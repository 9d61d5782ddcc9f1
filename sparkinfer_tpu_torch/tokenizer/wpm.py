"""WordPiece (BERT-style) tokenizer.

Behavioral parity with llm_tokenizer_wpm (ref: src/llama-vocab.cpp):
NFD-ish normalization to lowercase without accents, split on
whitespace/punctuation/CJK, then greedy longest-prefix matching with
"##" continuation pieces; whole word falls back to UNK on any miss.
"""

from __future__ import annotations

import unicodedata

from .vocab import Vocab


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def _normalize_split(self, text: str) -> list[str]:
        # lowercase + strip accents (NFD, drop Mn)
        norm = []
        for ch in unicodedata.normalize("NFD", text.lower()):
            if unicodedata.category(ch) == "Mn":
                continue
            norm.append(ch)
        words: list[str] = []
        cur: list[str] = []
        for ch in norm:
            cat = unicodedata.category(ch)
            if ch.isspace():
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif cat.startswith("P") or _is_chinese_char(ord(ch)) or cat in ("So", "Sm", "Sc", "Sk"):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        v = self.vocab
        out: list[int] = []
        cls_id = v.token_to_id.get("[CLS]", v.bos_id)
        sep_id = v.token_to_id.get("[SEP]", v.eos_id)
        unk_id = v.token_to_id.get("[UNK]", v.unk_id)
        if add_special and cls_id is not None and cls_id >= 0:
            out.append(cls_id)
        for word in self._normalize_split(text):
            ids = []
            start = 0
            ok = True
            while start < len(word):
                end = len(word)
                found = None
                while end > start:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    tid = v.token_to_id.get(piece)
                    if tid is not None:
                        found = tid
                        break
                    end -= 1
                if found is None:
                    ok = False
                    break
                ids.append(found)
                start = end
            out.extend(ids if ok else [unk_id])
        if add_special and sep_id is not None and sep_id >= 0:
            out.append(sep_id)
        return out

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        v = self.vocab
        parts = []
        for t in ids:
            if 0 <= t < v.n_tokens:
                s = v.tokens[t]
                if skip_special and s in ("[CLS]", "[SEP]", "[PAD]", "[UNK]"):
                    continue
                parts.append(s[2:] if s.startswith("##") else " " + s)
        return "".join(parts).strip()
