"""UGM (SentencePiece unigram) tokenizer — Viterbi segmentation.

Behavioral parity target: llm_tokenizer_ugm (src/llama-vocab.cpp): choose
the segmentation maximizing the sum of per-token scores (log-likelihoods);
characters not coverable by any token become UNK with a penalty below any
valid token. Normalization: the reference uses a precompiled charsmap from
the model; here the common-case subset (space -> ▁, optional space
prefix) is applied — full charsmap support would read
tokenizer.ggml.precompiled_charsmap.
"""

from __future__ import annotations

from .vocab import Vocab, split_on_specials

SPIECE_UNDERLINE = "▁"
UNK_PENALTY = 10.0


class UGMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.max_len = max((len(t) for t in vocab.tokens if t), default=1)
        if vocab.scores is None:
            raise ValueError("UGM tokenizer needs scores")
        self.min_score = float(vocab.scores.min())

    def _normalize(self, text: str) -> str:
        out = text.replace(" ", SPIECE_UNDERLINE)
        if self.vocab.add_space_prefix and out and not out.startswith(SPIECE_UNDERLINE):
            out = SPIECE_UNDERLINE + out
        return out

    def _viterbi(self, text: str) -> list[int]:
        n = len(text)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        v = self.vocab
        unk_score = self.min_score - UNK_PENALTY
        for i in range(n):
            if best[i] == NEG:
                continue
            # unknown single char fallback
            cand = best[i] + unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, v.unk_id)
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = v.token_to_id.get(text[i:j])
                if tid is None:
                    continue
                cand = best[i] + float(v.scores[tid])
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, tid)
        # backtrack, merging consecutive UNKs (reference merges them)
        ids: list[int] = []
        i = n
        while i > 0:
            prev, tid = back[i]
            ids.append(tid)
            i = prev
        ids.reverse()
        merged: list[int] = []
        for t in ids:
            if t == v.unk_id and merged and merged[-1] == v.unk_id:
                continue
            merged.append(t)
        return merged

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for frag, sid in split_on_specials(text, v):
            if sid is not None:
                out.append(sid)
            else:
                out.extend(self._viterbi(self._normalize(frag)))
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        if add_special and v.add_bos and v.bos_id >= 0:
            out.insert(0, v.bos_id)
        return out

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        v = self.vocab
        parts = []
        for t in ids:
            if skip_special and t in (v.bos_id, v.eos_id, v.pad_id):
                continue
            parts.append(v.tokens[t])
        text = "".join(parts).replace(SPIECE_UNDERLINE, " ")
        return text[1:] if text.startswith(" ") else text
