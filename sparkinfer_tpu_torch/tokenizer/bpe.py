"""GPT-2-style byte-level BPE tokenizer.

Behavioral parity with llm_tokenizer_bpe (ref: src/llama-vocab.cpp:281-460,
src/unicode.cpp unicode_regex_split): per-`pre` pretokenizer regex lists
applied sequentially (each regex re-splits every current fragment into
match/gap segments), byte-to-unicode remapping, then rank-based pair
merging over tokenizer.ggml.merges.

The regex pattern strings are upstream pretokenizer definitions (from the
respective models' tokenizer.json files, mirrored in llama-vocab.cpp).

A copy of sparkinfer_tpu/tokenizer/bpe.py. The patterns use Unicode
property classes, which need the `regex` package: it is imported where a BPE
vocabulary is built, so that the rest of the tokenizer package works
without it. There is no fallback to `re`, which would split differently.
"""

from __future__ import annotations

from .vocab import Vocab, split_on_specials

# --- byte <-> unicode mapping (GPT-2 bytes_to_unicode convention) ---


def _bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_ENCODER = _bytes_to_unicode()
BYTE_DECODER = {v: k for k, v in BYTE_ENCODER.items()}

# --- pretokenizer registry (pre name -> regex list) ---

_GPT2_RE = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)"""

_LLAMA3_RE = (
    r"""(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"""
    r"""|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"""
    r"""|\s*[\r\n]+|\s+(?!\S)|\s+"""
)

_QWEN2_RE = (
    r"""(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"""
    r"""|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"""
    r"""|\s*[\r\n]+|\s+(?!\S)|\s+"""
)

# NOTE: several codepoints here are Greek-Extended / Letterlike look-alikes
# of basic Greek/Latin letters (U+1F7D, U+1FBE, U+1FD3, U+1FDB, U+2126,
# U+212A) — written as escapes so they survive transcription.
_DEEPSEEK_LLM_LETTERS = (
    "A-Za-zµÀ-ÖØ-öø-ƺƼ-ƿǄ-ʓʕ-ʯͰ-ͳͶͷͻ-ͽͿΆΈ-ΊΌΎ-ΡΣ-ϵϷ-ҁҊ-ԯԱ-ՖႠ-ჅᎠ-Ᏽᏸ-ᏽᲐ-ᲺᲽ-Ჿᴀ-ᴫᵫ-ᵷᵹ-ᶚḀ-ἕἘ-Ἕἠ-ὅὈ-Ὅὐ-ὗὙὛὝὟ-\u1F7Dᾀ-ᾴᾶ-ᾼ\u1FBEῂ-ῄῆ-ῌῐ-\u1FD3ῖ-\u1FDBῠ-Ῥῲ-ῴῶ-ῼℂℇℊ-ℓℕℙ-ℝℤ\u2126ℨ\u212A-ℭℯ-ℴℹℼ-ℿⅅ-ⅉⅎↃↄⰀ-ⱻⱾ-ⳤⳫ-ⳮⳲⳳꙀ-ꙭꚀ-ꚛꜢ-ꝯꝱ-ꞇꞋ-ꞎꭰ-ꮿﬀ-ﬆﬓ-ﬗＡ-Ｚａ-ｚ𐐀-𐑏𐒰-𐓓𐓘-𐓻𐲀-𐲲𐳀-𐳲𑢠-𑣟𞤀-𞥃"
)

PRE_REGEXES: dict[str, list[str]] = {
    "default": [_GPT2_RE],
    "gpt-2": [_GPT2_RE],
    "mpt": [_GPT2_RE],
    "olmo": [_GPT2_RE],
    "jais": [_GPT2_RE],
    "gpt-neox": [_GPT2_RE],
    "phi-2": [_GPT2_RE],
    "stablelm2": [_QWEN2_RE],
    "qwen2": [_QWEN2_RE],
    "llama-bpe": [_LLAMA3_RE],
    "llama3": [_LLAMA3_RE],
    "smaug-bpe": [_LLAMA3_RE],
    "falcon": [
        r"[\p{P}\$\+<=>\^~\|`]+",
        _GPT2_RE,
        r"[0-9][0-9][0-9]",
    ],
    "falcon3": [_LLAMA3_RE],
    "starcoder": [r"\p{N}", _GPT2_RE],
    "refact": [r"\p{N}", _GPT2_RE],
    "command-r": [r"\p{N}", _GPT2_RE],
    "smollm": [r"\p{N}", _GPT2_RE],
    "codeshell": [r"\p{N}", _GPT2_RE],
    "exaone": [r"\p{N}", _GPT2_RE],
    "deepseek-llm": [
        "[\r\n]",
        rf"\s?[{_DEEPSEEK_LLM_LETTERS}]+",
        r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
        r"\s+$",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}+",
    ],
    "deepseek-coder": [
        "[\r\n]",
        r"\s?\p{L}+",
        r"\s?\p{P}+",
        r"[一-龥ࠀ-一가-퟿]+",
        r"\p{N}",
    ],
    "gpt-4o": [
        r"""[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+(?i:'s|'t|'re|'ve|'m|'ll|'d)?|[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*(?i:'s|'t|'re|'ve|'m|'ll|'d)?|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+""",
    ],
}

# pre types where the whole pretokenized word is looked up in the vocab
# before running merges (ref: llama-vocab.cpp ignore_merges for llama3)
IGNORE_MERGES_PRES = {"llama-bpe", "llama3", "falcon3", "smaug-bpe"}


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        try:
            import regex as re
        except ImportError as e:
            raise ImportError("a BPE vocabulary needs the `regex` package "
                              "(pip install regex)") from e
        self.vocab = vocab
        self.regexes = [re.compile(r) for r in PRE_REGEXES.get(vocab.pre, PRE_REGEXES["default"])]
        self.ignore_merges = vocab.pre in IGNORE_MERGES_PRES
        self.ranks: dict[tuple[str, str], int] = {}
        if vocab.merges:
            for i, m in enumerate(vocab.merges):
                a, _, b = m.partition(" ")
                self.ranks[(a, b)] = i

    # --- pretokenization ---

    def _pretokenize(self, text: str) -> list[str]:
        frags = [text]
        for rx in self.regexes:
            out = []
            for f in frags:
                pos = 0
                for m in rx.finditer(f):
                    if m.start() > pos:
                        out.append(f[pos : m.start()])
                    if m.end() > m.start():
                        out.append(f[m.start() : m.end()])
                    pos = m.end()
                if pos < len(f):
                    out.append(f[pos:])
            frags = out
        return frags

    # --- rank-based merge over one pretokenized word ---

    def _bpe_word(self, word: str) -> list[int]:
        v = self.vocab
        if self.ignore_merges:
            tid = v.token_to_id.get(word)
            if tid is not None:
                return [tid]
        parts = list(word)
        if not parts:
            return []
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            tid = v.token_to_id.get(p)
            if tid is not None:
                out.append(tid)
            else:
                # decompose to single mapped characters (byte-level fallback)
                for ch in p:
                    ctid = v.token_to_id.get(ch)
                    if ctid is not None:
                        out.append(ctid)
        return out

    # --- public API ---

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if add_special and v.add_bos and v.bos_id >= 0:
            out.append(v.bos_id)
        for frag, sid in split_on_specials(text, v):
            if sid is not None:
                out.append(sid)
                continue
            for word in self._pretokenize(frag):
                mapped = "".join(BYTE_ENCODER[b] for b in word.encode("utf-8"))
                out.extend(self._bpe_word(mapped))
        if add_special and v.add_eos and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def decode_bytes(self, ids: list[int], skip_special: bool = False) -> bytes:
        """Raw token bytes — the streaming-safe primitive (a multi-byte
        UTF-8 character split across tokens stays intact until the caller
        has a complete sequence; ref: the server's incomplete-UTF-8
        holdback)."""
        v = self.vocab
        buf = bytearray()
        for t in ids:
            if t < 0 or t >= v.n_tokens:
                continue
            if skip_special and t in (v.bos_id, v.eos_id):
                continue
            from ..gguf.constants import TokenType

            if v.token_types[t] in (TokenType.CONTROL,):
                if not skip_special:
                    buf.extend(v.tokens[t].encode("utf-8"))
                continue
            for ch in v.tokens[t]:
                b = BYTE_DECODER.get(ch)
                if b is None:
                    buf.extend(ch.encode("utf-8"))
                else:
                    buf.append(b)
        return bytes(buf)

    def decode(self, ids: list[int], skip_special: bool = False) -> str:
        return self.decode_bytes(ids, skip_special).decode("utf-8", errors="replace")
