"""Vocabulary loaded from GGUF metadata + tokenizer dispatch.

Behavioral parity target: src/llama-vocab.cpp (SPM/BPE tokenizers, special
token handling, add_bos/add_eos/add_space_prefix semantics). Tokenization is
validated against the reference's models/ggml-vocab-*.gguf.{inp,out} vectors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from ..gguf.constants import Keys, TokenType

if TYPE_CHECKING:
    from ..gguf.reader import GGUFReader


@dataclass
class Vocab:
    model: str  # "llama" (SPM) | "gpt2" (BPE) | "bert" (WPM) | ...
    pre: str
    tokens: list[str]
    token_types: np.ndarray  # TokenType per id
    scores: np.ndarray | None
    merges: list[str] | None
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    pad_id: int = -1
    mask_id: int = -1  # diffusion LMs (Dream/LLaDA): the [MASK] token
    sep_id: int = -1
    add_bos: bool = False
    add_eos: bool = False
    add_sep: bool = False
    add_space_prefix: bool = True
    chat_template: str | None = None
    # fill-in-the-middle specials (ref llama-vocab.cpp special_fim_*_id)
    fim_pre_id: int = -1
    fim_suf_id: int = -1
    fim_mid_id: int = -1
    fim_pad_id: int = -1
    fim_rep_id: int = -1
    fim_sep_id: int = -1
    token_to_id: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def special_ids(self) -> list[int]:
        tt = self.token_types
        return [
            i
            for i in range(len(self.tokens))
            if tt[i] in (TokenType.CONTROL, TokenType.USER_DEFINED)
        ]

    def is_eog(self, tok: int) -> bool:
        """End-of-generation: EOS or common EOT-style control tokens."""
        if tok == self.eos_id:
            return True
        t = self.tokens[tok] if 0 <= tok < len(self.tokens) else ""
        return t in (
            "<|eot_id|>", "<|im_end|>", "<|end|>", "<end_of_turn>",
            "<|endoftext|>", "<|end_of_text|>", "<EOT>", "</s>", "<|return|>",
        )

    @classmethod
    def from_gguf(cls, reader: "GGUFReader") -> "Vocab":
        kv = reader.kv
        tokens = kv[Keys.Tokenizer.LIST]
        n = len(tokens)
        tt = kv.get(Keys.Tokenizer.TOKEN_TYPE)
        token_types = (
            np.asarray(tt, dtype=np.int32) if tt is not None else np.full(n, TokenType.NORMAL, np.int32)
        )
        scores = kv.get(Keys.Tokenizer.SCORES)
        model = kv.get(Keys.Tokenizer.MODEL, "llama")
        v = cls(
            model=model,
            pre=kv.get(Keys.Tokenizer.PRE, "default"),
            tokens=tokens,
            token_types=token_types,
            scores=np.asarray(scores, dtype=np.float32) if scores is not None else None,
            merges=kv.get(Keys.Tokenizer.MERGES),
            bos_id=int(kv.get(Keys.Tokenizer.BOS_ID, 1 if model == "llama" else -1)),
            eos_id=int(kv.get(Keys.Tokenizer.EOS_ID, 2 if model == "llama" else -1)),
            unk_id=int(kv.get(Keys.Tokenizer.UNK_ID, 0 if model == "llama" else -1)),
            pad_id=int(kv.get(Keys.Tokenizer.PAD_ID, -1)),
            mask_id=int(kv.get(Keys.Tokenizer.MASK_ID, -1)),
            sep_id=int(kv.get(Keys.Tokenizer.SEP_ID, -1)),
            add_bos=bool(kv.get(Keys.Tokenizer.ADD_BOS, model == "llama")),
            add_eos=bool(kv.get(Keys.Tokenizer.ADD_EOS, False)),
            add_sep=bool(kv.get(Keys.Tokenizer.ADD_SEP, False)),
            add_space_prefix=bool(kv.get(Keys.Tokenizer.ADD_SPACE_PREFIX, model == "llama")),
            chat_template=kv.get(Keys.Tokenizer.CHAT_TEMPLATE),
            fim_pre_id=int(kv.get(Keys.Tokenizer.FIM_PRE_ID, -1)),
            fim_suf_id=int(kv.get(Keys.Tokenizer.FIM_SUF_ID, -1)),
            fim_mid_id=int(kv.get(Keys.Tokenizer.FIM_MID_ID, -1)),
            fim_pad_id=int(kv.get(Keys.Tokenizer.FIM_PAD_ID, -1)),
            fim_rep_id=int(kv.get(Keys.Tokenizer.FIM_REP_ID, -1)),
            fim_sep_id=int(kv.get(Keys.Tokenizer.FIM_SEP_ID, -1)),
        )
        v._detect_fim_by_name()
        return v

    # name-based FIM detection fallback (ref llama-vocab.cpp:2225-2335 —
    # token-string tables for Qwen/Granite/DeepSeek/CodeLlama/GLM)
    _FIM_NAMES = {
        "fim_pre_id": ("<|fim_prefix|>", "<fim-prefix>", "<fim_prefix>",
                       "<｜fim▁begin｜>", "<PRE>", "▁<PRE>", "<|code_prefix|>"),
        "fim_suf_id": ("<|fim_suffix|>", "<fim-suffix>", "<fim_suffix>",
                       "<｜fim▁hole｜>", "<SUF>", "▁<SUF>", "<|code_suffix|>"),
        "fim_mid_id": ("<|fim_middle|>", "<fim-middle>", "<fim_middle>",
                       "<｜fim▁end｜>", "<MID>", "▁<MID>", "<|code_middle|>"),
        "fim_pad_id": ("<|fim_pad|>", "<fim-pad>", "<fim_pad>", "<PAD>"),
        "fim_rep_id": ("<|fim_repo|>", "<|repo_name|>", "<fim-repo>",
                       "<REPO>", "<reponame>"),
        "fim_sep_id": ("<|file_sep|>", "<file_sep>"),
    }

    def _detect_fim_by_name(self):
        for attr, names in self._FIM_NAMES.items():
            if getattr(self, attr) >= 0:
                continue
            for nm in names:
                tid = self.token_to_id.get(nm, -1)
                if tid >= 0:
                    setattr(self, attr, tid)
                    break


def split_on_specials(text: str, vocab: Vocab) -> list[tuple[str, int | None]]:
    """Partition text into (raw_fragment, None) / ("", special_id) pieces.

    Mirrors tokenizer_st_partition: special/user-defined token strings are
    matched literally, longest-first.
    """
    specials = sorted(
        ((vocab.tokens[i], i) for i in vocab.special_ids() if vocab.tokens[i]),
        key=lambda p: -len(p[0]),
    )
    frags: list[tuple[str, int | None]] = [(text, None)]
    for s, sid in specials:
        out: list[tuple[str, int | None]] = []
        for frag, fid in frags:
            if fid is not None:
                out.append((frag, fid))
                continue
            start = 0
            while True:
                idx = frag.find(s, start)
                if idx < 0:
                    if start < len(frag):
                        out.append((frag[start:], None))
                    break
                if idx > start:
                    out.append((frag[start:idx], None))
                out.append(("", sid))
                start = idx + len(s)
        frags = out
    return frags


def build_tokenizer(vocab: Vocab):
    if vocab.model == "llama":
        from .spm import SPMTokenizer

        return SPMTokenizer(vocab)
    if vocab.model == "gpt2":
        from .bpe import BPETokenizer

        return BPETokenizer(vocab)
    if vocab.model == "bert":
        from .wpm import WPMTokenizer

        return WPMTokenizer(vocab)
    if vocab.model in ("t5", "ugm"):
        from .ugm import UGMTokenizer

        return UGMTokenizer(vocab)
    if vocab.model == "rwkv":
        from .rwkv import RWKVTokenizer

        return RWKVTokenizer(vocab)
    raise NotImplementedError(f"tokenizer model {vocab.model!r}")
