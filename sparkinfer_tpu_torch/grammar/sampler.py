"""Grammar-constrained token sampling.

Mirrors the reference's grammar-first resampling strategy
(common/sampling.cpp:104,163,386): sample normally on-device first; check
the winner against the grammar on the host (cheap); only when it violates
the grammar compute the full allowed-token mask and resample — so the
grammar cost is paid only on the rare correction path.

A GrammarSampler is per-sequence state (the current stack set), like
llama_grammar attached to a sampler chain.
"""

from __future__ import annotations

import numpy as np

from .gbnf import Grammar, parse_gbnf


class GrammarSampler:
    def __init__(self, grammar: Grammar | str, vocab, tokenizer=None):
        self.grammar = parse_gbnf(grammar) if isinstance(grammar, str) else grammar
        self.vocab = vocab
        self.tokenizer = tokenizer
        self.stacks = self.grammar.start_stacks()
        # token id -> decoded piece text (cached once). Decoding goes through
        # the tokenizer's byte decoder when available so byte-level BPE
        # vocabs ("gpt2" model: llama3/qwen2 families) yield real text
        # (" hello"), not byte-encoder glyphs ("Ġhello") the grammar
        # can never match (round-1 bug). Control/special tokens decode to ""
        # and are treated as always-allowed, like llama_token_to_piece with
        # special=false.
        if tokenizer is not None and hasattr(tokenizer, "decode_bytes"):
            self._pieces = [
                tokenizer.decode_bytes([i], skip_special=True).decode(
                    "utf-8", errors="replace")
                for i in range(vocab.n_tokens)
            ]
        else:
            self._pieces = [self._piece(i) for i in range(vocab.n_tokens)]

    def _piece(self, tok: int) -> str:
        """Raw piece text as the sequence contributes it — llama_token_to_piece
        semantics: NO first-token space stripping (the grammar must see
        exactly what detokenization appends). Byte-fallback tokens render as
        their char when ASCII; non-ASCII lone bytes render as U+FFFD, which
        real grammars don't match — the codepoint-level engine can't track
        partial UTF-8 (reference tracks partial-utf8 state; rare path)."""
        t = self.vocab.tokens[tok]
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            b = int(t[3:5], 16)
            return chr(b) if b < 0x80 else "�"
        return t.replace("▁", " ")

    def reset(self):
        self.stacks = self.grammar.start_stacks()

    def allows(self, tok: int) -> bool:
        if self.vocab.is_eog(tok):
            return self.grammar.is_complete(self.stacks)
        piece = self._pieces[tok]
        if not piece:
            return True
        return bool(self.grammar.accept_text(self.stacks, piece))

    def accept(self, tok: int):
        if self.vocab.is_eog(tok):
            return
        piece = self._pieces[tok]
        if piece:
            self.stacks = self.grammar.accept_text(self.stacks, piece)
            if not self.stacks:
                raise ValueError(f"token {tok} ({piece!r}) violates grammar")

    def mask(self) -> np.ndarray:
        """(V,) bool mask of allowed next tokens (the expensive path)."""
        out = np.zeros(len(self._pieces), bool)
        complete = self.grammar.is_complete(self.stacks)
        for i, piece in enumerate(self._pieces):
            if self.vocab.is_eog(i):
                out[i] = complete
            elif not piece:
                out[i] = False
            else:
                out[i] = bool(self.grammar.accept_text(self.stacks, piece))
        return out

    def constrain_and_pick(self, logits: np.ndarray, sampled: int) -> int:
        """Grammar-first resample: keep `sampled` if legal, else argmax over
        the masked logits (greedy correction; callers wanting stochastic
        correction can softmax-sample the masked logits)."""
        if self.allows(sampled):
            self.accept(sampled)
            return sampled
        m = self.mask()
        if not m.any():
            raise ValueError("grammar dead end: no token allowed")
        masked = np.where(m, logits, -np.inf)
        tok = int(np.argmax(masked))
        self.accept(tok)
        return tok
