"""Prompt-lookup (n-gram) decoding, the port of sparkinfer_tpu/runtime/lookup.py
(the analogue of common/ngram-cache.cpp + examples/lookup): a draft-free
speculative decoder whose proposals come from matching the current n-gram
suffix against the context seen so far.

It verifies with the target Engine's `verify`, as SpeculativeEngine does
(greedy acceptance, lossless). A proposal of Kd <= K tokens is padded to K
so that every round runs one verify graph (T = K+1); the padded rows are
written past the accepted ones and hidden by the causal mask, like rejected
rows. Generation stops when the K+1 rows no longer fit in the cache.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .engine import Engine
from .speculative import greedy_accept, refuse_penalties


@dataclass
class LookupStats:
    n_rounds: int = 0
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


class NgramCache:
    """Maps n-gram tuples -> most recent continuation position (ref:
    common_ngram_cache_update)."""

    def __init__(self, n: int = 3):
        self.n = n
        self.index: dict[tuple, int] = {}

    def update(self, tokens: list[int], start: int = 0):
        n = self.n
        for i in range(max(start, n - 1), len(tokens) - 1):
            key = tuple(tokens[i - n + 1 : i + 1])
            self.index[key] = i + 1  # continuation starts here

    def propose(self, tokens: list[int], k: int) -> list[int]:
        if len(tokens) < self.n:
            return []
        key = tuple(tokens[-self.n :])
        pos = self.index.get(key)
        if pos is None:
            return []
        return tokens[pos : pos + k]


def verify_block(t: Engine, tok: int, drafts: list[int], K: int, n_past: int, cache
                 ) -> tuple[torch.Tensor, int, int]:
    """[tok] + drafts, padded to K+1 tokens, through t.verify: (the argmax
    (K+1,) on the device, accepted count, the target's next token)."""
    block = [tok] + drafts + [drafts[-1]] * (K - len(drafts))
    _, t_toks = t.verify(block, n_past, cache)
    n_acc, nxt = greedy_accept(t_toks, drafts)
    return t_toks, n_acc, nxt


class LookupEngine:
    """Greedy prompt-lookup decoding over a target Engine (batch 1)."""

    def __init__(self, target: Engine, n_draft: int = 5, ngram: int = 3):
        assert target.batch == 1
        assert target.sampler_cfg.greedy, "lookup decoding implemented for greedy"
        refuse_penalties(target, "lookup")
        self.t = target
        self.n_draft = n_draft
        self.cache_ngram = ngram
        self.stats = LookupStats()

    @torch.inference_mode()
    def generate(self, prompt_tokens: list[int], max_new_tokens: int = 128,
                 stop_ids: set[int] | None = None) -> list[int]:
        stop_ids = stop_ids or set()
        t = self.t
        K = self.n_draft
        cache = t.own_cache()
        sstate = t.new_sampler_state()
        tok, cache, sstate, n_past = t.prefill(prompt_tokens, cache, sstate)

        seq = list(prompt_tokens)
        ng = NgramCache(self.cache_ngram)
        ng.update(seq)
        out: list[int] = []

        while len(out) < max_new_tokens and tok not in stop_ids:
            out.append(tok)
            seq.append(tok)
            ng.update(seq, start=len(seq) - self.cache_ngram - 1)
            if len(out) >= max_new_tokens or n_past + K + 1 > t.max_seq:
                break
            drafts = ng.propose(seq, K)
            if not drafts:
                tok, cache, sstate = t.decode_step(tok, n_past, cache, sstate)
                n_past += 1
                continue
            _, n_acc, nxt = verify_block(t, tok, drafts, K, n_past, cache)
            self.stats.n_rounds += 1
            self.stats.n_drafted += len(drafts)
            self.stats.n_accepted += n_acc
            for a in drafts[:n_acc]:
                if len(out) >= max_new_tokens or a in stop_ids:
                    return out
                out.append(a)
                seq.append(a)
            ng.update(seq)
            n_past += n_acc + 1
            tok = nxt
        return out
