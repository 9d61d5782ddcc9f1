"""Lookahead decoding, the port of sparkinfer_tpu/runtime/lookahead.py
(the analogue of examples/lookahead: lookahead.cpp, Jacobi-iteration
decoding with an n-gram pool, after Fu et al. 2024).

The reference packs a 2D lookahead window + verification branches into one
batch with a custom block attention mask. The TPU re-design keeps the
attention path causal and static-shape (the same verify batch the
speculative/lookup engines jit) and expresses the Jacobi iteration
sequentially:

  - each round verifies a draft continuation [tok, d_1..d_K] in ONE forward
    (on the MXU this costs roughly one decode step, so rejected drafts are
    nearly free);
  - the model's own greedy outputs over the rejected suffix form the next
    Jacobi trajectory (the fixed-point iteration: feed the model's guess
    back as the next guess);
  - accepted/predicted continuations are harvested into a speculative
    n-gram pool (the lookahead pool), consulted before the trajectory —
    verified context n-grams (prompt-lookup) take priority over pool
    entries, pool over trajectory.

Greedy acceptance keeps it lossless: emitted tokens are exactly the plain
greedy decode. Speedup comes from accept-rate on self-consistent text.
Each round pads its proposal to K and runs the target's one verify graph
(`lookup.verify_block`); generation stops when the K+1 rows no longer fit
in the cache.
"""

from __future__ import annotations

import torch

from .engine import Engine
from .lookup import LookupStats, NgramCache, verify_block
from .speculative import refuse_penalties


class LookaheadEngine:
    """Greedy lookahead decoding over a target Engine (batch=1)."""

    def __init__(self, target: Engine, n_draft: int = 5, ngram: int = 3):
        assert target.batch == 1
        assert target.sampler_cfg.greedy, "lookahead decoding implemented for greedy"
        refuse_penalties(target, "lookahead")
        self.t = target
        self.n_draft = n_draft
        self.cache_ngram = ngram
        self.stats = LookupStats()

    def _propose(self, seq, ng, pool, traj):
        K = self.n_draft
        drafts = ng.propose(seq, K)  # verified context n-grams first
        if not drafts:
            drafts = pool.propose(seq, K)  # then the speculative pool
        if not drafts and traj:
            drafts = list(traj[:K])  # then the Jacobi trajectory
        # chain: a short proposal (match near the sequence end) is extended
        # by re-querying on the hypothetical continuation, so verify batches
        # stay K-deep instead of collapsing to single-token drafts
        while drafts and len(drafts) < K:
            h = seq + drafts
            more = ng.propose(h, K - len(drafts)) or pool.propose(h, K - len(drafts))
            if not more:
                break
            drafts += more
        return drafts[:K]

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
        pool = NgramCache(self.cache_ngram)
        traj: list[int] = []
        out: list[int] = []

        while len(out) < max_new_tokens and tok not in stop_ids:
            out.append(tok)
            seq.append(tok)
            ng.update(seq, start=len(seq) - self.cache_ngram - 1)
            if len(out) >= max_new_tokens or n_past + K + 1 > t.max_seq:
                break
            drafts = self._propose(seq, ng, pool, traj)
            if not drafts:
                tok, cache, sstate = t.decode_step(tok, n_past, cache, sstate)
                n_past += 1
                continue
            Kd = len(drafts)
            t_toks, n_acc, nxt = verify_block(t, tok, drafts, K, n_past, cache)
            # the model's outputs over the real rows (the padding's are no guess)
            t_toks = t_toks[:Kd + 1].tolist()
            self.stats.n_rounds += 1
            self.stats.n_drafted += Kd
            self.stats.n_accepted += n_acc
            for a in drafts[:n_acc]:
                if len(out) >= max_new_tokens or a in stop_ids:
                    return out
                out.append(a)
                seq.append(a)
            ng.update(seq)
            # harvest the model-predicted continuation into the pool: the
            # hypothetical sequence (context + greedy outputs) seeds n-grams
            # that future rounds can propose before they're verified
            pool.update(seq + [int(x) for x in t_toks[n_acc:]],
                        start=max(0, len(seq) - self.cache_ngram))
            # Jacobi iteration: the rejected suffix's corrected predictions
            # become the next trajectory guess
            traj = [int(x) for x in t_toks[n_acc + 1 :]]
            n_past += n_acc + 1
            tok = nxt
        return out
