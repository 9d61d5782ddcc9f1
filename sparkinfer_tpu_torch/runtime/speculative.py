"""Speculative decoding, the port of sparkinfer_tpu/runtime/speculative.py
(ref: common/speculative.{h,cpp} and examples/speculative, including the
SparkInfer pairing where target and draft may both run sparse).

The draft proposes K tokens with K decode steps on its own cache (its
`decode_step`, a graph replay on the card); the target scores all K+1
positions in one `Engine.verify`, a graph of its own keyed on T = K+1, whose
sparse FFN runs the kernel at N = K+1. Acceptance:
  - greedy (temp == 0): accept while the target's argmax equals the draft's
    proposal, compared on the device, so only the accepted count and the
    next token are read back; the output is target-only greedy decoding;
  - stochastic: accept d_i with probability min(1, p_t(d_i) / p_d(d_i)),
    on rejection draw from normalize(max(0, p_t - p_d)); the uniforms and
    the draws come from the target Engine's generator.

Drafting refuses a target sampler with penalties (`refuse_penalties`):
acceptance reads the raw logits and verified tokens never enter the
penalty ring, so the stream would be neither penalized nor plain decoding.
It refuses an engine with an iSWA cache (kv_iswa) too, as the JAX
package's drafters have no iSWA path.

No KV rollback is needed: rejected rows are hidden by the causal mask until
they are written again. A round needs K+1 free rows: generation stops when
the verify block no longer fits in the cache (no context shift here).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .engine import Engine
from .sampling import penalizes


@dataclass
class SpecStats:
    n_rounds: int = 0
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def accept_rate(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


def refuse_penalties(target: Engine, what: str):
    """Raise ValueError when the target's sampler applies repetition,
    presence or frequency penalties, which `what` decoding cannot honour,
    or when it keeps an iSWA cache (kv_iswa), which the JAX package's
    drafters take none of."""
    if target.kv_iswa:
        raise ValueError(f"{what} decoding needs a full KV cache: the iSWA cache "
                         "(kv_iswa) has no drafting path, as in the JAX package")
    sc = target.sampler_cfg
    if penalizes(sc):
        raise ValueError(
            f"{what} decoding accepts drafts on the unpenalized logits: it cannot run "
            f"with penalties (repeat {sc.penalty_repeat}, presence {sc.penalty_present}, "
            f"frequency {sc.penalty_freq} over the last {sc.penalty_last_n} tokens)")


def greedy_accept(t_toks: torch.Tensor, drafts: list[int]) -> tuple[int, int]:
    """(accepted count, the target's next token) from the target's argmax
    t_toks (>= len(drafts)+1,) over [tok] + drafts: one read of two ints."""
    K = len(drafts)
    d = torch.tensor(drafts, device=t_toks.device)
    miss = (t_toks[:K] != d).to(torch.int32)
    # index of the first mismatch, K when every draft matched
    n_acc = torch.where(miss.any(), torch.argmax(miss), K)
    n_acc, nxt = torch.stack([n_acc, t_toks[n_acc]]).tolist()
    return int(n_acc), int(nxt)


class SpeculativeEngine:
    """Wraps a target Engine and a draft Engine (both batch 1)."""

    def __init__(self, target: Engine, draft: Engine, n_draft: int = 5):
        assert target.batch == 1 and draft.batch == 1
        refuse_penalties(target, "speculative")
        if draft.kv_iswa:
            raise ValueError("speculative decoding needs a full KV cache in the draft engine")
        self.target = target
        self.draft = draft
        self.n_draft = n_draft
        self.stats = SpecStats()

    @torch.inference_mode()
    def generate(self, prompt_tokens: list[int], max_new_tokens: int = 128,
                 stop_ids: set[int] | None = None, seed: int | None = None) -> list[int]:
        stop_ids = stop_ids or set()
        K = self.n_draft
        t, d = self.target, self.draft
        greedy = t.sampler_cfg.greedy
        max_seq = min(t.max_seq, d.max_seq)

        t_cache, d_cache = t.own_cache(), d.own_cache()
        t_state = t.new_sampler_state(seed)
        d_state = d.new_sampler_state(seed)
        gen = t.generator

        # prefill both on the prompt; the target's sampled token is authoritative
        tok, t_cache, t_state, n_past = t.prefill(prompt_tokens, t_cache, t_state)
        _, d_cache, d_state, _ = d.prefill(prompt_tokens, d_cache, d_state)

        out: list[int] = []
        while len(out) < max_new_tokens and tok not in stop_ids:
            out.append(tok)
            if len(out) >= max_new_tokens or n_past + K + 1 > max_seq:
                break

            # draft K tokens: greedy for a greedy target (acceptance is an
            # argmax match), sampled from p_d otherwise (min(1, p_t/p_d) is
            # lossless only for drafts drawn from p_d)
            drafts: list[int] = []
            d_probs = []
            d_tok = tok
            for i in range(K):
                d.decode_step(d_tok, n_past + i, d_cache, d_state)
                lgv = d.last_logits[0]
                if greedy:
                    d_tok = int(torch.argmax(lgv))
                else:
                    p = torch.softmax(lgv, dim=-1)
                    d_tok = int(torch.multinomial(p, 1, generator=gen))
                    d_probs.append(p)
                drafts.append(d_tok)

            # the target verifies all K+1 positions in one forward
            logits, t_toks = t.verify([tok] + drafts, n_past, t_cache)
            if greedy:
                n_acc, next_tok = greedy_accept(t_toks, drafts)
            else:
                n_acc, next_tok = self._stochastic(logits, drafts, torch.stack(d_probs), gen)
            accepted = drafts[:n_acc]

            self.stats.n_rounds += 1
            self.stats.n_drafted += K
            self.stats.n_accepted += n_acc

            for a in accepted:
                if len(out) >= max_new_tokens or a in stop_ids:
                    return out
                out.append(a)

            if n_acc == K:
                # full accept: the draft proposed d_K but never consumed it,
                # so its row at n_past+K is missing; feed it now
                d.decode_step(drafts[-1], n_past + K, d_cache, d_state)
            n_past += n_acc + 1
            tok = next_tok
        return out

    @staticmethod
    def _stochastic(logits, drafts, d_probs, gen) -> tuple[int, int]:
        """Speculative sampling over the target's (K+1, V) logits and the
        draft's (K, V) probabilities: (accepted count, next token)."""
        K = len(drafts)
        t_probs = torch.softmax(logits.float(), dim=-1)
        idx = torch.tensor(drafts, device=t_probs.device)[:, None]
        pt = t_probs[:K].gather(1, idx)[:, 0]
        pd = d_probs.gather(1, idx)[:, 0].clamp_min(1e-20)
        u = torch.rand((K,), generator=gen, device=t_probs.device)
        reject = (u >= (pt / pd).clamp(max=1.0)).tolist()
        n_acc = reject.index(True) if True in reject else K
        if n_acc < K:
            resid = (t_probs[n_acc] - d_probs[n_acc]).clamp_min(0.0)
            if float(resid.sum()) <= 0:
                resid = t_probs[n_acc]
            nxt = torch.multinomial(resid / resid.sum(), 1, generator=gen)
        else:
            nxt = torch.multinomial(t_probs[K], 1, generator=gen)
        return n_acc, int(nxt)
