"""Token sampling, the port of sparkinfer_tpu/runtime/sampling.py.

Two chains, as in the JAX package:

  - `sample`, the Engine's static chain: greedy, or top-k -> top-p -> min-p
    -> temp -> draw. Its penalties, typical, xtc and mirostat stages are
    not ported; the Engine rejects a SamplerConfig that sets them.
  - `make_dynamic_sampler`, the serving Scheduler's per-slot chain over
    (B, V) rows, every knob carried per row as data (`DynamicParams`):
    penalties -> top-k -> typical -> top-p -> min-p -> xtc -> temp -> draw,
    greedy where temp <= 0. A knob at its neutral value leaves its stage an
    exact identity. Mirostat raises NotImplementedError.

Draws come from a torch.Generator per slot, so a seeded draw cannot match
JAX's PRNG-key draw; the masks and the greedy choice do match.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler parameters; defaults mirror common_params_sampling."""

    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    mirostat: int = 0  # 0 off, 2 = mirostat v2 (not ported)
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.1
    seed: int = 42

    @property
    def greedy(self) -> bool:
        return self.temp <= 0.0 and self.mirostat == 0


def neutral_penalties(repeat: float, freq: float, present: float) -> bool:
    return repeat == 1.0 and freq == 0.0 and present == 0.0


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the most likely tokens until their cumulative probability exceeds
    p (at least one)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < p).sum(-1, keepdim=True).clamp_min(1)
    cutoff = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits < cutoff, NEG_INF, logits)


def min_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep tokens with prob >= p * max prob, i.e. logit >= max + log(p)."""
    if p <= 0.0:
        return logits
    max_l = logits.amax(-1, keepdim=True)
    return torch.where(logits < max_l + math.log(p), NEG_INF, logits)


def sample(logits: torch.Tensor, cfg: SamplerConfig,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int64. Greedy takes the first index
    of the maximum, as jnp.argmax does."""
    lf = logits.float()
    if cfg.greedy:
        return torch.argmax(lf, dim=-1)
    lf = top_k_mask(lf, cfg.top_k)
    lf = top_p_mask(lf, cfg.top_p)
    lf = min_p_mask(lf, cfg.min_p)
    probs = torch.softmax(lf / max(cfg.temp, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ---------------------------------------------------------------------------
# The Scheduler's per-slot dynamic chain (sparkinfer_tpu/runtime/sampling.py
# :236-352)


@dataclasses.dataclass
class SamplerState:
    """One slot's carried sampling state: its generator and the ring of its
    recent tokens (-1 = empty) on the logits' device."""

    gen: torch.Generator
    recent: torch.Tensor  # (max(penalty_last_n, 1),) int64
    recent_pos: int = 0


def init_state(cfg: SamplerConfig, seed: int | None = None, device=None) -> SamplerState:
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed if seed is None else seed)
    n = max(cfg.penalty_last_n, 1)
    return SamplerState(gen=gen, recent=torch.full((n,), -1, dtype=torch.long, device=device))


class DynamicParams(NamedTuple):
    """Per-slot sampler knobs, each a CPU tensor: () for one slot, (B,)
    stacked (`stack_params`). Kept on the host so that the sampler knows
    without a device read which stages and draws a batch needs."""

    temp: torch.Tensor  # f32; <= 0 -> greedy
    top_k: torch.Tensor  # i32; <= 0 -> off
    top_p: torch.Tensor  # f32; >= 1 -> off
    min_p: torch.Tensor  # f32; <= 0 -> off
    typical_p: torch.Tensor  # f32; >= 1 -> off
    penalty_repeat: torch.Tensor  # f32; 1.0 -> off
    penalty_freq: torch.Tensor  # f32; 0 -> off
    penalty_present: torch.Tensor  # f32; 0 -> off
    xtc_probability: torch.Tensor  # f32; 0 -> off


def dynamic_params(cfg: SamplerConfig) -> DynamicParams:
    return DynamicParams(*(
        torch.tensor(getattr(cfg, f), dtype=torch.int32 if f == "top_k" else torch.float32)
        for f in DynamicParams._fields))


def stack_params(dps: list[DynamicParams]) -> DynamicParams:
    return DynamicParams(*(torch.stack(col) for col in zip(*dps)))


def _col(t: torch.Tensor, device, dtype=torch.float32) -> torch.Tensor:
    """A (B,) host knob as a (B, 1) column on the logits' device."""
    return t.to(device=device, dtype=dtype)[:, None]


def apply_penalties(lf: torch.Tensor, recent: torch.Tensor, dp: DynamicParams) -> torch.Tensor:
    """Repetition, frequency and presence penalties of each row over its
    ring of recent tokens recent (B, n), -1 = empty."""
    B, V = lf.shape
    valid = recent >= 0
    count = torch.zeros((B, V), dtype=torch.float32, device=lf.device).scatter_add_(
        1, torch.where(valid, recent, 0), valid.float())
    present = count > 0
    rep = _col(dp.penalty_repeat, lf.device)
    lf = torch.where(present, torch.where(lf > 0, lf / rep, lf * rep), lf)
    return (lf - count * _col(dp.penalty_freq, lf.device)
            - present.float() * _col(dp.penalty_present, lf.device))


def dynamic_logits(lf: torch.Tensor, recent: torch.Tensor | None, dp: DynamicParams,
                   xtc_threshold: float, xtc_u: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chain over f32 logits lf (B, V) with per-row knobs dp (B,) on the
    host: (temperature-scaled logits, masked with NEG_INF, greedy tokens).
    recent (B, n) is the rows' rings (None: no penalties); xtc_u (B,) the
    rows' uniform draws for xtc (None: xtc off). Each stage is written as
    the JAX chain writes it, so masks and greedy tokens agree."""
    V = lf.shape[-1]
    dev = lf.device
    if recent is not None:
        lf = apply_penalties(lf, recent, dp)
    greedy_tok = torch.argmax(lf, dim=-1)

    # top-k (dynamic k): the k-th largest as cutoff
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    k = _col(dp.top_k, dev, torch.long)
    kth = torch.gather(sorted_desc, 1, (k - 1).clamp(0, V - 1))
    lf = torch.where((k > 0) & (k < V) & (lf < kth), NEG_INF, lf)

    # typical: keep the tokens nearest the entropy until their mass reaches p
    typ = _col(dp.typical_p, dev)
    probs = torch.softmax(lf, dim=-1)
    ent = -torch.where(probs > 0, probs * torch.log(probs + 1e-20), 0.0).sum(-1, keepdim=True)
    shifted = (-torch.log(probs + 1e-20) - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    probs_sorted = torch.gather(probs, 1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_n = ((cum - probs_sorted) < typ).sum(-1, keepdim=True).clamp_min(1)
    rank = torch.argsort(order, dim=-1)
    lf = torch.where((typ < 1.0) & (rank >= keep_n), NEG_INF, lf)

    # top-p
    top_p = _col(dp.top_p, dev)
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    n_keep = ((cum - probs) < top_p).sum(-1, keepdim=True).clamp_min(1)
    cutoff = torch.gather(sorted_desc, 1, n_keep - 1)
    lf = torch.where((top_p < 1.0) & (lf < cutoff), NEG_INF, lf)

    # min-p
    min_p = _col(dp.min_p, dev)
    min_cut = lf.amax(-1, keepdim=True) + torch.log(min_p.clamp_min(1e-30))
    lf = torch.where((min_p > 0.0) & (lf < min_cut), NEG_INF, lf)

    # xtc: drop every token above the threshold but the least likely of them
    if xtc_u is not None:
        probs = torch.softmax(lf, dim=-1)
        above = probs >= xtc_threshold
        min_above = torch.where(above, probs, math.inf).amin(-1, keepdim=True)
        do_xtc = (xtc_u.to(dev)[:, None] < _col(dp.xtc_probability, dev)) & (
            above.sum(-1, keepdim=True) >= 2)
        lf = torch.where(do_xtc & above & (probs > min_above), NEG_INF, lf)

    return lf / _col(dp.temp, dev).clamp_min(1e-6), greedy_tok


def make_dynamic_sampler(cfg: SamplerConfig):
    """sample(logits (B, V), states [B SamplerState], dp DynamicParams (B,))
    -> tokens (B,) int64 on the logits' device, each row's state advanced.

    `cfg` gives only the static structure, as in the JAX package: the ring
    size, the xtc threshold and the mirostat mode. A batch whose rows are
    all greedy skips the truncation stages, whose result greedy rows never
    read; a batch with no penalty in any row skips the penalty stage. Rows
    with temp > 0 draw from their own generator."""
    if cfg.mirostat:
        raise NotImplementedError("mirostat is not ported yet")

    def sample(logits: torch.Tensor, states: list[SamplerState], dp: DynamicParams):
        lf = logits.float()
        B = lf.shape[0]
        draw = (dp.temp > 0.0).tolist()
        penalize = cfg.penalty_last_n > 0 and not all(
            neutral_penalties(*v) for v in zip(dp.penalty_repeat.tolist(),
                                               dp.penalty_freq.tolist(),
                                               dp.penalty_present.tolist()))
        recent = torch.stack([st.recent for st in states]) if penalize else None
        if any(draw):
            xtc_u = None
            if bool((dp.xtc_probability > 0.0).any()):
                xtc_u = torch.stack([torch.rand((), generator=st.gen, device=lf.device)
                                     for st in states])
            scaled, tok = dynamic_logits(lf, recent, dp, cfg.xtc_threshold, xtc_u)
            probs = torch.softmax(scaled, dim=-1)
            tok = tok.clone()
            for b in range(B):
                if draw[b]:
                    tok[b] = torch.multinomial(probs[b], 1, generator=states[b].gen)[0]
        else:
            tok = torch.argmax(lf if recent is None else apply_penalties(lf, recent, dp),
                               dim=-1)
        for b, st in enumerate(states):
            st.recent[st.recent_pos % st.recent.shape[0]] = tok[b]
            st.recent_pos += 1
        return tok

    return sample
