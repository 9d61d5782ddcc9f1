"""Token sampling, the port of the greedy / temperature / top-k / top-p /
min-p chain of sparkinfer_tpu/runtime/sampling.py.

Chain order as in the JAX package: top-k -> top-p -> min-p -> temp -> draw.
Draws come from a torch.Generator, so a seeded draw cannot match JAX's
PRNG-key draw; the masks and the greedy choice do match. Penalties, typical
sampling, xtc and mirostat come later.
"""

from __future__ import annotations

import dataclasses
import math

import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler parameters; defaults mirror common_params_sampling."""

    temp: float = 0.8
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    seed: int = 42

    @property
    def greedy(self) -> bool:
        return self.temp <= 0.0


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
