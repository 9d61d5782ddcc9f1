"""Rotary position embeddings, the port of sparkinfer_tpu/ops/rope.py.

Two layouts, matching ggml_rope modes:
  - "norm": rotate adjacent pairs (x[2i], x[2i+1]), llama-family GGUF
    weights (the HF->GGUF converter permutes Q/K so this layout applies);
  - "neox": rotate split halves (x[i], x[i+d/2]), qwen2/falcon/gpt-neox.

Linear and YaRN frequency scaling as in the JAX package. M-RoPE comes later.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RopeParams:
    dim: int  # rotary dimensions (<= head_dim)
    mode: str = "norm"  # "norm" | "neox" | "none"
    freq_base: float = 10000.0
    freq_scale: float = 1.0  # linear scaling (1/factor)
    # YaRN
    yarn_orig_ctx: int = 0
    yarn_ext_factor: float = 0.0
    yarn_attn_factor: float = 1.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0


def rope_freqs(p: RopeParams, device=None) -> tuple[torch.Tensor, float]:
    """Per-pair inverse frequencies (already scaled, f32) and magnitude scale."""
    half = p.dim // 2
    # a Python-float base: no host-to-device copy (which would synchronize)
    inv_freq = p.freq_base ** (
        -torch.arange(0, half, dtype=torch.float32, device=device) / half)
    mscale = 1.0
    if p.yarn_ext_factor != 0.0 and p.yarn_orig_ctx > 0:
        # YaRN: per-dim interpolation between scaled and unscaled freqs
        def corr_dim(n_rot: float) -> float:
            return (p.dim * math.log(p.yarn_orig_ctx / (n_rot * 2 * math.pi))
                    / (2 * math.log(p.freq_base)))

        low = max(0.0, math.floor(corr_dim(p.yarn_beta_fast)))
        high = min(half - 1.0, math.ceil(corr_dim(p.yarn_beta_slow)))
        i = torch.arange(half, dtype=torch.float32, device=device)
        ramp = (1.0 - ((i - low) / max(0.001, high - low)).clamp(0.0, 1.0)) \
            * p.yarn_ext_factor
        inv_freq = inv_freq * p.freq_scale * (1 - ramp) + inv_freq * ramp
        mscale = p.yarn_attn_factor * (1.0 + 0.1 * math.log(1.0 / p.freq_scale))
    else:
        inv_freq = inv_freq * p.freq_scale
    return inv_freq, float(mscale)


def rope_cos_sin(positions: torch.Tensor, p: RopeParams) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin tables (..., seq, 1, half) for positions (..., seq), the
    part of the rotation that every head and every layer shares."""
    inv_freq, mscale = rope_freqs(p, positions.device)
    theta = positions[..., None].float() * inv_freq  # (..., seq, half)
    return ((torch.cos(theta) * mscale)[..., :, None, :],
            (torch.sin(theta) * mscale)[..., :, None, :])


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           p: RopeParams) -> torch.Tensor:
    """Rotate x (..., seq, n_head, head_dim) by tables from rope_cos_sin."""
    if p.mode == "none":
        return x
    if p.mode not in ("norm", "neox"):
        raise ValueError(f"rope mode {p.mode}")
    rot, rest = x[..., : p.dim], x[..., p.dim:]
    rf = rot.float()
    if p.mode == "norm":
        x1, x2 = rf[..., 0::2], rf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(rf.shape)
    else:
        half = p.dim // 2
        x1, x2 = rf[..., :half], rf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


def apply_rope(x: torch.Tensor, positions: torch.Tensor, p: RopeParams) -> torch.Tensor:
    """x (..., seq, n_head, head_dim); positions broadcastable to (..., seq)."""
    if p.mode == "none":
        return x
    return rotate(x, *rope_cos_sin(positions, p), p)
