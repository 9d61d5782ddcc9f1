"""RMS and layer normalization (ggml_rms_norm / ggml_norm semantics), the
port of sparkinfer_tpu/ops/norms.py. Both accumulate in f32 whatever the
activation dtype, as ggml does, and return x's dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: f32 mean and variance of the centred
    values, then scale and optional bias, rounded to x's dtype once."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.reciprocal(torch.sqrt(var + eps)) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
