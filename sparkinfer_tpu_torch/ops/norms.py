"""RMS normalization (ggml_rms_norm semantics), the port of
sparkinfer_tpu/ops/norms.py:rms_norm. Accumulates in f32 whatever the
activation dtype, as ggml does, and returns x's dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float()).to(x.dtype)
