"""FFN activations of the llama family and the sparse models, the port of
sparkinfer_tpu/ops/activations.py:act_fn.

ProSparse: fatrelu(gate) * up; Bamboo: relu(gate) * relu(up); ReLU models:
relu(up); llama: silu(gate) * up. The other activations of the JAX table
(gelu, geglu, relu², swiglu_oai, xIELU, ...) come with their families.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fatrelu(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """x where x > threshold, else 0 (GGML_OP_FATRELU)."""
    return torch.where(x > threshold, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu_gate(g, u):
    return F.silu(g.float()).to(g.dtype) * u


def _drelu(g, u):
    return g.clamp_min(0) * u.clamp_min(0)


def _relu(u):
    return u.clamp_min(0)


def act_fn(name: str, fatrelu_threshold: float = 0.0):
    """Returns (gated, fn). gated=True -> fn(gate, up); else fn(up)."""
    table = {
        "silu": (True, _silu_gate),
        "swiglu": (True, _silu_gate),
        "fatrelu": (True, lambda g, u: fatrelu(g, fatrelu_threshold) * u),
        "drelu": (True, _drelu),
        "relu": (False, _relu),
    }
    if name not in table:
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return table[name]
