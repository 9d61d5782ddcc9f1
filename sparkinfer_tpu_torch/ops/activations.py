"""FFN activations of the llama family and the sparse models, the port of
sparkinfer_tpu/ops/activations.py:act_fn.

ProSparse: fatrelu(gate) * up; Bamboo: relu(gate) * relu(up); ReLU models:
relu(up); llama and the MoE families: silu(gate) * up; the MoE functions'
other variants: gpt-oss's clamped swiglu, geglu, reglu and gelu; plm's,
nemotron's and arcee's ungated relu²; bitnet's gated relu², relu(gate)² *
up; the bert encoders' exact (erf) gelu. `xielu` is apertus's activation
with per-layer coefficients, which the FFN calls itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fatrelu(x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """x where x > threshold, else 0 (GGML_OP_FATRELU)."""
    return torch.where(x > threshold, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu_gate(g, u):
    return F.silu(g.float()).to(g.dtype) * u


def _gelu_gate(g, u):
    return F.gelu(g.float(), approximate="tanh").to(g.dtype) * u


def _swiglu_oai(g, u, alpha: float = 1.702, limit: float = 7.0):
    """gpt-oss clamped swiglu (ggml_swiglu_oai): gate clamped above at
    limit, up to [-limit, limit], sigmoid slope alpha, the (up + 1) shift."""
    gf = g.float().clamp_max(limit)
    uf = u.float().clamp(-limit, limit)
    return (gf * torch.sigmoid(alpha * gf) * (uf + 1.0)).to(g.dtype)


def _drelu(g, u):
    return g.clamp_min(0) * u.clamp_min(0)


def _relu(u):
    return u.clamp_min(0)


def _relu2(u):
    """relu(u)**2 (plm, nemotron, arcee: ggml_sqr(ggml_relu))."""
    r = u.clamp_min(0)
    return r * r


def _relu2_glu(g, u):
    """relu(gate)**2 * up (bitnet b1.58)."""
    r = g.clamp_min(0)
    return r * r * u


def xielu(x: torch.Tensor, alpha_p: torch.Tensor, alpha_n: torch.Tensor, beta: torch.Tensor,
          eps: torch.Tensor) -> torch.Tensor:
    """xIELU (apertus), in f32 and back in x's dtype: a_p * x^2 + beta * x
    for x > 0, else (expm1(min(x, eps)) - x) * a_n + beta * x. The
    coefficients are f32 tensors (one a layer, broadcast) that the loader
    has already passed through softplus."""
    xf = x.float()
    b = beta.float()
    pos = alpha_p.float() * xf * xf + b * xf
    neg = (torch.expm1(torch.minimum(xf, eps.float())) - xf) * alpha_n.float() + b * xf
    return torch.where(xf > 0, pos, neg).to(x.dtype)


def _gelu(u):
    return F.gelu(u.float(), approximate="tanh").to(u.dtype)


def _gelu_erf(u):
    """Exact (erf) GELU of the bert encoders, in f32 and back in u's dtype."""
    return F.gelu(u.float(), approximate="none").to(u.dtype)


def act_fn(name: str, fatrelu_threshold: float = 0.0):
    """Returns (gated, fn). gated=True -> fn(gate, up); else fn(up)."""
    table = {
        "silu": (True, _silu_gate),
        "swiglu": (True, _silu_gate),
        "swiglu_oai": (True, _swiglu_oai),
        "geglu": (True, _gelu_gate),
        "reglu": (True, lambda g, u: g.clamp_min(0) * u),
        "gelu": (False, _gelu),
        "gelu_erf": (False, _gelu_erf),
        "fatrelu": (True, lambda g, u: fatrelu(g, fatrelu_threshold) * u),
        "drelu": (True, _drelu),
        "relu": (False, _relu),
        "relu2": (False, _relu2),
        "relu2_glu": (True, _relu2_glu),
    }
    if name not in table:
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return table[name]
