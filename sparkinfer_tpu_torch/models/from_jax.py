"""Params of the JAX package as params of the port, key for key.

The caller turns the JAX params into numpy arrays first
(`jax.tree.map(np.asarray, params)`); this module never imports JAX. The
two packages share keys and orientations (models/loader.py), including the
pipelined sparse layout (`_nx` predictor copies and params["sparse_flat"]),
so the result computes what the JAX params compute. One exception: the
port keeps the up and gate expert stacks (and grovemoe's chunk experts) as
(..., X, Fe, E), where the JAX package keeps (..., X, E, Fe)
(sparse/moe.py); they are transposed here.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# expert stacks the JAX package keeps as (..., X, E, Fe), the port (..., X, Fe, E)
EXPERT_COLUMNS = ("w_up_exps", "w_gate_exps", "w_up_chexps", "w_gate_chexps")


def params_from_numpy(np_params: dict, device, dtype=None) -> dict:
    """Nested dicts of numpy arrays -> the same dicts of tensors on `device`.
    dtype=None keeps each array's dtype; else floating arrays are cast."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _tensor(np.ascontiguousarray(np.swapaxes(v, -1, -2))
                             if k in EXPERT_COLUMNS else v,
                             device, dtype))
            for k, v in np_params.items()}
