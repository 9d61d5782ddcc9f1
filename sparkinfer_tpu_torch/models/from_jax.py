"""Params of the JAX package as params of the port, key for key.

The caller turns the JAX params into numpy arrays first
(`jax.tree.map(np.asarray, params)`); this module never imports JAX. The
two packages share keys and orientations (models/loader.py), including the
pipelined sparse layout (`_nx` predictor copies and params["sparse_flat"]),
so the result computes what the JAX params compute. One exception: the
port keeps the up and gate expert stacks (and grovemoe's chunk experts) as
(..., X, Fe, E), where the JAX package keeps (..., X, E, Fe)
(sparse/moe.py); they are transposed here. A JAX W8A8Tensor (after the
tree map, an object with numpy `q` and `s` and no `kind`) becomes the
port's W8A8Tensor, recognised by those attributes (the JAX class is never
imported), its q laid out out-major and its scales kept in f32. A model with
layer segments (deepseek2) keeps them as the JAX loader does, a list of
stacks under "layer_segments" with "layers" the first of them, and the
expert stacks are transposed inside each.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant_matmul import W8A8Tensor


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


def _is_w8a8(v) -> bool:
    return hasattr(v, "q") and hasattr(v, "s") and not hasattr(v, "kind")


def _w8a8(v, device) -> W8A8Tensor:
    q = torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.asarray(v.q, np.int8), -1, -2)))
    return W8A8Tensor(q.to(device).mT, _tensor(v.s, device, torch.float32))


def params_from_numpy(np_params: dict, device, dtype=None) -> dict:
    """Nested dicts of numpy arrays -> the same dicts of tensors on `device`.
    dtype=None keeps each array's dtype; else floating arrays are cast."""
    def one(k, v):
        if isinstance(v, dict):
            return params_from_numpy(v, device, dtype)
        if _is_w8a8(v):
            return _w8a8(v, device)
        if k in EXPERT_COLUMNS:
            v = np.ascontiguousarray(np.swapaxes(v, -1, -2))
        return _tensor(v, device, dtype)

    segs = np_params.get("layer_segments")
    out = {k: one(k, v) for k, v in np_params.items()
           if k != "layer_segments" and not (segs is not None and k == "layers")}
    if segs is not None:  # "layers" is the first segment, as in JAX
        out["layer_segments"] = [params_from_numpy(s, device, dtype) for s in segs]
        out["layers"] = out["layer_segments"][0]
    return out
