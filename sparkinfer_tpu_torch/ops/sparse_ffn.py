"""Fused predictor-gated sparse FFN over flat (layer, group) weight stores.

The port of the Pallas TPU kernel `sparse_ffn_block_v6`
(sparkinfer_tpu/ops/sparse_ffn_pallas.py:564). For each token n and selected
row r = idx[n, c]:

    up   = x[n] . w_upT_rows[r] + bu_sel[n, c]     (E, G) store
    gate = x[n] . w_gateT_rows[r]                  gated activations only
    h    = combine(act, gate, up) * mask           mask = gp >= thr, or gp
    out[n] = sum_c h . w_down_rows[r]              (G, E) store

all in f32, as the TPU kernel does (the hidden is not rounded to bf16 before
the down product). `sparse_ffn_block_v6` dispatches on the device of `x`:
a CPU tensor runs `sparse_ffn_block_v6_plain`, a CUDA tensor launches the
hand-written kernel in csrc/sparse_ffn_v6.cu and never the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# activations the kernel computes; "relu" is the only ungated one, and the
# gate store is read only for the gated ones (ops/sparse_ffn_pallas.py:585)
ACT_CODES = {"fatrelu": 0, "drelu": 1, "relu": 2, "silu": 3, "gelu": 4}
GATED_ACTS = ("fatrelu", "drelu", "silu", "gelu")
MASK_MODES = ("threshold", "scale")


def combine(act: str, fatrelu_threshold: float, gate, up):
    """hidden = act(gate, up) for the sparse activations; gate is unused
    (may be None) for "relu"."""
    if act == "fatrelu":
        return torch.where(gate > fatrelu_threshold, gate, 0.0) * up
    if act == "drelu":
        return gate.clamp_min(0.0) * up.clamp_min(0.0)
    if act == "relu":
        return up.clamp_min(0.0)
    if act == "silu":
        return gate * torch.sigmoid(gate) * up
    return F.gelu(gate, approximate="tanh") * up


def _is_gated(act: str, w_gateT_rows) -> bool:
    if act not in ACT_CODES:
        raise ValueError(f"sparse_ffn_block_v6: unsupported activation {act!r}")
    gated = w_gateT_rows is not None and act in GATED_ACTS
    if act != "relu" and not gated:
        raise ValueError(f"activation {act!r} needs a gate store")
    return gated


def sparse_ffn_block_v6_plain(x, idx, gp_sel, w_upT_rows, w_gateT_rows,
                              w_down_rows, *, act: str,
                              fatrelu_threshold: float = 0.0,
                              prob_threshold: float = 0.5, bu_sel=None,
                              mask_mode: str = "threshold") -> torch.Tensor:
    """The same function in plain torch: gather the selected rows, einsum,
    all in f32. x (N, E); idx (N, C) row ids; gp_sel/bu_sel (N, C, G);
    w_upT_rows/w_gateT_rows (R, E, G); w_down_rows (R, G, E) -> (N, E) f32."""
    gated = _is_gated(act, w_gateT_rows)
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode {mask_mode!r}")
    rows = idx.long().clamp(0, w_upT_rows.shape[0] - 1)
    xf = x.float()
    up = torch.einsum("ne,nceg->ncg", xf, w_upT_rows[rows].float())
    if bu_sel is not None:
        up = up + bu_sel.float()
    gate = (torch.einsum("ne,nceg->ncg", xf, w_gateT_rows[rows].float())
            if gated else None)
    hidden = combine(act, fatrelu_threshold, gate, up)
    gp = gp_sel.float()
    hidden = hidden * ((gp >= prob_threshold).float()
                       if mask_mode == "threshold" else gp)
    return torch.einsum("ncg,ncge->ne", hidden, w_down_rows[rows].float())


_lib_cache: list[ctypes.CDLL] = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("sparse_ffn_v6")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sparse_ffn_v6.argtypes = [p] * 9 + [i] * 7 + [f, f, i, p]
        lib.sparse_ffn_v6.restype = i
        lib.sparse_ffn_v6_scratch_floats.argtypes = [i] * 4
        lib.sparse_ffn_v6_scratch_floats.restype = ctypes.c_longlong
        lib.sparse_ffn_v6_error_string.argtypes = [i]
        lib.sparse_ffn_v6_error_string.restype = ctypes.c_char_p
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"sparse_ffn_block_v6: {msg}")


def sparse_ffn_block_v6(x, idx, gp_sel, w_upT_rows, w_gateT_rows, w_down_rows,
                        *, act: str, fatrelu_threshold: float = 0.0,
                        prob_threshold: float = 0.5, bu_sel=None,
                        mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel (counted in `sparse_ffn_block_v6.launches`) or raise.
    Row ids outside [0, R) are clamped, as XLA clamps a gather."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel,
              mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v6_plain(x, idx, gp_sel, w_upT_rows,
                                         w_gateT_rows, w_down_rows, **kw)
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")
    gated = _is_gated(act, w_gateT_rows)
    _check(mask_mode in MASK_MODES, f"mask_mode {mask_mode!r}")
    N, E = x.shape
    C = idx.shape[1]
    R, E_w, G = w_upT_rows.shape
    stores = [w_upT_rows, w_down_rows] + ([w_gateT_rows] if gated else [])
    _check(E_w == E and idx.shape == (N, C), "x/idx/store shapes disagree")
    _check(gp_sel.shape == (N, C, G), f"gp_sel shape {tuple(gp_sel.shape)}")
    _check(w_down_rows.shape == (R, G, E), "w_down_rows must be (R, G, E)")
    _check(not gated or w_gateT_rows.shape == (R, E, G),
           "w_gateT_rows must be (R, E, G)")
    _check(bu_sel is None or bu_sel.shape == (N, C, G), "bu_sel must be (N, C, G)")
    _check(G % 8 == 0 and G <= 2048 and E % 8 == 0,
           "kernel needs G and E multiples of 8, G <= 2048")
    dt = w_upT_rows.dtype
    _check(dt in (torch.bfloat16, torch.float32), f"store dtype {dt}")
    for w in stores:
        _check(w.device == x.device, "stores must be on x's device")
        _check(w.dtype == dt, "stores must share one dtype")
        _check(w.is_contiguous() and w.data_ptr() % 16 == 0,
               "stores must be contiguous and 16-byte aligned")
    small = [t for t in (idx, gp_sel, bu_sel) if t is not None]
    _check(all(t.device == x.device for t in small), "inputs on mixed devices")

    xf = x.float().contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    gp = gp_sel.float().contiguous()
    bu = bu_sel.float().contiguous() if bu_sel is not None else None
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((N, E), **f32)
    scratch = torch.empty((lib.sparse_ffn_v6_scratch_floats(N, C, E, G),), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.sparse_ffn_v6(
            ptr(xf), ptr(idx32), ptr(gp), ptr(bu), ptr(w_upT_rows),
            ptr(w_gateT_rows if gated else None), ptr(w_down_rows), ptr(out),
            ptr(scratch), N, C, E, G, R,
            int(dt == torch.bfloat16), ACT_CODES[act], float(fatrelu_threshold),
            float(prob_threshold), int(mask_mode == "scale"),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.sparse_ffn_v6_error_string(err).decode()
        raise RuntimeError(f"sparse_ffn_v6 launch failed: CUDA error {err} ({msg})")
    sparse_ffn_block_v6.launches += 1
    return out


sparse_ffn_block_v6.launches = 0
