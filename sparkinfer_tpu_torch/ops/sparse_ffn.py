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

`sparse_ffn_block_v6q` is the same function over Q8_0 stores (the port of
`sparse_ffn_block_v6q`, sparse_ffn_pallas.py:706): int8 weights with one
f32 scale per 32 elements (along E for up/gate, along G for down),
dequantized in f32, kernel in csrc/sparse_ffn_v6q.cu; `quantize_rows_q8_0`
packs a v6 store into that layout on the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .quant_matmul import QK, q8_blocks

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


def _v6_from_rows(x, gp_sel, wu, wg, wd, act, fatrelu_threshold,
                  prob_threshold, bu_sel, mask_mode):
    """v6's function from the gathered f32 rows wu/wg (N, C, E, G) and
    wd (N, C, G, E); wg is None for an ungated activation."""
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode {mask_mode!r}")
    xf = x.float()
    up = torch.einsum("ne,nceg->ncg", xf, wu)
    if bu_sel is not None:
        up = up + bu_sel.float()
    gate = torch.einsum("ne,nceg->ncg", xf, wg) if wg is not None else None
    hidden = combine(act, fatrelu_threshold, gate, up)
    gp = gp_sel.float()
    hidden = hidden * ((gp >= prob_threshold).float()
                       if mask_mode == "threshold" else gp)
    return torch.einsum("ncg,ncge->ne", hidden, wd)


def sparse_ffn_block_v6_plain(x, idx, gp_sel, w_upT_rows, w_gateT_rows,
                              w_down_rows, *, act: str,
                              fatrelu_threshold: float = 0.0,
                              prob_threshold: float = 0.5, bu_sel=None,
                              mask_mode: str = "threshold") -> torch.Tensor:
    """The same function in plain torch: gather the selected rows, einsum,
    all in f32. x (N, E); idx (N, C) row ids; gp_sel/bu_sel (N, C, G);
    w_upT_rows/w_gateT_rows (R, E, G); w_down_rows (R, G, E) -> (N, E) f32."""
    gated = _is_gated(act, w_gateT_rows)
    rows = idx.long().clamp(0, w_upT_rows.shape[0] - 1)
    wg = w_gateT_rows[rows].float() if gated else None
    return _v6_from_rows(x, gp_sel, w_upT_rows[rows].float(), wg,
                         w_down_rows[rows].float(), act, fatrelu_threshold,
                         prob_threshold, bu_sel, mask_mode)


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
        raise ValueError(f"sparse FFN kernel: {msg}")


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


# ---------------------------------------------------------------------------
# v6q: v6 over Q8_0 stores


def dequant_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """A v6q store in f32: q (..., B, L) int8 with scales (..., B/32, L) f32,
    each scale repeated over its 32 rows (`_dequant_sub`,
    sparse_ffn_pallas.py:653)."""
    B, L = q.shape[-2:]
    qf = q.float().reshape(q.shape[:-2] + (B // QK, QK, L))
    return (qf * s.float()[..., :, None, :]).reshape(q.shape)


def quantize_rows_q8_0(w_rows: torch.Tensor):
    """Quantize a v6 weight store to the v6q layout, on the tensor's device,
    with the ggml blocks along axis -2: an up/gate store w (..., E, G) ->
    (qw int8 (..., E, G), scales f32 (..., E/32, G)); a down store
    w (..., G, E) -> (qw int8 (..., G, E), scales f32 (..., G/32, E)).
    Bit-equal to the JAX package's numpy packer (scale = amax / 127, round
    half to even), whose `transposed` flag selects no other arithmetic."""
    w = w_rows.float()
    B = w.shape[-2]
    if B % QK:
        raise ValueError(f"blocked axis {B} is not a multiple of {QK}")
    q, s = q8_blocks(w.reshape(w.shape[:-2] + (B // QK, QK, w.shape[-1])), -2)
    return q.reshape(w.shape), s


def sparse_ffn_block_v6q_plain(x, idx, gp_sel, qw_upT, s_upT, qw_gateT, s_gateT,
                               qw_down, s_down, *, act: str,
                               fatrelu_threshold: float = 0.0,
                               prob_threshold: float = 0.5, bu_sel=None,
                               mask_mode: str = "threshold") -> torch.Tensor:
    """v6q in plain torch: gather the selected rows, dequantize in f32,
    einsum. Stores: qw_upT/qw_gateT (R, E, G) int8 with s_upT/s_gateT
    (R, E/32, G) f32; qw_down (R, G, E) int8 with s_down (R, G/32, E)."""
    gated = _is_gated(act, qw_gateT)
    rows = idx.long().clamp(0, qw_upT.shape[0] - 1)
    wg = dequant_rows(qw_gateT[rows], s_gateT[rows]) if gated else None
    return _v6_from_rows(x, gp_sel, dequant_rows(qw_upT[rows], s_upT[rows]), wg,
                         dequant_rows(qw_down[rows], s_down[rows]), act,
                         fatrelu_threshold, prob_threshold, bu_sel, mask_mode)


_libq_cache: list[ctypes.CDLL] = []


def _libq() -> ctypes.CDLL:
    if not _libq_cache:
        lib = _build.load("sparse_ffn_v6q")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sparse_ffn_v6q.argtypes = [p] * 12 + [i] * 6 + [f, f, i, p]
        lib.sparse_ffn_v6q.restype = i
        lib.sparse_ffn_v6q_scratch_floats.argtypes = [i] * 4
        lib.sparse_ffn_v6q_scratch_floats.restype = ctypes.c_longlong
        lib.sparse_ffn_v6q_error_string.argtypes = [i]
        lib.sparse_ffn_v6q_error_string.restype = ctypes.c_char_p
        _libq_cache.append(lib)
    return _libq_cache[0]


def sparse_ffn_block_v6q(x, idx, gp_sel, qw_upT, s_upT, qw_gateT, s_gateT,
                         qw_down, s_down, *, act: str,
                         fatrelu_threshold: float = 0.0,
                         prob_threshold: float = 0.5, bu_sel=None,
                         mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel (counted in `sparse_ffn_block_v6q.launches`) or raise.
    Row ids outside [0, R) are clamped, as XLA clamps a gather."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v6q_plain(x, idx, gp_sel, qw_upT, s_upT, qw_gateT,
                                          s_gateT, qw_down, s_down, **kw)
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")
    gated = _is_gated(act, qw_gateT)
    _check(mask_mode in MASK_MODES, f"mask_mode {mask_mode!r}")
    N, E = x.shape
    C = idx.shape[1]
    R, E_w, G = qw_upT.shape
    _check(E_w == E and idx.shape == (N, C), "x/idx/store shapes disagree")
    _check(G % QK == 0 and E % QK == 0 and G <= 4096,
           f"kernel needs G and E multiples of {QK}, G <= 4096 (G={G}, E={E})")
    _check(gp_sel.shape == (N, C, G), f"gp_sel shape {tuple(gp_sel.shape)}")
    _check(bu_sel is None or bu_sel.shape == (N, C, G), "bu_sel must be (N, C, G)")
    stores = [(qw_upT, (R, E, G), s_upT, (R, E // QK, G)),
              (qw_down, (R, G, E), s_down, (R, G // QK, E))]
    if gated:
        stores.append((qw_gateT, (R, E, G), s_gateT, (R, E // QK, G)))
    for q, qshape, s, sshape in stores:
        _check(q.dtype == torch.int8 and s.dtype == torch.float32,
               f"stores must be int8 with f32 scales, got {q.dtype}, {s.dtype}")
        _check(q.shape == qshape and s.shape == sshape,
               f"store {tuple(q.shape)} / scales {tuple(s.shape)}, want {qshape} / {sshape}")
        for t in (q, s):
            _check(t.device == x.device, "stores must be on x's device")
            _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
                   "stores must be contiguous and 16-byte aligned")
    small = [t for t in (idx, gp_sel, bu_sel) if t is not None]
    _check(all(t.device == x.device for t in small), "inputs on mixed devices")

    xf = x.float().contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    gp = gp_sel.float().contiguous()
    bu = bu_sel.float().contiguous() if bu_sel is not None else None
    lib = _libq()
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((N, E), **f32)
    scratch = torch.empty((lib.sparse_ffn_v6q_scratch_floats(N, C, E, G),), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.sparse_ffn_v6q(
            ptr(xf), ptr(idx32), ptr(gp), ptr(bu), ptr(qw_upT), ptr(s_upT),
            ptr(qw_gateT if gated else None), ptr(s_gateT if gated else None),
            ptr(qw_down), ptr(s_down), ptr(out), ptr(scratch), N, C, E, G, R,
            ACT_CODES[act], float(fatrelu_threshold), float(prob_threshold),
            int(mask_mode == "scale"), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.sparse_ffn_v6q_error_string(err).decode()
        raise RuntimeError(f"sparse_ffn_v6q launch failed: CUDA error {err} ({msg})")
    sparse_ffn_block_v6q.launches += 1
    return out


sparse_ffn_block_v6q.launches = 0
