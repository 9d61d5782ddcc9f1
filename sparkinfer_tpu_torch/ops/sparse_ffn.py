"""Fused predictor-gated sparse FFN kernels and their plain torch versions.

Each wrapper dispatches on the device of `x`: a CPU tensor runs the plain
version, a CUDA tensor launches the hand-written kernel (csrc/, built by
`_build` at first use, counted in the wrapper's `.launches`) and never the
plain version. Row ids outside [0, R) are clamped, as XLA clamps a gather.
For each token n and selected row r = idx[n, c]:

    up   = x[n] . W_up[r] + bu_sel[n, c]
    gate = x[n] . W_gate[r] (+ bg_sel[n, c])      gated activations only
    h    = combine(act, gate, up) * mask          mask = gp >= thr, or gp
    out[n] = sum_c h . W_down[r]

  - `sparse_ffn_block_v6` (sparkinfer_tpu/ops/sparse_ffn_pallas.py:564,
    csrc/sparse_ffn_v6.cu): transposed flat stores (R, E, G) for up/gate,
    (R, G, E) for down, all in f32 (the hidden is not rounded before the
    down product); one launch with f32 FMAs, its selections added through
    a per-device workspace of counters (`v6_plan` gives its shape);
  - `sparse_ffn_block_v6q` (:706, csrc/sparse_ffn_v6q.cu): v6 over Q8_0
    stores, int8 with one f32 scale per 32 elements (along E for up/gate,
    along G for down), dequantized in f32; `quantize_rows_q8_0` packs a v6
    store into that layout on the tensor's device; two launches with f32
    FMAs (`v6q_plan` gives their shape);
  - `sparse_ffn_block` (v1, :124, csrc/sparse_ffn_v1.cu): row stores
    (R, G, E) for all three projections, the only gate bias (bg_sel) and
    the only gated swiglu_oai of the three-store kernels; the hidden is
    rounded to the store dtype before the down product (:105), so bf16
    stores round it to bf16;
  - `sparse_ffn_block_v3` (:306) and `sparse_ffn_block_v5` (:888): v1's
    function over v1's stores, without bg_sel, gated for fatrelu, drelu,
    silu and gelu; `sparse_ffn_block_v4` (:446) over one interleaved
    (R, P, G, E) store (`interleave_rows`); `sparse_ffn_block_v2` (:1044)
    over one concatenated (P*R, G, E) store. v2 and v4 take `gated` from
    the caller. All four round the hidden as v1 does and launch v1's kernel
    with their own strides and offsets: on the TPU they differ only in how
    the DMA is scheduled. One launch a call with f32 FMAs, x read in its own
    dtype, the selections added through a per-device workspace of counters
    as v6's (`v1_plan` gives its shape);
  - `sparse_ffn_block_v7u` (:1172, csrc/sparse_ffn_v7u.cu): batched decode
    over the cross-token union of selected groups, each union row read once
    for all B tokens, with v6's flat stores; the up/gate stores are cast to
    x's dtype and the hidden and W_down are rounded to bf16 (:1135-1156);
    two launches on the tensor cores (`v7u_plan` gives their shape).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, workspace
from .quant_matmul import QK, q8_blocks

# activation codes of csrc/sparse_ffn_common.cuh; "relu" is the only ungated
# one, and the gate store is read only for the gated ones
ACT_CODES = {"fatrelu": 0, "drelu": 1, "relu": 2, "silu": 3, "gelu": 4,
             "swiglu_oai": 5}
GATED_ACTS = ("fatrelu", "drelu", "silu", "gelu")  # v6, v6q, v7u (:585, :1193)
GATED_ACTS_V1 = GATED_ACTS + ("swiglu_oai",)  # v1 (sparse_ffn_pallas.py:149)
MASK_MODES = ("threshold", "scale")


def combine(act: str, fatrelu_threshold: float, gate, up):
    """hidden = act(gate, up) for the sparse activations
    (sparse_ffn_pallas.py:41-58); gate is unused (may be None) for "relu"."""
    if act == "fatrelu":
        return torch.where(gate > fatrelu_threshold, gate, 0.0) * up
    if act == "drelu":
        return gate.clamp_min(0.0) * up.clamp_min(0.0)
    if act == "relu":
        return up.clamp_min(0.0)
    if act == "silu":
        return gate * torch.sigmoid(gate) * up
    if act == "swiglu_oai":
        # gpt-oss clamped swiglu (ggml_swiglu_oai): gate clamped above at 7,
        # up clamped both ways, sigmoid slope 1.702, (up + 1) shift
        g = gate.clamp_max(7.0)
        return g * torch.sigmoid(1.702 * g) * (up.clamp(-7.0, 7.0) + 1.0)
    return F.gelu(gate, approximate="tanh") * up


def _is_gated(act: str, w_gate, gated_acts=GATED_ACTS) -> bool:
    if act != "relu" and act not in gated_acts:
        raise ValueError(f"sparse FFN kernel: unsupported activation {act!r}")
    if act != "relu" and w_gate is None:
        raise ValueError(f"activation {act!r} needs a gate store")
    return act != "relu"


def _from_rows(x, gp_sel, wu, wg, wd, act, fatrelu_threshold, prob_threshold,
               bu_sel, mask_mode, bg_sel=None, hidden_dtype=None):
    """The sparse FFN from the gathered f32 rows wu/wg (N, C, E, G) and
    wd (N, C, G, E); wg is None for an ungated activation. hidden_dtype
    rounds the hidden before the down product (v1's quirk)."""
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode {mask_mode!r}")
    xf = x.float()
    up = torch.einsum("ne,nceg->ncg", xf, wu)
    if bu_sel is not None:
        up = up + bu_sel.float()
    gate = None
    if wg is not None:
        gate = torch.einsum("ne,nceg->ncg", xf, wg)
        if bg_sel is not None:
            gate = gate + bg_sel.float()
    hidden = combine(act, fatrelu_threshold, gate, up)
    gp = gp_sel.float()
    hidden = hidden * ((gp >= prob_threshold).float()
                       if mask_mode == "threshold" else gp)
    if hidden_dtype is not None:
        hidden = hidden.to(hidden_dtype).float()
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
    return _from_rows(x, gp_sel, w_upT_rows[rows].float(), wg,
                      w_down_rows[rows].float(), act, fatrelu_threshold,
                      prob_threshold, bu_sel, mask_mode)


_typed: set[str] = set()  # libraries whose C signatures are declared
_v6_workspace: dict[int, torch.Tensor] = {}  # v6's counters, by device index
V6_MAX_E = 32768  # 16 splits of at most 2048 columns (csrc/sparse_ffn_v6.cu)
V6_MAX_N = 4096  # 16 splits a token in the workspace's 65536 counters


def _kernel_lib(name: str, n_ptr: int, n_int: int, n_ll: int = 0,
                n_scratch: int = 4) -> ctypes.CDLL:
    """The loaded csrc/<name>.cu, whose entry `name` takes n_ptr pointers,
    n_int ints, n_ll long longs, (fatrelu_threshold, prob_threshold) as
    floats, the mask mode and the stream; `<name>_scratch_floats` takes
    n_scratch ints."""
    lib = _build.load(name)
    if name not in _typed:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        getattr(lib, name).argtypes = [p] * n_ptr + [i] * n_int + [ll] * n_ll + [f, f, i, p]
        getattr(lib, name).restype = i
        getattr(lib, name + "_scratch_floats").argtypes = [i] * n_scratch
        getattr(lib, name + "_scratch_floats").restype = ctypes.c_longlong
        getattr(lib, name + "_error_string").argtypes = [i]
        getattr(lib, name + "_error_string").restype = ctypes.c_char_p
        if hasattr(lib, name + "_workspace_words"):
            getattr(lib, name + "_workspace_words").argtypes = []
            getattr(lib, name + "_workspace_words").restype = ctypes.c_longlong
        _typed.add(name)
    return lib


def _launch(lib: ctypes.CDLL, name: str, device, *args):
    """Call the kernel entry on the device's current stream; raise on a
    CUDA error of the launches."""
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = getattr(lib, name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"sparse FFN kernel: {msg}")


def _cuda_only(x):
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")


def _check_stores(x, stores, dtypes=(torch.bfloat16, torch.float32)):
    """Every store on x's device, of one dtype in `dtypes`, contiguous and
    16-byte aligned."""
    dt = stores[0].dtype
    _check(dt in dtypes, f"store dtype {dt}")
    for w in stores:
        _check(w.device == x.device, "stores must be on x's device")
        _check(w.dtype == dt, "stores must share one dtype")
        _check(w.is_contiguous() and w.data_ptr() % 16 == 0,
               "stores must be contiguous and 16-byte aligned")


def _f32(t):
    """t as a contiguous f32 tensor (None stays None)."""
    return None if t is None else t.float().contiguous()


def _kernel_x(x):
    """x as the kernels read it, without a copy where it already is: bf16 or
    f32 (another dtype as f32), contiguous, its data on 16 bytes (a
    misaligned view is copied)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.float()
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def sparse_ffn_block_v6(x, idx, gp_sel, w_upT_rows, w_gateT_rows, w_down_rows,
                        *, act: str, fatrelu_threshold: float = 0.0,
                        prob_threshold: float = 0.5, bu_sel=None,
                        mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel (one launch a call, counted in `sparse_ffn_block_v6.launches`)
    or raise. x (bf16 or f32) is read in its own dtype. Row ids outside
    [0, R) are clamped, as XLA clamps a gather. The kernel adds its
    selections through a per-device workspace of counters, allocated zeroed
    at the first call on a device, which therefore must come before any
    CUDA-graph capture; two streams must not run it at once on one device."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel,
              mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v6_plain(x, idx, gp_sel, w_upT_rows,
                                         w_gateT_rows, w_down_rows, **kw)
    _cuda_only(x)
    gated = _is_gated(act, w_gateT_rows)
    _check(mask_mode in MASK_MODES, f"mask_mode {mask_mode!r}")
    N, E = x.shape
    C = idx.shape[1]
    R, E_w, G = w_upT_rows.shape
    _check(E_w == E and idx.shape == (N, C), "x/idx/store shapes disagree")
    _check(gp_sel.shape == (N, C, G), f"gp_sel shape {tuple(gp_sel.shape)}")
    _check(w_down_rows.shape == (R, G, E), "w_down_rows must be (R, G, E)")
    _check(not gated or w_gateT_rows.shape == (R, E, G),
           "w_gateT_rows must be (R, E, G)")
    _check(bu_sel is None or bu_sel.shape == (N, C, G), "bu_sel must be (N, C, G)")
    _check(G % 8 == 0 and G <= 2048 and E % 8 == 0,
           "kernel needs G and E multiples of 8, G <= 2048")
    _check(E <= V6_MAX_E and N <= V6_MAX_N,
           f"kernel takes E <= {V6_MAX_E} and N <= {V6_MAX_N} (E={E}, N={N})")
    _check_stores(x, [w_upT_rows, w_down_rows] + ([w_gateT_rows] if gated else []))
    small = [t for t in (idx, gp_sel, bu_sel) if t is not None]
    _check(all(t.device == x.device for t in small), "inputs on mixed devices")

    # x is read in its own dtype (bf16 or f32), gp_sel and bu_sel in place
    # when they are contiguous f32; every tensor whose pointer the kernel
    # gets stays referenced until the launch is enqueued, so the allocator
    # cannot hand its memory on first
    x = _kernel_x(x)
    idx32, gp, bu = idx.to(torch.int32).contiguous(), _f32(gp_sel), _f32(bu_sel)
    lib = _kernel_lib("sparse_ffn_v6", 10, 8)
    counters = workspace.zeroed(_v6_workspace, x.device, lib.sparse_ffn_v6_workspace_words(),
                                "sparse_ffn_block_v6")
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((N, E), **f32)
    floats = lib.sparse_ffn_v6_scratch_floats(N, C, E, G)
    part = torch.empty((floats,), **f32) if floats else None
    _launch(lib, "sparse_ffn_v6", x.device,
            _ptr(x), _ptr(idx32), _ptr(gp), _ptr(bu), _ptr(w_upT_rows),
            _ptr(w_gateT_rows if gated else None), _ptr(w_down_rows), _ptr(out),
            _ptr(part), _ptr(counters), N, C, E, G, R,
            int(w_upT_rows.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
            ACT_CODES[act], float(fatrelu_threshold), float(prob_threshold),
            int(mask_mode == "scale"))
    sparse_ffn_block_v6.launches += 1
    return out


def v6_plan(device, N: int, C: int, E: int, G: int, *, gated: bool = True,
            w_dtype=torch.bfloat16, x_dtype=torch.bfloat16) -> dict:
    """The launch shape of `sparse_ffn_block_v6` on a CUDA device: the
    splits of E (the cluster size KS), the blocks (N * C * KS), the wave
    ratio (the most stages an SM streams over an even share), the shared
    bytes of a block, the rows of an up/gate stage and of a down stage, the
    stages of the widest block and the columns of a down box."""
    lib = _kernel_lib("sparse_ffn_v6", 10, 8)
    fn = lib.sparse_ffn_v6_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    v = (ctypes.c_longlong * 9)()
    with torch.cuda.device(device):
        err = fn(N, C, E, G, int(gated), int(w_dtype == torch.bfloat16),
                 int(x_dtype == torch.bfloat16), v)
    if err:
        raise RuntimeError(f"sparse_ffn_v6_plan failed: CUDA error {err}")
    return {"sms": v[0], "splits": v[1], "blocks": v[2], "wave_ratio": v[3] / 1e6,
            "smem_bytes": v[4], "up_rows": v[5], "down_rows": v[6], "stages": v[7],
            "down_box_cols": v[8]}


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
    return _from_rows(x, gp_sel, dequant_rows(qw_upT[rows], s_upT[rows]), wg,
                      dequant_rows(qw_down[rows], s_down[rows]), act,
                      fatrelu_threshold, prob_threshold, bu_sel, mask_mode)


def sparse_ffn_block_v6q(x, idx, gp_sel, qw_upT, s_upT, qw_gateT, s_gateT,
                         qw_down, s_down, *, act: str,
                         fatrelu_threshold: float = 0.0,
                         prob_threshold: float = 0.5, bu_sel=None,
                         mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel (two kernels, counted once in `sparse_ffn_block_v6q.launches`)
    or raise. x (bf16 or f32) is read in its own dtype. Row ids outside
    [0, R) are clamped, as XLA clamps a gather."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v6q_plain(x, idx, gp_sel, qw_upT, s_upT, qw_gateT,
                                          s_gateT, qw_down, s_down, **kw)
    _cuda_only(x)
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

    # x is read in its own dtype (bf16 or f32), gp_sel and bu_sel in place
    # when they are contiguous f32
    x = _kernel_x(x)
    idx32, gp, bu = idx.to(torch.int32).contiguous(), _f32(gp_sel), _f32(bu_sel)
    lib = _kernel_lib("sparse_ffn_v6q", 12, 7)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((N, E), **f32)
    hidden = torch.empty((lib.sparse_ffn_v6q_scratch_floats(N, C, E, G),), **f32)
    _launch(lib, "sparse_ffn_v6q", x.device,
            _ptr(x), _ptr(idx32), _ptr(gp), _ptr(bu), _ptr(qw_upT), _ptr(s_upT),
            _ptr(qw_gateT if gated else None), _ptr(s_gateT if gated else None),
            _ptr(qw_down), _ptr(s_down), _ptr(out), _ptr(hidden), N, C, E, G, R,
            int(x.dtype == torch.bfloat16), ACT_CODES[act], float(fatrelu_threshold),
            float(prob_threshold), int(mask_mode == "scale"))
    sparse_ffn_block_v6q.launches += 1
    return out


def v6q_plan(device, N: int, C: int, E: int, G: int, *, gated: bool = True,
             x_dtype=torch.bfloat16) -> dict:
    """The launch shape of `sparse_ffn_block_v6q` on a CUDA device: for each
    of its two launches (up: up, gate and hidden over tiles of G columns;
    down: the down product over tiles of E columns) the column tile, the
    cluster size (splits of the reduction), the blocks and the wave ratio
    (the most stages an SM streams over an even share)."""
    lib = _kernel_lib("sparse_ffn_v6q", 12, 7)
    fn = lib.sparse_ffn_v6q_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    v = (ctypes.c_longlong * 10)()
    with torch.cuda.device(device):
        err = fn(N, C, E, G, int(gated), int(x_dtype == torch.bfloat16), v)
    if err:
        raise RuntimeError(f"sparse_ffn_v6q_plan failed: CUDA error {err}")
    return {"sms": v[0],
            "up": {"tile": v[1], "cluster": v[2], "blocks": v[3], "wave_ratio": v[4] / 1e6},
            "down": {"tile": v[5], "cluster": v[6], "blocks": v[7], "wave_ratio": v[8] / 1e6},
            "smem_bytes": v[9]}


sparse_ffn_block_v6q.launches = 0


# ---------------------------------------------------------------------------
# neuron-row stores: v1 (the serving Scheduler's decode), v2, v3, v4, v5
#
# One CUDA kernel (csrc/sparse_ffn_v1.cu) serves all five: they compute one
# function over (G, E) neuron rows and differ only in where a row lives. Row
# r of projection p starts at element off_p + r * row_stride of its store.


def _rows_ffn(x, gp_sel, wu, wg, wd, *, act, fatrelu_threshold, prob_threshold,
              bu_sel, mask_mode, bg_sel=None):
    """The row-store sparse FFN from the gathered rows wu/wg/wd (N, C, G, E)
    in the store dtype (wg None where the gate is not computed): up and gate
    are f32 sums of the exact products of x and the store, the hidden is
    rounded to the store dtype before the down product."""
    def col(w):  # (N, C, E, G) view
        return w.float().transpose(-1, -2)

    return _from_rows(x, gp_sel, col(wu), None if wg is None else col(wg), wd.float(),
                      act, fatrelu_threshold, prob_threshold, bu_sel, mask_mode,
                      bg_sel=bg_sel, hidden_dtype=wd.dtype)


def _explicit_gate(act: str, gated: bool) -> bool:
    """v2 and v4 take `gated` from the caller: the gate row is read for any
    activation when it is set ("relu" ignores it), and an activation that
    needs the gate fails without it (in JAX on a None gate). Returns whether
    the gate is computed."""
    if act != "relu" and act not in GATED_ACTS_V1:
        raise ValueError(f"sparse FFN kernel: unsupported activation {act!r}")
    if act != "relu" and not gated:
        raise ValueError(f"activation {act!r} needs gated=True")
    return gated and act != "relu"


def sparse_ffn_block_plain(x, idx, gp_sel, w_up_rows, w_gate_rows, w_down_rows,
                           *, act: str, fatrelu_threshold: float = 0.0,
                           prob_threshold: float = 0.5, bu_sel=None, bg_sel=None,
                           mask_mode: str = "threshold") -> torch.Tensor:
    """v1 in plain torch. x (N, E); idx (N, C) row ids; gp_sel/bu_sel/bg_sel
    (N, C, G); w_up_rows/w_gate_rows/w_down_rows (R, G, E) -> (N, E) f32.
    Up and gate are f32 sums of the exact products of x and the store, the
    hidden is rounded to the store dtype before the down product."""
    gated = _is_gated(act, w_gate_rows, GATED_ACTS_V1)
    rows = idx.long().clamp(0, w_up_rows.shape[0] - 1)
    return _rows_ffn(x, gp_sel, w_up_rows[rows], w_gate_rows[rows] if gated else None,
                     w_down_rows[rows], act=act, fatrelu_threshold=fatrelu_threshold,
                     prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode,
                     bg_sel=bg_sel)


def sparse_ffn_block_v3_plain(x, idx, gp_sel, w_up_rows, w_gate_rows, w_down_rows,
                              *, act: str, fatrelu_threshold: float = 0.0,
                              prob_threshold: float = 0.5, bu_sel=None,
                              mask_mode: str = "threshold") -> torch.Tensor:
    """v3 in plain torch: v1 over v1's stores without a gate bias, gated
    only for fatrelu/drelu/silu/gelu (sparse_ffn_pallas.py:328)."""
    gated = _is_gated(act, w_gate_rows)
    rows = idx.long().clamp(0, w_up_rows.shape[0] - 1)
    return _rows_ffn(x, gp_sel, w_up_rows[rows], w_gate_rows[rows] if gated else None,
                     w_down_rows[rows], act=act, fatrelu_threshold=fatrelu_threshold,
                     prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)


# v5 (sparse_ffn_pallas.py:888) computes v3's function over the same stores
sparse_ffn_block_v5_plain = sparse_ffn_block_v3_plain


def interleave_rows(w_up_rows, w_gate_rows, w_down_rows) -> torch.Tensor:
    """(..., R, G, E) x P -> the (..., R, P, G, E) interleaved store of v4,
    [up, (gate,) down] per row (sparse_ffn_pallas.py:967)."""
    parts = [w_up_rows] + ([] if w_gate_rows is None else [w_gate_rows]) + [w_down_rows]
    return torch.stack(parts, dim=-3)


def sparse_ffn_block_v4_plain(x, idx, gp_sel, w_rows_il, *, act: str, gated: bool,
                              fatrelu_threshold: float = 0.0,
                              prob_threshold: float = 0.5, bu_sel=None,
                              mask_mode: str = "threshold") -> torch.Tensor:
    """v4 in plain torch over the interleaved store w_rows_il (R, P, G, E),
    P = 3 if gated else 2."""
    R, P = w_rows_il.shape[:2]
    _check(P == (3 if gated else 2), f"interleaved store has P={P}, gated={gated}")
    gate = _explicit_gate(act, gated)
    w = w_rows_il[idx.long().clamp(0, R - 1)]  # (N, C, P, G, E)
    return _rows_ffn(x, gp_sel, w[:, :, 0], w[:, :, 1] if gate else None, w[:, :, P - 1],
                     act=act, fatrelu_threshold=fatrelu_threshold,
                     prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)


def sparse_ffn_block_v2_plain(x, idx, gp_sel, w_all_rows, *, act: str, gated: bool,
                              R: int, fatrelu_threshold: float = 0.0,
                              prob_threshold: float = 0.5, bu_sel=None,
                              mask_mode: str = "threshold") -> torch.Tensor:
    """v2 in plain torch over the concatenated store w_all_rows (P*R, G, E),
    [up; (gate;) down], P = 3 if gated else 2: projection p of row idx is
    row p*R + idx (sparse_ffn_pallas.py:1073). Ids are clamped into [0, R),
    where the JAX kernel would read another projection's rows."""
    P = 3 if gated else 2
    _check(w_all_rows.shape[0] == P * R, f"store has {w_all_rows.shape[0]} rows, want {P}*{R}")
    gate = _explicit_gate(act, gated)
    rows = idx.long().clamp(0, R - 1)
    return _rows_ffn(x, gp_sel, w_all_rows[rows], w_all_rows[R + rows] if gate else None,
                     w_all_rows[(P - 1) * R + rows], act=act,
                     fatrelu_threshold=fatrelu_threshold, prob_threshold=prob_threshold,
                     bu_sel=bu_sel, mask_mode=mask_mode)


_v1_workspace: dict[int, torch.Tensor] = {}  # the row kernel's counters, by device index
V1_MAX_E = 8192  # 4 chunks of 8 columns a thread, 256 threads (csrc/sparse_ffn_v1.cu)
V1_MAX_N = 4096  # 16 splits a token in the workspace's 65536 counters


def _rows_kernel(x, idx, gp_sel, stores, offsets, row_stride: int, R: int, G: int, E: int, *,
                 act: str, fatrelu_threshold: float, prob_threshold: float, bu_sel,
                 mask_mode: str, bg_sel=None) -> torch.Tensor:
    """Launch the strided row kernel (csrc/sparse_ffn_v1.cu, one kernel a
    call). stores: the up, gate and down tensors (gate None where it is not
    read; they may be one tensor), whose neuron g of row r of projection p
    starts at element offsets[p] + r * row_stride + g * E. Checks what every
    row wrapper shares; the caller checks its store's shape, (.., G, E). The
    kernel adds its selections through a per-device workspace of counters,
    allocated zeroed at the first call on a device, which therefore must
    come before any CUDA-graph capture; two streams must not run it at once
    on one device."""
    _check(mask_mode in MASK_MODES, f"mask_mode {mask_mode!r}")
    N, C = idx.shape
    _check(x.shape == (N, E), "x/idx/store shapes disagree")
    for name, t in (("gp_sel", gp_sel), ("bu_sel", bu_sel), ("bg_sel", bg_sel)):
        _check(t is None or t.shape == (N, C, G), f"{name} must be (N, C, G)")
    _check(E % 8 == 0, f"kernel needs E a multiple of 8 (E={E})")
    _check(E <= V1_MAX_E and N <= V1_MAX_N,
           f"kernel takes E <= {V1_MAX_E} and N <= {V1_MAX_N} (E={E}, N={N})")
    _check_stores(x, [w for w in stores if w is not None])
    small = [t for t in (idx, gp_sel, bu_sel, bg_sel) if t is not None]
    _check(all(t.device == x.device for t in small), "inputs on mixed devices")

    # x is read in its own dtype (bf16 or f32), gp_sel, bu_sel and bg_sel in
    # place when they are contiguous f32
    x, idx32 = _kernel_x(x), idx.to(torch.int32).contiguous()
    gp, bu, bg = _f32(gp_sel), _f32(bu_sel), _f32(bg_sel)
    wu, wg, wd = stores
    lib = _kernel_lib("sparse_ffn_v1", 11, 8, n_ll=4, n_scratch=7)
    counters = workspace.zeroed(_v1_workspace, x.device, lib.sparse_ffn_v1_workspace_words(),
                                "sparse_ffn_block")
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((N, E), **f32)
    keys = (int(wg is not None), int(wu.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16))
    with torch.cuda.device(x.device):
        floats = lib.sparse_ffn_v1_scratch_floats(N, C, E, G, *keys)
    part = torch.empty((floats,), **f32) if floats else None
    _launch(lib, "sparse_ffn_v1", x.device,
            _ptr(x), _ptr(idx32), _ptr(gp), _ptr(bu), _ptr(bg), _ptr(wu), _ptr(wg),
            _ptr(wd), _ptr(out), _ptr(part), _ptr(counters), N, C, E, G, R, *keys[1:],
            ACT_CODES[act], row_stride, *offsets, float(fatrelu_threshold),
            float(prob_threshold), int(mask_mode == "scale"))
    return out


def v1_plan(device, N: int, C: int, E: int, G: int, *, gated: bool = True,
            w_dtype=torch.bfloat16, x_dtype=torch.bfloat16) -> dict:
    """The launch shape of the row kernel (`sparse_ffn_block`, `_v2`-`_v5`)
    on a CUDA device: the cluster size KS (splits), the clusters of each
    token, the blocks (N * clusters * KS, each owning an even share of its
    token's C * G rows), the wave ratio (the rows the busiest SM streams
    over an even share), the shared bytes of a block, the rows of each
    projection in an up/gate stage and of a down stage, and the stages of
    the widest block."""
    lib = _kernel_lib("sparse_ffn_v1", 11, 8, n_ll=4, n_scratch=7)
    fn = lib.sparse_ffn_v1_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    v = (ctypes.c_longlong * 9)()
    with torch.cuda.device(device):
        err = fn(N, C, E, G, int(gated), int(w_dtype == torch.bfloat16),
                 int(x_dtype == torch.bfloat16), v)
    if err:
        raise RuntimeError(f"sparse_ffn_v1_plan failed: CUDA error {err}")
    return {"sms": v[0], "splits": v[1], "clusters_per_token": v[2], "blocks": v[3],
            "wave_ratio": v[4] / 1e6, "smem_bytes": v[5], "up_rows": v[6], "down_rows": v[7],
            "stages": v[8]}


def _three_stores(wrapper, plain, gated_acts, x, idx, gp_sel, w_up_rows, w_gate_rows,
                  w_down_rows, kw):
    """v1, v3, v5 over three (R, G, E) stores: the plain version for CPU
    tensors, else the row kernel, counted in wrapper.launches."""
    if x.device.type == "cpu":
        return plain(x, idx, gp_sel, w_up_rows, w_gate_rows, w_down_rows, **kw)
    _cuda_only(x)
    gated = _is_gated(kw["act"], w_gate_rows, gated_acts)
    R, G, E = w_up_rows.shape
    stores = [w_up_rows, w_gate_rows if gated else None, w_down_rows]
    _check(all(w is None or w.shape == (R, G, E) for w in stores), "stores must be (R, G, E)")
    if not gated:
        kw = dict(kw, bg_sel=None)
    out = _rows_kernel(x, idx, gp_sel, stores, (0, 0, 0), G * E, R, G, E, **kw)
    wrapper.launches += 1
    return out


def sparse_ffn_block(x, idx, gp_sel, w_up_rows, w_gate_rows, w_down_rows, *,
                     act: str, fatrelu_threshold: float = 0.0,
                     prob_threshold: float = 0.5, bu_sel=None, bg_sel=None,
                     mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel (counted in `sparse_ffn_block.launches`) or raise. Row ids
    outside [0, R) are clamped, as XLA clamps a gather."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, bg_sel=bg_sel,
              mask_mode=mask_mode)
    return _three_stores(sparse_ffn_block, sparse_ffn_block_plain, GATED_ACTS_V1, x, idx,
                         gp_sel, w_up_rows, w_gate_rows, w_down_rows, kw)


sparse_ffn_block.launches = 0


def sparse_ffn_block_v3(x, idx, gp_sel, w_up_rows, w_gate_rows, w_down_rows, *,
                        act: str, fatrelu_threshold: float = 0.0,
                        prob_threshold: float = 0.5, bu_sel=None,
                        mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the row kernel (counted in `sparse_ffn_block_v3.launches`) or raise."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)
    return _three_stores(sparse_ffn_block_v3, sparse_ffn_block_v3_plain, GATED_ACTS, x, idx,
                         gp_sel, w_up_rows, w_gate_rows, w_down_rows, kw)


sparse_ffn_block_v3.launches = 0


def sparse_ffn_block_v5(x, idx, gp_sel, w_up_rows, w_gate_rows, w_down_rows, *,
                        act: str, fatrelu_threshold: float = 0.0,
                        prob_threshold: float = 0.5, bu_sel=None,
                        mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the row kernel (counted in `sparse_ffn_block_v5.launches`) or raise."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)
    return _three_stores(sparse_ffn_block_v5, sparse_ffn_block_v5_plain, GATED_ACTS, x, idx,
                         gp_sel, w_up_rows, w_gate_rows, w_down_rows, kw)


sparse_ffn_block_v5.launches = 0


def sparse_ffn_block_v4(x, idx, gp_sel, w_rows_il, *, act: str, gated: bool,
                        fatrelu_threshold: float = 0.0, prob_threshold: float = 0.5,
                        bu_sel=None, mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32 from the interleaved store w_rows_il (R, P, G, E). CPU
    tensors run the plain version; CUDA tensors launch the row kernel
    (counted in `sparse_ffn_block_v4.launches`) or raise."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v4_plain(x, idx, gp_sel, w_rows_il, gated=gated, **kw)
    _cuda_only(x)
    _check(w_rows_il.dim() == 4, "interleaved store must be (R, P, G, E)")
    R, P, G, E = w_rows_il.shape
    _check(P == (3 if gated else 2), f"interleaved store has P={P}, gated={gated}")
    gate = _explicit_gate(act, gated)
    stores = [w_rows_il, w_rows_il if gate else None, w_rows_il]
    out = _rows_kernel(x, idx, gp_sel, stores, (0, G * E, (P - 1) * G * E), P * G * E, R,
                       G, E, **kw)
    sparse_ffn_block_v4.launches += 1
    return out


sparse_ffn_block_v4.launches = 0


def sparse_ffn_block_v2(x, idx, gp_sel, w_all_rows, *, act: str, gated: bool, R: int,
                        fatrelu_threshold: float = 0.0, prob_threshold: float = 0.5,
                        bu_sel=None, mask_mode: str = "threshold") -> torch.Tensor:
    """(N, E) f32 from the concatenated store w_all_rows (P*R, G, E). CPU
    tensors run the plain version; CUDA tensors launch the row kernel
    (counted in `sparse_ffn_block_v2.launches`) or raise. Ids are clamped
    into [0, R), so a row never reads another projection's."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_sel=bu_sel, mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v2_plain(x, idx, gp_sel, w_all_rows, gated=gated, R=R, **kw)
    _cuda_only(x)
    _check(w_all_rows.dim() == 3, "concatenated store must be (P*R, G, E)")
    P = 3 if gated else 2
    _check(w_all_rows.shape[0] == P * R, f"store has {w_all_rows.shape[0]} rows, want {P}*{R}")
    _, G, E = w_all_rows.shape
    gate = _explicit_gate(act, gated)
    stores = [w_all_rows, w_all_rows if gate else None, w_all_rows]
    out = _rows_kernel(x, idx, gp_sel, stores, (0, R * G * E, (P - 1) * R * G * E), G * E,
                       R, G, E, **kw)
    sparse_ffn_block_v2.launches += 1
    return out


sparse_ffn_block_v2.launches = 0


# ---------------------------------------------------------------------------
# v7u: the cross-token union of selected groups, batched decode


def sparse_ffn_block_v7u_plain(x, union_rows, gp_u, w_upT_rows, w_gateT_rows,
                               w_down_rows, *, act: str,
                               fatrelu_threshold: float = 0.0,
                               prob_threshold: float = 0.5, bu_u=None,
                               mask_mode: str = "threshold") -> torch.Tensor:
    """v7u in plain torch. x (B, E); union_rows (Cu,) row ids; gp_u/bu_u
    (B, Cu, G), gp_u zero where a token did not select the group;
    w_upT_rows/w_gateT_rows (R, E, G); w_down_rows (R, G, E) -> (B, E) f32.
    The up/gate stores are cast to x's dtype, the hidden and W_down are
    rounded to bf16 before the down product; sums in f32."""
    gated = _is_gated(act, w_gateT_rows)
    if mask_mode not in MASK_MODES:
        raise ValueError(f"mask_mode {mask_mode!r}")
    rows = union_rows.long().clamp(0, w_upT_rows.shape[0] - 1)
    xf = x.float()

    def col(w):  # (Cu, E, G) in x's dtype, then exact in f32
        return w[rows].to(x.dtype).float()

    up = torch.einsum("be,ueg->bug", xf, col(w_upT_rows))
    if bu_u is not None:
        up = up + bu_u.float()
    gate = torch.einsum("be,ueg->bug", xf, col(w_gateT_rows)) if gated else None
    hidden = combine(act, fatrelu_threshold, gate, up)
    gp = gp_u.float()
    hidden = hidden * ((gp >= prob_threshold).float()
                       if mask_mode == "threshold" else gp)
    wd = w_down_rows[rows].to(torch.bfloat16).float()
    return torch.einsum("bug,uge->be", hidden.to(torch.bfloat16).float(), wd)


def sparse_ffn_block_v7u(x, union_rows, gp_u, w_upT_rows, w_gateT_rows,
                         w_down_rows, *, act: str, fatrelu_threshold: float = 0.0,
                         prob_threshold: float = 0.5, bu_u=None,
                         mask_mode: str = "threshold") -> torch.Tensor:
    """(B, E) f32. CPU tensors run the plain version; CUDA tensors launch
    the kernel (two kernels, counted once in `sparse_ffn_block_v7u.launches`)
    or raise. x (bf16 or f32) is read in its own dtype. Row ids outside
    [0, R) are clamped, as XLA clamps a gather."""
    kw = dict(act=act, fatrelu_threshold=fatrelu_threshold,
              prob_threshold=prob_threshold, bu_u=bu_u, mask_mode=mask_mode)
    if x.device.type == "cpu":
        return sparse_ffn_block_v7u_plain(x, union_rows, gp_u, w_upT_rows,
                                          w_gateT_rows, w_down_rows, **kw)
    _cuda_only(x)
    gated = _is_gated(act, w_gateT_rows)
    _check(mask_mode in MASK_MODES, f"mask_mode {mask_mode!r}")
    _check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    B, E = x.shape
    (Cu,) = union_rows.shape
    R, E_w, G = w_upT_rows.shape
    _check(E_w == E, "x/store shapes disagree")
    _check(gp_u.shape == (B, Cu, G), f"gp_u shape {tuple(gp_u.shape)}")
    _check(bu_u is None or bu_u.shape == (B, Cu, G), "bu_u must be (B, Cu, G)")
    _check(w_down_rows.shape == (R, G, E), "w_down_rows must be (R, G, E)")
    _check(not gated or w_gateT_rows.shape == (R, E, G),
           "w_gateT_rows must be (R, E, G)")
    _check(G % 8 == 0 and E % 8 == 0, "kernel needs G and E multiples of 8")
    _check_stores(x, [w_upT_rows, w_down_rows] + ([w_gateT_rows] if gated else []))
    small = [t for t in (union_rows, gp_u, bu_u) if t is not None]
    _check(all(t.device == x.device for t in small), "inputs on mixed devices")

    # x is read in its own dtype; bu_u without a copy where its (Cu, G) part
    # is contiguous f32 (the batched path expands one row over the tokens)
    x = _kernel_x(x)
    rows32, gp = union_rows.to(torch.int32).contiguous(), _f32(gp_u)
    bu, bu_bs = bu_u, Cu * G
    if bu is not None:
        if bu.dtype == torch.float32 and bu.stride(2) == 1 and bu.stride(1) == G:
            bu_bs = bu.stride(0)
        else:
            bu = _f32(bu)
    lib = _kernel_lib("sparse_ffn_v7u", 9, 9)
    out = torch.empty((B, E), dtype=torch.float32, device=x.device)
    hidden = torch.empty((lib.sparse_ffn_v7u_scratch_floats(B, Cu, E, G),),
                         dtype=torch.float32, device=x.device)
    _launch(lib, "sparse_ffn_v7u", x.device,
            _ptr(x), _ptr(rows32), _ptr(gp), _ptr(bu), _ptr(w_upT_rows),
            _ptr(w_gateT_rows if gated else None), _ptr(w_down_rows), _ptr(out),
            _ptr(hidden), B, Cu, E, G, R, int(w_upT_rows.dtype == torch.bfloat16),
            int(x.dtype == torch.bfloat16), ACT_CODES[act], bu_bs,
            float(fatrelu_threshold), float(prob_threshold), int(mask_mode == "scale"))
    sparse_ffn_block_v7u.launches += 1
    return out


def v7u_plan(device, B: int, Cu: int, E: int, G: int, *, w_dtype=torch.bfloat16,
             x_dtype=torch.bfloat16, gated: bool = True) -> dict:
    """The launch shape of `sparse_ffn_block_v7u` on a CUDA device: the G
    and token tiles, and for each of its two launches (up: up, gate and
    hidden; down: the down product) the cluster size (K splits), the blocks
    and the wave ratio (the most stages an SM streams over an even share)."""
    lib = _kernel_lib("sparse_ffn_v7u", 9, 9)
    fn = lib.sparse_ffn_v7u_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    v = (ctypes.c_longlong * 10)()
    with torch.cuda.device(device):
        err = fn(B, Cu, E, G, int(w_dtype == torch.bfloat16), int(x_dtype == torch.bfloat16),
                 int(gated), v)
    if err:
        raise RuntimeError(f"sparse_ffn_v7u_plan failed: CUDA error {err}")
    return {"sms": v[0], "g_tile": v[1], "token_tile": v[2],
            "up": {"cluster": v[3], "blocks": v[4], "wave_ratio": v[5] / 1e6},
            "down": {"cluster": v[6], "blocks": v[7], "wave_ratio": v[8] / 1e6},
            "up_smem_bytes": v[9]}


sparse_ffn_block_v7u.launches = 0
