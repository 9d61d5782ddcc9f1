"""Packed Q4_0/Q8_0 linears: the port of sparkinfer_tpu/ops/quant_matmul.py.

Weights stay packed in device memory (8.5 / 4.5 bits per weight with f32
scales) and are dequantized inside the kernel on their way into the
product, so a decode step reads the packed bytes only.

Wire repack (host numpy, at load; `repack_q4_0` / `repack_q8_0`), out-major:
  Q4_0: qw (out, in/2) uint8, SEQUENTIAL nibbles (byte j = q[2j] | q[2j+1] << 4),
        repacked from ggml's interleaved order (byte j = q[j] | q[j+16] << 4);
        value = (nibble - 8) * scale
  Q8_0: qw (out, in) int8
  both: scales (out, in/32) f32, one per 32-weight ggml block.

Device layout (`QuantTensor.from_repack`), IN-major: qw (in/div, out),
scales (in/32, out), so that neighbouring output columns are neighbouring
bytes and threads along `out` load 16 bytes each.

The function of the TPU kernel (`_q_matmul_kernel`, :111), which the plain
versions here compute and csrc/quant_matmul.cu computes on the card:
x is rounded to bf16, each weight is bf16(bf16(q) * bf16(scale)), and the
exact products are summed in f32. `quant_matmul_2d` and `quant_matmul_flat`
take the plain version for a CPU tensor and launch the kernel for a CUDA
tensor (or raise), counting launches in `.launches`. Unlike the JAX
function, no shape falls back to another path: the kernel takes every
`in % 32 == 0`. Every call is one launch. Decode (N <= DECODE_MAX_N
tokens) runs `qmm_decode`, which sums its K splits itself through a
per-device workspace (tile counters and partial sums), allocated zeroed at
the first decode call on that device, which therefore must not happen
during CUDA-graph capture; two streams must not run the decode kernel at
the same time on one device. Wider x runs `qmm_prefill` on the tensor
cores, whose K splits add up inside a thread-block cluster.

Row-wise W8A8 (`W8A8Tensor`, `w8a8_linear`, the port of :376-426): int8
weights with one f32 scale per output column, each token's activations
quantized to int8 with one scale, an int8 x int8 -> int32 product and the
two scales folded into its result. The JAX package computes the product in
XLA, not in a Pallas kernel, so it is no kernel of this repository: on the
card it is the library call `torch._int_mm` (`int8_matmul`), on the CPU an
int32 matmul; both are exact, so the two paths agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, workspace

QK = 32  # ggml block size for q4_0/q8_0
KINDS = ("q4_0", "q8_0")
DECODE_MAX_N = 4  # the widest x of the decode kernel; wider x runs the prefill kernel


def _div(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"quant kind {kind!r} (want one of {KINDS})")
    return 2 if kind == "q4_0" else 1


# --------------------------------------------------------------------------
# host-side repack (numpy, at load time)


def repack_q4_0(raw: np.ndarray, out_dim: int, in_dim: int):
    """raw: ggml q4_0 blocks for a (out, in) row-major tensor
    (uint8 (nblocks, 18): 2B f16 scale + 16B packed). Returns
    (qw uint8 (out, in/2) sequential nibbles, scales f32 (out, in/32))."""
    nb = out_dim * in_dim // QK
    blocks = np.asarray(raw, np.uint8).reshape(nb, 18)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32).reshape(out_dim, in_dim // QK)
    packed = blocks[:, 2:]  # (nb, 16): byte j = q[j] | q[j+16] << 4
    low = packed & 0x0F  # q[0..15]
    high = packed >> 4  # q[16..31]
    seq = np.concatenate([low, high], axis=1)  # (nb, 32) values 0..15
    # sequential nibble pack: byte j = q[2j] | q[2j+1] << 4
    qw = (seq[:, 0::2] | (seq[:, 1::2] << 4)).astype(np.uint8)  # (nb, 16)
    return qw.reshape(out_dim, in_dim // 2), scales


def repack_q8_0(raw: np.ndarray, out_dim: int, in_dim: int):
    """ggml q8_0 blocks (nblocks, 34): 2B f16 scale + 32B int8. Returns
    (qw int8 (out, in), scales f32 (out, in/32))."""
    nb = out_dim * in_dim // QK
    blocks = np.asarray(raw, np.uint8).reshape(nb, 34)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32).reshape(out_dim, in_dim // QK)
    qw = blocks[:, 2:].copy().view(np.int8).reshape(out_dim, in_dim)
    return qw, scales


REPACK = {"q4_0": repack_q4_0, "q8_0": repack_q8_0}


# --------------------------------------------------------------------------
# packed weights


class QuantTensor:
    """Packed weight W (in, out) for x @ W, optionally stacked on leading
    axes (a layer axis). IN-major storage: q (..., in/div, out) packed
    (int8 for q8_0, uint8 nibbles for q4_0) + s (..., in/32, out) f32."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, kind: str):
        _div(kind)
        self.q = q
        self.s = s
        self.kind = kind

    @classmethod
    def from_repack(cls, qw, sc, kind: str, device=None) -> "QuantTensor":
        """From repack_q*_0 output ((..., out, in/div) packed rows +
        (..., out, in/32) scales): moved to `device`, then transposed there
        to the IN-major layout."""
        q = torch.from_numpy(np.ascontiguousarray(qw)).to(device)
        s = torch.from_numpy(np.ascontiguousarray(sc, np.float32)).to(device)
        return cls(q.transpose(-1, -2).contiguous(), s.transpose(-1, -2).contiguous(), kind)

    @property
    def shape(self) -> tuple[int, ...]:  # logical (..., in, out)
        return tuple(self.q.shape[:-2]) + (self.q.shape[-2] * _div(self.kind),
                                           self.q.shape[-1])

    def __getitem__(self, idx) -> "QuantTensor":  # per-layer slicing
        return QuantTensor(self.q[idx], self.s[idx], self.kind)

    def unbind(self, dim: int = 0) -> tuple["QuantTensor", ...]:
        if dim != 0:
            raise ValueError("QuantTensor unbinds its leading (layer) axis only")
        return tuple(QuantTensor(q, s, self.kind)
                     for q, s in zip(self.q.unbind(0), self.s.unbind(0)))

    def to(self, device) -> "QuantTensor":
        return QuantTensor(self.q.to(device), self.s.to(device), self.kind)


class FlatQuantTensor:
    """Layer-stacked packed weight, one loop-invariant store with the layer
    index bound late (the forward calls `.with_il(il)` when it merges
    params["sparse_flat"] into a layer's params). Per-layer shape is
    W (in, out); storage is IN-major (in/div, L*out) + (in/32, L*out) f32,
    layer l at column stripe l*out .. (l+1)*out."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, kind: str,
                 out_dim: int, il: int | None = None):
        _div(kind)
        self.q = q
        self.s = s
        self.kind = kind
        self.out_dim = out_dim
        self.il = il

    def with_il(self, il: int) -> "FlatQuantTensor":
        return FlatQuantTensor(self.q, self.s, self.kind, self.out_dim, int(il))

    @property
    def shape(self) -> tuple[int, int]:  # per-layer (in, out)
        return (self.q.shape[-2] * _div(self.kind), self.out_dim)

    def to(self, device) -> "FlatQuantTensor":
        return FlatQuantTensor(self.q.to(device), self.s.to(device), self.kind,
                               self.out_dim, self.il)


def q8_blocks(blk: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric Q8_0 of f32 blocks whose 32 elements run along `axis`:
    scale = amax / 127, q = round_half_even(x * (1 / scale)) clipped to
    +-127. Bit-equal to the numpy quantizers of the JAX package (the
    division is a true division: torch on CUDA turns `t / python_scalar`
    into a multiply by the reciprocal)."""
    amax = blk.abs().amax(dim=axis, keepdim=True)
    s = amax / torch.tensor(127.0, device=blk.device)
    inv = torch.where(s > 0, 1.0 / torch.clamp_min(s, 1e-30), 0.0)
    q = torch.round(blk * inv).clamp_(-127, 127).to(torch.int8)
    return q, s.squeeze(axis)


def flat_quantize(w_stack: torch.Tensor, kind: str = "q8_0") -> FlatQuantTensor:
    """(L, in, out) float tensor -> FlatQuantTensor with IN-major
    (in, L*out) int8 + (in/32, L*out) f32 storage, quantized on the tensor's
    device one layer at a time (q8_0 only, as in the JAX package)."""
    if kind != "q8_0":
        raise ValueError("flat_quantize packs q8_0 only")
    L, IN, OUT = w_stack.shape
    if IN % QK:
        raise ValueError(f"in dim {IN} is not a multiple of {QK}")
    dev = w_stack.device
    q = torch.empty((IN, L * OUT), dtype=torch.int8, device=dev)
    s = torch.empty((IN // QK, L * OUT), dtype=torch.float32, device=dev)
    for il in range(L):
        blk = w_stack[il].float().reshape(IN // QK, QK, OUT)
        ql, sl = q8_blocks(blk, 1)
        q[:, il * OUT:(il + 1) * OUT] = ql.reshape(IN, OUT)
        s[:, il * OUT:(il + 1) * OUT] = sl
    return FlatQuantTensor(q, s, kind, OUT)


# --------------------------------------------------------------------------
# row-wise W8A8


class W8A8Tensor:
    """Row-wise int8 weight W (in, out) for x @ W, optionally stacked on
    leading axes: q (..., in, out) int8 and s (..., out) f32, one scale per
    output column. q is stored out-major (q.mT is contiguous), the order in
    which torch._int_mm's cuBLASLt int8 path takes its second operand."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        self.q = q
        self.s = s

    @classmethod
    def from_float(cls, w) -> "W8A8Tensor":
        """Quantize a float (..., in, out) tensor or array on its device, bit
        for bit as the JAX from_float: f32 column amax, / 127, reciprocal,
        round half to even, clip to +-127 (each a separate rounding)."""
        w = torch.as_tensor(w).float()
        s = w.abs().amax(dim=-2, keepdim=True) / w.new_full((), 127.0)
        inv = torch.where(s > 0, 1.0 / torch.clamp_min(s, 1e-30), 0.0)
        q = torch.round(w * inv).clamp_(-127, 127).to(torch.int8)
        return cls(q.mT.contiguous().mT, s.squeeze(-2))

    @classmethod
    def empty(cls, shape: tuple[int, ...], device=None) -> "W8A8Tensor":
        """An unfilled stack of logical shape (..., in, out), filled per
        layer by `stack[il] = W8A8Tensor.from_float(w)`."""
        *lead, inn, out = shape
        return cls(torch.empty((*lead, out, inn), dtype=torch.int8, device=device).mT,
                   torch.empty((*lead, out), dtype=torch.float32, device=device))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    def __getitem__(self, idx) -> "W8A8Tensor":
        return W8A8Tensor(self.q[idx], self.s[idx])

    def __setitem__(self, idx, other: "W8A8Tensor"):
        self.q[idx].copy_(other.q)
        self.s[idx].copy_(other.s)

    def unbind(self, dim: int = 0) -> tuple["W8A8Tensor", ...]:
        if dim != 0:
            raise ValueError("W8A8Tensor unbinds its leading (layer) axis only")
        return tuple(W8A8Tensor(q, s) for q, s in zip(self.q.unbind(0), self.s.unbind(0)))

    def roll(self, shift: int) -> "W8A8Tensor":
        """The stack rolled along its layer axis (torch.roll's direction)."""
        return W8A8Tensor(torch.roll(self.q.mT, shift, dims=0).mT,
                          torch.roll(self.s, shift, dims=0))

    def to(self, device) -> "W8A8Tensor":
        return W8A8Tensor(self.q.to(device), self.s.to(device))


INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exactly: an int32 matmul
    on the CPU; on the card (which has no integer matmul outside
    torch._int_mm) an f64 one, exact while |sums| < 2^53 (127 * 127 * K)."""
    if a.device.type == "cpu":
        return a.int() @ b.int()
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. CPU tensors run the plain
    version; CUDA tensors run torch._int_mm (counted in
    `int8_matmul.launches`), whose bounds are checked here: K and N
    multiples of 8, and M padded with zero rows to 17 where it is smaller."""
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    M, K = a.shape
    N = b.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got K={K} N={N}")
    if M < INT_MM_MIN_ROWS:
        a = torch.nn.functional.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - M))
    out = torch._int_mm(a.contiguous(), b)
    int8_matmul.launches += 1
    return out[:M]


int8_matmul.launches = 0


def w8a8_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 of x (..., in): (xq int8, sx f32 (..., 1)),
    sx = max(|x|, 1e-20) / 127, xq = round_half_even(x / sx) clipped."""
    xf = x.float()
    # max |x| in one reduction (no arithmetic: the bits of abs().amax())
    ax = torch.linalg.vector_norm(xf, ord=float("inf"), dim=-1, keepdim=True)
    # a true division by a device tensor (torch on CUDA turns `t / 127.0`
    # into a multiply by the reciprocal), filled on the device so that a
    # CUDA-graph capture takes it
    sx = ax.clamp_min(1e-20) / ax.new_full((), 127.0)
    return torch.round(xf / sx).clamp_(-127, 127).to(torch.int8), sx


def w8a8_linear(x: torch.Tensor, w: W8A8Tensor, out_dtype=None, xq=None) -> torch.Tensor:
    """x (..., in) @ W8A8 (in, out) -> (..., out) in out_dtype (default
    x.dtype; f32 for a logit head): y = (xq @ q) * sx * s. `xq` takes the
    (xq, sx) of `w8a8_quantize(x)` where several weights read the same x
    (wq, wk and wv), which then is quantized once."""
    xq, sx = xq if xq is not None else w8a8_quantize(x)
    lead = x.shape[:-1]
    y = int8_matmul(xq.reshape(-1, x.shape[-1]), w.q)
    yf = y * sx.reshape(-1, 1) * w.s  # int32 -> f32 (rounded) inside the first multiply
    return yf.reshape(lead + (yf.shape[-1],)).to(out_dtype or x.dtype)


def is_quantized(w) -> bool:
    return isinstance(w, QuantTensor)


# --------------------------------------------------------------------------
# plain versions: the TPU kernel's function in torch


def dequant_bf16(qw: torch.Tensor, scales: torch.Tensor, kind: str) -> torch.Tensor:
    """IN-major (in/div, out) packed + (in/32, out) scales -> (in, out)
    bf16, each weight bf16(bf16(q) * bf16(scale)) as the TPU kernel's
    `_scale_cols` rounds it. Q4_0: low nibble = even input row, value - 8."""
    if _div(kind) == 2:
        b = qw.to(torch.int16)
        w = torch.stack([(b & 15) - 8, (b >> 4) - 8], dim=1).reshape(-1, qw.shape[-1])
    else:
        w = qw
    IN, OUT = w.shape
    w = w.to(torch.bfloat16).reshape(IN // QK, QK, OUT)
    return (w * scales.to(torch.bfloat16)[:, None, :]).reshape(IN, OUT)


def quant_matmul_2d_plain(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                          *, kind: str) -> torch.Tensor:
    """x (N, in) @ packed W (in, out) -> (N, out) f32: bf16 operands, f32
    products and sums (an f32 matmul of the bf16 values, never a bf16
    matmul, which would round the output)."""
    w = dequant_bf16(qw, scales, kind)
    return x.to(torch.bfloat16).float() @ w.float()


def quant_matmul_flat_plain(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                            il: int, *, kind: str, out_dim: int) -> torch.Tensor:
    """quant_matmul_2d_plain on layer il's column stripe of a flat store."""
    c0 = int(il) * out_dim
    return quant_matmul_2d_plain(x, qw[:, c0:c0 + out_dim],
                                 scales[:, c0:c0 + out_dim], kind=kind)


# --------------------------------------------------------------------------
# the CUDA kernel (csrc/quant_matmul.cu)

_lib_cache: list[ctypes.CDLL] = []
_workspace: dict[int, torch.Tensor] = {}  # decode workspace, by device index
_capacity: list[tuple[int, int]] = []  # (counter tiles, partial floats) of the workspace
_plans: dict[tuple, tuple[int, ...]] = {}  # launch shapes, by (device, N, in, out, q4)


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.load("quant_matmul")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quant_matmul.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
        lib.quant_matmul.restype = i
        lib.quant_matmul_workspace_words.argtypes = []
        lib.quant_matmul_workspace_words.restype = ll
        lib.quant_matmul_workspace_capacity.argtypes = [ctypes.POINTER(ll)] * 2
        lib.quant_matmul_workspace_capacity.restype = None
        lib.quant_matmul_plan.argtypes = [i, i, i, i, ctypes.POINTER(ll)]
        lib.quant_matmul_plan.restype = i
        lib.quant_matmul_error_string.argtypes = [i]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        tiles, floats = ll(), ll()
        lib.quant_matmul_workspace_capacity(ctypes.byref(tiles), ctypes.byref(floats))
        _capacity.append((tiles.value, floats.value))
        _lib_cache.append(lib)
    return _lib_cache[0]


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"quant_matmul: {msg}")


def _cuda_error(lib, err: int, what: str):
    if err != 0:
        msg = lib.quant_matmul_error_string(err).decode()
        raise RuntimeError(f"quant_matmul {what} failed: CUDA error {err} ({msg})")


def launch_plan(device, N: int, IN: int, OUT: int, kind: str) -> dict:
    """The kernel's launch shape for x (N, IN) over OUT columns on `device`:
    the column tile, the K splits, the tiles (column tiles, times token tiles
    at N > DECODE_MAX_N), the blocks per wave (slots, R) and the wave ratio
    ceil(B / R) / (B / R), counted in bytes. k_splits is 0 where IN is too
    large for the decode kernel (the wrappers raise). Cached by shape."""
    device = torch.device(device)
    key = (device.index, N, IN, OUT, _div(kind) == 2)
    got = _plans.get(key)
    if got is None:
        lib = _lib()
        out = (ctypes.c_longlong * 6)()
        with torch.cuda.device(device):
            _cuda_error(lib, lib.quant_matmul_plan(N, IN, OUT, int(key[-1]), out), "plan")
        got = _plans[key] = tuple(out)
    tx, ks, tiles, slots, steps, ratio = got
    return dict(tile=16 * tx, k_splits=ks, tiles=tiles, blocks=tiles * ks, slots=slots,
                steps=steps, wave_ratio=ratio / 1e6)


def _decode_workspace(device: torch.device) -> torch.Tensor:
    """The device's decode workspace (int32 tile counters, then f32
    partials), allocated zeroed at the first decode call on that device."""
    return workspace.zeroed(_workspace, device, _lib().quant_matmul_workspace_words(),
                            "quant_matmul decode")


def _launch(x, qw, scales, kind: str, col0: int, out_dim: int) -> torch.Tensor:
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")
    div = _div(kind)
    _check(x.dim() == 2, f"x must be (N, in), got {tuple(x.shape)}")
    N, IN = x.shape
    _check(IN % QK == 0, f"in dim {IN} is not a multiple of {QK}")
    _check(qw.dtype == (torch.uint8 if div == 2 else torch.int8),
           f"{kind} store dtype {qw.dtype}")
    _check(scales.dtype == torch.float32, f"scales dtype {scales.dtype} (f32 only)")
    ld = qw.shape[-1]
    _check(qw.shape == (IN // div, ld) and scales.shape == (IN // QK, ld),
           f"store shapes {tuple(qw.shape)}, {tuple(scales.shape)} for in={IN}")
    _check(0 <= col0 and col0 + out_dim <= ld and out_dim > 0,
           f"column stripe {col0}..{col0 + out_dim} outside {ld}")
    for t in (qw, scales):
        _check(t.device == x.device, "store must be on x's device")
        _check(t.is_contiguous(), "store must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    x = x.contiguous()
    lib = _lib()
    scratch = None
    if N <= DECODE_MAX_N:
        scratch = _decode_workspace(x.device)
        plan = launch_plan(x.device, N, IN, out_dim, kind)
        tiles, floats = _capacity[0]
        ks = plan["k_splits"]
        _check(ks > 0, f"x ({N}, {IN}): no K split of the decode kernel holds its x rows "
                       f"in shared memory (in dim too large)")
        _check(ks == 1 or (plan["tiles"] <= tiles and ks * N * out_dim <= floats),
               f"x ({N}, {IN}) over {out_dim} columns in {ks} K splits needs "
               f"{plan['tiles']} tile counters and {ks * N * out_dim} partial floats; "
               f"the workspace holds {tiles} and {floats}")
    out = torch.empty((N, out_dim), dtype=torch.float32, device=x.device)
    ws = 0 if scratch is None else scratch.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.quant_matmul(
            x.data_ptr(), int(x.dtype == torch.bfloat16), qw.data_ptr(),
            scales.data_ptr(), out.data_ptr(), ws, N, IN,
            out_dim, ld, col0, int(div == 2),
            torch.cuda.current_stream(x.device).cuda_stream)
    _cuda_error(lib, err, "launch")
    return out


def quant_matmul_2d(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                    *, kind: str) -> torch.Tensor:
    """x (N, in) @ packed IN-major W -> (N, out) f32. CPU tensors run the
    plain version; CUDA tensors launch the kernel (counted in
    `quant_matmul_2d.launches`) or raise."""
    if x.device.type == "cpu":
        return quant_matmul_2d_plain(x, qw, scales, kind=kind)
    out = _launch(x, qw, scales, kind, 0, qw.shape[-1])
    quant_matmul_2d.launches += 1
    return out


def quant_matmul_flat(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                      il: int, *, kind: str, out_dim: int) -> torch.Tensor:
    """quant_matmul_2d over layer il's column stripe of a flat (in/div, L*out)
    store, read in place (no slice copy). Counted in
    `quant_matmul_flat.launches`."""
    if x.device.type == "cpu":
        return quant_matmul_flat_plain(x, qw, scales, il, kind=kind, out_dim=out_dim)
    out = _launch(x, qw, scales, kind, int(il) * out_dim, out_dim)
    quant_matmul_flat.launches += 1
    return out


quant_matmul_2d.launches = 0
quant_matmul_flat.launches = 0


def quant_linear(x: torch.Tensor, w, xq=None) -> torch.Tensor:
    """x (..., in) @ W (in, out); w is a plain tensor, a QuantTensor, a
    FlatQuantTensor with its layer bound or a W8A8Tensor (which reads `xq`,
    x's `w8a8_quantize`, where given). Returns (..., out) in x.dtype, as
    the JAX function does (so an f32 input is still rounded to bf16 inside
    the packed product, and the f32 result is cast back to a bf16 input's
    dtype)."""
    if isinstance(w, W8A8Tensor):
        return w8a8_linear(x, w, xq=xq)
    if isinstance(w, FlatQuantTensor):
        if w.il is None:
            raise ValueError("FlatQuantTensor used without a bound layer index; "
                             "pass it via params['sparse_flat'] so the forward binds il")
        x2 = x.reshape(-1, x.shape[-1])
        out = quant_matmul_flat(x2, w.q, w.s, w.il, kind=w.kind, out_dim=w.out_dim)
    elif is_quantized(w):
        x2 = x.reshape(-1, x.shape[-1])
        out = quant_matmul_2d(x2, w.q, w.s, kind=w.kind)
    else:
        return x @ w
    return out.reshape(x.shape[:-1] + (out.shape[-1],)).to(x.dtype)
