"""Host kernels of the tiered FFN, the port of sparkinfer_tpu/native
(`sparse_complement`, `has_f16`, `reload_plan`), over torch CPU tensors.

The library is the port's own copy of the C++ (`csrc/spark_host.cpp`),
built with g++ by `ops/_build.py` at its first use and loaded with ctypes.
There is no fallback: a failed build raises, and host mode
(`sparse/tiering.py`) then raises with it. `sparse_complement_plain` is the
same function in plain torch, for the tests.

The complement of one layer, for each token n and each group g that is
cold and active for it (`cold_active[n, g]`), and each row r of g whose
probability passes `prob_thr`:

    up   = x[n] . W_up[g, r] + b_up[g, r]
    gate = x[n] . W_gate[g, r]                 fatrelu and drelu only
    out[n] += act(gate, up) * W_down[g, r]

in f32, the weights f32 or f16 (converted inside the dot loops).
"""

from __future__ import annotations

import ctypes

import torch

from .ops import _build

ACT_KIND = {"relu": 0, "fatrelu": 1, "drelu": 2}
WEIGHT_DTYPES = (torch.float32, torch.float16)

_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed (raises if it cannot
    be built)."""
    global _lib
    if _lib is None:
        lib = _build.load_host("spark_host")
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float
        lib.spif_sparse_complement.argtypes = [p] * 8 + [i32] * 5 + [f32, f32]
        lib.spif_sparse_complement.restype = None
        lib.spif_sparse_complement_f16.argtypes = [p] * 8 + [i32] * 5 + [f32, f32]
        lib.spif_sparse_complement_f16.restype = i32
        lib.spif_has_f16.restype = i32
        lib.spif_reload_plan.argtypes = [p, i32, p, i32, i32, p, p]
        lib.spif_reload_plan.restype = i32
        lib.spif_num_threads.restype = i32
        _lib = lib
    return _lib


def has_f16() -> bool:
    """Whether the library computes over f16 weights (the compiler has
    _Float16)."""
    return bool(library().spif_has_f16())


def num_threads() -> int:
    return int(library().spif_num_threads())


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"host complement: {msg}")


def sparse_complement(x, up, gate, down, b_up, probs, cold_active, act: str,
                      fatrelu_thr: float = 0.0, prob_thr: float = 0.5,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, E) f32 on the CPU, through the library. x (N, E) f32; up, gate,
    down (ng, G, E) f32 or f16, one dtype (gate None for relu); b_up (ng, G)
    f32 or None; probs (N, ng, G) f32; cold_active (N, ng) bool. Every
    tensor lies on the CPU, contiguous; `out` (N, E) f32 is written if
    given."""
    lib = library()
    N, E = x.shape
    ng, G, E_w = up.shape
    ws = [up, down] + ([gate] if gate is not None else [])
    _check(act in ACT_KIND, f"activation {act!r}")
    _check(act == "relu" or gate is not None, f"{act} needs the gate store")
    _check(E_w == E and probs.shape == (N, ng, G) and cold_active.shape == (N, ng),
           "shapes disagree")
    _check(up.dtype in WEIGHT_DTYPES and all(w.dtype == up.dtype and w.shape == up.shape
                                             for w in ws), "weights: one f32/f16 dtype")
    small = [x, probs] + ([b_up] if b_up is not None else [])
    _check(all(t.dtype == torch.float32 for t in small), "x, probs and b_up must be f32")
    _check(cold_active.dtype == torch.bool, "cold_active must be bool")
    every = ws + small + [cold_active] + ([out] if out is not None else [])
    _check(all(t.device.type == "cpu" and t.is_contiguous() for t in every),
           "tensors must be contiguous on the CPU")
    _check(b_up is None or b_up.shape == (ng, G), "b_up must be (ng, G)")
    if out is None:
        out = torch.empty((N, E), dtype=torch.float32)
    _check(out.shape == (N, E) and out.dtype == torch.float32, "out must be (N, E) f32")
    args = [x.data_ptr(), up.data_ptr(), None if gate is None else gate.data_ptr(),
            down.data_ptr(), None if b_up is None else b_up.data_ptr(), probs.data_ptr(),
            cold_active.data_ptr(), out.data_ptr(), N, ng, G, E, ACT_KIND[act],
            float(fatrelu_thr), float(prob_thr)]
    if up.dtype == torch.float16:
        if lib.spif_sparse_complement_f16(*args) != 0:
            raise RuntimeError("the host library was built without _Float16: "
                               "keep the cold store in f32")
    else:
        lib.spif_sparse_complement(*args)
    return out


def sparse_complement_plain(x, up, gate, down, b_up, probs, cold_active, act: str,
                            fatrelu_thr: float = 0.0, prob_thr: float = 0.5) -> torch.Tensor:
    """The same function in plain torch (the tests' reference), in f32."""
    N, E = x.shape
    out = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    for n in range(N):
        gs = torch.nonzero(cold_active[n]).flatten()
        if gs.numel() == 0:
            continue
        xn = x[n].float()
        u = torch.einsum("e,kge->kg", xn, up[gs].float())
        if b_up is not None:
            u = u + b_up[gs].float()
        if act == "fatrelu":
            g = torch.einsum("e,kge->kg", xn, gate[gs].float())
            h = torch.where(g > fatrelu_thr, g, 0.0) * u
        elif act == "drelu":
            g = torch.einsum("e,kge->kg", xn, gate[gs].float())
            h = g.clamp_min(0.0) * u.clamp_min(0.0)
        else:
            h = u.clamp_min(0.0)
        h = h * (probs[n, gs] >= prob_thr).float()
        out[n] = torch.einsum("kg,kge->e", h, down[gs].float())
    return out


def reload_plan(current_hot, desired_hot, window: int) -> list[tuple[int, int]]:
    """The library's two-pointer plan (`spif_reload_plan`): [(slot, group)],
    at most `window` pairs, the desired groups taken in their order."""
    lib = library()
    cur = torch.as_tensor(current_hot, dtype=torch.int32).contiguous()
    want = torch.as_tensor(desired_hot, dtype=torch.int32).contiguous()
    slots = torch.empty(max(window, 1), dtype=torch.int32)
    groups = torch.empty(max(window, 1), dtype=torch.int32)
    n = lib.spif_reload_plan(cur.data_ptr(), cur.numel(), want.data_ptr(), want.numel(),
                             window, slots.data_ptr(), groups.data_ptr())
    return [(int(slots[i]), int(groups[i])) for i in range(n)]
