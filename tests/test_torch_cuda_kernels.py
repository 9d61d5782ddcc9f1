"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device. Run them on
a machine with a card (no JAX needed there, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: kernel and plain version both sum in f32, in another order
(over E for up/gate and over C*G for down), so they agree to a relative
1e-3 of the output's scale for bf16 stores and 1e-5 for f32 stores. The
Q8_0 kernels (v6q, quant_matmul) sum exact or f32 products in another
order too: 1e-5 of the scale at small widths, 1e-4 at the 13B decode
shapes (sums over 5120 terms). The packers and encoders are bit-equal to
their CPU runs. v1 over f32 stores keeps an f32 hidden: 1e-5. v7u rounds
its hidden to bf16, so a hidden value whose f32 sums differ in the last
bit can round to the neighbouring bf16 value: 1e-3 of the scale for v7u
and for v1 over bf16 stores. v2, v3, v4 and v5 run v1's kernel over their
own strides and offsets and are held to v1's tolerances (1e-5 with f32
stores whatever x's dtype: bf16 x is exact in f32).
"""

import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparkinfer_tpu_torch.gguf.constants import GGMLType  # noqa: E402
from sparkinfer_tpu_torch.gguf.quants import quantize  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import lm_head  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.ops.sparse_ffn import (  # noqa: E402
    quantize_rows_q8_0,
    sparse_ffn_block_v6,
    sparse_ffn_block_v6_plain,
    interleave_rows,
    sparse_ffn_block,
    sparse_ffn_block_plain,
    sparse_ffn_block_v2,
    sparse_ffn_block_v2_plain,
    sparse_ffn_block_v3,
    sparse_ffn_block_v3_plain,
    sparse_ffn_block_v4,
    sparse_ffn_block_v4_plain,
    sparse_ffn_block_v5,
    sparse_ffn_block_v5_plain,
    sparse_ffn_block_v6q,
    sparse_ffn_block_v6q_plain,
    sparse_ffn_block_v7u,
    sparse_ffn_block_v7u_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(N, C, E, G, R, dtype, device, seed, with_bu=True, gated=True):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a).to(device=device, dtype=dt)

    x = t(rng.standard_normal((N, E), dtype=np.float32))
    idx = t(np.stack([rng.choice(R, C, replace=False) for _ in range(N)])
            .astype(np.int32), torch.int32)
    gp = t(rng.uniform(0, 1, (N, C, G)).astype(np.float32))
    bu = t(rng.standard_normal((N, C, G), dtype=np.float32) * 0.1) if with_bu else None
    wu = t(rng.standard_normal((R, E, G), dtype=np.float32) * 0.05, dtype)
    wg = t(rng.standard_normal((R, E, G), dtype=np.float32) * 0.05, dtype) if gated else None
    wd = t(rng.standard_normal((R, G, E), dtype=np.float32) * 0.05, dtype)
    return x, idx, gp, wu, wg, wd, bu


def _check(args, bu, tol, **kw):
    x, idx, gp, wu, wg, wd = args
    before = sparse_ffn_block_v6.launches
    got = sparse_ffn_block_v6(x, idx, gp, wu, wg, wd, bu_sel=bu, **kw)
    torch.cuda.synchronize()
    assert sparse_ffn_block_v6.launches == before + 1
    ref = sparse_ffn_block_v6_plain(x, idx, gp, wu, wg, wd, bu_sel=bu, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("act,mask_mode,with_bu", list(itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu"], ["threshold", "scale"],
    [True, False])))
def test_v6_small_f32(cuda, act, mask_mode, with_bu):
    *args, bu = _inputs(3, 4, 64, 16, 12, torch.float32, cuda, seed=1,
                        with_bu=with_bu)
    _check(args, bu, 1e-5, act=act, mask_mode=mask_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("N,act", [(1, "fatrelu"), (4, "fatrelu"), (4, "relu")])
def test_v6_decode_shape_bf16(cuda, N, act):
    """ProSparse-Llama-2-7B widths: E=4096, G=128, C=12, bf16 stores."""
    *args, bu = _inputs(N, 12, 4096, 128, 256, torch.bfloat16, cuda, seed=2,
                        gated=(act != "relu"))
    _check(args, bu, 1e-3, act=act)


@pytest.mark.cuda
def test_v6_odd_widths(cuda):
    """E not a multiple of the kernel's slices and tiles; G not a power of 2."""
    *args, bu = _inputs(2, 3, 1000, 48, 7, torch.bfloat16, cuda, seed=3)
    _check(args, bu, 1e-3, act="silu")


@pytest.mark.cuda
def test_v6_rejects_bad_stores(cuda):
    *args, bu = _inputs(1, 2, 64, 16, 4, torch.bfloat16, cuda, seed=4)
    x, idx, gp, wu, wg, wd = args
    with pytest.raises(ValueError):
        sparse_ffn_block_v6(x, idx, gp, wu.transpose(1, 2), wg, wd, act="fatrelu")
    with pytest.raises(ValueError):
        sparse_ffn_block_v6(x, idx, gp, wu, wg.float(), wd, act="fatrelu")
    with pytest.raises(ValueError):
        sparse_ffn_block_v6(x, idx, gp, wu, None, wd, act="silu")
    *odd, _ = _inputs(1, 2, 64, 12, 4, torch.bfloat16, cuda, seed=5)
    with pytest.raises(ValueError):  # G not a multiple of 8
        sparse_ffn_block_v6(*odd, act="fatrelu")


@pytest.mark.cuda
def test_v6_is_deterministic(cuda):
    """Fixed-order sums, no atomics: repeated calls agree bit for bit."""
    *args, bu = _inputs(4, 12, 4096, 128, 64, torch.bfloat16, cuda, seed=6)
    a = sparse_ffn_block_v6(*args, act="fatrelu", bu_sel=bu)
    b = sparse_ffn_block_v6(*args, act="fatrelu", bu_sel=bu)
    assert torch.equal(a, b)


# The shapes of the v6 sweep: C in (1, 3, 12), G in (16, 48, 128, 2048) and
# E in (64, 1000, 4096), with the 7B decode shape (12, 128, 4096)
_V6_SHAPES = [(1, 16, 64), (3, 48, 1000), (12, 128, 4096), (3, 2048, 64),
              (1, 128, 1000), (12, 16, 4096), (3, 128, 4096), (1, 2048, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("C,G,E", _V6_SHAPES)
def test_v6_sweep_bf16(cuda, N, C, G, E):
    """bf16 x and stores (the 7B main path's route) at every token count,
    selection count, group size and width, inputs made on the card."""
    gen = torch.Generator(device=cuda).manual_seed(30)
    R = C + 3

    def store(*shape):
        return (torch.randn(shape, generator=gen, device=cuda) * 0.05).bfloat16()

    x = torch.randn((N, E), generator=gen, device=cuda).bfloat16()
    idx = torch.stack([torch.randperm(R, generator=gen, device=cuda)[:C]
                       for _ in range(N)]).to(torch.int32)
    gp = torch.rand((N, C, G), generator=gen, device=cuda)
    bu = torch.randn((N, C, G), generator=gen, device=cuda) * 0.1
    args = (x, idx, gp, store(R, E, G), store(R, E, G), store(R, G, E))
    _check(args, bu, 1e-3, act="fatrelu", fatrelu_threshold=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt,act,mask_mode,bias", list(itertools.product(
    [torch.bfloat16, torch.float32], [torch.bfloat16, torch.float32], ["fatrelu", "relu"],
    ["threshold", "scale"], [True, False])))
def test_v6_routes(cuda, xdt, wdt, act, mask_mode, bias):
    """Each route: bf16 or f32 x, bf16 or f32 stores, gated (up and gate in
    one stage) and ungated, both mask modes, with and without the up bias;
    two row ids out of range (clamped). 1e-5 of the scale with f32 stores,
    1e-3 with bf16."""
    *args, bu = _inputs(5, 7, 1000, 48, 11, wdt, cuda, seed=31, with_bu=bias,
                        gated=act != "relu")
    x, idx, *rest = args
    idx = idx.clone()
    idx[1, 2], idx[3, 0] = -4, 11 + 6
    _check((x.to(xdt), idx, *rest), bu, 1e-5 if wdt == torch.float32 else 1e-3, act=act,
           mask_mode=mask_mode, fatrelu_threshold=0.01)


@pytest.mark.cuda
def test_v6_plan(cuda):
    """The launch plan at the 7B decode shapes: one cluster of 1-16 blocks a
    selection, so N * C * KS blocks, and wave ratios at or above 1."""
    from sparkinfer_tpu_torch.ops.sparse_ffn import v6_plan

    for N, gated in itertools.product((1, 4, 8), (True, False)):
        plan = v6_plan(cuda, N, 12, 4096, 128, gated=gated)
        assert plan["sms"] > 0 and plan["smem_bytes"] > 0, plan
        assert 1 <= plan["splits"] <= 16, plan
        assert plan["blocks"] == N * 12 * plan["splits"], plan
        assert 0.99 <= plan["wave_ratio"] < 4 and plan["stages"] > 1, plan


@pytest.mark.cuda
def test_v6_workspace_counters_and_capture_guard(cuda, monkeypatch):
    """Every counter of the workspace is 0 after calls of several shapes;
    the workspace is allocated at a device's first call, which raises
    inside CUDA-graph capture."""
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf

    *a8, b8 = _inputs(8, 12, 4096, 128, 40, torch.bfloat16, cuda, seed=32)
    *a2, b2 = _inputs(2, 3, 1000, 48, 7, torch.float32, cuda, seed=33)
    ref = sparse_ffn_block_v6(*a8, act="fatrelu", bu_sel=b8)
    sparse_ffn_block_v6(*a2, act="silu", bu_sel=b2)
    torch.cuda.synchronize()
    ws = sf._v6_workspace[a8[0].device.index]
    assert ws.dtype == torch.int32 and int(ws.count_nonzero()) == 0
    monkeypatch.setattr(sf, "_v6_workspace", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before CUDA-graph capture"):
        with torch.cuda.graph(graph):
            sparse_ffn_block_v6(*a8, act="fatrelu", bu_sel=b8)
    assert not sf._v6_workspace
    assert torch.equal(sparse_ffn_block_v6(*a8, act="fatrelu", bu_sel=b8), ref)  # allocates
    torch.cuda.synchronize()
    assert int(sf._v6_workspace[a8[0].device.index].count_nonzero()) == 0


@pytest.mark.cuda
def test_v6_graph_replay_equals_the_eager_call(cuda):
    """Replays of a CUDA graph of three calls (the 7B shape at N = 4 with
    bf16 x, N = 1, an odd shape with f32 x and stores) give the eager calls'
    bits, and so does every eager call: no state is left between calls."""
    *a4, b4 = _inputs(4, 12, 4096, 128, 40, torch.bfloat16, cuda, seed=34)
    *a1, b1 = _inputs(1, 12, 4096, 128, 40, torch.bfloat16, cuda, seed=35)
    *a3, b3 = _inputs(3, 3, 1000, 48, 7, torch.float32, cuda, seed=36)
    a4 = (a4[0].bfloat16(), *a4[1:])
    calls = (lambda: sparse_ffn_block_v6(*a4, act="fatrelu", bu_sel=b4),
             lambda: sparse_ffn_block_v6(*a1, act="relu", bu_sel=b1),
             lambda: sparse_ffn_block_v6(*a3, act="silu", mask_mode="scale", bu_sel=b3))
    ref = [c() for c in calls]
    for _ in range(3):
        assert all(torch.equal(c(), r) for c, r in zip(calls, ref))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)


# One v6 call profiled in a fresh process (see _V7U_ONE_CALL)
_V6_ONE_CALL = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[2])
from test_torch_cuda_kernels import _kernels_of_one_call
from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v6
N = int(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(37)
stores = [(torch.randn(sh, generator=gen, device="cuda") * 0.05).bfloat16()
          for sh in ((86, 4096, 128), (86, 4096, 128), (86, 128, 4096))]
idx = torch.stack([torch.randperm(86, generator=gen, device="cuda")[:12]
                   for _ in range(N)]).to(torch.int32)
gp = torch.rand((N, 12, 128), generator=gen, device="cuda")
bu = torch.randn((N, 12, 128), generator=gen, device="cuda") * 0.1
x = torch.randn((N, 4096), generator=gen, device="cuda").bfloat16()
print(json.dumps(_kernels_of_one_call(
    lambda: sparse_ffn_block_v6(x, idx, gp, *stores, act="fatrelu", bu_sel=bu))))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 4])
def test_v6_one_call_is_one_kernel(cuda, N):
    """One call over bf16 x and stores, int32 ids and f32 gp and bias
    launches v6_ffn and nothing else: no copy or conversion of x, no sum of
    partials in another kernel (profiled in a child process)."""
    import json
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", _V6_ONE_CALL, str(N), str(here)],
                          cwd=here.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "v6_ffn" in names[0], names


# ---------------------------------------------------------------------------
# v6q over Q8_0 stores


def _q8_inputs(N, C, E, G, R, device, seed, with_bu=True, gated=True):
    x, idx, gp, wu, wg, wd, bu = _inputs(N, C, E, G, R, torch.float32, device, seed,
                                         with_bu=with_bu, gated=gated)
    qu, su = quantize_rows_q8_0(wu)
    qg, sg = quantize_rows_q8_0(wg) if gated else (None, None)
    qd, sd = quantize_rows_q8_0(wd)
    return (x, idx, gp, qu, su, qg, sg, qd, sd), bu


def _check_v6q(args, bu, tol, **kw):
    before = sparse_ffn_block_v6q.launches
    got = sparse_ffn_block_v6q(*args, bu_sel=bu, **kw)
    torch.cuda.synchronize()
    assert sparse_ffn_block_v6q.launches == before + 1
    ref = sparse_ffn_block_v6q_plain(*args, bu_sel=bu, **kw)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("act,mask_mode,with_bu", list(itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu"], ["threshold", "scale"],
    [True, False])))
def test_v6q_small(cuda, act, mask_mode, with_bu):
    args, bu = _q8_inputs(3, 4, 64, 32, 12, cuda, seed=11, with_bu=with_bu)
    _check_v6q(args, bu, 1e-5, act=act, mask_mode=mask_mode)


@pytest.mark.cuda
@pytest.mark.parametrize("N,act", [(1, "fatrelu"), (4, "fatrelu"), (4, "relu")])
def test_v6q_decode_shape(cuda, N, act):
    """ProSparse-Llama-2-13B widths: E=5120, G=128, C=16 of 108 groups."""
    args, bu = _q8_inputs(N, 16, 5120, 128, 216, cuda, seed=12, gated=(act != "relu"))
    _check_v6q(args, bu, 1e-4, act=act)


@pytest.mark.cuda
def test_v6q_odd_widths(cuda):
    """E not a multiple of the kernel's slices and tiles; G not a power of 2."""
    args, bu = _q8_inputs(2, 3, 1056, 96, 7, cuda, seed=13)
    _check_v6q(args, bu, 1e-5, act="silu")


@pytest.mark.cuda
def test_v6q_rejects_bad_stores(cuda):
    args, bu = _q8_inputs(1, 2, 64, 32, 4, cuda, seed=14)
    x, idx, gp, qu, su, qg, sg, qd, sd = args
    with pytest.raises(ValueError):  # scales in another dtype
        sparse_ffn_block_v6q(x, idx, gp, qu, su.half(), qg, sg, qd, sd, act="fatrelu")
    with pytest.raises(ValueError):  # a store in the wrong layout
        sparse_ffn_block_v6q(x, idx, gp, qu.transpose(1, 2).contiguous(), su, qg, sg,
                             qd, sd, act="fatrelu")
    with pytest.raises(ValueError):  # a gated activation without its gate
        sparse_ffn_block_v6q(x, idx, gp, qu, su, None, None, qd, sd, act="silu")
    x, idx, gp = _inputs(1, 2, 64, 16, 4, torch.float32, cuda, seed=15)[:3]
    q16 = torch.zeros((4, 64, 16), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):  # G not a multiple of 32
        sparse_ffn_block_v6q(x, idx, gp, q16, torch.zeros((4, 2, 16), device=cuda), None,
                             None, q16.transpose(1, 2).contiguous(),
                             torch.zeros((4, 0, 64), device=cuda), act="relu")


@pytest.mark.cuda
def test_v6q_is_deterministic(cuda):
    args, bu = _q8_inputs(4, 16, 5120, 128, 64, cuda, seed=16)
    a = sparse_ffn_block_v6q(*args, act="fatrelu", bu_sel=bu)
    b = sparse_ffn_block_v6q(*args, act="fatrelu", bu_sel=bu)
    assert torch.equal(a, b)


# The shapes of the v6q sweep: C in (1, 3, 16), G in (32, 96, 128, 4096)
# and E in (64, 1056, 5120), with the 13B decode shape (16, 128, 5120)
_V6Q_SHAPES = [(1, 32, 64), (3, 96, 1056), (16, 128, 5120), (3, 4096, 64),
               (1, 128, 1056), (16, 32, 5120), (3, 128, 5120), (1, 4096, 1056)]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("C,G,E", _V6Q_SHAPES)
def test_v6q_sweep_bf16(cuda, N, C, G, E):
    """bf16 x (the 13B main path's route) at every token count, selection
    count, group size and width, inputs made on the card. 1e-4 of the scale
    where a sum runs over 4096 terms or more (E, or C * G for the down
    product), else 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    R = C + 3

    def store(*shape):
        return quantize_rows_q8_0(torch.randn(shape, generator=gen, device=cuda) * 0.05)

    x = torch.randn((N, E), generator=gen, device=cuda).bfloat16()
    idx = torch.stack([torch.randperm(R, generator=gen, device=cuda)[:C]
                       for _ in range(N)]).to(torch.int32)
    gp = torch.rand((N, C, G), generator=gen, device=cuda)
    bu = torch.randn((N, C, G), generator=gen, device=cuda) * 0.1
    args = (x, idx, gp, *store(R, E, G), *store(R, E, G), *store(R, G, E))
    _check_v6q(args, bu, 1e-4 if max(E, C * G) >= 4096 else 1e-5, act="fatrelu",
               fatrelu_threshold=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,act,mask_mode,bias", list(itertools.product(
    [torch.bfloat16, torch.float32], ["fatrelu", "relu"], ["threshold", "scale"],
    [True, False])))
def test_v6q_routes(cuda, xdt, act, mask_mode, bias):
    """Each route: bf16 or f32 x, gated (up and gate in one launch) and
    ungated, both mask modes, with and without the up bias; two row ids out
    of range (clamped)."""
    args, bu = _q8_inputs(5, 7, 1056, 96, 11, cuda, seed=19, with_bu=bias,
                          gated=act != "relu")
    x, idx, *rest = args
    idx = idx.clone()
    idx[1, 2], idx[3, 0] = -4, 11 + 6
    _check_v6q((x.to(xdt), idx, *rest), bu, 1e-5, act=act, mask_mode=mask_mode,
               fatrelu_threshold=0.01)


@pytest.mark.cuda
def test_v6q_plan(cuda):
    """The launch plan at the 13B decode shapes: clusters of at most 16
    blocks, a block count that is the clusters' multiple, and wave ratios
    at or above 1 (the busiest SM's share over an even one)."""
    from sparkinfer_tpu_torch.ops.sparse_ffn import v6q_plan

    for N in (1, 4):
        plan = v6q_plan(cuda, N, 16, 5120, 128)
        assert plan["sms"] > 0 and plan["smem_bytes"] > 0, plan
        for launch in ("up", "down"):
            p = plan[launch]
            assert 1 <= p["cluster"] <= 16 and p["blocks"] % p["cluster"] == 0, plan
            assert p["tile"] % 32 == 0 and 0.99 <= p["wave_ratio"] < 4, plan


# One v6q call profiled in a fresh process (see _V7U_ONE_CALL)
_V6Q_ONE_CALL = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[2])
from test_torch_cuda_kernels import _kernels_of_one_call
from sparkinfer_tpu_torch.ops.sparse_ffn import quantize_rows_q8_0, sparse_ffn_block_v6q
N = int(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(20)
stores = [t for sh in ((108, 5120, 128), (108, 5120, 128), (108, 128, 5120))
          for t in quantize_rows_q8_0(torch.randn(sh, generator=gen, device="cuda") * 0.05)]
idx = torch.stack([torch.randperm(108, generator=gen, device="cuda")[:16]
                   for _ in range(N)]).to(torch.int32)
gp = torch.rand((N, 16, 128), generator=gen, device="cuda")
bu = torch.randn((N, 16, 128), generator=gen, device="cuda") * 0.1
x = torch.randn((N, 5120), generator=gen, device="cuda").bfloat16()
print(json.dumps(_kernels_of_one_call(
    lambda: sparse_ffn_block_v6q(x, idx, gp, *stores, act="fatrelu", bu_sel=bu))))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 4])
def test_v6q_one_call_is_two_kernels(cuda, N):
    """One call over bf16 x, int32 ids and f32 gp and bias launches the up
    and down kernels and nothing else: no copy or conversion of x, no
    partial sums (profiled in a child process)."""
    import json
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", _V6Q_ONE_CALL, str(N), str(here)],
                          cwd=here.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) == 2, names
    assert "v6q_up" in names[0] and "v6q_down" in names[1], names


@pytest.mark.cuda
def test_v6q_sass_has_no_int_conversions(cuda):
    """v6q_up (bf16 and f32 x) and v6q_down read int8 as f32 with LOP3,
    PRMT and FADD: no I2F or I2FP in their SASS, and their FMAs (FFMA) and
    byte permutes (PRMT) show that the parser reads them. Needs cuobjdump."""
    from sparkinfer_tpu_torch.ops import _build
    from sparkinfer_tpu_torch.ops.sparse_ffn import _kernel_lib

    _kernel_lib("sparse_ffn_v6q", 12, 7)
    funcs = _sass_functions(_build.library_path("sparse_ffn_v6q"))
    v6q = {k: v for k, v in funcs.items() if "v6q_up" in k or "v6q_down" in k}
    assert len(v6q) == 3, sorted(funcs)
    for name, ops in v6q.items():
        assert "FFMA" in ops and "PRMT" in ops, (name, sorted(set(ops)))
        assert not {"I2F", "I2FP"} & set(ops), (name, sorted({"I2F", "I2FP"} & set(ops)))


@pytest.mark.cuda
def test_v6q_graph_replay_equals_the_eager_call(cuda):
    """Replays of a CUDA graph of two calls (the 13B shape at N = 4 with bf16
    x, an odd shape with f32 x) give the eager calls' bits: no state is left
    between calls."""
    a4, b4 = _q8_inputs(4, 16, 5120, 128, 40, cuda, seed=21)
    a3, b3 = _q8_inputs(3, 3, 1056, 96, 7, cuda, seed=22)
    a4 = (a4[0].bfloat16(), *a4[1:])
    calls = (lambda: sparse_ffn_block_v6q(*a4, act="fatrelu", bu_sel=b4),
             lambda: sparse_ffn_block_v6q(*a3, act="silu", mask_mode="scale", bu_sel=b3))
    ref = [c() for c in calls]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)


@pytest.mark.cuda
def test_packers_on_the_card_equal_the_cpu(cuda):
    gen = torch.Generator(device=cuda).manual_seed(17)
    w = torch.randn((3, 256, 96), generator=gen, device=cuda) * 0.1
    w[0, :32] = 0.0
    for a, b in zip(quantize_rows_q8_0(w), quantize_rows_q8_0(w.cpu())):
        assert torch.equal(a.cpu(), b)
    fa, fb = tqm.flat_quantize(w), tqm.flat_quantize(w.cpu())
    assert torch.equal(fa.q.cpu(), fb.q) and torch.equal(fa.s.cpu(), fb.s)
    for t in (GGMLType.Q8_0, GGMLType.Q4_0):
        assert torch.equal(quantize(w, t).cpu(), quantize(w.cpu(), t))


# ---------------------------------------------------------------------------
# quant_matmul_2d / quant_matmul_flat


def _store(kind, IN, ld, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "q8_0":
        q = torch.randint(-127, 128, (IN, ld), generator=gen, device=device).to(torch.int8)
    else:
        q = torch.randint(0, 256, (IN // 2, ld), generator=gen, device=device).to(torch.uint8)
    s = torch.rand((IN // 32, ld), generator=gen, device=device) * 0.01
    return q, s


def _check_qmm(got, ref, tol):
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= tol * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,IN,OUT,xdt", [
    (k, n, i, o, dt) for k in ("q4_0", "q8_0") for n in (1, 4, 32)
    for (i, o, dt) in ((5120, 5120, torch.bfloat16), (5120, 1280, torch.float32),
                       (96, 199, torch.float32))] + [
    (k, n, i, o, dt) for k in ("q4_0", "q8_0") for n in (2, 3)
    for (i, o) in ((5120, 5120), (5120, 1280), (96, 199))
    for dt in (torch.bfloat16, torch.float32)] + [
    (k, n, i, o, dt) for k in ("q4_0", "q8_0") for n in (1, 4)
    for (i, o, dt) in ((5120, 5120, torch.float32), (5120, 1280, torch.bfloat16),
                       (96, 199, torch.bfloat16))])
def test_quant_matmul_2d(cuda, kind, N, IN, OUT, xdt):
    """The 13B attention and predictor shapes, and an OUT that is not
    16-byte aligned (the byte-wise path), against the plain version: the
    decode kernel at N <= 4 (f32 and bf16 x), the prefill kernel at N = 32."""
    q, s = _store(kind, IN, OUT, cuda, seed=20)
    x = torch.randn((N, IN), device=cuda).to(xdt)
    before = tqm.quant_matmul_2d.launches
    got = tqm.quant_matmul_2d(x, q, s, kind=kind)
    torch.cuda.synchronize()
    assert tqm.quant_matmul_2d.launches == before + 1
    _check_qmm(got, tqm.quant_matmul_2d_plain(x, q, s, kind=kind), 1e-4 if IN > 256 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N,IN,OUT,xdt", [
    (k, n, i, o, dt) for k in ("q4_0", "q8_0") for n in (5, 8, 13, 32, 33, 128, 512)
    for (i, o, dt) in ((5120, 5120, torch.bfloat16), (5120, 1280, torch.float32),
                       (96, 199, torch.float32), (96, 199, torch.bfloat16))])
def test_quant_matmul_prefill(cuda, kind, N, IN, OUT, xdt):
    """qmm_prefill (N > 4) against the plain version: token counts below,
    at and across its token tiles (16, 32, 64), the 13B attention and
    pred_up shapes, and an OUT that is not 16-byte aligned (byte loads) at
    IN = 96 (three stages), f32 and bf16 x."""
    q, s = _store(kind, IN, OUT, cuda, seed=28)
    x = torch.randn((N, IN), device=cuda).to(xdt)
    before = tqm.quant_matmul_2d.launches
    got = tqm.quant_matmul_2d(x, q, s, kind=kind)
    torch.cuda.synchronize()
    assert tqm.quant_matmul_2d.launches == before + 1
    _check_qmm(got, tqm.quant_matmul_2d_plain(x, q, s, kind=kind), 1e-4 if IN > 256 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32])
def test_quant_matmul_prefill_head(cuda, xdt):
    """The 13B head, 5120 x 32000 Q8_0, at a 32-token prefill (250 column
    tiles), and an x that starts off a 16-byte boundary (byte loads of x)."""
    q, s = _store("q8_0", 5120, 32000, cuda, seed=29)
    x = torch.randn((33, 5120), device=cuda).to(xdt)
    for xx in (x[:32], x.view(-1)[1:1 + 32 * 5120].view(32, 5120)):
        _check_qmm(tqm.quant_matmul_2d(xx, q, s, kind="q8_0"),
                   tqm.quant_matmul_2d_plain(xx, q, s, kind="q8_0"), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,N", [("q8_0", 1), ("q8_0", 4), ("q4_0", 1), ("q8_0", 2),
                                    ("q8_0", 3), ("q4_0", 2), ("q4_0", 3), ("q4_0", 4),
                                    ("q8_0", 5), ("q8_0", 32), ("q4_0", 32), ("q8_0", 128)])
def test_quant_matmul_flat(cuda, kind, N):
    """Layer 2 of a 3-layer stack at the 13B pred_down shape, read in place."""
    L, IN, OUT = 3, 1280, 13824
    q, s = _store(kind, IN, L * OUT, cuda, seed=21)
    x = torch.randn((N, IN), device=cuda)
    before = tqm.quant_matmul_flat.launches
    got = tqm.quant_matmul_flat(x, q, s, 2, kind=kind, out_dim=OUT)
    torch.cuda.synchronize()
    assert tqm.quant_matmul_flat.launches == before + 1
    _check_qmm(got, tqm.quant_matmul_flat_plain(x, q, s, 2, kind=kind, out_dim=OUT), 1e-4)


@pytest.mark.cuda
def test_quant_matmul_is_deterministic_and_checks_shapes(cuda):
    q, s = _store("q8_0", 5120, 5120, cuda, seed=22)
    x = torch.randn((4, 5120), device=cuda)
    assert torch.equal(tqm.quant_matmul_2d(x, q, s, kind="q8_0"),
                       tqm.quant_matmul_2d(x, q, s, kind="q8_0"))
    with pytest.raises(ValueError):  # in not a multiple of 32
        tqm.quant_matmul_2d(x[:, :48], q[:48], s[:1], kind="q8_0")
    with pytest.raises(ValueError):  # int8 store named q4_0
        tqm.quant_matmul_2d(x, q, s, kind="q4_0")
    with pytest.raises(ValueError):  # bf16 scales
        tqm.quant_matmul_2d(x, q, s.bfloat16(), kind="q8_0")
    with pytest.raises(ValueError):  # a stripe past the store
        tqm.quant_matmul_flat(x, q, s, 2, kind="q8_0", out_dim=2560)


def _kernels_of_one_call(fn):
    """Names of the device kernels that one call of fn launches
    (torch.profiler), after a warm-up call outside the profile. The call
    lies between two marker kernels (fill_), and the window opens with a
    pause, since CUPTI records nothing for a moment after the profile
    starts; both markers must be recorded."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        marker.fill_(1.0)
        fn()
        marker.fill_(2.0)
        torch.cuda.synchronize()
        time.sleep(0.2)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("FillFunctor" in n for n in names) == 2, names
    return [n for n in names if "FillFunctor" not in n]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 4, 8, 32, 512])
def test_quant_matmul_launches_per_call(cuda, N):
    """One kernel per call: qmm_decode at N <= 4, qmm_prefill above, each
    summing its own K splits."""
    q, s = _store("q8_0", 5120, 5120, cuda, seed=24)
    x = torch.randn((N, 5120), device=cuda)
    names = _kernels_of_one_call(lambda: tqm.quant_matmul_2d(x, q, s, kind="q8_0"))
    if N <= tqm.DECODE_MAX_N:
        assert len(names) == 1 and "qmm_decode" in names[0], names
        assert tqm.launch_plan(cuda, N, 5120, 5120, "q8_0")["k_splits"] > 1
    else:
        assert len(names) == 1 and "qmm_prefill" in names[0], names
    if N in (8, 32):
        assert tqm.launch_plan(cuda, N, 5120, 5120, "q8_0")["k_splits"] > 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("N", [1, 4])
def test_quant_matmul_decode_is_bit_equal_across_calls_and_graph_replays(cuda, kind, N):
    """The last block of a column tile adds the K splits in split order, so
    every call and every replay gives the same bits; two replays of a graph
    of two calls show that the tile counters are back at 0 after each."""
    q, s = _store(kind, 5120, 3 * 1280, cuda, seed=25)
    x = torch.randn((N, 5120), device=cuda)
    x2 = torch.randn((N, 5120), device=cuda).bfloat16()
    calls = (lambda: tqm.quant_matmul_2d(x, q, s, kind=kind),
             lambda: tqm.quant_matmul_flat(x2, q, s, 1, kind=kind, out_dim=1280))
    ref = [c() for c in calls]
    for _ in range(3):
        for c, r in zip(calls, ref):
            assert torch.equal(c(), r)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)
    _check_qmm(ref[0], tqm.quant_matmul_2d_plain(x, q, s, kind=kind), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["q8_0", "q4_0"])
@pytest.mark.parametrize("N", [8, 32, 128, 512])
def test_quant_matmul_prefill_is_bit_equal_across_calls_and_graph_replays(cuda, kind, N):
    """qmm_prefill's last block of a tile adds the K splits in split order:
    the same bits on every call and replay, with the counters back at 0."""
    q, s = _store(kind, 5120, 3 * 1280, cuda, seed=30)
    x = torch.randn((N, 5120), device=cuda)
    x2 = torch.randn((N, 5120), device=cuda).bfloat16()
    assert tqm.launch_plan(cuda, N, 5120, 1280, kind)["k_splits"] > 1
    calls = (lambda: tqm.quant_matmul_2d(x, q, s, kind=kind),
             lambda: tqm.quant_matmul_flat(x2, q, s, 1, kind=kind, out_dim=1280))
    ref = [c() for c in calls]
    for _ in range(3):
        for c, r in zip(calls, ref):
            assert torch.equal(c(), r)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)
    _check_qmm(ref[0], tqm.quant_matmul_2d_plain(x, q, s, kind=kind), 1e-4)
    _check_qmm(ref[1], tqm.quant_matmul_flat_plain(x2, q, s, 1, kind=kind, out_dim=1280), 1e-4)


@pytest.mark.cuda
def test_quant_matmul_decode_workspace_guards(cuda, monkeypatch):
    """The decode workspace is allocated at a device's first decode call,
    which raises inside CUDA-graph capture; a call whose K splits need more
    tile counters or partials than the workspace holds raises."""
    q, s = _store("q8_0", 5120, 5120, cuda, seed=26)
    x = torch.randn((1, 5120), device=cuda)
    ref = tqm.quant_matmul_2d(x, q, s, kind="q8_0")
    monkeypatch.setattr(tqm, "_workspace", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before CUDA-graph capture"):
        with torch.cuda.graph(graph):
            tqm.quant_matmul_2d(x, q, s, kind="q8_0")
    assert not tqm._workspace
    assert torch.equal(tqm.quant_matmul_2d(x, q, s, kind="q8_0"), ref)  # allocates
    plan = tqm.launch_plan(cuda, 1, 5120, 5120, "q8_0")
    assert plan["k_splits"] > 1 and plan["tiles"] > 4
    monkeypatch.setattr(tqm, "_capacity", [(4, tqm._capacity[0][1])])
    with pytest.raises(ValueError, match="tile counters"):
        tqm.quant_matmul_2d(x, q, s, kind="q8_0")
    monkeypatch.setattr(tqm, "_capacity", [(1 << 16, 5120)])
    with pytest.raises(ValueError, match="partial floats"):
        tqm.quant_matmul_2d(x, q, s, kind="q8_0")


@pytest.mark.cuda
def test_quant_matmul_decode_refuses_an_in_dim_beyond_its_splits(cuda):
    """At N = 4 no K split (at most 16) holds more than 32768 input rows of x
    in shared memory, so the wrapper raises for 32800; at N = 1 it fits."""
    q, s = _store("q8_0", 32800, 16, cuda, seed=27)
    assert tqm.launch_plan(cuda, 4, 32800, 16, "q8_0")["k_splits"] == 0
    with pytest.raises(ValueError, match="in dim too large"):
        tqm.quant_matmul_2d(torch.randn((4, 32800), device=cuda), q, s, kind="q8_0")
    x = torch.randn((1, 32800), device=cuda)
    _check_qmm(tqm.quant_matmul_2d(x, q, s, kind="q8_0"),
               tqm.quant_matmul_2d_plain(x, q, s, kind="q8_0"), 1e-4)


_CONVERSIONS = {"I2F", "I2FP", "F2F", "F2FP", "F2I", "F2IP"}


def _sass_functions(lib_path):
    """{kernel name: [opcode, ...]} from cuobjdump -sass of the library."""
    import re
    import shutil
    import subprocess

    from sparkinfer_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = chunk.split("\n", 1)
        funcs[name.strip()] = re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)", body)
    return funcs


@pytest.mark.cuda
def test_quant_matmul_decode_sass_has_no_conversions(cuda):
    """qmm_decode dequantizes with PRMT, LOP3, FADD and bf16x2 FMAs: its
    SASS holds no I2F, F2F or F2FP (nor their P forms or F2I). qmm_prefill,
    which rounds x and the scales to bf16 with F2FP, shows that the parser
    sees them. Needs cuobjdump from the CUDA toolkit."""
    from sparkinfer_tpu_torch.ops import _build

    tqm._lib()
    funcs = _sass_functions(_build.library_path("quant_matmul"))
    decode = {k: v for k, v in funcs.items() if "qmm_decode" in k}
    assert len(decode) == 8, sorted(funcs)  # Q8_0 and Q4_0 at N = 1, 2, 3, 4
    for name, ops in decode.items():
        assert len(ops) > 100, name
        assert not _CONVERSIONS & set(ops), (name, sorted(_CONVERSIONS & set(ops)))
    prefill = [v for k, v in funcs.items() if "qmm_prefill" in k]
    assert prefill and all(_CONVERSIONS & set(ops) for ops in prefill)


@pytest.mark.cuda
def test_quant_matmul_prefill_sass_runs_on_tensor_cores(cuda):
    """All six qmm_prefill instantiations (Q8_0 and Q4_0 at token tiles 16,
    32 and 64) issue tensor-core products (HMMA) and dequantize without I2F
    (PRMT, LOP3 and bf16x2 FMAs). Needs cuobjdump."""
    from sparkinfer_tpu_torch.ops import _build

    tqm._lib()
    funcs = _sass_functions(_build.library_path("quant_matmul"))
    prefill = {k: v for k, v in funcs.items() if "qmm_prefill" in k}
    assert len(prefill) == 6, sorted(funcs)
    for name, ops in prefill.items():
        assert "HMMA" in ops or "HGMMA" in ops, (name, sorted(set(ops)))
        assert not {"I2F", "I2FP"} & set(ops), name


@pytest.mark.cuda
def test_bf16_lm_head_on_the_card(cuda):
    """f32 sums of exact bf16 products: the card's f32-output product
    against the CPU's f32 chunks."""
    x = torch.randn((3, 5120), device=cuda).bfloat16()
    w = (torch.randn((5120, 32000), device=cuda) * 0.02).bfloat16()
    got = lm_head(x, w)
    ref = lm_head(x.cpu(), w.cpu())
    assert got.dtype == torch.float32
    _check_qmm(got.cpu(), ref, 1e-5)


# ---------------------------------------------------------------------------
# v1 over neuron-row stores, v7u over the cross-token union


def _v1_inputs(N, C, E, G, R, dtype, device, seed, bias=True, gated=True):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    x = t(rng.standard_normal((N, E)))
    idx = t(np.stack([rng.choice(R, C, replace=False) for _ in range(N)]), torch.int32)
    gp = t(rng.uniform(0, 1, (N, C, G)))
    bu = t(rng.standard_normal((N, C, G)) * 0.1) if bias else None
    bg = t(rng.standard_normal((N, C, G)) * 0.1) if bias and gated else None
    wu = t(rng.standard_normal((R, G, E)) * 0.05, dtype)
    wg = t(rng.standard_normal((R, G, E)) * 0.05, dtype) if gated else None
    wd = t(rng.standard_normal((R, G, E)) * 0.05, dtype)
    return (x, idx, gp, wu, wg, wd), dict(bu_sel=bu, bg_sel=bg)


def _check_fn(fn, plain, args, tol, **kw):
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _check_qmm(got, plain(*args, **kw), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("act,mask_mode,bias", list(itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu", "swiglu_oai"], ["threshold", "scale"],
    [True, False])))
def test_v1_small_f32(cuda, act, mask_mode, bias):
    args, kw = _v1_inputs(3, 4, 64, 16, 12, torch.float32, cuda, seed=31, bias=bias,
                          gated=act != "relu")
    _check_fn(sparse_ffn_block, sparse_ffn_block_plain, args, 1e-5, act=act,
              mask_mode=mask_mode, fatrelu_threshold=0.01, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("N,act", [(1, "fatrelu"), (4, "fatrelu"), (4, "relu")])
def test_v1_decode_shape_bf16(cuda, N, act):
    """ProSparse-Llama-2-7B widths: E=4096, G=128, C=12 of 86 groups, bf16."""
    args, kw = _v1_inputs(N, 12, 4096, 128, 86, torch.bfloat16, cuda, seed=32,
                          gated=act != "relu")
    x, *rest = args
    _check_fn(sparse_ffn_block, sparse_ffn_block_plain, (x.bfloat16(), *rest), 1e-3,
              act=act, bu_sel=kw["bu_sel"])


@pytest.mark.cuda
def test_v1_odd_widths(cuda):
    """E not a multiple of the kernel's tiles; G neither a power of 2 nor a
    multiple of 8 (v1 needs only E % 8 == 0)."""
    args, kw = _v1_inputs(2, 3, 1000, 12, 7, torch.bfloat16, cuda, seed=33)
    _check_fn(sparse_ffn_block, sparse_ffn_block_plain, args, 1e-3, act="silu", **kw)


@pytest.mark.cuda
def test_v1_rejects_bad_stores(cuda):
    (x, idx, gp, wu, wg, wd), _ = _v1_inputs(1, 2, 64, 16, 4, torch.bfloat16, cuda, seed=34)
    with pytest.raises(ValueError):  # stores in two dtypes
        sparse_ffn_block(x, idx, gp, wu, wg.float(), wd, act="fatrelu")
    with pytest.raises(ValueError):  # a store in the transposed layout
        sparse_ffn_block(x, idx, gp, wu.transpose(1, 2).contiguous(), wg, wd, act="fatrelu")
    with pytest.raises(ValueError):  # a gated activation without its gate
        sparse_ffn_block(x, idx, gp, wu, None, wd, act="swiglu_oai")
    with pytest.raises(ValueError):  # E not a multiple of 8
        sparse_ffn_block(x[:, :60], idx, gp, wu[..., :60].contiguous(),
                         wg[..., :60].contiguous(), wd[..., :60].contiguous(), act="fatrelu")


@pytest.mark.cuda
def test_v1_is_deterministic(cuda):
    args, kw = _v1_inputs(4, 12, 4096, 128, 64, torch.bfloat16, cuda, seed=35)
    a = sparse_ffn_block(*args, act="fatrelu", **kw)
    b = sparse_ffn_block(*args, act="fatrelu", **kw)
    assert torch.equal(a, b)


# The shapes of the v1 sweep: C in (1, 3, 12), G in (12, 48, 128, 2048) and
# E in (64, 1000, 4096), with the 7B decode shape (12, 128, 4096)
_V1_SHAPES = [(1, 12, 64), (3, 48, 1000), (12, 128, 4096), (3, 2048, 64),
              (1, 128, 1000), (12, 12, 4096), (3, 128, 4096), (1, 2048, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("C,G,E", _V1_SHAPES)
def test_v1_sweep_bf16(cuda, N, C, G, E):
    """bf16 x and stores (the Scheduler's route) at every token count,
    selection count, group size and width, with both biases, inputs made on
    the card: the grid shares each token's C * G rows among its blocks, so
    a block's rows may span selections."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    R = C + 3

    def store():
        return (torch.randn((R, G, E), generator=gen, device=cuda) * 0.05).bfloat16()

    x = torch.randn((N, E), generator=gen, device=cuda).bfloat16()
    idx = torch.stack([torch.randperm(R, generator=gen, device=cuda)[:C]
                       for _ in range(N)]).to(torch.int32)
    gp = torch.rand((N, C, G), generator=gen, device=cuda)
    bu = torch.randn((N, C, G), generator=gen, device=cuda) * 0.1
    bg = torch.randn((N, C, G), generator=gen, device=cuda) * 0.1
    _check_fn(sparse_ffn_block, sparse_ffn_block_plain, (x, idx, gp, store(), store(), store()),
              1e-3, act="fatrelu", fatrelu_threshold=0.01, bu_sel=bu, bg_sel=bg)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt,act,mask_mode,bias", list(itertools.product(
    [torch.bfloat16, torch.float32], [torch.bfloat16, torch.float32],
    ["fatrelu", "drelu", "relu", "silu", "gelu", "swiglu_oai"], ["threshold", "scale"],
    [True, False])))
def test_v1_routes(cuda, xdt, wdt, act, mask_mode, bias):
    """Each route: bf16 or f32 x, bf16 or f32 stores, every activation (gated
    swiglu_oai with its gate bias), both mask modes, with and without the
    biases; two row ids out of range (clamped); the 7B selection shape (C =
    12 of G = 128 rows) at an odd width. 1e-5 of the scale with f32 stores,
    1e-3 with bf16 (a hidden value that rounds to the neighbouring bf16 value
    moves the output by one bf16 step of it times its down row)."""
    args, kw = _v1_inputs(5, 12, 1000, 128, 15, wdt, cuda, seed=41, bias=bias,
                          gated=act != "relu")
    x, idx, *rest = args
    idx = idx.clone()
    idx[1, 2], idx[3, 0] = -4, 15 + 6
    _check_fn(sparse_ffn_block, sparse_ffn_block_plain, (x.to(xdt), idx, *rest),
              1e-5 if wdt == torch.float32 else 1e-3, act=act, mask_mode=mask_mode,
              fatrelu_threshold=0.01, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,wdt,act", list(itertools.product(
    ["v1", "v2", "v3", "v4", "v5"], [torch.bfloat16, torch.float32], ["fatrelu", "relu"])))
def test_v1_layouts(cuda, kernel, wdt, act):
    """The five layouts through the one kernel (three stores; v2's offsets
    into one concatenated store; v4's interleaved stride), bf16 x, with an
    up bias, ids out of range clamped into each projection's own rows."""
    gated = act != "relu"
    args, kw = _v1_inputs(4, 12, 1000, 48, 15, wdt, cuda, seed=42, gated=gated)
    x, idx, *stores = args
    idx = idx.clone()
    idx[0, 0], idx[2, 5] = 15 + 4, -2
    args = (x.bfloat16(), idx, *stores)
    tol = 1e-5 if wdt == torch.float32 else 1e-3
    if kernel == "v1":
        _check_fn(sparse_ffn_block, sparse_ffn_block_plain, args, tol, act=act,
                  mask_mode="scale", **kw)
        return
    fn, plain, rargs, extra = _row_calls(kernel, args, gated)
    _check_fn(fn, plain, rargs, tol, act=act, mask_mode="scale", bu_sel=kw["bu_sel"], **extra)


@pytest.mark.cuda
def test_v1_reads_misaligned_x(cuda):
    """A contiguous view of x that does not start on 16 bytes is copied,
    not read misaligned."""
    args, kw = _v1_inputs(2, 3, 64, 16, 7, torch.bfloat16, cuda, seed=43)
    x, *rest = args
    base = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    base[1:] = x.bfloat16().flatten()
    xm = base[1:].view(x.shape)
    assert xm.is_contiguous() and xm.data_ptr() % 16
    _check_fn(sparse_ffn_block, sparse_ffn_block_plain, (xm, *rest), 1e-3, act="fatrelu", **kw)


@pytest.mark.cuda
def test_v1_refuses_widths_beyond_its_limits(cuda):
    """E above V1_MAX_E or N above V1_MAX_N raises rather than falling back."""
    from sparkinfer_tpu_torch.ops.sparse_ffn import V1_MAX_E, V1_MAX_N

    (x, idx, gp, wu, wg, wd), _ = _v1_inputs(1, 2, V1_MAX_E + 8, 2, 3, torch.bfloat16, cuda,
                                             seed=44)
    with pytest.raises(ValueError, match="E <="):
        sparse_ffn_block(x, idx, gp, wu, wg, wd, act="fatrelu")
    (x, idx, gp, wu, wg, wd), _ = _v1_inputs(V1_MAX_N + 1, 1, 64, 8, 2, torch.bfloat16, cuda,
                                             seed=45)
    with pytest.raises(ValueError, match="N <="):
        sparse_ffn_block(x, idx, gp, wu, wg, wd, act="fatrelu")


@pytest.mark.cuda
def test_v1_plan(cuda):
    """The launch plan at the 7B decode shapes: clusters of 1-16 blocks, each
    token's C * G rows shared among its clusters' blocks (at least one row
    a block), so N * clusters * KS blocks, and wave ratios at or above 1."""
    from sparkinfer_tpu_torch.ops.sparse_ffn import v1_plan

    for N, gated in itertools.product((1, 4, 8), (True, False)):
        plan = v1_plan(cuda, N, 12, 4096, 128, gated=gated)
        assert plan["sms"] > 0 and plan["smem_bytes"] > 0, plan
        assert 1 <= plan["splits"] <= 16 and plan["clusters_per_token"] >= 1, plan
        assert plan["blocks"] == N * plan["clusters_per_token"] * plan["splits"], plan
        assert plan["clusters_per_token"] * plan["splits"] <= 12 * 128, plan
        assert 0.99 <= plan["wave_ratio"] < 4 and plan["stages"] > 1, plan
        assert plan["down_rows"] == (2 if gated else 1) * plan["up_rows"], plan


@pytest.mark.cuda
def test_v1_workspace_counters_and_capture_guard(cuda, monkeypatch):
    """Every counter of the workspace is 0 after calls of several shapes;
    the workspace is allocated at a device's first call, which raises
    inside CUDA-graph capture."""
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf

    a8, k8 = _v1_inputs(8, 12, 4096, 128, 40, torch.bfloat16, cuda, seed=46)
    a2, k2 = _v1_inputs(2, 3, 1000, 12, 7, torch.float32, cuda, seed=47)
    ref = sparse_ffn_block(*a8, act="fatrelu", **k8)
    sparse_ffn_block(*a2, act="swiglu_oai", **k2)
    sparse_ffn_block_v2(a8[0], a8[1], a8[2], torch.cat(a8[3:]), act="fatrelu", gated=True,
                        R=40)
    torch.cuda.synchronize()
    ws = sf._v1_workspace[a8[0].device.index]
    assert ws.dtype == torch.int32 and int(ws.count_nonzero()) == 0
    monkeypatch.setattr(sf, "_v1_workspace", {})
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="before CUDA-graph capture"):
        with torch.cuda.graph(graph):
            sparse_ffn_block(*a8, act="fatrelu", **k8)
    assert not sf._v1_workspace
    assert torch.equal(sparse_ffn_block(*a8, act="fatrelu", **k8), ref)  # allocates
    torch.cuda.synchronize()
    assert int(sf._v1_workspace[a8[0].device.index].count_nonzero()) == 0


@pytest.mark.cuda
def test_v1_graph_replay_equals_the_eager_call(cuda):
    """Repeated eager calls and replays of a CUDA graph of four calls (the 7B
    shape at N = 4 and N = 1 with bf16 x, an odd shape with f32 x and
    stores, v2 over its concatenated store) give the same bits: no state is
    left between calls and no sum depends on arrival order."""
    a4, k4 = _v1_inputs(4, 12, 4096, 128, 40, torch.bfloat16, cuda, seed=48)
    a1, k1 = _v1_inputs(1, 12, 4096, 128, 40, torch.bfloat16, cuda, seed=49)
    a3, k3 = _v1_inputs(3, 3, 1000, 12, 7, torch.float32, cuda, seed=50)
    a4 = (a4[0].bfloat16(), *a4[1:])
    w_all = torch.cat(a1[3:])
    calls = (lambda: sparse_ffn_block(*a4, act="fatrelu", **k4),
             lambda: sparse_ffn_block(*a1[:3], a1[3], None, a1[5], act="relu",
                                      bu_sel=k1["bu_sel"]),
             lambda: sparse_ffn_block(*a3, act="swiglu_oai", mask_mode="scale", **k3),
             lambda: sparse_ffn_block_v2(a1[0], a1[1], a1[2], w_all, act="silu", gated=True,
                                         R=40))
    ref = [c() for c in calls]
    for _ in range(3):
        assert all(torch.equal(c(), r) for c, r in zip(calls, ref))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)


# One row-kernel call profiled in a fresh process (see _V7U_ONE_CALL): v1
# over three bf16 stores, or v2 over its concatenated store
_V1_ONE_CALL = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[3])
from test_torch_cuda_kernels import _kernels_of_one_call
from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block, sparse_ffn_block_v2
N, kind = int(sys.argv[1]), sys.argv[2]
gen = torch.Generator(device="cuda").manual_seed(51)
w_all = (torch.randn((3 * 86, 128, 4096), generator=gen, device="cuda") * 0.05).bfloat16()
idx = torch.stack([torch.randperm(86, generator=gen, device="cuda")[:12]
                   for _ in range(N)]).to(torch.int32)
gp = torch.rand((N, 12, 128), generator=gen, device="cuda")
x = torch.randn((N, 4096), generator=gen, device="cuda").bfloat16()
if kind == "v2":
    fn = lambda: sparse_ffn_block_v2(x, idx, gp, w_all, act="fatrelu", gated=True, R=86)
else:
    fn = lambda: sparse_ffn_block(x, idx, gp, w_all[:86], w_all[86:172], w_all[172:],
                                  act="fatrelu")
print(json.dumps(_kernels_of_one_call(fn)))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("N,kind", [(1, "v1"), (4, "v1"), (1, "v2")])
def test_v1_one_call_is_one_kernel(cuda, N, kind):
    """One call over bf16 x and stores, int32 ids and f32 gp launches v1_ffn
    and nothing else: no copy or conversion of x, no sum of partials in
    another kernel (profiled in a child process)."""
    import json
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", _V1_ONE_CALL, str(N), kind, str(here)],
                          cwd=here.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) == 1 and "v1_ffn" in names[0], names


def _v7u_inputs(B, Cu, E, G, R, dtype, device, seed, xdt=torch.float32, bias=True,
                gated=True):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    x = t(rng.standard_normal((B, E)), xdt)
    union = t(rng.choice(R, Cu, replace=False), torch.int32)
    sel = rng.uniform(0, 1, (B, Cu, 1)) < 0.6  # which tokens selected each slot
    gp = t(rng.uniform(0, 1, (B, Cu, G)) * sel)
    bu = t(rng.standard_normal((B, Cu, G)) * 0.1) if bias else None
    wu = t(rng.standard_normal((R, E, G)) * 0.05, dtype)
    wg = t(rng.standard_normal((R, E, G)) * 0.05, dtype) if gated else None
    wd = t(rng.standard_normal((R, G, E)) * 0.05, dtype)
    return (x, union, gp, wu, wg, wd), dict(bu_u=bu)


@pytest.mark.cuda
@pytest.mark.parametrize("act,mask_mode,bias", list(itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu"], ["threshold", "scale"], [True, False])))
def test_v7u_small_f32(cuda, act, mask_mode, bias):
    args, kw = _v7u_inputs(3, 5, 64, 16, 12, torch.float32, cuda, seed=41, bias=bias,
                           gated=act != "relu")
    _check_fn(sparse_ffn_block_v7u, sparse_ffn_block_v7u_plain, args, 1e-3, act=act,
              mask_mode=mask_mode, fatrelu_threshold=0.01, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
def test_v7u_store_casts(cuda, xdt, wdt):
    """The up/gate stores cast to x's dtype (an f32 store rounds to bf16
    under a bf16 x), W_down rounded to bf16."""
    args, kw = _v7u_inputs(4, 6, 256, 32, 9, wdt, cuda, seed=42, xdt=xdt)
    _check_fn(sparse_ffn_block_v7u, sparse_ffn_block_v7u_plain, args, 1e-3,
              act="fatrelu", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 8, 11])
def test_v7u_decode_shape_bf16(cuda, B):
    """ProSparse-Llama-2-7B widths: E=4096, G=128, Cu=48 of 86 groups, bf16;
    B=11 takes two token chunks."""
    args, kw = _v7u_inputs(B, 48, 4096, 128, 86, torch.bfloat16, cuda, seed=43,
                           xdt=torch.bfloat16)
    _check_fn(sparse_ffn_block_v7u, sparse_ffn_block_v7u_plain, args, 1e-3,
              act="fatrelu", **kw)


@pytest.mark.cuda
def test_v7u_odd_widths(cuda):
    """E not a multiple of the kernel's slices and tiles; G not a power of 2."""
    args, kw = _v7u_inputs(3, 5, 1000, 48, 7, torch.bfloat16, cuda, seed=44)
    _check_fn(sparse_ffn_block_v7u, sparse_ffn_block_v7u_plain, args, 1e-3, act="silu",
              **kw)


@pytest.mark.cuda
def test_v7u_rejects_bad_stores(cuda):
    (x, union, gp, wu, wg, wd), _ = _v7u_inputs(2, 3, 64, 16, 4, torch.bfloat16, cuda,
                                                seed=45)
    with pytest.raises(ValueError):  # stores in two dtypes
        sparse_ffn_block_v7u(x, union, gp, wu, wg.float(), wd, act="fatrelu")
    with pytest.raises(ValueError):  # gp_u of another union size
        sparse_ffn_block_v7u(x, union[:2], gp, wu, wg, wd, act="fatrelu")
    with pytest.raises(ValueError):  # swiglu_oai is v1's alone
        sparse_ffn_block_v7u(x, union, gp, wu, wg, wd, act="swiglu_oai")
    (x, union, gp, wu, wg, wd), _ = _v7u_inputs(2, 3, 64, 12, 4, torch.bfloat16, cuda,
                                                seed=46)
    with pytest.raises(ValueError):  # G not a multiple of 8
        sparse_ffn_block_v7u(x, union, gp, wu, wg, wd, act="fatrelu")


@pytest.mark.cuda
def test_v7u_is_deterministic(cuda):
    args, kw = _v7u_inputs(8, 48, 4096, 128, 86, torch.bfloat16, cuda, seed=47,
                           xdt=torch.bfloat16)
    a = sparse_ffn_block_v7u(*args, act="fatrelu", **kw)
    b = sparse_ffn_block_v7u(*args, act="fatrelu", **kw)
    assert torch.equal(a, b)


# The launch shapes of the sweep: every Cu in (1, 5, 47, 48, 64), G in
# (16, 48, 128, 256) and E in (64, 1000, 4096, 5120), with the 7B and 13B
# batched-decode shapes (Cu, G, E) = (48, 128, 4096) and (64, 128, 5120)
_V7U_SHAPES = [(1, 16, 64), (5, 48, 1000), (47, 256, 4096), (48, 128, 4096),
               (64, 128, 5120), (5, 256, 5120), (64, 16, 1000), (47, 48, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 8, 16, 33])
@pytest.mark.parametrize("Cu,G,E", _V7U_SHAPES)
def test_v7u_sweep_bf16(cuda, B, Cu, G, E):
    """bf16 x over bf16 stores (the batched path's route) at every B (33:
    two token tiles of 32), union size, group size and width. Inputs made on
    the card (the stores reach 250 MB)."""
    gen = torch.Generator(device=cuda).manual_seed(48)
    R = Cu + 3

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=cuda) * 0.05).bfloat16()

    x = torch.randn((B, E), generator=gen, device=cuda).bfloat16()
    union = torch.randperm(R, generator=gen, device=cuda)[:Cu].to(torch.int32)
    sel = torch.rand((B, Cu, 1), generator=gen, device=cuda) < 0.6
    gp = torch.rand((B, Cu, G), generator=gen, device=cuda) * sel
    kw = dict(bu_u=torch.randn((B, Cu, G), generator=gen, device=cuda) * 0.1)
    args = (x, union, gp, w(R, E, G), w(R, E, G), w(R, G, E))
    _check_fn(sparse_ffn_block_v7u, sparse_ffn_block_v7u_plain, args, 1e-3,
              act="fatrelu", fatrelu_threshold=0.01, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt,act,mask_mode,bias", list(itertools.product(
    [torch.bfloat16, torch.float32], [torch.bfloat16, torch.float32],
    ["fatrelu", "relu"], ["threshold", "scale"], [True, False])))
def test_v7u_routes(cuda, xdt, wdt, act, mask_mode, bias):
    """Each route: bf16 x or f32 x (three bf16 terms) over bf16 stores on the
    tensor cores, f32 stores rounded to bf16 under a bf16 x, f32 x over f32
    stores by f32 FMAs; gated and ungated, both mask modes, with and without
    the up bias; two of the union's row ids out of range (clamped)."""
    args, kw = _v7u_inputs(5, 7, 1000, 48, 11, wdt, cuda, seed=49, xdt=xdt, bias=bias,
                           gated=act != "relu")
    x, union, *rest = args
    union = union.clone()
    union[1], union[4] = -3, 11 + 5
    _check_fn(sparse_ffn_block_v7u, sparse_ffn_block_v7u_plain, (x, union, *rest), 1e-3,
              act=act, mask_mode=mask_mode, fatrelu_threshold=0.01, **kw)


@pytest.mark.cuda
def test_v7u_shared_bias_row_is_read_in_place(cuda):
    """An up bias expanded over the tokens (batch stride 0, as the batched
    path passes it) gives the same output as its contiguous copy."""
    args, kw = _v7u_inputs(4, 48, 4096, 128, 86, torch.bfloat16, cuda, seed=50,
                           xdt=torch.bfloat16)
    row = kw["bu_u"][:1]
    shared = row.expand(4, -1, -1)
    assert shared.stride(0) == 0
    got = sparse_ffn_block_v7u(*args, act="fatrelu", bu_u=shared)
    assert torch.equal(got, sparse_ffn_block_v7u(*args, act="fatrelu",
                                                 bu_u=shared.contiguous()))
    _check_qmm(got, sparse_ffn_block_v7u_plain(*args, act="fatrelu", bu_u=shared), 1e-3)


# One v7u call profiled in a fresh process: in a process that has captured
# CUDA graphs (earlier tests of this file), a short torch.profiler window
# records no device activity at all.
_V7U_ONE_CALL = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[2])
from test_torch_cuda_kernels import _kernels_of_one_call
from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v7u
B = int(sys.argv[1])
gen = torch.Generator(device="cuda").manual_seed(51)
w = [(torch.randn(sh, generator=gen, device="cuda") * 0.05).bfloat16()
     for sh in ((86, 4096, 128), (86, 4096, 128), (86, 128, 4096))]
union = torch.randperm(86, generator=gen, device="cuda")[:48].to(torch.int32)
gp = torch.rand((B, 48, 128), generator=gen, device="cuda")
bu = torch.randn((B, 48, 128), generator=gen, device="cuda") * 0.1
x = torch.randn((B, 4096), generator=gen, device="cuda").bfloat16()
print(json.dumps(_kernels_of_one_call(
    lambda: sparse_ffn_block_v7u(x, union, gp, *w, act="fatrelu", bu_u=bu))))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_v7u_one_call_is_two_kernels(cuda, B):
    """One call over bf16 x, bf16 stores and an f32 bias launches the up and
    down kernels and nothing else: no copy or conversion of x, no partial
    sums (profiled in a child process)."""
    import json
    import subprocess
    import sys

    here = Path(__file__).resolve().parent
    proc = subprocess.run([sys.executable, "-c", _V7U_ONE_CALL, str(B), str(here)],
                          cwd=here.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(names) == 2, names
    assert "v7u_up" in names[0] and "v7u_down" in names[1], names


@pytest.mark.cuda
def test_v7u_sass_runs_on_tensor_cores(cuda):
    """Every v7u_down instantiation and every v7u_up one but the f32-x over
    f32-stores route issue tensor-core products (HMMA); that route's FMAs
    (FFMA) show that the parser reads the functions. Needs cuobjdump."""
    from sparkinfer_tpu_torch.ops import _build
    from sparkinfer_tpu_torch.ops.sparse_ffn import _kernel_lib

    _kernel_lib("sparse_ffn_v7u", 9, 9)
    funcs = _sass_functions(_build.library_path("sparse_ffn_v7u"))
    up = {k: v for k, v in funcs.items() if "v7u_up" in k}
    down = {k: v for k, v in funcs.items() if "v7u_down" in k}
    assert len(up) == 12 and len(down) == 6, sorted(funcs)
    fma_route = {k for k in up if "v7u_upILb1ELb1E" in k}
    assert len(fma_route) == 3, sorted(up)
    for name, ops in list(up.items()) + list(down.items()):
        if name in fma_route:
            assert "FFMA" in ops and "HMMA" not in ops, name
        else:
            assert "HMMA" in ops or "HGMMA" in ops, (name, sorted(set(ops)))


@pytest.mark.cuda
def test_v7u_graph_replay_equals_the_eager_call(cuda):
    """Replays of a CUDA graph of two calls (B = 8 and B = 3, bf16 and f32 x)
    give the eager calls' bits: no state is left between calls."""
    a8, k8 = _v7u_inputs(8, 48, 4096, 128, 86, torch.bfloat16, cuda, seed=52,
                         xdt=torch.bfloat16)
    a3, k3 = _v7u_inputs(3, 5, 1000, 48, 7, torch.bfloat16, cuda, seed=53)
    calls = (lambda: sparse_ffn_block_v7u(*a8, act="fatrelu", **k8),
             lambda: sparse_ffn_block_v7u(*a3, act="silu", mask_mode="scale", **k3))
    ref = [c() for c in calls]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)


# ---------------------------------------------------------------------------
# v2, v3, v4, v5: v1's strided kernel over their own stores


def _row_calls(kernel, args, gated):
    """(wrapper, plain, args, kwargs) of one row kernel over the (R, G, E)
    stores of args, rearranged into the kernel's own store."""
    x, idx, gp, wu, wg, wd = args
    if kernel == "v3":
        return sparse_ffn_block_v3, sparse_ffn_block_v3_plain, args, {}
    if kernel == "v5":
        return sparse_ffn_block_v5, sparse_ffn_block_v5_plain, args, {}
    if kernel == "v4":
        return (sparse_ffn_block_v4, sparse_ffn_block_v4_plain,
                (x, idx, gp, interleave_rows(wu, wg, wd)), dict(gated=gated))
    w_all = torch.cat([wu] + ([wg] if gated else []) + [wd])
    return (sparse_ffn_block_v2, sparse_ffn_block_v2_plain, (x, idx, gp, w_all),
            dict(gated=gated, R=wu.shape[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,act,mask_mode,bias", list(itertools.product(
    ["v2", "v3", "v4", "v5"], ["fatrelu", "drelu", "relu", "silu", "gelu"],
    ["threshold", "scale"], [True, False])))
def test_row_kernels_small_f32(cuda, kernel, act, mask_mode, bias):
    args, kw = _v1_inputs(3, 4, 64, 16, 12, torch.float32, cuda, seed=51, bias=bias,
                          gated=act != "relu")
    fn, plain, args, extra = _row_calls(kernel, args, act != "relu")
    _check_fn(fn, plain, args, 1e-5, act=act, mask_mode=mask_mode, fatrelu_threshold=0.01,
              bu_sel=kw["bu_sel"], **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["v2", "v4"])
def test_row_kernels_gated_swiglu_and_relu(cuda, kernel):
    """v2 and v4 read the gate for any activation when gated: swiglu_oai
    computes, relu ignores the gate."""
    args, kw = _v1_inputs(2, 3, 64, 16, 9, torch.float32, cuda, seed=52)
    for act in ("swiglu_oai", "relu"):
        fn, plain, rargs, extra = _row_calls(kernel, args, True)
        _check_fn(fn, plain, rargs, 1e-5, act=act, bu_sel=kw["bu_sel"], **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,N", list(itertools.product(["v2", "v3", "v4", "v5"],
                                                             [1, 4])))
def test_row_kernels_decode_shape_bf16(cuda, kernel, N):
    """ProSparse-Llama-2-7B widths: E=4096, G=128, C=12 of 86 groups, bf16."""
    args, kw = _v1_inputs(N, 12, 4096, 128, 86, torch.bfloat16, cuda, seed=53)
    x, *rest = args
    fn, plain, rargs, extra = _row_calls(kernel, (x.bfloat16(), *rest), True)
    _check_fn(fn, plain, rargs, 1e-3, act="fatrelu", bu_sel=kw["bu_sel"], **extra)


@pytest.mark.cuda
def test_row_kernels_odd_widths_and_clamped_ids(cuda):
    """E not a multiple of the kernel's tiles, G not a multiple of 8; ids
    outside [0, R) clamped into the projection's own rows."""
    args, kw = _v1_inputs(2, 3, 1000, 12, 7, torch.bfloat16, cuda, seed=54)
    x, idx, *stores = args
    idx = idx.clone()
    idx[0, 0], idx[1, 2] = 9, -1
    for kernel in ("v2", "v3", "v4", "v5"):
        fn, plain, rargs, extra = _row_calls(kernel, (x, idx, *stores), True)
        _check_fn(fn, plain, rargs, 1e-3, act="silu", bu_sel=kw["bu_sel"], **extra)


@pytest.mark.cuda
def test_row_kernels_reject_bad_stores(cuda):
    (x, idx, gp, wu, wg, wd), _ = _v1_inputs(1, 2, 64, 16, 4, torch.bfloat16, cuda, seed=55)
    with pytest.raises(ValueError):  # swiglu_oai is not gated for v3
        sparse_ffn_block_v3(x, idx, gp, wu, wg, wd, act="swiglu_oai")
    with pytest.raises(ValueError):  # stores in two dtypes
        sparse_ffn_block_v5(x, idx, gp, wu, wg.float(), wd, act="fatrelu")
    with pytest.raises(ValueError):  # an interleaved store of 3 called ungated
        sparse_ffn_block_v4(x, idx, gp, interleave_rows(wu, wg, wd), act="relu", gated=False)
    with pytest.raises(ValueError):  # 2R rows called gated
        sparse_ffn_block_v2(x, idx, gp, torch.cat([wu, wd]), act="fatrelu", gated=True, R=4)
    with pytest.raises(ValueError):  # a strided view is no store
        sparse_ffn_block_v2(x, idx, gp, torch.cat([wu, wg, wd])[:, :, ::2], act="fatrelu",
                            gated=True, R=4)


@pytest.mark.cuda
def test_row_kernels_are_deterministic(cuda):
    args, kw = _v1_inputs(4, 12, 4096, 128, 64, torch.bfloat16, cuda, seed=56)
    for kernel in ("v2", "v4"):
        fn, _, rargs, extra = _row_calls(kernel, args, True)
        a = fn(*rargs, act="fatrelu", bu_sel=kw["bu_sel"], **extra)
        b = fn(*rargs, act="fatrelu", bu_sel=kw["bu_sel"], **extra)
        assert torch.equal(a, b)
