"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`; each test skips where torch sees no CUDA device. Run them on
a machine with a card (no JAX needed there, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: kernel and plain version both sum in f32, in another order
(over E for up/gate and over C*G for down), so they agree to a relative
1e-3 of the output's scale for bf16 stores and 1e-5 for f32 stores.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparkinfer_tpu_torch.ops.sparse_ffn import (  # noqa: E402
    sparse_ffn_block_v6,
    sparse_ffn_block_v6_plain,
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
