"""The port's loader and sparse FFN against the JAX package's, on the CPU.

One tiny ProSparse GGUF (make_tiny_llama, pred_rank 8, n_ff 96) is loaded by
both packages. Tolerances, all in f32:
  - loaded params: exactly equal (same decoding, same layout);
  - predictor and masked-dense FFN: 1e-5 (same matmuls, other BLAS);
  - plain v6 against the JAX v6 kernel in interpret mode: rtol=atol=1e-5
    (both sum in f32, in another order).
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.ops.sparse_ffn_pallas import (  # noqa: E402
    sparse_ffn_block_v6 as jax_v6,
)
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse import predictor as jpred  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.ops.sparse_ffn import (  # noqa: E402
    sparse_ffn_block_v6,
    sparse_ffn_block_v6_plain,
)
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse import predictor as tpred  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

G, CAP = 16, 4


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    jm = jax_load(str(path), dtype=jnp.float32)
    tm = load_model(str(path), dtype=torch.float32, device="cpu")
    return jm, tm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_same_params(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_same_params(got[k], ref[k])
            continue
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_loader_matches_jax(both):
    jm, tm = both
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    _assert_same_params(tm.params, _np(jm.params))
    _assert_same_params(params_from_numpy(_np(jm.params), "cpu"), _np(jm.params))


def test_params_from_numpy_casts_bf16():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    jb = np.asarray(jnp.asarray(a, jnp.bfloat16))
    out = params_from_numpy({"w": jb, "sub": {"b": a}}, "cpu")
    assert out["w"].dtype == torch.bfloat16 and out["sub"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(out["w"].float().numpy(), a)
    assert params_from_numpy({"b": a}, "cpu", torch.bfloat16)["b"].dtype == torch.bfloat16


def test_prepare_pipelined_params_matches_jax(both):
    jm, tm = both
    cfg = jm.config
    jp = jffn.prepare_pipelined_params(jm.params, cfg, JaxSparseConfig(G, CAP),
                                       layout="v6")
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP))
    _assert_same_params(tp, _np(jp))
    assert tp["sparse_flat"]["w_down_flat"].data_ptr() == tm.params["layers"]["w_down"].data_ptr()


def test_predictor_matches_jax(both):
    jm, tm = both
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    lj = {k: v[1] for k, v in jm.params["layers"].items()}
    lt = {k: v[1] for k, v in tm.params["layers"].items()}
    ref = np.asarray(jpred.predict_activations(lj, jnp.asarray(x)))
    got = tpred.predict_activations(lt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_select_groups_matches_jax():
    # distinct scores: lax.top_k and torch.topk may order exact ties differently
    scfg_j, scfg_t = JaxSparseConfig(G, CAP), SparseConfig(G, CAP)
    probs = np.random.default_rng(1).uniform(0, 1, (6, 96)).astype(np.float32)
    ref = np.asarray(jffn.select_groups(jnp.asarray(probs), scfg_j, 96))
    got = tffn.select_groups(torch.from_numpy(probs), scfg_t, 96)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_masked_dense_ffn_matches_jax(both):
    jm, tm = both
    x = np.random.default_rng(2).standard_normal((1, 5, 64)).astype(np.float32)
    lj = {k: v[0] for k, v in jm.params["layers"].items()}
    lt = {k: v[0] for k, v in tm.params["layers"].items()}
    ref = np.asarray(jffn.make_sparse_ffn(jm.config, JaxSparseConfig(G, CAP))(
        lj, jnp.asarray(x)))
    got = tffn.make_sparse_ffn(tm.config, SparseConfig(G, CAP))(
        lt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _v6_inputs(seed, with_bu):
    rng = np.random.default_rng(seed)
    N, C, E, R = 3, 4, 64, 12
    x = rng.standard_normal((N, E)).astype(np.float32)
    idx = np.stack([rng.choice(R, C, replace=False) for _ in range(N)]).astype(np.int32)
    gp = rng.uniform(0, 1, (N, C, G)).astype(np.float32)
    wu = (rng.standard_normal((R, E, G)) * 0.2).astype(np.float32)
    wg = (rng.standard_normal((R, E, G)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((R, G, E)) * 0.2).astype(np.float32)
    bu = (rng.standard_normal((N, C, G)) * 0.1).astype(np.float32) if with_bu else None
    return x, idx, gp, wu, wg, wd, bu


@pytest.mark.parametrize("act,mask_mode,with_bu", list(itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu"], ["threshold", "scale"],
    [True, False])))
def test_plain_v6_matches_jax_kernel(act, mask_mode, with_bu):
    x, idx, gp, wu, wg, wd, bu = _v6_inputs(3, with_bu)
    kw = dict(act=act, fatrelu_threshold=0.05, prob_threshold=0.5,
              mask_mode=mask_mode)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    ref = np.asarray(jax_v6(j(x), j(idx), j(gp), j(wu), j(wg), j(wd),
                            bu_sel=j(bu), **kw))
    got = sparse_ffn_block_v6_plain(t(x), t(idx), t(gp), t(wu), t(wg), t(wd),
                                    bu_sel=t(bu), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_v6_on_cpu_runs_the_plain_version_uncounted():
    x, idx, gp, wu, wg, wd, bu = (torch.from_numpy(a) for a in _v6_inputs(4, True))
    before = sparse_ffn_block_v6.launches
    got = sparse_ffn_block_v6(x, idx, gp, wu, wg, wd, act="fatrelu", bu_sel=bu)
    ref = sparse_ffn_block_v6_plain(x, idx, gp, wu, wg, wd, act="fatrelu", bu_sel=bu)
    assert torch.equal(got, ref)
    assert sparse_ffn_block_v6.launches == before


def test_v6_rejects_activations_the_kernel_lacks():
    x, idx, gp, wu, wg, wd, _ = (None if a is None else torch.from_numpy(a)
                                 for a in _v6_inputs(5, False))
    with pytest.raises(ValueError):
        sparse_ffn_block_v6(x, idx, gp, wu, wg, wd, act="swiglu_oai")
    with pytest.raises(ValueError):
        sparse_ffn_block_v6(x, idx, gp, wu, None, wd, act="fatrelu")
