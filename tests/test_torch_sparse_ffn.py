"""The port's loader and sparse FFN against the JAX package's, on the CPU.

One tiny ProSparse GGUF (make_tiny_llama, pred_rank 8, n_ff 96) is loaded by
both packages. Tolerances, all in f32:
  - loaded params: exactly equal (same decoding, same layout);
  - predictor and masked-dense FFN: 1e-5 (same matmuls, other BLAS);
  - plain v6 and v6q against the JAX v6 and v6q kernels in interpret mode:
    rtol=atol=1e-5 (both sum in f32, in another order);
  - Q8_0 flat stores and predictor stacks: bit-equal to the JAX packers.
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
from sparkinfer_tpu.ops import quant_matmul as jqm  # noqa: E402
from sparkinfer_tpu.ops.sparse_ffn_pallas import (  # noqa: E402
    quantize_rows_q8_0 as jax_rows_q8,
)
from sparkinfer_tpu.ops.sparse_ffn_pallas import (  # noqa: E402
    sparse_ffn_block_v6 as jax_v6,
)
from sparkinfer_tpu.ops.sparse_ffn_pallas import (  # noqa: E402
    sparse_ffn_block_v6q as jax_v6q,
)
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse import predictor as jpred  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.ops.sparse_ffn import (  # noqa: E402
    sparse_ffn_block_v6,
    sparse_ffn_block_v6_plain,
    sparse_ffn_block_v6q,
    sparse_ffn_block_v6q_plain,
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
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP),
                                       layout="v6")
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
    # distinct scores
    scfg_j, scfg_t = JaxSparseConfig(G, CAP), SparseConfig(G, CAP)
    probs = np.random.default_rng(1).uniform(0, 1, (6, 96)).astype(np.float32)
    ref = np.asarray(jffn.select_groups(jnp.asarray(probs), scfg_j, 96))
    got = tffn.select_groups(torch.from_numpy(probs), scfg_t, 96)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_tied", [20, 86], ids=["20-of-86", "all"])
def test_select_groups_breaks_ties_as_jax(n_tied):
    """More than C groups tie on score (saturated probabilities): lax.top_k
    keeps the lower group id first, and so must the port (7B widths)."""
    probs = np.full((1, 11008), 0.2, np.float32)
    probs[:, :n_tied * 128] = 1.0
    ref = np.asarray(jffn.select_groups(jnp.asarray(probs), JaxSparseConfig(128, 12), 11008))
    got = tffn.select_groups(torch.from_numpy(probs), SparseConfig(128, 12), 11008)
    np.testing.assert_array_equal(ref, np.arange(12)[None])
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


_V6_CASES = list(itertools.product(["fatrelu", "drelu", "relu", "silu", "gelu"],
                                   ["threshold", "scale"], [True, False]))


# each case with f32 x (ids as act-mask-bias) and with x rounded to bf16
# (ids ending in -bf16), as the 7B main path passes it to the kernel
@pytest.mark.parametrize(
    "act,mask_mode,with_bu,x_bf16",
    [(*c, False) for c in _V6_CASES] + [(*c, True) for c in _V6_CASES],
    ids=[f"{a}-{m}-{b}" for a, m, b in _V6_CASES]
    + [f"{a}-{m}-{b}-bf16" for a, m, b in _V6_CASES])
def test_plain_v6_matches_jax_kernel(act, mask_mode, with_bu, x_bf16):
    x, idx, gp, wu, wg, wd, bu = _v6_inputs(3, with_bu)
    kw = dict(act=act, fatrelu_threshold=0.05, prob_threshold=0.5,
              mask_mode=mask_mode)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    jx, tx = j(x), t(x)
    if x_bf16:  # both round to nearest even
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    ref = np.asarray(jax_v6(jx, j(idx), j(gp), j(wu), j(wg), j(wd),
                            bu_sel=j(bu), **kw))
    got = sparse_ffn_block_v6_plain(tx, t(idx), t(gp), t(wu), t(wg), t(wd),
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


# ---------------------------------------------------------------------------
# Q8_0 stores (v6q) and predictor stacks


GQ = 32  # Q8_0 stores need G % 32 == 0


def _v6q_inputs(seed, with_bu):
    x, idx, gp, wu, wg, wd, bu = _v6_inputs(seed, with_bu)
    rng = np.random.default_rng(seed + 100)
    N, C = idx.shape
    R, E = wu.shape[0], x.shape[1]
    gp = rng.uniform(0, 1, (N, C, GQ)).astype(np.float32)
    bu = (rng.standard_normal((N, C, GQ)) * 0.1).astype(np.float32) if with_bu else None
    stores = []
    for shape, tr in (((R, E, GQ), True), ((R, E, GQ), True), ((R, GQ, E), False)):
        stores += list(jax_rows_q8((rng.standard_normal(shape) * 0.2).astype(np.float32),
                                   transposed=tr))
    return (x, idx, gp, *stores), bu


# each case with f32 x (ids as act-mask-bias) and with x rounded to bf16
# (ids ending in -bf16), as the 13B main path passes it to the kernel
_V6Q_CASES = list(itertools.product(["fatrelu", "drelu", "relu", "silu", "gelu"],
                                    ["threshold", "scale"], [True, False]))


@pytest.mark.parametrize(
    "act,mask_mode,with_bu,x_bf16",
    [(*c, False) for c in _V6Q_CASES] + [(*c, True) for c in _V6Q_CASES],
    ids=[f"{a}-{m}-{b}" for a, m, b in _V6Q_CASES]
    + [f"{a}-{m}-{b}-bf16" for a, m, b in _V6Q_CASES])
def test_plain_v6q_matches_jax_kernel(act, mask_mode, with_bu, x_bf16):
    args, bu = _v6q_inputs(6, with_bu)
    kw = dict(act=act, fatrelu_threshold=0.05, prob_threshold=0.5,
              mask_mode=mask_mode)
    jx, tx = jnp.asarray(args[0]), torch.from_numpy(args[0])
    if x_bf16:  # both round to nearest even
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    ref = np.asarray(jax_v6q(jx, *(jnp.asarray(a) for a in args[1:]),
                             bu_sel=None if bu is None else jnp.asarray(bu), **kw))
    got = sparse_ffn_block_v6q_plain(tx, *(torch.from_numpy(a) for a in args[1:]),
                                     bu_sel=None if bu is None else torch.from_numpy(bu),
                                     **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_v6q_on_cpu_runs_the_plain_version_uncounted():
    args, bu = _v6q_inputs(7, True)
    t = [torch.from_numpy(a) for a in args]
    bt = torch.from_numpy(bu)
    before = sparse_ffn_block_v6q.launches
    got = sparse_ffn_block_v6q(*t, act="fatrelu", bu_sel=bt)
    assert torch.equal(got, sparse_ffn_block_v6q_plain(*t, act="fatrelu", bu_sel=bt))
    assert sparse_ffn_block_v6q.launches == before
    with pytest.raises(ValueError):
        sparse_ffn_block_v6q(*t[:5], None, None, *t[7:], act="silu")


def _np_flat(flat):
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def q8_prepared(both):
    jm, tm = both
    kw = dict(drop_dense=True, quant="q8_0")
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, JaxSparseConfig(GQ, CAP),
                                       layout="v6", **kw)
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(GQ, CAP),
                                       layout="v6", **kw)
    return jm, tm, jp, tp


def test_prepare_pipelined_params_q8_matches_jax(q8_prepared):
    _, tm, jp, tp = q8_prepared
    ref = _np_flat(jp["sparse_flat"])
    assert sorted(tp["sparse_flat"]) == sorted(ref) == [
        "qw_down_flat", "qw_gateT_flat", "qw_upT_flat",
        "s_down_flat", "s_gateT_flat", "s_upT_flat"]
    for k, v in tp["sparse_flat"].items():
        assert v.dtype == (torch.int8 if k.startswith("qw") else torch.float32), k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    assert "w_up" not in tp["layers"] and "w_up" in tm.params["layers"]


@pytest.mark.parametrize("quant", [None, "q8_0"], ids=["bf16-layout", "q8_0"])
def test_masked_dense_ffn_from_flat_stores_matches_jax(both, quant):
    """Prefill with the dense weights dropped reads layer 1's flat stores."""
    jm, tm = both
    kw = dict(drop_dense=True, quant=quant)
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, JaxSparseConfig(GQ, CAP),
                                       layout="v6", **kw)
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(GQ, CAP),
                                       layout="v6", **kw)
    x = np.random.default_rng(8).standard_normal((1, 5, 64)).astype(np.float32)
    lj = {k: v[1] for k, v in jp["layers"].items()} | dict(jp["sparse_flat"], flat_il=1)
    lt = {k: v[1] for k, v in tp["layers"].items()} | dict(tp["sparse_flat"], flat_il=1)
    ref = np.asarray(jffn.make_sparse_ffn(jm.config, JaxSparseConfig(GQ, CAP))(
        lj, jnp.asarray(x)))
    got = tffn.make_sparse_ffn(tm.config, SparseConfig(GQ, CAP))(
        lt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_q8_predictor_stacks_match_jax(tmp_path):
    """resolve_predictor over FlatQuantTensor stacks (rank 32: Q8_0 blocks
    run along the rank for pred_down), for layer 1 of 2."""
    path = tmp_path / "tiny-rank32.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=32, n_ff=96, seed=5)
    jm = jax_load(str(path), dtype=jnp.float32)
    tm = load_model(str(path), dtype=torch.float32, device="cpu")
    lay_j, lay_t = jm.params["layers"], tm.params["layers"]
    fj = {"pred_up_qt": jqm.flat_quantize(np.asarray(lay_j["pred_up"])),
          "pred_down_qt": jqm.flat_quantize(np.asarray(lay_j["pred_down"])),
          "pred_up_b_all": lay_j["pred_up_b"], "pred_down_b_all": lay_j["pred_down_b"]}
    ft = {"pred_up_qt": tqm.flat_quantize(lay_t["pred_up"]),
          "pred_down_qt": tqm.flat_quantize(lay_t["pred_down"]),
          "pred_up_b_all": lay_t["pred_up_b"], "pred_down_b_all": lay_t["pred_down_b"]}
    for k in ("pred_up_qt", "pred_down_qt"):
        np.testing.assert_array_equal(ft[k].q.numpy(), np.asarray(fj[k].q))
    x = np.random.default_rng(9).standard_normal((5, 64)).astype(np.float32)
    ref = np.asarray(jpred.predict_activations(dict(fj, flat_il=1), jnp.asarray(x)))
    got = tpred.predict_activations(dict(ft, flat_il=1), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    pu, _, pd, _ = tpred.resolve_predictor(dict(ft, flat_il=0), 1)
    assert pu.il == pd.il == 1
