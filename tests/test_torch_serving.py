"""Batched sparse serving in the port against the JAX package, on the CPU.

Inputs come from numpy seeds at a small size (E=64, G=16, tiny GGUFs of
make_tiny_llama). Tolerances, all in f32 unless said:
  - plain v1 and v7u against the JAX kernels in interpret mode: 1e-5
    relative (f32 sums in another order); with bf16 stores the same, since
    both sides round the same f32 values to bf16 and no seed here puts a
    hidden value on a rounding boundary;
  - union ids, row stores and greedy tokens: exactly equal;
  - FFN outputs of the sparse modes against the JAX modes: 1e-5;
  - sampler masks: the same kept tokens, kept logits within 1e-5.
The Scheduler tests hold the port's Scheduler against the JAX Scheduler's
greedy streams (dense, sparse v1, dense fallback) and against the port's
own Engine, and port the JAX Scheduler's tests.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.ops.sparse_ffn_pallas import (  # noqa: E402
    sparse_ffn_block as jax_v1,
)
from sparkinfer_tpu.ops.sparse_ffn_pallas import (  # noqa: E402
    sparse_ffn_block_v7u as jax_v7u,
)
from sparkinfer_tpu.runtime import sampling as jsampling  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.ops.sparse_ffn import (  # noqa: E402
    sparse_ffn_block,
    sparse_ffn_block_plain,
    sparse_ffn_block_v7u,
    sparse_ffn_block_v7u_plain,
)
from sparkinfer_tpu_torch.runtime import sampling as tsampling  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache, slot_view  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import (  # noqa: E402
    SparseConfig,
    sparse_batch_crossover,
)

G, CAP = 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)
GREEDY = SamplerConfig(temp=0.0)
PROMPTS = [[3, 14, 15], [9, 26, 53, 58], [97, 93], [2, 71, 82, 81, 82]]


def _j(a, dt=None):
    return None if a is None else jnp.asarray(a, dt)


def _t(a, dt=None):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dt or torch.float32)


# ---------------------------------------------------------------------------
# v1 and v7u plain versions against the JAX kernels (interpret mode)


def _v1_inputs(seed, gated, bias):
    rng = np.random.default_rng(seed)
    N, C, E, R = 3, 4, 64, 10
    f = lambda *s, k=0.2: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    idx = np.stack([rng.choice(R, C, replace=False) for _ in range(N)]).astype(np.int32)
    idx[0, 0] = R + 3  # out of range: clamped, as XLA clamps a gather
    return dict(x=f(N, E, k=1.0), idx=idx, gp=rng.uniform(0, 1, (N, C, G)).astype(np.float32),
                wu=f(R, G, E), wg=f(R, G, E) if gated else None, wd=f(R, G, E),
                bu=f(N, C, G, k=0.1) if bias else None,
                bg=f(N, C, G, k=0.1) if bias and gated else None)


@pytest.mark.parametrize("act,mask_mode,bias,store", list(itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu", "swiglu_oai"], ["threshold", "scale"],
    [True, False], ["f32", "bf16", "bf16x_f32"])))
def test_plain_v1_matches_jax_kernel(act, mask_mode, bias, store):
    """store: the dtype of x and the stores; "bf16x_f32" is bf16 x over f32
    stores, which the row kernel reads as it is."""
    a = _v1_inputs(7, act != "relu", bias)
    dts = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
    (jx, tx), (jdt, tdt) = {"f32": (dts["f32"], dts["f32"]), "bf16": (dts["bf16"], dts["bf16"]),
                            "bf16x_f32": (dts["bf16"], dts["f32"])}[store]
    kw = dict(act=act, fatrelu_threshold=0.05, prob_threshold=0.5, mask_mode=mask_mode)
    ref = np.asarray(jax_v1(_j(a["x"], jx), _j(a["idx"]), _j(a["gp"]), _j(a["wu"], jdt),
                            _j(a["wg"], jdt), _j(a["wd"], jdt), bu_sel=_j(a["bu"]),
                            bg_sel=_j(a["bg"]), **kw))
    args = (_t(a["x"], tx), _t(a["idx"], torch.int32), _t(a["gp"]), _t(a["wu"], tdt),
            _t(a["wg"], tdt), _t(a["wd"], tdt))
    got = sparse_ffn_block_plain(*args, bu_sel=_t(a["bu"]), bg_sel=_t(a["bg"]), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    before = sparse_ffn_block.launches
    assert torch.equal(sparse_ffn_block(*args, bu_sel=_t(a["bu"]), bg_sel=_t(a["bg"]), **kw),
                       got)
    assert sparse_ffn_block.launches == before  # CPU: the plain version, uncounted


def _v7u_inputs(seed, gated, bias):
    rng = np.random.default_rng(seed)
    B, Cu, E, R = 4, 5, 64, 9
    f = lambda *s, k=0.2: (rng.standard_normal(s) * k).astype(np.float32)  # noqa: E731
    sel = rng.uniform(0, 1, (B, Cu, 1)) < 0.6
    return dict(x=f(B, E, k=1.0), union=rng.choice(R, Cu, replace=False).astype(np.int32),
                gp=(rng.uniform(0, 1, (B, Cu, G)) * sel).astype(np.float32),
                wu=f(R, E, G), wg=f(R, E, G) if gated else None, wd=f(R, G, E),
                bu=f(B, Cu, G, k=0.1) if bias else None)


_V7U_CASES = ([(act, mm, True, "f32", "f32") for act, mm in itertools.product(
    ["fatrelu", "drelu", "relu", "silu", "gelu"], ["threshold", "scale"])]
    + [("fatrelu", "threshold", False, xd, sd) for xd, sd in
       (("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16"))])


@pytest.mark.parametrize("act,mask_mode,bias,xdt,store", _V7U_CASES)
def test_plain_v7u_matches_jax_kernel(act, mask_mode, bias, xdt, store):
    a = _v7u_inputs(8, act != "relu", bias)
    dts = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
    (jx, tx), (jw, tw) = dts[xdt], dts[store]
    kw = dict(act=act, fatrelu_threshold=0.05, prob_threshold=0.5, mask_mode=mask_mode)
    ref = np.asarray(jax_v7u(_j(a["x"], jx), _j(a["union"]), _j(a["gp"]), _j(a["wu"], jw),
                             _j(a["wg"], jw), _j(a["wd"], jw), bu_u=_j(a["bu"]), **kw))
    args = (_t(a["x"], tx), _t(a["union"], torch.int32), _t(a["gp"]), _t(a["wu"], tw),
            _t(a["wg"], tw), _t(a["wd"], tw))
    got = sparse_ffn_block_v7u_plain(*args, bu_u=_t(a["bu"]), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    before = sparse_ffn_block_v7u.launches
    assert torch.equal(sparse_ffn_block_v7u(*args, bu_u=_t(a["bu"]), **kw), got)
    assert sparse_ffn_block_v7u.launches == before


def test_kernels_reject_what_they_lack():
    a = _v1_inputs(9, True, False)
    args = [_t(a[k]) for k in ("x", "idx", "gp", "wu", "wg", "wd")]
    with pytest.raises(ValueError):  # gated activation without a gate store
        sparse_ffn_block(*args[:4], None, args[5], act="swiglu_oai")
    with pytest.raises(ValueError):
        sparse_ffn_block(*args, act="geglu")
    b = _v7u_inputs(9, True, False)
    args = [_t(b[k]) for k in ("x", "union", "gp", "wu", "wg", "wd")]
    with pytest.raises(ValueError):  # swiglu_oai is v1's alone
        sparse_ffn_block_v7u(*args, act="swiglu_oai")


# ---------------------------------------------------------------------------
# row stores, the union and the sparse FFN modes


@pytest.fixture(scope="module")
def sparse_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return str(path)


@pytest.fixture(scope="module")
def both(sparse_gguf):
    return (jax_load(sparse_gguf, dtype=jnp.float32),
            load_model(sparse_gguf, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("drop_dense", [False, True])
def test_prepare_sparse_params_matches_jax(both, drop_dense):
    jm, tm = both
    jp = jffn.prepare_sparse_params(jm.params, jm.config, JaxSparseConfig(G, CAP),
                                    drop_dense=drop_dense)
    tp = tffn.prepare_sparse_params(tm.params, tm.config, SparseConfig(G, CAP),
                                    drop_dense=drop_dense)
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    for k, v in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), np.asarray(v), err_msg=k)
    assert ("w_up" in tp["layers"]) != drop_dense and "w_up" in tm.params["layers"]
    # the down store is a view of the dense weight, the others are copies
    assert tp["layers"]["w_down_rows"].data_ptr() == tm.params["layers"]["w_down"].data_ptr()


@pytest.mark.parametrize("B,C,ng,Cu", [(4, 3, 10, 10), (4, 3, 10, 4), (6, 2, 8, 3),
                                       (1, 4, 6, 4)])
def test_union_from_selection_bit_equal(B, C, ng, Cu):
    """Counts tie often at these sizes; a truncated Cu keeps the lower
    group ids among equal counts, as lax.top_k does."""
    rng = np.random.default_rng(B * 100 + Cu)
    idx = np.stack([rng.choice(ng, C, replace=False) for _ in range(B)]).astype(np.int32)
    gp = rng.uniform(0, 1, (B, C, G)).astype(np.float32)
    ju, jg = jffn.union_from_selection(jnp.asarray(idx), jnp.asarray(gp), ng, Cu)
    tu, tg = tffn.union_from_selection(torch.from_numpy(idx), torch.from_numpy(gp), ng, Cu)
    assert tu.dtype == torch.int32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def _layer(params, il, flat=None):
    lp = {k: v[il] for k, v in params["layers"].items()}
    return lp | dict(flat, flat_il=il) if flat is not None else lp


@pytest.mark.parametrize("modes,drop_dense", [(("gather", "gather"), False),
                                              (("kernel", "pallas"), False),
                                              (("dense", "dense"), True)])
def test_sparse_ffn_modes_match_jax(both, modes, drop_dense):
    """The per-token modes over the row stores, and the masked-dense FFN
    reading the row stores once the dense weights are dropped."""
    jm, tm = both
    tmode, jmode = modes
    jp = jffn.prepare_sparse_params(jm.params, jm.config, JaxSparseConfig(G, CAP),
                                    drop_dense=drop_dense)
    tp = tffn.prepare_sparse_params(tm.params, tm.config, SparseConfig(G, CAP),
                                    drop_dense=drop_dense)
    x = np.random.default_rng(10).standard_normal((2, 3, 64)).astype(np.float32)
    ref = np.asarray(jffn.make_sparse_ffn(jm.config, JaxSparseConfig(G, CAP), mode=jmode)(
        _layer(jp, 1), jnp.asarray(x)))
    got = tffn.make_sparse_ffn(tm.config, SparseConfig(G, CAP), mode=tmode)(
        _layer(tp, 1), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("union_groups", [6, 3], ids=["full", "truncated"])
@pytest.mark.parametrize("modes", [("gather_union", "gather_union"),
                                   ("kernel_union", "pallas_union")])
def test_union_modes_match_jax(both, modes, union_groups):
    """At a matched selection (the carry), layer 1 of the batched pipelined
    FFN, each union group read once for the 6 tokens."""
    jm, tm = both
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, JaxSparseConfig(G, CAP),
                                       layout="v6")
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP),
                                       layout="v6")
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 3, 64)) * 0.5).astype(np.float32)
    idx = np.stack([rng.choice(6, CAP, replace=False) for _ in range(6)]).astype(np.int32)
    gp = rng.uniform(0, 1, (6, CAP, G)).astype(np.float32)
    jffn_fn, _ = jffn.make_pipelined_sparse_ffn(jm.config, JaxSparseConfig(G, CAP),
                                                mode=modes[1], union_groups=union_groups)
    tffn_fn, _ = tffn.make_pipelined_sparse_ffn(tm.config, SparseConfig(G, CAP),
                                                mode=modes[0], union_groups=union_groups)
    ref, jcarry = jffn_fn(_layer(jp, 1, jp["sparse_flat"]), jnp.asarray(x),
                          {"idx": jnp.asarray(idx), "gp_sel": jnp.asarray(gp)}, jnp.int32(1))
    got, tcarry = tffn_fn(_layer(tp, 1, tp["sparse_flat"]), torch.from_numpy(x),
                          {"idx": torch.from_numpy(idx), "gp_sel": torch.from_numpy(gp)}, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tcarry["idx"].numpy(), np.asarray(jcarry["idx"]))


@pytest.mark.parametrize("union_groups", [12, 3], ids=["full", "truncated"])
def test_gather_union_over_row_stores_matches_jax(tmp_path, union_groups):
    """"gather_union" over the v1 layout's row stores (no flat stores), as
    the JAX package's bench batch path runs it; "kernel_union" still needs
    the flat stores."""
    path = tmp_path / "tiny-rank16.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=16, n_ff=96, seed=5)
    jm, tm = jax_load(str(path), dtype=jnp.float32), load_model(str(path), dtype=torch.float32,
                                                              device="cpu")
    jscfg, tscfg = JaxSparseConfig(8, 4), SparseConfig(8, 4)
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, jscfg, layout="v1")
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, tscfg, layout="v1")
    assert "sparse_flat" not in tp and "w_up_rows" in tp["layers"]
    x = (np.random.default_rng(13).standard_normal((2, 1, 64)) * 0.5).astype(np.float32)
    jf, jinit = jffn.make_pipelined_sparse_ffn(jm.config, jscfg, mode="gather_union",
                                               union_groups=union_groups)
    tf, tinit = tffn.make_pipelined_sparse_ffn(tm.config, tscfg, mode="gather_union",
                                               union_groups=union_groups)
    for il in (0, 1):
        ref, jc = jf(_layer(jp, il), jnp.asarray(x), jinit(2, 1), jnp.int32(il))
        got, tc = tf(_layer(tp, il), torch.from_numpy(x), tinit(2, 1, "cpu"), il)
        assert np.isfinite(np.asarray(ref)).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    kf, _ = tffn.make_pipelined_sparse_ffn(tm.config, tscfg, mode="kernel_union")
    with pytest.raises(ValueError, match="flat stores"):
        kf(_layer(tp, 0), torch.from_numpy(x), tinit(2, 1, "cpu"), 0)


def test_union_full_equals_per_token(both):
    """With the union covering every selected group, the union FFN equals
    the per-token FFN (gather_union keeps f32: 1e-5)."""
    _, tm = both
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP),
                                       layout="v6")
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.standard_normal((1, 5, 64)) * 0.5).astype(np.float32))
    carry = {"idx": torch.from_numpy(np.stack([rng.choice(6, CAP, replace=False)
                                               for _ in range(5)]).astype(np.int32)),
             "gp_sel": torch.from_numpy(rng.uniform(0, 1, (5, CAP, G)).astype(np.float32))}
    lp = _layer(tp, 1, tp["sparse_flat"])
    outs = [tffn.make_pipelined_sparse_ffn(tm.config, SparseConfig(G, CAP), mode=m,
                                           union_groups=6)[0](lp, x, carry, 1)[0]
            for m in ("gather", "gather_union")]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), **TOL)


# ---------------------------------------------------------------------------
# the per-slot dynamic sampler


_SLOT_KNOBS = [
    dict(temp=0.0),
    dict(temp=0.7, top_k=5, top_p=1.0, min_p=0.0),
    dict(temp=1.0, top_k=0, top_p=0.6, min_p=0.0, penalty_repeat=1.3),
    dict(temp=0.9, top_k=0, top_p=1.0, min_p=0.2, typical_p=0.5),
    dict(temp=1.2, top_k=40, top_p=0.9, min_p=0.05, penalty_freq=0.5, penalty_present=0.3,
         xtc_probability=1.0, xtc_threshold=0.01),
    dict(temp=0.0, penalty_repeat=1.5, penalty_present=2.0),
]


def _jax_chain(logits, recent, knobs):
    """The JAX dynamic chain's scaled logits and its greedy token, caught at
    its draw (jax.random.categorical) for one row."""
    seen = {}

    def catch(key, lf, *a, **k):
        seen["lf"] = np.asarray(lf)
        return jnp.int32(0)

    cfg = jsampling.SamplerConfig(**knobs)
    st = jsampling.init_state(cfg, 0)._replace(recent=jnp.asarray(recent))
    orig = jax.random.categorical
    jax.random.categorical = catch
    try:
        tok, _ = jsampling.make_dynamic_sampler(cfg)(jnp.asarray(logits), st,
                                                     jsampling.dynamic_params(cfg))
    finally:
        jax.random.categorical = orig
    return seen["lf"], int(tok)


def test_dynamic_sampler_masks_match_jax():
    rng = np.random.default_rng(13)
    V, n = 50, 64
    logits = (rng.standard_normal((len(_SLOT_KNOBS), V)) * 3).astype(np.float32)
    recent = np.full((len(_SLOT_KNOBS), n), -1, np.int32)
    recent[:, :6] = rng.integers(0, V, (len(_SLOT_KNOBS), 6))
    cfgs = [SamplerConfig(**k) for k in _SLOT_KNOBS]
    dp = tsampling.stack_params([tsampling.dynamic_params(c) for c in cfgs])
    # xtc draws u in [0, 1): probability 1.0 always applies, as in JAX
    scaled, greedy = tsampling.dynamic_logits(
        torch.from_numpy(logits), torch.from_numpy(recent).long(), dp, 0.01,
        xtc_u=torch.zeros(len(cfgs)))
    for b, knobs in enumerate(_SLOT_KNOBS):
        ref_lf, ref_tok = _jax_chain(logits[b], recent[b], knobs | {"xtc_threshold": 0.01})
        if knobs["temp"] <= 0:
            assert int(greedy[b]) == ref_tok, b
            continue
        got = scaled[b].numpy()
        kept = got > -1e29
        np.testing.assert_array_equal(kept, ref_lf > -1e29, err_msg=str(b))
        np.testing.assert_allclose(got[kept], ref_lf[kept], **TOL)


def test_dynamic_sampler_draws_and_rings():
    """Draws only from the kept tokens, per-slot generators (seeded
    streams repeat), greedy rows take the penalized argmax, rings fill."""
    V = 30
    logits = torch.from_numpy(np.random.default_rng(14).standard_normal((3, V)).astype(
        np.float32) * 2)
    cfgs = [SamplerConfig(temp=0.0), SamplerConfig(temp=1.0, top_k=3),
            SamplerConfig(temp=0.0, penalty_repeat=100.0)]
    dp = tsampling.stack_params([tsampling.dynamic_params(c) for c in cfgs])
    sample = tsampling.make_dynamic_sampler(SamplerConfig(penalty_last_n=4))

    def run(seed):
        sts = [tsampling.init_state(SamplerConfig(penalty_last_n=4), seed + i)
               for i in range(3)]
        return [sample(logits, sts, dp).tolist() for _ in range(6)], sts

    toks, sts = run(1)
    assert toks == run(1)[0]
    top3 = set(torch.topk(logits[1], 3).indices.tolist())
    assert all(t[1] in top3 for t in toks) and all(t[0] == toks[0][0] for t in toks)
    # row 2 penalizes its own history: it never repeats a token within 4 steps
    row2 = [t[2] for t in toks]
    assert len(set(row2[:4])) == 4
    assert sts[2].recent.tolist() == row2[4:] + row2[2:4] and sts[2].recent_pos == 6
    with pytest.raises(NotImplementedError):
        tsampling.make_dynamic_sampler(SamplerConfig(mirostat=2))


# ---------------------------------------------------------------------------
# the Scheduler


@pytest.fixture(scope="module")
def llama_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny.gguf"
    make_tiny_llama(path)
    return str(path)


def _port_model(path):
    return load_model(path, dtype=torch.float32, device="cpu")


def _sched(path, n_slots=2, **kw):
    kw = dict(max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cpu") | kw
    return Scheduler(_port_model(path), n_slots=n_slots, **kw)


def _serve(sched, prompts, n_new=6, **kw):
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new, **kw)) for p in prompts]
    sched.run_until_idle()
    return [r.tokens() for r in reqs]


def _jax_serve(path, sparse=None, **kw):
    from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler

    sched = JaxScheduler(jax_load(path, dtype=jnp.float32), n_slots=2, max_seq=64,
                         sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                         sparse=sparse, **kw)
    reqs = [sched.submit(JaxRequest(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS]
    sched.run_until_idle()
    return [r.tokens() for r in reqs]


@pytest.mark.parametrize("kind", ["dense", "sparse_v1", "dense_fallback"])
def test_scheduler_matches_jax_scheduler(llama_gguf, sparse_gguf, kind):
    """4 prompts on 2 slots, greedy: equal token streams. sparse_v1 decodes
    every tick through v1 (its plain version here); dense_fallback takes
    the masked-dense step at every tick (sparse_batch_max=0)."""
    if kind == "dense":
        path, kw, jkw = llama_gguf, {}, {}
    else:
        bmax = 100 if kind == "sparse_v1" else 0
        path = sparse_gguf
        kw = dict(sparse=SparseConfig(G, CAP), sparse_batch_max=bmax)
        jkw = dict(sparse=JaxSparseConfig(G, CAP), sparse_batch_max=bmax)
    sched = _sched(path, **kw)
    got = _serve(sched, PROMPTS)
    assert got == _jax_serve(path, **jkw)
    assert all(len(t) == 6 for t in got)
    m = sched.metrics_snapshot()
    assert m["n_dense_steps"] == (m["n_decode_steps"] if kind == "dense_fallback" else 0)


def test_batched_matches_isolated_greedy(llama_gguf):
    eng = Engine(_port_model(llama_gguf), max_seq=64, sampler=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    want = [eng.generate(p, max_new_tokens=6) for p in PROMPTS]
    sched = _sched(llama_gguf)
    assert _serve(sched, PROMPTS) == want
    m = sched.metrics_snapshot()
    assert m["n_requests"] == 4 and m["queue_peak"] >= 2 and m["slots_running"] == 0


def test_idle_slot_keeps_the_cached_prefix(llama_gguf):
    """An idle slot's dummy step must not write into the prefix the slot
    keeps for reuse. A (2 tokens) ends while B runs on, so A's slot idles;
    C extends A's prompt and reuses its 5 cached tokens. The JAX Scheduler
    writes its idle slots at position 0 and gives C [0, 27, 2, 0, 20, 13];
    the isolated stream is [27, 150, 27, 64, 61, 131]."""
    A = [3, 14, 15, 92, 65]
    C = A + [35, 89]
    eng = Engine(_port_model(llama_gguf), max_seq=64, sampler=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    sched = _sched(llama_gguf)
    ra = sched.submit(Request(prompt_tokens=A, max_new_tokens=2))
    rb = sched.submit(Request(prompt_tokens=[9, 26, 53], max_new_tokens=12))
    sched.run_until_idle()
    assert ra.tokens() == eng.generate(A, 2) and len(rb.tokens()) == 12
    rc = sched.submit(Request(prompt_tokens=C, max_new_tokens=6))
    sched.run_until_idle()
    assert sched.metrics["n_prompt_cached"] == 5
    assert rc.tokens() == eng.generate(C, 6) == [27, 150, 27, 64, 61, 131]


def test_prompt_prefix_reuse_and_slot_similarity(llama_gguf):
    """A prompt that extends a slot's cached prompt is routed to that slot
    (slot_similarity) and prefills only its new tokens."""
    eng = Engine(_port_model(llama_gguf), max_seq=64, sampler=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    p1, p2 = [3, 14, 15], [3, 14, 15, 99, 42]
    sched = _sched(llama_gguf, slot_similarity=0.5)
    assert _serve(sched, [[50, 51], p1], 4) == [eng.generate(p, 4) for p in ([50, 51], p1)]
    assert sched.slots[1].cached_tokens[:3] == p1
    assert _serve(sched, [p2], 4) == [eng.generate(p2, 4)]  # slot 1, not the first free
    assert sched.metrics["n_prompt_cached"] == 3 and sched.metrics["n_prompt_tokens"] == 7
    assert sched.slots[1].cached_tokens[:5] == p2


def test_background_loop_and_streaming(llama_gguf):
    sched = _sched(llama_gguf)
    sched.start()
    try:
        req = sched.submit(Request(prompt_tokens=[5, 6, 7], max_new_tokens=5))
        assert len(list(req.stream())) == 5
        assert req.first_token_s is not None and req.done_s is not None
    finally:
        sched.stop()


def test_oversize_and_empty_prompts_rejected(llama_gguf):
    sched = _sched(llama_gguf, n_slots=1, max_seq=16)
    with pytest.raises(ValueError):
        sched.submit(Request(prompt_tokens=[]))
    with pytest.raises(ValueError):
        sched.submit(Request(prompt_tokens=list(range(99))))


def test_max_seq_ends_generation(llama_gguf):
    sched = _sched(llama_gguf, n_slots=1, max_seq=8)
    (toks,) = _serve(sched, [[1, 2, 3, 4, 5]], n_new=20)
    assert len(toks) == 3  # the prefill's token, then positions 5 and 6


def test_stop_ids_end_generation(llama_gguf):
    eng = Engine(_port_model(llama_gguf), max_seq=64, sampler=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    full = eng.generate([3, 14, 15], max_new_tokens=8)
    sched = _sched(llama_gguf, n_slots=1)
    assert _serve(sched, [[3, 14, 15]], 8, stop_ids={full[3]}) == [full[:3]]


class _FakeTok:
    """Token -> '<id>' pieces; enough for the stop-string logic."""

    def decode(self, ids, skip_special=False):
        return "".join(f"<{t}>" for t in ids)


@pytest.mark.parametrize("kind", ["holdback", "flush"])
def test_stop_strings(llama_gguf, kind):
    """A stop string across generated tokens 3 and 4 is never partially
    streamed; a partial match that never completes is flushed."""
    eng = Engine(_port_model(llama_gguf), max_seq=64, sampler=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    full = eng.generate([3, 14, 15], max_new_tokens=6)
    stop = f"<{full[2]}><{full[3]}>" if kind == "holdback" else f"<{full[2]}>NOPE"
    sched = _sched(llama_gguf, n_slots=1, tokenizer=_FakeTok())
    (got,) = _serve(sched, [[3, 14, 15]], 6, stop_strings=[stop])
    assert got == (full[:2] if kind == "holdback" else full)


def test_admit_isolates_errors(llama_gguf, monkeypatch):
    """A failing prefill fails its request only; the loop keeps serving."""
    sched = _sched(llama_gguf, n_slots=1)
    original = sched._prefill_into_slot
    calls = {"n": 0}

    def flaky(s_i, req):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected fault")
        return original(s_i, req)

    monkeypatch.setattr(sched, "_prefill_into_slot", flaky)
    sched.start()
    try:
        bad = sched.submit(Request(prompt_tokens=[1, 2], max_new_tokens=3))
        assert bad.tokens() == []
        good = sched.submit(Request(prompt_tokens=[1, 2], max_new_tokens=3))
        assert len(good.tokens()) == 3
        assert sched.metrics["n_errors"] == 1
    finally:
        sched.stop()


def test_per_request_sampler_configs(llama_gguf):
    """A greedy request beside a hot one, under a hot server default,
    decodes exactly as the greedy Engine; the hot one is seeded."""
    hot = SamplerConfig(temp=1.5, top_k=0, seed=7)
    eng = Engine(_port_model(llama_gguf), max_seq=64, sampler=GREEDY,
                 kv_dtype=torch.float32, device="cpu")
    want = eng.generate([3, 14, 15], max_new_tokens=8)
    outs = []
    for _ in range(2):
        sched = _sched(llama_gguf, sampler=hot)
        r_hot = sched.submit(Request(prompt_tokens=[9, 26, 53], max_new_tokens=8,
                                     sampler=hot, seed=11))
        r_greedy = sched.submit(Request(prompt_tokens=[3, 14, 15], max_new_tokens=8,
                                        sampler=GREEDY))
        sched.run_until_idle()
        assert r_greedy.tokens() == want
        outs.append(r_hot.tokens())
    assert outs[0] == outs[1] and len(outs[0]) == 8


def test_sparse_batch_crossover(monkeypatch, sparse_gguf):
    monkeypatch.setenv("SPIF_SPARSE_BATCH_MAX", "2")
    assert sparse_batch_crossover(2048) == 2
    monkeypatch.delenv("SPIF_SPARSE_BATCH_MAX")
    assert sparse_batch_crossover(96) == sparse_batch_crossover(11008) >= 0
    assert 0 <= sparse_batch_crossover(32768) <= sparse_batch_crossover(11008)
    sched = _sched(sparse_gguf, sparse=SparseConfig(G, CAP))
    assert sched.sparse_batch_max == sparse_batch_crossover(96)


@pytest.mark.parametrize("crossover, n_slots", [(2, 2), (1, 2)], ids=["v1", "dense"])
def test_default_crossover_is_keyed_on_n_slots(monkeypatch, sparse_gguf, crossover, n_slots):
    """Without sparse_batch_max the Scheduler compares the crossover with
    its n_slots, the rows every tick computes, not with the slots that are
    live: with more slots than the crossover every tick is masked-dense,
    one live slot included (the last request runs alone)."""
    monkeypatch.setenv("SPIF_SPARSE_BATCH_MAX", str(crossover))
    sched = _sched(sparse_gguf, n_slots=n_slots, sparse=SparseConfig(G, CAP))
    assert sched.sparse_batch_max == (crossover if n_slots <= crossover else 0)
    assert all(len(t) == 6 for t in _serve(sched, PROMPTS[:3]))
    m = sched.metrics_snapshot()
    assert m["n_decode_steps"] > 0
    assert m["n_dense_steps"] == (0 if n_slots <= crossover else m["n_decode_steps"])


def test_slot_view_writes_in_place(llama_gguf):
    cache = init_cache(_port_model(llama_gguf).config, 3, 8, torch.float32, "cpu")
    view = slot_view(cache, 1)
    view.k[0, 0, 2] = 1.0
    assert cache.k[0, 1, 2].eq(1.0).all() and cache.k[0, 0].eq(0).all()
    assert view.k.shape == (cache.k.shape[0], 1) + cache.k.shape[2:]


def test_unported_options_raise(llama_gguf, sparse_gguf):
    # the int8 and split KV caches are ported (tests/test_torch_kvq.py)
    assert _sched(llama_gguf, kv_quantized=True).cache.k_scale.dtype == torch.float32
    assert _sched(llama_gguf, kv_dtype_v=torch.bfloat16).cache.v.dtype == torch.bfloat16
    sched = _sched(llama_gguf)
    # grammars are ported (tests/test_torch_grammar.py); one needs the tokenizer
    with pytest.raises(ValueError, match="tokenizer"):
        sched.submit(Request(prompt_tokens=[1, 2], grammar='root ::= "a"'))
    # slot files are ported (tests/test_torch_state_io.py): a missing file raises
    with pytest.raises(OSError):
        sched.restore_slot(0, "no-such-slot.state")
    with pytest.raises(NotImplementedError):  # the per-slot chain has no mirostat
        _sched(llama_gguf, sampler=SamplerConfig(mirostat=2))
    # the Engine's static chain has the penalties (tests/test_torch_sampling_chain.py)
    Engine(_port_model(llama_gguf), sampler=SamplerConfig(penalty_repeat=1.1), device="cpu")


# ---------------------------------------------------------------------------
# Engine(sparse_pipelined=False)


@pytest.mark.parametrize("modes", [("kernel", "pallas"), ("gather", "gather")])
def test_non_pipelined_engine_matches_jax(sparse_gguf, modes):
    from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler

    je = JaxEngine(jax_load(sparse_gguf, dtype=jnp.float32), max_seq=64,
                   sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                   sparse=JaxSparseConfig(G, CAP), sparse_decode_mode=modes[1],
                   sparse_pipelined=False)
    pe = Engine(_port_model(sparse_gguf), max_seq=64, sampler=GREEDY,
                kv_dtype=torch.float32, sparse=SparseConfig(G, CAP),
                sparse_decode_mode=modes[0], sparse_pipelined=False, device="cpu")
    assert "w_up_rows" in pe.params["layers"] and "sparse_flat" not in pe.params
    assert pe.generate([5, 9, 42], 8) == je.generate([5, 9, 42], 8)
