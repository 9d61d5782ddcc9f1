"""Hot/cold neuron tiering and online balancing in the port
(sparkinfer_tpu_torch/sparse/tiering.py, balancer.py, native.py) against
the JAX package's, on the CPU, in f32, on one tiny ProSparse GGUF of
tests/model_fixtures.py (2 layers, n_ff 96, groups of 16, capacity 4).

Tolerances (f32): the host complement (the port's g++ build of its copy of
the C++, and its plain torch version) within 1e-5 of the JAX ColdStore's
scale, f32 and f16 stores; the hot stores, Q8_0 bytes and scales, reload
plans, hot_ids and group maps bit-equal; tiered forwards' logits within
1e-5 of their scale, miss and miss_g equal, the DFR within 1e-6 (one f32
rounding of its update, which XLA may fuse); greedy token streams of the
Engine and the Scheduler equal in host, drop and fetch modes. The JAX
Scheduler runs with synchronous ticks (SPARK_SCHED_PIPELINE=0): its
one-tick-late readback steps a finished slot once more, which changes the
statistics. Its tiered prefill pads a prompt to 32 tokens and counts the pads
in the statistics, so the prompts of that mode are 32 tokens long. The
port's own checks mirror tests/test_tiering.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu import native as jnative  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_cache  # noqa: E402
from sparkinfer_tpu.sparse import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu.sparse import sparse_layout as jax_sparse_layout  # noqa: E402
from sparkinfer_tpu.sparse import balancer as jbal  # noqa: E402
from sparkinfer_tpu.sparse import tiering as jtier  # noqa: E402
from sparkinfer_tpu_torch import native  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse import balancer as tbal  # noqa: E402
from sparkinfer_tpu_torch.sparse import tiering as ttier  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse.ffn import make_sparse_ffn, prepare_sparse_params  # noqa: E402

G, CAP = 16, 4
GQ = 32  # Q8_0 stores block G by 32
ROW_KEYS = ("w_up_rows", "w_gate_rows", "w_down_rows", "b_up")


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return str(path)


def _models(path, g=G):
    """(JAX model, port model) in f32 with the row stores of groups of g."""
    jm = jax_load(path, dtype=jnp.float32)
    jm.params["layers"] = jax_sparse_layout(jm.params["layers"], jm.config,
                                            JaxSparseConfig(g, CAP))
    pm = load_model(path, dtype=torch.float32, device="cpu")
    pm.params = prepare_sparse_params(pm.params, pm.config, SparseConfig(g, CAP))
    return jm, pm


@pytest.fixture(scope="module")
def both(gguf):
    return _models(gguf)


def _rows(layers, numpy=False):
    return {k: (np.asarray(v) if numpy else v) for k, v in layers.items() if k in ROW_KEYS}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _jax_mk(jm, scfg, H, mode, init_hot=None, quant=None, kernel="gather"):
    cfg, layers = jm.config, jm.params["layers"]
    tp, st = jtier.init_tiered(cfg, scfg, layers, H, init_hot=init_hot, quant=quant,
                               track_miss_groups=(mode == "fetch"))
    cold = jtier.ColdStore(cfg, scfg, _rows(layers, numpy=True), dtype=np.float32)
    ffn = jtier.make_tiered_ffn(cfg, scfg, cold, mode=mode, kernel=kernel)
    params = dict(jm.params)
    params["layers"], params["sparse_flat"] = jtier.tiered_layer_params(layers, tp)
    fwd = jax.jit(jax_forward(cfg, ffn_fn=ffn, stateful_ffn=True))
    return fwd, params, tp, st, cold


def _port_mk(pm, scfg, H, mode, init_hot=None, quant=None, kernel="kernel",
             cold_dtype=torch.float32):
    cfg, layers = pm.config, pm.params["layers"]
    tp, st = ttier.init_tiered(cfg, scfg, layers, H, init_hot=init_hot, quant=quant,
                               track_miss_groups=(mode == "fetch"))
    cold = ttier.ColdStore(cfg, scfg, _rows(layers), dtype=cold_dtype)
    ffn = ttier.make_tiered_ffn(cfg, scfg, cold, mode=mode, kernel=kernel)
    params = dict(pm.params)
    params["layers"], params["sparse_flat"] = ttier.tiered_layer_params(layers, tp)
    return make_forward(cfg, ffn_fn=ffn, stateful_ffn=True), params, tp, st, cold


def _jax_run(fwd, params, toks, st, cfg, start=0, S=16):
    cache = jax_cache(cfg, 1, S, jnp.float32)
    pos = jnp.arange(start, start + len(toks), dtype=jnp.int32)[None]
    logits, _, st = fwd(params, jnp.asarray(toks, jnp.int32)[None], pos, cache, st)
    return np.asarray(logits), st


def _port_run(fwd, params, toks, st, cfg, start=0, S=16):
    cache = init_cache(cfg, 1, S, torch.float32, "cpu")
    pos = torch.arange(start, start + len(toks))[None]
    with torch.inference_mode():
        logits = fwd(params, torch.tensor([toks]), pos, cache, st)
    return logits.numpy()


def _ref_logits(pm, scfg, toks):
    """The untiered gather sparse forward of the port."""
    cfg = pm.config
    fwd = make_forward(cfg, ffn_fn=make_sparse_ffn(cfg, scfg, mode="gather"))
    cache = init_cache(cfg, 1, 16, torch.float32, "cpu")
    with torch.inference_mode():
        return fwd(pm.params, torch.tensor([toks]), torch.arange(len(toks))[None], cache).numpy()


def _bad_hot(cfg, lo, hi):
    return np.tile(np.arange(lo, hi, dtype=np.int32), (cfg.n_layer, 1))


def _state_equal(jst, pst):
    np.testing.assert_allclose(pst.dfr.numpy(), np.asarray(jst.dfr), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pst.miss.numpy(), np.asarray(jst.miss))
    np.testing.assert_array_equal(pst.steps.numpy(), np.asarray(jst.steps))
    if jst.miss_g is not None:
        np.testing.assert_array_equal(pst.miss_g.numpy(), np.asarray(jst.miss_g))


def _stores_equal(jtp, ptp):
    for name in ("hot_upT", "hot_gateT", "hot_down", "group_map", "hot_ids",
                 "s_upT", "s_gateT", "s_down"):
        j, p = getattr(jtp, name), getattr(ptp, name)
        assert (j is None) == (p is None), name
        if j is not None:
            np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=name)


# ---------------------------------------------------------------------------
# the host library


@pytest.mark.parametrize("cur,want,window", [
    ([3, 7, 9, 1], [3, 2, 9, 5], 8), ([3, 7, 9, 1], [3, 2, 9, 5], 1),
    ([0, 1, 2, 3], [0, 10, 11, 12], 2), ([0, 10, 11, 3], [0, 10, 11, 12], 2),
    ([0, 1], [0, 1], 4), ([4, 5, 6], [9, 8, 7, 6, 5], 8), ([1, 2, 3], [3, 1, 2], 8),
])
def test_reload_plan_matches_jax(cur, want, window):
    """The balancer's plan (bit-equal pairs) and the host library's
    `spif_reload_plan` (the port's build against the JAX package's)."""
    cur, want = np.asarray(cur, np.int32), np.asarray(want, np.int32)
    assert tbal.reload_plan(cur, want, window) == jbal.reload_plan(cur, want, window)
    assert native.reload_plan(cur, want, window) == jnative.reload_plan(cur, want, window)


@pytest.mark.parametrize("dtype", ["f32", "f16"])
@pytest.mark.parametrize("act,bias", [("relu", False), ("relu", True), ("fatrelu", True),
                                      ("drelu", False)])
def test_complement_matches_jax(dtype, act, bias):
    """The library and the plain version against JAX's ColdStore.complement:
    within 1e-5 of its scale, over random stores, probabilities and
    cold-active sets."""
    rng = np.random.default_rng(3)
    L, ng, g, E, N = 2, 6, 16, 64, 5
    npdt, tdt = (np.float32, torch.float32) if dtype == "f32" else (np.float16, torch.float16)
    rows = {k: (rng.standard_normal((L, ng, g, E)) * 0.2).astype(np.float32)
            for k in ("w_up_rows", "w_gate_rows", "w_down_rows")}
    if act == "relu":
        rows.pop("w_gate_rows")
    if bias:
        rows["b_up"] = (rng.standard_normal((L, ng * g)) * 0.1).astype(np.float32)
    cfg = ModelConfig(arch={"relu": "opt", "fatrelu": "prosparse_llama", "drelu": "bamboo"}[act],
                      n_layer=L, n_embd=E, n_head=4, n_head_kv=4, n_ff=ng * g, n_vocab=8,
                      head_dim=E // 4)
    scfg = JaxSparseConfig(g, 3)
    x = rng.standard_normal((N, E)).astype(np.float32)
    probs = rng.random((N, ng, g)).astype(np.float32)
    cold_active = rng.random((N, ng)) < 0.5
    jcold = jtier.ColdStore(_jax_cfg(cfg), scfg, rows, dtype=npdt)
    pcold = ttier.ColdStore(cfg, SparseConfig(g, 3), {k: torch.from_numpy(v)
                                                      for k, v in rows.items()}, dtype=tdt)
    assert pcold.act == jcold.act
    for il in range(L):
        want = jcold.complement(np.int32(il), x, probs, cold_active)
        got = pcold.complement(il, torch.from_numpy(x), torch.from_numpy(probs),
                               torch.from_numpy(cold_active))
        _close(got, want)
        b_up = None if pcold.b_up is None else pcold.b_up[il]
        plain = native.sparse_complement_plain(
            torch.from_numpy(x), pcold.up[il], None if pcold.gate is None else pcold.gate[il],
            pcold.down[il], b_up, torch.from_numpy(probs), torch.from_numpy(cold_active),
            act, pcold.fatrelu_threshold, 0.5)
        _close(plain, want)
    assert pcold.n_calls == L


def test_complement_from_many_threads():
    """The library's thread pool under calls from more Python threads than
    cores (ctypes drops the interpreter lock): every call returns the serial
    result, bit for bit (the same additions in the same order)."""
    import sys
    import threading

    gen = torch.Generator().manual_seed(0)
    ng, g, E, N = 12, 16, 256, 3
    up, gate, down = (torch.randn((ng, g, E), generator=gen) for _ in range(3))
    x, probs = torch.randn((N, E), generator=gen), torch.rand((N, ng, g), generator=gen)
    cold_active = torch.rand((N, ng), generator=gen) < 0.5
    args = (x, up, gate, down, None, probs, cold_active, "fatrelu")
    want = native.sparse_complement(*args)
    bad, done = [], []

    def work():
        for _ in range(20):
            if not torch.equal(native.sparse_complement(*args), want):
                bad.append(1)
        done.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(4 * native.num_threads())]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == len(threads) and not bad


def _jax_cfg(cfg):
    from sparkinfer_tpu.models.config import ModelConfig as JaxModelConfig

    return JaxModelConfig(arch=cfg.arch, n_layer=cfg.n_layer, n_embd=cfg.n_embd,
                          n_head=cfg.n_head, n_head_kv=cfg.n_head_kv, n_ff=cfg.n_ff,
                          n_vocab=cfg.n_vocab, head_dim=cfg.head_dim)


def test_host_mode_needs_the_library(both, monkeypatch):
    """No fallback: where the library cannot be built, a cold store (and with
    it host mode) raises."""
    _, pm = both
    from sparkinfer_tpu_torch.ops import _build

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="compiler"):
        ttier.ColdStore(pm.config, SparseConfig(G, CAP), _rows(pm.params["layers"]))


def test_cold_store_defaults_to_f16(both, capsys):
    _, pm = both
    cold = ttier.ColdStore(pm.config, SparseConfig(G, CAP), _rows(pm.params["layers"]))
    assert cold.dtype == (torch.float16 if native.has_f16() else torch.float32)
    assert cold.up.dtype == cold.dtype and cold.b_up is None
    assert f"{cold.nbytes} bytes" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the hot store, the tiered FFN, the DFR statistics


@pytest.mark.parametrize("quant", [None, "q8_0"])
@pytest.mark.parametrize("hot", ["first", "chosen"])
def test_init_tiered_matches_jax(gguf, quant, hot):
    g = GQ if quant else G
    jm, pm = _models(gguf, g)
    cfg = pm.config
    ng = cfg.n_ff // g
    init_hot = None if hot == "first" else np.stack(
        [np.random.default_rng(l).permutation(ng)[:2].astype(np.int32)
         for l in range(cfg.n_layer)])
    jtp, jst = jtier.init_tiered(jm.config, JaxSparseConfig(g, CAP), jm.params["layers"], 2,
                                 init_hot=init_hot, quant=quant, track_miss_groups=True)
    ptp, pst = ttier.init_tiered(cfg, SparseConfig(g, CAP), pm.params["layers"], 2,
                                 init_hot=init_hot, quant=quant, track_miss_groups=True)
    _stores_equal(jtp, ptp)
    assert ptp.quantized == (quant is not None) and ptp.n_hot == 2
    _state_equal(jst, pst)
    # rows on the host, the store on the card's stand-in: the same store
    htp, _ = ttier.init_tiered(cfg, SparseConfig(g, CAP), _rows(pm.params["layers"]), 2,
                               init_hot=init_hot, quant=quant, device="cpu")
    _stores_equal(jtp, htp)


@pytest.mark.parametrize("mode", ["host", "drop", "fetch"])
@pytest.mark.parametrize("kernel", ["kernel", "gather"])
def test_tiered_ffn_matches_jax(both, mode, kernel):
    """One 5-token forward and two 1-token steps through a badly chosen hot
    set (the never-firing last groups): logits within 1e-5, statistics
    equal."""
    jm, pm = both
    scfg, jscfg = SparseConfig(G, CAP), JaxSparseConfig(G, CAP)
    ng = pm.config.n_ff // G
    bad = _bad_hot(pm.config, ng - 2, ng)
    jfwd, jparams, _, jst, _ = _jax_mk(jm, jscfg, 2, mode, init_hot=bad)
    pfwd, pparams, _, pst, _ = _port_mk(pm, scfg, 2, mode, init_hot=bad, kernel=kernel)
    for toks, start in (([2, 7, 11, 3, 8], 0), ([5], 5), ([9], 6)):
        want, jst = _jax_run(jfwd, jparams, toks, jst, jm.config, start)
        got = _port_run(pfwd, pparams, toks, pst, pm.config, start)
        _close(got, want)
        _state_equal(jst, pst)
    assert float(pst.miss.sum()) > 0


@pytest.mark.parametrize("mode", ["host", "fetch"])
def test_q8_tiered_ffn_matches_jax(gguf, mode):
    """A Q8_0 hot store (v6q's layout): the port's plain v6q against the JAX
    gather math over the same packed store, logits within 1e-5."""
    jm, pm = _models(gguf, GQ)
    jfwd, jparams, _, jst, _ = _jax_mk(jm, JaxSparseConfig(GQ, 2), 1, mode, quant="q8_0")
    pfwd, pparams, _, pst, _ = _port_mk(pm, SparseConfig(GQ, 2), 1, mode, quant="q8_0")
    want, jst = _jax_run(jfwd, jparams, [4, 9, 17], jst, jm.config)
    got = _port_run(pfwd, pparams, [4, 9, 17], pst, pm.config)
    _close(got, want)
    _state_equal(jst, pst)


def test_host_mode_exact_for_any_hot_set(both):
    """hot kernel + host complement == the full gathered sparse FFN, even with
    a tiny, badly chosen hot set."""
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    toks = np.random.default_rng(0).integers(0, cfg.n_vocab, 5).tolist()
    ng = cfg.n_ff // G
    fwd, params, _, st, _ = _port_mk(pm, scfg, 2, "host", init_hot=_bad_hot(cfg, ng - 2, ng))
    np.testing.assert_allclose(_port_run(fwd, params, toks, st, cfg),
                               _ref_logits(pm, scfg, toks), rtol=1e-4, atol=1e-4)
    assert float(st.miss.sum()) > 0


def test_host_mode_f16_cold_store_close(both):
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    toks = np.random.default_rng(0).integers(0, cfg.n_vocab, 5).tolist()
    ng = cfg.n_ff // G
    fwd, params, _, st, cold = _port_mk(pm, scfg, 2, "host", init_hot=_bad_hot(cfg, ng - 2, ng),
                                        cold_dtype=torch.float16)
    assert cold.up.dtype == torch.float16
    np.testing.assert_allclose(_port_run(fwd, params, toks, st, cfg),
                               _ref_logits(pm, scfg, toks), rtol=2e-2, atol=2e-3)


def test_drop_mode_exact_when_hot_covers_active(both):
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    toks = np.random.default_rng(1).integers(0, cfg.n_vocab, 5).tolist()
    fireable = int(np.ceil(2 * (cfg.n_ff // G) / 3))
    fwd, params, _, st, _ = _port_mk(pm, scfg, fireable, "drop")
    np.testing.assert_allclose(_port_run(fwd, params, toks, st, cfg),
                               _ref_logits(pm, scfg, toks), rtol=1e-4, atol=1e-4)
    assert float(st.miss.sum()) == 0


def test_dfr_ema_math(both):
    """One forward: dfr' = λ·0 + (1-λ)·fired_fraction; never-firing groups stay 0."""
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    toks = np.random.default_rng(2).integers(0, cfg.n_vocab, 4).tolist()
    fwd, params, _, st, _ = _port_mk(pm, scfg, 2, "host")
    _port_run(fwd, params, toks, st, cfg)
    dfr = st.dfr.numpy()
    ng = cfg.n_ff // G
    assert dfr.shape == (cfg.n_layer, ng)
    assert (dfr >= 0).all() and (dfr <= (1 - scfg.dfr_decay) + 1e-6).all()
    assert np.allclose(dfr[:, 2 * ng // 3 + 1:], 0.0)
    assert (st.steps.numpy() == 1).all()


def test_stateless_ffn_is_the_stateful_output(both):
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    fwd, params, tp, st, cold = _port_mk(pm, scfg, 2, "host")
    stateless = make_forward(cfg, ffn_fn=ttier.make_tiered_ffn(cfg, scfg, cold, stateless=True))
    cache = init_cache(cfg, 1, 16, torch.float32, "cpu")
    with torch.inference_mode():
        got = stateless(params, torch.tensor([[4, 8, 15]]), torch.arange(3)[None], cache)
    np.testing.assert_array_equal(got.numpy(), _port_run(fwd, params, [4, 8, 15], st, cfg))


# ---------------------------------------------------------------------------
# the balancer


@pytest.mark.parametrize("quant", [None, "q8_0"])
@pytest.mark.parametrize("budget,hyst,fetch", [(0.0, 0.05, False), (0.0, 0.0, True),
                                               (0.004, 0.05, True), (0.0, 0.5, False)])
def test_rebalance_matches_jax(gguf, quant, budget, hyst, fetch):
    """Three rebalances over the same random DFR and miss counts, from the
    same f32 cold store: equal hot_ids, group maps, stores (and scales),
    swap counts and windows."""
    g = GQ if quant else G
    jm, pm = _models(gguf, g)
    kw = dict(reload_budget_mb=budget, swap_hysteresis=hyst)
    jscfg, scfg = JaxSparseConfig(g, 2, **kw), SparseConfig(g, 2, **kw)
    ng = pm.config.n_ff // g
    jtp, _ = jtier.init_tiered(jm.config, jscfg, jm.params["layers"], 1, quant=quant)
    ptp, _ = ttier.init_tiered(pm.config, scfg, pm.params["layers"], 1, quant=quant)
    jcold = jtier.ColdStore(jm.config, jscfg, _rows(jm.params["layers"], True), dtype=np.float32)
    pcold = ttier.ColdStore(pm.config, scfg, _rows(pm.params["layers"]), dtype=torch.float32)
    jb, pb = jbal.Balancer(cold=jcold, scfg=jscfg), tbal.Balancer(cold=pcold, scfg=scfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        dfr = rng.random((pm.config.n_layer, ng)).astype(np.float32)
        miss = ((rng.random(dfr.shape) < 0.3) * rng.integers(1, 5, dfr.shape)).astype(
            np.float32) if fetch else None
        jtp = jb.rebalance(jtp, dfr, miss_g=miss)
        got = pb.rebalance(ptp, torch.from_numpy(dfr),
                           miss_g=None if miss is None else torch.from_numpy(miss))
        assert got is ptp  # in place
        _stores_equal(jtp, ptp)
        assert (pb.total_swaps, pb.rebalances, pb.window) == (jb.total_swaps, jb.rebalances,
                                                                jb.window)
    assert pb.total_swaps > 0 and pb.bytes_h2d > 0


def test_balancer_converges_hot_set(both):
    """Drop mode, a bad first hot set: DFR plus rebalancing between steps
    brings every fireable group in, and the misses vanish."""
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    ng = cfg.n_ff // G
    fireable = int(np.ceil(2 * ng / 3))
    fwd, params, tp, st, cold = _port_mk(pm, scfg, fireable, "drop",
                                         init_hot=_bad_hot(cfg, ng - fireable, ng))
    bal = tbal.Balancer(cold=cold, scfg=scfg, window=8)
    rng = np.random.default_rng(3)
    cache = init_cache(cfg, 1, 64, torch.float32, "cpu")
    miss_t = []
    with torch.inference_mode():
        for t in range(12):
            tok = int(rng.integers(0, cfg.n_vocab))
            prev = float(st.miss.sum())
            fwd(params, torch.tensor([[tok]]), torch.tensor([[t]]), cache, st)
            miss_t.append(float(st.miss.sum()) - prev)
            bal.rebalance(tp, st.dfr)
    assert miss_t[-1] == 0.0, miss_t
    assert bal.total_swaps > 0
    ids, dfr = tp.hot_ids.numpy(), st.dfr.numpy()
    for l in range(cfg.n_layer):
        assert set(range(fireable)) <= set(ids[l].tolist()) | set(np.nonzero(dfr[l] == 0)[0])


def test_balancer_completion_probe_adapts_window(both):
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    ng = cfg.n_ff // G
    tp, _ = ttier.init_tiered(cfg, scfg, pm.params["layers"], 2)
    cold = ttier.ColdStore(cfg, scfg, _rows(pm.params["layers"]), dtype=torch.float32)
    bal = tbal.Balancer(cold=cold, scfg=scfg, window=2, max_window=8)
    dfr = np.zeros((cfg.n_layer, ng), np.float32)
    dfr[:, ng - 1] = 1.0
    bal.rebalance(tp, dfr)
    assert bal._pending is not None  # swaps were made and recorded
    w0 = bal.window
    dfr[:, ng - 2] = 2.0
    bal.rebalance(tp, dfr)  # the CPU's copies have landed: the window grows
    assert bal.window == min(bal.max_window, w0 * 2) and bal.overruns == 0
    bal.last_reload_s = 1.0
    bal.adapt_window(0.5)
    assert bal.window == min(bal.max_window, w0 * 2) // 2


def test_fetch_tier_turns_misses_into_hits(both):
    """Fetch mode: per-group miss counts are carried in the step; the
    balancer brings the missed groups in, so the same input, repeated, hits
    and matches the exact sparse forward."""
    _, pm = both
    cfg, scfg = pm.config, SparseConfig(G, CAP)
    ng = cfg.n_ff // G
    fireable = int(np.ceil(2 * ng / 3))
    fwd, params, tp, st, cold = _port_mk(pm, scfg, fireable, "fetch",
                                         init_hot=_bad_hot(cfg, ng - fireable, ng))
    bal = tbal.Balancer(cold=cold, scfg=scfg, window=8)
    toks = [2, 7, 11, 3, 8]
    _port_run(fwd, params, toks, st, cfg)
    miss1 = float(st.miss.sum())
    assert miss1 > 0 and float(st.miss_g.sum()) > 0
    bal.rebalance(tp, st.dfr, miss_g=st.miss_g)
    st.miss_g.zero_()
    _port_run(fwd, params, toks, st, cfg)
    assert float(st.miss.sum()) - miss1 == 0
    np.testing.assert_allclose(_port_run(fwd, params, toks, st, cfg),
                               _ref_logits(pm, scfg, toks), rtol=1e-4, atol=1e-4)


def test_reload_budget_caps_swaps(both):
    """reload_budget_mb of one block swap a layer: at most one swap a layer,
    where the unbudgeted balancer swaps more."""
    _, pm = both
    cfg = pm.config
    ng = cfg.n_ff // G
    per_swap = 3 * G * cfg.n_embd * 4
    scfg0 = SparseConfig(G, CAP)
    scfg = dataclasses.replace(scfg0, reload_budget_mb=per_swap * cfg.n_layer / 2**20)
    bad = _bad_hot(cfg, ng - 2, ng)
    fwd, params, tp, st, cold = _port_mk(pm, scfg, 2, "drop", init_hot=bad)
    _port_run(fwd, params, [int(np.random.default_rng(3).integers(0, cfg.n_vocab))], st, cfg)
    bal = tbal.Balancer(cold=cold, scfg=scfg, window=8)
    bal.rebalance(tp, st.dfr)
    assert 0 < bal.total_swaps <= cfg.n_layer
    _, _, tp2, _, _ = _port_mk(pm, scfg0, 2, "drop", init_hot=bad)
    bal2 = tbal.Balancer(cold=cold, scfg=scfg0, window=8)
    bal2.rebalance(tp2, st.dfr)
    assert bal2.total_swaps > bal.total_swaps


def test_reload_budget_global_priority(both):
    """A budget of ONE swap goes to the most-missed group, across layers."""
    _, pm = both
    cfg = pm.config
    ng = cfg.n_ff // G
    scfg = SparseConfig(G, CAP, reload_budget_mb=3 * G * cfg.n_embd * 4 / 2**20)
    bad = _bad_hot(cfg, ng - 2, ng)
    _, _, tp, _, cold = _port_mk(pm, scfg, 2, "fetch", init_hot=bad)
    bal = tbal.Balancer(cold=cold, scfg=scfg, window=8)
    miss = np.zeros((cfg.n_layer, ng), np.float32)
    miss[1, 0] = 100.0
    miss[0, 1] = 3.0
    bal.rebalance(tp, np.zeros((cfg.n_layer, ng), np.float32), miss_g=miss)
    assert bal.total_swaps == 1
    hot = tp.hot_ids.numpy()
    assert 0 in hot[1]
    np.testing.assert_array_equal(hot[0], bad[0])


# ---------------------------------------------------------------------------
# the Engine, the Scheduler and the server

PROMPT = [11, 22, 33]
# the JAX Scheduler's tiered prefill pads to 32 tokens: prompts of 32 pad nothing
PROMPTS32 = [np.random.default_rng(1).integers(1, 190, 32).tolist() for _ in range(4)]


def _jax_engine(path, mode, split=None):
    from sparkinfer_tpu.runtime.engine import Engine as JaxEngine
    from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler

    return JaxEngine(jax_load(path, dtype=jnp.float32), max_seq=64,
                     sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                     sparse=JaxSparseConfig(G, CAP, hot_groups=2), sparse_cold_mode=mode,
                     split=split)


def _port_engine(path, mode, split=None, **kw):
    from sparkinfer_tpu_torch.runtime.engine import Engine

    return Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=64,
                  sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                  sparse=SparseConfig(G, CAP, hot_groups=2), sparse_cold_mode=mode,
                  split=split, device="cpu", **kw)


@pytest.mark.parametrize("mode", ttier.MODES)
def test_engine_matches_jax(gguf, mode):
    """Greedy streams of the tiered Engines equal; host mode also equals the
    untiered gather Engine's (it is exact)."""
    from sparkinfer_tpu_torch.runtime.engine import Engine

    want = _jax_engine(gguf, mode).generate(PROMPT, max_new_tokens=10)
    pe = _port_engine(gguf, mode)
    assert pe.generate(PROMPT, max_new_tokens=10) == want
    assert pe.balancer.rebalances == 9 and not pe.graphs.capture
    if mode == "host":
        ref = Engine(load_model(gguf, dtype=torch.float32, device="cpu"), max_seq=64,
                     sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                     sparse=SparseConfig(G, CAP), sparse_decode_mode="gather",
                     sparse_pipelined=False, device="cpu")
        assert ref.generate(PROMPT, max_new_tokens=10) == want
        assert pe.cold.n_calls == 9 * pe.cfg.n_layer
    if mode == "fetch":
        assert pe.balancer.total_swaps > 0 and float(pe.fstate.miss_g.sum()) == 0


def test_engine_host_mode_runs_eagerly(gguf):
    with pytest.raises(ValueError, match="cuda_graph"):
        _port_engine(gguf, "host", cuda_graph=True)
    with pytest.raises(ValueError, match="cold mode"):
        _port_engine(gguf, "nearby")


def _jax_scheduler(path, mode, prefill_mode, split=None):
    from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler
    from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest
    from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler

    sched = JaxScheduler(jax_load(path, dtype=jnp.float32), n_slots=2, max_seq=64,
                         sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                         sparse=JaxSparseConfig(G, CAP, hot_groups=2),
                         sparse_cold_mode=mode, prefill_mode=prefill_mode, split=split)
    reqs = [sched.submit(JaxRequest(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS32]
    sched.run_until_idle()
    return [r.tokens() for r in reqs]


def _port_scheduler(path, mode, prefill_mode, split=None):
    from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler

    model = load_model(path, dtype=torch.float32, device="cpu")
    sched = Scheduler(model, n_slots=2, max_seq=64, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, sparse=SparseConfig(G, CAP, hot_groups=2),
                      sparse_cold_mode=mode, prefill_mode=prefill_mode, split=split,
                      device="cpu")
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS32]
    sched.run_until_idle()
    return model, sched, [r.tokens() for r in reqs]


@pytest.mark.parametrize("prefill_mode", ["rows", "tiered"])
@pytest.mark.parametrize("mode", ttier.MODES)
def test_scheduler_matches_jax(gguf, monkeypatch, mode, prefill_mode):
    """4 requests on 2 slots: equal streams, every tick tiered (no
    masked-dense fallback), a rebalance after every tick; in "tiered" prefill
    the dense FFN has left the model and no row store is kept."""
    monkeypatch.setenv("SPARK_SCHED_PIPELINE", "0")
    want = _jax_scheduler(gguf, mode, prefill_mode)
    model, sched, got = _port_scheduler(gguf, mode, prefill_mode)
    assert got == want and all(len(t) == 6 for t in got)
    m = sched.metrics_snapshot()
    assert m["n_dense_steps"] == 0 and m["n_rebalances"] == m["n_decode_steps"] == 10
    assert sched.sparse_batch_max is None and not sched.graphs.capture
    if prefill_mode == "tiered":
        layers = model.params["layers"]
        assert not {"w_up", "w_gate", "w_down"} & set(layers)
        assert not any(k.endswith("_rows") for k in sched.params["layers"])
        assert float(sched.fstate.steps[0]) == 4 + 10  # 4 prompts, 10 ticks


def test_fetch_warns_when_capacity_exceeds_hot_groups(gguf, capsys):
    _port_scheduler(gguf, "fetch", "rows")
    assert "capacity_groups (4) > hot_groups (2)" in capsys.readouterr().err


def test_server_tiering_flags(tmp_path, monkeypatch):
    """--hot-groups, --cold-mode, --prefill-mode and --rebalance-every reach
    the server's Scheduler, -vb gives the JAX CLI's hot-group count, and the
    tiered server answers a completion."""
    import json
    import urllib.request

    from sparkinfer_tpu.tools.cli import hbm_budget_to_hot_groups as jax_budget
    from sparkinfer_tpu_torch.server import __main__ as server_main
    from sparkinfer_tpu_torch.server.app import SparkServer
    from sparkinfer_tpu_torch.sparse.config import hbm_budget_to_hot_groups

    path = tmp_path / "tiny-prosparse-vocab.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5, n_vocab=300,
                    with_vocab=True)
    served = []
    serve = SparkServer.serve
    monkeypatch.setattr(SparkServer, "serve",
                        lambda self, block=True: (served.append(self), serve(self, block=False)))
    base = ["-m", str(path), "--device", "cpu", "--port", "0", "-np", "2", "--group-size",
            "16", "--capacity-groups", "4"]
    server_main.main(base + ["--hot-groups", "3", "--cold-mode", "fetch",
                             "--prefill-mode", "tiered", "--rebalance-every", "2"])
    srv = served[-1]
    try:
        s = srv.sched
        assert (s.tiered_params.n_hot, s.prefill_mode, s.rebalance_every) == (3, "tiered", 2)
        assert s.fstate.miss_g is not None  # fetch mode
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions", method="POST",
            data=json.dumps({"prompt": [1, 263, 42], "max_tokens": 4, "temperature": 0,
                             "stop": []}).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["usage"]["completion_tokens"] == 4
    finally:
        srv.shutdown()
    cfg = srv.model.config
    assert hbm_budget_to_hot_groups(5e-5, cfg, 16) == jax_budget(5e-5, cfg, 16) == 4
    server_main.main(base + ["-vb", "5e-5"])
    srv = served[-1]
    try:
        assert srv.sched.tiered_params.n_hot == 4 and srv.sched.fstate.miss_g is None  # host
    finally:
        srv.shutdown()
