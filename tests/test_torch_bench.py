"""The single-stream pipelined decode of sparkinfer-bench in the port against
the JAX package, on the CPU: the v1 row layout of prepare_pipelined_params
(with v2's concatenated store under SPIF_KERNEL_V2), the pipelined FFN's
row-store routes, the bench tool and the profiling helpers.

One tiny ProSparse GGUF (make_tiny_llama, pred_rank 8, n_ff 96) is loaded
by both packages in f32. Tolerances:
  - prepared stores: bit-equal;
  - the forward's logits: rtol=atol=1e-4 (f32 sums in other orders across
    a whole forward, as tests/test_sparse.py holds the JAX v2 path);
    greedy token streams: equal.
The JAX kernels run in interpret mode.
"""

import json
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402
from sparkinfer_tpu_torch.tools import bench_matrix  # noqa: E402
from sparkinfer_tpu_torch.utils import profiling  # noqa: E402

G, CAP = 16, 4
TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = [5, 9, 42, 7, 30]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return str(path)


@pytest.fixture(scope="module")
def both(gguf):
    return (jax_load(gguf, dtype=jnp.float32),
            load_model(gguf, dtype=torch.float32, device="cpu"))


def _set_v2(monkeypatch, on):
    if on:
        monkeypatch.setenv("SPIF_KERNEL_V2", "1")
    else:
        monkeypatch.delenv("SPIF_KERNEL_V2", raising=False)


@pytest.mark.parametrize("drop_dense", [False, True])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_prepare_pipelined_params_v1_layout_matches_jax(both, monkeypatch, v2, drop_dense):
    jm, tm = both
    _set_v2(monkeypatch, v2)
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, JaxSparseConfig(G, CAP),
                                       drop_dense=drop_dense)
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP),
                                       drop_dense=drop_dense)
    assert "sparse_flat" not in tp and sorted(tp) == sorted(jp)
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    assert ("w_all_rows" in tp["layers"]) == v2
    for k, v in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), np.asarray(v), err_msg=k)
    if v2:
        assert tp["layers"]["w_all_rows"].shape == (2, 3 * 6, G, 64)


def test_prepare_pipelined_params_rejects_what_jax_rejects(both):
    _, tm = both
    with pytest.raises(ValueError, match="layout='v6'"):
        tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(32, 2), quant="q8_0")
    with pytest.raises(ValueError, match="layout"):
        tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP), layout="v9")


def _jax_greedy(jm, params, mode, n_new):
    cfg = jm.config
    ffn, ci = jffn.make_pipelined_sparse_ffn(cfg, JaxSparseConfig(G, CAP), mode=mode)
    fwd = jax.jit(jax_forward(cfg, ffn_fn=ffn, ffn_carry_init=ci))
    cache = jax_cache(cfg, 1, 32, jnp.float32)
    lg, cache = fwd(params, jnp.asarray([PROMPT], jnp.int32),
                    jnp.arange(len(PROMPT), dtype=jnp.int32)[None], cache)
    logits, toks = [np.asarray(lg[:, -1])], []
    for i in range(n_new):
        toks.append(int(np.argmax(logits[-1][0])))
        lg, cache = fwd(params, jnp.asarray([[toks[-1]]], jnp.int32),
                        jnp.asarray([[len(PROMPT) + i]], jnp.int32), cache)
        logits.append(np.asarray(lg[:, -1]))
    return logits, toks


def _port_greedy(tm, params, mode, n_new):
    cfg = tm.config
    ffn, ci = tffn.make_pipelined_sparse_ffn(cfg, SparseConfig(G, CAP), mode=mode)
    fwd = make_forward(cfg, ffn_fn=ffn, ffn_carry_init=ci)
    cache = init_cache(cfg, 1, 32, torch.float32, "cpu")
    lg = fwd(params, torch.tensor([PROMPT]), torch.arange(len(PROMPT))[None], cache)
    logits, toks = [lg[:, -1].numpy()], []
    for i in range(n_new):
        toks.append(int(np.argmax(logits[-1][0])))
        lg = fwd(params, torch.tensor([[toks[-1]]]), torch.tensor([[len(PROMPT) + i]]), cache)
        logits.append(lg[:, -1].numpy())
    return logits, toks


@pytest.mark.parametrize("modes,v2", [(("kernel", "pallas"), False),
                                      (("kernel", "pallas"), True),
                                      (("gather", "gather"), False)],
                         ids=["kernel-v1", "kernel-v2", "gather"])
def test_pipelined_v1_layout_forward_matches_jax(both, monkeypatch, modes, v2):
    """sparkinfer-bench's sparse decode: mode "kernel" (the JAX "pallas")
    over the v1 layout runs v1, or v2 under SPIF_KERNEL_V2; "gather" the
    JAX gather math. Prefill and 6 greedy steps through the bare forward."""
    jm, tm = both
    _set_v2(monkeypatch, v2)
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, JaxSparseConfig(G, CAP))
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP))
    calls = {"sparse_ffn_block": 0, "sparse_ffn_block_v2": 0}
    for name in calls:  # count which row kernel the route takes
        orig = getattr(tffn, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tffn, name, counted)
    ref_logits, ref_toks = _jax_greedy(jm, jp, modes[1], 6)
    got_logits, got_toks = _port_greedy(tm, tp, modes[0], 6)
    assert got_toks == ref_toks
    for got, ref in zip(got_logits[:2], ref_logits[:2]):  # prefill, first decode
        np.testing.assert_allclose(got, ref, **TOL)
    n_calls = tm.config.n_layer * 7
    want = {"gather": (0, 0), "kernel": (0, n_calls) if v2 else (n_calls, 0)}[modes[0]]
    assert (calls["sparse_ffn_block"], calls["sparse_ffn_block_v2"]) == want


def test_v6_layout_ignores_kernel_v2_where_jax_fails(monkeypatch, tmp_path):
    """The JAX fault the port does not copy: with SPIF_KERNEL_V2 set, the
    JAX Engine's "pallas" decode prepares layout "v6", which pops the row
    stores into the flat ones and then reads w_up_rows to build w_all_rows
    (KeyError). The port's layout "v6" builds no w_all_rows, and its Engine
    generates what the JAX "gather" Engine does."""
    path = tmp_path / "tiny-rank16.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=16, n_ff=96, seed=5)
    monkeypatch.setenv("SPIF_KERNEL_V2", "1")
    jkw = dict(max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
               sparse=JaxSparseConfig(8, 4))
    with pytest.raises(KeyError, match="w_up_rows"):
        JaxEngine(jax_load(str(path), dtype=jnp.float32), sparse_decode_mode="pallas", **jkw)
    ref = JaxEngine(jax_load(str(path), dtype=jnp.float32), sparse_decode_mode="gather",
                    **jkw).generate([5, 9, 42], 3)
    tm = load_model(str(path), dtype=torch.float32, device="cpu")
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(8, 4), layout="v6")
    assert "w_all_rows" not in tp["layers"] and "w_all_rows" not in tp["sparse_flat"]
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                sparse=SparseConfig(8, 4), device="cpu")
    assert "w_all_rows" not in pe.params["layers"]
    assert pe.generate([5, 9, 42], 3) == ref


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_bench_matrix_main_on_the_cpu(gguf, capsys, monkeypatch, v2):
    _set_v2(monkeypatch, v2)
    rc = bench_matrix.main(["-m", gguf, "--device", "cpu", "-pp", "8", "-tg", "4",
                            "--sparse", "-o", "json"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["meta"] == {"arch": "prosparse_llama", "n_layer": 2, "n_embd": 64, "n_ff": 96}
    assert [r["test"] for r in out["results"]] == ["pp8", "tg4-sparse"]
    assert all(r["t/s"] > 0 for r in out["results"])


def test_bench_tg_prepares_once_per_model(gguf, monkeypatch):
    """The stores are prepared once per model and SparseConfig, and again
    only when SPIF_KERNEL_V2 asks for a w_all_rows they lack."""
    model = load_model(gguf, dtype=torch.float32, device="cpu")
    scfg = SparseConfig(G, CAP)
    monkeypatch.delenv("SPIF_KERNEL_V2", raising=False)
    kw = dict(ctx=64, sparse=scfg)
    assert bench_matrix.bench_tg(model, 2, 1, torch.float32, **kw) > 0
    first = bench_matrix.sparse_params(model, scfg)
    assert bench_matrix.bench_tg(model, 2, 1, torch.float32, batch=2, **kw) > 0
    assert bench_matrix.sparse_params(model, scfg) is first
    assert "w_all_rows" not in first["layers"] and "w_up_rows" not in model.params["layers"]
    old_rows = weakref.ref(first["layers"]["w_up_rows"])
    del first
    prepare = tffn.prepare_pipelined_params

    def prepare_after_the_old_stores_are_gone(*a, **k):
        assert old_rows() is None  # one store set at a time
        return prepare(*a, **k)

    monkeypatch.setattr(tffn, "prepare_pipelined_params", prepare_after_the_old_stores_are_gone)
    monkeypatch.setenv("SPIF_KERNEL_V2", "1")
    again = bench_matrix.sparse_params(model, scfg)
    assert "w_all_rows" in again["layers"]
    monkeypatch.delenv("SPIF_KERNEL_V2")
    assert bench_matrix.sparse_params(model, scfg) is again
    with pytest.raises(ValueError, match="ctx"):
        bench_matrix.bench_tg(model, 40, 2, torch.float32, **kw)


def _one_traced_region(where):
    files = list(where.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "spif-region" for e in events)


def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("SPIF_TRACE_DIR", raising=False)
    with profiling.maybe_trace() as d:
        assert d is None
    with profiling.maybe_trace(str(tmp_path / "arg")) as d:
        assert d == str(tmp_path / "arg")
        with profiling.annotate("spif-region"):
            torch.ones(8) @ torch.ones(8)
    _one_traced_region(tmp_path / "arg")
    monkeypatch.setenv("SPIF_TRACE_DIR", str(tmp_path / "env"))
    with profiling.maybe_trace():
        with profiling.annotate("spif-region"):
            torch.ones(8) @ torch.ones(8)
    _one_traced_region(tmp_path / "env")


def test_device_memory_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling.device_memory_profile()
