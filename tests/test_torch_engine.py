"""The port's Engine against the JAX package's, on the CPU, plus the port's
guards (device resolution, no JAX import, unported options).

Both engines load one tiny ProSparse GGUF in f32 with an f32 KV cache; the
JAX sparse decode runs its Pallas v6 kernel in interpret mode. Greedy token
streams must be identical; prefill and first-decode logits agree to
rtol=atol=1e-4 (f32, summed in other orders across a whole forward).

The Q8_0 sparse engine is built as chip_smoke.py builds its model: Q8_0
QuantTensor attention and head (keep_quantized), Q8_0 flat FFN stores
(prepare_pipelined_params(layout="v6", quant="q8_0", drop_dense=True)) and Q8_0
predictor stacks in params["sparse_flat"], then Engine(sparse_preprepared=
True); the JAX engine runs v6q and the quant matmuls in interpret mode.
Its products round activations to bf16, so the fixture's seed is one
where no activation lies on a bf16 rounding boundary (test_torch_quant.py).
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu.ops import quant_matmul as jqm  # noqa: E402
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.ops.sparse_ffn import (  # noqa: E402
    sparse_ffn_block_v6,
    sparse_ffn_block_v6q,
)
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT = [5, 9, 42]
G, CAP = 16, 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return str(path)


def _jax_engine(gguf, sparse):
    return JaxEngine(jax_load(gguf, dtype=jnp.float32), max_seq=64,
                     sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                     sparse=JaxSparseConfig(G, CAP) if sparse else None,
                     sparse_decode_mode="pallas")


def _port_engine(gguf, sparse, **kw):
    return Engine(load_model(gguf, dtype=torch.float32, device="cpu"), max_seq=64,
                  sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                  sparse=SparseConfig(G, CAP) if sparse else None, device="cpu", **kw)


def _jax_logits(je):
    """Prefill and first-decode logits of the JAX engine's own forwards."""
    cache = je.new_cache()
    toks = jnp.asarray([PROMPT], jnp.int32)
    pos = jnp.arange(len(PROMPT), dtype=jnp.int32)[None]
    lg, cache = je.fwd_prefill(je.model.params, toks, pos, cache)
    first = int(jnp.argmax(lg[0, -1]))
    lg2, _ = je.fwd_decode(je.model.params, jnp.asarray([[first]], jnp.int32),
                           jnp.asarray([[len(PROMPT)]], jnp.int32), cache)
    return np.asarray(lg[:, -1]), np.asarray(lg2[:, -1]), first


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_engine_matches_jax(gguf, sparse):
    je = _jax_engine(gguf, sparse)
    pe = _port_engine(gguf, sparse)
    ref_pre, ref_dec, first = _jax_logits(je)
    cache, st = pe.new_cache(), pe.new_sampler_state()
    tok, cache, st, n = pe.prefill(PROMPT, cache, st)
    assert tok == first and n == len(PROMPT)
    np.testing.assert_allclose(pe.last_logits.numpy(), ref_pre, **TOL)
    pe.decode_step(tok, n, cache, st)
    np.testing.assert_allclose(pe.last_logits.numpy(), ref_dec, **TOL)

    before = sparse_ffn_block_v6.launches
    got = pe.generate(PROMPT, 8)
    assert got == je.generate(PROMPT, 8)
    assert len(got) == 8 and pe.perf.n_decode == 1 + 7
    assert sparse_ffn_block_v6.launches == before  # CPU: plain version, uncounted


def test_chunked_prefill_matches_jax(gguf):
    je, pe = _jax_engine(gguf, True), _port_engine(gguf, True)
    je.prefill_chunk = pe.prefill_chunk = 4
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, 199, 11)]
    assert pe.generate(prompt, 6) == je.generate(prompt, 6)


def test_gather_mode_equals_kernel_mode(gguf):
    a = _port_engine(gguf, True, sparse_decode_mode="kernel").generate(PROMPT, 6)
    b = _port_engine(gguf, True, sparse_decode_mode="gather").generate(PROMPT, 6)
    assert a == b


@pytest.mark.parametrize("seed", [6, 8, 11])
def test_engine_gather_ffn_bf16_is_bit_equal_to_jax(tmp_path, seed):
    """The Engine's "gather" decode builds the v1 row stores, as the JAX
    Engine does for every mode but "pallas", so one bf16 FFN call at layer 0
    is bit-equal to JAX's (a token stream in bf16 could still part ways on
    a mask bit near the threshold, so none is compared)."""
    path = tmp_path / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=seed)
    je = JaxEngine(jax_load(str(path), dtype=jnp.bfloat16), max_seq=16,
                   sampler=JaxSampler(temp=0.0), sparse=JaxSparseConfig(G, CAP),
                   sparse_decode_mode="gather")
    pe = Engine(load_model(str(path), dtype=torch.bfloat16, device="cpu"), max_seq=16,
                sampler=SamplerConfig(temp=0.0), sparse=SparseConfig(G, CAP),
                sparse_decode_mode="gather", device="cpu")
    assert "w_up_rows" in pe.params["layers"] and "sparse_flat" not in pe.params
    jf, jinit = jffn.make_pipelined_sparse_ffn(je.cfg, JaxSparseConfig(G, CAP), mode="gather")
    tf, tinit = tffn.make_pipelined_sparse_ffn(pe.cfg, SparseConfig(G, CAP), mode="gather")
    x = np.random.default_rng(seed).standard_normal((1, 1, 64)).astype(np.float32)
    jl = {k: v[0] for k, v in je.model.params["layers"].items()}
    tl = {k: v[0] for k, v in pe.params["layers"].items()}
    ref, _ = jf(jl, jnp.asarray(x, jnp.bfloat16), jinit(1, 1), jnp.int32(0))
    got, _ = tf(tl, torch.from_numpy(x).to(torch.bfloat16), tinit(1, 1, "cpu"), 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_drop_dense_engine_equals_the_default(gguf):
    a = _port_engine(gguf, True).generate(PROMPT, 6)
    e = _port_engine(gguf, True, sparse_drop_dense=True)
    assert "w_up" not in e.params["layers"]
    assert e.generate(PROMPT, 6) == a


# ---------------------------------------------------------------------------
# Q8_0 sparse decode

GQ, CAPQ = 32, 2
PRED = ("pred_up", "pred_up_b", "pred_down", "pred_down_b")


@pytest.fixture(scope="module")
def q8_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse-q8.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=32, n_ff=96,
                    quant_type="q8_0", seed=1)
    return str(path)


def _q8_sparse_model(load, prepare, flat_quantize, scfg, path, **kw):
    """Q8_0 attention and head, Q8_0 flat FFN stores and Q8_0 predictor
    stacks from one GGUF, with either package's functions."""
    model = load(path, keep_quantized=True, **kw)
    dense = load(path, **kw).params["layers"]
    layers = dict(model.params["layers"])
    layers.update({k: dense[k] for k in ("w_up", "w_gate", "w_down")})
    pred = {k: layers.pop(k) for k in PRED}
    params = prepare(dict(model.params, layers=layers), model.config, scfg)
    params["sparse_flat"].update(
        pred_up_qt=flat_quantize(pred["pred_up"]),
        pred_down_qt=flat_quantize(pred["pred_down"]),
        pred_up_b_all=pred["pred_up_b"], pred_down_b_all=pred["pred_down_b"])
    model.params = params
    return model, pred


def _q8_engines(path, mode="kernel"):
    jm, jpred = _q8_sparse_model(
        jax_load, lambda p, c, s: jffn.prepare_pipelined_params(
            p, c, s, drop_dense=True, layout="v6", quant="q8_0"),
        lambda w: jqm.flat_quantize(np.asarray(w)), JaxSparseConfig(GQ, CAPQ), path,
        dtype=jnp.float32)
    # the JAX pipelined FFN routes to the stacks on "pred_up_all" only
    jm.params["sparse_flat"]["pred_up_all"] = jpred["pred_up"]
    tm, _ = _q8_sparse_model(
        lambda p, **kw: load_model(p, device="cpu", **kw),
        lambda p, c, s: tffn.prepare_pipelined_params(p, c, s, drop_dense=True,
                                                      layout="v6", quant="q8_0"),
        tqm.flat_quantize, SparseConfig(GQ, CAPQ), path, dtype=torch.float32)
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                   sparse=JaxSparseConfig(GQ, CAPQ), sparse_decode_mode="pallas",
                   sparse_preprepared=True)
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                sparse=SparseConfig(GQ, CAPQ), sparse_decode_mode=mode,
                sparse_preprepared=True, device="cpu")
    return je, pe


def test_q8_sparse_engine_matches_jax(q8_gguf):
    je, pe = _q8_engines(q8_gguf)
    flat = pe.params["sparse_flat"]
    assert isinstance(pe.params["layers"]["wq"], tqm.QuantTensor)
    assert isinstance(pe.params["output"], tqm.QuantTensor)
    assert isinstance(flat["pred_up_qt"], tqm.FlatQuantTensor) and "pred_up_all" not in flat
    assert flat["qw_upT_flat"].dtype == torch.int8 and "w_up" not in pe.params["layers"]
    ref_pre, ref_dec, first = _jax_logits(je)
    cache, st = pe.new_cache(), pe.new_sampler_state()
    tok, cache, st, n = pe.prefill(PROMPT, cache, st)
    assert tok == first
    np.testing.assert_allclose(pe.last_logits.numpy(), ref_pre, **TOL)
    pe.decode_step(tok, n, cache, st)
    np.testing.assert_allclose(pe.last_logits.numpy(), ref_dec, **TOL)
    counts = (sparse_ffn_block_v6q.launches, tqm.quant_matmul_2d.launches,
              tqm.quant_matmul_flat.launches)
    got = pe.generate(PROMPT, 8)
    assert got == je.generate(PROMPT, 8)
    assert counts == (sparse_ffn_block_v6q.launches, tqm.quant_matmul_2d.launches,
                      tqm.quant_matmul_flat.launches)  # CPU: plain versions, uncounted
    assert _q8_engines(q8_gguf, mode="gather")[1].generate(PROMPT, 8) == got


def test_generate_stops_and_streams(gguf):
    pe = _port_engine(gguf, True)
    full = pe.generate(PROMPT, 6)
    assert list(pe.generate(PROMPT, 6, stream=True)) == full
    assert pe.generate(PROMPT, 6, stop_ids={full[2]}) == full[:2]
    assert pe.generate(PROMPT, 0) == []


def test_sampled_generation_is_seeded(gguf):
    pe = Engine(load_model(gguf, dtype=torch.float32, device="cpu"), max_seq=64,
                sampler=SamplerConfig(temp=1.0, top_k=0, top_p=1.0, min_p=0.0),
                kv_dtype=torch.float32, device="cpu")
    assert pe.generate(PROMPT, 8, seed=3) == pe.generate(PROMPT, 8, seed=3)


def test_entry_points_default_to_the_card(gguf):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        load_model(gguf)
    model = load_model(gguf, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Engine(model)


def test_unported_options_raise(gguf, tmp_path):
    model = load_model(gguf, dtype=torch.float32, device="cpu")
    for kw in (dict(split="x"), dict(self_extend=(2, 8)), dict(kv_iswa=True),
               dict(sparse=SparseConfig(G, CAP, hot_groups=2))):
        with pytest.raises(NotImplementedError):
            Engine(model, device="cpu", **kw)
    pe = Engine(model, max_seq=6, sampler=SamplerConfig(temp=0.0), device="cpu")
    with pytest.raises(NotImplementedError, match="context shift"):
        pe.generate(PROMPT, 8)
    qwen = tmp_path / "qwen2.gguf"
    make_tiny_llama(qwen, arch="qwen2")
    with pytest.raises(NotImplementedError, match="qwen2"):
        load_model(str(qwen), device="cpu")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The build is keyed by source and flags, and fails loudly without nvcc."""
    from sparkinfer_tpu_torch.ops import _build

    lib = _build.library_path("sparse_ffn_v6")
    assert lib.parent == _build.BUILD_DIR and lib == _build.library_path("sparse_ffn_v6")
    if shutil.which("nvcc") or lib.exists():
        pytest.skip("nvcc or a built library is present")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all(["sparse_ffn_v6"])


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sparkinfer_tpu'] = None\n"
        "import sparkinfer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    print(importlib.import_module(m.name).__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("ops.quant_matmul", "ops.sparse_ffn", "gguf.quants", "sparse.predictor",
                "sparse.ffn", "models.loader", "models.from_jax", "runtime.engine",
                "runtime.scheduler", "utils.profiling", "tools.bench_matrix"):
        assert "sparkinfer_tpu_torch." + mod in names, mod


def test_port_sources_name_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|sparkinfer_tpu(\.|\s|$))", re.M)
    files = sorted((ROOT / "sparkinfer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not bad.search(f.read_text()), f


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH="")
    in_repo = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
    for run in (in_repo, alone):
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout
