"""The decode step over static buffers (`runtime/graphs.py`): the function
the card captures as one CUDA graph, run eagerly on the CPU against the JAX
package, and on the card the graph against the eager step.

CPU (JAX on the CPU, its Pallas kernels in interpret mode): the Engine's
static-buffer step gives the JAX Engine's greedy streams and, at every
decode step, its logits within 1e-5 of their scale (f32, the same sums in
other orders) for dense, v6 "kernel" mode (the plain version here) and
"gather" mode, on one tiny ProSparse GGUF of tests/model_fixtures.py; the
Scheduler's static-buffer ticks give the JAX Scheduler's streams.

Card (marked `cuda`; no JAX needed, so run with --noconftest as README's
port section says): graph against eager on the same params, first decode
logits bit-equal and greedy streams equal (a replay runs the eager step's
kernels on the same inputs in the same order, so any difference is a fault,
such as a stale static buffer) for dense, v6, v6q (with quant_matmul), the
Scheduler's v1 tick and its masked-dense fallback; the launch counters
credited per replay; one capture for two `generate` calls; a sampled
engine's seeded stream; and a fresh process's first captured step.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu_torch.models.loader import LoadedModel, load_model  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block  # noqa: E402
from sparkinfer_tpu_torch.runtime import graphs  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPT = [5, 9, 42]
PROMPTS = [[3, 14, 15], [9, 26, 53, 58], [97, 93], [2, 71, 82, 81, 82]]
G, CAP = 16, 4
GQ, CAPQ = 32, 2
GREEDY = SamplerConfig(temp=0.0)
SAMPLED = SamplerConfig(temp=1.0, top_k=0, top_p=1.0, min_p=0.0)
PRED = ("pred_up", "pred_up_b", "pred_down", "pred_down_b")


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return str(path)


@pytest.fixture(scope="module")
def q8_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse-q8.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=32, n_ff=96,
                    quant_type="q8_0", seed=1)
    return str(path)


def _engine(path, device, kind="v6", sampler=GREEDY, **kw):
    """kind: "dense", "v6" (kernel mode), "gather"."""
    sparse = None if kind == "dense" else SparseConfig(G, CAP)
    mode = "gather" if kind == "gather" else "kernel"
    return Engine(load_model(path, dtype=torch.float32, device=device), max_seq=64,
                  sampler=sampler, kv_dtype=torch.float32, sparse=sparse,
                  sparse_decode_mode=mode, device=device, **kw)


def _q8_model(path, device):
    """Q8_0 attention and head, Q8_0 flat FFN stores and Q8_0 predictor
    stacks, as tests/test_torch_engine.py builds them, with the port alone."""
    model = load_model(path, dtype=torch.float32, device=device, keep_quantized=True)
    dense = load_model(path, dtype=torch.float32, device=device).params["layers"]
    layers = dict(model.params["layers"])
    layers.update({k: dense[k] for k in ("w_up", "w_gate", "w_down")})
    pred = {k: layers.pop(k) for k in PRED}
    params = tffn.prepare_pipelined_params(dict(model.params, layers=layers), model.config,
                                           SparseConfig(GQ, CAPQ), drop_dense=True,
                                           layout="v6", quant="q8_0")
    params["sparse_flat"].update(
        pred_up_qt=tqm.flat_quantize(pred["pred_up"]),
        pred_down_qt=tqm.flat_quantize(pred["pred_down"]),
        pred_up_b_all=pred["pred_up_b"], pred_down_b_all=pred["pred_down_b"])
    return LoadedModel(config=model.config, params=params)


def _steps(eng, n):
    """Prefill PROMPT into a cache of the caller's own, then n greedy decode
    steps: (tokens, each step's logits on the CPU)."""
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n_past = eng.prefill(PROMPT, cache, st)
    toks, logits = [tok], []
    for i in range(n):
        tok, cache, st = eng.decode_step(tok, n_past + i, cache, st)
        toks.append(tok)
        logits.append(eng.last_logits.float().cpu().clone())
    return toks, logits


def _serve(sched, prompts=PROMPTS, n_new=6):
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    sched.run_until_idle()
    return [r.tokens() for r in reqs]


# ---------------------------------------------------------------------------
# CPU: the static-buffer step, run eagerly, against the JAX package


@pytest.mark.parametrize("owner", ["engine", "scheduler"])
def test_cuda_graph_true_on_the_cpu_raises(gguf, owner):
    model = load_model(gguf, dtype=torch.float32, device="cpu")
    make = Engine if owner == "engine" else Scheduler
    with pytest.raises(ValueError, match="cuda_graph"):
        make(model, device="cpu", cuda_graph=True)
    assert make(model, device="cpu", cuda_graph=False).graphs.capture is False
    assert make(model, device="cpu").graphs.capture is False


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sparkinfer_tpu.models.loader import load_model as jax_load
    from sparkinfer_tpu.runtime.engine import Engine as JaxEngine
    from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler
    from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig

    return jax, jnp, jax_load, JaxEngine, JaxSampler, JaxSparseConfig


@pytest.mark.parametrize("kind", ["dense", "v6", "gather"])
def test_static_buffer_step_matches_jax(gguf, kind):
    _, jnp, jax_load, JaxEngine, JaxSampler, JaxSparseConfig = _jax()
    je = JaxEngine(jax_load(gguf, dtype=jnp.float32), max_seq=64, sampler=JaxSampler(temp=0.0),
                   kv_dtype=jnp.float32,
                   sparse=None if kind == "dense" else JaxSparseConfig(G, CAP),
                   sparse_decode_mode="gather" if kind == "gather" else "pallas")
    pe = _engine(gguf, "cpu", kind)
    n = 7
    toks, logits = _steps(pe, n)
    # the JAX Engine's own forwards, fed the port's tokens
    cache = je.new_cache()
    pos = jnp.arange(len(PROMPT), dtype=jnp.int32)[None]
    lg, cache = je.fwd_prefill(je.model.params, jnp.asarray([PROMPT], jnp.int32), pos, cache)
    assert int(jnp.argmax(lg[0, -1])) == toks[0]
    for i in range(n):
        lg, cache = je.fwd_decode(je.model.params, jnp.asarray([[toks[i]]], jnp.int32),
                                  jnp.asarray([[len(PROMPT) + i]], jnp.int32), cache)
        ref = np.asarray(lg[:, -1])
        err = np.abs(logits[i].numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (i, err)
        assert int(np.argmax(ref[0])) == toks[i + 1]
    got = pe.generate(PROMPT, 8)
    assert got == je.generate(PROMPT, 8)
    # generate's 7 steps ran over the static buffers of its cache's step,
    # which hold the last step's inputs
    step = pe.graphs.get(pe.cache, 1, "decode", None)
    assert step.tokens.tolist() == [[got[6]]]
    assert step.positions.tolist() == [[len(PROMPT) + 6]]


def test_generate_reuses_one_cache(gguf):
    pe = _engine(gguf, "cpu", "v6")
    a = pe.generate(PROMPT, 8)
    cache = pe.cache
    assert pe.generate(PROMPT, 8) == a and pe.cache is cache
    assert pe.generate([7, 1], 5) == _engine(gguf, "cpu", "v6").generate([7, 1], 5)
    assert pe.generate(PROMPT, 8) == a and pe.cache is cache
    assert pe.perf.n_decode == 7 + 7 + 4 + 7


def test_caller_caches_keep_a_few_steps(gguf):
    pe = _engine(gguf, "cpu", "dense")
    want = pe.generate(PROMPT, 4)
    for _ in range(pe.GRAPHS + 2):
        assert _steps(pe, 3)[0] == want
    assert len(pe.graphs) == pe.GRAPHS


def test_sampled_steps_draw_from_the_engine_generator(gguf):
    pe = _engine(gguf, "cpu", "v6", sampler=SAMPLED)
    assert pe.generate(PROMPT, 8, seed=3) == pe.generate(PROMPT, 8, seed=3)
    assert pe.new_sampler_state(1) is pe.generator
    cache = pe.new_cache()
    with pytest.raises(ValueError, match="generator"):
        pe.decode_step(5, 3, cache, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("bmax", [100, 0, 1], ids=["sparse_v1", "dense_fallback", "mixed"])
def test_static_buffer_tick_matches_jax(gguf, bmax):
    """4 prompts on 2 slots, greedy, requests of 6, 2, 6 and 3 new tokens:
    the JAX Scheduler's streams. "mixed" takes the sparse tick with one slot
    running and the masked-dense tick with two, so both static steps run."""
    _, jnp, jax_load, _, JaxSampler, JaxSparseConfig = _jax()
    from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest
    from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler

    js = JaxScheduler(jax_load(gguf, dtype=jnp.float32), n_slots=2, max_seq=64,
                      sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                      sparse=JaxSparseConfig(G, CAP), sparse_batch_max=bmax)
    news = (6, 2, 6, 3)
    jreqs = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=n))
             for p, n in zip(PROMPTS, news)]
    js.run_until_idle()
    sched = Scheduler(load_model(gguf, dtype=torch.float32, device="cpu"), n_slots=2,
                      max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
                      sparse=SparseConfig(G, CAP), sparse_batch_max=bmax, device="cpu")
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n))
            for p, n in zip(PROMPTS, news)]
    sched.run_until_idle()
    assert [r.tokens() for r in reqs] == [r.tokens() for r in jreqs]
    m = sched.metrics_snapshot()
    ticks, dense = m["n_decode_steps"], m["n_dense_steps"]
    want = {100: (0, 0), 0: (ticks, ticks), 1: (1, ticks - 1)}[bmax]
    assert want[0] <= dense <= want[1] and len(sched.graphs) == (2 if bmax == 1 else 1)


# ---------------------------------------------------------------------------
# card: the graph against the eager step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counts():
    return [w.launches for w in graphs.COUNTED]


def _engines(kind, gguf, q8_gguf, sampler=GREEDY):
    """A graph engine and an eager engine over the same params."""
    if kind == "v6q":
        model = _q8_model(q8_gguf, "cuda")
        kw = dict(max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                  sparse=SparseConfig(GQ, CAPQ), sparse_preprepared=True, device="cuda")
        return Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    eng = _engine(gguf, "cuda", kind, sampler=sampler)
    model = LoadedModel(config=eng.cfg, params=eng.params)
    kw = dict(max_seq=64, sampler=sampler, kv_dtype=torch.float32, device="cuda",
              cuda_graph=False)
    if kind != "dense":
        kw.update(sparse=SparseConfig(G, CAP), sparse_preprepared=True)
    return eng, Engine(model, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "v6", "v6q"])
def test_graph_step_equals_the_eager_step(cuda, gguf, q8_gguf, kind):
    graph_eng, eager = _engines(kind, gguf, q8_gguf)
    assert graph_eng.graphs.capture and not eager.graphs.capture
    runs = {}
    for name, eng in (("eager", eager), ("graph", graph_eng)):
        c0 = _counts()
        toks, logits = _steps(eng, 6)
        runs[name] = (toks, logits, [b - a for a, b in zip(c0, _counts())])
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    # the eager run launched each kernel at 6 steps and the prefill; the
    # graph run also at its warm-up, every replay credited
    # the counters: the graph run's launches are the eager run's and one
    # step's more, its warm-up's (every replay credited)
    assert graph_eng.graphs.captures == 1
    per_step = _per_step(eager)
    assert [g - e for g, e in zip(runs["graph"][2], runs["eager"][2])] == per_step
    assert any(per_step) == (kind != "dense")


def _per_step(eng):
    """The launches of one eager decode step of `eng`, by counted wrapper."""
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(PROMPT, cache, st)
    c0 = _counts()
    eng.decode_step(tok, n, cache, st)
    return [b - a for a, b in zip(c0, _counts())]


@pytest.mark.cuda
@pytest.mark.parametrize("bmax", [100, 0], ids=["v1", "dense_fallback"])
def test_graph_tick_equals_the_eager_tick(cuda, gguf, bmax):
    model = load_model(gguf, dtype=torch.float32, device="cuda")
    kw = dict(n_slots=2, max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
              sparse=SparseConfig(G, CAP), sparse_batch_max=bmax, device="cuda")
    runs = {}
    for name, cg in (("eager", False), ("graph", None)):
        sched = Scheduler(model, cuda_graph=cg, **kw)
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS]
        c0 = _counts()
        sched.step()
        first = sched.last_logits.clone()
        sched.run_until_idle()
        ticks = sched.metrics_snapshot()["n_decode_steps"]
        runs[name] = ([r.tokens() for r in reqs], first, ticks,
                      [b - a for a, b in zip(c0, _counts())], sched.graphs.captures)
    assert runs["graph"][0] == runs["eager"][0]
    assert torch.equal(runs["graph"][1], runs["eager"][1])
    assert runs["graph"][2] == runs["eager"][2] and runs["graph"][4] == 1
    v1 = graphs.COUNTED.index(sparse_ffn_block)
    L = model.config.n_layer
    ticks = runs["eager"][2]
    assert runs["eager"][3][v1] == (L * ticks if bmax else 0)
    assert runs["graph"][3][v1] == (L * (ticks + 1) if bmax else 0)  # + the warm-up


@pytest.mark.cuda
def test_two_generates_capture_once(cuda, gguf):
    eng = _engine(gguf, "cuda", "v6")
    a = eng.generate(PROMPT, 8)
    assert eng.generate(PROMPT, 8) == a and eng.generate(PROMPT, 8) == a
    assert eng.graphs.captures == 1
    assert eng.graphs.captured[0]["pool_bytes"] >= 0


@pytest.mark.cuda
def test_sampled_graph_stream_is_seeded(cuda, gguf):
    graph_eng, eager = _engines("v6", gguf, None, sampler=SAMPLED)
    a = graph_eng.generate(PROMPT, 12, seed=3)
    assert graph_eng.generate(PROMPT, 12, seed=3) == a
    assert eager.generate(PROMPT, 12, seed=3) == a
    assert graph_eng.generate(PROMPT, 12, seed=4) == eager.generate(PROMPT, 12, seed=4)
    assert graph_eng.graphs.captures == 1


FRESH = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
from test_torch_cuda_graph import GREEDY, PROMPTS, _engine, _q8_model, _serve
from sparkinfer_tpu_torch.runtime.engine import Engine
from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
from sparkinfer_tpu_torch.sparse.config import SparseConfig

# the first call of every kernel in this process is a graph's warm-up
gguf, q8 = sys.argv[2], sys.argv[3]
assert len(_engine(gguf, "cuda", "v6").generate([5, 9, 42], 4)) == 4
eng = Engine(_q8_model(q8, "cuda"), max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
             sparse=SparseConfig(32, 2), sparse_preprepared=True, device="cuda")
# a 6-token prompt prefills through qmm_prefill, so the warm-up makes
# qmm_decode's first call (and allocates its workspace)
assert len(eng.generate([5, 9, 42, 7, 1, 3], 4)) == 4 and eng.graphs.captures == 1
from sparkinfer_tpu_torch.models.loader import load_model
sched = Scheduler(load_model(gguf, dtype=torch.float32, device="cuda"), n_slots=2, max_seq=64,
                  sampler=GREEDY, kv_dtype=torch.float32, sparse=SparseConfig(16, 4),
                  sparse_batch_max=100, device="cuda")
assert all(len(t) == 6 for t in _serve(sched)) and sched.graphs.captures == 1
print("fresh ok")
"""


@pytest.mark.cuda
def test_a_fresh_process_captures_its_first_step(cuda, gguf, q8_gguf):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", FRESH, str(ROOT / "tests"), gguf, q8_gguf],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "fresh ok" in out.stdout
    assert out.stderr.count("cuda graph: captured") == 3, out.stderr[-4000:]
