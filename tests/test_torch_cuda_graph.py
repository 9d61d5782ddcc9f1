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
such as a stale static buffer) for dense, v6, v6q (with quant_matmul), v6q
with W8A8 attention and predictor stacks (torch._int_mm), the Scheduler's v1 tick and its masked-dense fallback; the launch counters
credited per replay; one capture for two `generate` calls; a sampled
engine's seeded stream; a fresh process's first captured step; and the
Scheduler's first capture while another thread works on the card: the
server's router loading a second model, or an allocation, a copy and a
matmul that take no lock. Rewrites between replays: the replayed step after
a context shift and after a self-extend firing bit-equal to the eager step;
the verify graph (T = 6) bit-equal to its eager forward, and speculative
decoding over it lossless; a slot restore capturing nothing new; a LoRA
re-merge reaching the graphs of the dense and v6 engines and of the v1
Scheduler. The iSWA decode step (rings rebuilt from the static position
buffer on the device) of a tiny gemma2 and of a tiny gpt-oss through v1,
across ring wraps, bit-equal to the eager step. The MLA decode step of a
tiny deepseek2 (latent cache, layer segments) in dense and "pallas" MoE
mode, bit-equal to the eager step. The same for a tiny qwen2moe and
hunyuan-moe (tests/arch_fixture.py) in both modes, and for a tiny bloom
(ALiBi, the post-embedding LayerNorm) in bf16 and in Q8_0 (its six packed
linears through quant_matmul_2d), past a context shift, and its 2-slot
Scheduler's tick. The same for tests/arch_fixture.py:make_feature's olmo2
(post-norms only) in bf16 and in Q8_0, apertus (xIELU), and deci (a layer
of 1 KV head under a cache of 2, written through a narrowed view, and an
attention-free layer). The same for each of 15g's trait archs
(tests/arch_fixture.py TRAIT_KINDS: granite, minicpm, pangu-embedded,
plamo, starcoder2, command-r, phi3) in bf16. The non-causal encoders
(tests/arch_fixture.py:make_encoder: bert in Q8_0, neo-bert and
gemma-embedding in f32): the Embedder's hidden states on the card against
the CPU's.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from arch_fixture import (  # noqa: E402
    ENCODER_KINDS,
    TRAIT_KINDS,
    make_arch,
    make_encoder,
    make_feature,
)
from deepseek2_fixture import make_deepseek2  # noqa: E402
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


def _q8_model(path, device, w8a8=False):
    """Q8_0 attention and head, Q8_0 flat FFN stores and Q8_0 predictor
    stacks, as tests/test_torch_engine.py builds them, with the port alone;
    w8a8=True makes the attention (`attn_w8a8`) and the predictor stacks
    W8A8 instead, over the same Q8_0 flat FFN stores, the head dense."""
    model = load_model(path, dtype=torch.float32, device=device, keep_quantized=not w8a8,
                       attn_w8a8=w8a8)
    dense = load_model(path, dtype=torch.float32, device=device).params["layers"]
    layers = dict(model.params["layers"])
    layers.update({k: dense[k] for k in ("w_up", "w_gate", "w_down")})
    pred = {k: layers.pop(k) for k in PRED}
    params = tffn.prepare_pipelined_params(dict(model.params, layers=layers), model.config,
                                           SparseConfig(GQ, CAPQ), drop_dense=True,
                                           layout="v6", quant="q8_0")
    if w8a8:
        params["sparse_flat"].update(pred_up_w8=tqm.W8A8Tensor.from_float(pred["pred_up"]),
                                     pred_down_w8=tqm.W8A8Tensor.from_float(pred["pred_down"]))
    else:
        params["sparse_flat"].update(pred_up_qt=tqm.flat_quantize(pred["pred_up"]),
                                     pred_down_qt=tqm.flat_quantize(pred["pred_down"]))
    params["sparse_flat"].update(pred_up_b_all=pred["pred_up_b"],
                                 pred_down_b_all=pred["pred_down_b"])
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
    st = pe.new_sampler_state(1)
    assert st is pe.sstate and st.gen is pe.generator
    cache = pe.new_cache()
    other = _engine(gguf, "cpu", "v6", sampler=SAMPLED).new_sampler_state(1)
    with pytest.raises(ValueError, match="generator"):
        pe.decode_step(5, 3, cache, other)


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
    if kind in ("v6q", "w8a8"):
        model = _q8_model(q8_gguf, "cuda", w8a8=kind == "w8a8")
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
@pytest.mark.parametrize("kind", ["dense", "v6", "v6q", "w8a8"])
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


@pytest.fixture(scope="module")
def moe_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-qwen3moe.gguf"
    rng = np.random.default_rng(11)
    norms = {f"blk.{i}.attn_{qk}_norm.weight": 1.0 + 0.2 * rng.standard_normal(16)
             for i in range(2) for qk in ("q", "k")}
    make_tiny_llama(path, arch="qwen3moe", n_expert=8, n_expert_used=3, n_ff=32, seed=3,
                    extra_tensors=norms)
    return str(path)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "pallas"])
def test_moe_graph_step_equals_the_eager_step(cuda, moe_gguf, mode):
    """A qwen3moe Engine in each moe_mode: the decode graph against the eager
    step over the same model, greedy streams equal and every step's logits
    bit-equal (routing, its top-k and the expert rows run inside the
    graph); in "pallas" mode v1 once a layer a step, in "dense" none."""
    model = load_model(moe_gguf, dtype=torch.float32, device="cuda")
    kw = dict(max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cuda",
              moe_mode=mode)
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {}
    for name, eng in (("eager", eager), ("graph", graph_eng)):
        toks, logits = _steps(eng, 6)
        runs[name] = (toks, logits)
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    v1 = graphs.COUNTED.index(sparse_ffn_block)
    assert _per_step(eager)[v1] == (model.config.n_layer if mode == "pallas" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode", [("qwen2moe", "dense"), ("qwen2moe", "pallas"),
                                       ("hunyuan-moe", "dense"), ("hunyuan-moe", "pallas")])
def test_arch_graph_step_equals_the_eager_step(cuda, tmp_path, kind, mode):
    """A qwen2moe (qkv biases, a shared expert with its sigmoid gate, no
    top-k renormalization) and a hunyuan-moe (q/k norms after rope, an
    ungated shared expert) of tests/arch_fixture.py in each moe_mode: the
    decode graph's greedy stream and every step's logits bit-equal to the
    eager step's, one capture, and v1 once a layer a step in "pallas"."""
    make_arch(tmp_path / "m.gguf", kind, seed=7)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.float32, device="cuda")
    kw = dict(max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cuda",
              moe_mode=mode)
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {label: _steps(eng, 8) for label, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    v1 = graphs.COUNTED.index(sparse_ffn_block)
    assert _per_step(eager)[v1] == (model.config.n_layer if mode == "pallas" else 0)


def swa_gguf(path, name):
    """A tiny gemma2 (softcaps, sandwich norms) or gpt-oss (sinks, q/k/v and
    output biases, 4 experts of width 64 with their biases, the router's
    bias, softmax over the 2 selected) GGUF, window 8 on alternate layers."""
    rng = np.random.default_rng(12)
    if name == "gemma2":
        post = {f"blk.{i}.{n}_post_norm.weight": 1.0 + 0.1 * rng.standard_normal(64)
                for i in range(4) for n in ("attn", "ffn")}
        make_tiny_llama(path, arch="gemma2", n_layer=4, seed=6, extra_tensors=post,
                        extra_kv={"gemma2.attention.sliding_window": np.uint32(8)})
        return
    t = {}
    for i in range(2):
        t[f"blk.{i}.attn_sinks.weight"] = rng.standard_normal(4)
        for nm, n in (("q", 64), ("k", 32), ("v", 32), ("output", 64)):
            t[f"blk.{i}.attn_{nm}.bias"] = 0.1 * rng.standard_normal(n)
        for nm in ("up", "gate", "down"):
            t[f"blk.{i}.ffn_{nm}_exps.bias"] = 0.1 * rng.standard_normal((4, 64))
        t[f"blk.{i}.ffn_gate_inp.bias"] = 0.1 * rng.standard_normal(4)
    make_tiny_llama(path, arch="gpt-oss", n_expert=4, n_expert_used=2, n_ff=64, seed=8,
                    extra_tensors=t,
                    extra_kv={"gpt-oss.attention.sliding_window": np.uint32(8),
                              "gpt-oss.expert_gating_func": 3,
                              "gpt-oss.expert_weights_norm": False})


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", [("gemma2", "dense"), ("gpt-oss", "pallas")])
def test_iswa_graph_step_equals_the_eager_step(cuda, tmp_path, name, mode):
    """Engine(kv_iswa=True) with prefill_chunk 4 (rings of 12 slots), 24
    decode steps past two ring wraps: the graph's greedy stream and every
    step's logits bit-equal to the eager step's, one capture, and in
    "pallas" mode v1 once a layer a step."""
    swa_gguf(tmp_path / "m.gguf", name)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.float32, device="cuda")
    kw = dict(max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cuda",
              kv_iswa=True, moe_mode=mode)
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {}
    for label, eng in (("eager", eager), ("graph", graph_eng)):
        eng.prefill_chunk = 4
        runs[label] = _steps(eng, 24)
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    assert [a.shape[2] for a in eager.new_cache().k] == [12, 64, 12, 64][:len(eager.cfg.swa_layers)]
    v1 = graphs.COUNTED.index(sparse_ffn_block)
    assert _per_step(eager)[v1] == (model.config.n_layer if mode == "pallas" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "pallas"])
def test_mla_graph_step_equals_the_eager_step(cuda, tmp_path, mode):
    """A tiny deepseek2 Engine (the q-lora, the latent cache, a leading dense
    layer and two MoE layers in segments) in each moe_mode: the decode
    graph's greedy stream and every step's logits bit-equal to the eager
    step's, one capture, and in "pallas" mode v1 once an MoE layer a step."""
    make_deepseek2(tmp_path / "ds.gguf", q_lora=24, seed=9)
    model = load_model(str(tmp_path / "ds.gguf"), dtype=torch.float32, device="cuda")
    kw = dict(max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cuda",
              moe_mode=mode)
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {label: _steps(eng, 8) for label, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    cache = eager.new_cache()
    assert cache.k.shape[-2:] == (1, 32 + 8) and cache.v.shape[-1] == 0
    v1 = graphs.COUNTED.index(sparse_ffn_block)
    assert _per_step(eager)[v1] == (2 if mode == "pallas" else 0)


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


@pytest.mark.cuda
@pytest.mark.parametrize("other", ["router_load", "unlocked_cuda_work"])
def test_capture_while_another_thread_uses_the_card(cuda, tmp_path, monkeypatch, other):
    """The Scheduler's first tick is captured while another thread works on
    the card: the server's router loading a second model from a handler
    thread (it waits on CAPTURE_LOCK until the capture ends), or an
    allocation, a copy and a matmul that take no lock (the capture is
    thread-local, so they neither join nor invalidate it). The graphed
    ticks give the eager Scheduler's streams; the routed model serves."""
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    monkeypatch.setenv("SPIF_SPARSE_BATCH_MAX", "100")  # the server's ticks: v1
    path = tmp_path / "tiny-prosparse-vocab.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5, n_vocab=300,
                    with_vocab=True)
    model = load_model(str(path), dtype=torch.float32, device="cuda")
    kw = dict(n_slots=2, max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
              sparse=SparseConfig(G, CAP), sparse_batch_max=100, device="cuda")
    want = _serve(Scheduler(model, cuda_graph=False, **kw))
    srv = SparkServer(model, ServerConfig(port=0, n_slots=2, max_seq=64, kv_dtype="f32",
                                          sparse=SparseConfig(G, CAP),
                                          extra_models={"second": str(path)}),
                      sampler=GREEDY)
    sched = srv.sched
    capturing, done = threading.Event(), threading.Event()
    make_tick = sched._tick_fn

    def hooked_tick_fn(fwd):
        tick = make_tick(fwd)

        def hooked(tokens, positions):
            if torch.cuda.is_current_stream_capturing():
                capturing.set()
                if other == "unlocked_cuda_work":
                    assert done.wait(120)  # the other thread's work lands mid-capture
                else:
                    time.sleep(0.5)  # the router's load waits on CAPTURE_LOCK meanwhile
            return tick(tokens, positions)

        return hooked

    sched._tick_fn = hooked_tick_fn
    result = {}

    def work():
        try:
            assert capturing.wait(120)
            if other == "router_load":
                result["backend"] = srv._backend_for({"model": "second"})
                result["captures_then"] = sched.graphs.captures
            else:
                big = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
                x = (torch.arange(4096) % 7).float().to("cuda").reshape(64, 64)
                result["sum"] = float((x @ x).sum().item())
                del big
        except BaseException as e:  # noqa: BLE001 - asserted below
            result["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=work)
    t.start()
    try:
        got = _serve(sched)
        t.join(timeout=300)
        assert "error" not in result, result.get("error")
        assert got == want and sched.graphs.captures == 1
        if other == "router_load":
            assert result["captures_then"] == 1  # the load ran after the capture
            be_sched = result["backend"][0]
            req = be_sched.submit(Request(prompt_tokens=PROMPTS[0], max_new_tokens=6,
                                          sampler=GREEDY))
            assert len(req.tokens()) == 6
        else:
            x = (np.arange(4096) % 7).astype(np.float64).reshape(64, 64)
            assert result["sum"] == float((x @ x).sum())
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# card: the tiered decode (sparse/tiering.py, sparse/balancer.py)


def _tiered(path, device, mode, **kw):
    return Engine(load_model(path, dtype=torch.float32, device=device), max_seq=64,
                  sampler=GREEDY, kv_dtype=torch.float32,
                  sparse=SparseConfig(G, CAP, hot_groups=2), sparse_cold_mode=mode,
                  device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fetch", "drop"])
def test_tiered_graph_equals_eager_after_swaps(cuda, gguf, mode):
    """The tiered step as a graph against the eager step, each engine with its
    own hot store swapped in place after every step: equal streams and
    bit-equal logits at every step, so no replay read a stale or half-written
    store; one v6 launch a layer a step."""
    graph_eng, eager = _tiered(gguf, "cuda", mode), _tiered(gguf, "cuda", mode,
                                                             cuda_graph=False)
    runs = {}
    for name, eng in (("eager", eager), ("graph", graph_eng)):
        c0 = _counts()
        toks, logits = _steps(eng, 12)
        runs[name] = (toks, logits, [b - a for a, b in zip(c0, _counts())])
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1 and graph_eng.balancer.total_swaps > 0
    assert torch.equal(graph_eng.tiered_params.hot_ids, eager.tiered_params.hot_ids)
    assert torch.equal(graph_eng.fstate.dfr, eager.fstate.dfr)  # the warm-up undone
    v6 = graphs.COUNTED.index(tffn.sparse_ffn_block_v6)
    L = graph_eng.cfg.n_layer
    assert runs["eager"][2][v6] == 12 * L and runs["graph"][2][v6] == 13 * L


@pytest.mark.cuda
def test_tiered_host_mode_on_the_card_equals_the_cpu(cuda, gguf):
    """Host mode on the card (eager; pinned copies to and from the host
    library at every layer) against host mode on the CPU: equal streams."""
    on_card = _tiered(gguf, "cuda", "host")
    assert not on_card.graphs.capture
    want = _tiered(gguf, "cpu", "host").generate(PROMPT, 12)
    assert on_card.generate(PROMPT, 12) == want
    assert on_card.cold.n_calls == 11 * on_card.cfg.n_layer


@pytest.mark.cuda
def test_cold_store_complement_from_the_card(cuda, gguf):
    """ColdStore.complement of card tensors (the library over pinned copies)
    against the plain version on the CPU: within 1e-5 of its scale."""
    from sparkinfer_tpu_torch import native
    from sparkinfer_tpu_torch.sparse.tiering import ColdStore

    eng = _engine(gguf, "cpu", "gather", sparse_pipelined=False)
    rows = {k: v for k, v in eng.params["layers"].items() if k.endswith("_rows")}
    cold = ColdStore(eng.cfg, SparseConfig(G, CAP), rows, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((5, eng.cfg.n_embd), generator=gen)
    probs = torch.rand((5, 6, G), generator=gen)
    cold_active = torch.rand((5, 6), generator=gen) < 0.5
    for il in range(eng.cfg.n_layer):
        got = cold.complement(il, x.cuda(), probs.cuda(), cold_active.cuda())
        assert got.device.type == "cuda"
        want = native.sparse_complement_plain(x, cold.up[il], cold.gate[il], cold.down[il],
                                              None, probs, cold_active, cold.act,
                                              cold.fatrelu_threshold, 0.5)
        assert (got.cpu() - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
def test_tiered_prefill_pins_one_staging_set(cuda, gguf):
    """Host-mode tiered prefill calls the cold store's complement with N =
    the prompt's length: five lengths served one after another leave one
    pinned staging set, sized for the longest prompt (x, probabilities,
    out: f32 rows; cold_active: bool), not a set a length."""
    sched = Scheduler(load_model(gguf, dtype=torch.float32, device="cuda"), n_slots=2,
                      max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
                      sparse=SparseConfig(G, CAP, hot_groups=2), sparse_cold_mode="host",
                      prefill_mode="tiered", device="cuda")
    lengths = (7, 3, 12, 5, 9)
    for n in lengths:
        req = sched.submit(Request(prompt_tokens=[(13 * n + 11 * i) % 199 for i in range(n)],
                                   max_new_tokens=3))
        sched.run_until_idle()
        assert len(req.tokens()) == 3
    E, ng = sched.cfg.n_embd, SparseConfig(G, CAP).n_groups(sched.cfg.n_ff)
    assert sched.cold.staging.nbytes == max(lengths) * ((2 * E + ng * G) * 4 + ng)


# ---------------------------------------------------------------------------
# Cache and weight rewrites between replays: context shift, self-extend,
# the verify graph, a slot restore and a LoRA re-merge


def _pair(gguf, kind, **kw):
    """A graph engine and an eager engine over the same params ("dense" or
    "v6", the sparse pipelined FFN over the flat stores)."""
    sparse = None if kind == "dense" else SparseConfig(G, CAP)
    model = load_model(gguf, dtype=torch.float32, device="cuda")
    graph_eng = Engine(model, sampler=GREEDY, kv_dtype=torch.float32, sparse=sparse,
                       device="cuda", **kw)
    extra = {} if sparse is None else dict(sparse=sparse, sparse_preprepared=True)
    eager = Engine(LoadedModel(config=graph_eng.cfg, params=graph_eng.params), sampler=GREEDY,
                   kv_dtype=torch.float32, device="cuda", cuda_graph=False, **extra, **kw)
    return graph_eng, eager


def _stream_logits(eng, prompt, n, **kw):
    toks, logits = [], []
    for t in eng.generate(prompt, n, stream=True, **kw):
        toks.append(t)
        logits.append(eng.last_logits.clone())
    return toks, logits


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "v6"])
@pytest.mark.parametrize("what", ["context_shift", "self_extend"])
def test_replay_after_a_cache_rewrite_equals_the_eager_step(cuda, gguf, kind, what):
    """A context shift (max_seq 16, keep 2) or a self-extend firing ((2, 8))
    rewrites the cache's rows in place between steps: every replayed step
    after it has the eager step's logits bit for bit, with one capture."""
    if what == "context_shift":
        kw, gen_kw, n = dict(max_seq=16), dict(n_keep=2), 40
    else:
        kw, gen_kw, n = dict(max_seq=64, self_extend=(2, 8)), {}, 50
    graph_eng, eager = _pair(gguf, kind, **kw)
    runs = {name: _stream_logits(eng, PROMPT, n, **gen_kw)
            for name, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0] and len(runs["graph"][0]) == n
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    if what == "self_extend":
        assert graph_eng.self_extend.gamma > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "v6"])
def test_verify_graph_equals_its_eager_forward(cuda, gguf, kind):
    """Engine.verify over 6 tokens (T = K+1 = 6: v6 at N = 6) replays its own
    graph: logits and argmax bit-equal to the eager forward's at 3
    positions, one capture; a speculative run over it stays lossless."""
    from sparkinfer_tpu_torch.runtime.speculative import SpeculativeEngine

    graph_eng, eager = _pair(gguf, kind, max_seq=64)
    outs = {}
    for name, eng in (("graph", graph_eng), ("eager", eager)):
        cache, st = eng.own_cache(), eng.new_sampler_state()
        tok, cache, st, n = eng.prefill(PROMPT, cache, st)
        res = []
        for r in range(3):
            logits, am = eng.verify([tok, 7, 9, 11, 13, 15], n + 6 * r, cache)
            res.append((logits.clone(), am.clone()))
        outs[name] = res
    for (gl, ga), (el, ea) in zip(outs["graph"], outs["eager"]):
        assert torch.equal(gl, el) and torch.equal(ga, ea)
    assert graph_eng.graphs.captures == 1
    draft = Engine(load_model(gguf, dtype=torch.float32, device="cuda"), max_seq=64,
                   sampler=GREEDY, kv_dtype=torch.float32, device="cuda")
    spec = SpeculativeEngine(graph_eng, draft, n_draft=5)
    assert spec.generate(PROMPT, 24) == graph_eng.generate(PROMPT, 24)
    assert spec.stats.accept_rate == 1.0 or kind == "v6"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "v6"])
def test_int8_graph_step_equals_the_eager_step(cuda, gguf, kind):
    """The Engine over the int8 KV cache (codes and scales written and read
    in place by the step): the decode graph's stream and every step's
    logits bit-equal to the eager step's, past a context shift (max_seq 16,
    keep 2), one capture."""
    graph_eng, eager = _pair(gguf, kind, max_seq=16, kv_quantized=True)
    runs = {name: _stream_logits(eng, PROMPT, 40, n_keep=2)
            for name, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0] and len(runs["graph"][0]) == 40
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1 and graph_eng.cache.quantized
    assert graph_eng.cache.k.dtype == torch.int8 and graph_eng.cache.k_scale.any()


def shift_slots(sched, keep: int, discard: int):
    """A context shift of every slot of the Scheduler's cache, between
    ticks (the running slots share one n_past): rows [keep, keep + discard)
    dropped, the rest slid down and re-roped; the running slots' n_past and
    token histories moved with them."""
    from sparkinfer_tpu_torch.models.transformer import rope_params
    from sparkinfer_tpu_torch.runtime.kv_cache import shift_cache

    n_past = {s.n_past for s in sched.slots if s.running}
    assert len(n_past) == 1, n_past
    shift_cache(sched.cache, rope_params(sched.cfg), keep, discard, n_past.pop())
    for s in sched.slots:
        if s.running:
            s.n_past -= discard
            s.cached_tokens = s.cached_tokens[:keep] + s.cached_tokens[keep + discard:]


def _running_logits(sched):
    """The last tick's logits of the running slots."""
    return sched.last_logits[[i for i, s in enumerate(sched.slots) if s.running]].clone()


@pytest.mark.cuda
def test_int8_tick_after_a_shift_and_a_restore_equals_the_eager_tick(cuda, gguf, tmp_path):
    """Two v1 Schedulers over int8 caches, one replaying its tick's graph,
    one eager: the same requests, a context shift of both caches between
    ticks, then a slot saved, zeroed and restored into another slot: the
    first tick after each rewrite has the eager tick's logits bit for bit
    in every running slot, and the streams are equal, with one capture."""
    model = load_model(gguf, dtype=torch.float32, device="cuda")
    kw = dict(n_slots=3, max_seq=32, sampler=GREEDY, sparse=SparseConfig(G, CAP),
              sparse_batch_max=100, kv_quantized=True, device="cuda")
    prompts = [[(7 * j + 3 * i) % 199 for i in range(6)] for j in range(3)]
    out = {}
    for name, cg in (("eager", False), ("graph", None)):
        sched = Scheduler(model, cuda_graph=cg, **kw)
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=24)) for p in prompts]
        for _ in range(14):
            sched.step()
        shift_slots(sched, 2, 12)
        sched.step()
        logits = [_running_logits(sched)]
        sched.run_until_idle()
        toks = [r.tokens() for r in reqs]
        f = tmp_path / f"{name}.state"
        sched.save_slot(0, str(f))
        sched.slots[0].cached_tokens = []
        for buf in sched.cache.buffers():
            buf[:, 0].zero_()
        sched.restore_slot(2, str(f))
        sched.slot_similarity = 0.5  # to the restored slot, its prefix reused
        cont = sched.submit(Request(prompt_tokens=sched.slots[2].cached_tokens + [5, 6],
                                    max_new_tokens=6))
        sched.step()
        logits.append(_running_logits(sched))
        sched.run_until_idle()
        out[name] = (toks + [cont.tokens()], logits, sched.graphs.captures)
    assert out["graph"][0] == out["eager"][0] and all(len(t) == 24 for t in out["graph"][0][:3])
    for got, want in zip(out["graph"][1], out["eager"][1]):
        assert torch.equal(got, want)
    assert out["graph"][2] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3", "plm"])
def test_minicpm3_graph_step_equals_the_eager_step(cuda, tmp_path, arch):
    """A tiny minicpm3 (the q-lora, neox rope, the embedding, residual and
    logit multipliers) and plm (a direct q, an ungated relu² FFN) over the
    latent cache: the decode graph's stream and every step's logits
    bit-equal to the eager step's, one capture."""
    from deepseek2_fixture import make_mla_arch

    make_mla_arch(tmp_path / "m.gguf", arch, scales=arch == "minicpm3", seed=9)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.float32, device="cuda")
    kw = dict(max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cuda")
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {label: _steps(eng, 8) for label, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0]
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1 and graph_eng.cfg.kv_lora_rank == 32


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["bf16", "q8_0"])
def test_alibi_graph_step_equals_the_eager_step(cuda, tmp_path, quant):
    """The bloom fixture of tests/arch_fixture.py (ALiBi slopes built on the
    card at the forward's first call, the warm-up's, never inside the
    capture) in bf16, and in Q8_0 with its packed q, k, v, o, up, down and
    head: the decode graph's stream and every step's logits bit-equal to
    the eager step's, past a context shift (max_seq 16, keep 2), one
    capture; in Q8_0 quant_matmul_2d seven times a step."""
    q8 = quant == "q8_0"
    make_arch(tmp_path / "m.gguf", "bloom", seed=7, quant_type="q8_0" if q8 else None)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.bfloat16, device="cuda",
                       keep_quantized=q8)
    assert model.config.traits.alibi and "tok_norm_w" in model.params
    kw = dict(max_seq=16, sampler=GREEDY, device="cuda")
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {name: _stream_logits(eng, PROMPT, 40, n_keep=2)
            for name, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0] and len(runs["graph"][0]) == 40
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    q2d = graphs.COUNTED.index(tqm.quant_matmul_2d)
    assert _per_step(eager)[q2d] == (6 * model.config.n_layer + 1 if q8 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["bf16", "q8_0"])
def test_alibi_graph_tick_equals_the_eager_tick(cuda, tmp_path, quant):
    """The bloom fixture on a 2-slot dense Scheduler, four requests (two
    queue): the graph tick's streams and first tick logits bit-equal to the
    eager tick's, as many ticks, one capture."""
    q8 = quant == "q8_0"
    make_arch(tmp_path / "m.gguf", "bloom", seed=7, quant_type="q8_0" if q8 else None)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.bfloat16, device="cuda",
                       keep_quantized=q8)
    runs = {}
    for name, cg in (("eager", False), ("graph", None)):
        sched = Scheduler(model, n_slots=2, max_seq=64, sampler=GREEDY, device="cuda",
                          cuda_graph=cg)
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS]
        sched.step()
        first = sched.last_logits.clone()
        sched.run_until_idle()
        runs[name] = ([r.tokens() for r in reqs], first,
                      sched.metrics_snapshot()["n_decode_steps"], sched.graphs.captures)
    assert runs["graph"][0] == runs["eager"][0] and all(len(t) == 6 for t in runs["graph"][0])
    assert torch.equal(runs["graph"][1], runs["eager"][1])
    assert runs["graph"][2] == runs["eager"][2] and runs["graph"][3] == 1


def _graph_against_eager(model, n=40, **gen_kw):
    """A decode graph's stream and every step's logits against an eager
    engine's, bit for bit, past a context shift (max_seq 16, keep 2): the
    graph engine, after its one capture."""
    kw = dict(max_seq=16, sampler=GREEDY, device="cuda")
    graph_eng, eager = Engine(model, **kw), Engine(model, cuda_graph=False, **kw)
    runs = {name: _stream_logits(eng, PROMPT, n, n_keep=2, **gen_kw)
            for name, eng in (("eager", eager), ("graph", graph_eng))}
    assert runs["graph"][0] == runs["eager"][0] and len(runs["graph"][0]) == n
    for got, want in zip(runs["graph"][1], runs["eager"][1]):
        assert torch.equal(got, want)
    assert graph_eng.graphs.captures == 1
    return graph_eng, eager


@pytest.mark.cuda
@pytest.mark.parametrize("kind,quant", [("olmo2", "bf16"), ("olmo2", "q8_0"),
                                        ("apertus", "bf16")])
def test_feature_graph_step_equals_the_eager_step(cuda, tmp_path, kind, quant):
    """olmo2's post-norm-only blocks (bf16, and Q8_0 with its q, k, v, o, up,
    gate, down and head packed: quant_matmul_2d 7L + 1 times a step) and
    apertus's xIELU: the decode graph's stream and every step's logits
    bit-equal to the eager step's, past a context shift, one capture."""
    q8 = quant == "q8_0"
    make_feature(tmp_path / "m.gguf", kind, seed=7, quant_type="q8_0" if q8 else None)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.bfloat16, device="cuda",
                       keep_quantized=q8)
    lay = model.params["layers"]
    assert ("attn_norm_w" in lay) == (kind != "olmo2") and ("xielu_ap" in lay) == (
        kind == "apertus")
    _, eager = _graph_against_eager(model)
    q2d = graphs.COUNTED.index(tqm.quant_matmul_2d)
    assert _per_step(eager)[q2d] == (7 * model.config.n_layer + 1 if q8 else 0)


@pytest.mark.cuda
def test_deci_graph_step_equals_the_eager_step(cuda, tmp_path):
    """deci's NAS stack (layers of 2, 0 and 1 KV heads over a cache of 2,
    three layer segments) in bf16: the decode graph's stream and every
    step's logits bit-equal to the eager step's past a context shift, one
    capture; the replayed narrowed layer wrote its one head in place and
    left the cache's second head zero, the attention-free layer nothing."""
    make_feature(tmp_path / "m.gguf", "deci", seed=7)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.bfloat16, device="cuda")
    assert len(model.params["layer_segments"]) == 3
    graph_eng, _ = _graph_against_eager(model)
    k = graph_eng.cache.k
    assert bool(k[2, :, :, 0].any()) and not k[2, :, :, 1].any() and not k[1].any()


@pytest.mark.cuda
def test_restore_slot_captures_nothing_new(cuda, gguf, tmp_path):
    """The v1 Scheduler: a slot saved, its rows zeroed, the file restored
    into another slot in place: the tick's graph serves the shared prefix
    from the restored rows (the stream of the never-saved slot), and no
    capture is made."""
    def sched():
        return Scheduler(load_model(gguf, dtype=torch.float32, device="cuda"), n_slots=3,
                         max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
                         sparse=SparseConfig(G, CAP), sparse_batch_max=100,
                         slot_similarity=0.5, device="cuda")

    ref, s = sched(), sched()
    for sc in (ref, s):
        first = _serve(sc, [PROMPT], 6)[0]
    cont = PROMPT + first + [7, 8]
    want = _serve(ref, [cont], 6)[0]
    captures = s.graphs.captures
    f = tmp_path / "slot0.state"
    s.save_slot(0, str(f))
    s.slots[0].cached_tokens = []
    s.cache.k[:, 0].zero_()
    s.cache.v[:, 0].zero_()
    s.restore_slot(2, str(f))
    assert _serve(s, [cont], 6)[0] == want
    assert s.graphs.captures == captures == 1


def _write_lora(path, L, E, F, rank=4, alpha=32.0, seed=0):
    """attn_q and the three FFN projections, written by the port's writer."""
    from sparkinfer_tpu_torch.gguf.constants import GGMLType
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, "llama")
    w.add_kv("general.type", "adapter")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", np.float32(alpha))
    for il in range(L):
        for name, (out_d, in_d) in {"attn_q": (E, E), "ffn_up": (F, E), "ffn_gate": (F, E),
                                    "ffn_down": (E, F)}.items():
            for sfx, shape in (("a", (rank, in_d)), ("b", (out_d, rank))):
                w.add_tensor(f"blk.{il}.{name}.lora_{sfx}",
                             (rng.standard_normal(shape) * 0.05).astype(np.float32),
                             GGMLType.F32)
    w.write()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "v6", "v1_scheduler"])
def test_lora_remerge_reaches_the_graphs(cuda, gguf, tmp_path, kind):
    """A LoRA re-merge writes the dense weights and the stores in place: the
    graphs captured before it decode as a fresh engine on apply_lora's
    params, and scale 0 brings back the base stream, with no new capture."""
    from sparkinfer_tpu_torch.models.lora import LoraMerger, apply_lora

    lora = str(tmp_path / "a.gguf")
    _write_lora(lora, 2, 64, 96)
    model = load_model(gguf, dtype=torch.float32, device="cuda")
    ref = load_model(gguf, dtype=torch.float32, device="cuda")
    ref.params = apply_lora(ref.params, ref.config, lora, 1.0)
    if kind == "v1_scheduler":
        def run(m):
            sc = Scheduler(m, n_slots=2, max_seq=64, sampler=GREEDY, kv_dtype=torch.float32,
                           sparse=SparseConfig(G, CAP), sparse_batch_max=100, device="cuda")
            return sc, lambda: _serve(sc, PROMPTS[:2], 8)
    else:
        def run(m):
            eng = Engine(m, max_seq=64, sampler=GREEDY, kv_dtype=torch.float32, device="cuda",
                         sparse=None if kind == "dense" else SparseConfig(G, CAP))
            return eng, lambda: eng.generate(PROMPT, 12)

    live, go = run(model)
    base = go()
    merger = LoraMerger([model.params, live.params], model.config, [lora])
    merger.merge([1.0])
    for slot in getattr(live, "slots", []):
        slot.cached_tokens = []
    merged = go()
    assert merged == run(ref)[1]() and merged != base
    merger.merge([0.0])
    for slot in getattr(live, "slots", []):
        slot.cached_tokens = []
    assert go() == base
    assert live.graphs.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TRAIT_KINDS)
def test_trait_graph_step_equals_the_eager_step(cuda, tmp_path, kind):
    """The 15g trait archs in bf16 (granite's and minicpm's multipliers,
    pangu-embedded's biases, plamo's and command-r's parallel blocks,
    starcoder2's LayerNorm and FFN biases, phi3): the decode graph's stream
    and every step's logits bit-equal to the eager step's, past a context
    shift, one capture."""
    make_arch(tmp_path / "m.gguf", kind, seed=7)
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.bfloat16, device="cuda")
    assert model.config.arch == kind
    _graph_against_eager(model)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ENCODER_KINDS)
def test_encoder_embedder_on_the_card(cuda, tmp_path, kind):
    """The non-causal encoders' Embedder on the card against the CPU's, 40
    tokens (past gemma-embedding's half window of 4): bert in Q8_0 through
    quant_matmul_2d (qmm_prefill, 6 launches a layer) within 1e-3 of the
    plain CPU path's scale (both round the products' inputs to bf16), the
    f32 neo-bert and gemma-embedding within 1e-4; generation refused by
    name."""
    from sparkinfer_tpu_torch.runtime.embeddings import Embedder

    q8 = kind == "bert"
    make_encoder(tmp_path / "m.gguf", kind, seed=7, quant_type="q8_0" if q8 else None)
    ids = [int(t) for t in np.random.default_rng(3).integers(5, 110, 40)]
    got, want = (Embedder(load_model(str(tmp_path / "m.gguf"), dtype=torch.float32, device=d,
                                     keep_quantized=q8), device=d).hidden(ids)
                 for d in ("cuda", "cpu"))
    before = tqm.quant_matmul_2d.launches
    model = load_model(str(tmp_path / "m.gguf"), dtype=torch.float32, device="cuda",
                       keep_quantized=q8)
    Embedder(model, device="cuda").hidden(ids)
    assert tqm.quant_matmul_2d.launches - before == (12 if q8 else 0)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= (1e-3 if q8 else 1e-4), err
    with pytest.raises(ValueError, match=f"'{kind}'"):
        Engine(model, max_seq=64, device="cuda")
