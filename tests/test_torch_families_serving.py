"""The paper's other sparse families served by the port against the JAX
package, on the CPU: the Q8_0 sparse Engine (v6q over Q8_0 flat stores,
quant_matmul for the predictor stacks and, where the loader keeps them
packed, attention and head), the Scheduler's v1 ticks, the CLI and the
server, and the logits of tiny transformers models converted by the JAX
tools/convert_hf. The GGUFs are test_torch_families.py's (`make_family`);
tolerances as there: greedy streams equal token for token, f32; logits
within 2e-3 of transformers.
"""

import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sparkinfer_tpu.models import loader as jloader  # noqa: E402
from sparkinfer_tpu.ops import quant_matmul as jqm  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402
from test_torch_families import (  # noqa: E402
    CAP,
    FAMILIES,
    KINDS,
    PROMPT,
    PROMPTS,
    G,
    GQ,
    CAPQ,
    _both,
    make_family,
)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for i, kind in enumerate(KINDS):
        out[kind] = str(d / f"{kind}.gguf")
        make_family(out[kind], kind, seed=11 + i)
        # Q8_0 predictor stacks want whole 32-blocks of the rank
        out[kind + "-q8"] = str(d / f"{kind}-q8.gguf")
        make_family(out[kind + "-q8"], kind, rank=32, quant_type="q8_0", seed=21 + i)
    return out


def _q8_model(load, prepare, flat_quantize, scfg, path, **kw):
    """Packed attention and head where the loader keeps them, Q8_0 flat FFN
    stores and Q8_0 predictor stacks from one Q8_0 GGUF, with either
    package's functions."""
    model = load(path, keep_quantized=True, **kw)
    dense = load(path, **kw).params["layers"]
    layers = dict(model.params["layers"])
    layers.update({k: dense[k] for k in ("w_up", "w_gate", "w_down") if k in dense})
    pred = {k: layers.pop(k) for k in ("pred_up", "pred_up_b", "pred_down", "pred_down_b")}
    params = prepare(dict(model.params, layers=layers), model.config, scfg)
    params["sparse_flat"].update(
        pred_up_qt=flat_quantize(pred["pred_up"]), pred_down_qt=flat_quantize(pred["pred_down"]),
        pred_up_b_all=pred["pred_up_b"], pred_down_b_all=pred["pred_down_b"])
    model.params = params
    return model, pred


@pytest.mark.parametrize("kind", KINDS)
def test_q8_engine_streams_match_jax(ggufs, kind):
    """Q8_0 flat stores (v6q), Q8_0 predictor stacks (quant_matmul_flat) and
    the packed attention and head where the loader keeps them
    (quant_matmul_2d), in f32."""
    path = ggufs[kind + "-q8"]
    jm, jpred = _q8_model(
        jloader.load_model, lambda p, c, s: jffn.prepare_pipelined_params(
            p, c, s, drop_dense=True, layout="v6", quant="q8_0"),
        lambda w: jqm.flat_quantize(np.asarray(w)), JaxSparseConfig(GQ, CAPQ), path,
        dtype=jnp.float32)
    jm.params["sparse_flat"]["pred_up_all"] = jpred["pred_up"]
    tm, _ = _q8_model(
        lambda p, **kw: load_model(p, device="cpu", **kw),
        lambda p, c, s: tffn.prepare_pipelined_params(p, c, s, drop_dense=True, layout="v6",
                                                      quant="q8_0"),
        tqm.flat_quantize, SparseConfig(GQ, CAPQ), path, dtype=torch.float32)
    flat = tm.params["sparse_flat"]
    assert flat["qw_upT_flat"].dtype == torch.int8
    assert ("qw_gateT_flat" in flat) == (FAMILIES[kind][0] == "qwen2")
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                   sparse=JaxSparseConfig(GQ, CAPQ), sparse_decode_mode="pallas",
                   sparse_preprepared=True)
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                sparse=SparseConfig(GQ, CAPQ), sparse_preprepared=True, device="cpu")
    got = pe.generate(PROMPT, 10)
    assert got == je.generate(PROMPT, 10) and len(got) == 10


@pytest.mark.parametrize("kind", KINDS)
def test_scheduler_streams_match_jax(ggufs, kind):
    """4 requests on 2 slots, greedy: every tick runs v1 over the row stores
    (its plain version here)."""
    jm, tm = _both(ggufs[kind])
    kw = dict(sparse_batch_max=100)
    sched = Scheduler(tm, n_slots=2, max_seq=64, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, device="cpu", sparse=SparseConfig(G, CAP), **kw)
    got = [sched.submit(Request(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS]
    sched.run_until_idle()
    assert sched.metrics_snapshot()["n_dense_steps"] == 0
    jsched = JaxScheduler(jm, n_slots=2, max_seq=64, sampler=JaxSampler(temp=0.0),
                          kv_dtype=jnp.float32, sparse=JaxSparseConfig(G, CAP), **kw)
    want = [jsched.submit(JaxRequest(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS]
    jsched.run_until_idle()
    got = [r.tokens() for r in got]
    assert got == [r.tokens() for r in want] and all(len(t) == 6 for t in got)
    # a second Scheduler over the first one's row stores, built once
    again = Scheduler(type(tm)(config=tm.config, params=sched.params), n_slots=2, max_seq=64,
                      sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32, device="cpu",
                      sparse=SparseConfig(G, CAP), sparse_preprepared=True, **kw)
    assert again.params["layers"]["w_up_rows"] is sched.params["layers"]["w_up_rows"]
    reqs = [again.submit(Request(prompt_tokens=p, max_new_tokens=6)) for p in PROMPTS]
    again.run_until_idle()
    assert [r.tokens() for r in reqs] == got


# ---------------------------------------------------------------------------
# the CLI and the server


@pytest.mark.parametrize("kind,flags", [
    ("opt", ["--sparse", "--group-size", "16", "--capacity-groups", "4"]),
    ("falcon40b", ["--draft-mode", "lookup", "--draft", "4"])])
def test_cli_streams_match_the_jax_cli(ggufs, capsys, monkeypatch, kind, flags):
    from sparkinfer_tpu.tools.cli import main as jax_main
    from sparkinfer_tpu_torch.models import loader
    from sparkinfer_tpu_torch.tools.cli import main

    jload, tload = jloader.load_model, loader.load_model
    monkeypatch.setattr(jloader, "load_model",
                        lambda p, **kw: jload(p, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(loader, "load_model",
                        lambda p, **kw: tload(p, **{**kw, "dtype": torch.float32}))
    argv = ["-m", ggufs[kind], "-p", "5 9 42 7 5 9 42 7", "-n", "24", "--temp", "0",
            "-ctk", "f32", "-c", "64"] + flags
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.split()) >= 24


def test_server_answers_a_falcon_model(tmp_path):
    """SparkServer over the grouped two-norm falcon, sparse ticks: the
    completions equal the same requests through its Scheduler."""
    from sparkinfer_tpu_torch.server.app import ServerConfig, SparkServer

    path = tmp_path / "falcon40b-vocab.gguf"
    make_family(str(path), "falcon40b", n_vocab=300, seed=7, with_vocab=True)
    model = load_model(str(path), dtype=torch.float32, device="cpu")
    scfg = SparseConfig(G, CAP)
    srv = SparkServer(model, ServerConfig(port=0, n_slots=2, max_seq=64, kv_dtype="f32",
                                          sparse=scfg, device="cpu"),
                      sampler=SamplerConfig(temp=0.0))
    srv.serve(block=False)
    try:
        got = []
        for p in PROMPTS:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/completion",
                data=json.dumps({"prompt": p, "n_predict": 6, "temperature": 0}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got.append(json.loads(r.read())["choices"][0]["text"])
    finally:
        srv.shutdown()
    sched = Scheduler(model, n_slots=2, max_seq=64, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, sparse=scfg, device="cpu")
    want = []
    for p in PROMPTS:
        req = sched.submit(Request(prompt_tokens=p, max_new_tokens=6, stop_ids=srv._stop_ids()))
        sched.run_until_idle()
        want.append(srv.tokenizer.decode_bytes(req.tokens()).decode("utf-8", "replace"))
    assert got == want and any(got)


# ---------------------------------------------------------------------------
# against transformers, through the JAX converter


def _hf(kind):
    """A tiny transformers model of the family, seeded."""
    import transformers as tf

    torch.manual_seed(0)
    if kind == "opt":
        return tf.OPTForCausalLM(tf.OPTConfig(
            vocab_size=160, hidden_size=64, ffn_dim=96, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64, do_layer_norm_before=True,
            word_embed_proj_dim=64))
    if kind == "qwen2":
        return tf.Qwen2ForCausalLM(tf.Qwen2Config(
            vocab_size=160, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False))
    new = kind == "falcon40b"
    return tf.FalconForCausalLM(tf.FalconConfig(
        vocab_size=160, hidden_size=64, num_hidden_layers=2, num_attention_heads=8 if new else 4,
        num_kv_heads=2 if new else None, multi_query=not new, new_decoder_architecture=new,
        parallel_attn=True, bias=False, alibi=False, layer_norm_epsilon=1e-5))


@pytest.mark.parametrize("kind", KINDS)
def test_transformers_logits(tmp_path, kind):
    pytest.importorskip("transformers")
    from sparkinfer_tpu.tools.convert_hf import convert

    hf = _hf(kind).eval()
    hf.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)
    out = str(tmp_path / f"{kind}.gguf")
    assert convert(str(tmp_path / "hf"), out, out_type="f32")["arch"] == FAMILIES[kind][0]
    tm = load_model(out, dtype=torch.float32, device="cpu")
    assert ("attn_norm2_w" in tm.params["layers"]) == (kind == "falcon40b")
    toks = np.random.default_rng(0).integers(0, 160, 6)
    with torch.no_grad():
        ref = hf(torch.tensor(toks)[None]).logits[0].numpy()
        got = make_forward(tm.config, fresh_prefill=True)(
            tm.params, torch.tensor(toks)[None], torch.arange(6)[None],
            init_cache(tm.config, 1, 16, torch.float32, "cpu"))[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
