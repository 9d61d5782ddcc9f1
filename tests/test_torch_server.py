"""The port's OpenAI-compatible server (sparkinfer_tpu_torch/server/) against
the JAX package's SparkServer, on the CPU.

One tiny f32 GGUF (make_tiny_llama with an SPM vocabulary, a Jinja chat
template and FIM tokens) is served by the JAX SparkServer and by the port's
(device="cpu"), each on port 0 with one slot (a JAX idle slot steps at
position 0 and overwrites the first cached token of its prefix, which the
port does not; one slot has no idle tick), greedy. The same requests to both
give the same status and body, with response ids and timestamps dropped:
/tokenize, /detokenize, /v1/completions, /completion with token ids,
/v1/chat/completions, SSE chunks, stop strings, /apply-template,
/v1/messages, /infill and its prompt layout, json_schema requests, /props,
/v1/models, /health and /slots. Exact: ids and text equal.

Port only: a sparse server (prosparse fixture, SparseConfig(8, 4),
a crossover of 2 from SPIF_SPARSE_BATCH_MAX) streams what the port's "kernel" Scheduler gives;
/embeddings and /rerank answer as the JAX server's; --attn-w8a8 serves the
JAX server's streams, and so do the int8 and split KV caches (options and
flags); -hf raises; the router loads a second model; Engine.generate_text
gives the JAX Engine's text; and `python -m sparkinfer_tpu_torch.server
--device cpu` answers /health in a subprocess.
"""

import json
import os
import pathlib
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.server import ServerConfig as JaxServerConfig  # noqa: E402
from sparkinfer_tpu.server import SparkServer as JaxServer  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.server import ServerConfig, SparkServer  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEMPLATE = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] }}"
            "<|im_end|>\n{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n"
            "{% endif %}")
FIM = {"tokenizer.ggml.fim_pre_token_id": 290, "tokenizer.ggml.fim_suf_token_id": 291,
       "tokenizer.ggml.fim_mid_token_id": 292}
SCHEMA = {"type": "object", "properties": {"name": {"type": "string"},
                                           "n": {"type": "integer"}},
          "required": ["name", "n"]}
MSGS = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello world"}]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-vocab.gguf"
    make_tiny_llama(path, n_vocab=300, with_vocab=True, chat_template=TEMPLATE, extra_kv=FIM)
    return str(path)


@pytest.fixture(scope="module")
def servers(gguf):
    jsrv = JaxServer(jax_load(gguf, dtype=jnp.float32),
                     JaxServerConfig(port=0, n_slots=1, max_seq=192, kv_dtype="f32"),
                     sampler=JaxSampler(temp=0.0))
    tsrv = SparkServer(load_model(gguf, dtype=torch.float32, device="cpu"),
                       ServerConfig(port=0, n_slots=1, max_seq=192, kv_dtype="f32",
                                    device="cpu", extra_models={"second": gguf}),
                       sampler=SamplerConfig(temp=0.0))
    jsrv.serve(block=False)
    tsrv.serve(block=False)
    yield jsrv, tsrv
    jsrv.shutdown()
    tsrv.shutdown()


def _call(port, path, body=None, timeout=120):
    """(status, raw body) of one request to 127.0.0.1:port."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _strip(obj):
    """A response with its per-server ids and timestamps dropped."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("id", "created", "tool_call_id")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _parsed(raw):
    if raw.startswith("data: "):  # SSE: every chunk, in order
        return [_strip(json.loads(e[6:])) if e != "data: [DONE]" else e
                for e in raw.split("\n") if e.startswith("data: ")]
    try:
        return _strip(json.loads(raw))
    except json.JSONDecodeError:
        return raw


def _both(servers, path, body=None):
    jsrv, tsrv = servers
    (jc, jraw), (tc, traw) = _call(jsrv.port, path, body), _call(tsrv.port, path, body)
    return (jc, _parsed(jraw)), (tc, _parsed(traw))


GREEDY = {"temperature": 0.0}
CASES = {
    "health": ("/health", None),
    "props": ("/props", None),
    "slots": ("/slots", None),
    "tokenize": ("/tokenize", {"content": "hello world, the world"}),
    "tokenize_special": ("/tokenize", {"content": "hello</s>world", "add_special": True}),
    "detokenize": ("/detokenize", {"tokens": [1, 263, 268, 5, 100, 2]}),
    "completion": ("/v1/completions", {"prompt": "hello world", "max_tokens": 8, **GREEDY}),
    "completion_ids": ("/completion", {"prompt": [1, 263, 42, 17], "n_predict": 6, **GREEDY}),
    "completion_sse": ("/v1/completions", {"prompt": "the world", "max_tokens": 8,
                                           "stream": True, **GREEDY}),
    "chat": ("/v1/chat/completions", {"messages": MSGS, "max_tokens": 8, **GREEDY}),
    "chat_sse": ("/v1/chat/completions", {"messages": MSGS, "max_tokens": 8, "stream": True,
                                          **GREEDY}),
    "apply_template": ("/apply-template", {"messages": MSGS}),
    "messages": ("/v1/messages", {"system": "be brief", "max_tokens": 6,
                                  "messages": [{"role": "user", "content": [
                                      {"type": "text", "text": "hello"}]}], **GREEDY}),
    "infill": ("/infill", {"input_prefix": "def add(a, b):", "input_suffix": "return c",
                           "n_predict": 4, **GREEDY}),
    "json_schema": ("/v1/completions", {
        "prompt": "hello", "max_tokens": 12, **GREEDY,
        "response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMA}}}),
    "json_object": ("/v1/chat/completions", {
        "messages": MSGS, "max_tokens": 10, "response_format": {"type": "json_object"},
        **GREEDY}),
    "grammar": ("/completion", {"prompt": "x", "n_predict": 8, **GREEDY,
                                "grammar": 'root ::= ("hello" | " world")+'}),
    "not_found": ("/nope", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routes_match_jax(servers, case):
    path, body = CASES[case]
    (jc, jout), (tc, tout) = _both(servers, path, body)
    assert (tc, tout) == (jc, jout)
    assert jc == (404 if case == "not_found" else 200)


def test_models_route_lists_the_routed_model(servers):
    _, tsrv = servers
    code, raw = _call(tsrv.port, "/v1/models")
    assert code == 200
    assert [m["id"] for m in json.loads(raw)["data"]] == ["sparkinfer-tpu", "second"]


def test_stop_strings_match_jax(servers):
    """A stop string cut from the greedy text itself: both servers stop at
    it, and the text before it is the same."""
    body = {"prompt": "hello world", "max_tokens": 16, **GREEDY}
    (_, jout), _ = _both(servers, "/v1/completions", body)
    text = jout["choices"][0]["text"]
    stop = text[len(text) // 2:len(text) // 2 + 2]
    assert len(stop) == 2
    (jc, jstop), (tc, tstop) = _both(servers, "/v1/completions", {**body, "stop": [stop]})
    assert (tc, tstop) == (jc, jstop)
    assert len(tstop["choices"][0]["text"]) < len(text)
    (_, jsse), (_, tsse) = _both(servers, "/v1/completions",
                                 {**body, "stop": [stop], "stream": True})
    assert tsse == jsse


def test_infill_prompt_layout_matches_jax(servers):
    jsrv, tsrv = servers
    for body in ({"input_prefix": "hello ", "input_suffix": " world", "n_predict": 4},
                 {"input_prefix": "hello ", "input_suffix": " world", "n_predict": 4,
                  "spm_infill": True, "prompt": "the",
                  "input_extra": [{"filename": "a.py", "text": "x = 1"}]}):
        assert tsrv.infill_prompt(body) == jsrv.infill_prompt(body)


@pytest.mark.parametrize("path,body", [
    ("/embeddings", {"input": "hello"}), ("/v1/embeddings", {"input": "hello"}),
    ("/rerank", {"query": "a", "documents": ["b"]}), ("/v1/rerank", {"query": "a"}),
])
def test_unported_routes_answer_501(servers, path, body):
    """Formerly 501; now the routes answer as the JAX server's: the same
    status and JSON, numbers within 1e-5 of their scale (the JAX Embedder
    pads to a length bucket and sums in another order)."""
    jsrv, tsrv = servers
    (jc, jraw), (tc, traw) = (_call(s.port, path, body) for s in (jsrv, tsrv))
    assert tc == jc == (400 if "documents" not in body and "rerank" in path else 200)
    _json_close(json.loads(traw), json.loads(jraw))  # a rerank of nothing: the same 400


def _json_close(got, want, rel=1e-5):
    """Equal JSON, floats within rel of the largest |float| of their list."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _json_close(got[k], want[k], rel)
    elif isinstance(want, list) and want and all(isinstance(v, float) for v in want):
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(map(abs, want)))
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _json_close(g, w, rel)
    elif isinstance(want, float):
        assert abs(got - want) <= rel * max(abs(want), 1e-30)
    else:
        assert got == want


@pytest.mark.parametrize("path,body,code", [
    ("/lora-adapters", None, 200), ("/lora-adapters", [{"id": 0, "scale": 0.5}], 400),
    ("/slots/0?action=save", {"filename": "../s.bin"}, 400),
    ("/slots/0?action=drop", {"filename": "s.bin"}, 400),
    ("/slots/0?action=restore", {"filename": "absent.bin"}, 400),
])
def test_lora_and_slot_routes_without_adapters_or_files(servers, path, body, code):
    """The routes are ported (tests/test_torch_lora.py and test_torch_state_io.py
    drive them); a server without adapters lists none and refuses a scale,
    and a slot route refuses a path, an unknown action or a missing file."""
    _, tsrv = servers
    got, raw = _call(tsrv.port, path, body)
    assert got == code
    if code == 200:
        assert json.loads(raw) == []


def test_router_loads_a_second_model(servers):
    _, tsrv = servers
    body = {"model": "second", "prompt": [1, 263, 42], "max_tokens": 4, "stop": [],
            **GREEDY}
    code, raw = _call(tsrv.port, "/v1/completions", body)
    assert code == 200 and json.loads(raw)["usage"]["completion_tokens"] == 4
    assert "second" in tsrv._backends  # loaded at its first request, on the CPU
    assert tsrv._backends["second"][0].device.type == "cpu"


@pytest.mark.parametrize("kw,match", [
    (dict(kv_dtype="int8"), "KV"),
    (dict(kv_dtype_v="f32"), "KV"),
])
def test_unported_startup_options_raise(gguf, kw, match):
    """The int8 KV cache (kv_dtype "int8") and a split cache (kv_dtype_v
    "f32" beside bf16 K) are ported: each server's Scheduler holds that
    cache and serves the JAX server's completion on the same option."""
    model = load_model(gguf, dtype=torch.float32, device="cpu")
    tsrv = SparkServer(model, ServerConfig(port=0, n_slots=1, max_seq=64, device="cpu", **kw),
                       sampler=SamplerConfig(temp=0.0))
    cache = tsrv.sched.cache
    assert (cache.k.dtype, cache.v.dtype, cache.quantized) == (
        (torch.int8, torch.int8, True) if "kv_dtype" in kw
        else (torch.bfloat16, torch.float32, False)), match
    jsrv = JaxServer(jax_load(gguf, dtype=jnp.float32),
                     JaxServerConfig(port=0, n_slots=1, max_seq=64, **kw),
                     sampler=JaxSampler(temp=0.0))
    _same_completion(jsrv, tsrv)


def _same_completion(jsrv, tsrv):
    """One greedy completion from both servers: equal choices."""
    jsrv.serve(block=False)
    if tsrv._httpd is None:
        tsrv.serve(block=False)
    try:
        body = {"prompt": "hello world", "max_tokens": 24, "temperature": 0}
        (jc, jraw), (tc, traw) = (_call(s.port, "/v1/completions", body) for s in (jsrv, tsrv))
        assert jc == tc == 200
        got = _strip(json.loads(traw))["choices"]
        assert got == _strip(json.loads(jraw))["choices"] and got[0]["text"]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


@pytest.mark.parametrize("flags,module", [
    (["-hf", "acme/tiny"], "tools/hf.py"),
    (["-ctk", "q8", "-ctv", "q8"], "quantized KV"), (["-ctv", "f32"], "split-dtype"),
])
def test_unported_flags_fail_with_the_module(gguf, capsys, monkeypatch, flags, module):
    """-hf exits 2 naming its module. -ctk q8 -ctv q8 (the int8 cache) and
    -ctv f32 (a split cache) are ported: the server they start (its loader
    made to load f32) serves the JAX server's completion on the options
    the JAX server's own flags map them to ("q8" to "int8")."""
    from sparkinfer_tpu_torch.models import loader
    from sparkinfer_tpu_torch.server.__main__ import main

    if module in ("quantized KV", "split-dtype"):
        load, started = loader.load_model, []
        monkeypatch.setattr(loader, "load_model",
                            lambda path, **kw: load(path, **{**kw, "dtype": torch.float32}))
        serve = SparkServer.serve
        monkeypatch.setattr(SparkServer, "serve", lambda self, block=True: (
            started.append(self), serve(self, block=False)))
        assert main(["-m", gguf, "--device", "cpu", "--port", "0", "-np", "1", "-c", "64",
                     "--temp", "0"] + flags) == 0
        kw = (dict(kv_dtype="int8", kv_dtype_v="int8") if module == "quantized KV"
              else dict(kv_dtype="bf16", kv_dtype_v="f32"))
        jsrv = JaxServer(jax_load(gguf, dtype=jnp.float32),
                         JaxServerConfig(port=0, n_slots=1, max_seq=64, **kw),
                         sampler=JaxSampler(temp=0.0))
        _same_completion(jsrv, started[0])
        return
    with pytest.raises(SystemExit) as e:
        main(["-m", gguf, "--device", "cpu", "--port", "0"] + flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert module in err and "not ported yet" in err


def test_attn_w8a8_flag_serves_the_jax_servers_streams(gguf, monkeypatch):
    """`--attn-w8a8` loads W8A8 attention (both loaders made to load f32)
    and the server's completions equal the JAX server's on the same flag."""
    from sparkinfer_tpu_torch.models import loader
    from sparkinfer_tpu_torch.server.__main__ import main

    load, started = loader.load_model, []
    monkeypatch.setattr(loader, "load_model",
                        lambda path, **kw: load(path, **{**kw, "dtype": torch.float32}))
    serve = SparkServer.serve
    monkeypatch.setattr(SparkServer, "serve",
                        lambda self, block=True: (started.append(self), serve(self, block=False)))
    assert main(["-m", gguf, "--device", "cpu", "--port", "0", "-np", "1", "-c", "192",
                 "-ctk", "f32", "--attn-w8a8", "--temp", "0"]) == 0
    (tsrv,) = started
    jsrv = JaxServer(jax_load(gguf, dtype=jnp.float32, attn_w8a8=True),
                     JaxServerConfig(port=0, n_slots=1, max_seq=192, kv_dtype="f32"),
                     sampler=JaxSampler(temp=0.0))
    jsrv.serve(block=False)
    try:
        from sparkinfer_tpu_torch.ops.quant_matmul import W8A8Tensor

        assert isinstance(tsrv.model.params["layers"]["wq"], W8A8Tensor)
        body = {"prompt": "hello world", "max_tokens": 12, "temperature": 0}
        (jc, jraw), (tc, traw) = (_call(s.port, "/v1/completions", body) for s in (jsrv, tsrv))
        assert jc == tc == 200
        assert _strip(json.loads(traw))["choices"] == _strip(json.loads(jraw))["choices"]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_sparse_server_streams_the_kernel_scheduler(tmp_path, monkeypatch):
    """The ProSparse fixture served sparse (SparseConfig(8, 4), a crossover
    of 2, so every tick of its 2 slots goes through v1's plain version here)
    gives the port's "kernel" Scheduler's streams for the same requests, one
    after another."""
    monkeypatch.setenv("SPIF_SPARSE_BATCH_MAX", "2")
    path = tmp_path / "tiny-prosparse-vocab.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5, n_vocab=300,
                    with_vocab=True)
    model = load_model(str(path), dtype=torch.float32, device="cpu")
    scfg = SparseConfig(8, 4)
    srv = SparkServer(model, ServerConfig(port=0, n_slots=2, max_seq=64, kv_dtype="f32",
                                          sparse=scfg, device="cpu"),
                      sampler=SamplerConfig(temp=0.0))
    sched = Scheduler(model, n_slots=2, max_seq=64, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, sparse=scfg, sparse_batch_max=2, device="cpu")
    prompts = [[3, 14, 15], [9, 26, 53, 58], [97, 93], [2, 71, 82, 81, 82]]
    srv.serve(block=False)
    try:
        got = []
        for p in prompts:
            code, raw = _call(srv.port, "/completion",
                              {"prompt": p, "n_predict": 6, "stream": True, **GREEDY})
            assert code == 200
            got.append("".join(json.loads(e[6:])["choices"][0]["text"]
                               for e in raw.split("\n")
                               if e.startswith("data: ") and e != "data: [DONE]"))
        m = srv.sched.metrics_snapshot()
    finally:
        srv.shutdown()
    want = []
    for p in prompts:
        req = sched.submit(Request(prompt_tokens=p, max_new_tokens=6,
                                   stop_ids=srv._stop_ids()))
        sched.run_until_idle()
        want.append(srv.tokenizer.decode_bytes(req.tokens()).decode("utf-8", "replace"))
    assert got == want
    assert m["n_decode_steps"] > 0 and m["n_dense_steps"] == 0


def test_engine_generate_text_matches_jax(gguf):
    jeng = JaxEngine(jax_load(gguf, dtype=jnp.float32), max_seq=64,
                     sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32)
    eng = Engine(load_model(gguf, dtype=torch.float32, device="cpu"), max_seq=64,
                 sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32, device="cpu")
    for prompt in ("hello world", "the"):
        assert eng.generate_text(prompt, 8) == jeng.generate_text(prompt, 8)


def test_entry_point_answers_health(gguf):
    """`python -m sparkinfer_tpu_torch.server --device cpu --port 0` in a
    subprocess: its "listening on" line gives the bound port, /health
    answers, and the process is stopped."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparkinfer_tpu_torch.server", "-m", gguf, "--device", "cpu",
         "--port", "0", "-np", "1", "-c", "128"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()  # the server's first line, or EOF if it died
        assert line.startswith("listening on http://127.0.0.1:"), line + proc.stdout.read()
        port = int(line.split()[2].rsplit(":", 1)[1])
        deadline = time.monotonic() + 60
        while True:
            try:
                code, raw = _call(port, "/health", timeout=10)
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert code == 200 and json.loads(raw) == {"status": "ok"}
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
