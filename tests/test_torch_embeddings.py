"""The port's embeddings (runtime/embeddings.py), its /embeddings and /rerank
routes and tools/retrieval.py against the JAX package, on the CPU.

One tiny f32 GGUF with an SPM vocabulary and a reranker's classification
head (cls.weight, cls.bias, cls.output.weight, cls.output.bias). Pooled
vectors and rank scores lie within 1e-5 of the JAX Embedder's (relative to
the vector's largest entry: the JAX Embedder pads each input to a length
bucket and attends over a longer cache, so its f32 sums run in another
order); the servers' JSON is equal apart from those floats; retrieval's
top-k order is equal.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_make_forward  # noqa: E402
from sparkinfer_tpu.runtime.embeddings import Embedder as JaxEmbedder  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_init_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.server import ServerConfig as JaxServerConfig  # noqa: E402
from sparkinfer_tpu.server import SparkServer as JaxServer  # noqa: E402
from sparkinfer_tpu.tools import retrieval as jretrieval  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.embeddings import Embedder  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.server import ServerConfig, SparkServer  # noqa: E402
from sparkinfer_tpu_torch.tools import retrieval as tretrieval  # noqa: E402
from test_torch_server import _call, _json_close  # noqa: E402

E = 64
INPUTS = [[1, 263, 42, 7, 9], [1, 5], [1, 270, 271, 272, 9, 9, 9, 9, 9, 9, 9, 280, 3],
          list(range(1, 40))]


def _cls_head(seed=7):
    rng = np.random.default_rng(seed)
    return {"cls.weight": rng.standard_normal((E, E)) * 0.2,
            "cls.bias": rng.standard_normal(E) * 0.1,
            "cls.output.weight": rng.standard_normal((1, E)) * 0.5,
            "cls.output.bias": np.array([0.25])}


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-rerank.gguf"
    make_tiny_llama(path, n_vocab=300, with_vocab=True, extra_tensors=_cls_head())
    return str(path)


@pytest.fixture(scope="module")
def models(gguf):
    return (jax_load(gguf, dtype=jnp.float32),
            load_model(gguf, dtype=torch.float32, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_loader_reads_the_classification_head(models):
    jm, tm = models
    for k in ("cls_w", "cls_b", "cls_out_w", "cls_out_b"):
        assert tm.params[k].dtype == torch.float32
        np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(jm.params[k]))


def test_forward_with_hidden_matches_jax(models):
    jm, tm = models
    toks = INPUTS[2]
    n = len(toks)
    jl, _, jh = jax_make_forward(jm.config, with_hidden=True)(
        jm.params, jnp.asarray([toks], jnp.int32), jnp.arange(n, dtype=jnp.int32)[None],
        jax_init_cache(jm.config, 1, 16, jnp.float32))
    tl, th = make_forward(tm.config, with_hidden=True)(
        tm.params, torch.tensor([toks]), torch.arange(n)[None],
        init_cache(tm.config, 1, 16, torch.float32, "cpu"))
    assert th.shape == (1, n, E)
    _close(th.numpy(), np.asarray(jh))
    _close(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("pooling", ["mean", "last", "cls", "none", "rank"])
@pytest.mark.parametrize("normalize", [True, False])
def test_poolings_match_jax(models, pooling, normalize):
    jm, tm = models
    want = JaxEmbedder(jm, max_seq=32, pooling=pooling).embed_tokens(INPUTS, normalize)
    got = Embedder(tm, max_seq=32, pooling=pooling, device="cpu").embed_tokens(
        INPUTS, normalize)
    if pooling == "none":  # one (n, E) array an input (cut to max_seq)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape == ((4, 1) if pooling == "rank" else (4, E))
    assert got.dtype == np.float32
    for g, w in zip(got, want):
        _close(g, w)
    if normalize and pooling != "rank":
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def test_an_input_pools_alike_alone_and_among_others(models):
    _, tm = models
    emb = Embedder(tm, max_seq=64, device="cpu")
    together = emb.embed_tokens(INPUTS)
    for i, ids in enumerate(INPUTS):
        np.testing.assert_array_equal(emb.embed_tokens([ids])[0], together[i])


def test_rerank_scores_match_jax_and_the_f64_head(models):
    jm, tm = models
    want = JaxEmbedder(jm, pooling="rank").rerank_scores(INPUTS)
    emb = Embedder(tm, pooling="rank", device="cpu")
    got = emb.rerank_scores(INPUTS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the head in f32 on the hidden state, as the JAX Embedder computes it
    keys = ("cls_w", "cls_b", "cls_out_w", "cls_out_b")
    p = {k: tm.params[k].numpy() for k in keys}
    h = emb.hidden(INPUTS[0])[0]
    t = np.tanh(p["cls_w"] @ h + p["cls_b"])
    assert got[0] == float((p["cls_out_w"] @ t + p["cls_out_b"])[0])
    # and within 1e-5 of the f64 head, relative to the sum of its terms' sizes
    p64 = {k: v.astype(np.float64) for k, v in p.items()}
    t64 = np.tanh(p64["cls_w"] @ h.astype(np.float64) + p64["cls_b"])
    ref = (p64["cls_out_w"] @ t64 + p64["cls_out_b"])[0]
    size = (np.abs(p64["cls_out_w"]) @ np.abs(t64) + np.abs(p64["cls_out_b"]))[0]
    assert abs(got[0] - ref) <= 1e-5 * size
    with pytest.raises(ValueError):
        Embedder(tm, pooling="mean", device="cpu").rerank_scores(INPUTS)
    with pytest.raises(ValueError):
        Embedder(tm, pooling="max", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        emb.embed_tokens([[]])


def test_embedder_runs_on_the_card_unless_asked(models):
    _, tm = models
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Embedder(tm)


@pytest.fixture(scope="module")
def servers(gguf, models):
    jm, _ = models
    jsrv = JaxServer(jm, JaxServerConfig(port=0, n_slots=1, max_seq=128, kv_dtype="f32"),
                     sampler=JaxSampler(temp=0.0))
    tsrv = SparkServer(load_model(gguf, dtype=torch.float32, device="cpu"),
                       ServerConfig(port=0, n_slots=1, max_seq=128, kv_dtype="f32",
                                    device="cpu"),
                       sampler=SamplerConfig(temp=0.0))
    jsrv.serve(block=False)
    tsrv.serve(block=False)
    yield jsrv, tsrv
    jsrv.shutdown()
    tsrv.shutdown()


DOCS = ["hello world", "the hello", "world world world", "hello"]


@pytest.mark.parametrize("path,body", [
    ("/embeddings", {"input": "hello world"}),
    ("/v1/embeddings", {"input": ["hello", "the world", "hello hello the"]}),
    ("/v1/embeddings", {"content": "world"}),
    ("/rerank", {"query": "hello", "documents": DOCS}),
    ("/reranking", {"query": "the", "documents": DOCS, "top_n": 2}),
    ("/v1/rerank", {"query": "world", "texts": DOCS}),
    ("/v1/reranking", {"query": "hello world", "documents": DOCS[:2]}),
    ("/v1/rerank", {"documents": DOCS}),
])
def test_routes_answer_as_the_jax_server(servers, path, body):
    jsrv, tsrv = servers
    (jc, jraw), (tc, traw) = (_call(s.port, path, body) for s in (jsrv, tsrv))
    assert tc == jc == (400 if "query" not in body and "rerank" in path else 200)
    got, want = json.loads(traw), json.loads(jraw)
    if "results" in want:  # ranks may swap only between scores within the tolerance
        assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
    _json_close(got, want)


def test_routes_interleave_with_completions(servers):
    """An embedding request beside running completions: the Scheduler's
    lock keeps the forwards apart, and both answer as when alone."""
    import threading

    _, tsrv = servers
    body = {"prompt": "hello world", "max_tokens": 16, "temperature": 0}
    alone = _call(tsrv.port, "/v1/completions", body)
    emb_alone = _call(tsrv.port, "/v1/embeddings", {"input": DOCS})
    out = {}
    th = threading.Thread(target=lambda: out.update(c=_call(tsrv.port, "/v1/completions",
                                                            body)))
    th.start()
    emb = _call(tsrv.port, "/v1/embeddings", {"input": DOCS})
    th.join()
    strip = [json.loads(r[1])["choices"] for r in (alone, out["c"])]
    assert strip[0] == strip[1]
    assert json.loads(emb[1])["data"] == json.loads(emb_alone[1])["data"]


def test_retrieval_top_k_matches_jax(gguf, models, tmp_path, capsys):
    jm, tm = models
    text = ("hello world. the hello world. world the world. hello hello. the the hello. "
            "world hello the.")
    chunks = tretrieval.chunk_text(text, 10, ".")
    assert chunks == jretrieval.chunk_text(text, 10, ".")
    jr, tr = jretrieval.Retriever(jm), tretrieval.Retriever(tm, device="cpu")
    jr.add(chunks)
    tr.add(chunks)
    for q in ("hello", "the world", "world world hello"):
        got, want = tr.query(q, 4), jr.query(q, 4)
        assert [t for _, t in got] == [t for _, t in want]
        np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], atol=1e-5)
    ctx = tmp_path / "ctx.txt"
    ctx.write_text(text)
    argv = ["-m", gguf, "--context-file", str(ctx), "--chunk-size", "10", "-q", "hello the",
            "--top-k", "3", "--json"]
    assert jretrieval.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert tretrieval.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    # both tools load bf16 weights, whose roundings differ by an ulp here and there
    assert [h["text"] for h in got] == [h["text"] for h in want] and len(got) == 3
    np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                               atol=1e-2)
