"""The non-causal encoders of ROADMAP 15h in the port against the JAX
package, on the CPU: bert, neo-bert and gemma-embedding.

bert from a tiny transformers BertModel (and a BertForSequenceClassification
for rank pooling) converted by the JAX package's tools/convert_hf.py (f32;
its LayerNorms and biases drawn away from their ones and zeros), and from
tests/arch_fixture.py:make_encoder with a WordPiece vocabulary and a
cls/cls.output head for the server; neo-bert and gemma-embedding (per-head
q/k norms, sandwich norms, a sliding window of 8 over 6 layers, the last
full) as direct GGUFs of make_tiny_llama. f32 throughout. Tolerances: params
equal bit for bit; hidden states within 1e-5 of the JAX forward's scale
(the port unpadded or padded with keys at position -1, the JAX forward
padded); the port's unpadded Embedder within 1e-5 of the JAX Embedder's
padded one; against transformers' f32 BertModel 4e-3 (the JAX package's
own test's bound), and its classification logit 1e-5.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
T = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

import arch_checks as ac  # noqa: E402
from arch_fixture import ENCODER_KINDS, WPM_PIECES, make_encoder  # noqa: E402
from sparkinfer_tpu.runtime.embeddings import Embedder as JaxEmbedder  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_init_cache  # noqa: E402
from sparkinfer_tpu.server import ServerConfig as JaxServerConfig  # noqa: E402
from sparkinfer_tpu.server import SparkServer as JaxServer  # noqa: E402
from sparkinfer_tpu.tokenizer import build_tokenizer as jax_tokenizer  # noqa: E402
from sparkinfer_tpu.tools import convert_hf  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import ENCODER_ARCHS, make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.embeddings import Embedder  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.server import ServerConfig, SparkServer  # noqa: E402
from sparkinfer_tpu_torch.tokenizer import build_tokenizer  # noqa: E402
from sparkinfer_tpu_torch.tools import cli  # noqa: E402
from test_torch_server import _call  # noqa: E402

V = 160  # the transformers checkpoints' vocabulary
BERT = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=96, max_position_embeddings=64, hidden_act="gelu")
TOL = 1e-5
HF_TOL = 4e-3
# 14 tokens: past gemma-embedding's half window of 4, so its symmetric band binds
TOKS = [int(t) for t in np.random.default_rng(1).integers(5, 110, 14)]
NAMES = ("bert-hf", "bert-rank-hf") + ENCODER_KINDS
INPUTS = [TOKS, TOKS[:3], [7], TOKS[::-1] + TOKS[:5]]


def _hf_bert(d, name, cls):
    """A tiny transformers bert with its LayerNorms and biases drawn away from
    their ones and zeros, converted to an f32 GGUF: (path, the model)."""
    torch.manual_seed(0)
    hf = getattr(T, cls)(T.BertConfig(**BERT, num_labels=1)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if "LayerNorm" in n or n.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    hf.save_pretrained(str(d / name), safe_serialization=True)
    path = str(d / f"{name}.gguf")
    convert_hf.convert(str(d / name), path, out_type="f32")
    return path, hf


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """name -> (GGUF path, the transformers model or None)."""
    d = tmp_path_factory.mktemp("encoders")
    out = {"bert-hf": _hf_bert(d, "bert-hf", "BertModel"),
           "bert-rank-hf": _hf_bert(d, "bert-rank-hf", "BertForSequenceClassification")}
    for kind in ENCODER_KINDS:
        make_encoder(d / f"{kind}.gguf", kind, seed=2, with_vocab=kind == "bert",
                     cls_head=kind == "bert")
        out[kind] = (str(d / f"{kind}.gguf"), None)
    return out


@pytest.fixture(scope="module")
def models(ggufs):
    loaded = {}

    def get(name):
        if name not in loaded:
            loaded[name] = ac.both(ggufs[name][0])
        return loaded[name]

    return get


def _jax_hidden(jm, toks, pad_to=0):
    """The JAX forward's hidden states of toks, f32 numpy (n, E): padded to
    pad_to tokens with the pads at position -1, as the JAX Embedder pads."""
    from sparkinfer_tpu.models.transformer import make_forward as jax_forward

    n = len(toks)
    Tp = max(pad_to, n)
    t = np.zeros((1, Tp), np.int32)
    t[0, :n] = toks
    pos = np.arange(Tp, dtype=np.int32)[None].copy()
    pos[0, n:] = -1
    _, _, h = jax.jit(jax_forward(jm.config, with_hidden=True))(
        jm.params, jnp.asarray(t), jnp.asarray(pos), jax_init_cache(jm.config, 1, Tp,
                                                                     jnp.float32))
    return np.asarray(h)[0, :n]


def _hidden(pm, toks, pad_to=0):
    """The port's forward's hidden states (n, E), the same padding."""
    n = len(toks)
    Tp = max(pad_to, n)
    t = torch.zeros((1, Tp), dtype=torch.long)
    t[0, :n] = torch.tensor(toks)
    pos = torch.arange(Tp)[None].clone()
    pos[0, n:] = -1
    with torch.inference_mode():
        _, h = make_forward(pm.config, with_hidden=True, fresh_prefill=True, head=False)(
            pm.params, t, pos, init_cache(pm.config, 1, Tp, torch.float32, "cpu"))
    return h[0, :n].numpy()


def test_check_supported_admits_the_encoders():
    assert set(ENCODER_ARCHS) == {"bert", "neo-bert", "gemma-embedding"} == set(ENCODER_KINDS)


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_jax(models, name):
    """bert's token types, embedding LayerNorm and post-sum norms (in the
    attn_norm and ffn_norm slots) load as the JAX loader's, with no final
    norm; the rank head's cls tensors; neo-bert and gemma-embedding as
    llama and gemma3 blocks."""
    jm, pm = models(name)
    lay = ac.same_params(jm, pm)
    assert pm.config.traits.non_causal
    if name.startswith("bert"):
        assert {"type_embd", "pos_embd", "tok_norm_w", "tok_norm_b"} <= set(pm.params)
        assert "output_norm_w" not in pm.params and pm.config.traits.post_norm
        assert {"attn_norm_w", "attn_norm_b", "ffn_norm_w", "ffn_norm_b", "b_up"} <= set(lay)
    if name in ("bert-rank-hf", "bert"):
        assert {"cls_w", "cls_b", "cls_out_w", "cls_out_b"} <= set(pm.params)
    if name == "gemma-embedding":
        assert pm.config.sliding_window == 8 and pm.config.swa_layers == (True,) * 5 + (False,)


@pytest.mark.parametrize("name", NAMES)
def test_hidden_matches_jax(models, name):
    """Hidden states of 14 tokens within 1e-5 of the JAX forward's: the
    port unpadded and padded to 24 (its pads at position -1, hidden from
    every key), the JAX forward padded to 24 and unpadded."""
    jm, pm = models(name)
    want = _jax_hidden(jm, TOKS)
    for got in (_hidden(pm, TOKS), _hidden(pm, TOKS, pad_to=24)):
        assert ac.rel(got, want) <= TOL, ac.rel(got, want)
    assert ac.rel(_hidden(pm, TOKS), _jax_hidden(jm, TOKS, pad_to=24)) <= TOL


def test_symmetric_window_binds(models):
    """gemma-embedding's 14 tokens are longer than its half window: the
    band moves the hidden states, both ways (a one-sided window is not
    the JAX answer)."""
    import dataclasses

    _, pm = models("gemma-embedding")
    unbanded = type(pm)(config=dataclasses.replace(pm.config, sliding_window=0),
                        params=pm.params)
    assert ac.rel(_hidden(unbanded, TOKS), _hidden(pm, TOKS)) > 1e-2


def test_hidden_matches_transformers(ggufs, models):
    _, pm = models("bert-hf")
    with torch.no_grad():
        want = ggufs["bert-hf"][1](torch.tensor([TOKS])).last_hidden_state[0].numpy()
    assert ac.rel(_hidden(pm, TOKS), want) <= HF_TOL


@pytest.mark.parametrize("pooling", ["mean", "cls"])
@pytest.mark.parametrize("name", NAMES)
def test_embedder_matches_jax(models, name, pooling):
    """The port's Embedder (each input at its own length) against the JAX
    Embedder (each padded to a length bucket, its pads at position -1)."""
    jm, pm = models(name)
    want = JaxEmbedder(jm, max_seq=64, pooling=pooling).embed_tokens(INPUTS)
    got = Embedder(pm, max_seq=64, pooling=pooling, device="cpu").embed_tokens(INPUTS)
    assert got.shape == want.shape == (len(INPUTS), 64)
    for g, w in zip(got, want):
        assert ac.rel(g, w) <= TOL


def test_rank_pooling_matches_jax_and_transformers(ggufs, models):
    """BertForSequenceClassification's pooler and classifier as the rank
    head: scores within 1e-5 of the JAX Embedder's and of transformers'
    logit."""
    jm, pm = models("bert-rank-hf")
    want = JaxEmbedder(jm, max_seq=64, pooling="rank").rerank_scores(INPUTS)
    got = Embedder(pm, max_seq=64, pooling="rank", device="cpu").rerank_scores(INPUTS)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.no_grad():
        hf = [float(ggufs["bert-rank-hf"][1](torch.tensor([t])).logits[0, 0]) for t in INPUTS]
    np.testing.assert_allclose(got, hf, rtol=TOL, atol=TOL)


def test_inputs_are_cut_to_the_learned_positions(models):
    """bert's 64 learned positions cap the Embedder's max_seq: a longer
    input pools as its first 64 tokens."""
    _, pm = models("bert-hf")
    emb = Embedder(pm, max_seq=512, device="cpu")
    assert emb.max_seq == 64
    long = (TOKS * 6)[:80]
    np.testing.assert_array_equal(emb.embed_tokens([long]), emb.embed_tokens([long[:64]]))


@pytest.mark.parametrize("name", ENCODER_KINDS)
def test_generation_is_refused_by_name(ggufs, models, name):
    """The Engine, the Scheduler's requests and the CLI refuse to decode an
    encoder, naming the arch; the Scheduler itself builds (the server's)."""
    _, pm = models(name)
    arch = pm.config.arch
    with pytest.raises(ValueError, match=f"'{arch}'"):
        Engine(pm, max_seq=32, device="cpu")
    sched = Scheduler(pm, n_slots=1, max_seq=32, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=f"'{arch}'"):
        sched.submit(Request(prompt_tokens=[5, 6], max_new_tokens=2))
    with pytest.raises(ValueError, match=f"'{arch}'"):
        cli.main(["-m", ggufs[name][0], "--device", "cpu", "-p", "5 6", "-n", "2"])


@pytest.fixture(scope="module")
def servers(ggufs):
    path = ggufs["bert"][0]
    from sparkinfer_tpu.models.loader import load_model as jax_load

    jsrv = JaxServer(jax_load(path, dtype=jnp.float32),
                     JaxServerConfig(port=0, n_slots=1, max_seq=64, kv_dtype="f32"))
    tsrv = SparkServer(load_model(path, dtype=torch.float32, device="cpu"),
                       ServerConfig(port=0, n_slots=1, max_seq=512, kv_dtype="f32",
                                    device="cpu"),
                       sampler=SamplerConfig(temp=0.0))
    jsrv.serve(block=False)
    tsrv.serve(block=False)
    yield jsrv, tsrv
    jsrv.shutdown()
    tsrv.shutdown()


TEXTS = ["hello world", "what is the query?", "embedding texts, one two three!",
         "the rerankers don't"]


def test_wordpiece_gives_cls_and_sep(servers):
    """The server's tokenizer over a bert GGUF's vocabulary: [CLS] ... [SEP],
    word pieces as the JAX package's tokenizer gives them."""
    jsrv, tsrv = servers
    jt = jax_tokenizer(jsrv.model.vocab)
    for text in TEXTS:
        ids = tsrv.tokenizer.encode(text, add_special=True)
        assert ids == jt.encode(text, add_special=True)
        assert ids[0] == 2 and ids[-1] == 3 and 1 not in ids  # [CLS], [SEP], no [UNK]
    pieces = tsrv.tokenizer.encode("embedding rerankers", add_special=False)
    assert pieces == [5 + WPM_PIECES.index(p) for p in ("embed", "##ding", "rerank", "##er",
                                                        "##s")]


def test_embeddings_route_equals_the_embedder(servers):
    """/v1/embeddings over HTTP: the vectors of the Embedder called directly
    on the tokenizer's ids, bit for bit, and within 1e-5 of the JAX
    server's."""
    jsrv, tsrv = servers
    status, raw = _call(tsrv.port, "/v1/embeddings", {"input": TEXTS})
    assert status == 200
    got = np.array([d["embedding"] for d in json.loads(raw)["data"]])
    ids = [build_tokenizer(tsrv.model.vocab).encode(t, add_special=True) for t in TEXTS]
    direct = Embedder(tsrv.model, max_seq=512, device="cpu").embed_tokens(ids)
    np.testing.assert_array_equal(got, direct.astype(np.float64))
    jstatus, jraw = _call(jsrv.port, "/v1/embeddings", {"input": TEXTS})
    want = np.array([d["embedding"] for d in json.loads(jraw)["data"]])
    assert jstatus == 200 and ac.rel(got, want) <= TOL


def test_rerank_route_matches_jax(servers):
    """/v1/rerank's pairs ([CLS] query [SEP] doc [SEP]) through the cls head:
    the JAX server's order and scores within 1e-5."""
    jsrv, tsrv = servers
    body = {"query": "what is the query", "documents": TEXTS}
    (jc, jraw), (tc, traw) = (_call(s.port, "/v1/rerank", body) for s in (jsrv, tsrv))
    assert jc == tc == 200
    got, want = json.loads(traw)["results"], json.loads(jraw)["results"]
    assert [r["index"] for r in got] == [r["index"] for r in want]
    np.testing.assert_allclose([r["relevance_score"] for r in got],
                               [r["relevance_score"] for r in want], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 4}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                              "max_tokens": 4}),
])
def test_completions_are_refused_by_name(servers, path, body):
    _, tsrv = servers
    status, raw = _call(tsrv.port, path, body)
    assert status == 400 and "'bert'" in json.loads(raw)["error"]
