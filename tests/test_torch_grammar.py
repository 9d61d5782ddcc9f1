"""The port's grammar engine (sparkinfer_tpu_torch/grammar/, copies of the
JAX package's) and its grammar-constrained Scheduler slots, against the JAX
package, on the CPU:
  - json_schema_to_gbnf gives the JAX output, string for string;
  - GrammarSampler over the SPM vocabulary of a tiny GGUF: after each
    accepted token the (V,) mask of allowed tokens equals the JAX one, and
    the grammar-first pick over seeded logits is the same token;
  - the Scheduler with grammar requests (two constrained, one free, on two
    slots, greedy, f32) gives the JAX Scheduler's streams, and every
    constrained stream is a prefix of its grammar's language.
Exact: strings, masks and ids equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.grammar import GrammarSampler as JaxGrammarSampler  # noqa: E402
from sparkinfer_tpu.grammar import json_schema_to_gbnf as jax_to_gbnf  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu.tokenizer import build_tokenizer as jax_build  # noqa: E402
from sparkinfer_tpu_torch.grammar import (  # noqa: E402
    GrammarSampler,
    json_schema_to_gbnf,
    parse_gbnf,
)
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.tokenizer import build_tokenizer  # noqa: E402

SCHEMAS = [
    {},
    {"type": "object", "properties": {"name": {"type": "string"}, "age": {"type": "integer"},
                                      "tags": {"type": "array", "items": {"type": "string"},
                                               "minItems": 1}},
     "required": ["name", "age", "tags"]},
    {"oneOf": [{"enum": ["red", "green"]}, {"type": "integer"}]},
    {"type": "array", "items": {"type": "number"}, "maxItems": 3},
    {"type": "object", "properties": {"ok": {"type": "boolean"}, "v": {"type": "null"}}},
    {"type": "string", "enum": ["hello", "world"]},
]
GBNF = [
    'root ::= "yes" | "no"',
    "root ::= [a-z]+ [0-9]*",
    r'root ::= "\"" [^"]* "\""',
    'root ::= expr\nexpr ::= term ("+" term)*\nterm ::= [0-9]+ | "(" expr ")"',
    "root ::= [0-9]{2,4}",
    'root ::= ("hello" | "world")+',
]
GRAMMARS = GBNF + [jax_to_gbnf(s) for s in SCHEMAS]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-vocab.gguf"
    make_tiny_llama(path, n_vocab=300, with_vocab=True)
    return str(path)


@pytest.fixture(scope="module")
def models(gguf):
    jm = jax_load(gguf, dtype=jnp.float32)
    tm = load_model(gguf, dtype=torch.float32, device="cpu")
    return jm, tm


@pytest.mark.parametrize("schema", SCHEMAS, ids=range(len(SCHEMAS)))
def test_json_schema_to_gbnf_matches_jax(schema):
    assert json_schema_to_gbnf(schema) == jax_to_gbnf(schema)


@pytest.mark.parametrize("grammar", GRAMMARS, ids=range(len(GRAMMARS)))
def test_masks_match_jax_after_each_token(models, grammar):
    """Walk the grammar for up to 10 tokens, each picked from the allowed
    ones by a seeded draw: the masks and the grammar-first picks agree."""
    jm, tm = models
    ref = JaxGrammarSampler(grammar, jm.vocab, jax_build(jm.vocab))
    got = GrammarSampler(grammar, tm.vocab, build_tokenizer(tm.vocab))
    rng = np.random.default_rng(len(grammar))
    for _ in range(10):
        want = ref.mask()
        assert np.array_equal(got.mask(), want)
        allowed = [t for t in np.flatnonzero(want) if not jm.vocab.is_eog(int(t))]
        if not allowed:
            break
        tok = int(rng.choice(allowed))
        assert got.allows(tok) and ref.allows(tok)
        ref.accept(tok)
        got.accept(tok)
    logits = rng.standard_normal(jm.vocab.n_tokens).astype(np.float32)
    sampled = int(np.argmax(logits))
    a = JaxGrammarSampler(grammar, jm.vocab, jax_build(jm.vocab))
    b = GrammarSampler(grammar, tm.vocab, build_tokenizer(tm.vocab))
    assert b.constrain_and_pick(logits, sampled) == a.constrain_and_pick(logits, sampled)


GRAMMAR_REQUESTS = [
    ([3, 14, 15], jax_to_gbnf(SCHEMAS[1])),
    ([9, 26, 53, 58], None),
    ([97, 93], 'root ::= ("hello" | "world")+'),
]


def test_scheduler_grammar_slots_match_jax(gguf, models):
    """Two constrained requests and a free one on two slots, greedy, f32:
    the port's Scheduler gives the JAX Scheduler's streams, and each
    constrained stream's text is a prefix of its grammar's language."""
    jm, tm = models
    jtok, ttok = jax_build(jm.vocab), build_tokenizer(tm.vocab)
    jsched = JaxScheduler(jm, n_slots=2, max_seq=64, sampler=JaxSampler(temp=0.0),
                          kv_dtype=jnp.float32, tokenizer=jtok)
    sched = Scheduler(tm, n_slots=2, max_seq=64, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, tokenizer=ttok, device="cpu")
    jreqs = [jsched.submit(JaxRequest(prompt_tokens=p, max_new_tokens=10, grammar=g))
             for p, g in GRAMMAR_REQUESTS]
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=10, grammar=g))
            for p, g in GRAMMAR_REQUESTS]
    jsched.run_until_idle()
    sched.run_until_idle()
    want = [r.tokens() for r in jreqs]
    got = [r.tokens() for r in reqs]
    assert got == want
    for (_, g), toks in zip(GRAMMAR_REQUESTS, got):
        if g is not None:
            gr = parse_gbnf(g)
            text = ttok.decode_bytes(toks).decode("utf-8", errors="replace")
            assert toks and gr.accept_text(gr.start_stacks(), text), text
    m = sched.metrics_snapshot()
    assert m["n_grammar_masks"] > 0 and m["t_grammar_s"] > 0


def test_grammar_needs_a_tokenizer(models):
    _, tm = models
    sched = Scheduler(tm, n_slots=1, max_seq=32, kv_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        sched.submit(Request(prompt_tokens=[5, 9], grammar='root ::= "yes"'))


def test_grammar_dead_end_fails_only_its_request(models):
    """A grammar no piece of the vocabulary can continue after its first
    token fails its own request; the other slot's request runs on."""
    _, tm = models
    tok = build_tokenizer(tm.vocab)
    sched = Scheduler(tm, n_slots=2, max_seq=32, sampler=SamplerConfig(temp=0.0),
                      kv_dtype=torch.float32, tokenizer=tok, device="cpu")
    # "h" then a character no piece gives (a lone byte >= 0x80 decodes to
    # U+FFFD): a dead end after the first token
    dead = sched.submit(Request(prompt_tokens=[5, 9], max_new_tokens=6,
                                grammar='root ::= "h" "é"'))
    free = sched.submit(Request(prompt_tokens=[7, 11], max_new_tokens=6))
    sched.run_until_idle()
    assert len(free.tokens()) == 6
    assert dead.tokens() == [tm.vocab.token_to_id["<0x68>"]]
    assert sched.metrics_snapshot()["n_errors"] == 1
