"""Speculative, prompt-lookup and lookahead decoding in the port
(`runtime/speculative.py`, `lookup.py`, `lookahead.py`) against the JAX
package's engines, on the CPU, f32: greedy streams must equal plain greedy
decoding (the lossless invariant) and the JAX drafters' streams, whatever
the draft; a self-draft accepts everything; the n-gram cache proposes what
the JAX one does."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.lookahead import LookaheadEngine  # noqa: E402
from sparkinfer_tpu_torch.runtime.lookup import LookupEngine, NgramCache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.speculative import (  # noqa: E402
    SpeculativeEngine,
    greedy_accept,
)
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

REPEAT = [3, 4, 3, 4, 3, 4, 3, 4, 3, 4, 3, 4]
LOOP = [5, 9, 42, 7, 5, 9, 42, 7, 5, 9]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    make_tiny_llama(d / "target.gguf", seed=0)
    make_tiny_llama(d / "draft.gguf", seed=9, n_layer=1)
    make_tiny_llama(d / "sparse.gguf", arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    return {k: str(d / f"{k}.gguf") for k in ("target", "draft", "sparse")}


def _eng(path, max_seq=96, **kw):
    return Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=max_seq,
                  sampler=kw.pop("sampler", SamplerConfig(temp=0.0)),
                  kv_dtype=torch.float32, device="cpu", **kw)


def _jax_eng(path, max_seq=96):
    return JaxEngine(jax_load(path, dtype=jnp.float32), max_seq=max_seq,
                     sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32, donate_cache=False)


def test_ngram_cache_proposals():
    from sparkinfer_tpu.runtime.lookup import NgramCache as JaxNgram

    toks = [1, 2, 3, 4, 1, 2, 3, 9, 2, 3]
    for n in (1, 2, 3):
        a, b = NgramCache(n), JaxNgram(n)
        a.update(toks)
        b.update(toks)
        assert a.index == b.index
        for k in (1, 3, 5):
            assert a.propose(toks, k) == b.propose(toks, k)
    assert NgramCache(2).propose([9, 9, 9], 3) == []


@pytest.mark.parametrize("t_toks,drafts,want", [
    ([4, 5, 6, 7], [4, 5, 6], (3, 7)), ([4, 0, 6, 7], [4, 5, 6], (1, 0)),
    ([9, 5, 6, 7], [4, 5, 6], (0, 9)), ([4, 5, 1, 1, 1], [4, 5], (2, 1)),
])
def test_greedy_accept(t_toks, drafts, want):
    assert greedy_accept(torch.tensor(t_toks), drafts) == want


def test_self_draft_accepts_everything(paths):
    t, d = _eng(paths["target"]), _eng(paths["target"])
    spec = SpeculativeEngine(t, d, n_draft=4)
    want = t.generate([3, 14, 15], max_new_tokens=12)
    assert spec.generate([3, 14, 15], max_new_tokens=12) == want
    assert spec.stats.accept_rate == 1.0


def test_imperfect_draft_matches_jax(paths):
    from sparkinfer_tpu.runtime.speculative import SpeculativeEngine as JaxSpec

    t, d = _eng(paths["target"]), _eng(paths["draft"])
    spec = SpeculativeEngine(t, d, n_draft=3)
    got = spec.generate([7, 30, 99], max_new_tokens=10)
    assert got == t.generate([7, 30, 99], max_new_tokens=10)  # lossless
    js = JaxSpec(_jax_eng(paths["target"]), _jax_eng(paths["draft"]), n_draft=3)
    assert got == js.generate([7, 30, 99], max_new_tokens=10)
    assert (spec.stats.n_rounds, spec.stats.n_accepted) == (js.stats.n_rounds,
                                                            js.stats.n_accepted)


def test_sparse_target_speculative(paths):
    """Sparse target (the pipelined FFN over v6's flat stores: the plain
    version at N = K+1 in the verify) and a dense draft: lossless."""
    t = _eng(paths["sparse"], max_seq=64, sparse=SparseConfig(16, 4))
    spec = SpeculativeEngine(t, _eng(paths["draft"], max_seq=64), n_draft=3)
    want = t.generate([7, 30, 99], max_new_tokens=8)
    assert spec.generate([7, 30, 99], max_new_tokens=8) == want
    assert len(t.graphs) == 2  # the decode step and the verify of T = 4


def test_stochastic_speculative_is_seeded(paths):
    t = _eng(paths["target"], sampler=SamplerConfig(temp=0.8, seed=3))
    spec = SpeculativeEngine(t, _eng(paths["draft"]), n_draft=3)
    out = spec.generate([7, 30], max_new_tokens=8, seed=3)
    assert 1 <= len(out) <= 8 and all(0 <= x < t.cfg.n_vocab for x in out)
    assert spec.generate([7, 30], max_new_tokens=8, seed=3) == out


def test_stochastic_acceptance_is_lossless_in_distribution():
    """Compare distributions, not draws: over many rounds the token emitted
    at the first position follows p_t, whatever p_d proposed."""
    gen = torch.Generator().manual_seed(0)
    p_t = torch.tensor([0.5, 0.3, 0.15, 0.05])
    p_d = torch.tensor([0.1, 0.2, 0.3, 0.4])
    logits = torch.log(torch.stack([p_t, p_t]))
    counts = torch.zeros(4)
    n = 4000
    for _ in range(n):
        d = int(torch.multinomial(p_d, 1, generator=gen))
        n_acc, nxt = SpeculativeEngine._stochastic(logits, [d], p_d[None], gen)
        counts[d if n_acc else nxt] += 1
    assert (counts / n - p_t).abs().max() < 0.03


@pytest.mark.parametrize("cls", ["lookup", "lookahead"])
@pytest.mark.parametrize("prompt,n_new", [(LOOP, 20), (REPEAT, 40)], ids=["loop", "repeat"])
def test_drafters_are_lossless_and_match_jax(paths, cls, prompt, n_new):
    from sparkinfer_tpu.runtime.lookahead import LookaheadEngine as JaxLookahead
    from sparkinfer_tpu.runtime.lookup import LookupEngine as JaxLookup

    eng = _eng(paths["target"], max_seq=160)
    want = eng.generate(prompt, max_new_tokens=n_new)
    port, jcls = ((LookupEngine, JaxLookup) if cls == "lookup"
                  else (LookaheadEngine, JaxLookahead))
    dr = port(eng, n_draft=4, ngram=2)
    assert dr.generate(prompt, max_new_tokens=n_new) == want
    jd = jcls(_jax_eng(paths["target"], max_seq=160), n_draft=4, ngram=2)
    assert jd.generate(prompt, max_new_tokens=n_new) == want
    assert (dr.stats.n_rounds, dr.stats.n_drafted, dr.stats.n_accepted) == (
        jd.stats.n_rounds, jd.stats.n_drafted, jd.stats.n_accepted)
    if prompt is REPEAT:
        assert dr.stats.n_accepted > 0


def test_drafters_stop_where_the_block_no_longer_fits(paths):
    eng = _eng(paths["target"], max_seq=24)
    out = LookupEngine(eng, n_draft=4, ngram=2).generate(REPEAT, max_new_tokens=40)
    assert 0 < len(out) < 40 and out == eng.generate(REPEAT, 40)[:len(out)]


@pytest.mark.parametrize("penalty", [dict(penalty_repeat=1.1), dict(penalty_present=0.2),
                                     dict(penalty_freq=0.3)], ids=["repeat", "present", "freq"])
@pytest.mark.parametrize("cls", ["speculative", "lookup", "lookahead"])
def test_drafters_refuse_penalties(paths, cls, penalty):
    """Drafts are accepted on the unpenalized logits, and verified tokens
    never enter the penalty ring: under penalties the stream would be
    neither penalized nor plain greedy decoding, so the drafters refuse it
    (the JAX drafters accept it); with the ring off (last_n 0) they run."""
    make = {"speculative": lambda t: SpeculativeEngine(t, _eng(paths["draft"]), n_draft=4),
            "lookup": lambda t: LookupEngine(t, n_draft=4),
            "lookahead": lambda t: LookaheadEngine(t, n_draft=4)}[cls]
    with pytest.raises(ValueError, match=f"{cls} decoding .* penalties"):
        make(_eng(paths["target"], sampler=SamplerConfig(temp=0.0, **penalty)))
    off = _eng(paths["target"], sampler=SamplerConfig(temp=0.0, penalty_last_n=0, **penalty))
    assert make(off).generate(LOOP, max_new_tokens=8) == off.generate(LOOP, 8)
