"""The Engine's static sampler chain (`runtime/sampling.chain_sample`) and
context shift (`runtime/kv_cache.shift_cache`) against the JAX package, on
the CPU, f32.

Masks match the JAX chain's exactly (typical through the per-row stages
with every other knob neutral, xtc with a forced draw);
mirostat v2's truncation holds every token the JAX sampler draws over 256
keys, and its update of mu for a given draw is the JAX one within 1e-5
relative; greedy streams with repetition, frequency and presence penalties
and through context shifts are the JAX Engine's token for token; shifted
cache rows equal the JAX shift's within 1e-5 relative (f32 rope)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime import sampling as jsamp  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.runtime import sampling as tsamp  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402

PROMPT = [5, 9, 42, 7]
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny.gguf"
    make_tiny_llama(path)
    return str(path)


@pytest.fixture(scope="module")
def models(gguf):
    return (jax_load(gguf, dtype=jnp.float32),
            load_model(gguf, dtype=torch.float32, device="cpu"))


def _logits(seed, V=200, scale=3.0):
    return np.random.default_rng(seed).standard_normal((1, V)).astype(np.float32) * scale


@pytest.mark.parametrize("p", [0.2, 0.5, 0.9])
def test_typical_mask_matches_jax(p):
    lf = _logits(1)
    want = np.asarray(jsamp._typical_mask(jnp.asarray(lf[0]), p))
    dp = tsamp.stack_params([tsamp.dynamic_params(tsamp.SamplerConfig(
        top_k=0, top_p=1.0, min_p=0.0, typical_p=p))])
    got = tsamp._truncate(torch.from_numpy(lf), dp, None, 0.1)[0].numpy()
    np.testing.assert_array_equal(got <= tsamp.NEG_INF / 2, want <= jsamp.NEG_INF / 2)


@pytest.mark.parametrize("threshold", [0.02, 0.05, 0.2])
def test_xtc_mask_matches_jax(threshold):
    """Probability 1 forces the draw: the masks must be the JAX ones."""
    lf = _logits(2, scale=1.5)
    want = np.asarray(jsamp._xtc(jnp.asarray(lf[0]), jax.random.PRNGKey(0), 1.0, threshold))
    got = tsamp.xtc_mask(torch.from_numpy(lf), torch.zeros(1), 1.0, threshold)[0].numpy()
    np.testing.assert_array_equal(got <= tsamp.NEG_INF / 2, want <= jsamp.NEG_INF / 2)


@pytest.mark.parametrize("mu,temp", [(2.0, 1.0), (6.0, 0.7), (10.0, 1.3)])
def test_mirostat_mask_and_update_match_jax(mu, temp):
    cfg = jsamp.SamplerConfig(temp=temp, mirostat=2, mirostat_tau=5.0, mirostat_eta=0.1)
    sample = jax.jit(jax.vmap(jsamp.make_sampler(cfg), in_axes=(None, 0)))
    lf = _logits(3)
    st = jsamp.init_state(cfg)._replace(mirostat_mu=jnp.asarray(mu, jnp.float32))
    keys = jax.random.split(jax.random.PRNGKey(7), 256)
    states = jax.vmap(lambda k: st._replace(key=k))(keys)
    toks, new = sample(jnp.asarray(lf[0]), states)
    masked, s = tsamp.mirostat_mask(torch.from_numpy(lf), torch.tensor([mu]), temp)
    allowed = masked[0] > tsamp.NEG_INF / 2
    toks = np.array(toks)
    assert allowed[torch.from_numpy(toks).long()].all()  # every JAX draw lies in the mask
    assert int(allowed.sum()) >= len(set(toks.tolist()))
    for tok, mu_new in list(zip(toks, np.asarray(new.mirostat_mu)))[:8]:
        got = tsamp.mirostat_update(torch.tensor([mu]), s, torch.tensor([int(tok)]), 5.0, 0.1)
        np.testing.assert_allclose(got.numpy(), [mu_new], rtol=1e-5)


def test_mirostat_engine_updates_mu_in_place(models):
    _, tm = models
    pe = Engine(tm, max_seq=64, sampler=tsamp.SamplerConfig(temp=0.9, mirostat=2,
                                                         penalty_repeat=1.1),
                kv_dtype=torch.float32, device="cpu")
    mu = pe.sstate.mirostat_mu
    a = pe.generate(PROMPT, 12, seed=4)
    assert pe.sstate.mirostat_mu is mu and float(mu) != 10.0
    assert pe.generate(PROMPT, 12, seed=4) == a  # reset by new_sampler_state
    assert int(pe.sstate.recent_pos) == 12  # the ring holds every token under penalties


@pytest.mark.parametrize("kw", [
    dict(penalty_repeat=1.3, penalty_last_n=8),
    dict(penalty_freq=0.6, penalty_present=0.4),
    dict(penalty_repeat=1.2, penalty_freq=0.2, penalty_last_n=64),
], ids=["repeat", "freq_present", "all"])
def test_engine_penalties_match_jax(models, kw):
    jm, tm = models
    je = JaxEngine(jm, max_seq=64, sampler=jsamp.SamplerConfig(temp=0.0, **kw),
                   kv_dtype=jnp.float32)
    pe = Engine(tm, max_seq=64, sampler=tsamp.SamplerConfig(temp=0.0, **kw),
                kv_dtype=torch.float32, device="cpu")
    assert pe.generate(PROMPT, 24) == je.generate(PROMPT, 24)


def test_engine_sampled_chain_is_seeded(models):
    """typical, xtc, top-k/p, min-p and penalties together: a seeded stream
    repeats, a different seed differs."""
    _, tm = models
    sc = tsamp.SamplerConfig(temp=0.9, typical_p=0.8, xtc_probability=0.5,
                             xtc_threshold=0.05, penalty_repeat=1.1)
    pe = Engine(tm, max_seq=64, sampler=sc, kv_dtype=torch.float32, device="cpu")
    a = pe.generate(PROMPT, 16, seed=1)
    assert pe.generate(PROMPT, 16, seed=1) == a
    assert pe.generate(PROMPT, 16, seed=2) != a


@pytest.mark.parametrize("max_seq,n_keep", [(16, -1), (24, 2), (20, 0)])
def test_context_shift_matches_jax(models, max_seq, n_keep):
    jm, tm = models
    je = JaxEngine(jm, max_seq=max_seq, sampler=jsamp.SamplerConfig(temp=0.0),
                   kv_dtype=jnp.float32)
    pe = Engine(tm, max_seq=max_seq, sampler=tsamp.SamplerConfig(temp=0.0),
                kv_dtype=torch.float32, device="cpu")
    want = je.generate(PROMPT, 48, n_keep=n_keep)
    assert pe.generate(PROMPT, 48, n_keep=n_keep) == want and len(want) == 48
    assert pe.graphs.captures == 0 and len(pe.graphs) == 1  # one step, one cache


def test_shift_cache_matches_jax(models):
    from sparkinfer_tpu.models.transformer import rope_params as jrope
    from sparkinfer_tpu.runtime.kv_cache import KVCache as JKV
    from sparkinfer_tpu.runtime.kv_cache import shift_cache as jshift
    from sparkinfer_tpu_torch.models.transformer import rope_params
    from sparkinfer_tpu_torch.runtime.kv_cache import KVCache, shift_cache

    jm, tm = models
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 2, 32, 4, 16)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    want = jshift(JKV(k=jnp.asarray(k), v=jnp.asarray(v)), jrope(jm.config), 3, 9, 29)
    cache = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    k_ptr = cache.k.data_ptr()
    got = shift_cache(cache, rope_params(tm.config), 3, 9, 29)
    assert got is cache and cache.k.data_ptr() == k_ptr  # in place
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(want.k), **TOL)
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want.v))
