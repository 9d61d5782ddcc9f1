"""Self-Extend group attention in the port (`runtime/self_extend.py`):
label maps against a direct port of the reference's seq_add/seq_div loop
(tools/main/main.cpp:992-1004) and against the JAX module, incremental
equal to batch, re-rotation exactness (f32, 2e-5 as the JAX test), and the
Engine's stream against the JAX Engine's, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.runtime import self_extend as jse  # noqa: E402
from sparkinfer_tpu_torch.runtime.self_extend import (  # noqa: E402
    SelfExtendState,
    advance,
    apply_to_cache,
)


def ref_self_extend_labels(n_tokens: int, ga_n: int, ga_w: int):
    """The reference loop: labels mutated by the seq_add / seq_div / seq_add
    triplet as n_past grows token by token."""
    pos = []
    ga_i = 0
    n_past = 0
    for _ in range(n_tokens):
        pos.append(n_past)
        n_past += 1
        while n_past >= ga_i + ga_w:
            ib = (ga_n * ga_i) // ga_w
            bd = (ga_w // ga_n) * (ga_n - 1)
            dd = (ga_w // ga_n) - ib * bd - ga_w
            p = np.asarray(pos)
            m1 = (p >= ga_i) & (p < n_past)
            p = np.where(m1, p + ib * bd, p)
            m2 = (p >= ga_i + ib * bd) & (p < ga_i + ib * bd + ga_w)
            p = np.where(m2, p // ga_n, p)
            m3 = (p >= ga_i + ib * bd + ga_w) & (p < n_past + ib * bd)
            p = np.where(m3, p + dd, p)
            pos = list(p)
            n_past -= bd
            ga_i += ga_w // ga_n
    return np.asarray(pos), n_past


@pytest.mark.parametrize("ga_n,ga_w,n", [(2, 8, 40), (4, 16, 100), (2, 4, 9), (4, 64, 200)])
def test_label_map_matches_reference_and_jax(ga_n, ga_w, n):
    st, jst = SelfExtendState(ga_n=ga_n, ga_w=ga_w), jse.SelfExtendState(ga_n=ga_n, ga_w=ga_w)
    for t in range(1, n + 1):
        d, jd = advance(st, t), jse.advance(jst, t)
        assert (d is None) == (jd is None)
        if d is not None:
            np.testing.assert_array_equal(d, jd)
    ref, ref_n_past = ref_self_extend_labels(n, ga_n, ga_w)
    np.testing.assert_array_equal(st.labels[:n], ref)
    assert n - st.gamma == ref_n_past
    assert st.labels.max() < n


def test_labels_incremental_equals_batch():
    a = SelfExtendState(ga_n=2, ga_w=8)
    for t in range(1, 61):
        advance(a, t)
    b = SelfExtendState(ga_n=2, ga_w=8)
    advance(b, 60)
    np.testing.assert_array_equal(a.labels[:60], b.labels[:60])
    assert a.gamma == b.gamma and a.ga_i == b.ga_i


def test_rerotation_exactness():
    """After advances, the keys equal roping the raw keys at label+gamma:
    the in-place re-rotations compose exactly."""
    from sparkinfer_tpu_torch.ops.rope import RopeParams, apply_rope
    from sparkinfer_tpu_torch.runtime.kv_cache import KVCache

    rng = np.random.default_rng(0)
    L, B, S, H, D = 2, 1, 64, 2, 16
    raw_k = torch.from_numpy(rng.standard_normal((L, B, S, H, D)).astype(np.float32))
    rp = RopeParams(dim=D, freq_base=10000.0, mode="neox")
    st = SelfExtendState(ga_n=2, ga_w=8)
    cache = KVCache(k=torch.zeros((L, B, S, H, D)), v=torch.zeros((L, B, S, H, D)))
    k_ptr = cache.k.data_ptr()
    n = 40
    for t in range(n):
        cache.k[:, :, t:t + 1] = apply_rope(raw_k[:, :, t:t + 1], torch.tensor([t]), rp)
        delta = advance(st, t + 1)
        if delta is not None:
            assert apply_to_cache(cache, rp, delta) is cache
    assert cache.k.data_ptr() == k_ptr
    rot = torch.as_tensor(st.labels[:n] + st.gamma)
    want = apply_rope(raw_k[:, :, :n], rot, rp)
    np.testing.assert_allclose(cache.k[:, :, :n].numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("se,max_seq,n_new", [((2, 8), 96, 40), ((4, 16), 64, 70)])
def test_engine_self_extend_matches_jax(tmp_path, se, max_seq, n_new):
    from sparkinfer_tpu.models.loader import load_model as jax_load
    from sparkinfer_tpu.runtime.engine import Engine as JaxEngine
    from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler
    from sparkinfer_tpu_torch.models.loader import load_model
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig

    path = str(tmp_path / "t.gguf")
    make_tiny_llama(path)
    je = JaxEngine(jax_load(path, dtype=jnp.float32), max_seq=max_seq,
                   sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32, self_extend=se)
    pe = Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=max_seq,
                sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32, device="cpu",
                self_extend=se)
    want = je.generate([5, 9, 42, 7], max_new_tokens=n_new)
    got = pe.generate([5, 9, 42, 7], max_new_tokens=n_new)
    assert got == want
    assert pe.self_extend.ga_i > 0 and pe.self_extend.gamma == je.self_extend.gamma
    # a second sequence groups from scratch (the JAX Engine keeps the first's
    # state, so it is no reference here): equal to a fresh port engine's
    fresh = Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=max_seq,
                   sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32, device="cpu",
                   self_extend=se)
    assert pe.generate([7, 1, 3], max_new_tokens=n_new) == fresh.generate([7, 1, 3], n_new)
    # a short generation never fills the window: plain decoding
    plain = Engine(load_model(path, dtype=torch.float32, device="cpu"), max_seq=max_seq,
                   sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32, device="cpu")
    assert pe.generate([5, 9, 42, 7], 3) == plain.generate([5, 9, 42, 7], 3)
