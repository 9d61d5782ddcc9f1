"""The port's plain ops against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerance: f32 at 1e-6 absolute and relative; the two compute the same
formulas and differ only in the last bits of transcendental functions.
Sampling draws come from different generators, so the masks and the greedy
choice are compared, not draws.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sparkinfer_tpu.gguf import quants as jquants  # noqa: E402
from sparkinfer_tpu.gguf.constants import GGMLType  # noqa: E402
from sparkinfer_tpu.ops import activations as jact  # noqa: E402
from sparkinfer_tpu.ops import norms as jnorms  # noqa: E402
from sparkinfer_tpu.ops import rope as jrope  # noqa: E402
from sparkinfer_tpu.runtime import kv_cache as jkv  # noqa: E402
from sparkinfer_tpu.runtime import sampling as jsamp  # noqa: E402
from sparkinfer_tpu_torch.gguf import quants as tquants  # noqa: E402
from sparkinfer_tpu_torch.ops import activations as tact  # noqa: E402
from sparkinfer_tpu_torch.ops import norms as tnorms  # noqa: E402
from sparkinfer_tpu_torch.ops import rope as trope  # noqa: E402
from sparkinfer_tpu_torch.runtime import kv_cache as tkv  # noqa: E402
from sparkinfer_tpu_torch.runtime import sampling as tsamp  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


def test_rms_norm_matches_jax():
    rng = _rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("mode", ["norm", "neox"])
@pytest.mark.parametrize("yarn", [False, True])
def test_apply_rope_matches_jax(mode, yarn):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    kw = dict(freq_scale=0.25, yarn_orig_ctx=64, yarn_ext_factor=1.0) if yarn else {}
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      jrope.RopeParams(dim=16, mode=mode, **kw)))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           trope.RopeParams(dim=16, mode=mode, **kw)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_partial_rope_keeps_the_tail():
    x = torch.randn(1, 3, 2, 16, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(3)[None]
    out = trope.apply_rope(x, pos, trope.RopeParams(dim=8, mode="neox"))
    assert torch.equal(out[..., 8:], x[..., 8:])
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()),
                                      jrope.RopeParams(dim=8, mode="neox")))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("name", ["silu", "swiglu", "fatrelu", "drelu", "relu"])
def test_act_fn_matches_jax(name):
    rng = _rng(2)
    g = rng.standard_normal((4, 33)).astype(np.float32)
    u = rng.standard_normal((4, 33)).astype(np.float32)
    jg, jf = jact.act_fn(name, 0.1)
    tg, tf = tact.act_fn(name, 0.1)
    assert jg == tg
    if jg:
        ref = np.asarray(jf(jnp.asarray(g), jnp.asarray(u)))
        got = tf(torch.from_numpy(g), torch.from_numpy(u)).numpy()
    else:
        ref = np.asarray(jf(jnp.asarray(u)))
        got = tf(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_act_fn_rejects_unported():
    with pytest.raises(NotImplementedError):
        tact.act_fn("swiglu_oai")


@pytest.mark.parametrize("gtype", [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.F16,
                                   GGMLType.BF16, GGMLType.F32])
def test_dequantize_matches_jax(gtype):
    x = _rng(3).standard_normal(256).astype(np.float32)
    raw = jquants.quantize(x, gtype)
    ref = jquants.dequantize_tensor(raw, gtype, (8, 32))
    got = tquants.dequantize_tensor(raw, gtype, (8, 32))
    np.testing.assert_array_equal(got, ref)


def test_dequantize_rejects_unported():
    raw = jquants.quantize(np.zeros(256, np.float32), GGMLType.Q4_K)
    with pytest.raises(NotImplementedError):
        tquants.dequantize_tensor(raw, GGMLType.Q4_K, (256,))


def test_kv_write_read_matches_jax():
    rng = _rng(4)
    kc = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    pos = np.array([[0, 1, 2], [5, 6, 9]], np.int32)  # 9 clamps to slot 7
    ref, _ = jkv.write_layer(jnp.asarray(kc), None, jnp.asarray(new), jnp.asarray(pos))
    got = torch.from_numpy(kc.copy())
    tkv.write_layer(got, torch.from_numpy(new), torch.from_numpy(pos))
    np.testing.assert_array_equal(tkv.read_layer(got, torch.float32).numpy(),
                                  np.asarray(ref))


@pytest.mark.parametrize("mask,arg", [("top_k", 5), ("top_p", 0.7), ("min_p", 0.05)])
def test_sampler_masks_match_jax(mask, arg):
    logits = (_rng(5).standard_normal((3, 50)) * 3).astype(np.float32)
    jfn = {"top_k": jsamp._top_k_mask, "top_p": jsamp._top_p_mask,
           "min_p": jsamp._min_p_mask}[mask]
    ref = np.stack([np.asarray(jfn(jnp.asarray(row), arg)) for row in logits])
    got = getattr(tsamp, mask + "_mask")(torch.from_numpy(logits), arg).numpy()
    np.testing.assert_array_equal(got, ref)


def test_greedy_takes_first_max_like_jax():
    logits = np.array([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]], np.float32)
    got = tsamp.sample(torch.from_numpy(logits), tsamp.SamplerConfig(temp=0.0))
    ref = [int(jnp.argmax(jnp.asarray(row))) for row in logits]
    assert got.tolist() == ref == [1, 0]


def test_sampling_draws_stay_in_the_mask():
    logits = torch.from_numpy((_rng(6).standard_normal((2, 100)) * 2).astype(np.float32))
    cfg = tsamp.SamplerConfig(temp=1.0, top_k=3, top_p=1.0, min_p=0.0)
    allowed = torch.topk(logits, 3, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsamp.sample(logits, cfg, gen)
        assert all(int(t) in allowed[i].tolist() for i, t in enumerate(tok))
    a = tsamp.sample(logits, cfg, torch.Generator().manual_seed(7))
    b = tsamp.sample(logits, cfg, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
