"""The port's packed Q4_0/Q8_0 path against the JAX package's, on the CPU.

Tolerances:
  - ggml encoders, repacks, the v6q/flat packers and the loaded packed
    tensors: bit-equal (same integer math, same f32 roundings);
  - plain quant_matmul_2d/_flat against the JAX Pallas kernels in interpret
    mode: rtol=atol=1e-5 (both sum exact bf16 products in f32, in another
    order);
  - forwards over keep_quantized models: logits at rtol=atol=1e-4 (f32 sums
    in other orders across a whole forward), greedy tokens equal. The
    products round their activations to bf16, so an activation that lies on
    a bf16 rounding boundary can round one way here and the other in JAX,
    which moves the tiny model's logits by about 1e-3 (the q8_0 fixture at
    seed 7 has one such activation); the seeds used here have none, and
    the comparison is deterministic on a given CPU;
  - the bf16 LM head on the JAX forward's own final hidden state: 1e-5 of
    the logits' scale (f32 sums of exact bf16 products).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.gguf.constants import GGMLType as JGGMLType  # noqa: E402
from sparkinfer_tpu.gguf.quants import quantize as jax_quantize  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_make_forward  # noqa: E402
from sparkinfer_tpu.ops import quant_matmul as jqm  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_init_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu_torch.gguf.constants import GGMLType  # noqa: E402
from sparkinfer_tpu_torch.gguf.quants import quantize  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import lm_head  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402

PROMPT = [5, 9, 42]
KINDS = ["q4_0", "q8_0"]


def _weights(seed, shape, scale=0.1):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1, 32)[0] = 0.0  # an all-zero block: scale 0, inverse 0
    x.reshape(-1, 32)[1] = 0.25  # a block of one value: ties at the max
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_is_bit_equal_to_jax(kind):
    x = _weights(0, (48, 96))
    x[2, 5] = -3.0  # a negative max: Q4_0 keeps the max element's sign
    ref = jax_quantize(x, getattr(JGGMLType, kind.upper()))
    got = quantize(torch.from_numpy(x), getattr(GGMLType, kind.upper()))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(NotImplementedError):
        quantize(torch.from_numpy(x), GGMLType.Q4_1)


@pytest.mark.parametrize("kind", KINDS)
def test_repack_and_layout_are_bit_equal_to_jax(kind):
    raw = jax_quantize(_weights(1, (40, 64)), getattr(JGGMLType, kind.upper()))
    ref = getattr(jqm, "repack_" + kind)(raw, 40, 64)
    got = tqm.REPACK[kind](raw, 40, 64)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    jt = jqm.QuantTensor.from_repack(*ref, kind)
    tt = tqm.QuantTensor.from_repack(*got, kind, "cpu")
    assert tt.shape == jt.shape == (64, 40)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_array_equal(tt.s.numpy(), np.asarray(jt.s))


def test_q8_packers_are_bit_equal_to_jax():
    from sparkinfer_tpu.ops.sparse_ffn_pallas import quantize_rows_q8_0 as jax_rows
    from sparkinfer_tpu_torch.ops.sparse_ffn import quantize_rows_q8_0

    w = _weights(2, (3, 64, 96))
    for transposed in (True, False):
        qj, sj = jax_rows(w, transposed=transposed)
        qt, st = quantize_rows_q8_0(torch.from_numpy(w))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), qj)
        np.testing.assert_array_equal(st.numpy(), sj)
    fj = jqm.flat_quantize(w)
    ft = tqm.flat_quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(ft.q.numpy(), np.asarray(fj.q))
    np.testing.assert_array_equal(ft.s.numpy(), np.asarray(fj.s))
    assert ft.shape == fj.shape == (64, 96) and ft.out_dim == 96


def _packed(kind, IN, OUT, seed, L=None):
    """A packed (QuantTensor, JAX QuantTensor) pair of random weights."""
    shape = (OUT, IN) if L is None else (L, OUT, IN)
    w = _weights(seed, shape)
    raw = [jax_quantize(wi, getattr(JGGMLType, kind.upper()))
           for wi in (w if L is not None else [w])]
    parts = [getattr(jqm, "repack_" + kind)(r, OUT, IN) for r in raw]
    qw = np.stack([p[0] for p in parts]) if L is not None else parts[0][0]
    sc = np.stack([p[1] for p in parts]) if L is not None else parts[0][1]
    return (tqm.QuantTensor.from_repack(qw, sc, kind, "cpu"),
            jqm.QuantTensor.from_repack(qw, sc, kind))


@pytest.mark.parametrize("kind,N,form", list(itertools.product(
    KINDS, [1, 4, 5, 8, 32], ["2d", "flat"])))
def test_plain_quant_matmul_matches_jax_kernel(kind, N, form):
    IN, OUT, L = 96, 40, 3
    x = np.random.default_rng(3).standard_normal((N, IN)).astype(np.float32)
    if form == "2d":
        tt, jt = _packed(kind, IN, OUT, seed=4)
        ref = jqm.quant_matmul_2d(jnp.asarray(x), jt.q, jt.s, kind=kind)
        got = tqm.quant_matmul_2d_plain(torch.from_numpy(x), tt.q, tt.s, kind=kind)
    else:  # a layer-stacked store, layer 1 of 3
        tt, jt = _packed(kind, IN, OUT, seed=5, L=L)
        jq = np.concatenate(list(np.asarray(jt.q)), axis=1)  # (in/div, L*out)
        js = np.concatenate(list(np.asarray(jt.s)), axis=1)
        ref = jqm.quant_matmul_flat(jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js),
                                    jnp.int32(1), kind=kind, out_dim=OUT)
        got = tqm.quant_matmul_flat_plain(torch.from_numpy(x), torch.from_numpy(jq),
                                          torch.from_numpy(js), 1, kind=kind, out_dim=OUT)
    assert got.dtype == torch.float32 and got.shape == (N, OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_quant_linear_on_cpu_runs_the_plain_version_uncounted():
    tt, _ = _packed("q8_0", 64, 40, seed=6, L=2)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 3, 64))
                         .astype(np.float32))
    before = (tqm.quant_matmul_2d.launches, tqm.quant_matmul_flat.launches)
    layers = tt.unbind(0)
    assert len(layers) == 2 and layers[1].shape == tt[1].shape == (64, 40)
    got = tqm.quant_linear(x, layers[1])
    ref = tqm.quant_matmul_2d_plain(x.reshape(6, 64), tt.q[1], tt.s[1], kind="q8_0")
    assert got.shape == (2, 3, 40) and got.dtype == torch.float32
    assert torch.equal(got.reshape(6, 40), ref)
    xb = x.to(torch.bfloat16)
    assert tqm.quant_linear(xb, layers[0]).dtype == torch.bfloat16  # x.dtype out
    flat = tqm.flat_quantize(torch.randn(2, 64, 40))
    with pytest.raises(ValueError, match="layer index"):
        tqm.quant_linear(x, flat)
    assert tqm.quant_linear(x, flat.with_il(1)).shape == (2, 3, 40)
    assert (tqm.quant_matmul_2d.launches, tqm.quant_matmul_flat.launches) == before


@pytest.fixture(scope="module", params=KINDS)
def quant_gguf(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / f"tiny-{request.param}.gguf"
    make_tiny_llama(path, quant_type=request.param, seed=0)
    return request.param, str(path)


def test_keep_quantized_loader_matches_jax(quant_gguf):
    kind, path = quant_gguf
    jm = jax_load(path, dtype=jnp.float32, keep_quantized=True)
    tm = load_model(path, dtype=torch.float32, device="cpu", keep_quantized=True)
    packed = ["wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"]
    for key, tw, jw in [("output", tm.params["output"], jm.params["output"])] + [
            (k, tm.params["layers"][k], jm.params["layers"][k]) for k in packed]:
        assert isinstance(tw, tqm.QuantTensor) and tw.kind == jw.kind == kind, key
        assert tw.shape == jw.shape, key
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q), err_msg=key)
        np.testing.assert_array_equal(tw.s.numpy(), np.asarray(jw.s), err_msg=key)
    np.testing.assert_array_equal(tm.params["tok_embd"].numpy(),
                                  np.asarray(jm.params["tok_embd"]))


def test_keep_quantized_forward_matches_jax(quant_gguf):
    kind, path = quant_gguf
    je = JaxEngine(jax_load(path, dtype=jnp.float32, keep_quantized=True), max_seq=64,
                   sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32)
    pe = Engine(load_model(path, dtype=torch.float32, device="cpu", keep_quantized=True),
                max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                device="cpu")
    cache = je.new_cache()
    lg, cache = je.fwd_prefill(je.model.params, jnp.asarray([PROMPT], jnp.int32),
                               jnp.arange(len(PROMPT), dtype=jnp.int32)[None], cache)
    first = int(jnp.argmax(lg[0, -1]))
    lg2, _ = je.fwd_decode(je.model.params, jnp.asarray([[first]], jnp.int32),
                           jnp.asarray([[len(PROMPT)]], jnp.int32), cache)
    pc, st = pe.new_cache(), pe.new_sampler_state()
    tok, pc, st, n = pe.prefill(PROMPT, pc, st)
    assert tok == first
    np.testing.assert_allclose(pe.last_logits.numpy(), np.asarray(lg[:, -1]),
                               rtol=1e-4, atol=1e-4)
    pe.decode_step(tok, n, pc, st)
    np.testing.assert_allclose(pe.last_logits.numpy(), np.asarray(lg2[:, -1]),
                               rtol=1e-4, atol=1e-4)
    assert pe.generate(PROMPT, 8) == je.generate(PROMPT, 8)


def test_bf16_head_keeps_f32_products(tmp_path):
    """The bf16 head gives f32 sums of exact bf16 products, as the JAX head
    (einsum with preferred_element_type=f32): on the JAX forward's own
    final hidden state, the logits agree to 1e-5 of their scale. A head
    that rounded the logits to bf16 would miss by about 4e-3 of it."""
    path = tmp_path / "tiny.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=8, n_ff=96, seed=5)
    jm = jax_load(str(path), dtype=jnp.bfloat16)
    fwd = jax_make_forward(jm.config, with_hidden=True)
    cache = jax_init_cache(jm.config, 1, 64, jnp.bfloat16)
    logits, _, hidden = fwd(jm.params, jnp.asarray([PROMPT], jnp.int32),
                            jnp.arange(len(PROMPT), dtype=jnp.int32)[None], cache)
    assert hidden.dtype == jnp.bfloat16 and logits.dtype == jnp.float32
    tm = load_model(str(path), dtype=torch.bfloat16, device="cpu")
    h = torch.from_numpy(np.array(hidden.astype(jnp.float32))).to(torch.bfloat16)
    got = lm_head(h, tm.params["output"])
    ref = np.asarray(logits)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.bfloat16)
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0),
                kv_dtype=torch.bfloat16, device="cpu")
    assert pe.generate(PROMPT, 8) == je.generate(PROMPT, 8)
