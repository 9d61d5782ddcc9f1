"""Row-wise W8A8 (ops/quant_matmul.py W8A8Tensor, w8a8_linear) against the
JAX package, on the CPU.

Tolerances: from_float and the loaded W8A8 params are bit-equal (the same
f32 roundings in the same order); w8a8_linear is bit-equal to the JAX
function run op by op (jitted, XLA folds the two scale multiplies into one
and moves the last bit); forwards over W8A8 attention, head and predictor
stacks give logits within 1e-5 of the JAX forward's largest logit (f32 sums
in other orders) and equal greedy streams.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.ops import quant_matmul as jqm  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse import predictor as jpred  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse import predictor as tpred  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

PROMPT = [5, 9, 42]
ATTN = ("wq", "wk", "wv", "wo")
PRED = ("pred_up", "pred_up_b", "pred_down", "pred_down_b")
GQ, CAPQ = 16, 4  # the sparse engines' group size and capacity


def _w(seed, shape, scale=0.05):
    w = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    w[..., 0, 3] = 0.0
    w[..., :, 5] = 0.0  # an all-zero column: scale 0, inverse 0
    return w


def _same(t: tqm.W8A8Tensor, j):
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 40)])
def test_from_float_is_bit_equal_to_jax(shape):
    w = _w(0, shape)
    t = tqm.W8A8Tensor.from_float(torch.from_numpy(w))
    _same(t, jqm.W8A8Tensor.from_float(w))
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
    assert t.q.mT.is_contiguous() and t.shape == shape and t.ndim == len(shape)
    _same(tqm.W8A8Tensor.from_float(w), jqm.W8A8Tensor.from_float(w))  # numpy in


def test_stack_fills_indexes_unbinds_and_rolls_per_layer():
    w = _w(1, (3, 64, 40))
    ref = jqm.W8A8Tensor.from_float(w)
    st = tqm.W8A8Tensor.empty((3, 64, 40), "cpu")
    for il in range(3):
        st[il] = tqm.W8A8Tensor.from_float(torch.from_numpy(w[il]))
    _same(st, ref)  # a layer at a time gives the stack's bits
    assert st.q.mT.is_contiguous()
    for il, layer in enumerate(st.unbind(0)):
        _same(layer, ref[il])
        _same(st[il], ref[il])
    rolled = st.roll(-1)
    assert rolled.q.mT.is_contiguous()
    _same(rolled[0], ref[1])
    _same(rolled[2], ref[0])


@pytest.mark.parametrize("N", [1, 5, 32])
def test_w8a8_linear_is_bit_equal_to_jax(N):
    w = _w(2, (64, 48))
    jw, tw = jqm.W8A8Tensor.from_float(w), tqm.W8A8Tensor.from_float(w)
    x = (np.random.default_rng(3).standard_normal((N, 64)) * 3).astype(np.float32)
    x[0, :7] = 0.0
    with jax.disable_jit():
        ref = np.asarray(jqm.w8a8_linear(jnp.asarray(x), jw))
        ref_f32 = np.asarray(jqm.w8a8_linear(jnp.asarray(x).astype(jnp.bfloat16), jw,
                                             out_dtype=jnp.float32))
    got = tqm.w8a8_linear(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(tqm.w8a8_linear(xb, tw, out_dtype=torch.float32).numpy(),
                                  ref_f32)
    assert tqm.w8a8_linear(xb, tw).dtype == torch.bfloat16  # x.dtype out
    # one quantization shared by several weights gives the same bits
    xq = tqm.w8a8_quantize(torch.from_numpy(x).reshape(1, N, 64))
    np.testing.assert_array_equal(
        tqm.quant_linear(torch.from_numpy(x).reshape(1, N, 64), tw, xq).numpy()[0], ref)


def test_int8_matmul_on_cpu_is_the_exact_product_uncounted():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 96), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (96, 40), dtype=np.int8))
    before = tqm.int8_matmul.launches
    got = tqm.int8_matmul(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64)
                                  @ b.numpy().astype(np.int64))
    assert torch.equal(got, tqm.int8_matmul_plain(a, b))
    assert tqm.int8_matmul.launches == before


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("models") / "tiny-prosparse.gguf"
    make_tiny_llama(path, arch="prosparse_llama", pred_rank=32, n_ff=96, seed=4)
    return str(path)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attn_w8a8_loader_matches_jax(gguf, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jax_load(gguf, dtype=jdt, attn_w8a8=True)
    tm = load_model(gguf, dtype=tdt, device="cpu", attn_w8a8=True)
    for k in ATTN:
        assert isinstance(tm.params["layers"][k], tqm.W8A8Tensor), k
        _same(tm.params["layers"][k], jm.params["layers"][k])
    assert tm.params["layers"]["w_up"].dtype == tdt  # the FFN stays dense
    packed = load_model(gguf, device="cpu", attn_w8a8=True, keep_quantized=True)
    assert isinstance(packed.params["layers"]["wq"], tqm.W8A8Tensor)  # f32 weights: dense


def _jax_logits(je, prompt=PROMPT):
    cache = je.new_cache()
    lg, cache = je.fwd_prefill(je.model.params, jnp.asarray([prompt], jnp.int32),
                               jnp.arange(len(prompt), dtype=jnp.int32)[None], cache)
    first = int(jnp.argmax(lg[0, -1]))
    lg2, _ = je.fwd_decode(je.model.params, jnp.asarray([[first]], jnp.int32),
                           jnp.asarray([[len(prompt)]], jnp.int32), cache)
    return np.asarray(lg[:, -1]), np.asarray(lg2[:, -1]), first


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _compare(je, pe, n=12):
    pre, dec, first = _jax_logits(je)
    cache, st = pe.new_cache(), pe.new_sampler_state()
    tok, cache, st, n_past = pe.prefill(PROMPT, cache, st)
    assert tok == first
    _close(pe.last_logits.numpy(), pre)
    pe.decode_step(tok, n_past, cache, st)
    _close(pe.last_logits.numpy(), dec)
    assert pe.generate(PROMPT, n) == je.generate(PROMPT, n)


def _engines(gguf, head=False):
    jm = jax_load(gguf, dtype=jnp.float32, attn_w8a8=True)
    tm = load_model(gguf, dtype=torch.float32, device="cpu", attn_w8a8=True)
    if head:
        jm.params["output"] = jqm.W8A8Tensor.from_float(np.asarray(jm.params["output"]))
        tm.params["output"] = tqm.W8A8Tensor.from_float(tm.params["output"])
    return (JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32),
            Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                   device="cpu"))


@pytest.mark.parametrize("head", [False, True], ids=["attention", "attention+head"])
def test_attn_w8a8_forward_matches_jax(gguf, head):
    je, pe = _engines(gguf, head)
    if head:
        assert isinstance(pe.params["output"], tqm.W8A8Tensor)
    _compare(je, pe)


def _w8_sparse_model(load, prepare, from_float, path, **kw):
    """W8A8 attention, the v6 flat FFN stores (the dense FFN dropped) and
    W8A8 predictor stacks from one GGUF, with either package's functions."""
    model = load(path, attn_w8a8=True, **kw)
    layers = dict(model.params["layers"])
    pred = {k: layers.pop(k) for k in PRED}
    params = prepare(dict(model.params, layers=layers), model.config)
    params["sparse_flat"].update(
        pred_up_w8=from_float(pred["pred_up"]), pred_down_w8=from_float(pred["pred_down"]),
        pred_up_b_all=pred["pred_up_b"], pred_down_b_all=pred["pred_down_b"])
    model.params = params
    return model, pred


def test_w8a8_predictor_stacks_sparse_engine_matches_jax(gguf):
    jm, jp = _w8_sparse_model(
        jax_load, lambda p, c: jffn.prepare_pipelined_params(
            p, c, JaxSparseConfig(GQ, CAPQ), drop_dense=True, layout="v6"),
        lambda w: jqm.W8A8Tensor.from_float(np.asarray(w)), gguf, dtype=jnp.float32)
    # the JAX pipelined FFN routes to the stacks on "pred_up_all" only
    jm.params["sparse_flat"]["pred_up_all"] = jp["pred_up"]
    tm, _ = _w8_sparse_model(
        lambda p, **kw: load_model(p, device="cpu", **kw),
        lambda p, c: tffn.prepare_pipelined_params(p, c, SparseConfig(GQ, CAPQ),
                                                   drop_dense=True, layout="v6"),
        tqm.W8A8Tensor.from_float, gguf, dtype=torch.float32)
    flat = tm.params["sparse_flat"]
    assert isinstance(flat["pred_up_w8"], tqm.W8A8Tensor) and "pred_up_all" not in flat
    for k in ("pred_up_w8", "pred_down_w8"):
        _same(flat[k], jm.params["sparse_flat"][k])
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                   sparse=JaxSparseConfig(GQ, CAPQ), sparse_decode_mode="pallas",
                   sparse_preprepared=True)
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                sparse=SparseConfig(GQ, CAPQ), sparse_preprepared=True, device="cpu")
    _compare(je, pe, n=8)


def test_w8a8_predictor_matches_jax_per_layer_and_stacked(gguf):
    """resolve_predictor over W8A8 stacks (layer 1 of 2), and per-layer W8A8
    slices rolled into `_nx` by prepare_pipelined_params."""
    jm = jax_load(gguf, dtype=jnp.float32)
    tm = load_model(gguf, dtype=torch.float32, device="cpu")
    lj, lt = jm.params["layers"], tm.params["layers"]
    fj = {"pred_up_w8": jqm.W8A8Tensor.from_float(np.asarray(lj["pred_up"])),
          "pred_down_w8": jqm.W8A8Tensor.from_float(np.asarray(lj["pred_down"])),
          "pred_up_b_all": lj["pred_up_b"], "pred_down_b_all": lj["pred_down_b"]}
    ft = {"pred_up_w8": tqm.W8A8Tensor.from_float(lt["pred_up"]),
          "pred_down_w8": tqm.W8A8Tensor.from_float(lt["pred_down"]),
          "pred_up_b_all": lt["pred_up_b"], "pred_down_b_all": lt["pred_down_b"]}
    x = np.random.default_rng(9).standard_normal((5, 64)).astype(np.float32)
    ref = np.asarray(jpred.predict_activations(dict(fj, flat_il=1), jnp.asarray(x)))
    got = tpred.predict_activations(dict(ft, flat_il=1), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    layers = dict(lt, pred_up=ft["pred_up_w8"], pred_down=ft["pred_down_w8"])
    pp = tffn.prepare_pipelined_params(dict(tm.params, layers=layers), tm.config,
                                       SparseConfig(GQ, CAPQ))
    nx = pp["layers"]["pred_up_nx"]
    assert isinstance(nx, tqm.W8A8Tensor)
    _same(nx[0], fj["pred_up_w8"][1])  # layer 0 holds layer 1's predictor
    per = {k: v[0] for k, v in pp["layers"].items() if k.startswith("pred_")}
    per = {k[:-3]: v for k, v in per.items() if k.endswith("_nx")}
    np.testing.assert_allclose(tpred.predict_activations(per, torch.from_numpy(x)).numpy(),
                               ref, rtol=1e-5, atol=1e-6)


def test_from_jax_carries_a_w8a8_model(gguf):
    jm = jax_load(gguf, dtype=jnp.float32, attn_w8a8=True)
    jm.params["output"] = jqm.W8A8Tensor.from_float(np.asarray(jm.params["output"]))
    got = params_from_numpy(jax.tree.map(np.asarray, jm.params), "cpu")
    tm = load_model(gguf, dtype=torch.float32, device="cpu", attn_w8a8=True)
    for k in ATTN:
        t = got["layers"][k]
        assert isinstance(t, tqm.W8A8Tensor) and t.q.mT.is_contiguous(), k
        _same(t, tm.params["layers"][k])
    assert isinstance(got["output"], tqm.W8A8Tensor)
    _same(got["output"], jm.params["output"])
    tm.params = got
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                device="cpu")
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32)
    assert pe.generate(PROMPT, 8) == je.generate(PROMPT, 8)


def test_lora_into_w8a8_attention_raises_naming_both_flags(gguf, tmp_path):
    from sparkinfer_tpu_torch.models.lora import LoraMerger, apply_lora
    from test_torch_lora import write_lora

    path = tmp_path / "a.gguf"
    write_lora(path, 2, 64, 96, targets=("attn_q",))
    tm = load_model(gguf, dtype=torch.float32, device="cpu", attn_w8a8=True)
    for fn in (lambda: apply_lora(tm.params, tm.config, str(path)),
               lambda: LoraMerger([tm.params], tm.config, [str(path)])):
        with pytest.raises(ValueError, match="--lora and --attn-w8a8"):
            fn()
