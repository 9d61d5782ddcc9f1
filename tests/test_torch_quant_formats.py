"""Every GGML block format of the port against the JAX package, on the CPU.

Tolerances: decoders, encoders (with and without importance weights), the
quantize tool's tensor bytes and the loaded params are bit-equal (the same
numpy code on the same inputs); the forwards of the K-quant models are
compared by their greedy streams and by logits within 1e-5 of the JAX
forward's (f32 sums in other orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.gguf import quants as jquants  # noqa: E402
from sparkinfer_tpu.gguf.constants import GGML_TYPE_TRAITS  # noqa: E402
from sparkinfer_tpu.gguf.constants import GGMLType as JT  # noqa: E402
from sparkinfer_tpu.gguf.reader import GGUFReader as JReader  # noqa: E402
from sparkinfer_tpu.gguf.writer import GGUFWriter as JWriter  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.tools import imatrix as jimatrix  # noqa: E402
from sparkinfer_tpu.tools import quantize as jtool  # noqa: E402
from sparkinfer_tpu_torch.gguf import quants  # noqa: E402
from sparkinfer_tpu_torch.gguf.constants import GGMLType  # noqa: E402
from sparkinfer_tpu_torch.gguf.reader import GGUFReader  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.tools import quantize as ttool  # noqa: E402

PROMPT = [5, 9, 42]
DECODED = sorted(jquants._DECODERS, key=lambda t: t.name)
ENCODED = sorted(jquants._ENCODERS, key=lambda t: t.name)
PLAIN = sorted(set(jquants._PLAIN_DTYPES) | {JT.BF16}, key=lambda t: t.name)
WEIGHTED = sorted(jquants._QW_TYPES, key=lambda t: t.name)

# byte offsets of each format's f16 scale fields (ggml-common.h): random
# bytes there may be NaN or Inf, so they are overwritten with sane scales
F16_FIELDS = {
    "Q4_0": (0,), "Q4_1": (0, 2), "Q5_0": (0,), "Q5_1": (0, 2), "Q8_0": (0,),
    "Q2_K": (80, 82), "Q3_K": (108,), "Q4_K": (0, 2), "Q5_K": (0, 2), "Q6_K": (208,),
    "IQ4_NL": (0,), "IQ4_XS": (0,), "IQ2_XXS": (0,), "IQ2_XS": (0,), "IQ2_S": (0,),
    "IQ3_XXS": (0,), "IQ3_S": (0,), "IQ1_S": (0,), "TQ1_0": (52,), "TQ2_0": (64,),
}


def _blocks(t: JT, nb: int, seed: int) -> np.ndarray:
    """nb seeded blocks of type t with finite scales."""
    rng = np.random.default_rng(seed)
    _, tsz = GGML_TYPE_TRAITS[t]
    raw = rng.integers(0, 256, (nb, tsz), dtype=np.uint8)
    scales = (rng.uniform(0.5, 2.0, (nb,)) * 1e-2).astype(np.float16).view(np.uint8)
    for off in F16_FIELDS.get(t.name, ()):
        raw[:, off:off + 2] = scales.reshape(nb, 2)
    if t.name == "Q8_K":  # an f32 scale
        raw[:, 0:4] = (rng.uniform(0.5, 2.0, (nb,)) * 1e-2).astype(np.float32).view(
            np.uint8).reshape(nb, 4)
    elif t.name == "IQ1_M":  # the f16 scale rides the top nibbles of the four u16 scales
        sc = raw[:, 48:56].copy().view(np.uint16) & np.uint16(0x0FFF)
        d = scales.reshape(nb, 2).copy().view(np.uint16)[:, 0]
        for j, shift in enumerate((0, 4, 8, 12)):
            sc[:, j] |= ((d >> shift) & np.uint16(0xF)) << np.uint16(12)
        raw[:, 48:56] = sc.view(np.uint8)
    elif t.name == "MXFP4":  # an e8m0 exponent near 2^0
        raw[:, 0] = rng.integers(120, 136, (nb,), dtype=np.uint8)
    return raw.reshape(-1)


@pytest.mark.parametrize("t", DECODED, ids=lambda t: t.name)
def test_decoder_is_bit_equal_to_jax(t):
    bs, _ = GGML_TYPE_TRAITS[t]
    raw = _blocks(t, 24, seed=int(t))
    ref = jquants.dequantize(raw, t, 24 * bs)
    got = quants.dequantize(raw, GGMLType(int(t)), 24 * bs)
    assert np.isfinite(ref).all()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    shape = (4, 6 * bs)
    np.testing.assert_array_equal(quants.dequantize_tensor(raw, GGMLType(int(t)), shape),
                                  jquants.dequantize_tensor(raw, t, shape))


@pytest.mark.parametrize("t", PLAIN, ids=lambda t: t.name)
def test_plain_type_decodes_as_jax(t):
    raw = np.random.default_rng(int(t)).integers(0, 256, 8 * 37, dtype=np.uint8)
    if t.name in ("F16", "F32", "F64", "BF16"):  # finite values of the type
        raw = (np.random.default_rng(1).standard_normal(37).astype(np.float64)
               .astype({"F16": np.float16, "F32": np.float32, "F64": np.float64,
                        "BF16": np.float32}[t.name]))
        if t.name == "BF16":
            raw = (raw.view(np.uint32) >> 16).astype(np.uint16)
        raw = raw.view(np.uint8)
    ref = jquants.dequantize(raw, t, 37)
    got = quants.dequantize(raw, GGMLType(int(t)), 37)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_dequantize_raises_only_where_jax_does():
    raw = np.zeros(4096, np.uint8)
    for t in JT:
        if t not in GGML_TYPE_TRAITS:
            continue
        bs, tsz = GGML_TYPE_TRAITS[t]
        n = (4096 // tsz) * bs
        try:
            jquants.dequantize(raw, t, n)
            jax_ok = True
        except NotImplementedError:
            jax_ok = False
        if jax_ok:
            quants.dequantize(raw, GGMLType(int(t)), n)
        else:
            with pytest.raises(NotImplementedError):
                quants.dequantize(raw, GGMLType(int(t)), n)
    assert len(DECODED) == 23 and len(PLAIN) == 8 and len(ENCODED) == 13


def _floats(seed, n=8 * 256):
    x = (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)
    x[:256] = 0.0  # an all-zero super-block
    x[256:512] = 0.25  # one value throughout
    x[600] = -3.0  # a negative extreme
    return x


@pytest.mark.parametrize("t", ENCODED + [JT.F32, JT.F16, JT.BF16], ids=lambda t: t.name)
def test_encoder_is_bit_equal_to_jax(t):
    x = _floats(int(t))
    ref = jquants.quantize(x, t)
    got = quants.quantize(x, GGMLType(int(t)))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    # a torch tensor: Q8_0/Q4_0 in torch, the others through the numpy
    # encoders; a uint8 tensor back either way
    gt = quants.quantize(torch.from_numpy(x), GGMLType(int(t)))
    assert isinstance(gt, torch.Tensor) and gt.dtype == torch.uint8
    np.testing.assert_array_equal(gt.numpy(), ref)


@pytest.mark.parametrize("t", WEIGHTED, ids=lambda t: t.name)
def test_weighted_encoder_is_bit_equal_to_jax(t):
    x = _floats(int(t) + 100)
    qw = np.random.default_rng(5).uniform(0.0, 4.0, x.size).astype(np.float32)
    ref = jquants.quantize(x, t, qw=qw)
    np.testing.assert_array_equal(quants.quantize(x, GGMLType(int(t)), qw=qw), ref)
    np.testing.assert_array_equal(
        quants.quantize(torch.from_numpy(x), GGMLType(int(t)), qw=torch.from_numpy(qw)).numpy(),
        ref)
    assert not np.array_equal(ref, jquants.quantize(x, t))  # the weights did matter


def _tensor_bytes(reader_cls, path) -> dict:
    r = reader_cls(str(path))
    out = {n: (t.ggml_type.name, t.shape, bytes(t.raw())) for n, t in r.tensors.items()}
    kv = dict(r.kv)
    r.close()
    return out, kv


@pytest.mark.parametrize("target", ["q4_k", "q6_k", "q5_1", "q8_0", "bf16"])
def test_quantize_tool_writes_jax_bytes(tmp_path, target):
    src = tmp_path / "src.gguf"
    make_tiny_llama(src, n_embd=256, n_head=4, n_head_kv=2, n_ff=512, n_layer=1, seed=3,
                    pred_rank=8)
    imat = None
    if target in ("q4_k", "q6_k"):  # an importance matrix for the attention inputs
        imat = tmp_path / "imatrix.gguf"
        rng = np.random.default_rng(9)
        jimatrix.write_imatrix(str(imat), {
            "n_tokens": 64,
            **{f"blk.0.attn_{p}.weight.imatrix": rng.uniform(0.1, 3.0, 256).astype(np.float32)
               for p in ("q", "k", "v")}})
    a, b = tmp_path / "jax.gguf", tmp_path / "port.gguf"
    js = jtool.quantize_file(str(src), str(a), jtool._NAMES[target],
                             imatrix=None if imat is None else str(imat))
    ts = ttool.quantize_file(str(src), str(b), ttool._NAMES[target],
                             imatrix=None if imat is None else str(imat))
    assert js == ts
    if imat is not None:
        assert ts["imatrix_used"] == 3
    (ja, jkv), (ta, tkv) = _tensor_bytes(JReader, a), _tensor_bytes(GGUFReader, b)
    assert ja == ta
    assert jkv.keys() == tkv.keys()
    # the command line, without an importance matrix
    assert ttool.main([str(src), str(tmp_path / "cli.gguf"), target]) == 0
    assert jtool.main([str(src), str(tmp_path / "jcli.gguf"), target]) == 0
    assert (_tensor_bytes(GGUFReader, tmp_path / "cli.gguf")[0]
            == _tensor_bytes(JReader, tmp_path / "jcli.gguf")[0])


def _kquant_gguf(path, t: JT):
    """A tiny ProSparse llama (256 wide, so every row is whole 256-blocks)
    whose matmul weights are stored as t, the predictor in f16."""
    raw = make_tiny_llama(path, arch="prosparse_llama", n_embd=256, n_head=4, n_head_kv=2,
                          n_ff=512, n_layer=2, n_vocab=256, pred_rank=16, seed=11,
                          scale=0.05)
    w = JWriter(str(path), "prosparse_llama")
    r = JReader(str(path))
    for k, v in r.kv.items():
        if k != "general.architecture":
            try:
                w.add_kv(k, v)
            except Exception:
                w.add_array(k, v)
    r.close()
    for name, arr in raw.items():
        if arr.ndim < 2:
            w.add_tensor(name, arr, JT.F32)
        elif "pred" in name:
            w.add_tensor(name, arr, JT.F16)
        elif name.endswith("ffn_down.weight") and t == JT.Q4_K:
            w.add_tensor(name, arr, JT.Q6_K)  # llama.cpp's Q4_K_M mix
        else:
            w.add_tensor(name, arr, t)
    w.write()


@pytest.mark.parametrize("t", [JT.Q4_K, JT.Q6_K, JT.IQ4_XS], ids=lambda t: t.name)
def test_kquant_model_loads_and_decodes_as_jax(tmp_path, t):
    path = str(tmp_path / f"tiny-{t.name}.gguf")
    _kquant_gguf(path, t)
    types = {tt.ggml_type.name for tt in GGUFReader(path).tensors.values()}
    assert t.name in types and "F16" in types
    jm = jax_load(path, dtype=jnp.float32)
    tm = load_model(path, dtype=torch.float32, device="cpu")
    for k, v in tm.params["layers"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jm.params["layers"][k]), err_msg=k)
    for k in ("tok_embd", "output", "output_norm_w"):
        np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(jm.params[k]), err_msg=k)
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32)
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                device="cpu")
    assert pe.generate(PROMPT, 12) == je.generate(PROMPT, 12)
    cache = je.new_cache()
    lg, _ = je.fwd_prefill(je.model.params, jnp.asarray([PROMPT], jnp.int32),
                           jnp.arange(len(PROMPT), dtype=jnp.int32)[None], cache)
    pe.prefill(PROMPT, pe.new_cache(), pe.new_sampler_state())
    ref = np.asarray(lg[:, -1])
    np.testing.assert_allclose(pe.last_logits.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
