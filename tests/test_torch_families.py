"""The paper's other sparse families in the port against the JAX package,
on the CPU: qwen2 (SparseQwen2, dReLU), opt (LayerNorm with biases, learned
positions at offset 2, ungated ReLU with biases) and falcon (LayerNorm,
fused QKV, parallel attention/FFN, ungated ReLU) in two layouts: MQA with
one norm (Falcon-7B) and grouped QKV with two norms (Falcon-40B's new
decoder architecture, ReluFalcon-40B).

Tiny GGUFs (E=64, two layers, predictors, the sparse ffn_down transposed)
are written here with the JAX package's GGUFWriter from numpy seeds.
Serving (the Q8_0 Engine, the Scheduler, the CLI, the server) and the
transformers parity are in test_torch_families_serving.py, over GGUFs of
this file's writer. Tolerances, f32 throughout:
  - the fused QKV split, the loaded params and from_jax's params: exactly
    equal;
  - layer_norm: 1e-6 relative (the same f32 operations);
  - prefill and decode logits of the dense forward: 1e-5 relative;
  - one layer's FFN in each sparse mode: 1e-5; its carried selection equal;
  - greedy streams of the Engine (dense, gather, pipelined v6, Q8_0 v6q)
    and of the Scheduler (v1 rows): equal token for token;
  - against transformers (a tiny OPTForCausalLM, FalconForCausalLM in both
    layouts, Qwen2ForCausalLM converted by the JAX tools/convert_hf): 2e-3.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.gguf.constants import GGMLType  # noqa: E402
from sparkinfer_tpu.gguf.writer import GGUFWriter  # noqa: E402
from sparkinfer_tpu.models import config as jconfig  # noqa: E402
from sparkinfer_tpu.models import loader as jloader  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.ops import norms as jnorms  # noqa: E402
from sparkinfer_tpu.ops import quant_matmul as jqm  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_init_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.sparse import ffn as jffn  # noqa: E402
from sparkinfer_tpu.sparse.config import SparseConfig as JaxSparseConfig  # noqa: E402
from sparkinfer_tpu_torch.models import config as tconfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model, split_fused_qkv  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.ops import quant_matmul as tqm  # noqa: E402
from sparkinfer_tpu_torch.ops.norms import layer_norm  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse import ffn as tffn  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

# fixture -> (arch, n_head, n_head_kv)
FAMILIES = {"qwen2": ("qwen2", 4, 2), "opt": ("opt", 4, 4),
            "falcon7b": ("falcon", 4, 1), "falcon40b": ("falcon", 8, 2)}
KINDS = list(FAMILIES)
E, F, V, N_CTX, RANK = 64, 96, 199, 128, 8
G, CAP = 16, 4  # f32 stores: 6 groups, 4 selected
GQ, CAPQ = 32, 2  # Q8_0 stores: groups of whole 32-blocks
PROMPT = [5, 9, 42, 7]
PROMPTS = [[3, 14, 15], [9, 26, 53, 58], [97, 93], [2, 71, 82, 81, 82]]
TOL = dict(rtol=1e-5, atol=1e-5)


def _spm_vocab(wr, n_vocab):
    """A minimal SPM vocabulary (specials, byte pieces, a few words), so
    that the server can tokenize text for any of the families."""
    words = ["▁h", "▁he", "▁hel", "▁hell", "▁hello", "▁w", "▁wo", "▁wor", "▁worl", "▁world"]
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + words
    tokens += [f"<extra_{i}>" for i in range(n_vocab - len(tokens))]
    types = np.full(n_vocab, 1, np.int32)
    types[0], types[1], types[2] = 2, 3, 3
    types[3:259] = 6
    scores = np.zeros(n_vocab, np.float32)
    scores[259:259 + len(words)] = -1.0
    wr.add_kv("tokenizer.ggml.model", "llama")
    wr.add_array("tokenizer.ggml.tokens", tokens)
    wr.add_array("tokenizer.ggml.scores", scores)
    wr.add_array("tokenizer.ggml.token_type", types)
    wr.add_kv("tokenizer.ggml.bos_token_id", np.uint32(1))
    wr.add_kv("tokenizer.ggml.eos_token_id", np.uint32(2))
    wr.add_kv("tokenizer.ggml.unknown_token_id", np.uint32(0))


def make_family(path, kind, *, n_layer=2, n_vocab=V, rank=RANK, quant_type=None, seed=0,
                with_vocab=False, extra_kv=None):
    """Write a tiny GGUF of one family, with predictors (the last third of
    each layer's neurons never fires) and ffn_down stored transposed (F, E),
    as sparse GGUFs store it; predictors of rank `rank`. qwen2: q/k/v biases, gated FFN, RMS norms;
    opt: LayerNorm biases, q/k/v/o and FFN biases, position_embd of
    n_ctx + 2 rows; falcon: LayerNorm biases, a fused attn_qkv (grouped
    per kv head where n_head_kv > 1), attn_norm_2 where n_head_kv > 1,
    ungated FFN without biases. quant_type "q8_0" stores the linears as
    Q8_0 (norms, biases, predictors and embeddings stay F32). extra_kv:
    more `{arch}.` keys, name -> value."""
    arch, H, Hkv = FAMILIES[kind]
    D = E // H
    rng = np.random.default_rng(seed)

    def w(*shape, k=0.08):
        return (rng.standard_normal(shape) * k).astype(np.float32)

    ln = arch in ("opt", "falcon")
    t = {"token_embd.weight": w(n_vocab, E), "output_norm.weight": 1.0 + w(E, k=0.01),
         "output.weight": w(n_vocab, E)}
    if ln:
        t["output_norm.bias"] = w(E, k=0.02)
    if arch == "opt":
        t["position_embd.weight"] = w(N_CTX + 2, E)
    for i in range(n_layer):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = 1.0 + w(E, k=0.01)
        if ln:
            t[p + "attn_norm.bias"] = w(E, k=0.02)
        if arch == "falcon":
            t[p + "attn_qkv.weight"] = w((H + 2 * Hkv) * D, E)
            if Hkv > 1:
                t[p + "attn_norm_2.weight"] = 1.0 + w(E, k=0.01)
                t[p + "attn_norm_2.bias"] = w(E, k=0.02)
        else:
            for nm, n in (("q", H), ("k", Hkv), ("v", Hkv)):
                t[p + f"attn_{nm}.weight"] = w(n * D, E)
                t[p + f"attn_{nm}.bias"] = w(n * D, k=0.02)
        t[p + "attn_output.weight"] = w(E, H * D)
        if arch == "opt":
            t[p + "attn_output.bias"] = w(E, k=0.02)
        if arch != "falcon":
            t[p + "ffn_norm.weight"] = 1.0 + w(E, k=0.01)
            if ln:
                t[p + "ffn_norm.bias"] = w(E, k=0.02)
        t[p + "ffn_up.weight"] = w(F, E)
        if arch == "qwen2":
            t[p + "ffn_gate.weight"] = w(F, E)
        t[p + "ffn_down.weight"] = w(F, E)  # transposed: neuron rows contiguous
        if arch == "opt":
            t[p + "ffn_up.bias"] = w(F, k=0.02)
            t[p + "ffn_down.bias"] = w(E, k=0.02)
        pd, pdb = w(F, rank) * 20.0, w(F) - 1.0
        pd[2 * F // 3:], pdb[2 * F // 3:] = 0.0, -6.0
        t[p + "ffn_pred_up.weight"] = w(rank, E)
        t[p + "ffn_pred_up.bias"] = w(rank)
        t[p + "ffn_pred_down.weight"] = pd
        t[p + "ffn_pred_down.bias"] = pdb
    wr = GGUFWriter(path, arch)
    if with_vocab:
        _spm_vocab(wr, n_vocab)
    for key, val in (("block_count", n_layer), ("embedding_length", E),
                     ("attention.head_count", H), ("attention.head_count_kv", Hkv),
                     ("feed_forward_length", F), ("vocab_size", n_vocab),
                     ("context_length", N_CTX), ("rope.dimension_count", D)):
        wr.add_kv(f"{arch}.{key}", np.uint32(val))
    eps_key = "layer_norm_epsilon" if ln else "layer_norm_rms_epsilon"
    wr.add_kv(f"{arch}.attention.{eps_key}", np.float32(1e-5))
    wr.add_kv(f"{arch}.rope.freq_base", np.float32(10000.0))
    wr.add_array(f"{arch}.pred_lora", np.full(n_layer, rank, np.uint32))
    for key, val in (extra_kv or {}).items():
        wr.add_kv(f"{arch}.{key}", val)
    for name, data in t.items():
        gt = GGMLType.F32
        if (quant_type and data.ndim == 2 and name.endswith(".weight") and "norm" not in name
                and "pred" not in name and "embd" not in name):
            gt = getattr(GGMLType, quant_type.upper())
        wr.add_tensor(name, data, gt)
    wr.write()
    return t


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for i, kind in enumerate(KINDS):
        out[kind] = str(d / f"{kind}.gguf")
        make_family(out[kind], kind, seed=11 + i)
        out[kind + "-q8"] = str(d / f"{kind}-q8.gguf")
        # Q8_0 predictor stacks want whole 32-blocks of the rank
        make_family(out[kind + "-q8"], kind, rank=32, quant_type="q8_0", seed=21 + i)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _both(path, **kw):
    return (jloader.load_model(path, dtype=jnp.float32, **kw),
            load_model(path, dtype=torch.float32, device="cpu", **kw))


def _same_params(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _same_params(got[k], ref[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# ops and loading


@pytest.mark.parametrize("arch,H,Hkv,bias", [
    ("falcon", 4, 1, False), ("falcon", 4, 1, True), ("falcon", 8, 2, False),
    ("falcon", 8, 2, True), ("falcon", 4, 4, True), ("dbrx", 8, 2, True)],
    ids=["mqa", "mqa-bias", "grouped", "grouped-bias", "mha-concat", "concat-trait"])
def test_split_fused_qkv_matches_jax(arch, H, Hkv, bias):
    """Falcon-7B (MQA), Falcon-40B (grouped [q_0..q_{g-1}, k, v] per kv head)
    and plain [Q; K; V] (MHA, and an arch whose trait says concat)."""
    kw = dict(arch=arch, n_layer=1, n_embd=E, n_head=H, n_head_kv=Hkv, n_ff=F, n_vocab=V,
              head_dim=E // H)
    rng = np.random.default_rng(H * 10 + Hkv)
    width = (H + 2 * Hkv) * (E // H)
    w = rng.standard_normal((E, width)).astype(np.float32)
    b = rng.standard_normal(width).astype(np.float32) if bias else None
    ref = jloader._split_fused_qkv(w, b, jconfig.ModelConfig(**kw))
    got = split_fused_qkv(w, b, tconfig.ModelConfig(**kw))
    for r, g in zip(ref, got):
        assert (r is None) == (g is None)
        if r is not None:
            np.testing.assert_array_equal(g, r)
    if Hkv not in (1, H) and arch == "falcon":  # the grouped case is no plain cut
        assert not np.array_equal(got[1], w[:, H * (E // H):(H + Hkv) * (E // H)])


@pytest.mark.parametrize("dtype,bias", [("f32", True), ("f32", False), ("bf16", True)])
def test_layer_norm_matches_jax(dtype, bias):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, E)) * 3 + 1).astype(np.float32)
    w = (1 + rng.standard_normal(E) * 0.1).astype(np.float32)
    b = (rng.standard_normal(E) * 0.1).astype(np.float32) if bias else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jnorms.layer_norm(jnp.asarray(x, jdt), jnp.asarray(w),
                            None if b is None else jnp.asarray(b), 1e-5)
    got = layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), 1e-5)
    assert got.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "bf16":  # the same f32 values rounded once
        np.testing.assert_array_equal(got.float().numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_load_and_from_jax_match_the_jax_loader(ggufs, kind):
    """The port's own load equals the JAX loader's params key for key, and
    the JAX params carried over by from_jax equal the port's load."""
    jm, tm = _both(ggufs[kind])
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    ref = _np(jm.params)
    _same_params(tm.params, ref)
    _same_params(params_from_numpy(ref, "cpu"), {k: v for k, v in ref.items()})
    lay = tm.params["layers"]
    arch, H, Hkv = FAMILIES[kind]
    assert ("pos_embd" in tm.params) == (arch == "opt")
    assert ("output_norm_b" in tm.params) == (arch != "qwen2")
    assert ("attn_norm2_w" in lay) == (kind == "falcon40b")
    assert ("ffn_norm_w" in lay) == (arch != "falcon")
    assert lay["wk"].shape == (2, E, Hkv * (E // H))


@pytest.mark.parametrize("kind", KINDS)
def test_keep_quantized_load_matches_jax(ggufs, kind):
    """Q8_0 linears stay packed where the JAX loader keeps them; a fused QKV
    loads every linear dequantized, as in the JAX loader."""
    jm, tm = _both(ggufs[kind + "-q8"], keep_quantized=True)
    packed = isinstance(tm.params["layers"]["wq"], tqm.QuantTensor)
    assert packed == hasattr(jm.params["layers"]["wq"], "kind") == (FAMILIES[kind][0] != "falcon")
    assert isinstance(tm.params["output"], tqm.QuantTensor) == packed
    x = np.random.default_rng(0).standard_normal((3, E)).astype(np.float32)
    ref = np.asarray(jqm.quant_linear(jnp.asarray(x), jm.params["output"])) if packed else \
        x @ np.asarray(jm.params["output"])
    np.testing.assert_allclose(tqm.quant_linear(torch.from_numpy(x), tm.params["output"])
                               .numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["cohere2", "olmoe", "rwkv6", "mamba", "t5", "llama"])
def test_other_archs_stay_refused(tmp_path, arch):
    """Archs and features the port still refuses at load, each by name:
    cohere2 (15g's iSWA group), olmoe (an MoE arch not ported), the
    recurrent and encoder-decoder modules (rwkv6, mamba, t5), and per-layer
    FFN widths (a feed_forward_length array) on an arch other than deci and
    openelm. (The GPT-family archs, the feature archs and the non-causal
    encoders this test once held are ported: tests/test_torch_gpt_archs.py,
    tests/test_torch_feature_archs.py, tests/test_torch_encoders.py.)"""
    path = tmp_path / f"{arch}.gguf"
    match = {"llama": "per-layer"}.get(arch, arch)
    if arch == "llama":  # the header alone: the refusal comes before any tensor is read
        wr = GGUFWriter(str(path), arch)
        for k, v in (("block_count", 2), ("embedding_length", E), ("attention.head_count", 4),
                     ("attention.head_count_kv", 2), ("vocab_size", 199),
                     ("context_length", 256)):
            wr.add_kv(f"{arch}.{k}", np.uint32(v))
        wr.add_array(f"{arch}.feed_forward_length", np.array([96, 64], np.uint32))
        wr.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(1e-5))
        wr.write()
    elif arch == "olmoe":
        make_tiny_llama(path, arch=arch, n_expert=4, n_expert_used=2)
    else:
        make_tiny_llama(path, arch=arch)
    with pytest.raises(NotImplementedError, match=match):
        load_model(str(path), dtype=torch.float32, device="cpu")


def test_clamped_qkv_stays_refused(tmp_path):
    """Clamped q/k/v (attention.clamp_kqv, olmo's and dbrx's clip_qkv) is
    ported: on the fixture this test once refused, at a clamp that binds
    (0.1; most q/k/v entries exceed it), the port's prefill and decode
    logits within 1e-5 of the JAX forward's, and away from the unclamped
    model's."""
    path = tmp_path / "clamped.gguf"
    make_tiny_llama(path, extra_kv={"llama.attention.clamp_kqv": np.float32(0.1)})
    jm, tm = _both(str(path))
    assert tm.config.clamp_kqv == pytest.approx(0.1)
    prompt, tok = [5, 9, 42, 7, 100, 3], 17
    want, got = _jax_logits(jm, prompt, tok), _port_logits(tm, prompt, tok)
    for g, w in zip(got, want):
        _close(g, w)
    free = _port_logits(dataclasses.replace(tm, config=dataclasses.replace(
        tm.config, clamp_kqv=0.0)), prompt, tok)
    assert np.abs(free[0] - got[0]).max() > 1e-3 * np.abs(got[0]).max()


# ---------------------------------------------------------------------------
# the forward


def _jax_logits(jm, prompt, decode_tok):
    cfg = jm.config
    cache = jax_init_cache(cfg, 1, 32, jnp.float32)
    pre = jax.jit(jax_forward(cfg, fresh_prefill=True))
    dec = jax.jit(jax_forward(cfg))
    lg, cache = pre(jm.params, jnp.asarray([prompt], jnp.int32),
                    jnp.arange(len(prompt), dtype=jnp.int32)[None], cache)
    lg2, _ = dec(jm.params, jnp.asarray([[decode_tok]], jnp.int32),
                 jnp.asarray([[len(prompt)]], jnp.int32), cache)
    return np.asarray(lg)[0], np.asarray(lg2)[0]


def _port_logits(tm, prompt, decode_tok):
    cfg = tm.config
    cache = init_cache(cfg, 1, 32, torch.float32, "cpu")
    with torch.inference_mode():
        lg = make_forward(cfg, fresh_prefill=True)(
            tm.params, torch.tensor([prompt]), torch.arange(len(prompt))[None], cache)
        lg2 = make_forward(cfg)(tm.params, torch.tensor([[decode_tok]]),
                                torch.tensor([[len(prompt)]]), cache)
    return lg[0].numpy(), lg2[0].numpy()


def _close(got, ref, rel=1e-5):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= rel * scale, (np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_jax(ggufs, kind):
    """Dense prefill (every position's logits) and one decode step."""
    jm, tm = _both(ggufs[kind])
    ref_pre, ref_dec = _jax_logits(jm, PROMPT, 77)
    got_pre, got_dec = _port_logits(tm, PROMPT, 77)
    _close(got_pre, ref_pre)
    _close(got_dec, ref_dec)


# the model-level multipliers and NoPE layers that every arch's GGUF may
# carry, each far from its no-op (llama: embeddings x12 put a wrong argmax
# within reach; residual 0.22; logits halved; layer 1 of 2 without rope),
# and falcon's parallel block, which scales the attention output only
SCALE_CASES = {
    "embedding_scale": ("llama", {"embedding_scale": np.float32(12.0)}),
    "residual_scale": ("llama", {"residual_scale": np.float32(0.22)}),
    "logit_scale": ("llama", {"logit_scale": np.float32(0.5)}),
    "nope_layers": ("llama", {"nope_layers": np.asarray([0, 1], np.uint32)}),
    "falcon_residual_scale": ("falcon40b", {"residual_scale": np.float32(0.22)}),
}


@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_scales_and_nope_layers_match_jax(tmp_path, case):
    """embedding_scale, residual_scale, logit_scale and nope_layers in the
    port's forward against the JAX forward, prefill and decode, f32, 1e-5;
    and each moves the logits (a key the forward ignored would pass the
    parity only if the JAX forward ignored it too)."""
    kind, kv = SCALE_CASES[case]
    path, plain = str(tmp_path / "scaled.gguf"), str(tmp_path / "plain.gguf")
    if kind == "llama":
        make_tiny_llama(path, extra_kv={f"llama.{k}": v for k, v in kv.items()})
        make_tiny_llama(plain)
    else:
        make_family(path, kind, seed=5, extra_kv=kv)
        make_family(plain, kind, seed=5)
    jm, tm = _both(path)
    key = case.replace("falcon_", "").replace("embedding_scale", "embd_scale")
    assert getattr(tm.config, key) == getattr(jm.config, key) != getattr(
        load_model(plain, dtype=torch.float32, device="cpu").config, key)
    ref_pre, ref_dec = _jax_logits(jm, PROMPT, 77)
    got_pre, got_dec = _port_logits(tm, PROMPT, 77)
    _close(got_pre, ref_pre)
    _close(got_dec, ref_dec)
    base_pre, _ = _port_logits(load_model(plain, dtype=torch.float32, device="cpu"), PROMPT, 77)
    assert np.abs(base_pre - ref_pre).max() > 1e-2 * np.abs(ref_pre).max()


def test_opt_positions_are_offset_and_max_seq_is_cut(ggufs, capsys):
    """OPT reads its position table at positions + 2; the Engine and the
    Scheduler cut max_seq to the table (n_ctx_train + 2 rows less the
    offset), so an idle slot's position max_seq - 1 stays inside it."""
    tm = load_model(ggufs["opt"], dtype=torch.float32, device="cpu")
    assert tm.params["pos_embd"].shape == (N_CTX + 2, E)
    e = Engine(tm, max_seq=4 * N_CTX, sampler=SamplerConfig(temp=0.0),
               kv_dtype=torch.float32, device="cpu")
    assert e.max_seq == N_CTX and "cut to the model's 128" in capsys.readouterr().err
    s = Scheduler(tm, n_slots=2, max_seq=4 * N_CTX, sampler=SamplerConfig(temp=0.0),
                  kv_dtype=torch.float32, device="cpu")
    assert s.max_seq == N_CTX and s.cache.k.shape[2] == N_CTX
    assert Engine(tm, max_seq=64, device="cpu").max_seq == 64
    # a shifted table gives other logits: the offset is read
    p2 = dict(tm.params, pos_embd=torch.roll(tm.params["pos_embd"], 2, 0))
    a, _ = _port_logits(tm, PROMPT, 77)
    b, _ = _port_logits(type(tm)(config=tm.config, params=p2), PROMPT, 77)
    assert np.abs(a - b).max() > 1e-3


# ---------------------------------------------------------------------------
# the sparse FFN, one layer in each mode


def _layer(params, il, jax_side):
    lp = {k: v[il] for k, v in params["layers"].items()}
    if "sparse_flat" in params:
        lp.update(params["sparse_flat"])
        lp["flat_il"] = jnp.int32(il) if jax_side else il
    return lp


# (port mode, JAX mode, layout): the per-layer FFN of the Scheduler and
# masked-dense prefill, then the pipelined decode FFN over either layout
SPARSE_MODES = [("dense", "dense", None), ("gather", "gather", None), ("kernel", "pallas", None)]
PIPELINED_MODES = [("kernel", "pallas", "v6"), ("gather", "gather", "v1"),
                   ("kernel", "pallas", "v1"), ("kernel_union", "pallas_union", "v6")]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode,jmode,_", SPARSE_MODES, ids=[m[0] for m in SPARSE_MODES])
def test_sparse_ffn_matches_jax(ggufs, kind, mode, jmode, _):
    jm, tm = _both(ggufs[kind])
    jp = jffn.prepare_sparse_params(jm.params, jm.config, JaxSparseConfig(G, CAP))
    tp = tffn.prepare_sparse_params(tm.params, tm.config, SparseConfig(G, CAP))
    jf = jffn.make_sparse_ffn(jm.config, JaxSparseConfig(G, CAP), mode=jmode)
    tf = tffn.make_sparse_ffn(tm.config, SparseConfig(G, CAP), mode=mode)
    x = np.random.default_rng(4).standard_normal((2, 3, E)).astype(np.float32)
    for il in range(2):
        ref = np.asarray(jf(_layer(jp, il, True), jnp.asarray(x)))
        got = tf(_layer(tp, il, False), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode,jmode,layout", PIPELINED_MODES,
                         ids=[f"{m[0]}-{m[2]}" for m in PIPELINED_MODES])
def test_pipelined_ffn_matches_jax(ggufs, kind, mode, jmode, layout):
    """Two layers of the pipelined FFN: layer 0 selects from its own
    predictor and carries layer 1's selection, which layer 1 uses. B = 3
    tokens for the union modes, 1 for the per-token ones."""
    jm, tm = _both(ggufs[kind])
    jp = jffn.prepare_pipelined_params(jm.params, jm.config, JaxSparseConfig(G, CAP),
                                       layout=layout)
    tp = tffn.prepare_pipelined_params(tm.params, tm.config, SparseConfig(G, CAP),
                                       layout=layout)
    if FAMILIES[kind][0] != "qwen2":  # ungated: no gate store is built
        assert not any("gate" in k for k in {**tp["layers"], **tp.get("sparse_flat", {})})
    jf, jinit = jffn.make_pipelined_sparse_ffn(jm.config, JaxSparseConfig(G, CAP), mode=jmode)
    tf, tinit = tffn.make_pipelined_sparse_ffn(tm.config, SparseConfig(G, CAP), mode=mode)
    B = 3 if "union" in mode else 1
    x = np.random.default_rng(5).standard_normal((B, 1, E)).astype(np.float32)
    jc, tc = jinit(B, 1), tinit(B, 1, "cpu")
    for il in range(2):
        ref, jc = jf(_layer(jp, il, True), jnp.asarray(x), jc, jnp.int32(il))
        got, tc = tf(_layer(tp, il, False), torch.from_numpy(x), tc, il)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))


# ---------------------------------------------------------------------------
# the Engine and the Scheduler


def _engines(path, mode):
    """The JAX and the port Engine, f32, greedy: mode None dense, else the
    sparse decode mode ("gather" over the v1 row stores, "kernel" / the JAX
    "pallas" over v6's flat stores)."""
    jm, tm = _both(path)
    jmode = {"kernel": "pallas"}.get(mode, mode)
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32,
                   sparse=JaxSparseConfig(G, CAP) if mode else None,
                   **({"sparse_decode_mode": jmode} if mode else {}))
    pe = Engine(tm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                sparse=SparseConfig(G, CAP) if mode else None, device="cpu",
                **({"sparse_decode_mode": mode} if mode else {}))
    return je, pe


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", [None, "gather", "kernel"], ids=["dense", "gather", "v6"])
def test_engine_streams_match_jax(ggufs, kind, mode):
    je, pe = _engines(ggufs[kind], mode)
    got = pe.generate(PROMPT, 10)
    assert got == je.generate(PROMPT, 10) and len(got) == 10
    assert pe.perf.n_decode == 9
