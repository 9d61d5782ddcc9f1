"""The GPT-family archs and ALiBi in the port against the JAX package, on the
CPU: gpt2, starcoder, codeshell, jais, refact, qwen, phi2, gptneox, bloom,
mpt and gptj.

Where transformers has the class (gpt2 with learned positions and a fused
QKV; starcoder's GPTBigCode with MQA and a fused QKV; gptneox's parallel
block with attn_norm_2 and neox rope over half the lanes; bloom with ALiBi,
its post-embedding LayerNorm and a tied head, at 4 heads and at 12, whose
extra slopes are the odd powers of 2^(-1/2); mpt with ALiBi and no biases;
gptj's parallel block, interleaved rope over 8 of 16 lanes and its head
bias; phi2's parallel block, neox rope and head bias), a tiny checkpoint
converted by the JAX package's tools/convert_hf.py (tests/arch_checks.py),
its norms and biases drawn away from their ones and zeros; the others from
tests/arch_fixture.py (refact: llama blocks under ALiBi over 2 KV heads;
jais: ALiBi, a fused QKV and LayerNorm, output and FFN biases; codeshell:
the same with neox rope and gelu; qwen: a fused QKV under neox rope). f32
throughout. Tolerances: params equal bit for bit (dtypes too); prefill and
decode logits within 1e-5 of their scale; the Engine's greedy stream equal
to the JAX forward's greedy decode, the 2-slot Scheduler's to the JAX
Scheduler's, the int8-cache Engine's and the CLI's to the JAX Engine's and
CLI's, a session file of either package continuing in the other as the
uninterrupted stream; against transformers' own f32 forward, 2e-4;
alibi_slopes and a context shift's cache bit-equal to the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

import arch_checks as ac  # noqa: E402
from arch_fixture import GPT_KINDS, make_arch  # noqa: E402
from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.transformer import alibi_slopes as jax_alibi_slopes  # noqa: E402
from sparkinfer_tpu.models.transformer import rope_params as jax_rope_params  # noqa: E402
from sparkinfer_tpu.runtime import kv_cache as jkv  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import (  # noqa: E402
    GPT_FAMILY,
    alibi_slopes,
    check_supported,
    make_forward,
    rope_params,
)
from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor  # noqa: E402
from sparkinfer_tpu_torch.runtime import kv_cache as tkv  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402

V = ac.V
HF = {  # name -> (config class, model class, config keywords, base keywords)
    "gpt2": ("GPT2Config", "GPT2LMHeadModel", {}, dict(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, n_positions=128, n_inner=96)),
    "starcoder": ("GPTBigCodeConfig", "GPTBigCodeForCausalLM", dict(multi_query=True), dict(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, n_positions=128, n_inner=96)),
    "gptneox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(
        rotary_pct=0.5, use_parallel_residual=True, num_key_value_heads=4), ac.BASE),
    "bloom": ("BloomConfig", "BloomForCausalLM", {}, dict(
        vocab_size=V, hidden_size=64, n_layer=2, n_head=4)),
    # 12 heads: 8 slopes of 2^(-8/8) powers, then 4 odd powers of 2^(-4/8)
    "bloom-12": ("BloomConfig", "BloomForCausalLM", {}, dict(
        vocab_size=V, hidden_size=96, n_layer=2, n_head=12)),
    "mpt": ("MptConfig", "MptForCausalLM", {}, dict(
        vocab_size=V, d_model=64, n_layers=2, n_heads=4, expansion_ratio=2, max_seq_len=128)),
    "gptj": ("GPTJConfig", "GPTJForCausalLM", dict(rotary_dim=8), dict(
        vocab_size=V, n_embd=64, n_layer=2, n_head=4, n_positions=128)),
    "phi2": ("PhiConfig", "PhiForCausalLM", dict(
        num_key_value_heads=4, partial_rotary_factor=0.5), ac.BASE),
}
NAMES = tuple(HF) + GPT_KINDS[:-1]  # the bloom fixture serves the card's tests
ALIBI = ("bloom", "bloom-12", "mpt", "jais", "refact")
# the norms (ln_*, *layernorm*) and biases, away from their ones and zeros
NOISE = ("norm", "ln_", "bias")
GREEDY = dict(temp=0.0)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """name -> (GGUF path, transformers' logits of the prompt or None)."""
    d = tmp_path_factory.mktemp("gpt")
    out = {name: ac.hf_gguf(d, name, c, m, kw, base=base, noise=NOISE)
           for name, (c, m, kw, base) in HF.items()}
    for kind in GPT_KINDS[:-1]:
        make_arch(d / f"{kind}.gguf", kind, seed=7)
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


@pytest.fixture(scope="module")
def refs(models):
    got = {}

    def get(name):
        if name not in got:
            got[name] = ac.jax_reference(models(name)[0])
        return got[name]

    return get


def _cfg(arch, **kw):
    return ModelConfig(**{**dict(arch=arch, n_layer=2, n_embd=64, n_head=4, n_head_kv=4,
                                 n_ff=96, n_vocab=V, head_dim=16), **kw})


def test_check_supported_admits_the_gpt_family():
    assert set(GPT_FAMILY) == {"gpt2", "starcoder", "codeshell", "jais", "refact", "qwen",
                               "phi2", "gptneox", "bloom", "mpt", "gptj"}
    for arch in GPT_FAMILY:
        check_supported(_cfg(arch))


def test_alibi_slopes_bit_equal_to_jax():
    """Every head count from 1 to 80, powers of two and the interleaved
    extra slopes of the others."""
    for n in range(1, 81):
        got, want = alibi_slopes(n), jax_alibi_slopes(n)
        assert len(got) == n and got == want, n
    assert alibi_slopes(12)[8:] == pytest.approx([2.0 ** -0.5, 2.0 ** -1.5, 2.0 ** -2.5,
                                                  2.0 ** -3.5], rel=1e-15)


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_jax(models, name):
    """Params bit-equal to from_jax of the JAX loader's, dtypes included:
    bloom's token_embd_norm as f32 tok_norm_w and tok_norm_b, the head
    bias of gptj and phi2 as f32 output_b, each fused QKV split."""
    jm, pm = models(name)
    lay = ac.same_params(jm, pm)
    want = ac.params_from_numpy(jax.tree.map(np.asarray, jm.params), "cpu")
    for k in set(pm.params) - {"layers"}:
        assert pm.params[k].dtype == want[k].dtype, k
    assert pm.config.arch == jm.config.arch
    top = set(pm.params)
    assert ("tok_norm_w" in top and "tok_norm_b" in top) == name.startswith("bloom")
    assert ("output_b" in top) == (name in ("gptj", "phi2"))
    for k in ("tok_norm_w", "tok_norm_b", "output_b"):
        assert k not in top or pm.params[k].dtype == torch.float32, k
    assert ("pos_embd" in top) == (name in ("gpt2", "starcoder"))
    assert ("bq" in lay) == (name not in ("mpt", "gptj", "refact"))
    assert ("attn_norm2_w" in lay) == (name == "gptneox")
    cfg = pm.config
    assert lay["wk"].shape == (2, cfg.n_embd, cfg.n_head_kv * cfg.head_dim)
    if name == "starcoder":
        assert cfg.n_head_kv == 1
    if name in ("gptj", "gptneox", "phi2"):
        assert cfg.rope_dim == cfg.head_dim // 2
    if name in ("bloom", "mpt"):  # the tied head: the embedding's transpose
        assert torch.equal(pm.params["output"], pm.params["tok_embd"].T)
    assert cfg.traits.alibi == (name in ALIBI)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(models, refs, name):
    """A 9-token prefill and 3 decode steps: logits within 1e-5 of the JAX
    forward's scale, through the fresh prefill (the chunk path, or under
    ALiBi the cache) and over the cache."""
    pm = models(name)[1]
    want = refs(name)[0]
    ac.check_logits(ac.port_logits(pm), want)
    ac.check_logits(ac.port_logits(pm, fresh_prefill=False), want)


@pytest.mark.parametrize("name", tuple(HF))
def test_logits_match_transformers(ggufs, models, name):
    _, pm = models(name)
    got = ac.port_logits(pm, extra=())[0]
    assert ac.rel(got, ggufs[name][1]) <= ac.HF_TOL, ac.rel(got, ggufs[name][1])


@pytest.mark.parametrize("name", NAMES)
def test_engine_stream_matches_jax(models, refs, name):
    assert ac.port_stream(models(name)[1]) == refs(name)[1]


@pytest.mark.parametrize("name", ["bloom-12", "gptj"])
def test_scheduler_streams_match_jax(models, name):
    """ALiBi over 12 heads, and gptj's parallel block and head bias, on 2
    slots with three requests: the JAX Scheduler's streams."""
    jm, pm = models(name)
    prompts = [ac.PROMPT, ac.PROMPT[2:6], [7, 8, 9, 10, 11, 12, 13]]
    want, got = ac.scheduler_streams(jm, pm, prompts)
    assert got == want


@pytest.mark.parametrize("name", ["bloom", "jais"])
def test_int8_cache_engine_matches_jax(models, name):
    """An ALiBi Engine over the int8 KV cache, past a context shift (max_seq
    24), against the JAX Engine on the same options: equal streams."""
    jm, pm = models(name)
    je = JaxEngine(jm, max_seq=24, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.bfloat16,
                   kv_quantized=True)
    pe = Engine(pm, max_seq=24, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.bfloat16,
                kv_quantized=True, device="cpu")
    got = pe.generate(ac.PROMPT, 32)
    assert got == je.generate(ac.PROMPT, 32) and len(got) == 32 and pe.cache.quantized


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("name", ["bloom", "gptj"])
def test_shift_cache_bit_equal_to_jax(models, name, quantized):
    """shift_cache on the same cache (a real prefill's) under bloom's rope
    mode "none" (K moved unrotated: ALiBi reads slot indices) and gptj's
    partial interleaved rope: K, V and their scales bit-equal to the JAX
    package's."""
    jm, pm = models(name)
    cfg = pm.config
    dt = torch.bfloat16 if quantized else torch.float32
    tc = tkv.init_cache(cfg, 1, 24, dt, "cpu", quantized=quantized)
    toks = [int(t) for t in np.random.default_rng(1).integers(0, V, 20)]
    with torch.inference_mode():
        make_forward(cfg)(pm.params, torch.tensor([toks]), torch.arange(20)[None], tc)
    jc = jkv.KVCache(*(jnp.asarray(t.numpy()) for t in tc if t is not None))
    jc = jkv.shift_cache(jc, jax_rope_params(jm.config), 2, 9, 20)
    k0 = tc.k[:, :, 11:20].clone()
    tkv.shift_cache(tc, rope_params(cfg), 2, 9, 20)
    for got, want in zip(tc, jc):
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "bloom":  # no rope: the rows move unchanged
        assert torch.equal(tc.k[:, :, 2:11], k0)


def test_state_files_cross_between_the_packages(models, tmp_path):
    """bloom (ALiBi): a session saved by the JAX Engine after 4 decode steps
    restores in the port, a port save in the JAX Engine; both continuations
    equal the port's uninterrupted greedy stream."""
    from test_torch_state_io import _chain, _continue

    jm, pm = models("bloom")

    def port():
        return Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                      device="cpu")

    def jax_eng():
        return JaxEngine(jm, max_seq=64, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.float32,
                         donate_cache=False)

    full, *_ = _chain(port(), ac.PROMPT, 8)
    for save, load in ((jax_eng(), port()), (port(), jax_eng())):
        part, cache, st, n = _chain(save, ac.PROMPT, 4)
        f = tmp_path / f"{type(save).__module__}.state"
        save.save_session(str(f), cache, n, st, tokens=ac.PROMPT + part)
        cache2, n2, toks, st2 = load.load_session(str(f))
        assert n2 == n and toks == ac.PROMPT + part
        assert part + _continue(load, part[-1], n2, cache2, st2, 4) == full


def test_cli_matches_the_jax_cli(ggufs, capsys, monkeypatch):
    """The CLI over the bloom checkpoint with a token-id prompt, plain and
    past max_seq (a context shift): the JAX CLI's streams, both loaders at
    f32 and an f32 KV cache."""
    from sparkinfer_tpu.models import loader as jax_loader
    from sparkinfer_tpu.tools.cli import main as jax_main
    from sparkinfer_tpu_torch.models import loader
    from sparkinfer_tpu_torch.tools.cli import main

    jload, load = jax_loader.load_model, loader.load_model
    monkeypatch.setattr(jax_loader, "load_model",
                        lambda path, **kw: jload(path, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(loader, "load_model",
                        lambda path, **kw: load(path, **{**kw, "dtype": torch.float32}))
    for flags in ([], ["-c", "20"]):
        argv = ["-m", ggufs["bloom"][0], "-p", "5 9 42 7 5 9 42 7", "-n", "24", "--temp", "0",
                "-ctk", "f32"] + flags
        assert jax_main(argv) == 0
        want = capsys.readouterr().out
        assert main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert got == want and len(got.split()) == 24


def test_refusals_name_the_feature(models, tmp_path):
    """ALiBi over an iSWA ring (the JAX ring branch drops the term),
    self-extend without rope (no JAX path) and Baichuan-13B (the JAX
    package ropes it) raise, naming each."""
    import dataclasses

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    pm = models("bloom")[1]
    kw = dict(max_seq=32, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
              device="cpu")
    ring = LoadedModel(config=dataclasses.replace(pm.config, sliding_window=4),
                       params=pm.params)
    eng = Engine(ring, kv_iswa=True, **kw)
    eng.prefill_chunk = 8
    with pytest.raises(ValueError, match="ALiBi over an iSWA ring"):
        eng.generate(ac.PROMPT, 4)
    with pytest.raises(ValueError, match="self-extend .* no rope"):
        Engine(pm, self_extend=(2, 8), **kw)
    path = tmp_path / "baichuan13b.gguf"
    make_tiny_llama(path, arch="baichuan", n_layer=40)
    with pytest.raises(NotImplementedError, match="ALiBi .* of Baichuan-13B .* ropes"):
        load_model(str(path), dtype=torch.float32, device="cpu")


def test_bloom_fixture_loads_q8_packed(tmp_path):
    """The card's bloom fixture in Q8_0: its split Q/K/V, output, FFN and head
    stay packed, as the JAX loader keeps them, its biases and norms in f32;
    logits within 1e-4 of the JAX forward's scale (both round the packed
    products' inputs), the Engine's greedy stream equal."""
    from sparkinfer_tpu.models.loader import load_model as jax_load

    path = tmp_path / "bloom-q8.gguf"
    make_arch(path, "bloom", seed=7, quant_type="q8_0")
    jm = jax_load(str(path), dtype=jnp.float32, keep_quantized=True)
    pm = load_model(str(path), dtype=torch.float32, device="cpu", keep_quantized=True)
    lay = pm.params["layers"]
    for k in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        assert isinstance(lay[k], QuantTensor) and hasattr(jm.params["layers"][k], "kind"), k
    assert isinstance(pm.params["output"], QuantTensor) and hasattr(jm.params["output"], "kind")
    assert lay["bq"].dtype == torch.float32 and pm.params["tok_norm_b"].dtype == torch.float32
    want = ac.jax_reference(jm, extra=(3,), n_new=8)
    ac.check_logits(ac.port_logits(pm, extra=(3,)), want[0], tol=1e-4)
    assert ac.port_stream(pm, n_new=8) == want[1]
