"""The decoders with features of their own in the port against the JAX
package, on the CPU: olmo2 and olmo3 (post-norm-only blocks, full-width q/k
norms, olmo3's 3:1 sliding pattern), apertus (xIELU), bitnet (relu2_glu and
its sub-norms), deci and openelm (per-layer head counts and FFN widths,
deci's attention-free layer), chameleon's text path ((H, D) LayerNorm q/k
norms) and the text stacks of qwen2vl and qwen3vl (M-RoPE).

Where transformers has the class (Olmo2, Olmo3, Apertus, BitNet, Chameleon,
Qwen2VL, Qwen3VL), a tiny checkpoint converted by the JAX package's
tools/convert_hf.py (tests/arch_checks.py), its norms (and apertus's xIELU
coefficients) drawn away from their ones and zeros, the model in f32 (the
Apertus class keeps its xIELU parameters in bf16 otherwise); the others,
and the card's fixtures, from tests/arch_fixture.py:make_feature. f32
throughout. Tolerances: params equal bit for bit (dtypes too, segment by
segment); prefill and decode logits within 1e-5 of their scale; the
Engine's greedy stream equal to the JAX forward's greedy decode, the 2-slot
Scheduler's to the JAX Scheduler's, the int8-cache Engine's, the Engine's
past a context shift and the CLI's to the JAX Engine's and CLI's, a session
file of either package continuing in the other as the uninterrupted stream;
against transformers' own f32 forward, 2e-4; xielu and relu2_glu within 1e-6
of the JAX functions; apply_mrope within 1e-6 of the JAX function, and equal
to neox rope over three equal streams.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

import arch_checks as ac  # noqa: E402
from arch_fixture import FEATURES, make_feature  # noqa: E402
from sparkinfer_tpu.gguf.reader import GGUFReader as JaxReader  # noqa: E402
from sparkinfer_tpu.models.config import ModelConfig as JaxConfig  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.ops import activations as jact  # noqa: E402
from sparkinfer_tpu.ops import rope as jrope  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_init_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import (  # noqa: E402
    FEATURE_ARCHS,
    check_supported,
    make_forward,
)
from sparkinfer_tpu_torch.ops import activations as tact  # noqa: E402
from sparkinfer_tpu_torch.ops import rope as trope  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402

V = ac.V
GREEDY = dict(temp=0.0)
VISION = {  # the smallest vision towers the two VL classes accept (the text stack is tested)
    "qwen2vl": dict(depth=1, embed_dim=32, hidden_size=64, num_heads=4, mlp_ratio=2,
                    in_channels=3, patch_size=4, temporal_patch_size=2, spatial_merge_size=2),
    "qwen3vl": dict(depth=1, hidden_size=32, out_hidden_size=64, intermediate_size=48,
                    num_heads=4, in_channels=3, patch_size=4, temporal_patch_size=2,
                    spatial_merge_size=2, num_position_embeddings=16,
                    deepstack_visual_indexes=[0]),
}
TEXT = dict(ac.BASE, rope_theta=10000.0, head_dim=16)
HF = {  # name -> (config class, model class, config keywords, base keywords)
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM", {}, ac.BASE),
    # 4 layers: three sliding (window 4, under the 9-token prompt) and a full one
    "olmo3": ("Olmo3Config", "Olmo3ForCausalLM", dict(
        num_hidden_layers=4, sliding_window=4, rope_scaling=None, pad_token_id=0), ac.BASE),
    "apertus": ("ApertusConfig", "ApertusForCausalLM", dict(
        rope_scaling=None, pad_token_id=0), ac.BASE),
    "bitnet": ("BitNetConfig", "BitNetForCausalLM", dict(pad_token_id=0), ac.BASE),
    "chameleon": ("ChameleonConfig", "ChameleonForConditionalGeneration", dict(
        vocabulary_map={"a": 1}, pad_token_id=0, vq_config=dict(
            embed_dim=8, num_embeddings=16, latent_channels=32, base_channels=32,
            channel_multiplier=[1], num_res_blocks=1, resolution=32)), ac.BASE),
    # M-RoPE sections of 2, 3 and 3 of the 8 rotary half-dims
    "qwen2vl": ("Qwen2VLConfig", "Qwen2VLForConditionalGeneration", dict(
        text_config=dict(TEXT, rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}),
        vision_config=VISION["qwen2vl"]), {}),
    "qwen3vl": ("Qwen3VLConfig", "Qwen3VLForConditionalGeneration", dict(
        text_config=dict(TEXT, rope_scaling={"rope_type": "default", "mrope_section": [2, 3, 3],
                                             "mrope_interleaved": True}),
        vision_config=VISION["qwen3vl"]), {}),
}
KINDS = ("deci", "openelm", "olmo2-fixture", "apertus-fixture", "bitnet-fixture")
NAMES = tuple(HF) + KINDS
# the norms, and apertus's xIELU coefficients (act_fn.alpha_p, act_fn.alpha_n)
NOISE = ("norm", "act_fn")


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """name -> (GGUF path, transformers' logits of the prompt or None)."""
    d = tmp_path_factory.mktemp("feature")
    out = {name: ac.hf_gguf(d, name, c, m, kw, base=base, noise=NOISE, f32=True)
           for name, (c, m, kw, base) in HF.items()}
    for kind in KINDS + ("openelm-widths",):
        make_feature(d / f"{kind}.gguf", kind.removesuffix("-fixture"), seed=7)
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
    return ModelConfig(**{**dict(arch=arch, n_layer=2, n_embd=64, n_head=4, n_head_kv=2,
                                 n_ff=96, n_vocab=V, head_dim=16), **kw})


def test_check_supported_admits_the_feature_archs():
    """The nine archs, deci and openelm with per-layer arrays; such arrays
    stay refused on any other arch."""
    assert set(FEATURE_ARCHS) == {"olmo2", "olmo3", "apertus", "bitnet", "deci", "openelm",
                                  "chameleon", "qwen2vl", "qwen3vl"}
    for arch in FEATURE_ARCHS:
        check_supported(_cfg(arch))
    for arch in ("deci", "openelm"):
        check_supported(_cfg(arch, n_head_arr=(4, 0), n_head_kv_arr=(2, 0), n_ff_arr=(96, 48)))
    for arch in ("olmo2", "qwen2vl"):
        with pytest.raises(NotImplementedError, match="per-layer .* outside deci and openelm"):
            check_supported(_cfg(arch, n_ff_arr=(96, 48)))


@pytest.mark.parametrize("name", ["xielu", "relu2_glu"])
def test_activations_match_jax(name):
    """apertus's xIELU (coefficients through softplus, as the loader gives
    them, eps above and below the smallest negative inputs) and bitnet's
    relu2_glu (in bf16 too), within 1e-6 of the JAX functions."""
    rng = np.random.default_rng(3)
    g = (3.0 * rng.standard_normal((5, 67))).astype(np.float32)
    u = (3.0 * rng.standard_normal((5, 67))).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        if name == "xielu" and dt == torch.float32:
            for eps in (-1e-6, -0.5):
                co = [np.asarray([c], np.float32) for c in (0.9, 1.3, 0.5, eps)]
                want = jact.xielu(jnp.asarray(u, jdt), *map(jnp.asarray, co))
                got = tact.xielu(torch.from_numpy(u).to(dt), *map(torch.from_numpy, co))
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                           rtol=1e-6, atol=1e-6)
        if name == "xielu":
            continue
        jg, jf = jact.act_fn(name)
        tg, tf = tact.act_fn(name)
        assert jg and tg
        want = jf(jnp.asarray(g, jdt), jnp.asarray(u, jdt))
        got = tf(torch.from_numpy(g).to(dt), torch.from_numpy(u).to(dt))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sections,D,interleaved", [
    ((2, 3, 3), 16, False), ((16, 24, 24), 128, False), ((24, 20, 20), 128, True),
    ((2, 3, 3), 16, True)], ids=["qwen2vl-tiny", "qwen2vl-7b", "qwen3vl-8b", "qwen3vl-tiny"])
def test_apply_mrope_matches_jax(sections, D, interleaved):
    """Three distinct position streams (temporal, height, width) over 2
    sequences: the port's apply_mrope within 1e-6 of the JAX function, in
    the plain and in qwen3vl's interleaved layout, at a YaRN-free base of
    1e6; three equal streams give neox rope bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos3 = np.stack([np.arange(14).reshape(2, 7), np.arange(14).reshape(2, 7) // 2,
                     (np.arange(14).reshape(2, 7) * 3) % 11]).astype(np.int64)
    kw = dict(dim=D, mode="neox", freq_base=1e6)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3, jnp.int32), sections,
                             jrope.RopeParams(**kw), interleaved=interleaved)
    p = trope.RopeParams(**kw)
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections, p,
                            interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    same = torch.from_numpy(np.stack([pos3[0]] * 3))
    assert torch.equal(trope.apply_mrope(torch.from_numpy(x), same, sections, p, interleaved),
                       trope.apply_rope(torch.from_numpy(x), same[0], p))


def _same_segments(jm, pm):
    """The port's params equal from_jax of the JAX loader's, segment by
    segment (a NAS stack's layers in runs of equal tensors and widths)."""
    want = params_from_numpy(jax.tree.map(np.asarray, jm.params), "cpu")
    got = pm.params
    assert set(got) == set(want), set(got) ^ set(want)
    for k in set(got) - {"layers", "layer_segments"}:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    segs = list(zip(got.get("layer_segments") or [got["layers"]],
                    want.get("layer_segments") or [want["layers"]], strict=True))
    for gs, ws in segs:
        assert set(gs) == set(ws), set(gs) ^ set(ws)
        for k, v in ws.items():
            assert gs[k].dtype == v.dtype and torch.equal(gs[k], v), k
    return [gs for gs, _ in segs]


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_jax(models, name):
    """Params bit-equal to from_jax of the JAX loader's, dtypes included:
    olmo2's blocks with no pre-norms (no all-ones attn_norm_w or
    ffn_norm_w), bitnet's f32 sub-norms, apertus's f32 xIELU coefficients
    after softplus, deci's three segments (the attention-free layer alone)."""
    jm, pm = models(name)
    segs = _same_segments(jm, pm)
    arch = pm.config.arch
    lay = segs[0]
    post_only = arch in ("olmo2", "olmo3")
    assert ("attn_norm_w" in lay) == ("ffn_norm_w" in lay) == (not post_only)
    assert ("attn_post_norm_w" in lay) == post_only
    assert ("attn_sub_norm_w" in lay and "ffn_sub_norm_w" in lay) == (arch == "bitnet")
    assert ("xielu_ap" in lay) == (arch == "apertus")
    for k in ("xielu_ap", "xielu_an", "xielu_beta", "xielu_eps", "attn_sub_norm_w"):
        assert k not in lay or lay[k].dtype == torch.float32, k
    if arch == "apertus":  # a_p = softplus(raw), a_n = beta + softplus(raw)
        raw = torch.tensor(jm.config.xielu_alpha_p, dtype=torch.float32)
        torch.testing.assert_close(lay["xielu_ap"][:, 0], torch.nn.functional.softplus(raw))
    if arch == "chameleon":  # the (H, D) and (Hkv, D) LayerNorm affines with biases
        assert lay["attn_q_norm_w"].shape == (2, 4, 16) and "attn_k_norm_b" in lay
    if arch == "deci":
        assert [tuple(s["w_up"].shape) for s in segs] == [(1, 64, 96), (1, 64, 48), (1, 64, 96)]
        assert "wq" not in segs[1] and segs[2]["wk"].shape == (1, 64, 16)
    assert (pm.config.mrope_sections == (2, 3, 3)) == (arch in ("qwen2vl", "qwen3vl"))
    assert pm.config.mrope_interleaved == (arch == "qwen3vl")


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(models, refs, name):
    """A 9-token prefill and 3 decode steps: logits within 1e-5 of the JAX
    forward's scale, through the fresh prefill (the chunk path, or for
    olmo3's windows the cache) and over the cache."""
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


def _mrope_pos(T):
    """Three distinct streams over T tokens (1, T each), as an image's grid
    would give them: time, then rows and columns that repeat."""
    t = np.arange(T)
    return np.stack([t, t // 2, (t * 3) % 5])[:, None, :].astype(np.int64)


@pytest.mark.parametrize("name", ["qwen2vl", "qwen3vl"])
def test_mrope_forward_matches_jax_and_transformers(ggufs, models, name):
    """The forward with three distinct M-RoPE streams (mrope_pos (3, 1, T)):
    a 9-token prefill's logits within 1e-5 of the JAX forward's with the same
    streams, and within 2e-4 of transformers' with them as position_ids; the
    cache is written at the slot positions either way."""
    import transformers as T

    jm, pm = models(name)
    toks = ac.PROMPT
    pos3 = _mrope_pos(len(toks))
    f = jax.jit(jax_forward(jm.config))
    want, _ = f(jm.params, jnp.asarray([toks], jnp.int32),
                jnp.arange(len(toks), dtype=jnp.int32)[None],
                jax_init_cache(jm.config, 1, 32, jnp.float32),
                mrope_pos=jnp.asarray(pos3, jnp.int32))
    cache = init_cache(pm.config, 1, 32, torch.float32, "cpu")
    with torch.inference_mode():
        got = make_forward(pm.config)(pm.params, torch.tensor([toks]),
                                      torch.arange(len(toks))[None], cache,
                                      mrope_pos=torch.from_numpy(pos3))[0]
    ac.check_logits([got.numpy()], [np.asarray(want)[0]])
    plain = ac.port_logits(pm, extra=())[0]
    assert ac.rel(got.numpy(), plain) > 1e-4  # the streams move the logits
    hf = getattr(T, HF[name][1]).from_pretrained(
        str(pathlib.Path(ggufs[name][0]).with_suffix("")), torch_dtype=torch.float32).eval()
    with torch.no_grad():
        ref = hf(torch.tensor([toks]), position_ids=torch.from_numpy(pos3)).logits[0].numpy()
    assert ac.rel(got.numpy(), ref) <= ac.HF_TOL, ac.rel(got.numpy(), ref)


def test_mrope_refused_without_sections(models):
    pm = models("olmo2")[1]
    cache = init_cache(pm.config, 1, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no rope.dimension_sections"):
        make_forward(pm.config)(pm.params, torch.tensor([[1, 2]]), torch.arange(2)[None], cache,
                                mrope_pos=torch.zeros((3, 1, 2), dtype=torch.long))


def test_deci_cache_views_land_in_place(models):
    """deci's layer of 1 KV head writes the cache's first head through a
    narrowed view, in place, and leaves the second zero; its attention-free
    layer writes nothing; the written K and V within 1e-5 of the JAX
    forward's cache."""
    jm, pm = models("deci")
    cfg = pm.config
    assert cfg.n_head_kv == 2 and cfg.n_head_kv_arr == (2, 0, 1)
    cache = init_cache(cfg, 1, 16, torch.float32, "cpu")
    toks = ac.PROMPT
    with torch.inference_mode():
        make_forward(cfg)(pm.params, torch.tensor([toks]), torch.arange(9)[None], cache)
    _, jc = jax.jit(jax_forward(jm.config))(
        jm.params, jnp.asarray([toks], jnp.int32), jnp.arange(9, dtype=jnp.int32)[None],
        jax_init_cache(jm.config, 1, 16, jnp.float32))
    for got, want in ((cache.k, jc.k), (cache.v, jc.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        assert got[2, :, :9, 0].abs().amin() > 0 and not got[2, :, :, 1].any()
        assert not got[1].any() and got[0, :, :9].abs().amin() > 0


def test_openelm_widths_match_the_jax_forward(ggufs):
    """openelm with widths that change between layers of the same tensors
    (4, 4, 2 heads over 2, 2, 1; FFN 96, 96, 64): the JAX loader cannot
    stack such a run, the port loads it in two segments. The JAX forward,
    given the port's segments, computes the port's logits within 1e-5."""
    path = ggufs["openelm-widths"][0]
    with pytest.raises(ValueError, match="same shape"):
        ac.jax_load(path, dtype=jnp.float32)
    pm = load_model(path, dtype=torch.float32, device="cpu")
    segs = pm.params["layer_segments"]
    assert [s["wq"].shape[0] for s in segs] == [2, 1] and segs[1]["w_up"].shape == (1, 64, 64)
    r = JaxReader(path)
    jcfg = JaxConfig.from_gguf(r)
    r.close()

    def j(t):
        return jnp.asarray(t.numpy())

    jsegs = [{k: j(v) for k, v in s.items()} for s in segs]
    jparams = {**{k: j(v) for k, v in pm.params.items() if k not in ("layers", "layer_segments")},
               "layers": jsegs[0], "layer_segments": jsegs}
    want = ac.jax_reference(type("M", (), {"config": jcfg, "params": jparams}))
    ac.check_logits(ac.port_logits(pm), want[0])
    assert ac.port_stream(pm) == want[1]


@pytest.mark.parametrize("name", ["olmo3", "deci"])
def test_scheduler_streams_match_jax(models, name):
    """olmo3's sliding pattern over post-norm blocks, and deci's segments
    with the attention-free layer, on 2 slots with three requests: the JAX
    Scheduler's streams."""
    jm, pm = models(name)
    prompts = [ac.PROMPT, ac.PROMPT[2:6], [7, 8, 9, 10, 11, 12, 13]]
    want, got = ac.scheduler_streams(jm, pm, prompts)
    assert got == want


def test_olmo3_iswa_engine_matches_jax(models):
    """olmo3 over the iSWA cache (three sliding layers of window 4 in rings
    of 36 slots, the full one in a full cache; prefill_chunk 32, whose last
    chunk the JAX Engine pads to 32 tokens, which a ring must hold) against
    the JAX Engine on the same options: a 40-token prompt in two chunks and
    20 greedy tokens past the rings' wrap, equal streams."""
    jm, pm = models("olmo3")
    prompt = [int(t) for t in np.random.default_rng(4).integers(0, V, 40)]
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.float32,
                   kv_iswa=True)
    je.prefill_chunk = 32
    pe = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                device="cpu", kv_iswa=True)
    pe.prefill_chunk = 32
    got = pe.generate(prompt, 20)
    assert got == je.generate(prompt, 20) and len(got) == 20
    assert [k.shape[2] for k in pe.cache.k] == [36, 64]


@pytest.mark.parametrize("name", ["olmo2", "chameleon", "bitnet"])
def test_int8_cache_engine_matches_jax(models, name):
    """The Engine over the int8 KV cache, past a context shift (max_seq
    24), against the JAX Engine on the same options: equal streams."""
    jm, pm = models(name)
    je = JaxEngine(jm, max_seq=24, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.bfloat16,
                   kv_quantized=True)
    pe = Engine(pm, max_seq=24, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.bfloat16,
                kv_quantized=True, device="cpu")
    got = pe.generate(ac.PROMPT, 32)
    assert got == je.generate(ac.PROMPT, 32) and len(got) == 32 and pe.cache.quantized


@pytest.mark.parametrize("name", ["deci", "apertus", "qwen2vl"])
def test_context_shift_engine_matches_jax(models, name):
    """The Engine past max_seq 24 (the context shift, n_keep 2), f32 cache,
    against the JAX Engine: equal streams, deci's narrowed layer and
    attention-free layer over the shifted cache."""
    jm, pm = models(name)
    je = JaxEngine(jm, max_seq=24, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.float32)
    pe = Engine(pm, max_seq=24, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                device="cpu")
    got = pe.generate(ac.PROMPT, 32, n_keep=2)
    assert got == je.generate(ac.PROMPT, 32, n_keep=2) and len(got) == 32


def test_state_files_cross_between_the_packages(models, tmp_path):
    """deci: a session saved by the JAX Engine after 4 decode steps restores
    in the port, a port save in the JAX Engine; both continuations equal the
    port's uninterrupted greedy stream."""
    from test_torch_state_io import _chain, _continue

    jm, pm = models("deci")

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


@pytest.mark.parametrize("name", ["olmo2", "deci"])
def test_cli_matches_the_jax_cli(ggufs, capsys, monkeypatch, name):
    """The CLI with a token-id prompt, plain and past max_seq (a context
    shift): the JAX CLI's streams, both loaders at f32 and an f32 KV cache."""
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
        argv = ["-m", ggufs[name][0], "-p", "5 9 42 7 5 9 42 7", "-n", "24", "--temp", "0",
                "-ctk", "f32"] + flags
        assert jax_main(argv) == 0
        want = capsys.readouterr().out
        assert main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr().out
        assert got == want and len(got.split()) == 24


def test_refusals_name_the_feature(models, tmp_path):
    """Paths the JAX package cannot take with these archs raise, naming
    each: the int8 cache over deci's layers of different KV head counts (the
    JAX forward narrows the codes and not their scales), the iSWA cache over
    deci's layer segments (the JAX iSWA branch scans the first segment
    alone), openelm's fused per-layer attn_qkv (the JAX package reads split
    q/k/v) and bitnet's per-tensor weight scales (no JAX loader reads
    them)."""
    from model_fixtures import make_tiny_llama

    jm, pm = models("deci")
    kw = dict(max_seq=32, sampler=SamplerConfig(**GREEDY), device="cpu")
    with pytest.raises(ValueError, match="int8 KV cache .* different KV head counts"):
        Engine(pm, kv_dtype=torch.bfloat16, kv_quantized=True, **kw)
    with pytest.raises(TypeError, match="reshape"):  # and the JAX Engine indeed fails there
        JaxEngine(jm, max_seq=32, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.bfloat16,
                  kv_quantized=True).generate(ac.PROMPT, 4)
    eng = Engine(pm, kv_dtype=torch.float32, kv_iswa=True, **kw)
    with pytest.raises(ValueError, match="iSWA cache over layer segments"):
        eng.generate(ac.PROMPT, 4)
    fused = tmp_path / "openelm-fused.gguf"
    make_tiny_llama(fused, arch="openelm", fused_qkv=True, n_head_kv=4)
    with pytest.raises(NotImplementedError, match="fused attn_qkv .* 'openelm'"):
        load_model(str(fused), dtype=torch.float32, device="cpu")
    scaled = tmp_path / "bitnet-scales.gguf"
    make_tiny_llama(scaled, arch="bitnet",
                    extra_tensors={"blk.0.attn_q.scale": np.ones(1, np.float32)})
    with pytest.raises(NotImplementedError, match="blk.0.attn_q.scale is not read"):
        load_model(str(scaled), dtype=torch.float32, device="cpu")
    # olmo2's uniform stack takes the int8 cache (test_int8_cache_engine_matches_jax)
    olmo2 = models("olmo2")[1]
    assert len(Engine(olmo2, kv_dtype=torch.bfloat16, kv_quantized=True, **kw).generate(
        ac.PROMPT, 4)) == 4


@pytest.mark.parametrize("kind", ["olmo2", "deci"])
def test_q8_fixture_loads_packed(tmp_path, kind):
    """The card's olmo2 and deci fixtures in Q8_0: every projection whose
    input is whole Q8_0 blocks and the head stay packed, as the JAX loader
    keeps them, segment by segment; the Engine's greedy stream equal to the
    JAX forward's. Both packages round each packed product's input to bf16,
    whose one-ulp steps (2^-8) an f32 difference of 1e-7 can flip between
    them; a flip moves these 3-layer logits by up to about 2e-3 of their
    scale (seen on this deci fixture), so the logits are held within 5e-3
    (the f32 forwards within 1e-5: test_forward_matches_jax)."""
    from sparkinfer_tpu.models.loader import load_model as jax_load
    from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

    path = tmp_path / f"{kind}-q8.gguf"
    make_feature(path, kind, seed=7, quant_type="q8_0")
    jm = jax_load(str(path), dtype=jnp.float32, keep_quantized=True)
    pm = load_model(str(path), dtype=torch.float32, device="cpu", keep_quantized=True)
    jsegs = jm.params.get("layer_segments") or [jm.params["layers"]]
    for seg, jseg in zip(pm.params.get("layer_segments") or [pm.params["layers"]], jsegs):
        for k in ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down"):
            if k in seg:  # packed where the rows are whole Q8_0 blocks (deci's 48-wide down not)
                packed = seg[k].shape[-2] % 32 == 0
                assert isinstance(seg[k], QuantTensor) == packed == hasattr(jseg[k], "kind"), k
    assert isinstance(pm.params["output"], QuantTensor) and hasattr(jm.params["output"], "kind")
    want = ac.jax_reference(jm, extra=(3,), n_new=8)
    ac.check_logits(ac.port_logits(pm, extra=(3,)), want[0], tol=5e-3)
    assert ac.port_stream(pm, n_new=8) == want[1]


def test_feature_kinds_are_the_card_fixtures():
    assert set(FEATURES) == {"olmo2", "apertus", "bitnet", "deci", "openelm", "openelm-widths"}
