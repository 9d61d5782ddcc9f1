"""The port's sliding-window attention path (the iSWA ring cache, attention
sinks, softcaps, sandwich norms, gemma3's second rope base) against the JAX
package's, on the CPU.

Tiny checkpoints of transformers' gemma, gemma2, gemma3 and gpt-oss (with
and without yarn) and a windowed llama, converted by the JAX package's
convert_hf, f32 throughout. Tolerances: logits within 1e-5 of their scale
(f32 sums in other orders); greedy streams equal; params equal bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.runtime import kv_cache as jkv  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu.tools.convert_hf import convert  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import check_supported, make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime import kv_cache as tkv  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402

W = 8  # every model's sliding window
V = 160
BASE = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
GPT_OSS = dict(num_hidden_layers=3, head_dim=16, intermediate_size=64, num_local_experts=4,
               num_experts_per_tok=2, sliding_window=W)
HF = {  # name -> (config class, model class, config keywords)
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(num_hidden_layers=2, head_dim=16)),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM",
               dict(num_hidden_layers=4, head_dim=16, query_pre_attn_scalar=16,
                    sliding_window=W)),
    # one 5+1 pattern block and a sliding layer; the global layers take the
    # linear factor, the sliding ones their own base unscaled
    "gemma3": ("Gemma3TextConfig", "Gemma3ForCausalLM",
               dict(num_hidden_layers=7, head_dim=16, query_pre_attn_scalar=16,
                    sliding_window=W, rope_theta=1e6, rope_local_base_freq=1e4,
                    rope_scaling={"rope_type": "linear", "factor": 8.0})),
    "gpt-oss": ("GptOssConfig", "GptOssForCausalLM", dict(GPT_OSS, rope_scaling=None)),
    # transformers' default: yarn, factor 32 over 4096 original positions
    "gpt-oss-yarn": ("GptOssConfig", "GptOssForCausalLM", GPT_OSS),
}
PROMPT = [int(t) for t in np.random.default_rng(0).integers(0, V, 40)]
GREEDY = dict(temp=0.0)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    import transformers as T

    d = tmp_path_factory.mktemp("swa")
    out = {}
    for name, (cfg_cls, cls, kw) in HF.items():
        torch.manual_seed(0)
        hf = getattr(T, cls)(getattr(T, cfg_cls)(**{**BASE, **kw})).eval()
        hf.save_pretrained(str(d / name), safe_serialization=True)
        out[name] = str(d / f"{name}.gguf")
        convert(str(d / name), out[name], out_type="f32")
    out["llama-window"] = str(d / "llama-window.gguf")  # every layer sliding
    make_tiny_llama(out["llama-window"], n_layer=3, n_vocab=V, seed=4,
                    extra_kv={"llama.attention.sliding_window": np.uint32(W)})
    return out


@pytest.fixture(scope="module")
def models(ggufs):
    """models(name) -> (JAX model, port model) of one GGUF, f32, loaded once."""
    loaded = {}

    def get(name):
        if name not in loaded:
            loaded[name] = (jax_load(ggufs[name], dtype=jnp.float32),
                            load_model(ggufs[name], dtype=torch.float32, device="cpu"))
        return loaded[name]

    return get


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the cache


@pytest.mark.parametrize("name", ["gemma2", "gemma3", "gpt-oss", "llama-window"])
def test_swa_runs_and_iswa_shapes_match_jax(models, name):
    """swa_runs and init_cache_iswa's buffer shapes equal the JAX package's,
    with rings narrower than max_seq and clipped to it."""
    jm, pm = models(name)
    assert tkv.swa_runs(pm.config) == jkv.swa_runs(jm.config)
    want_runs = {"gemma2": 4, "gemma3": 3, "gpt-oss": 3, "llama-window": 1}[name]
    assert len(tkv.swa_runs(pm.config)) == want_runs
    for max_seq, chunk in ((64, 4), (64, 60), (10, 4)):
        jc = jkv.init_cache_iswa(jm.config, 2, max_seq, chunk=chunk, dtype=jnp.float32)
        tc = tkv.init_cache_iswa(pm.config, 2, max_seq, chunk=chunk, dtype=torch.float32)
        assert tc.iswa and jc.iswa and tc.max_seq == jc.max_seq
        assert [tuple(a.shape) for a in tc.k] == [tuple(a.shape) for a in jc.k]
        assert [tuple(a.shape) for a in tc.v] == [tuple(a.shape) for a in jc.v]
        view = tkv.slot_view(tc, 1)
        assert all(a.shape[1] == 1 and a.data_ptr() == b[:, 1].data_ptr()
                   for a, b in zip(view.k, tc.k))
        room = tkv.ring_room(pm.config, tc, max_seq)
        assert room == (chunk if W + chunk < max_seq else None)


# ---------------------------------------------------------------------------
# the loader and the forward


@pytest.mark.parametrize("name", ["gemma2", "gemma3", "gpt-oss"])
def test_loader_matches_from_jax(ggufs, models, name):
    """The port's params equal from_jax of the JAX loader's, key for key:
    sinks, q/k/v/output biases, sandwich norms and the tied head; loaded in
    bf16 the sinks and norms stay f32, as in the JAX loader."""
    jm, pm = models(name)
    want = params_from_numpy(jax.tree.map(np.asarray, jm.params), "cpu")
    got = pm.params
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k in ("tok_embd", "output", "output_norm_w"):
        assert torch.equal(got[k], want[k]), k
    for k, v in want["layers"].items():
        assert got["layers"][k].dtype == v.dtype and torch.equal(got["layers"][k], v), k
    lay = got["layers"]
    if name == "gpt-oss":
        assert {"attn_sinks", "bq", "bk", "bv", "bo", "w_up_exps_b"} <= set(lay)
        assert lay["attn_sinks"].shape == (3, 4)
    else:
        assert {"attn_post_norm_w", "ffn_post_norm_w"} <= set(lay)
        assert torch.equal(got["output"], got["tok_embd"].T)  # the tied head
    bf = load_model(ggufs[name], dtype=torch.bfloat16, device="cpu").params["layers"]
    for k in ("attn_sinks", "attn_post_norm_w", "ffn_post_norm_w", "attn_norm_w"):
        if k in bf:
            assert bf[k].dtype == torch.float32, k
    assert bf["wq"].dtype == torch.bfloat16


def _steps(fwd, params, cache, toks, prompt_len, as_tensor):
    """Logits of a prefill of toks[:prompt_len] and one decode step per
    remaining token, as numpy."""
    out = []
    pos = np.arange(prompt_len)[None]
    out.append(np.asarray(fwd(params, as_tensor(np.asarray([toks[:prompt_len]])),
                              as_tensor(pos), cache)))
    for t in range(prompt_len, len(toks)):
        out.append(np.asarray(fwd(params, as_tensor(np.asarray([[toks[t]]])),
                                  as_tensor(np.asarray([[t]])), cache)))
    return out


@pytest.mark.parametrize("iswa", [False, True], ids=["full", "iswa"])
@pytest.mark.parametrize("name", ["gemma", "gemma2", "gemma3", "gpt-oss", "gpt-oss-yarn",
                                  "llama-window"])
def test_forward_matches_jax(models, name, iswa):
    """A 12-token prefill and 24 decode steps, past the window and (iSWA,
    chunk 12: rings of 20 slots) past a ring wrap: every step's logits
    within 1e-5 of the JAX forward's over the same kind of cache."""
    jm, pm = models(name)
    toks = PROMPT[:36]
    if iswa:
        jc = jkv.init_cache_iswa(jm.config, 1, 64, chunk=12, dtype=jnp.float32)
        tc = tkv.init_cache_iswa(pm.config, 1, 64, chunk=12, dtype=torch.float32)
    else:
        jc = jkv.init_cache(jm.config, 1, 64, jnp.float32)
        tc = tkv.init_cache(pm.config, 1, 64, torch.float32)
    jf = jax.jit(jax_forward(jm.config))
    state = {"cache": jc}

    def jfwd(params, tokens, positions, _):
        logits, state["cache"] = jf(params, tokens, positions, state["cache"])
        return logits

    want = _steps(jfwd, jm.params, None, toks, 12, lambda a: jnp.asarray(a, jnp.int32))
    got = _steps(make_forward(pm.config), pm.params, tc, toks, 12, torch.from_numpy)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= 1e-5, f"step {i}: {_rel(g, w):.3e}"


@pytest.mark.parametrize("name", ["gemma2", "gemma3", "gpt-oss"])
def test_iswa_matches_the_full_cache_in_small_chunks(models, name):
    """The port's iSWA cache against its full cache: a 40-token prompt in
    chunks of 4 into rings of 12 slots (the ring wraps inside the chunked
    prefill), then decode steps; logits within 1e-5. The Engine with
    prefill_chunk 4 gives the same greedy stream with and without kv_iswa."""
    _, pm = models(name)
    fwd = make_forward(pm.config)
    full = tkv.init_cache(pm.config, 1, 64, torch.float32)
    ring = tkv.init_cache_iswa(pm.config, 1, 64, chunk=4, dtype=torch.float32)
    assert tkv.ring_room(pm.config, ring, 64) == 4
    toks = PROMPT + PROMPT[:8]
    spans = [(off, off + 4) for off in range(0, 40, 4)] + [(p, p + 1) for p in range(40, 48)]
    with torch.inference_mode():
        for a, b in spans:
            t, pos = torch.tensor([toks[a:b]]), torch.arange(a, b)[None]
            want, got = fwd(pm.params, t, pos, full), fwd(pm.params, t, pos, ring)
            assert _rel(got, want) <= 1e-5, a
    streams = []
    for kv_iswa in (False, True):
        eng = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                     device="cpu", kv_iswa=kv_iswa)
        eng.prefill_chunk = 4
        streams.append(eng.generate(PROMPT, 16))
        assert eng.cache.iswa == kv_iswa
    assert streams[0] == streams[1]


def test_prefill_chunk_is_cut_to_the_ring(models):
    """A prefill_chunk raised after the iSWA cache was made is cut to the
    ring's room, so that no chunk overwrites keys its own queries need."""
    _, pm = models("gemma2")
    a = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
               device="cpu", kv_iswa=True)
    a.prefill_chunk = 4
    a.own_cache()
    a.prefill_chunk = 32
    b = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
               device="cpu")
    assert a.generate(PROMPT, 12) == b.generate(PROMPT, 12)


# ---------------------------------------------------------------------------
# the Engine and the Scheduler against the JAX package's


@pytest.mark.parametrize("name,mode", [("gemma2", "dense"), ("gpt-oss", "dense"),
                                       ("gpt-oss", "pallas")])
def test_engine_iswa_streams_match_jax(ggufs, models, name, mode):
    """Engine(kv_iswa=True) against the JAX Engine(kv_iswa=True), both with
    prefill_chunk 32 (rings of 40 slots, max_seq 64): a 40-token prompt in
    two chunks and 20 greedy tokens past the ring's wrap, equal streams."""
    jm, pm = models(name)
    if mode == "pallas":  # the JAX Engine replaces the expert stacks in its model's params
        jm = jax_load(ggufs[name], dtype=jnp.float32)
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.float32,
                   kv_iswa=True, moe_mode=mode)
    je.prefill_chunk = 32
    pe = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                device="cpu", kv_iswa=True, moe_mode=mode)
    pe.prefill_chunk = 32
    got = pe.generate(PROMPT, 20)
    assert got == je.generate(PROMPT, 20)
    assert [a.shape[2] for a in pe.cache.k][0] == 40


@pytest.mark.parametrize("name", ["gemma2", "gpt-oss"])
def test_scheduler_streams_match_jax(models, name):
    """The Scheduler keeps a full cache a slot and the window as a mask, as
    the JAX one (gpt-oss ticks in dense MoE mode): three requests on one
    slot, prompts across the window, equal greedy streams."""
    jm, pm = models(name)
    prompts = [PROMPT[:20], PROMPT[5:9], PROMPT[10:23]]
    js = JaxScheduler(jm, n_slots=1, max_seq=64, sampler=JaxSampler(**GREEDY),
                      kv_dtype=jnp.float32)
    jreqs = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=12)) for p in prompts]
    js.run_until_idle()
    ps = Scheduler(pm, n_slots=1, max_seq=64, sampler=SamplerConfig(**GREEDY),
                   kv_dtype=torch.float32, device="cpu")
    preqs = [ps.submit(Request(prompt_tokens=p, max_new_tokens=12)) for p in prompts]
    ps.run_until_idle()
    assert [r.tokens() for r in preqs] == [r.tokens() for r in jreqs]


# ---------------------------------------------------------------------------
# what an iSWA cache refuses, and what check_supported still refuses


def test_iswa_refusals(models, tmp_path):
    """Context shift, self-extend, state files, the drafters and the
    pipelined sparse FFN's carry have no iSWA path: ValueError."""
    from sparkinfer_tpu_torch.models.transformer import rope_params
    from sparkinfer_tpu_torch.runtime.lookahead import LookaheadEngine
    from sparkinfer_tpu_torch.runtime.lookup import LookupEngine
    from sparkinfer_tpu_torch.runtime.self_extend import SelfExtendState, self_extend_step
    from sparkinfer_tpu_torch.runtime.state_io import load_state, save_state
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    _, pm = models("gemma2")
    cfg = pm.config
    cache = tkv.init_cache_iswa(cfg, 1, 64, chunk=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="iSWA"):
        tkv.shift_cache(cache, rope_params(cfg), 2, 8, 30)
    with pytest.raises(ValueError, match="iSWA"):
        self_extend_step(cache, rope_params(cfg), SelfExtendState(2, 8), 20)
    with pytest.raises(ValueError, match="iSWA"):
        save_state(str(tmp_path / "s.bin"), cfg, cache, 4)
    full = tkv.init_cache(cfg, 1, 64, torch.float32)
    save_state(str(tmp_path / "s.bin"), cfg, full, 4)
    with pytest.raises(ValueError, match="iSWA"):
        load_state(str(tmp_path / "s.bin"), cfg, cache)
    kw = dict(max_seq=24, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
              device="cpu")
    with pytest.raises(ValueError, match="self-extend"):
        Engine(pm, kv_iswa=True, self_extend=(2, 8), **kw)
    eng = Engine(pm, kv_iswa=True, **kw)
    for drafter in (LookupEngine, LookaheadEngine):
        with pytest.raises(ValueError, match="iSWA"):
            drafter(eng)
    with pytest.raises(ValueError, match="iSWA"):
        eng.save_session(str(tmp_path / "e.bin"), eng.own_cache(), 0)
    with pytest.raises(ValueError, match="context shift"):  # generation past max_seq
        eng.generate(PROMPT[:20], 8)
    with pytest.raises(ValueError, match="carry"):
        Engine(pm, kv_iswa=True, sparse=SparseConfig(16, 4), **kw)
    carry = make_forward(cfg, ffn_fn=lambda lp, x, c, il: (x * 0, c),
                         ffn_carry_init=lambda B, T, dev: None)
    with pytest.raises(ValueError, match="carry"):
        carry(pm.params, torch.tensor([[1]]), torch.tensor([[0]]), cache)


@pytest.mark.parametrize("kw,match", [
    (dict(arch="llama", kv_lora_rank=32, rope_dim=8), "MLA"),  # minicpm3's is ported
    (dict(arch="llama", n_head_arr=(4, 4)), "per-layer"),
    (dict(arch="llama", n_ff_arr=(96, 64)), "per-layer"),
    (dict(arch="qwen3", kv_lora_rank=32, rope_dim=8), "MLA"),  # plm's is ported
    # Baichuan-13B at its published widths (the refact case this once held is
    # ported); the small 40-layer cut below
    (dict(arch="baichuan", n_layer=40, n_embd=5120, n_head=40, n_head_kv=40, head_dim=128,
          n_ff=13696, n_vocab=64000), "ALiBi"),
    # cohere2's windows with rope-less global layers (gemma-embedding's
    # symmetric window, which this case once held, is ported)
    (dict(arch="cohere2", sliding_window=8), "cohere2"),
    (dict(arch="gemma3n", sliding_window=8), "gemma3n"),
    (dict(arch="gpt-oss"), "without experts"),
    (dict(arch="baichuan", n_layer=40), "ALiBi .* of Baichuan-13B"),
])
def test_check_supported_still_refuses(kw, match):
    cfg = ModelConfig(**{**dict(n_layer=2, n_embd=64, n_head=4, n_head_kv=2, n_ff=96,
                                n_vocab=V, head_dim=16), **kw})
    with pytest.raises(NotImplementedError, match=match):
        check_supported(cfg)


@pytest.mark.parametrize("arch,kw", [("gemma", {}), ("gemma2", dict(sliding_window=8)),
                                     ("gemma3", dict(sliding_window=8)),
                                     ("mistral", dict(sliding_window=8)),
                                     ("gpt-oss", dict(sliding_window=8, n_expert=4,
                                                      n_expert_used=2))])
def test_check_supported_admits_the_sliding_window_archs(arch, kw):
    check_supported(ModelConfig(arch=arch, n_layer=2, n_embd=64, n_head=4, n_head_kv=2,
                                n_ff=96, n_vocab=V, head_dim=16, **kw))
