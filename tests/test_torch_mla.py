"""deepseek2 in the port against the JAX package, on the CPU: multi-head
latent attention (MLA) over the latent cache, the leading dense layer and
the MoE layers as layer segments, shared experts and the routed scale.

Tiny GGUFs of tests/deepseek2_fixture.py, from numpy seeds:
3 layers (1 leading dense, 2 MoE), E=64, 4 heads, 4 experts of width 48
with 2 used, softmax gating without top-k renormalization, a routed scale
of 1.5, one shared expert; R=32, Dr=8, Dn=16, Dv=16. Variants: "direct"
(V2-Lite's direct q projection), "qlora" (V2/V3's q-lora) and "yarn"
(direct q under yarn rope scaling, as V2-Lite ropes). Tolerances, f32:
  - loaded params and from_jax's params: exactly equal;
  - prefill logits and 8 decode steps: 1e-5 of the logits' scale;
  - stepwise decode against one prefill over the latent cache: 2e-4, as
    the JAX package's own test holds it;
  - greedy streams of the Engine (dense and "pallas" MoE, the JAX v1 in
    interpret mode, the port's plain v1), the 2-slot Scheduler, the CLI
    and the server: equal;
  - a slot state file: bit for bit; the context shift: k_pe against the
    rope of the rows before it, 1e-6, c_kv moved bit for bit.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepseek2_fixture import DN, DR, DV, FE, E, F, H, K, R, V, X, make_deepseek2  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import (  # noqa: E402
    check_supported,
    make_forward,
    rope_params,
)
from sparkinfer_tpu_torch.ops.rope import apply_rope  # noqa: E402
from sparkinfer_tpu_torch.runtime import kv_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402

PROMPT = [5, 9, 42, 7, 11]
TOL = 1e-5
GREEDY = dict(temp=0.0)
VARIANTS = {"direct": {}, "qlora": dict(q_lora=24), "yarn": dict(yarn=True)}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("deepseek2")
    out = {}
    for i, (name, kw) in enumerate(VARIANTS.items()):
        out[name] = str(d / f"{name}.gguf")
        make_deepseek2(out[name], seed=7 + i, **kw)
    out["vocab"] = str(d / "vocab.gguf")
    make_deepseek2(out["vocab"], seed=3, n_vocab=300, with_vocab=True)
    return out


def _both(path):
    return (jax_load(path, dtype=jnp.float32),
            load_model(path, dtype=torch.float32, device="cpu"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(got, ref, key=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), key
        for k in ref:
            _same(got[k], ref[k], f"{key}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), key
        for i, (g, r) in enumerate(zip(got, ref)):
            _same(g, r, f"{key}[{i}]")
    else:
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=key)


def _close(got, ref, rel=TOL):
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= rel * scale, (np.abs(got - ref).max(), scale)


def _jax_steps(jm, steps=8):
    """The JAX forward's prefill logits and `steps` greedy decode steps'."""
    cfg = jm.config
    cache = jax_cache(cfg, 1, 32, jnp.float32)
    pre, dec = jax.jit(jax_forward(cfg, fresh_prefill=True)), jax.jit(jax_forward(cfg))
    lg, cache = pre(jm.params, jnp.asarray([PROMPT], jnp.int32),
                    jnp.arange(len(PROMPT), dtype=jnp.int32)[None], cache)
    rows, toks = [np.asarray(lg)[0]], []
    for i in range(steps):
        toks.append(int(np.argmax(rows[-1][-1])))
        lg, cache = dec(jm.params, jnp.asarray([[toks[-1]]], jnp.int32),
                        jnp.asarray([[len(PROMPT) + i]], jnp.int32), cache)
        rows.append(np.asarray(lg)[0])
    return rows, toks


def _port_steps(cfg, params, toks):
    """The port's prefill logits and its decode steps fed the JAX tokens."""
    cache = kv_cache.init_cache(cfg, 1, 32, torch.float32, "cpu")
    with torch.inference_mode():
        rows = [make_forward(cfg, fresh_prefill=True)(
            params, torch.tensor([PROMPT]), torch.arange(len(PROMPT))[None], cache)[0].numpy()]
        fwd = make_forward(cfg)
        for i, tok in enumerate(toks):
            rows.append(fwd(params, torch.tensor([[tok]]),
                            torch.tensor([[len(PROMPT) + i]]), cache)[0].numpy())
    return rows


# ---------------------------------------------------------------------------
# configuration, loading, the forward


def test_check_supported_admits_deepseek2():
    check_supported(ModelConfig(arch="deepseek2", n_layer=3, n_embd=E, n_head=H, n_head_kv=H,
                                n_ff=F, n_vocab=V, head_dim=DN + DR, rope_dim=DR,
                                kv_lora_rank=R, v_head_dim=DV, n_expert=X, n_expert_used=K,
                                n_ff_exp=FE, n_dense_lead=1))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_load_and_from_jax_match_the_jax_loader(ggufs, variant):
    """The port's load equals the JAX loader's params key for key, its layer
    segments too (the leading dense layer, then the two MoE layers), and
    from_jax carries the JAX params over to the same tensors."""
    jm, tm = _both(ggufs[variant])
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.config.n_head_kv == H  # the JAX quirk under MLA; the cache ignores it
    ref = _np(jm.params)
    got = tm.params
    segs = got["layer_segments"]
    assert [len(s["wkv_a"]) for s in segs] == [1, 2] and got["layers"] is segs[0]
    assert "w_up" in segs[0] and "w_router" in segs[1] and "w_up" not in segs[1]
    assert segs[0]["wk_b"].shape == (1, R, H, DN) and segs[0]["wv_b"].shape == (1, R, H, DV)
    assert segs[0]["wo"].shape == (1, H * DV, E)
    assert ("wq_a" in segs[0]) == (variant == "qlora") != ("wq" in segs[0])
    # the port keeps up and gate expert stacks as (X, Fe, E), JAX as (X, E, Fe)
    for k in ("w_up_exps", "w_gate_exps"):
        ref["layer_segments"][1][k] = np.swapaxes(ref["layer_segments"][1][k], -1, -2)
    ref["layers"] = ref["layer_segments"][0]
    _same(got, ref)
    carried = params_from_numpy(_np(jm.params), "cpu")
    assert carried["layers"] is carried["layer_segments"][0]
    _same(carried, ref)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(ggufs, variant):
    """Prefill logits (every position) and 8 decode steps within 1e-5 of the
    JAX forward's, through load_model and through from_jax."""
    jm, tm = _both(ggufs[variant])
    ref, toks = _jax_steps(jm)
    for params in (tm.params, params_from_numpy(_np(jm.params), "cpu")):
        for got, want in zip(_port_steps(tm.config, params, toks), ref):
            _close(got, want)


def test_latent_cache_and_stepwise_decode(ggufs):
    """One latent slot of R + Dr a token and a zero-width v, far smaller than
    a per-head K/V cache; decoding token by token over it equals one
    prefill of the same tokens within 2e-4."""
    tm = load_model(ggufs["qlora"], dtype=torch.float32, device="cpu")
    cfg = tm.config
    cache = kv_cache.init_cache(cfg, 1, 32, torch.float32, "cpu")
    assert cache.k.shape == (3, 1, 32, 1, R + DR) and cache.v.shape == (3, 1, 32, 1, 0)
    nbytes = sum(b.numel() * b.element_size() for b in cache.buffers())
    per_head = cfg.n_layer * 32 * H * ((DN + DR) + DV) * 4  # H heads of k (Dk) and v (Dv)
    assert nbytes == cfg.n_layer * 32 * (R + DR) * 4 and 4 * nbytes == per_head
    assert len(kv_cache.cache_key(cache)[1]) == 2
    toks = [5, 9, 42, 7, 11, 3, 64]
    with torch.inference_mode():
        full = make_forward(cfg)(tm.params, torch.tensor([toks]), torch.arange(7)[None],
                                 cache)[0].numpy()
        step_cache = kv_cache.init_cache(cfg, 1, 32, torch.float32, "cpu")
        fwd = make_forward(cfg)
        steps = [fwd(tm.params, torch.tensor([[t]]), torch.tensor([[i]]), step_cache)[0, 0]
                 .numpy() for i, t in enumerate(toks)]
    np.testing.assert_allclose(np.stack(steps), full, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(step_cache.k[:, :, :7].numpy(), cache.k[:, :, :7].numpy(),
                               rtol=2e-4, atol=2e-4)
    view = kv_cache.slot_view(cache, 0)
    assert view.k.data_ptr() == cache.k.data_ptr() and view.v.shape == (3, 1, 32, 1, 0)


def test_expert_groups_at_the_expert_width():
    """The fused mode's groups split the experts' width n_ff_exp, not the
    leading dense layer's n_ff: DeepSeek-V2-Lite's 1408 in 11 groups of 128
    (6 experts a token: C = 66), the fixture's 48 in 3 of 16."""
    from sparkinfer_tpu_torch.sparse.moe import expert_groups

    lite = ModelConfig(arch="deepseek2", n_layer=27, n_embd=2048, n_head=16, n_head_kv=16,
                       n_ff=10944, n_ff_exp=1408, n_vocab=102400, head_dim=192,
                       n_expert=64, n_expert_used=6)
    assert expert_groups(lite, 128) == (128, 11)
    tiny = ModelConfig(arch="deepseek2", n_layer=3, n_embd=E, n_head=H, n_head_kv=H, n_ff=F,
                       n_ff_exp=FE, n_vocab=V, head_dim=DN + DR, n_expert=X, n_expert_used=K)
    assert expert_groups(tiny, 16) == (16, 3)


# ---------------------------------------------------------------------------
# the runtime


@pytest.mark.parametrize("mode", ["dense", "pallas"])
def test_engine_streams_match_jax(ggufs, mode):
    """Engine(moe_mode=...) against the JAX Engine: equal greedy streams;
    "pallas" lays out the rows of the MoE segment only, in the engine's
    own params."""
    path = ggufs["direct"]
    je = JaxEngine(jax_load(path, dtype=jnp.float32), max_seq=64, sampler=JaxSampler(**GREEDY),
                   kv_dtype=jnp.float32, moe_mode=mode)
    model = load_model(path, dtype=torch.float32, device="cpu")
    pe = Engine(model, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                device="cpu", moe_mode=mode)
    got = pe.generate(PROMPT, 12)
    assert got == je.generate(PROMPT, 12) and len(got) == 12
    segs = pe.params["layer_segments"]
    assert ("moe_up_rows" in segs[1]) == (mode == "pallas") and "moe_up_rows" not in segs[0]
    assert pe.params["layers"] is segs[0]
    assert pe.cache.k.shape[-2:] == (1, R + DR) and pe.cache.v.shape[-1] == 0
    assert "w_up_exps" in model.params["layer_segments"][1]


def test_scheduler_streams_match_jax(ggufs):
    """A 2-slot Scheduler (dense MoE, slots over the latent cache) against
    the JAX Scheduler: two requests at once, equal greedy streams."""
    path = ggufs["qlora"]
    prompts = [[3, 14, 15, 92], [9, 26, 53]]
    js = JaxScheduler(jax_load(path, dtype=jnp.float32), n_slots=2, max_seq=64,
                      sampler=JaxSampler(**GREEDY), kv_dtype=jnp.float32)
    jreqs = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=8)) for p in prompts]
    js.run_until_idle()
    ps = Scheduler(load_model(path, dtype=torch.float32, device="cpu"), n_slots=2, max_seq=64,
                   sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32, device="cpu")
    assert ps.cache.k.shape == (3, 2, 64, 1, R + DR) and ps.cache.v.shape[-1] == 0
    preqs = [ps.submit(Request(prompt_tokens=p, max_new_tokens=8)) for p in prompts]
    ps.run_until_idle()
    got = [r.tokens() for r in preqs]
    assert got == [r.tokens() for r in jreqs] and all(len(g) == 8 for g in got)


def test_slot_state_file_round_trips_the_latent_cache(ggufs, tmp_path):
    """A Scheduler slot saved and restored into another slot, and an Engine
    session saved and loaded: the latent rows bit for bit, the zero-width v
    too, and the restored slot serves the same stream."""
    from sparkinfer_tpu_torch.runtime.state_io import load_state, save_state

    model = load_model(ggufs["direct"], dtype=torch.float32, device="cpu")
    eng = Engine(model, max_seq=32, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                 device="cpu")
    cache, st = eng.own_cache(), eng.new_sampler_state()
    _, cache, st, n = eng.prefill(PROMPT, cache, st)
    saved = cache.k[:, :, :n].clone()
    path = str(tmp_path / "mla.bin")
    assert eng.save_session(path, cache, n, st, PROMPT) > 0
    other = kv_cache.init_cache(model.config, 2, 32, torch.float32, "cpu")
    _, n2, toks, _ = load_state(path, model.config, other, slot=1)
    assert n2 == n and toks == PROMPT
    assert torch.equal(other.k[:, 1, :n], saved[:, 0]) and other.v.shape[-1] == 0
    assert not other.k[:, 0].any()
    cache.k.zero_()
    eng.load_session(path)
    assert torch.equal(eng.cache.k[:, :, :n], saved)
    save_state(str(tmp_path / "again.bin"), model.config, other, n, slot=1)


def test_context_shift_rotates_only_k_pe(ggufs):
    """The shift over the latent cache moves c_kv unchanged and rotates k_pe
    by -discard (the JAX shift would rotate lanes of c_kv instead); under
    yarn the rotation carries no second magnitude. An Engine then generates
    past max_seq through it."""
    for variant in ("direct", "yarn"):
        model = load_model(ggufs[variant], dtype=torch.float32, device="cpu")
        cfg, rp = model.config, rope_params(model.config)
        cache = kv_cache.init_cache(cfg, 1, 16, torch.float32, "cpu")
        toks = list(range(3, 15))
        with torch.inference_mode():
            make_forward(cfg)(model.params, torch.tensor([toks]), torch.arange(12)[None], cache)
        before = cache.k.clone()
        kv_cache.shift_cache(cache, rp, keep=2, discard=4, n_past=12)
        src, dst = before[:, :, 6:12], cache.k[:, :, 2:8]
        assert torch.equal(dst[..., :R], src[..., :R])  # c_kv moved, not rotated
        assert torch.equal(cache.k[:, :, :2], before[:, :, :2])
        pos = torch.full((6,), -4)
        want = apply_rope(src[..., R:], pos, rp)
        if variant == "yarn":
            from sparkinfer_tpu_torch.ops.rope import rope_freqs

            mscale = rope_freqs(rp)[1]
            assert mscale > 1.3
            want = want / mscale
        np.testing.assert_allclose(dst[..., R:].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    eng = Engine(model, max_seq=16, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                 device="cpu")
    out = eng.generate(PROMPT, 24, n_keep=2)
    assert len(out) == 24 and eng.perf.n_decode == 23


def test_drafters_run_over_the_latent_cache(ggufs):
    """Lookup, lookahead and speculative decoding verify blocks over the
    latent cache and, greedy, give the Engine's own stream."""
    from sparkinfer_tpu_torch.runtime.lookahead import LookaheadEngine
    from sparkinfer_tpu_torch.runtime.lookup import LookupEngine
    from sparkinfer_tpu_torch.runtime.speculative import SpeculativeEngine

    model = load_model(ggufs["direct"], dtype=torch.float32, device="cpu")

    def engine():
        return Engine(model, max_seq=64, sampler=SamplerConfig(**GREEDY),
                      kv_dtype=torch.float32, device="cpu")

    prompt = [5, 9, 5, 9, 5, 9, 42]
    want = engine().generate(prompt, 16)
    assert LookupEngine(engine(), n_draft=3).generate(prompt, 16) == want
    assert LookaheadEngine(engine()).generate(prompt, 16) == want
    assert SpeculativeEngine(engine(), engine(), n_draft=3).generate(prompt, 16) == want


def test_unported_paths_raise_naming_the_feature(ggufs, tmp_path):
    """Self-extend (it rotates whole key heads), the iSWA cache, expert
    tiering over the layer segments, the predictor-gated sparse modes, the
    int8 KV cache, LoRA adapters and control vectors over the segments all
    raise, naming the feature."""
    from sparkinfer_tpu_torch.models.lora import apply_control_vector
    from sparkinfer_tpu_torch.runtime.self_extend import SelfExtendState, self_extend_step
    from sparkinfer_tpu_torch.sparse.config import SparseConfig
    from sparkinfer_tpu_torch.sparse.moe import make_tiered_moe_ffn

    model = load_model(ggufs["direct"], dtype=torch.float32, device="cpu")
    cfg = model.config
    kw = dict(max_seq=32, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
              device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        Engine(model, self_extend=(2, 8), **kw)
    with pytest.raises(ValueError, match="MLA"):
        self_extend_step(kv_cache.init_cache(cfg, 1, 32, torch.float32, "cpu"),
                         rope_params(cfg), SelfExtendState(2, 8), 20)
    with pytest.raises(ValueError, match="MLA"):
        kv_cache.init_cache_iswa(cfg, 1, 32)
    with pytest.raises(ValueError, match="MLA"):
        Engine(model, kv_iswa=True, **kw).generate(PROMPT, 2)
    with pytest.raises(NotImplementedError, match="expert tiering over layer segments"):
        make_tiered_moe_ffn(cfg, SparseConfig(16, 4, hot_groups=4), None, mode="drop")
    with pytest.raises(ValueError, match="predictor"):
        Engine(model, sparse=SparseConfig(16, 4), **kw)
    with pytest.raises(ValueError, match="predictor"):
        Scheduler(model, n_slots=2, sparse=SparseConfig(16, 4), **kw)
    with pytest.raises(ValueError, match="int8 KV cache .* MLA"):
        Scheduler(model, n_slots=2, kv_quantized=True, **kw)
    with pytest.raises(NotImplementedError, match="control vector over layer segments"):
        apply_control_vector(model.params, cfg, np.zeros((3, E), np.float32))
    from test_torch_lora import write_lora

    from sparkinfer_tpu_torch.models.lora import apply_lora

    write_lora(str(tmp_path / "lora.gguf"), 3, E, F, alpha=16.0)
    with pytest.raises(NotImplementedError, match="LoRA adapter over layer segments"):
        apply_lora(model.params, cfg, str(tmp_path / "lora.gguf"))


# ---------------------------------------------------------------------------
# the entry points: the CLI and the server


def test_cli_stream_matches_the_jax_cli(ggufs, capsys, monkeypatch):
    """The port's CLI on a deepseek2 GGUF against the JAX CLI, both loaders
    made to load f32: the same printed stream."""
    from sparkinfer_tpu.models import loader as jax_loader
    from sparkinfer_tpu.tools.cli import main as jax_main
    from sparkinfer_tpu_torch.models import loader
    from sparkinfer_tpu_torch.tools.cli import main

    jl, tl = jax_loader.load_model, loader.load_model
    monkeypatch.setattr(jax_loader, "load_model",
                        lambda path, **kw: jl(path, **{**kw, "dtype": jnp.float32}))
    monkeypatch.setattr(loader, "load_model",
                        lambda path, **kw: tl(path, **{**kw, "dtype": torch.float32}))
    argv = ["-m", ggufs["direct"], "-p", "5 9 42", "-n", "16", "--temp", "0", "-ctk", "f32"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.split()) >= 16


def test_server_completion_matches_jax(ggufs):
    """A deepseek2 GGUF with a vocabulary behind both servers (one slot,
    f32): one greedy completion, the same text and token counts."""
    from sparkinfer_tpu.server import ServerConfig as JaxServerConfig
    from sparkinfer_tpu.server import SparkServer as JaxServer
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    path = ggufs["vocab"]
    jsrv = JaxServer(jax_load(path, dtype=jnp.float32),
                     JaxServerConfig(port=0, n_slots=1, max_seq=64, kv_dtype="f32"),
                     sampler=JaxSampler(**GREEDY))
    tsrv = SparkServer(load_model(path, dtype=torch.float32, device="cpu"),
                       ServerConfig(port=0, n_slots=1, max_seq=64, kv_dtype="f32",
                                    device="cpu"), sampler=SamplerConfig(**GREEDY))
    body = json.dumps({"prompt": "hello world", "max_tokens": 8, "temperature": 0.0}).encode()
    outs = []
    try:
        for srv in (jsrv, tsrv):
            srv.serve(block=False)
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                outs.append(json.loads(r.read()))
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    (want, got) = outs
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"] and got["usage"]["completion_tokens"] == 8
