"""The port's Mixture-of-Experts (sparse/moe.py, the MoE loader, forward,
Engine, Scheduler and server) against the JAX package's, on the CPU.

Two tiny GGUFs of tests/model_fixtures.py, f32: a llama-MoE (4 experts, 2
used) and a qwen3moe (8 experts, 3 used, per-head q/k norms). Inputs come
from numpy seeds; the JAX fused mode runs its Pallas v1 kernel off the TPU
as its own tests run it, the port's its plain version. Tolerances: routing
weights 1e-6 (the same f32 softmax and sums), expert ids equal; FFN outputs
1e-5 of their scale (f32 sums in other orders); forward logits 1e-5 of
their scale; greedy streams equal.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from model_fixtures import make_tiny_llama  # noqa: E402
from sparkinfer_tpu.models.config import ModelConfig as JaxConfig  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.models.transformer import make_forward as jax_forward  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_cache  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu.sparse import moe as jmoe  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import make_forward  # noqa: E402
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402
from sparkinfer_tpu_torch.sparse import moe as tmoe  # noqa: E402

PROMPT = [5, 9, 42]
G = 16  # the function-level tests' group size: 2-4 groups an expert


def _qwen3moe(path, **kw):
    """A qwen3moe GGUF: 8 experts of width 32, 3 used, per-head q/k norms."""
    rng = np.random.default_rng(11)
    D = 64 // 4
    norms = {f"blk.{i}.attn_{qk}_norm.weight": 1.0 + 0.2 * rng.standard_normal(D)
             for i in range(2) for qk in ("q", "k")}
    moe_kv = {"qwen3moe.expert_feed_forward_length": 32, "qwen3moe.expert_gating_func": 1,
              "qwen3moe.expert_weights_norm": True}
    make_tiny_llama(path, arch="qwen3moe", n_expert=8, n_expert_used=3, n_ff=32, seed=3,
                    extra_tensors=norms, extra_kv=moe_kv, **kw)


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    make_tiny_llama(d / "llama-moe.gguf", n_expert=4, n_expert_used=2, n_ff=64, seed=7)
    _qwen3moe(d / "qwen3moe.gguf")
    return {"llama_moe": str(d / "llama-moe.gguf"), "qwen3moe": str(d / "qwen3moe.gguf")}


@pytest.fixture(scope="module")
def llama_moe(ggufs):
    """(JAX cfg, port cfg, JAX layer-0 params as numpy) of the llama-MoE."""
    jm = jax_load(ggufs["llama_moe"], dtype=jnp.float32)
    pm = load_model(ggufs["llama_moe"], dtype=torch.float32, device="cpu")
    lp = {k: np.asarray(v[0]) for k, v in jm.params["layers"].items()}
    return jm.config, pm.config, lp


def _pair(jcfg, pcfg, lp_np, **cfg_kw):
    """The JAX and port configs with cfg_kw, and the layer params of both
    (the port's through from_jax)."""
    jcfg, pcfg = dataclasses.replace(jcfg, **cfg_kw), dataclasses.replace(pcfg, **cfg_kw)
    return jcfg, pcfg, {k: jnp.asarray(v) for k, v in lp_np.items()}, \
        params_from_numpy(lp_np, "cpu")


# ---------------------------------------------------------------------------
# routing

ROUTES = {
    "softmax": ({}, {}),
    "sigmoid": ({"expert_gating": "sigmoid"}, {}),
    "softmax_topk": ({"expert_gating": "softmax_topk"}, {}),
    "router_bias": ({}, {"router_bias": (4,)}),
    "w_router_b": ({}, {"w_router_b": (4,)}),
    "router_logits": ({}, {"router_logits": (6, 4)}),
    "no_renorm": ({"norm_topk_prob": False}, {}),
    "weights_scale": ({"expert_weights_scale": 2.5}, {}),
    "ties": ({}, {"router_logits": (6, 4)}),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_matches_jax(llama_moe, case):
    """The same expert ids, and weights within 1e-6, for each gating variant
    (`dataclasses.replace` on the config, extra tensors in the layer)."""
    cfg_kw, extra = ROUTES[case]
    jcfg, pcfg, lp = llama_moe
    rng = np.random.default_rng(2)
    lp = dict(lp, **{k: rng.standard_normal(s).astype(np.float32) for k, s in extra.items()})
    xt = rng.standard_normal((6, 64)).astype(np.float32)
    if case == "ties":  # experts 1 and 3 score alike for every token; 0 and 2 below
        r = lp["router_logits"]
        r[:, 3] = r[:, 1]
        r[:, 0] = r[:, 2] = r[:, 1] - 1.0
    jcfg, pcfg, jlp, tlp = _pair(jcfg, pcfg, lp, **cfg_kw)
    jidx, jw = jmoe.route(jcfg, jlp, jnp.asarray(xt))
    tidx, tw = tmoe.route(pcfg, tlp, torch.from_numpy(xt))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    if case == "ties":
        assert (tidx.numpy()[:, 0] == 1).all() and (tidx.numpy()[:, 1] == 3).all()


# ---------------------------------------------------------------------------
# the MoE FFN, dense and fused


def _gpt_oss(lp, rng):
    return {"arch": "gpt-oss"}, dict(
        lp, w_up_exps_b=rng.standard_normal((4, 64)) * 0.1,
        w_gate_exps_b=rng.standard_normal((4, 64)) * 0.1,
        w_down_exps_b=rng.standard_normal((4, 64)) * 0.1)


def _shared(lp, rng):
    return {}, dict(lp, w_up_shexp=rng.standard_normal((64, 48)) * 0.1,
                    w_gate_shexp=rng.standard_normal((64, 48)) * 0.1,
                    w_down_shexp=rng.standard_normal((48, 64)) * 0.1,
                    w_gate_inp_shexp=rng.standard_normal((64,)) * 0.1)


def _grove(lp, rng):
    return {"arch": "grovemoe", "n_group_experts": 2, "expert_group_scale": 0.5}, dict(
        lp, w_up_chexps=rng.standard_normal((2, 64, 32)) * 0.1,
        w_gate_chexps=rng.standard_normal((2, 64, 32)) * 0.1,
        w_down_chexps=rng.standard_normal((2, 32, 64)) * 0.1)


FFN_CASES = {
    "plain-dense": ("dense", None), "plain-pallas": ("pallas", None),
    "gpt_oss_biases-dense": ("dense", _gpt_oss), "gpt_oss_biases-pallas": ("pallas", _gpt_oss),
    "shared_expert-dense": ("dense", _shared), "shared_expert-pallas": ("pallas", _shared),
    "grovemoe_chunk_experts-dense": ("dense", _grove),
}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(llama_moe, case):
    """make_moe_ffn in the same mode on the same inputs: within 1e-5 of the
    output's scale. The fused mode's rows are views of the port's stacks
    (moe_layout) and its kernel the plain v1 here."""
    mode, extra = FFN_CASES[case]
    jcfg, pcfg, lp = llama_moe
    rng = np.random.default_rng(3)
    cfg_kw, lp = extra(lp, rng) if extra else ({}, lp)
    lp = {k: np.asarray(v, np.float32) for k, v in lp.items()}
    jcfg, pcfg, jlp, tlp = _pair(jcfg, pcfg, lp, **cfg_kw)
    if mode == "pallas":
        jlp, tlp = jmoe.moe_layout(jlp, jcfg, G), tmoe.moe_layout(tlp, pcfg, G)
        assert tlp["moe_up_rows"].data_ptr() == tlp["w_up_exps"].data_ptr()  # a view
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    want = np.asarray(jmoe.make_moe_ffn(jcfg, G, mode)(jlp, jnp.asarray(x)))
    got = tmoe.make_moe_ffn(pcfg, G, mode)(tlp, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_unknown_moe_modes_raise(llama_moe):
    _, pcfg, _ = llama_moe
    with pytest.raises(ValueError, match="moe mode"):
        tmoe.make_moe_ffn(pcfg, mode="sparse")
    with pytest.raises(ValueError, match="tiered MoE mode"):
        tmoe.make_tiered_moe_ffn(pcfg, None, None, mode="fetch")


# ---------------------------------------------------------------------------
# the loader and the forward


@pytest.mark.parametrize("name", ["llama_moe", "qwen3moe"])
def test_moe_config_matches_jax(ggufs, name):
    """The MoE hyperparameters and their GGUF keys (expert_count,
    expert_used_count, expert_feed_forward_length, expert_gating_func,
    expert_weights_norm) read as the JAX package reads them."""
    jc = jax_load(ggufs[name], dtype=jnp.float32).config
    pc = load_model(ggufs[name], dtype=torch.float32, device="cpu").config
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert (pc.n_expert, pc.n_expert_used) == ((4, 2) if name == "llama_moe" else (8, 3))
    assert pc.n_ff_exp == (0 if name == "llama_moe" else 32)
    assert pc.expert_gating == "softmax" and pc.norm_topk_prob


@pytest.mark.parametrize("name", ["llama_moe", "qwen3moe"])
def test_loader_matches_from_jax(ggufs, name):
    """The port's params equal from_jax of the JAX loader's, key for key, in
    the port's orientation: (X, Fe, E) for every expert stack."""
    jp = jax.tree.map(np.asarray, jax_load(ggufs[name], dtype=jnp.float32).params)
    want = params_from_numpy(jp, "cpu")
    got = load_model(ggufs[name], dtype=torch.float32, device="cpu").params
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k in ("tok_embd", "output", "output_norm_w"):
        assert torch.equal(got[k], want[k]), k
    for k, v in want["layers"].items():
        assert torch.equal(got["layers"][k], v), k
    lay = got["layers"]
    X, Fe = (4, 64) if name == "llama_moe" else (8, 32)
    for k in ("w_up_exps", "w_gate_exps", "w_down_exps"):
        assert lay[k].shape == (2, X, Fe, 64), k
    assert ("attn_q_norm_w" in lay) == (name == "qwen3moe")


def _logits_pair(jcfg, pcfg, jparams, tparams, toks, moe_mode="dense"):
    jl, _ = jax_forward(jcfg, moe_mode=moe_mode)(
        jparams, jnp.asarray([toks], jnp.int32), jnp.arange(len(toks), dtype=jnp.int32)[None],
        jax_cache(jcfg, 1, 16, jnp.float32))
    tl = make_forward(pcfg, moe_mode=moe_mode)(
        tparams, torch.tensor([toks]), torch.arange(len(toks))[None],
        init_cache(pcfg, 1, 16, torch.float32, "cpu"))
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("name", ["llama_moe", "qwen3moe"])
def test_forward_logits_match_jax(ggufs, name):
    """A prefill forward of each GGUF (qwen3moe's q/k norms before rope):
    logits within 1e-5 of their scale."""
    jm = jax_load(ggufs[name], dtype=jnp.float32)
    pm = load_model(ggufs[name], dtype=torch.float32, device="cpu")
    want, got = _logits_pair(jm.config, pm.config, jm.params, pm.params, [5, 9, 42, 7, 1])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_qwen3moe_head_dim_wider_than_e_over_h():
    """Qwen3-30B-A3B's shape: head_dim 2x E/H (q 64 -> 128 here), per-head
    q/k norms, neox rope over the whole head: logits within 1e-5."""
    rng = np.random.default_rng(5)
    kw = dict(arch="qwen3moe", n_layer=2, n_embd=64, n_head=4, n_head_kv=2, n_ff=32,
              n_vocab=97, head_dim=32, n_expert=8, n_expert_used=3, norm_eps=1e-6,
              rope_freq_base=1e6)
    jcfg, pcfg = JaxConfig(**kw), ModelConfig(**kw)

    def w(*s):
        return (rng.standard_normal(s) * 0.1).astype(np.float32)

    L, E = 2, 64
    layers = {"attn_norm_w": 1 + w(L, E), "ffn_norm_w": 1 + w(L, E), "wq": w(L, E, 128),
              "wk": w(L, E, 64), "wv": w(L, E, 64), "wo": w(L, 128, E),
              "attn_q_norm_w": 1 + w(L, 32), "attn_k_norm_w": 1 + w(L, 32),
              "w_router": w(L, E, 8), "w_up_exps": w(L, 8, E, 32),
              "w_gate_exps": w(L, 8, E, 32), "w_down_exps": w(L, 8, 32, E)}
    params = {"tok_embd": w(97, E), "output_norm_w": 1 + w(E), "output": w(E, 97),
              "layers": layers}
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    for mode in ("dense", "pallas"):
        jpm = dict(jp, layers=jmoe.moe_layout(jp["layers"], jcfg)) if mode == "pallas" else jp
        tpm = dict(tp, layers=tmoe.moe_layout(tp["layers"], pcfg)) if mode == "pallas" else tp
        want, got = _logits_pair(jcfg, pcfg, jpm, tpm, [3, 50, 8, 91], mode)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), mode


# ---------------------------------------------------------------------------
# the Engine, the Scheduler, the server


@pytest.mark.parametrize("mode", ["dense", "pallas"])
@pytest.mark.parametrize("name", ["llama_moe", "qwen3moe"])
def test_engine_streams_match_jax(ggufs, name, mode):
    """Engine(moe_mode=...) against the JAX Engine in the same mode: equal
    greedy streams; the model's own params keep their expert stacks."""
    je = JaxEngine(jax_load(ggufs[name], dtype=jnp.float32), max_seq=64,
                   sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32, moe_mode=mode)
    model = load_model(ggufs[name], dtype=torch.float32, device="cpu")
    pe = Engine(model, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                device="cpu", moe_mode=mode)
    assert pe.generate(PROMPT, 12) == je.generate(PROMPT, 12)
    assert ("moe_up_rows" in pe.params["layers"]) == (mode == "pallas")
    assert "w_up_exps" in model.params["layers"]


def test_engine_rejects_an_unknown_moe_mode(ggufs):
    model = load_model(ggufs["llama_moe"], dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="moe_mode"):
        Engine(model, device="cpu", moe_mode="fused")


@pytest.mark.parametrize("name", ["llama_moe", "qwen3moe"])
def test_scheduler_streams_match_jax(ggufs, name):
    """The Scheduler ticks a MoE model in dense mode, as the JAX one: three
    requests on one slot (one at a time: the JAX idle-slot fault would
    change a reused prefix), equal greedy streams."""
    prompts = [[3, 14, 15], [9, 26, 53, 58], [97, 93]]
    js = JaxScheduler(jax_load(ggufs[name], dtype=jnp.float32), n_slots=1, max_seq=64,
                      sampler=JaxSampler(temp=0.0), kv_dtype=jnp.float32)
    jreqs = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=6)) for p in prompts]
    js.run_until_idle()
    ps = Scheduler(load_model(ggufs[name], dtype=torch.float32, device="cpu"), n_slots=1,
                   max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                   device="cpu")
    preqs = [ps.submit(Request(prompt_tokens=p, max_new_tokens=6)) for p in prompts]
    ps.run_until_idle()
    assert [r.tokens() for r in preqs] == [r.tokens() for r in jreqs]


def test_server_completion_matches_jax(tmp_path):
    """A qwen3moe GGUF with a vocabulary behind both servers: one greedy
    completion, the same text and token counts."""
    import urllib.request

    from sparkinfer_tpu.server import ServerConfig as JaxServerConfig
    from sparkinfer_tpu.server import SparkServer as JaxServer
    from sparkinfer_tpu_torch.server import ServerConfig, SparkServer

    path = tmp_path / "qwen3moe-vocab.gguf"
    _qwen3moe(path, n_vocab=300, with_vocab=True)
    jsrv = JaxServer(jax_load(str(path), dtype=jnp.float32),
                     JaxServerConfig(port=0, n_slots=1, max_seq=64, kv_dtype="f32"),
                     sampler=JaxSampler(temp=0.0))
    tsrv = SparkServer(load_model(str(path), dtype=torch.float32, device="cpu"),
                       ServerConfig(port=0, n_slots=1, max_seq=64, kv_dtype="f32",
                                    device="cpu"), sampler=SamplerConfig(temp=0.0))
    body = json.dumps({"prompt": "hello world", "max_tokens": 8, "temperature": 0.0}).encode()
    outs = []
    try:
        for srv in (jsrv, tsrv):
            srv.serve(block=False)
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read().decode())
            outs.append((out["choices"][0]["text"], out["usage"]))
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert outs[1] == outs[0] and outs[0][1]["completion_tokens"] > 0
