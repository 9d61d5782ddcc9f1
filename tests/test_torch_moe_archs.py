"""The MoE archs of the port against the JAX package, on the CPU: qwen2moe,
hunyuan-dense and hunyuan-moe (q/k norms after rope), smallthinker (routed
on the layer input), grovemoe (chunk experts) and arctic (a parallel MoE
residual beside the dense FFN), each MoE arch in moe_mode "dense" and
"pallas" (the v1 row kernel's plain version here).

qwen2moe (Qwen1.5-MoE's shape: qkv biases, no top-k renormalization, a
shared expert with its sigmoid gate) and the hunyuan pair are tiny
transformers checkpoints converted by the JAX package's tools/convert_hf.py
(tests/arch_checks.py); the rest, and a qwen2moe and a hunyuan-moe written
directly (the card's fixtures), come from tests/arch_fixture.py. f32
throughout. Tolerances: params equal bit for bit; logits within 1e-5 of
their scale; the Engine's greedy stream equal to the JAX forward's greedy
decode in the same moe_mode (one jitted JAX forward a model and mode serves
both, tests/arch_checks.py:jax_reference), the 2-slot Scheduler's to the
JAX Scheduler's; against transformers' own f32 forward, 2e-4.

Where the JAX package computes no model the port keeps its own answer: the
JAX fused mode leaves grovemoe's chunk experts out (its dense mode has
them), so the port's fused mode is held to the JAX dense mode; the JAX row
kernel has no reglu, so smallthinker's fused mode is refused by both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

import arch_checks as ac  # noqa: E402
from arch_fixture import MOE_KINDS, make_arch  # noqa: E402
from sparkinfer_tpu.sparse import moe as jmoe  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import (  # noqa: E402
    EXPERT_ONLY,
    check_supported,
    make_forward,
)
from sparkinfer_tpu_torch.sparse import moe as tmoe  # noqa: E402
from sparkinfer_tpu_torch.sparse.config import SparseConfig  # noqa: E402

MOE = dict(num_experts=4, num_experts_per_tok=2)
HF = {
    "qwen2moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM",
                 dict(MOE, moe_intermediate_size=48, shared_expert_intermediate_size=64,
                      decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=False)),
    "hunyuan-dense": ("HunYuanDenseV1Config", "HunYuanDenseV1ForCausalLM",
                      dict(head_dim=16, pad_token_id=0)),
    "hunyuan-moe": ("HunYuanMoEV1Config", "HunYuanMoEV1ForCausalLM",
                    dict(head_dim=16, num_experts=4, moe_topk=2, pad_token_id=0)),
}
OWN = tuple(f"{k}-own" for k in MOE_KINDS)
NAMES = tuple(HF) + OWN
MODES = [(n, m) for n in NAMES for m in ("dense", "pallas")
         if n != "hunyuan-dense" and not (n == "smallthinker-own" and m == "pallas")]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_archs")
    out = {name: ac.hf_gguf(d, name, *spec) for name, spec in HF.items()}
    for name in OWN:
        make_arch(d / f"{name}.gguf", name[:-len("-own")], seed=5)
        out[name] = (str(d / f"{name}.gguf"), None)
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
    """(name, mode) -> the JAX forward's logits and greedy stream, computed
    once."""
    got = {}

    def get(name, mode):
        if (name, mode) not in got:
            got[name, mode] = ac.jax_reference(models(name)[0], mode)
        return got[name, mode]

    return get


def test_check_supported_admits_the_moe_archs():
    cfg = dict(n_layer=2, n_embd=64, n_head=4, n_head_kv=2, n_ff=96, n_vocab=ac.V, head_dim=16)
    for arch in ("qwen2moe", "hunyuan-moe", "smallthinker", "grovemoe", "arctic"):
        assert arch in EXPERT_ONLY
        check_supported(ModelConfig(arch=arch, n_expert=4, n_expert_used=2, **cfg))
        with pytest.raises(NotImplementedError, match="without experts"):
            check_supported(ModelConfig(arch=arch, **cfg))
    check_supported(ModelConfig(arch="hunyuan-dense", **cfg))


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_jax(models, name):
    """Each arch's own tensors under the JAX loader's keys: qwen2moe's qkv
    biases and gated shared expert, hunyuan's q/k norms and ungated shared
    MLP, grovemoe's chunk experts (in the port's (X, Fe, E) orientation),
    arctic's dense FFN beside its experts and ffn_norm_exps."""
    jm, pm = models(name)
    lay = ac.same_params(jm, pm)
    want = {"qwen2moe": {"bq", "w_up_shexp", "w_gate_inp_shexp"},
            "qwen2moe-own": {"bq", "w_up_shexp", "w_gate_inp_shexp"},
            "hunyuan-dense": {"attn_q_norm_w", "w_up"},
            "hunyuan-moe": {"attn_q_norm_w", "w_gate_shexp"},
            "hunyuan-moe-own": {"attn_q_norm_w", "w_gate_shexp"},
            "grovemoe-own": {"w_up_chexps", "w_down_chexps"},
            "arctic-own": {"ffn_norm_exps_w", "w_up", "w_router"}}.get(name, {"w_router"})
    assert want <= set(lay), want - set(lay)
    if name.startswith("hunyuan-moe"):
        assert "w_gate_inp_shexp" not in lay
    if name.startswith("qwen2moe"):
        assert not pm.config.norm_topk_prob


@pytest.mark.parametrize("name,mode", MODES + [("hunyuan-dense", "dense")])
def test_forward_matches_jax(models, refs, name, mode):
    """A 9-token prefill and 3 decode steps within 1e-5 of the JAX forward's
    logits in the same moe_mode (grovemoe's fused mode: of the JAX dense
    mode's, the JAX fused mode having no chunk experts)."""
    pm = models(name)[1]
    want = refs(name, "dense" if name == "grovemoe-own" else mode)[0]
    ac.check_logits(ac.port_logits(pm, mode), want)


@pytest.mark.parametrize("name", tuple(HF))
def test_logits_match_transformers(ggufs, models, name):
    _, pm = models(name)
    for mode in ("dense",) if name == "hunyuan-dense" else ("dense", "pallas"):
        got = ac.port_logits(pm, mode, extra=())[0]
        assert ac.rel(got, ggufs[name][1]) <= ac.HF_TOL, (mode, ac.rel(got, ggufs[name][1]))


@pytest.mark.parametrize("name,mode", [m for m in MODES if m[0] != "grovemoe-own"]
                         + [("hunyuan-dense", "dense"), ("grovemoe-own", "dense")])
def test_engine_stream_matches_jax(models, refs, name, mode):
    assert ac.port_stream(models(name)[1], mode) == refs(name, mode)[1]


def test_grovemoe_fused_mode_keeps_the_chunk_experts(models, refs):
    """The port's fused mode runs the chunk experts through a second row
    kernel call: its stream equals the JAX dense mode's greedy decode, and
    the JAX fused mode (no chunk experts) is off the JAX dense mode's
    logits."""
    (dense, stream), (fused, _) = refs("grovemoe-own", "dense"), refs("grovemoe-own", "pallas")
    assert ac.rel(fused[0], dense[0]) > 10 * ac.FWD_TOL
    assert ac.port_stream(models("grovemoe-own")[1], "pallas") == stream


def test_smallthinker_fused_mode_is_refused(models):
    """The fused mode of smallthinker's reglu experts is refused by the port,
    by name, as the JAX row kernel refuses reglu (its dense mode routes on
    the layer's input, as test_forward_matches_jax holds)."""
    jm, pm = models("smallthinker-own")
    assert pm.config.traits.moe_router_on_input and pm.config.traits.act == "reglu"
    with pytest.raises(NotImplementedError, match="reglu"):
        make_forward(pm.config, moe_mode="pallas")
    with pytest.raises(ValueError, match="reglu"):
        ac.jax_reference(jm, "pallas")


@pytest.mark.parametrize("name", ["qwen2moe", "hunyuan-moe"])
def test_moe_layer_matches_jax(models, name):
    """One layer's MoE FFN (routing without top-k renormalization for
    qwen2moe; the shared expert, gated by its sigmoid scalar for qwen2moe,
    ungated for hunyuan) in both modes, and route()'s experts and weights,
    against the JAX package's on the same 7 inputs."""
    jm, pm = models(name)
    cfg, jcfg = pm.config, jm.config
    jlp = {k: v[1] for k, v in jm.params["layers"].items()}
    tlp = {k: v[1] for k, v in pm.params["layers"].items()}
    x = np.random.default_rng(3).standard_normal((1, 7, cfg.n_embd)).astype(np.float32)
    ji, jw = jmoe.route(jcfg, jlp, jnp.asarray(x[0]))
    ti, tw = tmoe.route(cfg, tlp, torch.from_numpy(x[0]))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    if name == "qwen2moe":  # Qwen1.5-MoE's weights are softmax mass, not renormalized
        assert float(tw.sum(-1).max()) < 0.999
    for mode in ("dense", "pallas"):
        jl = jmoe.moe_layout(jlp, jcfg) if mode == "pallas" else jlp
        tl = tmoe.moe_layout(tlp, cfg) if mode == "pallas" else tlp
        want = np.asarray(jmoe.make_moe_ffn(jcfg, mode=mode)(jl, jnp.asarray(x)))
        got = tmoe.make_moe_ffn(cfg, mode=mode)(tl, torch.from_numpy(x)).numpy()
        assert ac.rel(got, want) <= ac.FWD_TOL, (mode, ac.rel(got, want))


def test_scheduler_streams_match_jax(models):
    """qwen2moe on 2 slots (the Scheduler ticks MoE models in dense mode),
    three requests: the JAX Scheduler's streams."""
    jm, pm = models("qwen2moe")
    prompts = [ac.PROMPT, ac.PROMPT[3:8], [5, 6, 7, 8, 9, 10]]
    want, got = ac.scheduler_streams(jm, pm, prompts)
    assert got == want


@pytest.mark.parametrize("name,match", [("arctic-own", "arctic's parallel MoE"),
                                        ("grovemoe-own", "chunk experts")])
def test_expert_tiering_refuses_what_jax_computes_wrong(models, name, match):
    """The JAX package's tiered MoE FFN runs arctic's MoE in place of its
    dense FFN and drops grovemoe's chunk experts: the port refuses both,
    and any FFN of its own over arctic's block."""
    _, pm = models(name)
    with pytest.raises(NotImplementedError, match=match):
        tmoe.make_tiered_moe_ffn(pm.config, SparseConfig(group_size=16, hot_groups=4), None)
    if name == "arctic-own":
        with pytest.raises(NotImplementedError, match="parallel MoE"):
            make_forward(pm.config, ffn_fn=lambda lp, x: x)
