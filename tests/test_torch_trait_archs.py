"""The trait archs of ROADMAP 15g in the port against the JAX package, on
the CPU: granite, minicpm, pangu-embedded, plamo, starcoder2, command-r and
phi3, decoders that differ from llama only in traits the port has.

Where transformers has the class and the JAX converter maps it (Cohere as
command-r, Granite, Phi3 with its fused qkv and gate/up split by the
converter, Starcoder2), a tiny checkpoint converted by the JAX package's
tools/convert_hf.py (tests/arch_checks.py); every arch also from
tests/arch_fixture.py (make_tiny_llama with its own tensors and keys: the
fault-7 multipliers of granite and minicpm, pangu-embedded's q/k/v and
output biases, plamo's and command-r's parallel blocks, starcoder2's
LayerNorm and FFN biases). f32 throughout. Tolerances as
tests/test_torch_archs.py: params equal bit for bit; prefill and decode
logits within 1e-5 of their scale; the Engine's greedy stream equal to the
JAX forward's greedy decode; against transformers' own f32 forward, 2e-4.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("transformers")

import arch_checks as ac  # noqa: E402
from arch_fixture import TRAIT_KINDS, make_arch  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import TRAIT_ARCHS, check_supported  # noqa: E402

HF = {  # name -> (config class, model class, config keywords)
    # Cohere's bias-less LayerNorm, parallel block, unpermuted NORM rope, logit_scale
    "command-r-hf": ("CohereConfig", "CohereForCausalLM", dict(logit_scale=0.0625)),
    # the fault-7 multipliers
    "granite-hf": ("GraniteConfig", "GraniteForCausalLM",
                   dict(embedding_multiplier=12.0, residual_multiplier=0.22,
                        attention_multiplier=0.015625, logits_scaling=8.0)),
    # a fused qkv_proj and gate_up_proj, which the JAX converter splits
    "phi3-hf": ("Phi3Config", "Phi3ForCausalLM", dict(pad_token_id=0)),
    # LayerNorm with biases, qkv, output and FFN biases, the ungated gelu
    "starcoder2-hf": ("Starcoder2Config", "Starcoder2ForCausalLM",
                      dict(use_bias=True, norm_epsilon=1e-5)),
}
NAMES = tuple(HF) + TRAIT_KINDS


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """name -> (GGUF path, transformers' logits of the prompt or None)."""
    d = tmp_path_factory.mktemp("trait_archs")
    out = {name: ac.hf_gguf(d, name, *spec, noise=("norm", "bias")) for name, spec in HF.items()}
    for kind in TRAIT_KINDS:
        make_arch(d / f"{kind}.gguf", kind, seed=5)
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
    """name -> the JAX forward's logits and greedy stream, computed once."""
    got = {}

    def get(name):
        if name not in got:
            got[name] = ac.jax_reference(models(name)[0])
        return got[name]

    return get


def test_check_supported_admits_the_trait_archs():
    assert set(TRAIT_ARCHS) == {"granite", "minicpm", "pangu-embedded", "plamo",
                                "starcoder2", "command-r", "phi3"} == set(TRAIT_KINDS)
    for arch in TRAIT_ARCHS:
        check_supported(ModelConfig(arch=arch, n_layer=2, n_embd=64, n_head=4, n_head_kv=2,
                                    n_ff=96, n_vocab=ac.V, head_dim=16))


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_jax(models, name):
    """Each arch's tensors and keys load as the JAX loader's: the
    multipliers, the biases, the parallel blocks' norms and phi3's split
    projections."""
    jm, pm = models(name)
    lay = ac.same_params(jm, pm)
    arch = pm.config.arch
    assert arch == jm.config.arch == name.removesuffix("-hf")
    if arch in ("granite", "minicpm"):
        assert pm.config.embd_scale == pytest.approx(12.0)
        assert pm.config.residual_scale != 1.0 and pm.config.logit_scale != 1.0
    if arch == "granite":
        assert pm.config.attn_scale == pytest.approx(0.015625)
    if arch == "command-r":
        assert pm.config.logit_scale == pytest.approx(0.0625) and "attn_norm_b" not in lay
    if arch in ("pangu-embedded", "starcoder2"):
        assert {"bq", "bk", "bv", "bo"} <= set(lay)
    if arch == "starcoder2":
        assert {"attn_norm_b", "ffn_norm_b", "b_up", "b_down"} <= set(lay)
    if name == "phi3-hf":  # the converter's split of qkv_proj and gate_up_proj
        assert lay["wq"].shape == (2, 64, 64) and lay["wk"].shape == (2, 64, 32)
        assert lay["w_gate"].shape == lay["w_up"].shape == (2, 64, 96)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(models, refs, name):
    """A 9-token prefill and 3 decode steps: logits within 1e-5 of the JAX
    forward's scale, over the chunk path and over the cache."""
    pm = models(name)[1]
    want = refs(name)[0]
    ac.check_logits(ac.port_logits(pm), want)
    ac.check_logits(ac.port_logits(pm, fresh_prefill=False), want)


@pytest.mark.parametrize("name", tuple(HF))
def test_logits_match_transformers(ggufs, models, name):
    """The port's prefill logits against transformers' own forward of the
    checkpoint the GGUF was converted from."""
    _, pm = models(name)
    got = ac.port_logits(pm, extra=())[0]
    assert ac.rel(got, ggufs[name][1]) <= ac.HF_TOL, ac.rel(got, ggufs[name][1])


@pytest.mark.parametrize("name", NAMES)
def test_engine_stream_matches_jax(models, refs, name):
    assert ac.port_stream(models(name)[1]) == refs(name)[1]


def test_scheduler_streams_match_jax(models):
    """command-r (a parallel block under one LayerNorm, logit_scale) on 2
    slots, three requests: the JAX Scheduler's streams."""
    jm, pm = models("command-r")
    prompts = [ac.PROMPT, ac.PROMPT[2:6], [7, 8, 9, 10, 11, 12, 13]]
    want, got = ac.scheduler_streams(jm, pm, prompts)
    assert got == want
