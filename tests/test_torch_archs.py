"""The llama-shaped archs in the port against the JAX package, on the CPU:
qwen3, smollm, tinyllama, internlm2, xverse, baichuan, exaone, ernie4_5,
seed_oss, smollm3, glm4, orion, stablelm, olmo, arcee and nemotron.

Where transformers has the class (qwen3, stablelm with partial rope and with
its per-head q/k LayerNorms, glm4 with post-norms, partial rope and qkv
biases, olmo with clip_qkv, ernie4_5, seed_oss with qkv biases, smollm3 with
its NoPE layers, arcee's ungated relu², nemotron's LayerNorm with biases,
partial rope and relu²), a tiny checkpoint converted by the JAX package's
tools/convert_hf.py (tests/arch_checks.py); the others from
tests/arch_fixture.py (make_tiny_llama with each arch's own tensors and
keys: orion's LayerNorm biases, stablelm's q/k LayerNorms with biases,
per head with an (H, D) affine and over the full width). f32 throughout.
Tolerances: params equal bit for bit; prefill and decode logits within 1e-5
of their scale (f32 sums in other orders); the Engine's greedy stream equal
to the JAX forward's greedy decode (one jitted JAX forward a model serves
both, tests/arch_checks.py:jax_reference), the 2-slot Scheduler's to the
JAX Scheduler's; against transformers' own f32 forward, 2e-4.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("transformers")

import arch_checks as ac  # noqa: E402
from arch_fixture import KINDS as FIXTURE_KINDS  # noqa: E402
from arch_fixture import make_arch  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import LLAMA_SHAPED, check_supported  # noqa: E402

HF = {  # name -> (config class, model class, config keywords)
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(head_dim=16)),
    "stablelm": ("StableLmConfig", "StableLmForCausalLM", dict(partial_rotary_factor=0.25)),
    # StableLM-2-1.6B's qkv biases and per-head q/k LayerNorms (H, D)
    "stablelm-qk": ("StableLmConfig", "StableLmForCausalLM",
                    dict(partial_rotary_factor=0.25, use_qkv_bias=True, qk_layernorm=True)),
    "glm4": ("Glm4Config", "Glm4ForCausalLM",
             dict(head_dim=16, partial_rotary_factor=0.5, attention_bias=True, pad_token_id=0)),
    # a clip that binds: most q/k/v entries of this checkpoint exceed it
    "olmo": ("OlmoConfig", "OlmoForCausalLM", dict(clip_qkv=0.1)),
    "ernie4_5": ("Ernie4_5Config", "Ernie4_5ForCausalLM", {}),
    "seed_oss": ("SeedOssConfig", "SeedOssForCausalLM", dict(head_dim=16, attention_bias=True)),
    "smollm3": ("SmolLM3Config", "SmolLM3ForCausalLM", dict(num_hidden_layers=4, pad_token_id=0)),
    # the ungated relu² FFN (AFM)
    "arcee": ("ArceeConfig", "ArceeForCausalLM", dict(head_dim=16)),
    # LayerNorm with biases (weights stored as w - 1), partial rope, relu²
    "nemotron": ("NemotronConfig", "NemotronForCausalLM",
                 dict(head_dim=16, partial_rotary_factor=0.5, norm_eps=1e-5)),
}
OWN = tuple(k for k in FIXTURE_KINDS if k not in ("clamped", "hunyuan-dense"))
NAMES = tuple(HF) + OWN


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """name -> (GGUF path, transformers' logits of the prompt or None)."""
    d = tmp_path_factory.mktemp("archs")
    out = {name: ac.hf_gguf(d, name, *spec) for name, spec in HF.items()}
    for kind in OWN:
        make_arch(d / f"{kind}.gguf", kind, seed=3)
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


def test_check_supported_admits_the_llama_shaped_archs():
    for arch in LLAMA_SHAPED:
        check_supported(ModelConfig(arch=arch, n_layer=2, n_embd=64, n_head=4, n_head_kv=2,
                                    n_ff=96, n_vocab=ac.V, head_dim=16))
    assert {"qwen3", "smollm", "tinyllama", "internlm2", "xverse", "baichuan", "exaone",
            "ernie4_5", "seed_oss", "smollm3", "glm4", "orion", "stablelm",
            "olmo", "arcee", "nemotron"} <= set(LLAMA_SHAPED)


@pytest.mark.parametrize("name", NAMES)
def test_loader_matches_jax(models, name):
    """Every arch's own tensors load under the JAX loader's keys: qwen3's q/k
    norms, glm4's post-norms, stablelm's LayerNorm biases and q/k LayerNorms
    (with biases, (H, D) or full width), orion's norm biases, olmo's all-ones
    norms, seed_oss's and glm4's qkv biases."""
    jm, pm = models(name)
    lay = ac.same_params(jm, pm)
    assert pm.config.arch == jm.config.arch
    want = {"qwen3": {"attn_q_norm_w"}, "glm4": {"attn_post_norm_w", "ffn_post_norm_w", "bq"},
            "stablelm": {"attn_norm_b", "ffn_norm_b"},
            "stablelm-qk": {"attn_q_norm_w", "attn_k_norm_w", "bq"},
            "stablelm-heads": {"attn_q_norm_b", "attn_k_norm_b"},
            "stablelm-width": {"attn_q_norm_b", "attn_k_norm_b"}, "seed_oss": {"bq", "bk"},
            "orion": {"attn_norm_b", "ffn_norm_b"},
            "nemotron": {"attn_norm_b", "ffn_norm_b"}}.get(name, set())
    assert want <= set(lay), want - set(lay)
    if name in ("stablelm-qk", "stablelm-heads"):
        assert lay["attn_q_norm_w"].shape == (2, 4, 16) and lay["attn_k_norm_w"].shape == (2, 2, 16)
    if name == "olmo":
        assert all(bool((lay[k] == 1).all()) for k in ("attn_norm_w", "ffn_norm_w"))
        assert pm.config.clamp_kqv == pytest.approx(0.1)
    if name in ("stablelm", "stablelm-qk", "glm4", "nemotron"):
        assert pm.config.rope_dim < pm.config.head_dim
    if name in ("arcee", "nemotron"):  # ungated relu²
        assert "w_gate" not in lay and pm.config.traits.act == "relu2"


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(models, refs, name):
    """A 9-token prefill and 3 decode steps: logits within 1e-5 of the JAX
    forward's scale, both over the cache (the chunk path's prefill too)."""
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
    """glm4 (post-norms, partial rope, qkv biases) on 2 slots, three
    requests: the JAX Scheduler's streams."""
    jm, pm = models("glm4")
    prompts = [ac.PROMPT, ac.PROMPT[2:6], [7, 8, 9, 10, 11, 12, 13]]
    want, got = ac.scheduler_streams(jm, pm, prompts)
    assert got == want
