"""The last MLA archs in the port against the JAX package, on the CPU:
minicpm3 (multi-head latent attention through the q-lora, neox rope, a
gated silu FFN, the embedding, residual and logit multipliers) and plm (a
direct q projection, an ungated relu² FFN), both over the latent cache with
no experts, so their layers load as one run.

Direct GGUFs of tests/deepseek2_fixture.py:make_mla_arch, as the JAX
package's own test writes them (tests/test_convert_families.py:
test_mla_arch_smoke): 2 layers, E=64, 4 heads, R=32, Dr=8, Dn=16, Dv=16,
F=96. "minicpm3" carries MiniCPM3's multipliers as GGUF keys and the
rope_factors_long/short tensors of llama.cpp's converter, which both
loaders leave unread. f32. Tolerances: params equal key for key, bit for
bit; prefill logits and 8 decode steps within 1e-5 of their scale; greedy
streams of the Engine and the 2-slot Scheduler equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepseek2_fixture import make_mla_arch  # noqa: E402
from test_torch_mla import PROMPT, _close, _jax_steps, _port_steps, _same  # noqa: E402
from sparkinfer_tpu.models.loader import load_model as jax_load  # noqa: E402
from sparkinfer_tpu.runtime.engine import Engine as JaxEngine  # noqa: E402
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest  # noqa: E402
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler  # noqa: E402
from sparkinfer_tpu_torch.models.config import ModelConfig  # noqa: E402
from sparkinfer_tpu_torch.models.loader import load_model  # noqa: E402
from sparkinfer_tpu_torch.models.transformer import (  # noqa: E402
    MLA_ARCHS,
    check_supported,
    rope_params,
)
from sparkinfer_tpu_torch.runtime.engine import Engine  # noqa: E402
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig  # noqa: E402
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler  # noqa: E402

GREEDY = dict(temp=0.0)
VARIANTS = {"minicpm3": dict(arch="minicpm3", scales=True, rope_factors=True),
            "minicpm3-plain": dict(arch="minicpm3"), "plm": dict(arch="plm")}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mla_archs")
    out = {}
    for i, (name, kw) in enumerate(VARIANTS.items()):
        out[name] = str(d / f"{name}.gguf")
        make_mla_arch(out[name], seed=11 + i, **kw)
    return out


@pytest.fixture(scope="module")
def models(ggufs):
    return {name: (jax_load(p, dtype=jnp.float32), load_model(p, dtype=torch.float32,
                                                              device="cpu"))
            for name, p in ggufs.items()}


def test_check_supported_admits_minicpm3_and_plm():
    for arch in ("minicpm3", "plm"):
        assert arch in MLA_ARCHS
        check_supported(ModelConfig(arch=arch, n_layer=2, n_embd=64, n_head=4, n_head_kv=4,
                                    n_ff=96, n_vocab=160, head_dim=24, rope_dim=8,
                                    kv_lora_rank=32, v_head_dim=16))
    with pytest.raises(NotImplementedError, match="MLA"):
        check_supported(ModelConfig(arch="mistral", n_layer=2, n_embd=64, n_head=4,
                                    n_head_kv=4, n_ff=96, n_vocab=160, head_dim=24,
                                    rope_dim=8, kv_lora_rank=32))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loader_matches_jax(models, name):
    """Every tensor under the JAX loader's key, bit for bit, one run of
    layers (no segments); the q-lora for minicpm3, a direct q for plm, no
    gate for plm; the multipliers read as the JAX config reads them; the
    rope_factors tensors left unread by both; neox rope."""
    jm, pm = models[name]
    params = jax.tree.map(np.asarray, jm.params)
    _same(pm.params, params)
    lay = pm.params["layers"]
    assert "layer_segments" not in pm.params or not pm.params["layer_segments"]
    assert ("wq_a" in lay) == name.startswith("minicpm3") and ("wq" in lay) == (name == "plm")
    assert ("w_gate" in lay) == (name != "plm")
    cfg, jcfg = pm.config, jm.config
    for key in ("embd_scale", "residual_scale", "logit_scale", "q_lora_rank", "kv_lora_rank"):
        assert getattr(cfg, key) == getattr(jcfg, key), key
    if name == "minicpm3":
        assert cfg.embd_scale == 12.0 and cfg.logit_scale == 4.0
        assert cfg.residual_scale == pytest.approx(1.4 / 2 ** 0.5)
    assert not any("rope_factors" in k for k in pm.params)
    assert rope_params(cfg).mode == "neox"


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(models, name):
    """A prefill and 8 greedy decode steps over the latent cache: logits
    within 1e-5 of the JAX forward's scale."""
    jm, pm = models[name]
    ref, toks = _jax_steps(jm)
    got = _port_steps(pm.config, pm.params, toks)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_engine_stream_matches_jax(models, name):
    jm, pm = models[name]
    je = JaxEngine(jm, max_seq=64, sampler=JaxSampler(**GREEDY), kv_dtype=jnp.float32)
    pe = Engine(pm, max_seq=64, sampler=SamplerConfig(**GREEDY), kv_dtype=torch.float32,
                device="cpu")
    got = pe.generate(PROMPT, 16)
    assert got == je.generate(PROMPT, 16) and len(got) == 16
    assert pe.cache.v.shape[-1] == 0  # the latent cache


def test_scheduler_streams_match_jax(models):
    """A 2-slot Scheduler over plm's latent cache against the JAX
    Scheduler: two requests at once, equal greedy streams."""
    jm, pm = models["plm"]
    prompts = [[3, 14, 15, 92], [9, 26, 53]]
    js = JaxScheduler(jm, n_slots=2, max_seq=64, sampler=JaxSampler(**GREEDY),
                      kv_dtype=jnp.float32)
    jreqs = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=8)) for p in prompts]
    js.run_until_idle()
    ps = Scheduler(pm, n_slots=2, max_seq=64, sampler=SamplerConfig(**GREEDY),
                   kv_dtype=torch.float32, device="cpu")
    preqs = [ps.submit(Request(prompt_tokens=p, max_new_tokens=8)) for p in prompts]
    ps.run_until_idle()
    got = [r.tokens() for r in preqs]
    assert got == [r.tokens() for r in jreqs] and all(len(g) == 8 for g in got)
