"""Shared checks of tests/test_torch_archs.py and tests/test_torch_moe_archs.py:
tiny transformers checkpoints converted by the JAX package's
tools/convert_hf.py (f32), and the port held to the JAX package on one GGUF:
the loader key for key, the forward's logits, the Engine's greedy stream
(against the JAX forward's greedy decode) and the Scheduler's (against the
JAX Scheduler's). Imports JAX; the card's tests use tests/arch_fixture.py
instead."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from sparkinfer_tpu.models.loader import load_model as jax_load
from sparkinfer_tpu.models.transformer import make_forward as jax_forward
from sparkinfer_tpu.runtime.kv_cache import init_cache as jax_init_cache
from sparkinfer_tpu.runtime.sampling import SamplerConfig as JaxSampler
from sparkinfer_tpu.runtime.scheduler import Request as JaxRequest
from sparkinfer_tpu.runtime.scheduler import Scheduler as JaxScheduler
from sparkinfer_tpu.sparse.moe import moe_layout as jax_moe_layout
from sparkinfer_tpu.tools import convert_hf
from sparkinfer_tpu_torch.models.from_jax import params_from_numpy
from sparkinfer_tpu_torch.models.loader import load_model
from sparkinfer_tpu_torch.models.transformer import make_forward
from sparkinfer_tpu_torch.runtime.engine import Engine
from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler
from sparkinfer_tpu_torch.sparse.moe import moe_params

V = 160  # the transformers checkpoints' vocabulary (make_tiny_llama's is 199)
BASE = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(0, V, 9)]
N_NEW = 12
FWD_TOL = 1e-5  # of the logits' scale: f32 sums in other orders
HF_TOL = 2e-4  # against transformers' f32 forward


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _stack_head_norms(d, cfg):
    """StableLM's per-head q/k LayerNorms (q_layernorm.norms.{h}.weight) as
    one (n_heads, head_dim) tensor a layer, the GGUF's attn_q_norm shape."""
    from safetensors.numpy import load_file, save_file

    f = d / "model.safetensors"
    sd = load_file(str(f))
    for i in range(cfg.num_hidden_layers):
        for nm, n in (("q", cfg.num_attention_heads), ("k", cfg.num_key_value_heads)):
            pre = f"model.layers.{i}.self_attn.{nm}_layernorm"
            sd[pre + ".weight"] = np.stack([sd.pop(f"{pre}.norms.{h}.weight") for h in range(n)])
    save_file(sd, str(f), metadata={"format": "pt"})


# the JAX converter writes neither StableLM's per-head q/k LayerNorms nor
# OLMo's clip_qkv (llama.cpp's converter writes both); these family entries
# add them for the checkpoints below
def _stablelm_qk(fam):
    tmap = {f"model.layers.{{i}}.self_attn.{nm}_layernorm.weight":
            f"blk.{{i}}.attn_{nm}_norm.weight" for nm in "qk"}
    return dict(fam, tmap={**fam["tmap"], **tmap})


def _olmo_clip(fam):
    return dict(fam, kv=lambda w, a, c: w.add_kv(f"{a}.attention.clamp_kqv",
                                                 np.float32(c["clip_qkv"])))


def _init_skipping_no_bias(init):
    def f(self, module):
        if isinstance(module, torch.nn.LayerNorm) and module.bias is None:
            module.weight.data.fill_(1.0)
        else:
            init(self, module)
    return f


FAMILY_PATCHES = {"StableLmForCausalLM": _stablelm_qk, "OlmoForCausalLM": _olmo_clip}


def hf_gguf(d, name, cfg_cls, cls, kw, base=BASE, noise=("norm",), f32=False):
    """A tiny transformers checkpoint converted to an f32 GGUF: (path, the
    checkpoint's f32 logits of PROMPT). `base`: the config keywords under
    kw; the parameters whose names hold one of `noise` get N(0, 0.1) added
    (the norms, by default: away from their ones and zeros, so each
    counts). f32=True casts the model to f32 first (a class that keeps some
    parameters in bf16, as Apertus's xIELU)."""
    import transformers as T

    torch.manual_seed(0)
    cfg = getattr(T, cfg_cls)(**{**base, **kw})
    with pytest.MonkeyPatch.context() as mp:
        if cls == "StableLmForCausalLM":  # its init zeroes the bias its q/k norms lack
            mp.setattr(T.StableLmPreTrainedModel, "_init_weights", _init_skipping_no_bias(
                T.StableLmPreTrainedModel._init_weights))
        hf = getattr(T, cls)(cfg).eval()
    if f32:
        hf = hf.float()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if any(k in n for k in noise):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
        ref = hf(torch.tensor([PROMPT])).logits[0].numpy()
    hf.save_pretrained(str(d / name), safe_serialization=True)
    patch = FAMILY_PATCHES.get(cls) if name in ("stablelm-qk", "olmo") else None
    if name == "stablelm-qk":
        _stack_head_norms(d / name, cfg)
    path = str(d / f"{name}.gguf")
    with pytest.MonkeyPatch.context() as mp:
        if patch is not None:
            mp.setitem(convert_hf._FAMILIES, cls, patch(convert_hf._FAMILIES[cls]))
        convert_hf.convert(str(d / name), path, out_type="f32")
    return path, ref


def both(path):
    """(JAX model, port model) of one GGUF, f32."""
    return (jax_load(path, dtype=jnp.float32),
            load_model(path, dtype=torch.float32, device="cpu"))


def same_params(jm, pm):
    """The port's params equal from_jax of the JAX loader's, key for key and
    bit for bit."""
    want = params_from_numpy(jax.tree.map(np.asarray, jm.params), "cpu")
    got = pm.params
    assert set(got) == set(want), set(got) ^ set(want)
    assert set(got["layers"]) == set(want["layers"]), set(got["layers"]) ^ set(want["layers"])
    for k in set(got) - {"layers"}:
        assert torch.equal(got[k], want[k]), k
    for k, v in want["layers"].items():
        assert got["layers"][k].dtype == v.dtype and torch.equal(got["layers"][k], v), k
    return got["layers"]


def jax_reference(jm, mode="dense", toks=PROMPT, extra=(3, 7, 11), n_new=N_NEW):
    """The JAX forward's logits of a prefill of toks and of a decode step a
    token of `extra` (numpy: prefill (T, V), then each step's (V,)), and
    its greedy stream of n_new tokens from toks (the first from the
    prefill), f32. One jitted forward, so the prefill and the one-token
    step compile once and serve all three."""
    cfg, params = jm.config, jm.params
    if mode == "pallas":
        params = {**params, "layers": jax_moe_layout(params["layers"], cfg)}
    f = jax.jit(jax_forward(cfg, moe_mode=mode))

    def prefill():
        cache = jax_init_cache(cfg, 1, 32, jnp.float32)
        lg, cache = f(params, jnp.asarray([toks], jnp.int32),
                      jnp.arange(len(toks), dtype=jnp.int32)[None], cache)
        return np.asarray(lg)[0], cache

    def step(tok, pos, cache):
        lg, cache = f(params, jnp.asarray([[tok]], jnp.int32), jnp.asarray([[pos]], jnp.int32),
                      cache)
        return np.asarray(lg)[0, 0], cache

    logits, cache = prefill()
    out = [logits]
    for i, t in enumerate(extra):
        row, cache = step(t, len(toks) + i, cache)
        out.append(row)
    logits, cache = prefill()
    stream = [int(logits[-1].argmax())]
    while len(stream) < n_new:
        row, cache = step(stream[-1], len(toks) + len(stream) - 1, cache)
        stream.append(int(row.argmax()))
    return out, stream


def port_logits(pm, mode="dense", toks=PROMPT, extra=(3, 7, 11), fresh_prefill=True):
    """jax_reference's logits over the port's forward."""
    cfg = pm.config
    params = moe_params(pm.params, cfg) if mode == "pallas" else pm.params
    pre = make_forward(cfg, fresh_prefill=fresh_prefill, moe_mode=mode)
    dec = make_forward(cfg, moe_mode=mode)
    cache = init_cache(cfg, 1, 32, torch.float32, "cpu")
    with torch.inference_mode():
        out = [pre(params, torch.tensor([toks]), torch.arange(len(toks))[None], cache)[0]]
        for i, t in enumerate(extra):
            out.append(dec(params, torch.tensor([[t]]), torch.tensor([[len(toks) + i]]),
                           cache)[0, 0])
    return [o.numpy() for o in out]


def check_logits(got, want, tol=FWD_TOL):
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) <= tol, f"step {i}: {rel(g, w):.3e}"


def port_stream(pm, mode="dense", prompt=PROMPT, n_new=N_NEW):
    """The port Engine's greedy stream, f32, max_seq 64."""
    pe = Engine(pm, max_seq=64, sampler=SamplerConfig(temp=0.0), kv_dtype=torch.float32,
                device="cpu", moe_mode=mode)
    return pe.generate(prompt, n_new)


def scheduler_streams(jm, pm, prompts, n_new=8):
    """Greedy streams of the JAX and the port's Scheduler, 2 slots, f32:
    more requests than slots, so some queue."""
    js = JaxScheduler(jm, n_slots=2, max_seq=64, sampler=JaxSampler(temp=0.0),
                      kv_dtype=jnp.float32)
    jreqs = [js.submit(JaxRequest(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    js.run_until_idle()
    ps = Scheduler(pm, n_slots=2, max_seq=64, sampler=SamplerConfig(temp=0.0),
                   kv_dtype=torch.float32, device="cpu")
    preqs = [ps.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    ps.run_until_idle()
    return [r.tokens() for r in jreqs], [r.tokens() for r in preqs]
