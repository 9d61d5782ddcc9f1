"""Tiny GGUFs of the llama-shaped and MoE archs that have no transformers
class to convert, each with the tensors and keys of its own, written by
tests/model_fixtures.py:make_tiny_llama (E=64, 4 heads of 16, 2 KV heads,
2 layers; numpy draws from the seed; no JAX needed, so the card's tests
use it too).

  plain llama blocks under their own arch: smollm, tinyllama, internlm2,
  xverse, baichuan, exaone (NEOX rope);
  orion: LayerNorm with biases on every norm, the output norm's too;
  stablelm-heads: LayerNorm blocks with biases and per-head q/k LayerNorms
  with an (H, D) affine and biases (tests/test_torch_archs.py converts a
  transformers StableLM for the partial rope);
  stablelm-width: the same with full-width q/k LayerNorms (H*D) and biases;
  clamped: llama with attention.clamp_kqv 0.1 (most q/k/v entries clamp);
  hunyuan-dense: per-head q/k RMS norms, which the arch runs after rope;
  qwen2moe: qkv biases, 4 experts of 48 (2 used, no top-k renormalization),
  a shared expert of 64 with its sigmoid gate (ffn_gate_inp_shexp);
  hunyuan-moe: q/k norms after rope, experts, and an ungated shared expert;
  smallthinker: experts with the reglu activation, routed on the layer input;
  grovemoe: experts and two chunk experts (experts_per_group 2, group scale
  0.05) on the routed output;
  arctic: a dense FFN in the block (as wide as the experts, as Arctic's) and
  experts over ffn_norm_exps of the layer input as a parallel residual.

The GPT-family kinds (GPT_KINDS), for the archs without a transformers
class and for the card's tests:
  refact: llama blocks under ALiBi (no rope), 4 heads over 2 KV heads;
  jais: ALiBi, a fused [Q; K; V] with its bias (4 KV heads), LayerNorm with
  biases, output and FFN biases, the gated silu FFN;
  codeshell: the same fused QKV and biases with neox rope and gelu;
  qwen: a fused QKV with its bias, RMS norms, neox rope;
  bloom: ALiBi, the post-embedding LayerNorm (token_embd_norm), q/k/v,
  output, norm and FFN biases, gelu (an untied head: make_tiny_llama
  always writes one).
"""

import numpy as np

from model_fixtures import make_tiny_llama

E, H, HKV, D, FE, FS, X, K = 64, 4, 2, 16, 48, 64, 4, 2

PLAIN = ("smollm", "tinyllama", "internlm2", "xverse", "baichuan", "exaone")
KINDS = PLAIN + ("orion", "stablelm-heads", "stablelm-width", "clamped", "hunyuan-dense")
MOE_KINDS = ("qwen2moe", "hunyuan-moe", "smallthinker", "grovemoe", "arctic")
GPT_KINDS = ("refact", "jais", "codeshell", "qwen", "bloom")


def _spec(kind: str, rng) -> tuple[str, dict]:
    """(arch, make_tiny_llama keywords) of one fixture kind."""

    def w(*shape, s=0.08, shift=0.0):
        return (shift + s * rng.standard_normal(shape)).astype(np.float32)

    def per_layer(make):
        out = {}
        for i in range(2):
            out.update({f"blk.{i}.{k}": v for k, v in make().items()})
        return out

    if kind in PLAIN or kind == "refact":
        return kind, {}
    if kind in ("jais", "codeshell", "qwen", "bloom"):
        def layer():
            t = {} if kind == "qwen" else {
                "attn_norm.bias": w(E, s=0.1), "ffn_norm.bias": w(E, s=0.1),
                "attn_output.bias": w(E), "ffn_up.bias": w(96), "ffn_down.bias": w(E)}
            if kind == "bloom":
                t.update({"attn_q.bias": w(H * D), "attn_k.bias": w(H * D),
                          "attn_v.bias": w(H * D)})
            return t

        t = per_layer(layer)
        if kind != "qwen":
            t["output_norm.bias"] = w(E, s=0.1)
        if kind == "bloom":
            t.update({"token_embd_norm.weight": w(E, s=0.1, shift=1.0),
                      "token_embd_norm.bias": w(E, s=0.1)})
        return kind, dict(extra_tensors=t, n_head_kv=H, fused_qkv=kind != "bloom")
    if kind == "clamped":
        return "llama", dict(extra_kv={"llama.attention.clamp_kqv": np.float32(0.1)})
    if kind == "orion":
        t = per_layer(lambda: {"attn_norm.bias": w(E, s=0.1), "ffn_norm.bias": w(E, s=0.1)})
        t["output_norm.bias"] = w(E, s=0.1)
        return "orion", dict(extra_tensors=t)
    if kind.startswith("stablelm"):
        shape = {"stablelm-heads": ((H, D), (HKV, D)),
                 "stablelm-width": ((H * D,), (HKV * D,))}[kind]

        def layer():
            return {"attn_norm.bias": w(E, s=0.1), "ffn_norm.bias": w(E, s=0.1),
                    "attn_q_norm.weight": w(*shape[0], s=0.2, shift=1.0),
                    "attn_q_norm.bias": w(*shape[0], s=0.1),
                    "attn_k_norm.weight": w(*shape[1], s=0.2, shift=1.0),
                    "attn_k_norm.bias": w(*shape[1], s=0.1)}

        t = per_layer(layer)
        t["output_norm.bias"] = w(E, s=0.1)
        return "stablelm", dict(extra_tensors=t)
    if kind in ("hunyuan-dense", "hunyuan-moe"):
        def layer():
            t = {"attn_q_norm.weight": w(D, s=0.2, shift=1.0),
                 "attn_k_norm.weight": w(D, s=0.2, shift=1.0)}
            if kind == "hunyuan-moe":  # the always-on shared MLP, no gate scalar
                t.update({"ffn_up_shexp.weight": w(FS, E), "ffn_gate_shexp.weight": w(FS, E),
                          "ffn_down_shexp.weight": w(E, FS)})
            return t

        kw = dict(extra_tensors=per_layer(layer))
        if kind == "hunyuan-moe":
            kw.update(n_expert=X, n_expert_used=K, n_ff=FE)
        return kind, kw
    moe = dict(n_expert=X, n_expert_used=K, n_ff=FE)
    if kind == "qwen2moe":
        def layer():
            return {"attn_q.bias": w(H * D), "attn_k.bias": w(HKV * D), "attn_v.bias": w(HKV * D),
                    "ffn_up_shexp.weight": w(FS, E), "ffn_gate_shexp.weight": w(FS, E),
                    "ffn_down_shexp.weight": w(E, FS), "ffn_gate_inp_shexp.weight": w(1, E)}

        return "qwen2moe", dict(moe, extra_tensors=per_layer(layer),
                                extra_kv={"qwen2moe.expert_weights_norm": False})
    if kind == "smallthinker":
        return "smallthinker", moe
    if kind == "grovemoe":
        def layer():
            return {"ffn_up_chexps.weight": w(X // 2, FE, E), "ffn_gate_chexps.weight":
                    w(X // 2, FE, E), "ffn_down_chexps.weight": w(X // 2, E, FE)}

        return "grovemoe", dict(moe, extra_tensors=per_layer(layer), extra_kv={
            "grovemoe.experts_per_group": np.uint32(2),
            "grovemoe.expert_group_scale": np.float32(0.05)})
    if kind == "arctic":
        def layer():
            return {"ffn_norm_exps.weight": w(E, s=0.1, shift=1.0), "ffn_up.weight": w(FE, E),
                    "ffn_gate.weight": w(FE, E), "ffn_down.weight": w(E, FE)}

        return "arctic", dict(moe, extra_tensors=per_layer(layer))
    raise ValueError(kind)


def make_arch(path, kind: str, seed: int = 0, **kw) -> str:
    """Write the fixture `kind` to path; returns its GGUF arch."""
    arch, spec = _spec(kind, np.random.default_rng(1000 + seed))
    make_tiny_llama(path, arch=arch, seed=seed, **{**spec, **kw})
    return arch
