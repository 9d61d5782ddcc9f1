"""Transformer forward, the port of sparkinfer_tpu/models/transformer.py:
make_forward for the llama family and the llama-shaped archs that differ
from it only in traits and tensors (qwen3, smollm, tinyllama, internlm2,
xverse, baichuan, exaone, ernie4_5, seed_oss, smollm3, glm4, orion,
stablelm, olmo, hunyuan-dense, arcee, nemotron), the other sparse families
of the paper (qwen2, opt, falcon), the GPT family (gpt2, starcoder,
codeshell, jais, refact, qwen, phi2, gptneox, bloom, mpt, gptj), the
feature archs (olmo2, olmo3, apertus, bitnet, deci, openelm, chameleon,
qwen2vl, qwen3vl), the trait archs (granite, minicpm, pangu-embedded,
plamo, starcoder2, command-r, phi3), the gemma family, the MLA archs
(deepseek2, minicpm3, plm), the non-causal encoders (bert, neo-bert,
gemma-embedding), and the Mixture-of-Experts FFN of llama-MoE (mixtral),
qwen3moe, qwen2moe, hunyuan-moe, smallthinker, grovemoe, arctic and
gpt-oss.

The block follows the arch's traits as the JAX body does: RMS or LayerNorm
(`_norm`, with the norm biases of the "ln" archs, the output norm's too),
OPT's learned positions (params["pos_embd"] at positions + pos_embd_offset,
added to the token embeddings; rope mode "none"), and falcon's parallel
block `x = x + attn(h) + ffn(h2)`, where h2 is attn_norm_2(x) when the
layer has that second norm (Falcon-40B's new decoder architecture) and h
otherwise (Falcon-7B). Biases on q/k/v, the output projection and the FFN
are added where the params carry them; q, k and v are then clamped to
[-clamp_kqv, clamp_kqv] where the model sets it (olmo's, dbrx's clip_qkv).

q/k norms (`_qk_norms`, attn_q_norm / attn_k_norm) take the arch's q/k norm
kind (its body norm unless it names another) and their biases where the
params carry them: per head when the weight is head_dim wide (qwen3,
gemma3, hunyuan), over the full width otherwise, and as an (H, D) affine
over stats of each head (stablelm's per-head LayerNorm). They
run before rope, or after it where the arch says so (hunyuan). Partial rope
(rope_dim < head_dim: stablelm, glm4) rotates the leading rope_dim lanes of
each head and keeps the rest (ops/rope.py).

A plain Python loop over layers takes the place of `lax.scan`; the KV cache
is written in place. The FFN is pluggable as in the JAX package:
`ffn_fn(lp, x) -> y`, or with `ffn_carry_init` the cross-layer carry form
`ffn_fn(lp, x, carry, il) -> (y, carry)` that the pipelined sparse FFN uses
(its selection for layer il+1 is computed at layer il), or with
`stateful_ffn=True` the form `ffn_fn(lp, x, fstate, il) -> y` whose state
lives across forwards (the tiered FFN's DFR statistics, a profiler's
counts): the forward takes it as a fifth argument and the FFN updates it in
place, where the JAX forward threads it through its scan and returns it.
A control vector (`layers["cvec"]`, models/lora.py) is added to the residual
stream after each layer, as in the JAX forward.

Every projection goes through `quant_linear` (the JAX `mm`), so packed
Q4_0/Q8_0 weights (QuantTensor, FlatQuantTensor) run the quant_matmul
kernels, row-wise W8A8 weights (W8A8Tensor, `attn_w8a8` at load) the int8
product, and plain tensors a plain matmul. W8A8 wq, wk and wv quantize
their shared input once a layer (the JAX package quantizes it three times,
to the same bits); a W8A8 head gives f32 logits.

A model with experts (cfg.n_expert > 0) and no `ffn_fn` runs the MoE FFN of
`sparse/moe.py` at every layer that carries a router (`w_router`), the dense
FFN at any other, in `moe_mode` "dense" (plain torch over the gathered expert
weights) or "pallas" (the v1 row kernel, `ops/sparse_ffn.py`, with the router
weights as its scale mask), as the JAX forward dispatches them. Two MoE
bodies differ: arctic keeps the dense FFN in the block and adds
`moe(ffn_norm_exps(x_in))` of the layer's input x_in as a parallel
residual; smallthinker routes on the raw layer input (`router_logits`, set
before attention), as the JAX forward does.

Attention is plain torch (matmul, mask, softmax), as the JAX CPU path
computes it; the JAX package's TPU prefill uses JAX's library flash
attention, which is no kernel of this repository and has no port here.

Sliding windows (gpt-oss, the gemma family, windowed mistral): a layer of
cfg.swa_layers masks keys more than sliding_window positions back, and
gemma3's sliding layers rope at their own base, unscaled
(rope_freq_base_swa). Over an iSWA cache (`runtime/kv_cache.py`) the
forward walks the runs of the dual cache: a sliding run writes its ring at
positions % ring and rebuilds each slot's absolute position from the
step's newest position, on the device, for the mask. gpt-oss's attention
sinks join the softmax as one more logit a head that carries no value;
gemma2 caps the attention logits (before the mask) and the final logits
with cap * tanh(x / cap); the gemma family scales the embeddings by
sqrt(n_embd) and wraps attention and FFN in sandwich post-norms
(attn_post_norm, ffn_post_norm; glm4 carries the same two).

Model-level multipliers, as the JAX forward applies them to every arch:
cfg.embd_scale on the embeddings (after gemma's sqrt scale, before learned
positions), cfg.residual_scale on the attention output after its post-norm
and, in a sequential block, on the FFN output after its post-norm (falcon's
parallel block scales the attention output only, as JAX does),
cfg.logit_scale on the f32 logits before the final softcap, each a scalar
rounded to the tensor's dtype; the layers flagged in cfg.nope_layers skip
rope on q and k (a Python branch a layer, fixed in a CUDA graph).

deepseek2 (DeepSeek-V2, V2-Lite, V3), minicpm3 (the q-lora, neox rope) and
plm (a direct q, an ungated relu² FFN): multi-head latent attention in the
absorbed form of the JAX package (`attention_mla`: q direct or through the
q-lora, the key decompressor folded into q, scores and context in the
latent space) over the latent cache of `runtime/kv_cache.py` (one slot of
kv_lora_rank + rope_dim a token, a zero-width v), and the JAX loader's
layer segments: params["layer_segments"], the leading dense layers and the
MoE layers as stacks of their own, walked in order (`layer_params`).

The GPT-family archs (gpt2, starcoder, codeshell, jais, refact, qwen,
phi2, gptneox, bloom, mpt, gptj) run on the same block: fused QKV split at
load, learned positions, LayerNorm with biases, the parallel block and
partial rope. ALiBi (bloom, mpt, jais, refact) adds slope * (slot - query
position) to the f32 scores after the softcap and before the mask, the
slopes of `alibi_slopes` in an (Hkv, g) tensor built once per device at
the forward's first call (eager: a CUDA graph's warm-up), so that no step
copies host data; a fresh prefill then reads the cache, as in the JAX
forward, which takes the chunk path only without ALiBi. bloom's
post-embedding LayerNorm (tok_norm_w, tok_norm_b) follows the learned
positions, and the head bias of gptj and phi2 (output_b, f32) joins the f32
logits before logit_scale. ALiBi over an iSWA ring raises ValueError: the
JAX ring branch computes no ALiBi term.

The feature archs: a layer runs its pre-norms only where it has them
(olmo2's and olmo3's blocks carry post-norms alone, after attention and
after the FFN); apertus's FFN is xIELU of the up product with the layer's
own coefficients (`ops/activations.py:xielu`); bitnet norms the attention
output before wo and the FFN's hidden before the down product (its
sub-norms) under relu2_glu; deci's and openelm's layers take their head
counts from their weights (the cache holds the most KV heads, a narrower
layer uses its first ones through a view, in place) and deci's
attention-free layer replaces the stream with ffn(ffn_norm(h)) + h, h its
attn_norm(x), as the JAX forward and llama.cpp's deci graph compute it;
chameleon is its (H, D) LayerNorm q/k norms. `fwd(..., mrope_pos=(3, B,
T))` ropes q and k with M-RoPE over three position streams (qwen2vl's
sections, qwen3vl's interleaved layout) while the cache is written at
`positions`; without it a qwen2vl ropes as neox, which M-RoPE over equal
streams is. The iSWA cache over layer segments raises ValueError: the JAX
iSWA branch scans the first segment alone.

The non-causal encoders (bert, neo-bert, gemma-embedding): attention runs
over the chunk both ways (`_chunk_attention` with positions, the JAX
condition: every forward of a non-causal arch without a softcap, sinks or
ALiBi), a key at position -1 (a pad) hidden from every query, and on
gemma-embedding's sliding layers the symmetric band |key pos - query pos|
<= sliding_window // 2; bert adds token type 0 (params["type_embd"]) after
the learned positions, reads its raw stream into attention (no pre-norm)
and closes each block with LayerNorms over the residual sums, x = LN(x +
attn), then x = LN(x + ffn(x)) (its post-sum norms ride the attn_norm and
ffn_norm slots), with no final norm. They embed (runtime/embeddings.py)
and never decode: `check_decoder` refuses generation over them by name.

Deepstack, Baichuan-13B (the JAX package ropes its 40-layer GGUF like the
7B's) and MLA on any other arch come later; `check_supported` names each
feature it can see in the configuration, and refuses the rest by arch
name.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import torch

from ..ops.activations import act_fn, xielu
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant_matmul import (
    FlatQuantTensor,
    W8A8Tensor,
    is_quantized,
    w8a8_linear,
    w8a8_quantize,
)
from ..ops.quant_matmul import quant_linear as mm
from ..ops.rope import RopeParams, mrope_cos_sin, rope_cos_sin, rotate
from ..runtime.kv_cache import KVCache, read_layer, swa_runs, write_layer
from .config import ModelConfig

NEG_INF = -1e30

LLAMA_FAMILY = ("llama", "mistral", "prosparse_llama", "bamboo")
# llama-shaped archs that differ from llama only in traits and tensors:
# q/k norms (before or after rope), post-norms, partial rope, LayerNorm
# blocks with biases, qkv biases, clamped q/k/v, NoPE layers
LLAMA_SHAPED = ("qwen3", "smollm", "tinyllama", "internlm2", "xverse", "baichuan", "exaone",
                "ernie4_5", "seed_oss", "smollm3", "glm4", "orion", "stablelm", "olmo",
                "hunyuan-dense", "arcee", "nemotron")
# the paper's other sparse families (SparkInfer's build_sparse_ffn archs)
SPARSE_FAMILIES = ("qwen2", "opt", "falcon")
# the GPT-family archs: fused QKV, learned positions, parallel blocks,
# LayerNorm with biases, ALiBi (bloom, mpt, jais, refact), head biases
GPT_FAMILY = ("gpt2", "starcoder", "codeshell", "jais", "refact", "qwen", "phi2", "gptneox",
              "bloom", "mpt", "gptj")
# decoders with features of their own: post-norm-only blocks (olmo2, olmo3),
# xIELU (apertus), bitnet's relu2_glu and sub-norms, per-layer widths (deci,
# openelm), chameleon's text path, M-RoPE (qwen2vl, qwen3vl)
FEATURE_ARCHS = ("olmo2", "olmo3", "apertus", "bitnet", "deci", "openelm", "chameleon",
                 "qwen2vl", "qwen3vl")
# the NAS stacks, whose head counts and FFN widths may differ by layer
NAS_ARCHS = ("deci", "openelm")
# decoders on traits the port has: the fault-7 multipliers (granite,
# minicpm), qkv and output biases (pangu-embedded), a parallel block under
# one pre-norm (plamo; command-r's under a bias-less LayerNorm, with
# logit_scale), LayerNorm with biases and an ungated gelu (starcoder2),
# phi3's q/k/v and gate/up as the JAX converter splits them
TRAIT_ARCHS = ("granite", "minicpm", "pangu-embedded", "plamo", "starcoder2", "command-r",
               "phi3")
# the non-causal encoders: bidirectional attention over the chunk, bert's
# post-sum LayerNorms and token types, gemma-embedding's symmetric window
ENCODER_ARCHS = ("bert", "neo-bert", "gemma-embedding")
# sliding windows, softcaps, sandwich norms and gemma3's second rope base
GEMMA_FAMILY = ("gemma", "gemma2", "gemma3")
# the archs it runs with experts only
EXPERT_ONLY = ("mixtral", "qwen3moe", "gpt-oss", "qwen2moe", "hunyuan-moe", "smallthinker",
               "grovemoe", "arctic")
# the archs whose experts the port runs
MOE_ARCHS = ("llama", "deepseek2") + EXPERT_ONLY
# multi-head latent attention over the latent cache
MLA_ARCHS = ("deepseek2", "minicpm3", "plm")


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for a configuration the port cannot run yet,
    naming the feature before the arch."""
    tr = cfg.traits
    # llama.cpp's baichuan: 40 layers is Baichuan-13B, ALiBi and no rope; the
    # JAX registry knows only the 7B rope variant and ropes it like the 7B
    if cfg.arch == "baichuan" and cfg.n_layer == 40:
        raise NotImplementedError(
            "ALiBi (attention linear biases) of Baichuan-13B is not ported: the JAX package "
            "ropes a 40-layer baichuan GGUF like the 7B's and has no ALiBi path for it")
    for cond, what in ((cfg.kv_lora_rank and cfg.arch not in MLA_ARCHS,
                        "MLA (multi-head latent attention) outside deepseek2, minicpm3 "
                        "and plm"),
                       ((cfg.n_head_arr or cfg.n_ff_arr) and cfg.arch not in NAS_ARCHS,
                        "per-layer head counts or FFN widths outside deci and openelm")):
        if cond:
            raise NotImplementedError(f"{what} is not ported yet (arch {cfg.arch!r})")
    archs = (LLAMA_FAMILY + LLAMA_SHAPED + SPARSE_FAMILIES + GPT_FAMILY + FEATURE_ARCHS
             + TRAIT_ARCHS + GEMMA_FAMILY + EXPERT_ONLY + MLA_ARCHS + ENCODER_ARCHS)
    if cfg.arch not in archs:
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (the llama family and the llama-shaped "
            f"archs, the MoE archs, the other sparse families, the GPT family, the "
            f"feature and trait archs, the gemma family, the MLA archs and the non-causal "
            f"encoders: {', '.join(archs)})")
    if cfg.n_expert and cfg.arch not in MOE_ARCHS:
        raise NotImplementedError(f"experts of arch {cfg.arch!r} are not ported yet")
    if cfg.arch in EXPERT_ONLY and not (cfg.n_expert and cfg.n_expert_used):
        raise NotImplementedError(f"arch {cfg.arch!r} without experts is not ported")


def check_decoder(cfg: ModelConfig, what: str):
    """Raise ValueError naming the arch where `what` (generation, a
    request) would decode over a non-causal encoder: each token would
    attend to keys after it, so the tokens would mean nothing (the JAX
    Engine and Scheduler decode such a model all the same)."""
    if cfg.traits.non_causal:
        raise ValueError(f"{what} over arch {cfg.arch!r}: a non-causal encoder decodes "
                         "nothing; it serves /v1/embeddings and /v1/rerank (runtime/embeddings.py)")


def clamp_max_seq(cfg: ModelConfig, params: dict, max_seq: int) -> int:
    """max_seq, cut to the positions a model with learned positions can
    address (its table's rows less pos_embd_offset), so that no position a
    runtime steps at, an idle slot's max_seq - 1 included, indexes past the
    table; a note on stderr where it cuts."""
    if not cfg.traits.pos_embd:
        return max_seq
    limit = params["pos_embd"].shape[0] - cfg.traits.pos_embd_offset
    if max_seq <= limit:
        return max_seq
    print(f"max_seq {max_seq} cut to the model's {limit} learned positions", file=sys.stderr)
    return limit


def _scalar(value: float, dtype) -> float:
    """value rounded to dtype, as JAX's jnp.asarray(value, x.dtype)."""
    return torch.tensor(value, dtype=dtype).item()


def _norm(x: torch.Tensor, w: torch.Tensor, b, kind: str, eps: float) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, w, eps)
    return layer_norm(x, w, b, eps)


def rope_params(cfg: ModelConfig) -> RopeParams:
    yarn_ext = cfg.yarn_ext_factor
    if yarn_ext < 0.0:  # auto: 1.0 when yarn, else 0
        yarn_ext = (1.0 if cfg.rope_scaling_type == "yarn"
                    and cfg.rope_orig_ctx else 0.0)
    return RopeParams(
        dim=cfg.rope_dim or cfg.head_dim,
        mode=cfg.traits.rope_mode,
        freq_base=cfg.rope_freq_base,
        freq_scale=cfg.rope_scale,
        yarn_orig_ctx=cfg.rope_orig_ctx,
        yarn_ext_factor=yarn_ext,
        yarn_attn_factor=cfg.yarn_attn_factor,
        yarn_beta_fast=cfg.yarn_beta_fast,
        yarn_beta_slow=cfg.yarn_beta_slow,
    )


def alibi_slopes(n_head: int) -> list[float]:
    """ALiBi's per-head slopes (bloom, mpt, jais, refact), the JAX package's:
    max bias 8, m0 = 2^(-8/n) over the largest power of two n <= n_head,
    and for the heads past n the odd powers of m1 = 2^(-4/n)."""
    import math

    n = 2 ** math.floor(math.log2(n_head))
    m0 = 2.0 ** (-8.0 / n)
    slopes = [m0 ** (i + 1) for i in range(n)]
    if n < n_head:
        m1 = 2.0 ** (-4.0 / n)
        slopes += [m1 ** (2 * i + 1) for i in range(n_head - n)]
    return slopes[:n_head]


def dense_ffn(cfg: ModelConfig):
    gated, f = act_fn(cfg.traits.act, cfg.fatrelu_threshold)

    def ffn(lp: dict, x: torch.Tensor) -> torch.Tensor:
        up = mm(x, lp["w_up"])
        if "b_up" in lp:
            up = up + lp["b_up"].to(up.dtype)
        if "xielu_ap" in lp:  # apertus: xIELU with the layer's own coefficients
            hidden = xielu(up, lp["xielu_ap"], lp["xielu_an"], lp["xielu_beta"],
                           lp["xielu_eps"])
        elif gated and "w_gate" in lp:
            hidden = f(mm(x, lp["w_gate"]), up)
        elif gated:  # gated act but no gate projection: act on up alone
            hidden = f(up, torch.ones_like(up))
        else:
            hidden = f(up)
        if "ffn_sub_norm_w" in lp:  # bitnet's norm before the down product
            hidden = _norm(hidden, lp["ffn_sub_norm_w"], None, cfg.traits.norm, cfg.norm_eps)
        out = mm(hidden, lp["w_down"])
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        return out

    return ffn


def _chunk_attention(q, k, v, H, Hkv, D, scale, positions=None, window: int = 0):
    """q (B,T,H,D), k/v (B,T,Hkv,D) -> (B,T,H,D) over the chunk alone:
    causal without `positions`; with them bidirectional (a non-causal
    encoder), every key at position -1 (a pad) hidden from every query, and
    window > 0 a symmetric band |key pos - query pos| <= window // 2
    (gemma-embedding's sliding layers), as the JAX forward's pair mask."""
    if positions is None:
        T = q.shape[1]
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    else:
        mask = (positions >= 0)[:, None, :]  # (B, 1, T): the keys that are no pad
        if window > 0:
            half = window // 2
            diff = positions[:, None, :] - positions[:, :, None]  # key - query, (B, T, T)
            mask = mask & (diff >= -half) & (diff <= half)
    return _attend(q, k, v, H, Hkv, D, scale, mask)


def _attend(q, k, v, H, Hkv, D, scale, mask, softcap: float = 0.0, sinks=None, bias=None):
    """Grouped-query attention: q (B,T,H,D) over k/v (B,S,Hkv,D); mask
    broadcastable to (B,T,S), True where query t may see key s. Scores and
    softmax in f32 (the JAX einsum's preferred_element_type), probabilities
    back in q's dtype for the value product. softcap > 0 caps the scores
    before the mask; bias (f32, broadcastable to (B,Hkv,g,T,S): ALiBi's) is
    added after the cap, before the mask; sinks (H,) join the softmax after
    it, one logit a head that carries no value."""
    B, T = q.shape[0], q.shape[1]
    g = H // Hkv
    qg = q.reshape(B, T, Hkv, g, D).permute(0, 2, 3, 1, 4).float()  # (B,Hkv,g,T,D)
    kt = k.permute(0, 2, 3, 1)[:, :, None].float()  # (B,Hkv,1,D,S)
    scores = (qg @ kt) * scale  # (B,Hkv,g,T,S)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if bias is not None:
        scores = scores + bias
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    if sinks is not None:
        sk = sinks.float().reshape(1, Hkv, g, 1, 1).expand(scores.shape[:-1] + (1,))
        probs = torch.softmax(torch.cat([scores, sk], dim=-1), dim=-1)[..., :-1].to(q.dtype)
    else:
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = probs @ v.permute(0, 2, 1, 3)[:, :, None]  # (B,Hkv,g,T,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


def _qk_norms(cfg: ModelConfig, lp: dict, q: torch.Tensor, k: torch.Tensor):
    """The q/k norms (attn_q_norm / attn_k_norm, with their biases where the
    params carry them) in the arch's q/k norm kind: per head when the weight
    is head_dim wide, over the full width when it is H*D wide, and an (H, D)
    affine over each head's unit-weight norm when it is 2-D (stablelm's
    per-head LayerNorm), that product taken in f32 and rounded to q's dtype
    once (the JAX package keeps it in f32; the same values in an f32 model)."""
    qw, kw = lp["attn_q_norm_w"], lp["attn_k_norm_w"]
    qb, kb = lp.get("attn_q_norm_b"), lp.get("attn_k_norm_b")
    kind, eps = cfg.traits.qk_norm_kind or cfg.traits.norm, cfg.norm_eps
    if qw.dim() == 2:
        ones = torch.ones(q.shape[-1], dtype=torch.float32, device=q.device)
        nq, nk = _norm(q, ones, None, kind, eps) * qw, _norm(k, ones, None, kind, eps) * kw
        if qb is not None:
            nq, nk = nq + qb, nk + kb
        return nq.to(q.dtype), nk.to(k.dtype)
    if qw.shape[-1] == q.shape[-1]:
        return _norm(q, qw, qb, kind, eps), _norm(k, kw, kb, kind, eps)
    return (_norm(q.flatten(-2), qw, qb, kind, eps).view(q.shape),
            _norm(k.flatten(-2), kw, kb, kind, eps).view(k.shape))


def _mask(positions: torch.Tensor, S: int, window: int, ring_width: int) -> torch.Tensor:
    """(B, T, S) True where query t may see cache slot s. Over a ring of
    ring_width slots, slot j holds the newest position q_j <= p_max with
    q_j % ring_width == j, p_max the step's newest position (on the device,
    so a CUDA graph replays it); a never-written slot rebuilds to q_j < 0.
    window > 0 hides keys window or more positions back."""
    s_idx = torch.arange(S, device=positions.device)
    if ring_width:
        p_max = positions[:, -1:]  # (B, 1)
        q_j = (p_max - (p_max - s_idx) % ring_width)[:, None, :]  # (B, 1, S)
        return ((q_j <= positions[:, :, None]) & (q_j >= 0)
                & (q_j > positions[:, :, None] - window))
    mask = s_idx[None, None, :] <= positions[:, :, None]
    if window:
        mask = mask & (s_idx[None, None, :] > positions[:, :, None] - window)
    return mask


def attention(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
              kc: torch.Tensor, vc: torch.Tensor, rp: RopeParams,
              rope_cs: tuple[torch.Tensor, torch.Tensor],
              fresh_prefill: bool = False, window: int = 0,
              ring_width: int = 0, rope: bool = True,
              ks: torch.Tensor | None = None, vs: torch.Tensor | None = None,
              alibi: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, T, E) already normed; positions (B, T); kc/vc one layer's cache
    (B, S, Hkv, D), written in place, and ks/vs its (B, S, Hkv, 1) scales
    where the cache is int8 (codes and scales written, reads dequantized
    into q's dtype); rope_cs the rope tables of positions
    (ops/rope.py:rope_cos_sin) at this layer's rope params rp. window: the
    layer's sliding window (0: none); ring_width: the slots of the layer's
    iSWA ring (0: a full cache). fresh_prefill: the prompt starts at
    position 0, so every key is in this chunk and attention runs over the
    chunk (T x T) instead of the whole cache (T x S), where the model has
    no window, no softcap, no sinks and no ALiBi, as in the JAX forward
    (over the chunk's own k and v, never their int8 codes). rope=False:
    a NoPE layer (cfg.nope_layers), whose q and k skip rope. alibi: the
    (Hkv, g) f32 ALiBi slopes of an ALiBi arch, whose term slope * (slot -
    query position) joins the scores; over a ring it raises ValueError.

    A NAS stack (deci, openelm: per-layer head counts) takes the layer's H
    and Hkv from its weights' widths, and a layer with fewer KV heads than
    the cache holds reads and writes the cache's first Hkv heads through a
    narrowed view, in place (the JAX forward slices them off and joins them
    back). bitnet's attn_sub_norm runs before wo."""
    B, T, _ = x.shape
    H, Hkv, D = cfg.n_head, cfg.n_head_kv, cfg.head_dim
    if cfg.n_head_arr or cfg.n_head_kv_arr:
        H, Hkv = lp["wq"].shape[-1] // D, lp["wk"].shape[-1] // D
        if kc.shape[2] != Hkv:
            kc, vc = kc[:, :, :Hkv], vc[:, :, :Hkv]
            if ks is not None:
                ks, vs = ks[:, :, :Hkv], vs[:, :, :Hkv]
    if alibi is not None and ring_width:
        raise ValueError(f"ALiBi over an iSWA ring cache (arch {cfg.arch!r}): the JAX "
                         "package's ring branch computes no ALiBi term; use a full cache")
    xq = w8a8_quantize(x) if isinstance(lp["wq"], W8A8Tensor) else None
    q = mm(x, lp["wq"], xq).reshape(B, T, H, D)
    k = mm(x, lp["wk"], xq).reshape(B, T, Hkv, D)
    v = mm(x, lp["wv"], xq).reshape(B, T, Hkv, D)
    if "bq" in lp:
        q = q + lp["bq"].to(q.dtype).reshape(H, D)
        k = k + lp["bk"].to(k.dtype).reshape(Hkv, D)
        v = v + lp["bv"].to(v.dtype).reshape(Hkv, D)
    if cfg.clamp_kqv > 0.0:  # olmo's, dbrx's clip_qkv
        c = cfg.clamp_kqv
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    after_rope = cfg.traits.qk_norm_after_rope  # hunyuan: rope, then the norms
    if "attn_q_norm_w" in lp and not after_rope:
        q, k = _qk_norms(cfg, lp, q, k)
    if rope:
        q = rotate(q, *rope_cs, rp)
        k = rotate(k, *rope_cs, rp)
    if "attn_q_norm_w" in lp and after_rope:
        q, k = _qk_norms(cfg, lp, q, k)
    wpos = positions % ring_width if ring_width else positions
    write_layer(kc, ks, k, wpos)
    write_layer(vc, vs, v, wpos)
    scale = cfg.attn_scale if cfg.attn_scale else D ** -0.5
    softcap, sinks = cfg.traits.attn_logit_softcap, lp.get("attn_sinks")
    causal = not cfg.traits.non_causal  # an encoder attends over its chunk both ways
    if ((fresh_prefill or not causal) and (cfg.sliding_window <= 0 or not causal)
            and softcap == 0.0 and sinks is None and alibi is None):
        out = _chunk_attention(q, k, v, H, Hkv, D, scale, None if causal else positions, window)
    else:
        keys = read_layer(kc, ks, q.dtype)
        vals = read_layer(vc, vs, q.dtype)
        S = kc.shape[1]
        # a ring holds a sliding run: the model's window, as in the JAX forward
        mask = _mask(positions, S, cfg.sliding_window if ring_width else window, ring_width)
        bias = None
        if alibi is not None:  # slope * (slot - query position), (B, Hkv, g, T, S)
            rel = (torch.arange(S, device=positions.device)[None, None, :]
                   - positions[:, :, None]).float()
            bias = alibi[None, :, :, None, None] * rel[:, None, None]
        out = _attend(q, keys, vals, H, Hkv, D, scale, mask, softcap, sinks, bias)
    out = out.reshape(B, T, H * D)
    if "attn_sub_norm_w" in lp:  # bitnet's norm before wo
        out = _norm(out, lp["attn_sub_norm_w"], None, cfg.traits.norm, cfg.norm_eps)
    out = mm(out, lp["wo"])
    if "bo" in lp:
        out = out + lp["bo"].to(out.dtype)
    return out


def attention_mla(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                  kc: torch.Tensor, rp: RopeParams,
                  rope_cs: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Multi-head latent attention (deepseek2), the absorbed form of the JAX
    package's attention_mla. x (B, T, E) already normed; kc one layer's
    latent cache (B, S, 1, R + Dr), written in place at positions: each
    token's normed latent c_kv (R) and its one roped key head k_pe (Dr).
    Associated as JAX does: q_lat = q_nope . wk_b, scores = q_lat . c +
    q_pe . k_pe (f32) scaled by Dk^-0.5, ctx = probs . c, out = ctx . wv_b,
    so no per-head key or value is ever built. Always over the whole cache,
    as in the JAX package (no chunk path)."""
    B, T, _ = x.shape
    eps, H, Dk, Dr, R = cfg.norm_eps, cfg.n_head, cfg.head_dim, cfg.rope_dim, cfg.kv_lora_rank
    Dn, Dv = Dk - Dr, cfg.v_head_dim or Dk
    if "wq_a" in lp:  # the q-lora (V2, V3)
        q = mm(rms_norm(mm(x, lp["wq_a"]), lp["q_a_norm_w"], eps), lp["wq_b"])
    else:  # V2-Lite: a direct q projection
        q = mm(x, lp["wq"])
    q = q.reshape(B, T, H, Dk)
    q_nope, q_pe = q[..., :Dn], rotate(q[..., Dn:], *rope_cs, rp)
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope, lp["wk_b"].to(q.dtype))
    kv_a = mm(x, lp["wkv_a"])  # (B, T, R + Dr)
    c_kv = rms_norm(kv_a[..., :R], lp["kv_a_norm_w"], eps)
    k_pe = rotate(kv_a[..., None, R:], *rope_cs, rp)[:, :, 0]
    write_layer(kc, None, torch.cat([c_kv, k_pe], -1)[:, :, None], positions)
    lat = read_layer(kc, None, q.dtype)[:, :, 0]  # (B, S, R + Dr)
    c_all, pe_all = lat[..., :R], lat[..., R:]
    scores = (torch.einsum("bthr,bsr->bhts", q_lat.float(), c_all.float())
              + torch.einsum("bthd,bsd->bhts", q_pe.float(), pe_all.float())) * Dk ** -0.5
    mask = _mask(positions, kc.shape[1], 0, 0)  # (B, T, S)
    probs = torch.softmax(torch.where(mask[:, None], scores, NEG_INF), dim=-1).to(q.dtype)
    ctx = torch.einsum("bhts,bsr->bthr", probs, c_all)  # the latent context
    out = torch.einsum("bthr,rhd->bthd", ctx, lp["wv_b"].to(ctx.dtype))
    return mm(out.reshape(B, T, H * Dv), lp["wo"])


def lm_head(x: torch.Tensor, w) -> torch.Tensor:
    """f32 logits of the normed hidden x (..., E). A W8A8Tensor head runs
    w8a8_linear with f32 out; a QuantTensor head runs quant_linear and casts
    its x.dtype result to f32, as the JAX package does. A plain head keeps
    f32 sums of the exact products of x and w in their own dtype (the JAX
    einsum's preferred_element_type=f32): on the card one cuBLAS product
    with an f32 output, on the CPU the head in f32 chunks of V, never an f32
    copy of the whole head."""
    if isinstance(w, W8A8Tensor):
        return w8a8_linear(x, w, out_dtype=torch.float32)
    if is_quantized(w):
        return mm(x, w).float()
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    V = w.shape[-1]
    if x2.is_cuda and x2.dtype == w.dtype:
        out = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        xf = x2.float()
        out = torch.empty((x2.shape[0], V), dtype=torch.float32, device=x.device)
        step = 8192
        for v0 in range(0, V, step):
            torch.mm(xf, w[:, v0:v0 + step].float(), out=out[:, v0:v0 + step])
    return out.reshape(x.shape[:-1] + (V,))


def moe_or_dense_ffn(cfg: ModelConfig, moe_mode: str = "dense") -> tuple[Callable, Callable]:
    """(ffn, moe): the FFN of a model with experts, the MoE FFN at a layer
    with a router and the dense FFN at any other (deepseek2-style leading
    dense layers) and at every layer of a parallel-MoE arch (arctic), whose
    layers carry both and whose MoE `moe` the forward adds as a residual of
    its own. moe_mode "pallas" reads the layers' `moe_layout` row stores."""
    from ..sparse.moe import make_moe_ffn

    moe, dense = make_moe_ffn(cfg, mode=moe_mode), dense_ffn(cfg)
    parallel = cfg.traits.parallel_moe

    def ffn(lp: dict, x: torch.Tensor) -> torch.Tensor:
        if "w_router" in lp and not (parallel and "w_up" in lp):
            return moe(lp, x)
        return dense(lp, x)

    return ffn, moe


def _layer_attention(cfg: ModelConfig, rp: RopeParams):
    """(window(il), rope(il)): each layer's sliding window (0: none) and
    rope params, as the JAX forward flags them: the window on every layer
    when the arch has no pattern and no second rope base, else on the
    layers of cfg.swa_layers; gemma3's sliding layers at
    rope_freq_base_swa, unscaled."""
    rp_swa = None
    if cfg.rope_freq_base_swa and cfg.rope_freq_base_swa != cfg.rope_freq_base:
        rp_swa = dataclasses.replace(rp, freq_base=cfg.rope_freq_base_swa,
                                     freq_scale=1.0, yarn_ext_factor=0.0)
    flags = None
    if cfg.sliding_window > 0 and (cfg.traits.swa_pattern > 1 or rp_swa is not None):
        flags = cfg.swa_layers

    def window(il: int) -> int:
        return cfg.sliding_window if cfg.sliding_window > 0 and (
            flags is None or flags[il]) else 0

    def rope(il: int) -> RopeParams:
        return rp_swa if rp_swa is not None and flags is not None and flags[il] else rp

    return window, rope


def layer_params(params: dict) -> list[dict]:
    """Each layer's params: the slices of params["layers"], or of each stack
    of params["layer_segments"] in order where the layers differ (deepseek2's
    leading dense layers, then its MoE layers), as the JAX forward scans
    them."""
    out = []
    for seg in params.get("layer_segments") or (params["layers"],):
        parts = {k: v.unbind(0) for k, v in seg.items()}
        out += [dict(zip(parts, vals)) for vals in zip(*parts.values())]
    return out


def one_stack(params: dict, what: str) -> None:
    """Raise NotImplementedError where `what` rewrites params["layers"] and
    the model keeps its layers in segments of different tensors."""
    if params.get("layer_segments"):
        raise NotImplementedError(f"{what} over layer segments (layers whose tensors or "
                                  "widths differ: deepseek2's leading dense layers, the "
                                  "per-layer widths of deci and openelm) is not ported yet")


def _layer_caches(cfg: ModelConfig, cache: KVCache) -> list[tuple]:
    """(k, v, k scales, v scales, ring width) of each layer: a full cache's
    layer (its scales None unless the cache is int8), or the layer of its
    run in an iSWA cache, whose sliding runs are rings."""
    if not cache.iswa:
        q = cache.quantized
        return [(cache.k[il], cache.v[il], cache.k_scale[il] if q else None,
                 cache.v_scale[il] if q else None, 0) for il in range(cfg.n_layer)]
    out = []
    for (s, e, is_swa), kr, vr in zip(swa_runs(cfg), cache.k, cache.v):
        rw = kr.shape[2] if is_swa else 0
        out += [(kr[j], vr[j], None, None, rw) for j in range(e - s)]
    return out


def make_forward(cfg: ModelConfig, ffn_fn: Callable | None = None,
                 fresh_prefill: bool = False,
                 ffn_carry_init: Callable | None = None,
                 stateful_ffn: bool = False, moe_mode: str = "dense",
                 with_hidden: bool = False, head: bool = True) -> Callable:
    """fwd(params, tokens (B,T), positions (B,T), cache[, fstate]) -> logits
    f32 (B, T, V); the cache is updated in place, and with stateful_ffn the
    FFN's state `fstate` too. `positions` are the absolute sequence
    positions of `tokens`. Without ffn_fn a model with experts runs its MoE
    FFN in `moe_mode` ("dense" or "pallas"). with_hidden=True returns
    (logits, hidden): hidden (B, T, E) the final-normed stream the head
    reads, in the model's dtype (the pooled input of runtime/embeddings);
    head=False leaves the head out and returns (None, hidden).
    The cache may be an iSWA dual cache, except in the carry form: the
    JAX forward's carry branch scans the cache as one stacked array, which
    a tuple of runs is not, so it raises ValueError there."""
    check_supported(cfg)
    eps, tr = cfg.norm_eps, cfg.traits
    if stateful_ffn and ffn_carry_init is not None:
        raise ValueError("a stateful FFN takes no cross-layer carry")
    if tr.parallel_moe and ffn_fn is not None:
        raise NotImplementedError("an FFN of its own (sparse, tiered) over arctic's parallel "
                                  "MoE block is not ported yet")
    moe_residual = None  # arctic: the MoE of the layer's input, a residual of its own
    if ffn_fn is None and cfg.n_expert > 0:
        ffn, moe = moe_or_dense_ffn(cfg, moe_mode)
        if tr.parallel_moe:
            moe_residual = moe
    else:
        ffn = ffn_fn or dense_ffn(cfg)
    rp = rope_params(cfg)
    kind = tr.norm
    window_of, rope_of = _layer_attention(cfg, rp)
    ropes = {rope_of(il) for il in range(cfg.n_layer)}
    final_cap = tr.final_logit_softcap
    mla = cfg.kv_lora_rank > 0
    nope = [bool(f) for f in cfg.nope_layers] if any(cfg.nope_layers) else [False] * cfg.n_layer
    nas = bool(cfg.n_head_arr)  # a NAS stack, whose attention-free layers carry no wq
    alibi: dict[torch.device, torch.Tensor] = {}  # ALiBi's (Hkv, g) slopes, one a device

    def alibi_of(device: torch.device) -> torch.Tensor | None:
        """The slopes on `device`, built at its first (eager) call; a CUDA
        graph's capture finds them built by its warm-up."""
        if not tr.alibi:
            return None
        if device not in alibi:
            alibi[device] = torch.tensor(alibi_slopes(cfg.n_head), dtype=torch.float32,
                                         device=device).view(cfg.n_head_kv, -1)
        return alibi[device]

    def fwd(params: dict, tokens: torch.Tensor, positions: torch.Tensor,
            cache: KVCache, fstate=None, mrope_pos: torch.Tensor | None = None) -> torch.Tensor:
        if mrope_pos is not None and not cfg.mrope_sections:
            raise ValueError(f"M-RoPE positions for arch {cfg.arch!r}, which has no "
                             "rope.dimension_sections")
        if cache.iswa and params.get("layer_segments"):
            raise ValueError("the iSWA cache over layer segments (layers whose tensors or "
                             "widths differ, as deci's): the JAX forward's iSWA branch scans "
                             "params['layers'] alone, the first segment")
        if ffn_carry_init is not None and cache.iswa:
            raise ValueError("the cross-layer FFN carry (the pipelined sparse FFN) takes no "
                             "iSWA cache, as the JAX forward's carry branch takes none")
        x = params["tok_embd"][tokens]
        if tr.embd_scale_sqrt:  # gemma: sqrt(n_embd) rounded to x's dtype, as JAX's
            x = x * _scalar(cfg.n_embd ** 0.5, x.dtype)
        if cfg.embd_scale != 1.0:  # granite/minicpm's embedding multiplier
            x = x * _scalar(cfg.embd_scale, x.dtype)
        if tr.pos_embd:  # learned positions (OPT's at HF offset 2)
            x = x + params["pos_embd"][positions + tr.pos_embd_offset]
        if "type_embd" in params:  # bert's token type (segment) 0, as the JAX forward
            x = x + params["type_embd"][0].to(x.dtype)
        if "tok_norm_w" in params:  # bloom's post-embedding LayerNorm
            x = _norm(x, params["tok_norm_w"], params.get("tok_norm_b"), kind, eps)
        sl = alibi_of(x.device)
        # loop-invariant flat (layer, group) sparse stores and predictor
        # stacks, addressed by the sparse FFN at row il * n_groups + group
        flat = params.get("sparse_flat")
        B, T = tokens.shape
        carry = ffn_carry_init(B, T, x.device) if ffn_carry_init else None
        # shared by every layer: the rope tables, or M-RoPE's of the three
        # position streams (the cache is still written at `positions`)
        if mrope_pos is None:
            rope_cs = {r: rope_cos_sin(positions, r) for r in ropes}
        else:
            rope_cs = {r: mrope_cos_sin(mrope_pos, cfg.mrope_sections, r, cfg.mrope_interleaved)
                       for r in ropes}
        for il, (lp, (kc, vc, ks, vs, ring_w)) in enumerate(zip(layer_params(params),
                                                                 _layer_caches(cfg, cache))):
            if flat is not None:  # FlatQuantTensors bind the layer late
                lp.update({k: (v.with_il(il) if isinstance(v, FlatQuantTensor) else v)
                           for k, v in flat.items()}, flat_il=il)
            x_in = x  # the layer's input: arctic's MoE and smallthinker's router read it
            if tr.moe_router_on_input and "w_router" in lp:  # routed before attention
                lp["router_logits"] = x_in @ lp["w_router"].to(x_in.dtype)
            # the pre-norm where the layer has one (olmo2's blocks have post-norms
            # only; bert's attn_norm slot holds its post-sum norm)
            h = (_norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), kind, eps)
                 if "attn_norm_w" in lp and not tr.post_norm else x)
            if nas and "wq" not in lp:
                # deci's attention-free layer: its output replaces the stream,
                # ffn(ffn_norm(h)) + h, as the JAX forward and llama.cpp's deci
                # graph compute it (no residual on x, no control vector)
                h2 = (_norm(h, lp["ffn_norm_w"], lp.get("ffn_norm_b"), kind, eps)
                      if "ffn_norm_w" in lp else h)
                if stateful_ffn:
                    y = ffn(lp, h2, fstate, il)
                elif ffn_carry_init is not None:
                    y, carry = ffn(lp, h2, carry, il)
                else:
                    y = ffn(lp, h2)
                x = h + y
                continue
            rp_l = rope_of(il)
            if mrope_pos is not None:  # M-RoPE rotates in the neox layout
                rp_l = dataclasses.replace(rp_l, mode="neox")
            if mla:
                attn_out = attention_mla(cfg, lp, h, positions, kc, rp_l, rope_cs[rope_of(il)])
            else:
                attn_out = attention(cfg, lp, h, positions, kc, vc, rp_l, rope_cs[rope_of(il)],
                                     fresh_prefill=fresh_prefill, window=window_of(il),
                                     ring_width=ring_w, rope=not nope[il], ks=ks, vs=vs,
                                     alibi=sl)
            if "attn_post_norm_w" in lp:  # gemma's sandwich norm
                attn_out = _norm(attn_out, lp["attn_post_norm_w"],
                                 lp.get("attn_post_norm_b"), kind, eps)
            if cfg.residual_scale != 1.0:  # granite's residual multiplier
                attn_out = attn_out * _scalar(cfg.residual_scale, attn_out.dtype)
            if tr.parallel_blocks:  # falcon: the FFN reads the layer's input
                h2 = (_norm(x, lp["attn_norm2_w"], lp.get("attn_norm2_b"), kind, eps)
                      if "attn_norm2_w" in lp else h)
            elif tr.post_norm:  # bert: a LayerNorm over each residual sum
                x = h2 = _norm(x + attn_out, lp["attn_norm_w"], lp.get("attn_norm_b"), kind, eps)
            else:
                x = x + attn_out
                h2 = (_norm(x, lp["ffn_norm_w"], lp.get("ffn_norm_b"), kind, eps)
                      if "ffn_norm_w" in lp else x)
            if stateful_ffn:
                y = ffn(lp, h2, fstate, il)
            elif ffn_carry_init is not None:
                y, carry = ffn(lp, h2, carry, il)
            else:
                y = ffn(lp, h2)
            if tr.parallel_blocks:  # JAX scales the attention output only here
                x = x + attn_out + y
            elif tr.post_norm:
                x = _norm(x + y, lp["ffn_norm_w"], lp.get("ffn_norm_b"), kind, eps)
            else:
                if "ffn_post_norm_w" in lp:
                    y = _norm(y, lp["ffn_post_norm_w"], lp.get("ffn_post_norm_b"), kind, eps)
                if cfg.residual_scale != 1.0:
                    y = y * _scalar(cfg.residual_scale, y.dtype)
                x = x + y
            if moe_residual is not None and "ffn_norm_exps_w" in lp:
                x = x + moe_residual(lp, _norm(x_in, lp["ffn_norm_exps_w"], None, kind, eps))
            if "cvec" in lp:  # control vector (llama_adapter_cvec)
                x = x + lp["cvec"].to(x.dtype)
        if "output_norm_w" in params:  # bert's last block normed the stream already
            x = _norm(x, params["output_norm_w"], params.get("output_norm_b"), kind, eps)
        if not head:
            return None, x
        logits = lm_head(x, params["output"])
        if "output_b" in params:  # gptj's and phi2's head bias, f32
            logits = logits + params["output_b"]
        if cfg.logit_scale != 1.0:  # cohere/granite's logit multiplier, on the f32 logits
            logits = logits * cfg.logit_scale
        if final_cap > 0:  # gemma2: cap * tanh(logits / cap)
            logits = final_cap * torch.tanh(logits / final_cap)
        return (logits, x) if with_hidden else logits

    return fwd
