"""Llama-family transformer forward, the port of the llama-family body of
sparkinfer_tpu/models/transformer.py:make_forward.

A plain Python loop over layers takes the place of `lax.scan`; the KV cache
is written in place. The FFN is pluggable as in the JAX package:
`ffn_fn(lp, x) -> y`, or with `ffn_carry_init` the cross-layer carry form
`ffn_fn(lp, x, carry, il) -> (y, carry)` that the pipelined sparse FFN uses
(its selection for layer il+1 is computed at layer il).

Every projection goes through `quant_linear` (the JAX `mm`), so packed
Q4_0/Q8_0 weights (QuantTensor, FlatQuantTensor) run the quant_matmul
kernels and plain tensors a plain matmul.

Attention is plain torch (matmul, mask, softmax), as the JAX CPU path
computes it; the JAX package's TPU prefill uses JAX's library flash
attention, which is no kernel of this repository and has no port here.
MLA, iSWA, layer segments, deepstack, ALiBi and softcaps come later.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.activations import act_fn
from ..ops.norms import rms_norm
from ..ops.quant_matmul import FlatQuantTensor, is_quantized
from ..ops.quant_matmul import quant_linear as mm
from ..ops.rope import RopeParams, rope_cos_sin, rotate
from ..runtime.kv_cache import KVCache, read_layer, write_layer
from .config import ModelConfig

NEG_INF = -1e30

LLAMA_FAMILY = ("llama", "mistral", "prosparse_llama", "bamboo")


def check_supported(cfg: ModelConfig):
    """Raise NotImplementedError for a configuration the port cannot run yet."""
    if cfg.arch not in LLAMA_FAMILY:
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet (llama family only: "
            f"{', '.join(LLAMA_FAMILY)})")
    if (cfg.n_expert or cfg.kv_lora_rank or cfg.sliding_window
            or cfg.n_head_arr or cfg.n_ff_arr):
        raise NotImplementedError(
            "MoE, MLA, sliding windows and per-layer widths are not ported yet")


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


def dense_ffn(cfg: ModelConfig):
    gated, f = act_fn(cfg.traits.act, cfg.fatrelu_threshold)

    def ffn(lp: dict, x: torch.Tensor) -> torch.Tensor:
        up = mm(x, lp["w_up"])
        if "b_up" in lp:
            up = up + lp["b_up"].to(up.dtype)
        if gated and "w_gate" in lp:
            hidden = f(mm(x, lp["w_gate"]), up)
        elif gated:  # gated act but no gate projection: act on up alone
            hidden = f(up, torch.ones_like(up))
        else:
            hidden = f(up)
        out = mm(hidden, lp["w_down"])
        if "b_down" in lp:
            out = out + lp["b_down"].to(out.dtype)
        return out

    return ffn


def _chunk_causal_attention(q, k, v, H, Hkv, D, scale):
    """q (B,T,H,D), k/v (B,T,Hkv,D) -> (B,T,H,D), causal within the chunk."""
    T = q.shape[1]
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    return _attend(q, k, v, H, Hkv, D, scale, mask)


def _attend(q, k, v, H, Hkv, D, scale, mask):
    """Grouped-query attention: q (B,T,H,D) over k/v (B,S,Hkv,D); mask
    broadcastable to (B,T,S), True where query t may see key s. Scores and
    softmax in f32 (the JAX einsum's preferred_element_type), probabilities
    back in q's dtype for the value product."""
    B, T = q.shape[0], q.shape[1]
    g = H // Hkv
    qg = q.reshape(B, T, Hkv, g, D).permute(0, 2, 3, 1, 4).float()  # (B,Hkv,g,T,D)
    kt = k.permute(0, 2, 3, 1)[:, :, None].float()  # (B,Hkv,1,D,S)
    scores = (qg @ kt) * scale  # (B,Hkv,g,T,S)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = probs @ v.permute(0, 2, 1, 3)[:, :, None]  # (B,Hkv,g,T,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


def attention(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
              kc: torch.Tensor, vc: torch.Tensor, rp: RopeParams,
              rope_cs: tuple[torch.Tensor, torch.Tensor],
              fresh_prefill: bool = False) -> torch.Tensor:
    """x (B, T, E) already normed; positions (B, T); kc/vc one layer's cache
    (B, S, Hkv, D), written in place; rope_cs the rope tables of positions
    (ops/rope.py:rope_cos_sin). fresh_prefill: the prompt starts at
    position 0, so every key is in this chunk and attention runs over the
    chunk (T x T) instead of the whole cache (T x S)."""
    B, T, _ = x.shape
    H, Hkv, D = cfg.n_head, cfg.n_head_kv, cfg.head_dim
    q = mm(x, lp["wq"]).reshape(B, T, H, D)
    k = mm(x, lp["wk"]).reshape(B, T, Hkv, D)
    v = mm(x, lp["wv"]).reshape(B, T, Hkv, D)
    if "bq" in lp:
        q = q + lp["bq"].to(q.dtype).reshape(H, D)
        k = k + lp["bk"].to(k.dtype).reshape(Hkv, D)
        v = v + lp["bv"].to(v.dtype).reshape(Hkv, D)
    q = rotate(q, *rope_cs, rp)
    k = rotate(k, *rope_cs, rp)
    write_layer(kc, k, positions)
    write_layer(vc, v, positions)
    scale = cfg.attn_scale if cfg.attn_scale else D ** -0.5
    if fresh_prefill:
        out = _chunk_causal_attention(q, k, v, H, Hkv, D, scale)
    else:
        keys = read_layer(kc, q.dtype)
        vals = read_layer(vc, q.dtype)
        s_idx = torch.arange(kc.shape[1], device=x.device)
        mask = s_idx[None, None, :] <= positions[:, :, None]  # (B, T, S)
        out = _attend(q, keys, vals, H, Hkv, D, scale, mask)
    out = mm(out.reshape(B, T, H * D), lp["wo"])
    if "bo" in lp:
        out = out + lp["bo"].to(out.dtype)
    return out


def lm_head(x: torch.Tensor, w) -> torch.Tensor:
    """f32 logits of the normed hidden x (..., E). A QuantTensor head runs
    quant_linear and casts its x.dtype result to f32, as the JAX package
    does. A plain head keeps f32 sums of the exact products of x and w in
    their own dtype (the JAX einsum's preferred_element_type=f32): on the
    card one cuBLAS product with an f32 output, on the CPU the head in f32
    chunks of V, never an f32 copy of the whole head."""
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


def make_forward(cfg: ModelConfig, ffn_fn: Callable | None = None,
                 fresh_prefill: bool = False,
                 ffn_carry_init: Callable | None = None) -> Callable:
    """fwd(params, tokens (B,T), positions (B,T), cache) -> logits f32
    (B, T, V); the cache is updated in place. `positions` are the absolute
    sequence positions of `tokens`."""
    check_supported(cfg)
    ffn = ffn_fn or dense_ffn(cfg)
    rp = rope_params(cfg)
    eps = cfg.norm_eps

    def fwd(params: dict, tokens: torch.Tensor, positions: torch.Tensor,
            cache: KVCache) -> torch.Tensor:
        x = params["tok_embd"][tokens]
        layers = params["layers"]
        # loop-invariant flat (layer, group) sparse stores and predictor
        # stacks, addressed by the sparse FFN at row il * n_groups + group
        flat = params.get("sparse_flat")
        B, T = tokens.shape
        carry = ffn_carry_init(B, T, x.device) if ffn_carry_init else None
        # shared by every layer: per-layer slices and the rope tables
        per_layer = {k: v.unbind(0) for k, v in layers.items()}
        rope_cs = rope_cos_sin(positions, rp)
        for il in range(cfg.n_layer):
            lp = {k: v[il] for k, v in per_layer.items()}
            if flat is not None:  # FlatQuantTensors bind the layer late
                lp.update({k: (v.with_il(il) if isinstance(v, FlatQuantTensor) else v)
                           for k, v in flat.items()}, flat_il=il)
            h = rms_norm(x, lp["attn_norm_w"], eps)
            x = x + attention(cfg, lp, h, positions, cache.k[il], cache.v[il],
                              rp, rope_cs, fresh_prefill=fresh_prefill)
            h2 = rms_norm(x, lp["ffn_norm_w"], eps)
            if ffn_carry_init is not None:
                y, carry = ffn(lp, h2, carry, il)
            else:
                y = ffn(lp, h2)
            x = x + y
        x = rms_norm(x, params["output_norm_w"], eps)
        return lm_head(x, params["output"])

    return fwd
