"""Model hyperparameters + architecture traits registry.

A copy of sparkinfer_tpu/models/config.py (pure Python and numpy), kept in
the port so that it imports nothing of the JAX package. The registry lists
every architecture the JAX package reads; the port's loader accepts the
llama family only (models/loader.py).

The analogue of src/llama-arch.{h,cpp} + src/llama-hparams.*:
a declarative per-arch trait table (norm type, activation, rope mode,
attention layout, tensor names) driving one generic transformer forward,
instead of 100 hand-written graph-builder files.

SparkInfer archs carried over (ref: src/llama-arch.h:14-15):
prosparse_llama, bamboo; sparse variants of qwen2/opt/falcon activate via
the predictor tensors + `{arch}.pred_lora` KV (ref: src/llama-hparams.h:54).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ..gguf.reader import GGUFReader


@dataclasses.dataclass(frozen=True)
class ArchTraits:
    name: str
    norm: str = "rms"  # "rms" | "ln"
    act: str = "silu"  # ops.activations.act_fn key
    rope_mode: str = "norm"  # "norm" | "neox" | "none"
    parallel_blocks: bool = False  # falcon: attn and FFN in parallel
    fused_qkv: bool = False  # falcon: blk.i.attn_qkv
    # fused qkv is a plain [Q;K;V] concat even under GQA/MQA (starcoder's
    # single-kv-head c_attn), not falcon's per-group interleave
    fused_qkv_concat: bool = False
    qkv_bias: bool = False  # qwen2
    attn_out_bias: bool = False
    ffn_bias: bool = False  # opt
    norm_bias: bool = False  # ln archs carry biases
    pos_embd: bool = False  # opt learned positions
    pos_embd_offset: int = 0  # opt: HF offset 2
    final_logit_softcap: float = 0.0
    # gemma2-style attention logit soft-capping (cap*tanh(s/cap), applied
    # pre-mask; ref: llama-graph.cpp build_attn_mha attn_soft_cap)
    attn_logit_softcap: float = 0.0
    # ALiBi positional bias (bloom/mpt — ref ggml_soft_max_ext max_bias)
    alibi: bool = False
    # gemma family scales embeddings by sqrt(n_embd)
    embd_scale_sqrt: bool = False
    # every Nth layer is full-attention, the others sliding-window
    # (ref: llama-hparams.h set_swa_pattern — gemma2: 2, gemma3: 6);
    # 0 = uniform (sliding_window applies to all layers when set)
    swa_pattern: int = 0
    recurrent: bool = False  # state-space/linear-attention family (mamba)
    # hybrid attention+recurrent stack (jamba — llama-memory-hybrid.cpp);
    # per-layer type comes from the attention.head_count_kv array
    ssm_hybrid: bool = False
    # falcon-h1 style: attention AND mamba2 run in parallel in EVERY layer
    # and their outputs sum (src/models/falcon-h1.cpp:26-72)
    hybrid_parallel: bool = False
    wkv_version: int = 0  # RWKV family: 6 | 7 (0 = not RWKV)
    # encoder-style post-norm: LayerNorm over each residual SUM
    # (bert attn_output_norm / layer_output_norm — ref src/models/bert.cpp)
    post_norm: bool = False
    # encoder-decoder family (t5 — ref src/models/t5-enc.cpp/t5-dec.cpp):
    # loaded/driven by models/t5.py + runtime/seq2seq.py
    enc_dec: bool = False
    # encoder-only (bidirectional attention, no causal mask — bert/WPM
    # embedding models; ref llama.cpp causal_attn=false for BERT)
    non_causal: bool = False
    # hunyuan: per-head qk-norm applied AFTER rope
    # (ref src/models/hunyuan-dense.cpp)
    qk_norm_after_rope: bool = False
    # qk-norm kind when it differs from the body norm (chameleon: LN
    # stats over head_dim with per-head affine — ChameleonLayerNorm)
    qk_norm_kind: str = ""
    # gemma3n: AltUp multi-stream stack + laurel + per-layer embeddings
    # (ref src/models/gemma3n-iswa.cpp; models/gemma3n.py here)
    altup: bool = False
    # arctic: dense FFN in the block + a PARALLEL residual MoE fed by a
    # second norm over the layer input (ref src/models/arctic.cpp)
    parallel_moe: bool = False
    # smallthinker: router logits from the RAW layer input before
    # attention (lookahead routing — src/models/smallthinker.cpp:22)
    moe_router_on_input: bool = False
    # sparse-FFN activation used when predictors present
    # (ref: src/llama-graph.cpp:1063-1094)
    sparse_act: str = "fatrelu"


ARCH_REGISTRY: dict[str, ArchTraits] = {}


def _reg(t: ArchTraits):
    ARCH_REGISTRY[t.name] = t
    return t


_reg(ArchTraits("llama"))
_reg(ArchTraits("prosparse_llama", act="fatrelu", sparse_act="fatrelu"))
_reg(ArchTraits("bamboo", act="drelu", sparse_act="drelu"))
_reg(ArchTraits("mistral"))
_reg(ArchTraits("qwen2", rope_mode="neox", qkv_bias=True, sparse_act="drelu"))
_reg(ArchTraits("qwen3", rope_mode="neox"))
# qwen2-vl text stack: qwen2 + M-RoPE (3-section multimodal rope;
# ref src/models/qwen2vl.cpp, ggml_rope_multi)
_reg(ArchTraits("qwen2vl", rope_mode="neox", qkv_bias=True))
# qwen3-vl text stacks: qwen3(+moe) with INTERLEAVED M-RoPE
# (ref src/models/qwen3vl.cpp / qwen3vl-moe.cpp)
_reg(ArchTraits("qwen3vl", rope_mode="neox"))
_reg(ArchTraits("qwen3vl-moe", rope_mode="neox"))
# diffusion LMs (examples/diffusion): denoised via runtime/diffusion.py
# with non-causal attention; dream is qwen2-flavoured, llada llama-flavoured
_reg(ArchTraits("dream", rope_mode="neox", qkv_bias=True))
_reg(ArchTraits("llada"))
_reg(
    ArchTraits(
        "falcon",
        norm="ln",
        act="gelu",
        rope_mode="neox",
        parallel_blocks=True,
        fused_qkv=True,
        norm_bias=True,
        sparse_act="relu",
    )
)
_reg(
    ArchTraits(
        "opt",
        norm="ln",
        act="relu",
        rope_mode="none",
        qkv_bias=True,
        attn_out_bias=True,
        ffn_bias=True,
        norm_bias=True,
        pos_embd=True,
        pos_embd_offset=2,
        sparse_act="relu",
    )
)
_reg(ArchTraits("gpt2", norm="ln", act="gelu", rope_mode="none", fused_qkv=True,
                qkv_bias=True, attn_out_bias=True, ffn_bias=True, norm_bias=True,
                pos_embd=True))
_reg(ArchTraits("gemma", rope_mode="neox", act="geglu", embd_scale_sqrt=True))
_reg(ArchTraits("gemma2", rope_mode="neox", act="geglu", embd_scale_sqrt=True,
                final_logit_softcap=30.0, attn_logit_softcap=50.0,
                swa_pattern=2))
_reg(ArchTraits("gemma3", rope_mode="neox", act="geglu", embd_scale_sqrt=True,
                swa_pattern=6))
# gemma-embedding: gemma3 stack as a bidirectional encoder — SYMMETRIC
# sliding windows (|Δpos| <= n_swa/2), causal_attn=false
# (ref llama-model.cpp LLM_ARCH_GEMMA_EMBEDDING, llama-hparams.cpp:218)
_reg(ArchTraits("gemma-embedding", rope_mode="neox", act="geglu",
                embd_scale_sqrt=True, swa_pattern=6, non_causal=True))
# gemma3n: AltUp + laurel + per-layer embeddings + KV sharing + FFN
# activation sparsity (ref src/models/gemma3n-iswa.cpp); swa pattern 5,
# softcap 30, scale=1.0 attention. Per-layer types may override the
# pattern via the swa_layers KV array.
_reg(ArchTraits("gemma3n", rope_mode="neox", act="geglu",
                embd_scale_sqrt=True, final_logit_softcap=30.0,
                swa_pattern=5, altup=True))
_reg(ArchTraits("stablelm", rope_mode="neox", norm="ln", norm_bias=True))
# broader llama-family coverage: these archs are trait-compatible with the
# generic forward (ref: per-arch builders in src/models/*.cpp that differ
# only in norm/act/rope/bias choices)
_reg(ArchTraits("qwen2moe", rope_mode="neox", qkv_bias=True))
_reg(ArchTraits("qwen3moe", rope_mode="neox"))
# grovemoe: softmax MoE + adjugate chunk experts applied to the routed
# output with expert id // experts_per_group (ref src/models/grovemoe.cpp)
_reg(ArchTraits("grovemoe", rope_mode="neox"))
# afmoe: sigmoid attention gate off the normed stream, per-head qk-norm,
# NoPE every n-th layer, post-norms, dense-lead sigmoid MoE with shared
# experts (ref src/models/afmoe.cpp; NEOX rope group)
_reg(ArchTraits("afmoe", rope_mode="neox", embd_scale_sqrt=True))
# smallthinker: lookahead MoE router (logits off the pre-attention
# stream) + relu-gated experts (ref src/models/smallthinker.cpp)
_reg(ArchTraits("smallthinker", rope_mode="neox", act="reglu",
                moe_router_on_input=True))
# arctic (snowflake): dense FFN + parallel residual MoE off the layer
# input via ffn_norm_exps (ref src/models/arctic.cpp)
_reg(ArchTraits("arctic", parallel_moe=True))
# grok-1: gelu MoE, post-attn/post-ffn norms, logit scale + softcap
# (ref src/models/grok.cpp; NEOX rope)
_reg(ArchTraits("grok", rope_mode="neox", act="geglu",
                final_logit_softcap=30.0))
_reg(ArchTraits("mixtral"))  # HF converts as llama; kept for direct GGUFs
_reg(ArchTraits("phi2", norm="ln", act="gelu", rope_mode="neox", qkv_bias=True,
                attn_out_bias=True, ffn_bias=True, norm_bias=True,
                parallel_blocks=True))
_reg(ArchTraits("phi3", rope_mode="neox"))
_reg(ArchTraits("olmo2", rope_mode="neox"))
# olmo3: olmo2 post-norm blocks + full-width qk-norm + 3:1 sliding/full
# pattern; full layers keep rope (scaled), sliding layers unscaled
_reg(ArchTraits("olmo3", rope_mode="neox", swa_pattern=4))
_reg(ArchTraits("smollm", ))
_reg(ArchTraits("tinyllama", ))
# internlm2 ropes NORM-style (ref llama-model.cpp rope-type switch)
_reg(ArchTraits("internlm2", ))
# chameleon: per-head LayerNorm on q/k with (H, D) affine
# (ref src/models/chameleon.cpp; HF ChameleonLayerNorm). neox layout —
# the HF weights are used unpermuted, unlike the reference converter.
_reg(ArchTraits("chameleon", rope_mode="neox", qk_norm_kind="ln"))
# dbrx: bias-less LayerNorm, fused concat Wqkv with qkv clamping,
# softmax-routed swiglu MoE (ref src/models/dbrx.cpp)
_reg(ArchTraits("dbrx", norm="ln", rope_mode="neox", fused_qkv=True,
                fused_qkv_concat=True))
# starcoder v1 (GPTBigCode): MQA (1 kv head), learned absolute positions,
# fused [Q;K;V] c_attn, LN + gelu (ref src/models/starcoder.cpp)
_reg(ArchTraits("starcoder", norm="ln", act="gelu", rope_mode="none",
                fused_qkv=True, fused_qkv_concat=True, qkv_bias=True,
                attn_out_bias=True, ffn_bias=True, norm_bias=True,
                pos_embd=True))
_reg(ArchTraits("starcoder2", norm="ln", act="gelu", rope_mode="neox",
                qkv_bias=True, attn_out_bias=True, ffn_bias=True,
                norm_bias=True))
# exaone ropes NEOX (ref llama_model_rope_type: LLM_ARCH_EXAONE in the
# GPTNEOX group)
_reg(ArchTraits("exaone", rope_mode="neox"))
_reg(ArchTraits("granite", ))
_reg(ArchTraits("minicpm", ))
_reg(ArchTraits("deepseek2", ))  # NORM rope (ref rope-type switch)
# diffusion MoE variants (examples/diffusion): llada-moe (qwen3moe-ish,
# unnormalized top-k) and rnd1 (qwen3moe-based); both NEOX rope
_reg(ArchTraits("llada-moe", rope_mode="neox"))
_reg(ArchTraits("rnd1", rope_mode="neox"))
# bailingmoe (Ling): NORM rope MoE with shared experts + weight norm/scale
# (ref src/models/bailingmoe.cpp)
_reg(ArchTraits("bailingmoe", ))
# minimax-m2: per-head qk-norm + sigmoid-routed MoE w/ correction bias
# (ref src/models/minimax-m2.cpp; NEOX rope group)
_reg(ArchTraits("minimax-m2", rope_mode="neox"))
# neo-bert: non-causal rms encoder with rope + swiglu
# (ref src/models/neo-bert.cpp; NORM rope group)
_reg(ArchTraits("neo-bert", non_causal=True))
# openelm: per-layer head counts + ffn widths, per-head qk-norm
# (ref src/models/openelm.cpp; converter-split q/k/v — the reference's
# fused per-layer attn_qkv GGUFs are not read directly yet)
_reg(ArchTraits("openelm", rope_mode="neox"))
# deci (Llama-3.1-Nemotron NAS): per-layer q/kv head counts, some layers
# attention-free (n_head==0: block output = ffn(norm2(norm1(x))) +
# norm1(x) — ref src/models/deci.cpp:32-38,92-112)
_reg(ArchTraits("deci", ))
# plamo v1: parallel attention+FFN sharing one pre-norm
# (ref src/models/plamo.cpp; NEOX rope)
_reg(ArchTraits("plamo", rope_mode="neox", parallel_blocks=True))
# pangu-embedded: llama-like with q/k/v/o biases (ref
# src/models/pangu-embedded.cpp; NEOX rope group)
_reg(ArchTraits("pangu-embedded", rope_mode="neox", qkv_bias=True,
                attn_out_bias=True))
# deepseek v1: llama-style attention + MoE with shared experts and
# unnormalized top-k weights (ref src/models/deepseek.cpp)
_reg(ArchTraits("deepseek", ))
# minicpm3: MLA with q-lora (ref src/models/minicpm3.cpp; NEOX rope group)
_reg(ArchTraits("minicpm3", rope_mode="neox"))
# plm: deepseek2-lite MLA (direct q) + ungated relu^2 FFN
# (ref src/models/plm.cpp)
_reg(ArchTraits("plm", rope_mode="neox", act="relu2"))
# bailingmoe2 (Ling v2): per-head qk-norm + grouped sigmoid MoE with
# dense lead and shared experts (ref src/models/bailingmoe2.cpp)
_reg(ArchTraits("bailingmoe2", rope_mode="neox"))
# jais: LN + ALiBi + fused [Q;K;V] + gated silu FFN with biases
# (ref src/models/jais.cpp; rope NONE group)
_reg(ArchTraits("jais", norm="ln", norm_bias=True, rope_mode="none",
                alibi=True, fused_qkv=True, fused_qkv_concat=True,
                qkv_bias=True, attn_out_bias=True, ffn_bias=True))
# codeshell: gpt2-family MQA with NEOX rope (ref src/models/codeshell.cpp)
_reg(ArchTraits("codeshell", norm="ln", act="gelu", rope_mode="neox",
                norm_bias=True, fused_qkv=True, fused_qkv_concat=True,
                qkv_bias=True, attn_out_bias=True, ffn_bias=True))
# refact: rms + gated silu FFN + ALiBi, no rope
# (ref src/models/refact.cpp; rope NONE group with MPT/OPT)
_reg(ArchTraits("refact", rope_mode="none", alibi=True))
# command-r/cohere2: parallel attn+FFN sharing one pre-LN, NORM rope
# WITHOUT the llama q/k permute (HF cohere is natively interleaved), and
# a logit_scale multiplier (ref src/models/command-r.cpp, cohere2.cpp)
_reg(ArchTraits("command-r", norm="ln", parallel_blocks=True))
# cohere2: 3 sliding+rope layers then 1 global rope-less layer
# (ref src/models/cohere2-iswa.cpp)
_reg(ArchTraits("cohere2", norm="ln", parallel_blocks=True, swa_pattern=4))
_reg(ArchTraits("olmoe", rope_mode="neox"))
_reg(ArchTraits("smollm3", ))
_reg(ArchTraits("granitemoe", ))
# gpt-oss: alternating SWA (pattern 2), learned attention sinks, MoE with
# clamped swiglu (ref src/models/openai-moe-iswa.cpp)
_reg(ArchTraits("gpt-oss", rope_mode="neox", swa_pattern=2,
                act="swiglu_oai"))
_reg(ArchTraits("glm4", swa_pattern=0))
# GLM-4.5 MoE: NEOX partial rope, optional qkv bias + per-head qk norm,
# sigmoid-routed MoE with score-correction bias + shared expert
# (ref src/models/glm4-moe.cpp)
_reg(ArchTraits("glm4moe", rope_mode="neox", qkv_bias=True))
_reg(ArchTraits("nemotron", norm="ln", act="relu2", norm_bias=True,
                rope_mode="neox"))
_reg(ArchTraits("ernie4_5", ))
# ernie 4.5 MoE: softmax router with selection-only correction bias,
# fused shared expert, leading dense layers (ref src/models/ernie4-5-moe.cpp)
_reg(ArchTraits("ernie4_5-moe", ))
# dots1: qwen3-style per-head qk-norm + deepseek3-style sigmoid-routed MoE
# with correction bias and shared experts (ref src/models/dots1.cpp)
_reg(ArchTraits("dots1", rope_mode="neox"))
# exaone4: 3 sliding:1 global hybrid; global layers are NoPE
# (nope_layers from the converter), per-head qk-norm
# (ref src/models/exaone4.cpp)
_reg(ArchTraits("exaone4", rope_mode="neox", swa_pattern=4))
# hunyuan v1: per-head qk-norm AFTER rope (src/models/hunyuan-dense.cpp);
# the moe variant adds softmax top-k experts + an always-on ungated
# shared MLP (src/models/hunyuan-moe.cpp)
_reg(ArchTraits("hunyuan-dense", rope_mode="neox", qk_norm_after_rope=True))
_reg(ArchTraits("hunyuan-moe", rope_mode="neox", qk_norm_after_rope=True))
# apertus: ungated xIELU FFN with per-layer learned coefficients,
# per-head qk-norm (ref src/models/apertus.cpp, ggml_xielu)
_reg(ArchTraits("apertus", rope_mode="neox"))
# bitnet b1.58: rms sub-norms before o_proj and down_proj, gated relu^2
# (ref src/models/bitnet.cpp attn_sub_norm/ffn_sub_norm)
_reg(ArchTraits("bitnet", act="relu2_glu"))
_reg(ArchTraits("gptneox", norm="ln", act="gelu", rope_mode="neox",
                norm_bias=True, qkv_bias=True, attn_out_bias=True,
                ffn_bias=True, parallel_blocks=True))
_reg(ArchTraits("bloom", norm="ln", act="gelu", rope_mode="none",
                norm_bias=True, qkv_bias=True, attn_out_bias=True,
                ffn_bias=True, alibi=True))
_reg(ArchTraits("mpt", norm="ln", act="gelu", rope_mode="none", alibi=True))
_reg(ArchTraits("gptj", norm="ln", act="gelu", norm_bias=True,
                ffn_bias=True, parallel_blocks=True))
# trait-only llama-shaped archs (direct-GGUF interop; per-arch traits
# verified against the reference graph builders + rope-type table):
_reg(ArchTraits("xverse", ))  # src/models/xverse.cpp: rms+silu, NORM rope
_reg(ArchTraits("baichuan", ))  # src/models/baichuan.cpp (7B rope variant)
_reg(ArchTraits("seed_oss", qkv_bias=True))  # src/models/seed-oss.cpp: NORM rope, attn bias
_reg(ArchTraits("arcee", act="relu2"))  # src/models/arcee.cpp: relu^2 FFN
_reg(ArchTraits("orion", norm="ln", norm_bias=True, rope_mode="neox"))
# olmo (v1): non-parametric layernorm is stored as unit weights in GGUF
_reg(ArchTraits("olmo", norm="ln", rope_mode="neox"))
_reg(ArchTraits("qwen", rope_mode="neox", fused_qkv=True, qkv_bias=True))
_reg(ArchTraits("mamba", rope_mode="none", recurrent=True))
_reg(ArchTraits("mamba2", rope_mode="none", recurrent=True))
_reg(ArchTraits("falcon-h1", rope_mode="neox", recurrent=True,
                ssm_hybrid=True, hybrid_parallel=True))
# granite 4.0 hybrid: interleaved mamba2/attention (NoPE), granitemoe-style
# fused MoE + shared expert, granite scale multipliers
# (ref src/models/granite-hybrid.cpp)
_reg(ArchTraits("granitehybrid", rope_mode="none", recurrent=True,
                ssm_hybrid=True))
# lfm2: gated short-conv layers + GQA attention layers (qk-norm, rope)
# (ref src/models/lfm2.cpp); lfm2moe adds sigma-gated MoE past the
# leading dense blocks
_reg(ArchTraits("lfm2", rope_mode="neox", recurrent=True, ssm_hybrid=True))
# qwen3next: gated-delta-net linear attention (3 of every 4 layers) +
# gated full attention, qwen3moe-style MoE with shared expert
# (ref src/models/qwen3next.cpp)
_reg(ArchTraits("qwen3next", rope_mode="neox", recurrent=True,
                ssm_hybrid=True))
_reg(ArchTraits("lfm2moe", rope_mode="neox", recurrent=True, ssm_hybrid=True))
_reg(ArchTraits("jamba", rope_mode="none", recurrent=True, ssm_hybrid=True))
# cogvlm: text-expert stream (fused [Q;K;V], rms+silu). The parallel
# vision-expert weights (vis_attn_qkv/vis_gate/...) select per-ubatch in
# the reference (src/models/cogvlm.cpp:14-34); image-batch evaluation is
# not wired (no vision tower oracle in this env)
_reg(ArchTraits("cogvlm", rope_mode="neox", fused_qkv=True,
                fused_qkv_concat=True))
# plamo2: mamba(per-head dt/B/C-normed) + attention hybrid with
# post-norms around both blocks (ref src/models/plamo2.cpp)
_reg(ArchTraits("plamo2", rope_mode="neox", recurrent=True, ssm_hybrid=True))
# nemotron-h: single-block hybrid — each layer is exactly ONE of
# {mamba2, NoPE attention, relu^2 FFN with biases}, one residual
# (ref src/models/nemotron-h.cpp; layer type from per-layer kv-head and
# ffn-width arrays)
_reg(ArchTraits("nemotron-h", rope_mode="none", recurrent=True,
                ssm_hybrid=True, act="relu2", ffn_bias=True))
# t5: encoder-decoder with shared relative-position-bucket attention bias,
# RMS pre-norm, unscaled attention (scale=1.0), relu (v1.0) or gated-gelu
# (v1.1/flan) FFN (ref src/models/t5-enc.cpp, t5-dec.cpp)
_reg(ArchTraits("t5", act="relu", rope_mode="none", enc_dec=True))
# t5encoder: encoder-only half (ref LLM_ARCH_T5ENCODER) for embeddings
_reg(ArchTraits("t5encoder", act="relu", rope_mode="none", enc_dec=True,
                non_causal=True))
# bert: encoder-only WPM embedding family — post-norm LayerNorm blocks,
# learned absolute positions, token-type embeddings, bidirectional
# attention, erf-GELU FFN (ref src/models/bert.cpp; HF BertModel oracle)
_reg(ArchTraits("bert", norm="ln", act="gelu_erf", rope_mode="none",
                qkv_bias=True, attn_out_bias=True, ffn_bias=True,
                norm_bias=True, pos_embd=True, post_norm=True,
                non_causal=True))
_reg(ArchTraits("rwkv6", norm="ln", rope_mode="none", recurrent=True,
                norm_bias=True, wkv_version=6))
_reg(ArchTraits("rwkv7", norm="ln", rope_mode="none", recurrent=True,
                norm_bias=True, wkv_version=7))
# rwkv6qwen2 (qrwkv): rwkv6 time-mix in a qwen2-shaped block — RMS
# pre-norms, GQA kv heads, sigmoid gate, gated linear attention, gated
# silu FFN (ref src/models/rwkv6qwen2.cpp + rwkv6-base.cpp is_qrwkv)
_reg(ArchTraits("rwkv6qwen2", rope_mode="none", recurrent=True,
                wkv_version=6))
# arwkv7: rwkv7 time-mix in a qwen-shaped block (ref src/models/arwkv7.cpp)
_reg(ArchTraits("arwkv7", rope_mode="none", recurrent=True, wkv_version=7))


@dataclasses.dataclass
class ModelConfig:
    arch: str
    n_layer: int
    n_embd: int
    n_head: int
    n_head_kv: int
    n_ff: int
    n_vocab: int
    head_dim: int
    n_ctx_train: int = 4096
    norm_eps: float = 1e-5
    rope_dim: int = 0
    rope_freq_base: float = 10000.0
    rope_scale: float = 1.0  # 1/factor linear
    rope_scaling_type: str = "none"
    rope_orig_ctx: int = 0
    # YaRN overrides (ref common/arg.cpp --yarn-*: -1/0 sentinel = derive
    # from the scaling type / use the standard constants)
    yarn_ext_factor: float = -1.0  # -1 = auto (1.0 when yarn, else 0)
    yarn_attn_factor: float = 1.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    tie_embeddings: bool = False
    # sparse predictor ranks per layer (0 = no predictor)
    pred_lora: tuple[int, ...] = ()
    # MoE
    n_expert: int = 0
    n_expert_used: int = 0
    n_expert_shared: int = 0  # shared (always-on) experts (qwen2moe/deepseek2)
    n_ff_exp: int = 0  # per-expert FF width when it differs from n_ff
    expert_weights_scale: float = 0.0  # deepseek2 routed_scaling_factor
    # grovemoe adjugate chunk experts (ref src/models/grovemoe.cpp;
    # llama-graph.cpp:1286-1289 maps expert id -> id // n_group_experts)
    n_group_experts: int = 0
    expert_group_scale: float = 0.0
    expert_gating: str = "softmax"  # "softmax" | "sigmoid" (deepseek3-style)
    norm_topk_prob: bool = True  # renormalize selected expert weights
    sliding_window: int = 0
    # model-level multipliers (granite/minicpm/cohere families; 1.0 = off.
    # ref: LLM_KV_*_SCALE in llama-arch.cpp, llama-hparams f_*_scale)
    embd_scale: float = 1.0
    logit_scale: float = 1.0
    residual_scale: float = 1.0
    attn_scale: float = 0.0  # 0 = default 1/sqrt(head_dim)
    # dbrx/mpt clip_qkv: clamp q/k/v projections to [-c, c]
    # (ref llama-hparams.h f_clamp_kqv, src/models/dbrx.cpp:41)
    clamp_kqv: float = 0.0
    # rope base for sliding-window layers when it differs from full layers
    # (gemma3: 10k local / 1M global; 0 = same base everywhere)
    rope_freq_base_swa: float = 0.0
    # per-layer NoPE flags (smollm3: every 4th layer skips rope)
    nope_layers: tuple[int, ...] = ()
    # MLA (deepseek2/3): low-rank latent attention geometry
    # (ref: src/models/deepseek2.cpp, llama-hparams n_lora_q/n_lora_kv)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    v_head_dim: int = 0  # != head_dim under MLA (value width)
    # number of dense (non-MoE) leading layers (first_k_dense_replace)
    n_dense_lead: int = 0
    fatrelu_threshold: float = 0.0
    # SSM (mamba) geometry (ref: mamba.ssm.* GGUF keys)
    n_head_kv_arr: tuple = ()  # per-layer kv heads (hybrid stacks; 0 = recurrent)
    # per-layer q heads (deci/openelm NAS stacks; 0 = attention-free layer)
    n_head_arr: tuple = ()
    # per-layer FFN widths (nemotron-h: mamba/attention layers carry 0)
    n_ff_arr: tuple = ()
    ssm_n_group: int = 0  # mamba2 B/C group count (ssm.group_count; 0 = mamba1)
    # falcon-mamba: weightless RMS over dt/B/C (ref llama-hparams.h
    # ssm_dt_b_c_rms, graph-context-mamba.cpp:94)
    ssm_dt_b_c_rms: bool = False
    shortconv_l_cache: int = 0  # lfm2 gated short-conv kernel length
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0
    # RWKV geometry (ref GGUF keys {arch}.wkv.head_size,
    # {arch}.time_mix_extra_dim, {arch}.time_decay_extra_dim,
    # {arch}.rescale_every_n_layers, {arch}.token_shift_count)
    # qwen2vl M-RoPE section widths (rope.dimension_sections)
    mrope_sections: tuple = ()
    # qwen3vl interleaved M-RoPE layout (T everywhere, H/W at strided dims)
    mrope_interleaved: bool = False
    # gemma3n AltUp geometry (ref gguf-py KV keys altup.num_inputs,
    # altup.active_idx, embedding_length_per_layer_input,
    # attention.shared_kv_layers, activation_sparsity_scale)
    n_altup: int = 0
    i_altup_act: int = 0
    n_embd_altup: int = 0
    n_kv_shared: int = 0
    act_sparsity_scale: tuple = ()  # per-layer gaussian-topk std multipliers
    swa_layers_arr: tuple = ()  # explicit per-layer sliding flags (override)
    # apertus xIELU per-layer coefficients (raw/pre-softplus, as stored
    # by the reference converter: gguf add_xielu_alpha_n/p)
    xielu_alpha_n: tuple = ()
    xielu_alpha_p: tuple = ()
    xielu_beta: tuple = ()
    xielu_eps: tuple = ()
    # T5 encoder-decoder geometry (ref llama-hparams.h dec_n_layer,
    # n_rel_attn_bkts; GGUF keys {arch}.decoder_block_count,
    # {arch}.attention.relative_buckets_count, {arch}.decoder_start_token_id)
    dec_n_layer: int = 0
    n_rel_attn_bkts: int = 0
    rel_attn_max_dist: int = 128
    dec_start_token_id: int = -1
    wkv_head_size: int = 0
    time_mix_extra_dim: int = 0
    time_decay_extra_dim: int = 0
    rescale_every_n_layers: int = 0
    token_shift_count: int = 2

    @property
    def traits(self) -> ArchTraits:
        return ARCH_REGISTRY[self.arch]

    @property
    def swa_layers(self) -> tuple[bool, ...]:
        """Per-layer sliding-window flags (ref: llama-hparams.h
        set_swa_pattern: il %% pattern < pattern-1 -> SWA; last of each
        pattern block is full attention). Uniform when swa_pattern == 0.
        An explicit per-layer array (gemma3n layer_types) wins."""
        if self.swa_layers_arr:
            return self.swa_layers_arr
        if self.sliding_window <= 0:
            return (False,) * self.n_layer
        p = self.traits.swa_pattern
        if p <= 1:
            return (True,) * self.n_layer
        return tuple((il % p) < (p - 1) for il in range(self.n_layer))

    @property
    def has_predictors(self) -> bool:
        return any(r > 0 for r in self.pred_lora)

    @property
    def max_pred_rank(self) -> int:
        return max(self.pred_lora) if self.pred_lora else 0

    @classmethod
    def from_gguf(cls, r: "GGUFReader") -> "ModelConfig":
        arch = r.arch()
        if arch not in ARCH_REGISTRY:
            raise NotImplementedError(f"arch {arch!r} not in registry")

        def g(key: str, default=None):
            return r.kv.get(f"{arch}.{key}", default)

        n_embd = int(g("embedding_length"))
        nh_raw = g("attention.head_count", 0)
        n_head_arr: tuple = ()
        if isinstance(nh_raw, (list, tuple, np.ndarray)):
            # per-layer q heads (deci NAS stacks; 0 = attention-free)
            n_head_arr = tuple(int(x) for x in nh_raw)
            n_head = max(n_head_arr)
        else:
            n_head = int(nh_raw or 0)
        if n_head == 0:  # recurrent archs carry no attention heads
            n_head = 1
        hkv_raw = g("attention.head_count_kv", n_head)
        n_head_kv_arr: tuple = ()
        if isinstance(hkv_raw, (list, tuple, np.ndarray)):
            # per-layer array (jamba-style hybrid stacks: 0 = recurrent
            # layer; ref src/llama-model.cpp:1470-1472)
            n_head_kv_arr = tuple(int(x) for x in hkv_raw)
            n_head_kv = max(n_head_kv_arr)
        else:
            n_head_kv = int(hkv_raw)
        if int(g("attention.kv_lora_rank", 0) or 0) > 0:
            # MLA decompresses K/V per query head; the naive cache stores
            # all n_head heads regardless of the GGUF's head_count_kv
            n_head_kv = n_head
        head_dim = int(g("attention.key_length", n_embd // n_head))
        tokens = r.kv.get("tokenizer.ggml.tokens")
        n_vocab = int(g("vocab_size", len(tokens) if tokens is not None else 0))
        pred = g("pred_lora")
        pred_lora = tuple(int(x) for x in pred) if pred is not None else ()
        ff_raw = g("feed_forward_length", 0)
        n_ff_arr: tuple = ()
        if isinstance(ff_raw, (list, tuple, np.ndarray)):
            # per-layer widths (nemotron-h: 0 on mamba/attention layers)
            n_ff_arr = tuple(int(x) for x in ff_raw)
            n_ff = max(n_ff_arr)
        else:
            n_ff = int(ff_raw or 0)
        scaling_type = g("rope.scaling.type", "none")
        factor = float(g("rope.scaling.factor", 1.0))
        has_output = "output.weight" in r.tensors
        return cls(
            arch=arch,
            n_layer=int(g("block_count")),
            n_embd=n_embd,
            n_head=n_head,
            n_head_kv=n_head_kv,
            n_head_kv_arr=n_head_kv_arr,
            n_head_arr=n_head_arr,
            n_ff=n_ff,
            n_ff_arr=n_ff_arr,
            n_vocab=n_vocab,
            head_dim=head_dim,
            n_ctx_train=int(g("context_length", 4096)),
            norm_eps=float(
                g("attention.layer_norm_rms_epsilon", g("attention.layer_norm_epsilon", 1e-5))
            ),
            rope_dim=int(g("rope.dimension_count", head_dim)),
            rope_freq_base=float(g("rope.freq_base", 10000.0)),
            # freq_scale = 1/factor for ANY scaling type (the reference sets
            # rope_freq_scale_train from rope.scaling.factor unconditionally,
            # llama-model.cpp:577-582 — YaRN needs it for interpolation+mscale)
            rope_scale=1.0 / factor if factor not in (0.0, 1.0) else 1.0,
            rope_scaling_type=scaling_type,
            rope_orig_ctx=int(g("rope.scaling.original_context_length", 0)),
            tie_embeddings=not has_output,
            pred_lora=pred_lora,
            n_expert=int(g("expert_count", 0)),
            n_expert_used=int(g("expert_used_count", 0)),
            n_expert_shared=int(g("expert_shared_count", 0)),
            n_ff_exp=int(g("expert_feed_forward_length", 0)),
            expert_weights_scale=float(g("expert_weights_scale", 0.0)),
            n_group_experts=int(g("experts_per_group", 0) or 0),
            expert_group_scale=float(g("expert_group_scale", 0.0)),
            # ref llama-hparams.h: 1=softmax, 2=sigmoid (deepseek3),
            # 3=softmax over the SELECTED top-k logits (gpt-oss)
            expert_gating={2: "sigmoid", 3: "softmax_topk"}.get(
                int(g("expert_gating_func", 1)), "softmax"),
            norm_topk_prob=bool(g("expert_weights_norm", True)),
            sliding_window=int(g("attention.sliding_window", 0)),
            embd_scale=float(g("embedding_scale", 1.0)),
            logit_scale=float(g("logit_scale", 1.0)),
            residual_scale=float(g("residual_scale", 1.0)),
            attn_scale=float(g("attention.scale", 0.0)),
            clamp_kqv=float(g("attention.clamp_kqv", 0.0)),
            rope_freq_base_swa=float(g("rope.freq_base_swa", 0.0)),
            nope_layers=tuple(
                int(x) for x in (g("nope_layers") if g("nope_layers") is not None else ())
            ),
            q_lora_rank=int(g("attention.q_lora_rank", 0) or 0),
            kv_lora_rank=int(g("attention.kv_lora_rank", 0) or 0),
            v_head_dim=int(g("attention.value_length", 0) or 0),
            n_dense_lead=int(g("leading_dense_block_count", 0) or 0),
            ssm_n_group=int(g("ssm.group_count", 0)),
            ssm_dt_b_c_rms=bool(g("ssm.dt_b_c_rms", False)),
            shortconv_l_cache=int(g("shortconv.l_cache", 0)),
            ssm_d_conv=int(g("ssm.conv_kernel", 0)),
            ssm_d_inner=int(g("ssm.inner_size", 0)),
            ssm_d_state=int(g("ssm.state_size", 0)),
            ssm_dt_rank=int(g("ssm.time_step_rank", 0)),
            mrope_sections=tuple(
                int(x) for x in (g("rope.dimension_sections")
                                 if g("rope.dimension_sections") is not None
                                 else ()) if int(x) > 0),
            mrope_interleaved=bool(g("rope.mrope_interleaved", False)),
            n_altup=int(g("altup.num_inputs", 0) or 0),
            i_altup_act=int(g("altup.active_idx", 0) or 0),
            n_embd_altup=int(g("embedding_length_per_layer_input", 0) or 0),
            n_kv_shared=int(g("attention.shared_kv_layers", 0) or 0),
            act_sparsity_scale=tuple(
                float(x) for x in (g("activation_sparsity_scale")
                                   if g("activation_sparsity_scale") is not None else ())),
            swa_layers_arr=tuple(
                bool(x) for x in (g("swa_layers")
                                  if g("swa_layers") is not None else ())),
            xielu_alpha_n=tuple(float(x) for x in (g("xielu_alpha_n") if g("xielu_alpha_n") is not None else ())),
            xielu_alpha_p=tuple(float(x) for x in (g("xielu_alpha_p") if g("xielu_alpha_p") is not None else ())),
            xielu_beta=tuple(float(x) for x in (g("xielu_beta") if g("xielu_beta") is not None else ())),
            xielu_eps=tuple(float(x) for x in (g("xielu_eps") if g("xielu_eps") is not None else ())),
            dec_n_layer=int(g("decoder_block_count", 0) or 0),
            n_rel_attn_bkts=int(g("attention.relative_buckets_count", 0) or 0),
            rel_attn_max_dist=int(g("attention.relative_max_distance", 128)),
            dec_start_token_id=int(g("decoder_start_token_id", -1)),
            wkv_head_size=int(g("wkv.head_size", 0)),
            time_mix_extra_dim=int(g("time_mix_extra_dim", 0)),
            time_decay_extra_dim=int(g("time_decay_extra_dim", 0)),
            rescale_every_n_layers=int(g("rescale_every_n_layers", 0)),
            token_shift_count=int(g("token_shift_count", 2)),
        )
