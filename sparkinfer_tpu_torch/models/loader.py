"""GGUF -> torch params, the port of sparkinfer_tpu/models/loader.py for
every arch `models/transformer.py:check_supported` admits: the llama
family, the llama-shaped archs, the MoE archs, the paper's other sparse
families (qwen2, opt, falcon), the GPT family (gpt2, starcoder, codeshell,
jais, refact, qwen, phi2, gptneox, bloom, mpt, gptj), the feature archs
(olmo2, olmo3, apertus, bitnet, deci, openelm, chameleon, qwen2vl,
qwen3vl), the trait archs (granite, minicpm, pangu-embedded, plamo,
starcoder2, command-r, phi3: the llama loader's tensors and keys; phi3's
q/k/v and gate/up as the JAX converter splits them), the gemma family, the
MLA archs (deepseek2, minicpm3, plm) and the non-causal encoders (bert,
neo-bert, gemma-embedding).

The params dict has the JAX loader's keys and orientations, so the two
packages can be compared key for key: `x @ W` with W shaped (in, out),
per-layer tensors stacked on a leading L axis under params["layers"],
norms and biases in f32, and the low-rank predictor as pred_up (E, R),
pred_up_b (R,), pred_down (R, F), pred_down_b (F,), zero-padded to the
largest rank. Each stacked tensor is allocated once on the device and
filled layer by layer, so the host never holds the whole model in f32.

Every GGML type the port decodes (gguf/quants.py: the K-quants, the IQ
formats, ...) loads, dequantized on the host a tensor at a time.
keep_quantized=True keeps Q4_0/Q8_0 linears packed on the device as
`QuantTensor`s (ops/quant_matmul.py), stacked over layers, the head too;
other types are dequantized, as in the JAX package. attn_w8a8=True
re-quantizes the dense attention projections (wq, wk, wv, wo; never packed
ones) to row-wise W8A8 (`W8A8Tensor`), a layer at a time on the device,
from the weight in the model's dtype (the bits of the JAX loader, which
quantizes the whole stack on the host). A reranker's classification head
(cls.weight, cls.bias, cls.output.weight, cls.output.bias) loads as f32
cls_w, cls_b, cls_out_w, cls_out_b for rank pooling (runtime/embeddings.py).
A GGUF with `tokenizer.ggml.*` metadata gives the model its `Vocab`
(tokenizer/vocab.py).

MoE: the router (ffn_gate_inp) as w_router (E, X), its bias, the expert
stacks, their gpt-oss biases, the score-correction bias (exp_probs_b),
grovemoe's chunk experts, the shared expert's tensors (qwen2moe's with its
gate ffn_gate_inp_shexp, hunyuan-moe's without) and arctic's second norm
ffn_norm_exps (ffn_norm_exps_w, over the layer's input). Every expert
stack is kept in one orientation, (X, Fe, E) a layer, the GGUF's own for
up and gate (sparse/moe.py): the fused mode and expert
tiering read it as row stores through views, so the experts are resident
once. The JAX loader keeps up and gate as (X, E, Fe); models/from_jax.py
converts.

The other sparse families add LayerNorm biases (attn_norm_b, ffn_norm_b,
output_norm_b), falcon's second norm (attn_norm_2 as attn_norm2_w and
attn_norm2_b), OPT's learned positions (position_embd as pos_embd, in the
model's dtype) and falcon's fused attn_qkv, split into wq/wk/wv (and their
biases) by `split_fused_qkv`: per kv group [q_0..q_{g-1}, k, v] for
grouped falcon, plain [Q; K; V] for MQA or MHA and the concat archs (gpt2,
starcoder, codeshell, jais, qwen). As in the JAX loader, a GGUF with a
fused QKV loads dequantized whatever keep_quantized says (the split needs
the dense weight), while the split Q/K/V that the JAX converter writes for
bloom, mpt and gptneox stays packed; a parallel-block arch gets no all-ones
FFN norm, since its FFN reads the attention norms. bloom's post-embedding
LayerNorm (token_embd_norm) loads as tok_norm_w and tok_norm_b, the head
bias of gptj and phi2 (output.bias) as output_b, all in f32; a tied head
(bloom, mpt) is the embedding's transpose.

The q/k norms load as attn_q_norm_w / attn_k_norm_w with their biases
attn_q_norm_b / attn_k_norm_b where the GGUF has them (stablelm's (H, D)
per-head LayerNorm weights keep that shape); the post-norms carry their
biases too (attn_post_norm_b, ffn_post_norm_b). An arch with no norm
tensors (olmo's non-parametric LayerNorm) gets all-ones weights, except
where the layer has the matching post-norm (olmo2, olmo3: attention and
FFN read the raw stream, as in the JAX loader). bitnet's sub-norms load as
attn_sub_norm_w and ffn_sub_norm_w, apertus's xIELU coefficients as f32
(1,) tensors a layer, xielu_ap = softplus(alpha_p), xielu_an = beta +
softplus(alpha_n), xielu_beta and xielu_eps (defaults 0.5 and -1e-6). A
NAS stack (deci, openelm) reads each layer at its own head counts and FFN
width (`layer_widths`); a layer of 0 heads has no attention tensors; runs
split on those widths too (`layer_runs`), so openelm's layers of other
widths stack apart, where the JAX loader, which splits on names alone,
fails. A fused attn_qkv on an arch whose q/k/v the port reads split (the
upstream openelm GGUFs) raises NotImplementedError.

The sliding-window archs add gpt-oss's attention sinks (attn_sinks, one
logit a head, kept in f32 as the JAX loader keeps them) beside its q/k/v
and output biases, and gemma's sandwich norms (attn_post_norm as
attn_post_norm_w, ffn_post_norm as ffn_post_norm_w); gemma's head is the
tied embedding, as for any GGUF without output.weight.

bert adds its token types (token_types as type_embd, in the model's dtype),
its embedding LayerNorm (token_embd_norm, as bloom's) and its post-sum
LayerNorms: attn_output_norm in the attn_norm slot and layer_output_norm
in the ffn_norm slot, with their biases, as the JAX loader places them. A
post-sum encoder gets no final norm (its last block normed the stream),
where any other arch without output_norm gets an all-ones one; olmo2's
post-norm-only blocks (attn_post_norm, ffn_post_norm) are another trait.
neo-bert and gemma-embedding read the llama and gemma3 tensors.

deepseek2 adds the MLA tensors as the JAX loader reads them: wq (V2-Lite's
direct q) or wq_a, q_a_norm_w and wq_b (the q-lora); wkv_a (the latent and
the rope key head, E x (R + Dr)); kv_a_norm_w; and attn_kv_b split into
wk_b (R, H, Dn) and wv_b (R, H, Dv) for the absorbed attention (always
dequantized: the split needs the dense weight); its wo is H*Dv wide. Layers
whose tensors differ (its leading dense layers, then its MoE layers) are
grouped into contiguous runs of the same tensor names, each stacked on its
own, as the JAX loader's params["layer_segments"]; params["layers"] is the
first of them, as there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader
from ..ops.quant_matmul import REPACK, QuantTensor, W8A8Tensor
from .config import ModelConfig
from .transformer import check_supported

Params = dict[str, Any]

# per-layer GGUF tensors the forward reads: suffix -> key (a fused attn_qkv
# lands in wq, wk and wv)
_LAYER_TENSORS = {
    "attn_norm.weight": "attn_norm_w", "attn_norm.bias": "attn_norm_b",
    "attn_norm_2.weight": "attn_norm2_w", "attn_norm_2.bias": "attn_norm2_b",
    "attn_qkv.weight": "wq", "attn_qkv.bias": "bq", "attn_q.weight": "wq",
    "attn_k.weight": "wk", "attn_v.weight": "wv", "attn_q.bias": "bq",
    "attn_k.bias": "bk", "attn_v.bias": "bv", "attn_output.weight": "wo",
    "attn_output.bias": "bo", "ffn_norm.weight": "ffn_norm_w", "ffn_norm.bias": "ffn_norm_b",
    "ffn_up.weight": "w_up", "ffn_up.bias": "b_up", "ffn_gate.weight": "w_gate",
    "ffn_down.weight": "w_down", "ffn_down.bias": "b_down",
    "ffn_pred_up.weight": "pred_up", "ffn_pred_up.bias": "pred_up_b",
    "ffn_pred_down.weight": "pred_down", "ffn_pred_down.bias": "pred_down_b",
    "attn_q_norm.weight": "attn_q_norm_w", "attn_k_norm.weight": "attn_k_norm_w",
    "attn_q_norm.bias": "attn_q_norm_b", "attn_k_norm.bias": "attn_k_norm_b",
    "attn_sinks.weight": "attn_sinks", "attn_post_norm.weight": "attn_post_norm_w",
    "attn_post_norm.bias": "attn_post_norm_b", "ffn_post_norm.weight": "ffn_post_norm_w",
    "ffn_post_norm.bias": "ffn_post_norm_b", "ffn_norm_exps.weight": "ffn_norm_exps_w",
    "ffn_gate_inp.weight": "w_router", "ffn_gate_inp.bias": "w_router_b",
    "ffn_up_exps.weight": "w_up_exps", "ffn_gate_exps.weight": "w_gate_exps",
    "ffn_down_exps.weight": "w_down_exps", "ffn_up_exps.bias": "w_up_exps_b",
    "ffn_gate_exps.bias": "w_gate_exps_b", "ffn_down_exps.bias": "w_down_exps_b",
    "exp_probs_b.bias": "router_bias", "ffn_up_chexps.weight": "w_up_chexps",
    "ffn_gate_chexps.weight": "w_gate_chexps", "ffn_down_chexps.weight": "w_down_chexps",
    "ffn_up_shexp.weight": "w_up_shexp", "ffn_gate_shexp.weight": "w_gate_shexp",
    "ffn_down_shexp.weight": "w_down_shexp", "ffn_gate_inp_shexp.weight": "w_gate_inp_shexp",
    # deepseek2's multi-head latent attention
    "attn_q_a.weight": "wq_a", "attn_q_a_norm.weight": "q_a_norm_w", "attn_q_b.weight": "wq_b",
    "attn_kv_a_mqa.weight": "wkv_a", "attn_kv_a_norm.weight": "kv_a_norm_w",
    "attn_kv_b.weight": "wk_b",
    # bitnet's sub-norms, before wo and before the down product
    "attn_sub_norm.weight": "attn_sub_norm_w", "ffn_sub_norm.weight": "ffn_sub_norm_w",
    # bert's post-sum norms, in the attn_norm and ffn_norm slots
    "attn_output_norm.weight": "attn_norm_w", "attn_output_norm.bias": "attn_norm_b",
    "layer_output_norm.weight": "ffn_norm_w", "layer_output_norm.bias": "ffn_norm_b",
}


@dataclass
class LoadedModel:
    config: ModelConfig
    params: Params
    vocab: Any = None  # tokenizer.Vocab, where the GGUF has one


def _host(arr: np.ndarray) -> torch.Tensor:
    # the reader's views are read-only mmaps; torch wants a writable array
    return torch.from_numpy(np.require(arr, requirements=["C", "W"]))


def _tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    return _host(arr).to(device=device, dtype=dtype)


def _get(r: GGUFReader, name: str) -> np.ndarray | None:
    t = r.tensors.get(name)
    return None if t is None else t.to_f32()


def _linear(r: GGUFReader, name: str, in_dim: int, out_dim: int) -> np.ndarray | None:
    """Fetch a weight canonicalized to numpy (in_dim, out_dim)."""
    w = _get(r, name)
    if w is None:
        return None
    if w.shape == (out_dim, in_dim):
        return np.ascontiguousarray(w.T)
    if w.shape == (in_dim, out_dim):
        return w
    raise ValueError(f"{name}: shape {w.shape} matches neither "
                     f"({out_dim},{in_dim}) nor ({in_dim},{out_dim})")


_QUANT_KINDS = {GGMLType.Q4_0: "q4_0", GGMLType.Q8_0: "q8_0"}


def _linear_maybe_quant(r: GGUFReader, name: str, in_dim: int, out_dim: int,
                        keep_quantized: bool):
    """Like _linear, but when keep_quantized and the stored type is Q4_0 /
    Q8_0 in the standard (out, in) orientation with in % 32 == 0, return
    ("quant", kind, qw, scales): the packed rows repacked to the kernel's
    wire layout (ops/quant_matmul.py)."""
    t = r.tensors.get(name)
    if t is None:
        return None
    if (keep_quantized and t.ggml_type in _QUANT_KINDS
            and t.shape == (out_dim, in_dim) and in_dim % 32 == 0):
        kind = _QUANT_KINDS[t.ggml_type]
        qw, sc = REPACK[kind](t.raw(), out_dim, in_dim)
        return ("quant", kind, qw, sc)
    return _linear(r, name, in_dim, out_dim)


def split_fused_qkv(wqkv: np.ndarray, bqkv: np.ndarray | None, cfg: ModelConfig):
    """A fused attn_qkv (in=E, out=(H+2*Hkv)*D) and its bias -> (wq, wk, wv,
    bq, bk, bv), the port of the JAX loader's _split_fused_qkv: falcon
    interleaves per kv group [q_0..q_{g-1}, k, v]; MQA/MHA and the
    fused_qkv_concat archs concatenate [Q; K; V]."""
    E = cfg.n_embd
    H, Hkv, D = cfg.n_head, cfg.n_head_kv, cfg.head_dim
    g = H // Hkv
    if wqkv.shape != (E, (H + 2 * Hkv) * D):
        raise ValueError(f"attn_qkv: shape {wqkv.shape}, want {(E, (H + 2 * Hkv) * D)}")
    if Hkv == H or cfg.traits.fused_qkv_concat:
        cuts = (H * D, (H + Hkv) * D)
        wq, wk, wv = np.split(wqkv, cuts, axis=1)
        bq, bk, bv = (None,) * 3 if bqkv is None else np.split(bqkv, cuts)
        return wq, wk, wv, bq, bk, bv
    w = wqkv.reshape(E, Hkv, g + 2, D)
    wq = np.ascontiguousarray(w[:, :, :g].reshape(E, H * D))
    wk = np.ascontiguousarray(w[:, :, g].reshape(E, Hkv * D))
    wv = np.ascontiguousarray(w[:, :, g + 1].reshape(E, Hkv * D))
    bq = bk = bv = None
    if bqkv is not None:
        b = bqkv.reshape(Hkv, g + 2, D)
        bq = np.ascontiguousarray(b[:, :g].reshape(H * D))
        bk = np.ascontiguousarray(b[:, g].reshape(Hkv * D))
        bv = np.ascontiguousarray(b[:, g + 1].reshape(Hkv * D))
    return wq, wk, wv, bq, bk, bv


def _is_quant(w) -> bool:
    return isinstance(w, tuple) and w[0] == "quant"


def _check_supported(r: GGUFReader, cfg: ModelConfig):
    check_supported(cfg)
    for name in r.tensors:
        if name.startswith("blk.") and name.split(".", 2)[2] not in _LAYER_TENSORS:
            raise NotImplementedError(f"tensor {name} is not read by the port yet")
        if name.endswith(".attn_qkv.weight") and not cfg.traits.fused_qkv:
            # openelm's upstream GGUFs fuse q/k/v a layer; the JAX package
            # reads the converter's split q/k/v only
            raise NotImplementedError(f"a fused attn_qkv ({name}) on arch {cfg.arch!r}, whose "
                                      "q/k/v the port reads split, as the JAX package does")


def _add_moe(r: GGUFReader, p: str, E: int, add):
    """A layer's MoE tensors (models/loader.py:404-445 of the JAX package),
    the expert stacks as (X, Fe, E)."""
    gi = _get(r, p + "ffn_gate_inp.weight")  # (X, E)
    if gi is None:
        return
    add("w_router", np.ascontiguousarray(gi.T))  # (E, X)
    add("w_router_b", _get(r, p + "ffn_gate_inp.bias"))
    for nm in ("up", "gate", "down"):  # gpt-oss per-expert biases, (X, Fe) and (X, E)
        add(f"w_{nm}_exps_b", _get(r, p + f"ffn_{nm}_exps.bias"))
    for kind in ("exps", "chexps"):  # grovemoe's chunk experts as the experts
        for nm in ("up", "gate", "down"):
            w = _get(r, p + f"ffn_{nm}_{kind}.weight")  # up/gate (X, Fe, E), down (X, E, Fe)
            if w is not None and nm == "down":
                w = np.ascontiguousarray(np.swapaxes(w, -1, -2))
            add(f"w_{nm}_{kind}", w)
    add("router_bias", _get(r, p + "exp_probs_b.bias"))  # selection-only bias
    # the shared expert, oriented by n_embd (its width differs from n_ff)
    for nm in ("up", "gate", "down"):
        ws = _get(r, p + f"ffn_{nm}_shexp.weight")
        if ws is not None and ws.shape[0 if nm == "down" else 1] == E:
            ws = np.ascontiguousarray(ws.T)  # to (E, Fs), down (Fs, E)
        add(f"w_{nm}_shexp", ws)
    gis = _get(r, p + "ffn_gate_inp_shexp.weight")  # (1, E): qwen2moe's shared-expert gate
    add("w_gate_inp_shexp", None if gis is None else np.ascontiguousarray(gis.reshape(-1)))


def _add_mla(r: GGUFReader, p: str, cfg: ModelConfig, lin, add):
    """A layer's MLA tensors (models/loader.py:310-333 of the JAX package):
    the q projection or the q-lora, the latent projection and its norm, and
    attn_kv_b split into the key and value decompressors wk_b (R, H, Dn) and
    wv_b (R, H, Dv)."""
    E, H, Dk, R, Dr = cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.kv_lora_rank, cfg.rope_dim
    Dn, Dv = Dk - Dr, cfg.v_head_dim or Dk
    if cfg.q_lora_rank > 0:
        add("wq_a", lin(p + "attn_q_a.weight", E, cfg.q_lora_rank))
        add("q_a_norm_w", _get(r, p + "attn_q_a_norm.weight"))
        add("wq_b", lin(p + "attn_q_b.weight", cfg.q_lora_rank, H * Dk))
    else:
        add("wq", lin(p + "attn_q.weight", E, H * Dk))
    add("wkv_a", lin(p + "attn_kv_a_mqa.weight", E, R + Dr))
    add("kv_a_norm_w", _get(r, p + "attn_kv_a_norm.weight"))
    wb = _linear(r, p + "attn_kv_b.weight", R, H * (Dn + Dv)).reshape(R, H, Dn + Dv)
    add("wk_b", np.ascontiguousarray(wb[:, :, :Dn]))
    add("wv_b", np.ascontiguousarray(wb[:, :, Dn:]))


def load_model(path: str, dtype=torch.bfloat16, device=None,
               keep_quantized: bool = False, attn_w8a8: bool = False) -> LoadedModel:
    """Load a llama-family GGUF into stacked torch tensors on `device`
    (None: the card; pass "cpu" to load on the CPU). keep_quantized=True
    keeps Q4_0/Q8_0 linears packed (QuantTensor) instead of dequantizing;
    attn_w8a8=True makes the dense attention projections W8A8Tensors."""
    device = resolve_device(device)
    r = GGUFReader(path)
    try:
        cfg = ModelConfig.from_gguf(r)
        _check_supported(r, cfg)
        params = _load_params(r, cfg, dtype, device, keep_quantized, attn_w8a8)
        vocab = None
        if "tokenizer.ggml.tokens" in r.kv:
            from ..tokenizer import Vocab

            vocab = Vocab.from_gguf(r)
    finally:
        r.close()
    return LoadedModel(config=cfg, params=params, vocab=vocab)


_ATTN = ("wq", "wk", "wv", "wo")


def layer_widths(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """(H_i, Hkv_i, F_i) of each layer: the per-layer head counts and FFN
    widths of a NAS stack (deci, openelm; H_i == 0 an attention-free layer),
    else the model's own."""
    return [(cfg.n_head_arr[i] if cfg.n_head_arr else cfg.n_head,
             cfg.n_head_kv_arr[i] if cfg.n_head_kv_arr else cfg.n_head_kv,
             cfg.n_ff_arr[i] if cfg.n_ff_arr else cfg.n_ff) for i in range(cfg.n_layer)]


def layer_runs(r: GGUFReader, widths: list[tuple]) -> list[tuple[int, int]]:
    """Contiguous runs [start, end) of layers with the same tensor names and
    the same widths (layer_widths): the JAX loader's layer segments (one run
    where every layer is alike). The JAX loader splits on names alone, so it
    cannot stack a run whose widths differ (openelm's layers); the port
    stacks each width on its own."""
    L = len(widths)
    sigs = [{widths[i]} for i in range(L)]
    for name in r.tensors:
        if name.startswith("blk."):
            _, i, rest = name.split(".", 2)
            sigs[int(i)].add(rest)
    runs, start = [], 0
    for i in range(1, L + 1):
        if i == L or sigs[i] != sigs[start]:
            runs.append((start, i))
            start = i
    return runs
# a reranker's classification head: GGUF name -> key
_CLS_TENSORS = {"cls.weight": "cls_w", "cls.bias": "cls_b",
                "cls.output.weight": "cls_out_w", "cls.output.bias": "cls_out_b"}


def _load_params(r: GGUFReader, cfg: ModelConfig, dtype, device,
                 keep_quantized: bool, attn_w8a8: bool = False) -> Params:
    E, H, Hkv, D, F, L = (cfg.n_embd, cfg.n_head, cfg.n_head_kv, cfg.head_dim,
                          cfg.n_ff, cfg.n_layer)
    f32, tr = torch.float32, cfg.traits
    kq = keep_quantized and not tr.fused_qkv  # a fused QKV must split: dense

    def _lin(name, in_dim, out_dim):
        return _linear_maybe_quant(r, name, in_dim, out_dim, kq)

    tok = _get(r, "token_embd.weight")
    params: Params = {"tok_embd": _tensor(tok, dtype, device)}
    for nm, key in (("token_embd_norm.weight", "tok_norm_w"),  # bloom's embedding LayerNorm
                    ("token_embd_norm.bias", "tok_norm_b")):
        w = _get(r, nm)
        if w is not None:
            params[key] = _tensor(w, f32, device)
    if tr.pos_embd:
        params["pos_embd"] = _tensor(_get(r, "position_embd.weight"), dtype, device)
    tte = _get(r, "token_types.weight")  # bert's segment embeddings
    if tte is not None:
        params["type_embd"] = _tensor(tte, dtype, device)
    onw = _get(r, "output_norm.weight")
    if onw is None and not tr.post_norm:
        onw = np.ones(E, np.float32)  # olmo's non-parametric final norm
    if onw is not None:  # a post-sum encoder (bert) has none: its last block normed the stream
        params["output_norm_w"] = _tensor(onw, f32, device)
        onb = _get(r, "output_norm.bias")
        if onb is not None:
            params["output_norm_b"] = _tensor(onb, f32, device)
    out_w = _lin("output.weight", E, cfg.n_vocab)
    if out_w is None:
        out_w = np.ascontiguousarray(tok.T)  # tied embeddings
    params["output"] = (QuantTensor.from_repack(out_w[2], out_w[3], out_w[1], device)
                        if _is_quant(out_w) else _tensor(out_w, dtype, device))
    ob = _get(r, "output.bias")  # gptj's and phi2's head bias
    if ob is not None:
        params["output_b"] = _tensor(ob, f32, device)
    for nm, key in _CLS_TENSORS.items():  # rank pooling's head
        w = _get(r, nm)
        if w is not None:
            params[key] = _tensor(w, f32, device)

    max_rank = cfg.max_pred_rank
    widths = layer_widths(cfg)
    runs = layer_runs(r, widths)
    if len(runs) > 1 and cfg.has_predictors:
        raise NotImplementedError("predictors over layer segments (layers whose tensors "
                                  "differ) are not ported yet")
    stacks: list[dict] = [{} for _ in runs]
    where = {i: (si, i - s) for si, (s, e) in enumerate(runs) for i in range(s, e)}

    def add(i: int, key: str, arr):
        si, j = where[i]  # layer i is layer j of its run's stacks
        layers, n = stacks[si], runs[si][1] - runs[si][0]
        w8 = attn_w8a8 and key in _ATTN and arr is not None and not _is_quant(arr)
        if arr is None:
            if key in layers:
                raise ValueError(f"{key} missing in layer {i}, not in the others of its run")
            return
        if key not in layers:
            if j > 0:
                raise ValueError(f"{key} missing before layer {i} of its run")
            if w8:
                layers[key] = W8A8Tensor.empty((n,) + arr.shape, device)
            elif _is_quant(arr):
                _, kind, qw, sc = arr
                layers[key] = QuantTensor(
                    torch.empty((n,) + qw.shape[::-1], dtype=_host(qw).dtype, device=device),
                    torch.empty((n,) + sc.shape[::-1], dtype=f32, device=device), kind)
            else:
                want = (f32 if ("norm" in key or key.startswith(("b", "xielu"))
                                or key in ("router_bias", "attn_sinks")) else dtype)
                layers[key] = torch.empty((n,) + arr.shape, dtype=want, device=device)
        dst = layers[key]
        if isinstance(dst, QuantTensor) != _is_quant(arr) or (
                _is_quant(arr) and arr[1] != dst.kind):
            raise ValueError(f"{key}: mixed quant kinds across layers")
        if w8:  # quantized on the device from the weight in the model's dtype
            dst[j] = W8A8Tensor.from_float(_tensor(arr, dtype, device))
        elif _is_quant(arr):  # to the device, then transposed there to IN-major
            dst.q[j].copy_(_host(arr[2]).to(device).T)
            dst.s[j].copy_(_host(arr[3]).to(device).T)
        else:
            dst[j].copy_(_host(arr))

    for i in range(L):
        p = f"blk.{i}."
        H_i, Hkv_i, F_i = widths[i]
        # bert's post-sum norms ride the attn_norm and ffn_norm slots
        attn_n, ffn_n = (("attn_output_norm", "layer_output_norm") if tr.post_norm
                         else ("attn_norm", "ffn_norm"))
        anw = _get(r, p + attn_n + ".weight")
        if anw is None and not tr.post_norm and p + "attn_post_norm.weight" not in r.tensors:
            anw = np.ones(E, np.float32)  # olmo's non-parametric norm; olmo2 has none
        add(i, "attn_norm_w", anw)
        add(i, "attn_norm_b", _get(r, p + attn_n + ".bias"))
        add(i, "attn_norm2_w", _get(r, p + "attn_norm_2.weight"))
        add(i, "attn_norm2_b", _get(r, p + "attn_norm_2.bias"))
        if cfg.kv_lora_rank > 0:  # deepseek2's MLA: latent projections replace wk/wv
            _add_mla(r, p, cfg, _lin, lambda key, arr: add(i, key, arr))
            qkv = ()  # _add_mla added the q projection
        elif tr.fused_qkv:
            qkv = split_fused_qkv(_linear(r, p + "attn_qkv.weight", E, (H + 2 * Hkv) * D),
                                  _get(r, p + "attn_qkv.bias"), cfg)
        else:
            qkv = (_lin(p + "attn_q.weight", E, H_i * D),
                   _lin(p + "attn_k.weight", E, Hkv_i * D),
                   _lin(p + "attn_v.weight", E, Hkv_i * D),
                   *(_get(r, p + f"attn_{nm}.bias") for nm in "qkv"))
        for key, arr in zip(("wq", "wk", "wv", "bq", "bk", "bv"), qkv):
            add(i, key, arr)
        # q/k norms: per head, full width or (H, D) affine, with their biases
        for nm in ("q", "k"):
            add(i, f"attn_{nm}_norm_w", _get(r, p + f"attn_{nm}_norm.weight"))
            add(i, f"attn_{nm}_norm_b", _get(r, p + f"attn_{nm}_norm.bias"))
        add(i, "attn_sinks", _get(r, p + "attn_sinks.weight"))  # gpt-oss: a logit a head
        add(i, "wo", _lin(p + "attn_output.weight", H * (cfg.v_head_dim or D)
                          if cfg.kv_lora_rank > 0 else H_i * D, E))
        add(i, "bo", _get(r, p + "attn_output.bias"))
        for nm in ("attn", "ffn"):  # bitnet's sub-norms
            add(i, f"{nm}_sub_norm_w", _get(r, p + f"{nm}_sub_norm.weight"))
        if cfg.xielu_alpha_p:  # apertus's xIELU coefficients, through softplus here
            b = cfg.xielu_beta[i] if cfg.xielu_beta else 0.5
            add(i, "xielu_ap", np.logaddexp(0.0, np.float32(cfg.xielu_alpha_p[i]))[None]
                .astype(np.float32))
            add(i, "xielu_an", (b + np.logaddexp(0.0, np.float32(cfg.xielu_alpha_n[i])))[None]
                .astype(np.float32))
            add(i, "xielu_beta", np.asarray([b], np.float32))
            add(i, "xielu_eps", np.asarray([cfg.xielu_eps[i] if cfg.xielu_eps else -1e-6],
                                           np.float32))
        # sandwich post-norms (gemma, glm4), after attention and after the FFN
        for nm in ("attn", "ffn"):
            add(i, f"{nm}_post_norm_w", _get(r, p + f"{nm}_post_norm.weight"))
            add(i, f"{nm}_post_norm_b", _get(r, p + f"{nm}_post_norm.bias"))
        fnw = _get(r, p + ffn_n + ".weight")
        if (fnw is None and not tr.parallel_blocks and not tr.post_norm
                and p + "ffn_post_norm.weight" not in r.tensors):
            fnw = np.ones(E, np.float32)  # a non-parametric norm (not olmo2's post-norm)
        add(i, "ffn_norm_w", fnw)
        add(i, "ffn_norm_b", _get(r, p + ffn_n + ".bias"))
        add(i, "ffn_norm_exps_w", _get(r, p + "ffn_norm_exps.weight"))  # arctic's MoE norm
        _add_moe(r, p, E, lambda key, arr: add(i, key, arr))
        add(i, "w_up", _lin(p + "ffn_up.weight", E, F_i))
        add(i, "b_up", _get(r, p + "ffn_up.bias"))
        add(i, "w_gate", _lin(p + "ffn_gate.weight", E, F_i))
        # ffn_down: sparse GGUFs store it transposed; _linear canonicalizes
        add(i, "w_down", _lin(p + "ffn_down.weight", F_i, E))
        add(i, "b_down", _get(r, p + "ffn_down.bias"))
        # predictor (low-rank ReLU MLP), zero-padded to the max rank
        pu = _linear(r, p + "ffn_pred_up.weight", E,
                     cfg.pred_lora[i] if cfg.pred_lora else 0)
        if pu is not None:
            rank = pu.shape[1]
            pub = _get(r, p + "ffn_pred_up.bias")
            pd = _linear(r, p + "ffn_pred_down.weight", rank, F)
            pdb = _get(r, p + "ffn_pred_down.bias")
            if rank < max_rank:
                pu = np.pad(pu, ((0, 0), (0, max_rank - rank)))
                pd = np.pad(pd, ((0, max_rank - rank), (0, 0)))
                if pub is not None:
                    pub = np.pad(pub, (0, max_rank - rank))
            add(i, "pred_up", pu)
            add(i, "pred_up_b", pub if pub is not None else np.zeros(max_rank, np.float32))
            add(i, "pred_down", pd)
            add(i, "pred_down_b", pdb if pdb is not None else np.zeros(F, np.float32))
    params["layers"] = stacks[0]
    if len(stacks) > 1:
        params["layer_segments"] = stacks
    return params
