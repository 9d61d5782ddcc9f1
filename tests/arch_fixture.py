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

`make_feature` writes the kinds of FEATURES for the decoders with features
of their own: olmo2's post-norm-only blocks, apertus's xIELU, bitnet's
sub-norms, and the NAS stacks of deci and openelm (per-layer head counts
and FFN widths, deci's attention-free layer).

The trait kinds (TRAIT_KINDS), the decoders of traits the port has:
  granite: the fault-7 multipliers (embedding, residual, attention and
  logit scales);
  minicpm: embedding, residual and logit scales;
  pangu-embedded: q/k/v and output biases, neox rope;
  plamo: the parallel block under one RMS pre-norm, neox rope;
  starcoder2: LayerNorm with biases, q/k/v, output and FFN biases, the
  ungated gelu;
  command-r: the parallel block under one bias-less LayerNorm, logit_scale
  (make_tiny_llama writes an ffn_norm and an ffn_gate a layer, which the
  parallel blocks and the ungated FFN leave unread, in both packages);
  phi3: q/k/v and gate/up as the JAX converter splits them.

`make_encoder` writes the non-causal encoders (ENCODER_KINDS): bert
(learned positions, token types, the embedding LayerNorm, the post-sum
LayerNorms attn_output_norm and layer_output_norm with biases, q/k/v,
output and FFN biases, the erf gelu, no final norm, a tied head; with
`with_vocab` a WordPiece vocabulary, with `cls_head` a reranker's
cls/cls.output head), neo-bert (RMS pre-norms, rope, swiglu) and
gemma-embedding (per-head q/k norms, sandwich post-norms, a sliding window
of 8 over 6 layers, the last full).
"""

import numpy as np

from model_fixtures import make_tiny_llama

E, H, HKV, D, FE, FS, X, K = 64, 4, 2, 16, 48, 64, 4, 2

PLAIN = ("smollm", "tinyllama", "internlm2", "xverse", "baichuan", "exaone")
KINDS = PLAIN + ("orion", "stablelm-heads", "stablelm-width", "clamped", "hunyuan-dense")
MOE_KINDS = ("qwen2moe", "hunyuan-moe", "smallthinker", "grovemoe", "arctic")
GPT_KINDS = ("refact", "jais", "codeshell", "qwen", "bloom")
TRAIT_KINDS = ("granite", "minicpm", "pangu-embedded", "plamo", "starcoder2", "command-r",
               "phi3")
ENCODER_KINDS = ("bert", "neo-bert", "gemma-embedding")
# bert's WordPiece pieces past its five specials ([PAD] [UNK] [CLS] [SEP] [MASK])
WPM_PIECES = ("hello", "world", "the", "a", "query", "doc", "##s", "##ing", "##ed", "do",
              "##n", "'", "t", "!", ".", "what", "is", "rerank", "##er", "embed", "##ding",
              "text", "one", "two", "three", "?", ",")


def _spec(kind: str, rng) -> tuple[str, dict]:
    """(arch, make_tiny_llama keywords) of one fixture kind."""

    def w(*shape, s=0.08, shift=0.0):
        return (shift + s * rng.standard_normal(shape)).astype(np.float32)

    def per_layer(make):
        out = {}
        for i in range(2):
            out.update({f"blk.{i}.{k}": v for k, v in make().items()})
        return out

    if kind in PLAIN or kind in ("refact", "phi3", "neo-bert"):
        return kind, {}
    if kind == "granite":
        return kind, {"extra_kv": {"granite.embedding_scale": np.float32(12.0),
                                   "granite.residual_scale": np.float32(0.22),
                                   "granite.attention.scale": np.float32(0.015625),
                                   "granite.logit_scale": np.float32(1 / 8)}}
    if kind == "minicpm":  # scale_emb 12, scale_depth 1.4 / sqrt(2), 1 / (E / 32)
        return kind, {"extra_kv": {"minicpm.embedding_scale": np.float32(12.0),
                                   "minicpm.residual_scale": np.float32(1.4 / np.sqrt(2)),
                                   "minicpm.logit_scale": np.float32(0.5)}}
    if kind == "pangu-embedded":
        return kind, {"extra_tensors": per_layer(lambda: {
            "attn_q.bias": w(H * D), "attn_k.bias": w(HKV * D), "attn_v.bias": w(HKV * D),
            "attn_output.bias": w(E)})}
    if kind == "plamo":
        return kind, {}
    if kind == "command-r":
        return kind, {"extra_kv": {"command-r.logit_scale": np.float32(0.0625)}}
    if kind == "starcoder2":
        t = per_layer(lambda: {
            "attn_norm.bias": w(E, s=0.1), "ffn_norm.bias": w(E, s=0.1),
            "attn_q.bias": w(H * D), "attn_k.bias": w(HKV * D), "attn_v.bias": w(HKV * D),
            "attn_output.bias": w(E), "ffn_up.bias": w(96), "ffn_down.bias": w(E)})
        t["output_norm.bias"] = w(E, s=0.1)
        return kind, {"extra_tensors": t}
    if kind == "gemma-embedding":
        def layer():
            return {"attn_q_norm.weight": w(D, s=0.1, shift=1.0),
                    "attn_k_norm.weight": w(D, s=0.1, shift=1.0),
                    "attn_post_norm.weight": w(E, s=0.1, shift=1.0),
                    "ffn_post_norm.weight": w(E, s=0.1, shift=1.0)}

        t = {}
        for i in range(6):
            t.update({f"blk.{i}.{k}": v for k, v in layer().items()})
        return kind, {"n_layer": 6, "extra_tensors": t,
                      "extra_kv": {"gemma-embedding.attention.sliding_window": np.uint32(8)}}
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


# the feature kinds: name -> (arch, per-layer head counts, KV head counts,
# FFN widths); make_feature writes each
FEATURES = {"olmo2": ("olmo2", (4, 4), (2, 2), (96, 96)),
            "apertus": ("apertus", (4, 4), (2, 2), (96, 96)),
            "bitnet": ("bitnet", (4, 4), (2, 2), (96, 96)),
            # an attention-free layer between layers of 2 and 1 KV heads
            "deci": ("deci", (4, 0, 4), (2, 0, 1), (96, 48, 96)),
            "openelm": ("openelm", (4, 4, 4), (2, 2, 2), (96, 96, 96)),
            # widths that change between layers of the same tensors
            "openelm-widths": ("openelm", (4, 4, 2), (2, 2, 1), (96, 96, 64))}


def make_feature(path, kind: str, seed: int = 0, quant_type: str | None = None,
                 n_vocab: int = 199) -> str:
    """Write the feature kind `kind` (FEATURES) at E=64, head_dim 16; norms
    1 + N(0, 0.1) (biases N(0, 0.1)), weights N(0, 0.08), Q8_0 with
    quant_type "q8_0"; returns its GGUF arch.

      olmo2: post-norms only (attn_post_norm, ffn_post_norm, no pre-norms)
      and full-width q/k RMS norms (H*D and Hkv*D wide);
      apertus: an ungated xIELU FFN with per-layer coefficients
      (xielu_alpha_p, xielu_alpha_n, xielu_beta, xielu_eps) and per-head q/k
      norms;
      bitnet: relu2_glu with both sub-norms (attn_sub_norm H*D wide,
      ffn_sub_norm F wide) and a tied head;
      deci, openelm, openelm-widths: the NAS stacks, whose head counts, KV
      head counts and FFN widths are per-layer arrays (a layer of 0 heads is
      deci's attention-free layer, with no attention tensors); openelm's
      layers carry per-head q/k RMS norms and its head is tied."""
    from sparkinfer_tpu_torch.gguf.constants import GGMLType
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    arch, heads, kvs, ffs = FEATURES[kind]
    rng = np.random.default_rng(2000 + seed)

    def w(*shape, s=0.08, shift=0.0):
        return (shift + s * rng.standard_normal(shape)).astype(np.float32)

    L, f32 = len(heads), GGMLType.F32
    qt = GGMLType.Q8_0 if quant_type == "q8_0" else f32
    nas = arch in ("deci", "openelm")
    wr = GGUFWriter(str(path), arch)
    for k, v in (("block_count", L), ("embedding_length", E), ("vocab_size", n_vocab),
                 ("context_length", 256), ("attention.key_length", D),
                 ("rope.dimension_count", D)):
        wr.add_kv(f"{arch}.{k}", np.uint32(v))
    for k, v in (("attention.head_count", heads), ("attention.head_count_kv", kvs),
                 ("feed_forward_length", ffs)):
        if nas:
            wr.add_array(f"{arch}.{k}", np.asarray(v, np.uint32))
        else:
            wr.add_kv(f"{arch}.{k}", np.uint32(v[0]))
    wr.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    wr.add_kv(f"{arch}.rope.freq_base", np.float32(10000.0))
    if arch == "apertus":  # raw coefficients: the loader applies softplus
        for k, v in (("xielu_alpha_p", w(L, s=0.5, shift=0.8)),
                     ("xielu_alpha_n", w(L, s=0.5, shift=0.3)),
                     ("xielu_beta", w(L, s=0.1, shift=0.5)), ("xielu_eps", w(L, s=1e-4))):
            wr.add_array(f"{arch}.{k}", v)

    def lin(name, *shape):
        wr.add_tensor(name, w(*shape), qt)

    def norm(name, *shape):
        wr.add_tensor(name, w(*shape, s=0.1, shift=1.0), f32)

    wr.add_tensor("token_embd.weight", w(n_vocab, E), f32)
    norm("output_norm.weight", E)
    if arch not in ("openelm", "bitnet"):  # openelm and bitnet tie their heads
        lin("output.weight", n_vocab, E)
    for i in range(L):
        p = f"blk.{i}."
        if arch != "olmo2":
            norm(p + "attn_norm.weight", E)
            norm(p + "ffn_norm.weight", E)
        if heads[i]:
            lin(p + "attn_q.weight", heads[i] * D, E)
            lin(p + "attn_k.weight", kvs[i] * D, E)
            lin(p + "attn_v.weight", kvs[i] * D, E)
            lin(p + "attn_output.weight", E, heads[i] * D)
        if arch in ("openelm", "apertus"):
            norm(p + "attn_q_norm.weight", D)
            norm(p + "attn_k_norm.weight", D)
        if arch == "olmo2":
            norm(p + "attn_q_norm.weight", heads[i] * D)
            norm(p + "attn_k_norm.weight", kvs[i] * D)
            norm(p + "attn_post_norm.weight", E)
            norm(p + "ffn_post_norm.weight", E)
        if arch == "bitnet":
            norm(p + "attn_sub_norm.weight", heads[i] * D)
            norm(p + "ffn_sub_norm.weight", ffs[i])
        lin(p + "ffn_up.weight", ffs[i], E)
        if arch != "apertus":
            lin(p + "ffn_gate.weight", ffs[i], E)
        lin(p + "ffn_down.weight", E, ffs[i])
    wr.write()
    return arch


def make_arch(path, kind: str, seed: int = 0, **kw) -> str:
    """Write the fixture `kind` to path; returns its GGUF arch."""
    arch, spec = _spec(kind, np.random.default_rng(1000 + seed))
    make_tiny_llama(path, arch=arch, seed=seed, **{**spec, **kw})
    return arch


def make_encoder(path, kind: str, seed: int = 0, quant_type: str | None = None,
                 with_vocab: bool = False, cls_head: bool = False, n_layer: int = 2,
                 n_pos: int = 64) -> str:
    """Write the encoder kind `kind` (ENCODER_KINDS); returns its arch.
    neo-bert and gemma-embedding through make_arch; bert here at E=64, 4
    heads of 16, F=96, n_pos learned positions, 2 token types: weights
    N(0, 0.08), biases and embeddings N(0, 0.05), LayerNorm weights
    1 + N(0, 0.1) and biases N(0, 0.1), eps 1e-12, Q8_0 linears with
    quant_type "q8_0"; a WordPiece vocabulary of the specials and
    WPM_PIECES ([CLS] the bos, [SEP] the eos and separator, both added)
    padded with unused pieces to 120, else a vocabulary size of 120 alone."""
    if kind != "bert":
        return make_arch(path, kind, seed=seed, **({"quant_type": quant_type}
                                                   if quant_type else {}))
    from sparkinfer_tpu_torch.gguf.constants import GGMLType
    from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(3000 + seed)
    V, F, f32 = 120, 96, GGMLType.F32
    qt = GGMLType.Q8_0 if quant_type == "q8_0" else f32

    def w(*shape, s=0.08, shift=0.0):
        return (shift + s * rng.standard_normal(shape)).astype(np.float32)

    wr = GGUFWriter(str(path), "bert")
    for k, v in (("block_count", n_layer), ("embedding_length", E), ("vocab_size", V),
                 ("context_length", n_pos), ("attention.head_count", H),
                 ("feed_forward_length", F)):
        wr.add_kv(f"bert.{k}", np.uint32(v))
    wr.add_kv("bert.attention.layer_norm_epsilon", np.float32(1e-12))
    if with_vocab:
        tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WPM_PIECES]
        tokens += [f"[unused{i}]" for i in range(V - len(tokens))]
        types = np.ones(V, np.int32)  # NORMAL
        types[[0, 2, 3, 4]] = 3  # CONTROL
        types[1] = 2  # UNKNOWN
        wr.add_kv("tokenizer.ggml.model", "bert")
        wr.add_array("tokenizer.ggml.tokens", tokens)
        wr.add_array("tokenizer.ggml.token_type", types)
        for k, v in (("bos_token_id", 2), ("eos_token_id", 3), ("unknown_token_id", 1),
                     ("seperator_token_id", 3), ("padding_token_id", 0)):
            wr.add_kv(f"tokenizer.ggml.{k}", np.uint32(v))
        wr.add_kv("tokenizer.ggml.add_bos_token", True)
        wr.add_kv("tokenizer.ggml.add_eos_token", True)

    def norm(name):
        wr.add_tensor(name + ".weight", w(E, s=0.1, shift=1.0), f32)
        wr.add_tensor(name + ".bias", w(E, s=0.1), f32)

    def lin(name, out_dim, in_dim):
        wr.add_tensor(name + ".weight", w(out_dim, in_dim), qt)
        wr.add_tensor(name + ".bias", w(out_dim, s=0.05), f32)

    wr.add_tensor("token_embd.weight", w(V, E, s=0.05), f32)
    wr.add_tensor("token_types.weight", w(2, E, s=0.05), f32)
    wr.add_tensor("position_embd.weight", w(n_pos, E, s=0.05), f32)
    norm("token_embd_norm")
    for i in range(n_layer):
        p = f"blk.{i}."
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            lin(p + nm, E, E)
        norm(p + "attn_output_norm")
        lin(p + "ffn_up", F, E)
        lin(p + "ffn_down", E, F)
        norm(p + "layer_output_norm")
    if cls_head:
        wr.add_tensor("cls.weight", w(E, E, s=0.2), f32)
        wr.add_tensor("cls.bias", w(E, s=0.1), f32)
        wr.add_tensor("cls.output.weight", w(1, E, s=0.5), f32)
        wr.add_tensor("cls.output.bias", np.array([0.25], np.float32), f32)
    wr.write()
    return "bert"
