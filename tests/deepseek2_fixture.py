"""A tiny deepseek2 GGUF for the port's tests, written with the port's own
GGUF writer (no JAX): the CPU parity tests and the card's graph tests share
it. 3 layers (1 leading dense, 2 MoE), E=64, 4 heads, 4 experts of width 48
with 2 used, softmax gating without top-k renormalization, a routed scale of
1.5, one shared expert; kv_lora_rank R=32, rope head Dr=8, Dn=16, Dv=16."""

import numpy as np

from sparkinfer_tpu_torch.gguf.writer import GGUFWriter

E, H, R, DN, DR, DV, F, X, K, FE, V = 64, 4, 32, 16, 8, 16, 96, 4, 2, 48, 199


def make_deepseek2(path, *, q_lora=0, yarn=False, n_layer=3, n_dense=1, seed=0,
                   n_vocab=V, with_vocab=False):
    """Write a tiny deepseek2 GGUF in llama.cpp's layout (weights (out, in),
    expert stacks (X, Fe, E) for up and gate and (X, E, Fe) for down, the
    shared expert's tensors n_shared * Fe wide)."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    Dk, a = DN + DR, "deepseek2"
    wr = GGUFWriter(str(path), a)
    if with_vocab:  # the families tests' SPM vocabulary (a CPU test's import)
        from test_torch_families import _spm_vocab

        _spm_vocab(wr, n_vocab)
    for key, val in (("block_count", n_layer), ("embedding_length", E),
                     ("attention.head_count", H), ("attention.head_count_kv", 1),
                     ("feed_forward_length", F), ("vocab_size", n_vocab), ("context_length", 128),
                     ("attention.key_length", Dk), ("attention.value_length", DV),
                     ("rope.dimension_count", DR), ("attention.kv_lora_rank", R),
                     ("leading_dense_block_count", n_dense), ("expert_count", X),
                     ("expert_used_count", K), ("expert_feed_forward_length", FE),
                     ("expert_shared_count", 1), ("expert_gating_func", 1)):
        wr.add_kv(f"{a}.{key}", np.uint32(val))
    if q_lora:
        wr.add_kv(f"{a}.attention.q_lora_rank", np.uint32(q_lora))
    wr.add_kv(f"{a}.expert_weights_scale", np.float32(1.5))
    wr.add_kv(f"{a}.expert_weights_norm", False)
    wr.add_kv(f"{a}.attention.layer_norm_rms_epsilon", np.float32(1e-6))
    wr.add_kv(f"{a}.rope.freq_base", np.float32(10000.0))
    if yarn:  # V2-Lite's factor; an original context the tiny prompts pass
        wr.add_kv(f"{a}.rope.scaling.type", "yarn")
        wr.add_kv(f"{a}.rope.scaling.factor", np.float32(40.0))
        wr.add_kv(f"{a}.rope.scaling.original_context_length", np.uint32(16))
    t = {"token_embd.weight": w(n_vocab, E), "output_norm.weight": 1.0 + w(E, s=0.01),
         "output.weight": w(n_vocab, E)}
    for i in range(n_layer):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = 1.0 + w(E, s=0.01)
        if q_lora:
            t[p + "attn_q_a.weight"] = w(q_lora, E)
            t[p + "attn_q_a_norm.weight"] = 1.0 + w(q_lora, s=0.01)
            t[p + "attn_q_b.weight"] = w(H * Dk, q_lora)
        else:
            t[p + "attn_q.weight"] = w(H * Dk, E)
        t[p + "attn_kv_a_mqa.weight"] = w(R + DR, E)
        t[p + "attn_kv_a_norm.weight"] = 1.0 + w(R, s=0.01)
        t[p + "attn_kv_b.weight"] = w(H * (DN + DV), R)
        t[p + "attn_output.weight"] = w(E, H * DV)
        t[p + "ffn_norm.weight"] = 1.0 + w(E, s=0.01)
        if i < n_dense:
            t[p + "ffn_up.weight"] = w(F, E)
            t[p + "ffn_gate.weight"] = w(F, E)
            t[p + "ffn_down.weight"] = w(E, F)
        else:
            t[p + "ffn_gate_inp.weight"] = w(X, E, s=0.3)
            t[p + "ffn_up_exps.weight"] = w(X, FE, E)
            t[p + "ffn_gate_exps.weight"] = w(X, FE, E)
            t[p + "ffn_down_exps.weight"] = w(X, E, FE)
            t[p + "ffn_up_shexp.weight"] = w(FE, E)
            t[p + "ffn_gate_shexp.weight"] = w(FE, E)
            t[p + "ffn_down_shexp.weight"] = w(E, FE)
    for name, data in t.items():
        wr.add_tensor(name, data)
    wr.write()


def make_mla_arch(path, arch, *, n_layer=2, seed=0, n_vocab=160, q_lora=24, scales=False,
                  rope_factors=False, with_vocab=False):
    """Write a tiny minicpm3 (the q-lora, a gated silu FFN) or plm (a direct
    q, an ungated relu² FFN) GGUF in llama.cpp's layout, no experts: E=64,
    4 heads, R=32, Dr=8, Dn=16, Dv=16, F=96. scales=True adds the
    embedding, residual and logit multipliers as GGUF keys (MiniCPM3's
    12, 1.4/sqrt(L) and 256/E); rope_factors=True adds the
    rope_factors_long/short tensors llama.cpp's converter writes for
    minicpm3, which both loaders leave unread."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    Dk, qr = DN + DR, q_lora if arch == "minicpm3" else 0
    wr = GGUFWriter(str(path), arch)
    if with_vocab:
        from test_torch_families import _spm_vocab

        _spm_vocab(wr, n_vocab)
    for key, val in (("block_count", n_layer), ("embedding_length", E),
                     ("attention.head_count", H), ("attention.head_count_kv", H),
                     ("feed_forward_length", F), ("vocab_size", n_vocab), ("context_length", 128),
                     ("attention.key_length", Dk), ("attention.value_length", DV),
                     ("rope.dimension_count", DR), ("attention.q_lora_rank", qr),
                     ("attention.kv_lora_rank", R)):
        wr.add_kv(f"{arch}.{key}", np.uint32(val))
    wr.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    wr.add_kv(f"{arch}.rope.freq_base", np.float32(10000.0))
    if scales:
        wr.add_kv(f"{arch}.embedding_scale", np.float32(12.0))
        wr.add_kv(f"{arch}.residual_scale", np.float32(1.4 / n_layer ** 0.5))
        wr.add_kv(f"{arch}.logit_scale", np.float32(256.0 / E))
    t = {"token_embd.weight": w(n_vocab, E), "output_norm.weight": 1.0 + 0.1 * w(E),
         "output.weight": w(n_vocab, E)}
    if rope_factors:
        t["rope_factors_long.weight"] = 1.0 + np.abs(w(DR // 2))
        t["rope_factors_short.weight"] = 1.0 + np.abs(w(DR // 2))
    for i in range(n_layer):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = 1.0 + 0.1 * w(E)
        if qr:
            t[p + "attn_q_a.weight"] = w(qr, E)
            t[p + "attn_q_a_norm.weight"] = 1.0 + 0.1 * w(qr)
            t[p + "attn_q_b.weight"] = w(H * Dk, qr)
        else:
            t[p + "attn_q.weight"] = w(H * Dk, E)
        t[p + "attn_kv_a_mqa.weight"] = w(R + DR, E)
        t[p + "attn_kv_a_norm.weight"] = 1.0 + 0.1 * w(R)
        t[p + "attn_kv_b.weight"] = w(H * (DN + DV), R)
        t[p + "attn_output.weight"] = w(E, H * DV)
        t[p + "ffn_norm.weight"] = 1.0 + 0.1 * w(E)
        t[p + "ffn_up.weight"] = w(F, E)
        if arch != "plm":  # plm: ungated relu²
            t[p + "ffn_gate.weight"] = w(F, E)
        t[p + "ffn_down.weight"] = w(E, F)
    for name, data in t.items():
        wr.add_tensor(name, data)
    wr.write()
