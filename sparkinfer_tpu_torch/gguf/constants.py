"""GGUF / GGML format constants.

Format-compatibility constants matching the GGUF v3 specification and the
ggml type enum (ref: ggml/include/ggml.h:385-425, ggml/src/gguf.cpp).
These are wire-format facts, not code: both sides of the container must
agree on them byte-for-byte.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor data types (ref: ggml/include/ggml.h:385-425)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


# (block_size_elems, bytes_per_block) per type — ggml's type traits table.
GGML_TYPE_TRAITS: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 2 + 16),
    GGMLType.Q4_1: (32, 2 + 2 + 16),
    GGMLType.Q5_0: (32, 2 + 4 + 16),
    GGMLType.Q5_1: (32, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: (32, 2 + 32),
    GGMLType.Q8_1: (32, 2 + 2 + 32),
    GGMLType.Q2_K: (256, 2 + 2 + 16 + 64),
    GGMLType.Q3_K: (256, 32 + 64 + 12 + 2),
    GGMLType.Q4_K: (256, 2 + 2 + 12 + 128),
    GGMLType.Q5_K: (256, 2 + 2 + 12 + 32 + 128),
    GGMLType.Q6_K: (256, 128 + 64 + 16 + 2),
    GGMLType.Q8_K: (256, 4 + 256 + 16 * 2),
    GGMLType.IQ2_XXS: (256, 2 + 64),
    GGMLType.IQ2_XS: (256, 2 + 64 + 8),
    GGMLType.IQ2_S: (256, 2 + 32 + 32 + 8 + 8),
    GGMLType.IQ3_XXS: (256, 2 + 96),
    GGMLType.IQ3_S: (256, 2 + 64 + 32 + 8 + 4),
    GGMLType.IQ1_S: (256, 2 + 32 + 16),
    GGMLType.IQ1_M: (256, 32 + 16 + 8),
    GGMLType.IQ4_NL: (32, 2 + 16),
    GGMLType.IQ4_XS: (256, 2 + 2 + 4 + 128),
    GGMLType.TQ1_0: (256, 48 + 4 + 2),
    GGMLType.TQ2_0: (256, 64 + 2),
    GGMLType.MXFP4: (32, 1 + 16),
}

QK_K = 256  # K-quant super-block size
QK4_0 = 32
QK8_0 = 32


def type_block_size(t: GGMLType) -> int:
    return GGML_TYPE_TRAITS[t][0]


def type_size(t: GGMLType) -> int:
    return GGML_TYPE_TRAITS[t][1]


def tensor_nbytes(n_elems: int, t: GGMLType) -> int:
    bs, ts = GGML_TYPE_TRAITS[t]
    assert n_elems % bs == 0, f"{n_elems} not a multiple of block size {bs} for {t.name}"
    return (n_elems // bs) * ts


# --- Standard GGUF metadata keys (the subset this framework reads/writes) ---


class Keys:
    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        QUANTIZATION_VERSION = "general.quantization_version"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"

    # per-arch keys are formatted with the arch name, e.g. "llama.block_count"
    class LLM:
        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        EXPERT_COUNT = "{arch}.expert_count"
        EXPERT_USED_COUNT = "{arch}.expert_used_count"
        EXPERT_FEED_FORWARD_LENGTH = "{arch}.expert_feed_forward_length"
        # SparkInfer predictor ranks, one per layer
        # (ref: gguf-py/gguf/constants.py:107 "{arch}.pred_lora")
        PRED_LORA = "{arch}.pred_lora"

    class Attention:
        HEAD_COUNT = "{arch}.attention.head_count"
        HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
        LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        KEY_LENGTH = "{arch}.attention.key_length"
        VALUE_LENGTH = "{arch}.attention.value_length"
        SLIDING_WINDOW = "{arch}.attention.sliding_window"

    class Rope:
        DIMENSION_COUNT = "{arch}.rope.dimension_count"
        FREQ_BASE = "{arch}.rope.freq_base"
        SCALING_TYPE = "{arch}.rope.scaling.type"
        SCALING_FACTOR = "{arch}.rope.scaling.factor"
        SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
        SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        PRE = "tokenizer.ggml.pre"
        LIST = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        MASK_ID = "tokenizer.ggml.mask_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"  # (sic — ref spelling)
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SEP = "tokenizer.ggml.add_sep_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        CHAT_TEMPLATE = "tokenizer.chat_template"
        # fill-in-the-middle special tokens (ref llama-arch.cpp:284-289)
        FIM_PRE_ID = "tokenizer.ggml.fim_pre_token_id"
        FIM_SUF_ID = "tokenizer.ggml.fim_suf_token_id"
        FIM_MID_ID = "tokenizer.ggml.fim_mid_token_id"
        FIM_PAD_ID = "tokenizer.ggml.fim_pad_token_id"
        FIM_REP_ID = "tokenizer.ggml.fim_rep_token_id"
        FIM_SEP_ID = "tokenizer.ggml.fim_sep_token_id"

    # SparkInfer model-split file keys (ref: src/llama-sparkinfer.cpp:150-158)
    class SparkInfer:
        FFN_GROUP_SIZE = "ffn_group_size"
        FFN_NORMALIZED_PATTERN = "ffn_normalized_pattern"
        REORDER_PERMS_TENSOR = "blk.{bid}.ffn_reorder_perms"


class TokenType(enum.IntEnum):
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
