"""Declarative argument table shared by all CLIs: the port's own copy of
sparkinfer_tpu/common/args.py, with the rows of the cli and server scopes,
and `--device` in both (the torch device; default the CUDA card). Rows whose
modules are not ported yet stay in the table, so the flags parse as in the
JAX package, and `unported_flags` names each one a run sets; the entry
points fail on them.

The reference declares every flag once in a table of `common_arg` rows
(ref: common/arg.cpp — ~200 rows), each naming the examples (tools) it
applies to and an optional environment-variable mirror installed with
`.set_env()` (ref: common/arg.cpp:1932 `LLAMA_ARG_SP_MODEL_SPLIT`).
Resolution order matches the reference: the env var provides the
*default*; an explicit CLI flag always wins (common_params_parse applies
env values before argv).

This module is the TPU-native analogue. Each `Opt` row declares:
  flags   — CLI aliases ("-m", "--model")
  scopes  — which tools expose it ({"cli","server","perplexity","bench"})
  env     — environment mirror (SPARK_ARG_* here; SPIF_* kept for the
            SparkInfer knobs the reference also spells SPIF_*)
  argparse kwargs (type/default/choices/action/nargs/help)

`build_parser(scope)` materializes an argparse parser for one tool from
the table, so flag names, defaults and env mirrors can never drift
between entry points.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field

ALL = frozenset({"cli", "server", "perplexity", "bench"})
CLI = frozenset({"cli"})
SERVER = frozenset({"server"})
CS = frozenset({"cli", "server"})


@dataclass
class Opt:
    flags: tuple
    scopes: frozenset
    env: str | None = None
    kwargs: dict = field(default_factory=dict)

    def add_to(self, ap: argparse.ArgumentParser) -> None:
        kw = dict(self.kwargs)
        if self.env is not None:
            raw = os.environ.get(self.env)
            if raw is not None:
                # env provides the default; CLI overrides (ref arg.cpp
                # common_params_parse applies env before argv)
                action = kw.get("action")
                if action in ("store_true", "store_false"):
                    kw["default"] = raw not in ("", "0", "false", "off")
                elif kw.get("action") == "append":
                    kw["default"] = [raw]
                else:
                    typ = kw.get("type")
                    kw["default"] = typ(raw) if typ else raw
            help_ = kw.get("help", "")
            kw["help"] = (help_ + f" (env: {self.env})").strip()
        ap.add_argument(*self.flags, **kw)


def _o(*flags, scopes=CLI, env=None, **kwargs) -> Opt:
    return Opt(tuple(flags), scopes, env, kwargs)


# ---------------------------------------------------------------------------
# The table. Grouped like the reference's arg.cpp sections.
# ---------------------------------------------------------------------------

OPTIONS: list[Opt] = [
    # --- model / context -------------------------------------------------
    _o("-m", "--model", scopes=ALL, env="SPARK_ARG_MODEL",
       default=None, help="GGUF model path"),
    _o("-hf", "--hf-repo", scopes=CS, env="SPARK_ARG_HF_REPO",
       default=None,
       help="resolve model from the LOCAL HF hub cache: user/repo[:quant] "
            "(offline; ref common/arg.cpp -hf)"),
    _o("-c", "--ctx-size", scopes=ALL, env="SPARK_ARG_CTX_SIZE",
       type=int, default=2048, help="context window (tokens)"),
    _o("-ctk", "--cache-type-k", scopes=CS, env="SPARK_ARG_CACHE_TYPE_K",
       choices=["f32", "bf16", "q8", "int8"], default="bf16",
       help="K cache dtype (q8/int8 = quantized KV; ref arg.cpp:1665)"),
    _o("-ctv", "--cache-type-v", scopes=CS, env="SPARK_ARG_CACHE_TYPE_V",
       choices=["f32", "bf16", "q8", "int8"], default=None,
       help="V cache dtype (default: same as -ctk; float/quantized mixes "
            "are rejected like the reference non-FA path; ref arg.cpp:1678)"),
    _o("--keep", scopes=CLI, type=int, default=-1,
       help="tokens kept from the prompt on context shift "
            "(-1 = whole prompt; ref main.cpp n_keep)"),
    _o("-b", "--batch-size", scopes=CS, env="SPARK_ARG_BATCH",
       type=int, default=1024,
       help="prefill micro-batch (ubatch) length in tokens (ref -b/-ub)"),
    _o("-t", "--threads", scopes=ALL, env="SPARK_ARG_THREADS",
       type=int, default=0,
       help="host threads for native (OpenMP) kernels; 0 = all cores "
            "(device compute is unaffected; ref -t)"),
    _o("--ignore-eos", scopes=CLI, action="store_true",
       help="keep generating past end-of-generation tokens (ref --ignore-eos)"),

    # --- rope / YaRN overrides (ref common/arg.cpp:1564-1630) -----------
    _o("--rope-scaling", scopes=CS, env="SPARK_ARG_ROPE_SCALING",
       choices=["none", "linear", "yarn"], default=None,
       help="override the GGUF rope scaling type"),
    _o("--rope-scale", scopes=CS, type=float, default=None,
       help="rope context scaling factor N (freq_scale = 1/N)"),
    _o("--rope-freq-base", scopes=CS, env="SPARK_ARG_ROPE_FREQ_BASE",
       type=float, default=None, help="override rope theta base"),
    _o("--rope-freq-scale", scopes=CS, type=float, default=None,
       help="override rope frequency scale directly (ref --rope-freq-scale)"),
    _o("--yarn-orig-ctx", scopes=CS, type=int, default=None,
       help="YaRN original training context (0 = model n_ctx_train)"),
    _o("--yarn-ext-factor", scopes=CS, type=float, default=None,
       help="YaRN extrapolation mix (-1 = auto from scaling type)"),
    _o("--yarn-attn-factor", scopes=CS, type=float, default=None,
       help="YaRN attention magnitude scale"),
    _o("--yarn-beta-fast", scopes=CS, type=float, default=None,
       help="YaRN low correction dim"),
    _o("--yarn-beta-slow", scopes=CS, type=float, default=None,
       help="YaRN high correction dim"),
    _o("--kv-iswa", scopes=CLI, env="SPARK_ARG_KV_ISWA", action="store_true",
       help="dual SWA/full KV cache for interleaved-SWA models "
            "(ref src/llama-kv-cache-iswa.cpp)"),
    _o("--attn-w8a8", scopes=CS, env="SPARK_ARG_ATTN_W8A8",
       action="store_true",
       help="re-quantize attention projections to row-wise W8A8 at load "
            "(not ported yet)"),
    _o("--chat-template", scopes=CS, env="SPARK_ARG_CHAT_TEMPLATE",
       default=None, help="override the GGUF chat template"),

    # --- adapters (ref common/arg.cpp --lora/--control-vector) ----------
    _o("--lora", scopes=CS, action="append", default=None, metavar="GGUF",
       help="LoRA adapter GGUF (repeatable; scale 1.0)"),
    _o("--lora-scaled", scopes=CS, action="append", default=None, nargs=2,
       metavar=("GGUF", "SCALE"), help="LoRA adapter with scale (repeatable)"),
    _o("--control-vector", scopes=CLI, action="append", default=None,
       metavar="GGUF", help="control vector (repeatable; ref llama-adapter)"),
    _o("--control-vector-scaled", scopes=CLI, action="append", default=None,
       nargs=2, metavar=("GGUF", "SCALE"), help="scaled control vector"),

    # --- sampling (ref common/common.h common_params_sampling) ----------
    _o("--temp", scopes=CS, env="SPARK_ARG_TEMP", type=float, default=0.8),
    _o("--top-k", scopes=CS, type=int, default=40),
    _o("--top-p", scopes=CS, type=float, default=0.95),
    _o("--min-p", scopes=CS, type=float, default=0.05),
    _o("--typical", dest="typical_p", scopes=CS, type=float, default=1.0,
       help="locally-typical sampling (ref --typical)"),
    _o("--repeat-last-n", scopes=CS, type=int, default=64,
       help="penalty window (ref --repeat-last-n)"),
    _o("--repeat-penalty", scopes=CS, type=float, default=1.0),
    _o("--presence-penalty", scopes=CS, type=float, default=0.0),
    _o("--frequency-penalty", scopes=CS, type=float, default=0.0),
    _o("--mirostat", scopes=CS, type=int, default=0, choices=[0, 2],
       help="mirostat v2 sampling (0 = off)"),
    _o("--mirostat-ent", dest="mirostat_tau", scopes=CS, type=float,
       default=5.0, help="mirostat target entropy tau"),
    _o("--mirostat-lr", dest="mirostat_eta", scopes=CS, type=float,
       default=0.1, help="mirostat learning rate eta"),
    _o("--xtc-probability", scopes=CS, type=float, default=0.0),
    _o("--xtc-threshold", scopes=CS, type=float, default=0.1),
    _o("-s", "--seed", scopes=ALL, env="SPARK_ARG_SEED", type=int, default=42),
    _o("--verbose", scopes=ALL, env="SPARK_ARG_VERBOSE", action="store_true"),

    # --- grammar / structured output (ref common/arg.cpp --grammar) -----
    _o("--grammar", scopes=CLI, default=None,
       help="GBNF grammar source for constrained decoding"),
    _o("--grammar-file", scopes=CLI, default=None,
       help="read GBNF grammar from file"),
    _o("-j", "--json-schema", scopes=CLI, default=None,
       help="constrain output to a JSON schema (converted to GBNF; "
            "ref grammars/README + json-schema-to-grammar)"),

    # --- generation (cli) ------------------------------------------------
    _o("-p", "--prompt", scopes=CLI, default=None),
    _o("-f", "--prompt-file", scopes=CLI, default=None),
    _o("-n", "--n-predict", scopes=CLI, env="SPARK_ARG_N_PREDICT",
       type=int, default=64),
    _o("-i", "--interactive", scopes=CLI, action="store_true",
       help="chat REPL (ref: llama-cli interactive mode)"),
    _o("--draft-mode", scopes=CLI, choices=["none", "lookup", "lookahead"],
       default="none",
       help="draft-free speculative decoding (greedy only; "
            "ref examples/lookup, examples/lookahead)"),
    _o("--draft", scopes=CLI, type=int, default=5,
       help="draft length for --draft-mode"),
    _o("-gan", "--grp-attn-n", scopes=CLI, type=int, default=1,
       help="self-extend group size (ref main.cpp grp_attn_n)"),
    _o("-gaw", "--grp-attn-w", scopes=CLI, type=int, default=512,
       help="self-extend window (multiple of -gan)"),
    _o("-nps", "--n-bench-prompts", scopes=CLI, type=int, default=0,
       help="bench mode: run N prompts from --prompt-file, report t/s "
            "(SparkInfer addition, ref tools/main/main.cpp:439,185)"),
    _o("--json", scopes=CLI, action="store_true", help="bench output as JSON"),

    # --- SparkInfer sparse knobs (ref common/arg.cpp:1926-1955) ---------
    _o("--spif-ms", "--split", dest="split", scopes=CS, env="SPIF_MS",
       default=None,
       help="model-split GGUF with group size/pattern/reorder perms "
            "(ref -spif-ms, env LLAMA_ARG_SP_MODEL_SPLIT)"),
    _o("-vb", "--hbm-budget", dest="hbm_budget", scopes=CS, env="SPIF_VB",
       type=float, default=None,
       help="hot-cache HBM budget in GiB (ref -vb VRAM budget)"),
    _o("--hot-groups", scopes=CS, type=int, default=0,
       help="explicit per-layer hot group count (overrides -vb)"),
    _o("--capacity-groups", scopes=CS, type=int, default=0,
       help="top-k group capacity per token"),
    _o("--group-size", scopes=CS, type=int, default=128,
       help="neurons per group (ref split-file ffn_group_size)"),
    _o("--cold-mode", scopes=CS, choices=["host", "drop", "fetch"],
       default=None,
       help="cold-neuron handling: host C++ complement (exact), drop, or "
            "fetch (missed groups demand-enter the hot set each rebalance "
            "— the chip-deployable near-exact tier)"),
    _o("--prefill-mode", scopes=CS, choices=["rows", "tiered"],
       default="rows",
       help="tiered serving prefill: 'rows' keeps the full FFN row layout "
            "in HBM for exact masked-dense prefill; 'tiered' frees it and "
            "prefills through the hot store + cold tier (the memory-"
            "critical >=7B-on-16GB regime — only the hot blocks ever "
            "touch HBM, ref src/llama-sparkinfer.cpp:354-359)"),
    _o("--sparse", scopes=CS, action="store_true",
       help="force sparse FFN path (auto when predictors present)"),
    _o("--dense", scopes=CS, action="store_true", help="force dense FFN path"),
    _o("--rebalance-every", scopes=CS, type=int, default=1,
       help="steps between tiered hot-set rebalances"),
    _o("--reload-budget-mb", scopes=CS, type=float, default=0.0,
       env="SPIF_RELOAD_BUDGET_MB",
       help="per-rebalance H2D upload budget in MiB (0 = unlimited), "
            "spent globally on the highest-miss swaps; bounds serving "
            "tick-latency tails (byte-aware form of the ref "
            "SPIF_RELOAD_WINDOW_SIZE copy cap; 8-16 on relay-attached "
            "chips measured 7x aggregate at 7B, BENCH_NOTES r5)"),
    _o("--swap-hysteresis", scopes=CS, type=float, default=0.05,
       env="SPIF_SWAP_HYSTERESIS",
       help="DFR swap hysteresis: a non-missed challenger must beat the "
            "incumbent hot group by this fraction of the layer's DFR "
            "range (kills steady-state churn; demand fetches bypass it)"),

    _o("--moe-mode", scopes=CLI, choices=["dense", "pallas"], default="dense",
       help="MoE expert FFN path (pallas = fused row streaming, the v1 kernel)"),

    # --- server ----------------------------------------------------------
    _o("--device", scopes=CS, env="SPARK_ARG_DEVICE", default=None,
       help="torch device to run on (default: the CUDA card; 'cpu' for "
            "the CPU)"),
    _o("--host", scopes=SERVER, env="SPARK_ARG_HOST", default="127.0.0.1"),
    _o("--port", scopes=SERVER, env="SPARK_ARG_PORT", type=int, default=8080),
    _o("-np", "--n-slots", scopes=SERVER, env="SPARK_ARG_N_PARALLEL",
       type=int, default=4, help="parallel slots (ref -np)"),
    _o("--alias", scopes=SERVER, env="SPARK_ARG_ALIAS",
       default="sparkinfer-tpu", help="model name served via the API"),
    _o("--api-key", scopes=SERVER, env="SPARK_ARG_API_KEY", default=None,
       help="require 'Authorization: Bearer <key>' on API routes "
            "(ref server middleware_validate_api_key; /health stays open)"),
    _o("--slot-save-path", scopes=SERVER, default=None,
       help="directory for /slots/:id?action=save files"),
    _o("-to", "--timeout", scopes=SERVER, env="SPARK_ARG_TIMEOUT",
       type=float, default=600.0,
       help="server read/write timeout in seconds (ref -to arg.cpp:2479)"),
    _o("-sps", "--slot-prompt-similarity", scopes=SERVER,
       type=float, default=0.1,
       help="min common-prefix fraction for routing a request to the idle "
            "slot with the best KV reuse (0 = first-free; ref -sps "
            "arg.cpp:2648)"),
    _o("-n", "--n-predict", scopes=SERVER, env="SPARK_ARG_N_PREDICT_SRV",
       dest="n_predict_default", type=int, default=128,
       help="default max_tokens when the request omits it"),
    _o("--models", scopes=SERVER, action="append", default=None,
       metavar="NAME=GGUF",
       help="extra routed models, selected by the OpenAI 'model' field "
            "(repeatable; ref server-models.cpp router)"),
]


def build_parser(scope: str, prog: str, description: str | None = None,
                 extra: list | None = None) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog, description=description)
    for opt in OPTIONS:
        if scope in opt.scopes:
            opt.add_to(ap)
    for opt in extra or []:
        opt.add_to(ap)
    return ap


def sampler_from_args(args):
    """SamplerConfig from parsed args (any scope that includes sampling)."""
    from ..runtime.sampling import SamplerConfig

    return SamplerConfig(
        temp=args.temp,
        top_k=args.top_k,
        top_p=args.top_p,
        min_p=args.min_p,
        typical_p=getattr(args, "typical_p", 1.0),
        penalty_last_n=getattr(args, "repeat_last_n", 64),
        penalty_repeat=args.repeat_penalty,
        penalty_freq=getattr(args, "frequency_penalty", 0.0),
        penalty_present=getattr(args, "presence_penalty", 0.0),
        mirostat=getattr(args, "mirostat", 0),
        mirostat_tau=getattr(args, "mirostat_tau", 5.0),
        mirostat_eta=getattr(args, "mirostat_eta", 0.1),
        xtc_probability=getattr(args, "xtc_probability", 0.0),
        xtc_threshold=getattr(args, "xtc_threshold", 0.1),
        seed=args.seed,
    )


def apply_model_overrides(args, model) -> None:
    """Apply --rope-*/--yarn-* CLI overrides onto the loaded model config
    (ref: common_init_from_params copies the rope/yarn params from
    common_params into llama_context_params)."""
    import dataclasses

    cfg = model.config
    upd = {}
    if getattr(args, "rope_scaling", None) is not None:
        upd["rope_scaling_type"] = args.rope_scaling
    if getattr(args, "rope_freq_base", None) is not None:
        upd["rope_freq_base"] = args.rope_freq_base
    if getattr(args, "rope_scale", None) is not None:
        upd["rope_scale"] = (1.0 / args.rope_scale
                             if args.rope_scale not in (0.0, 1.0) else 1.0)
    if getattr(args, "rope_freq_scale", None) is not None:
        upd["rope_scale"] = args.rope_freq_scale
    if getattr(args, "yarn_orig_ctx", None) is not None:
        upd["rope_orig_ctx"] = args.yarn_orig_ctx or cfg.n_ctx_train
    if getattr(args, "yarn_ext_factor", None) is not None:
        upd["yarn_ext_factor"] = args.yarn_ext_factor
    if getattr(args, "yarn_attn_factor", None) is not None:
        upd["yarn_attn_factor"] = args.yarn_attn_factor
    if getattr(args, "yarn_beta_fast", None) is not None:
        upd["yarn_beta_fast"] = args.yarn_beta_fast
    if getattr(args, "yarn_beta_slow", None) is not None:
        upd["yarn_beta_slow"] = args.yarn_beta_slow
    if upd:
        model.config = dataclasses.replace(cfg, **upd)
    n_threads = getattr(args, "threads", 0)
    if n_threads:
        # native OpenMP kernels read this at library init
        os.environ["OMP_NUM_THREADS"] = str(n_threads)


def kv_dtypes_from_args(args):
    """(k_dtype, v_dtype, quantized) from -ctk/-ctv. Mixing a float type
    with a quantized type is rejected (the reference's non-flash-attn V
    restriction, arg.cpp:1678 + context checks)."""
    import torch

    ctk = getattr(args, "cache_type_k", "bf16")
    ctv = getattr(args, "cache_type_v", None) or ctk
    qk = ctk in ("q8", "int8")
    qv = ctv in ("q8", "int8")
    if qk != qv:
        raise SystemExit(
            f"-ctk {ctk} / -ctv {ctv}: mixed float/quantized KV cache is "
            "not supported (quantize both or neither)")
    m = {"f32": torch.float32, "bf16": torch.bfloat16,
         "q8": torch.bfloat16, "int8": torch.bfloat16}
    return m[ctk], m[ctv], qk


def grammar_from_args(args) -> str | None:
    """GBNF source from --grammar / --grammar-file / --json-schema."""
    if getattr(args, "grammar", None):
        return args.grammar
    if getattr(args, "grammar_file", None):
        with open(args.grammar_file) as f:
            return f.read()
    if getattr(args, "json_schema", None):
        import json

        from ..grammar.json_schema import json_schema_to_gbnf

        schema = args.json_schema
        if schema.strip().startswith("{"):
            schema = json.loads(schema)
        else:  # a file path
            with open(schema) as f:
                schema = json.load(f)
        return json_schema_to_gbnf(schema)
    return None


def adapters_from_args(args) -> list:
    """[(path, scale), ...] from --lora/--lora-scaled."""
    out = []
    for p in getattr(args, "lora", None) or []:
        out.append((p, 1.0))
    for p, s in getattr(args, "lora_scaled", None) or []:
        out.append((p, float(s)))
    return out


def control_vectors_from_args(args) -> list:
    """[(path, scale), ...] from --control-vector/--control-vector-scaled."""
    out = []
    for p in getattr(args, "control_vector", None) or []:
        out.append((p, 1.0))
    for p, s in getattr(args, "control_vector_scaled", None) or []:
        out.append((p, float(s)))
    return out


# flags whose modules the port has not ported yet: dest -> (flag, module)
_UNPORTED = {
    "hf_repo": ("-hf/--hf-repo", "tools/hf.py"),
}


def unported_flags(args) -> list[str]:
    """One message for each flag of `args` that needs a module the port
    has not ported yet: the HF cache."""
    return [f"{flag} needs {mod}, which is not ported yet"
            for dest, (flag, mod) in _UNPORTED.items() if getattr(args, dest, None)]
