"""python -m sparkinfer_tpu_torch.server: the port of sparkinfer_tpu/server/__main__.py.

    python -m sparkinfer_tpu_torch.server -m model.gguf -np 4 [--device cpu]

Flags come from the port's copy of the shared declarative table
(common/args.py, server scope); --device picks the torch device (default:
the CUDA card). Tiered sparse serving: --hot-groups H (or -vb GiB, the hot
store's budget), --cold-mode host|drop|fetch (default host),
--prefill-mode rows|tiered, --split FILE, --rebalance-every,
--reload-budget-mb and --swap-hysteresis; --lora / --lora-scaled merge
adapters (rescaled by POST /lora-adapters), --slot-save-path holds the
/slots/:id save files; --attn-w8a8 re-quantizes the attention projections
to row-wise W8A8 at load; -ctk/-ctv q8 serve from the int8 KV cache, and
a float -ctv of its own splits the cache. Flags whose modules are not
ported yet (-hf) fail with an error naming the module. The line "listening on http://HOST:PORT" gives the bound port, also
for --port 0.
"""

from __future__ import annotations


def main(argv=None) -> int:
    from ..common.args import (
        adapters_from_args,
        build_parser,
        kv_dtypes_from_args,
        sampler_from_args,
        unported_flags,
    )

    ap = build_parser("server", prog="sparkinfer-torch-server", description=__doc__)
    args = ap.parse_args(argv)
    kv_dtypes_from_args(args)  # validates the -ctk/-ctv combination
    missing = unported_flags(args)
    if missing:
        ap.error("; ".join(missing))
    if args.model is None:
        ap.error("need -m/--model")

    from ..models.loader import load_model
    from .app import ServerConfig, SparkServer

    model = load_model(args.model, device=args.device, attn_w8a8=args.attn_w8a8)
    from ..common.args import apply_model_overrides

    apply_model_overrides(args, model)  # --rope-*/--yarn-*/-t

    sparse = None
    if (args.sparse or model.config.has_predictors) and not args.dense \
            and model.config.has_predictors:
        from ..sparse.config import SparseConfig, hbm_budget_to_hot_groups

        hot = args.hot_groups
        if not hot and args.hbm_budget:
            hot = hbm_budget_to_hot_groups(args.hbm_budget, model.config, args.group_size)
        sparse = SparseConfig(group_size=args.group_size,
                              capacity_groups=args.capacity_groups, hot_groups=hot,
                              reload_budget_mb=args.reload_budget_mb,
                              swap_hysteresis=args.swap_hysteresis)

    extra_models = None
    if args.models:
        extra_models = {}
        for spec in args.models:
            name, _, path = spec.partition("=")
            if not path:
                ap.error(f"--models expects NAME=GGUF, got {spec!r}")
            extra_models[name] = path

    srv = SparkServer(
        model,
        ServerConfig(
            host=args.host,
            port=args.port,
            n_slots=args.n_slots,
            max_seq=args.ctx_size,
            model_name=args.alias,
            kv_dtype={"q8": "int8"}.get(args.cache_type_k, args.cache_type_k),
            kv_dtype_v=({"q8": "int8"}.get(args.cache_type_v, args.cache_type_v)
                        if args.cache_type_v else None),
            chat_template=args.chat_template,
            timeout=args.timeout,
            n_predict_default=args.n_predict_default,
            slot_prompt_similarity=args.slot_prompt_similarity,
            api_key=args.api_key,
            slot_save_path=args.slot_save_path,
            lora=adapters_from_args(args) or None,
            extra_models=extra_models,
            sparse=sparse,
            sparse_cold_mode=args.cold_mode or "host",
            prefill_mode=args.prefill_mode,
            split=args.split,
            rebalance_every=args.rebalance_every,
            device=args.device,
        ),
        sampler=sampler_from_args(args),
    )
    srv.bind()
    print(f"listening on http://{args.host}:{srv.port} "
          f"({args.n_slots} slots, ctx {args.ctx_size}, device {srv.device})",
          flush=True)
    srv.serve(block=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
