"""sparkinfer-bench, the port of sparkinfer_tpu/tools/bench_matrix.py: a
llama-bench analogue that sweeps prefill sizes (pp), generation lengths (tg)
and batch sizes, reporting tokens/s as markdown or JSON.

    python -m sparkinfer_tpu_torch.tools.bench_matrix -m model.gguf -pp 512 -tg 32
    python -m sparkinfer_tpu_torch.tools.bench_matrix -m model.gguf --sparse
    SPIF_KERNEL_V2=1 python -m sparkinfer_tpu_torch.tools.bench_matrix -m model.gguf --sparse

It runs on the card unless --device says otherwise (--device cpu runs the
plain torch versions of the kernels). With --sparse, tg rows decode through
the pipelined sparse FFN over the v1 row layout: `sparse_ffn_block` (v1),
or `sparse_ffn_block_v2` over the concatenated store when SPIF_KERNEL_V2 is
set. Times are host wall times around synchronized windows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import time

import numpy as np
import torch

from ..models.transformer import make_forward
from ..runtime.kv_cache import init_cache


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(model) -> torch.device:
    return model.params["tok_embd"].device


@torch.inference_mode()
def bench_pp(model, n_tokens: int, n_rep: int, kv_dtype) -> float:
    """Prefill throughput t/s: the median of n_rep forwards of n_tokens
    after one warm-up forward."""
    cfg = model.config
    dev = _device(model)
    fwd = make_forward(cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.n_vocab, (1, n_tokens))).to(dev)
    pos = torch.arange(n_tokens, device=dev)[None]
    times = []
    for _ in range(n_rep + 1):
        cache = init_cache(cfg, 1, n_tokens, kv_dtype, dev)
        _sync(dev)
        t0 = time.perf_counter()
        fwd(model.params, toks, pos, cache)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return n_tokens / statistics.median(times[1:])  # skip the warm-up


def sparse_params(model, scfg) -> dict:
    """model.params with the pipelined sparse stores of scfg
    (`prepare_pipelined_params`, the JAX default layout "v1"), prepared once
    per model and kept on it, and prepared again only for another scfg or
    when SPIF_KERNEL_V2 asks for a w_all_rows they lack (the old stores are
    dropped first). The JAX tool re-prepares model.params for every row,
    stacking stores on stores: the function is the same, and a 7B model
    does not hold two store sets here."""
    from ..sparse.ffn import prepare_pipelined_params

    held = getattr(model, "_bench_sparse", None)
    stale = (held is None or held[0] != scfg
             or (os.environ.get("SPIF_KERNEL_V2") and "w_all_rows" not in held[1]["layers"]))
    del held  # no reference to the old stores may outlive their replacement
    if stale:
        model._bench_sparse = None
        model._bench_sparse = (scfg, prepare_pipelined_params(model.params, model.config, scfg))
    return model._bench_sparse[1]


@torch.inference_mode()
def bench_tg(model, n_tokens: int, n_rep: int, kv_dtype, ctx: int = 1024,
             batch: int = 1, sparse=None) -> float:
    """Decode throughput t/s at a realistic cache depth: a min(ctx/2, 512)
    token prefill, one warm-up step, then the median over n_rep runs of
    n_tokens steps. sparse: a SparseConfig to bench the pipelined sparse
    decode (mode "kernel") instead, whose forward also runs the prefill."""
    cfg = model.config
    dev = _device(model)
    if sparse is not None:
        from ..sparse.ffn import make_pipelined_sparse_ffn

        params = sparse_params(model, sparse)
        ffn, ci = make_pipelined_sparse_ffn(cfg, sparse, mode="kernel")
        fwd = make_forward(cfg, ffn_fn=ffn, ffn_carry_init=ci)
    else:
        params = model.params
        fwd = make_forward(cfg)
    T0 = min(ctx // 2, 512)
    if T0 + 1 + n_rep * n_tokens > ctx:
        raise ValueError(f"ctx {ctx} holds no {T0}-token prefill and "
                         f"{1 + n_rep * n_tokens} decode steps")
    cache = init_cache(cfg, batch, ctx, kv_dtype, dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.n_vocab, (batch, T0))).to(dev)
    fwd(params, toks, torch.arange(T0, device=dev)[None].expand(batch, T0), cache)

    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    fwd(params, tok, torch.full((batch, 1), T0, device=dev), cache)
    _sync(dev)
    rates = []
    for r in range(n_rep):
        t0 = time.perf_counter()
        for i in range(n_tokens):
            fwd(params, tok, torch.full((batch, 1), T0 + 1 + r * n_tokens + i, device=dev),
                cache)
        _sync(dev)
        rates.append(batch * n_tokens / (time.perf_counter() - t0))
    return statistics.median(rates)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparkinfer-bench")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-pp", type=str, default="512",
                    help="comma-separated prefill sizes (0 to skip)")
    ap.add_argument("-tg", type=str, default="32",
                    help="comma-separated generation lengths (0 to skip)")
    ap.add_argument("-b", "--batch", type=str, default="1",
                    help="comma-separated batch sizes for tg")
    ap.add_argument("-r", "--reps", type=int, default=3)
    ap.add_argument("-c", "--ctx", type=int, default=1024)
    ap.add_argument("-ctk", choices=["f32", "bf16", "q8"], default="bf16")
    ap.add_argument("--keep-quantized", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="bench the pipelined sparse decode (needs predictors)")
    ap.add_argument("--capacity-groups", type=int, default=0)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("-o", "--output", choices=["md", "json"], default="md")
    ap.add_argument("--trace", metavar="DIR",
                    help="capture a torch.profiler (Chrome trace) of the "
                         "measured section into DIR")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the plain "
                         "torch versions of the kernels)")
    args = ap.parse_args(argv)

    from ..models.loader import load_model
    from ..utils.profiling import maybe_trace

    kv_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "q8": torch.bfloat16}[args.ctk]
    model = load_model(args.model, keep_quantized=args.keep_quantized, device=args.device)
    cfg = model.config

    stack = contextlib.ExitStack()
    stack.enter_context(maybe_trace(args.trace))
    rows = []
    for pp in [int(x) for x in args.pp.split(",") if int(x) > 0]:
        tps = bench_pp(model, pp, args.reps, kv_dtype)
        rows.append({"test": f"pp{pp}", "t/s": round(tps, 2)})
    sparse = None
    if args.sparse:
        from ..sparse.config import SparseConfig

        gs = args.group_size
        while cfg.n_ff % gs:
            gs //= 2
        sparse = SparseConfig(group_size=gs, capacity_groups=args.capacity_groups)
    for b in [int(x) for x in args.batch.split(",")]:
        for tg in [int(x) for x in args.tg.split(",") if int(x) > 0]:
            tps = bench_tg(model, tg, args.reps, kv_dtype, args.ctx, batch=b, sparse=sparse)
            name = f"tg{tg}" if b == 1 else f"tg{tg}@b{b}"
            if sparse is not None:
                name += "-sparse"
            rows.append({"test": name, "t/s": round(tps, 2)})

    stack.close()  # write the profiler trace before reporting
    meta = {"arch": cfg.arch, "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
            "n_ff": cfg.n_ff}
    if args.output == "json":
        print(json.dumps({"meta": meta, "results": rows}))
    else:
        print("| model | test | t/s |")
        print("|---|---|---|")
        for r in rows:
            print(f"| {cfg.arch} L{cfg.n_layer} E{cfg.n_embd} | {r['test']} | {r['t/s']} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
