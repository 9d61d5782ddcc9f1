#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparkinfer_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the numbers in PERF.md). It exits non-zero, printing no result, where torch
sees no card or the package is missing. Phases, each of which fails the run:

  1. device: name, count, nvidia-smi name and power limit;
  2. build: every CUDA kernel of the main path, compiled at once from csrc/;
  3. reference, f32 on small inputs: a tiny model decoded greedily on the
     card (kernel path) and on the CPU (plain path), and ProSparse-Llama-2-7B
     widths cut to 2 layers through the kernel path and the plain ("gather")
     path on the card, must give the same tokens and first-decode logits;
  4. kernels: each kernel against its plain torch version on the card at the
     decode shapes of ProSparse-Llama-2-7B (E=4096, G=128, C=12 of 86 groups,
     bf16 stores of 32*86 rows, random rows so the 50 MB L2 stays cold),
     with times for kernel, plain version and the bound;
  5. main path: `Engine` on ProSparse-Llama-2-7B widths (no GGUF: random
     weights from a seed, bench.py's "7b" preset scales), sparse greedy
     generate of 64 tokens from a 32-token prompt; launch counts are reset
     just before and read just after, and every kernel must have run
     n_layer times per decode step; all logits must be finite; a profile of
     a few decode steps gives device time by kernel; then the dense engine
     on the same weights, the system's sparse-vs-dense headline. (At bf16
     and random weights, decode is chaotic: a last-bit difference in one
     FFN output can flip a later group selection, so the 7B bf16 run is
     checked for finiteness and counts, and agreement is checked in f32.)

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
KERNEL_TOL = 1e-3  # relative to max|plain|: f32 sums over 4096 and 1536 terms in other orders
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_S = 67e12  # H100 SXM, f32 outside the tensor cores


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def random_model(cfg, dtype, device, seed):
    """A LoadedModel with the loader's keys and dtypes, weights drawn on the
    device from a seeded generator at bench.py's "7b" scales: N(0, 0.02)
    projections, N(0, 0.05) pred_up, N(0, 0.6) pred_down and a predictor
    bias of N(0, 0.5) - 1.2."""
    import torch

    from sparkinfer_tpu_torch.models.loader import LoadedModel

    gen = torch.Generator(device=device).manual_seed(seed)
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_ff, cfg.n_vocab
    HD, KD, R = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim, cfg.max_pred_rank

    def w(*shape, scale=0.02, shift=0.0, dt=dtype):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        return t.mul_(scale).add_(shift)

    ones = dict(dtype=torch.float32, device=device)
    layers = {
        "attn_norm_w": torch.ones((L, E), **ones), "wq": w(L, E, HD),
        "wk": w(L, E, KD), "wv": w(L, E, KD), "wo": w(L, HD, E),
        "ffn_norm_w": torch.ones((L, E), **ones), "w_up": w(L, E, F),
        "w_gate": w(L, E, F), "w_down": w(L, F, E),
        "pred_up": w(L, E, R, scale=0.05),
        "pred_up_b": torch.zeros((L, R), dtype=dtype, device=device),
        "pred_down": w(L, R, F, scale=0.6),
        "pred_down_b": w(L, F, scale=0.5, shift=-1.2),
    }
    params = {"tok_embd": w(V, E), "output_norm_w": torch.ones((E,), **ones),
              "output": w(E, V), "layers": layers}
    return LoadedModel(config=cfg, params=params)


def prosparse_config(L, E, H, F, V, R):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="prosparse_llama", n_layer=L, n_embd=E, n_head=H,
                       n_head_kv=H, n_ff=F, n_vocab=V, head_dim=E // H,
                       pred_lora=(R,) * L)


def events_ms(fn, reps: int) -> float:
    """Mean time of fn(i) over reps eager calls, by CUDA events: device time
    where the device is the bottleneck, host issue time where the host is."""
    import torch

    fn(0)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn(i) over reps calls captured in one CUDA graph,
    so that no host time lies between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_decode_and_tokens(eng, prompt, n_new):
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    eng.decode_step(tok, n, cache, st)
    return eng.last_logits.float().cpu(), eng.generate(prompt, n_new)


def phase_reference(sparse_cfg_cls, engine_cls, sampler):
    """f32 references on small inputs:
    (a) a tiny model: kernel path on the card == plain path on the CPU;
    (b) ProSparse-Llama-2-7B widths cut to 2 layers: kernel path == plain
        ("gather") path, both on the card."""
    import torch

    prompt = list(range(3, 40, 3))
    cases = (
        ("tiny, card kernel vs CPU plain", prosparse_config(2, 256, 8, 512, 1024, 64),
         sparse_cfg_cls(group_size=128, capacity_groups=2), ("cuda", "kernel"),
         ("cpu", "kernel")),
        ("7B widths 2 layers, card kernel vs card plain",
         prosparse_config(2, 4096, 32, 11008, 32000, 1024),
         sparse_cfg_cls(group_size=128, capacity_groups=12), ("cuda", "kernel"),
         ("cuda", "gather")),
    )
    for label, cfg, scfg, *sides in cases:
        model = random_model(cfg, torch.float32, "cuda", SEED + 1)
        outs = []
        for dev, mode in sides:
            m = model
            if dev == "cpu":
                m = type(model)(config=cfg, params={
                    k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
                        else v.cpu()) for k, v in model.params.items()})
            eng = engine_cls(m, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                             sparse=scfg, sparse_decode_mode=mode, device=dev)
            outs.append(first_decode_and_tokens(eng, prompt, 16))
            del eng
        err = (outs[0][0] - outs[1][0]).abs().max().item()
        scale = outs[1][0].abs().max().item()
        print(f"reference ({label}): first decode logits max diff {err:.3e} "
              f"(scale {scale:.3e}); tokens {outs[0][1]} vs {outs[1][1]}")
        check(err <= 1e-4 * scale, f"{label}: logits differ")
        check(outs[0][1] == outs[1][1], f"{label}: token streams differ")
        del model, outs
        torch.cuda.empty_cache()


def phase_kernels(v6, v6_plain, flat, L, ng):
    """sparse_ffn_block_v6 against its plain version at the decode shapes."""
    import torch

    R, E, G = flat["w_upT_flat"].shape
    C = 12
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    results = []
    for N, act in ((1, "fatrelu"), (4, "fatrelu"), (4, "relu")):
        gated = act != "relu"
        n_sets = 64  # distinct row sets: consecutive launches miss in L2

        def rows():
            return torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                                + int(torch.randint(L, (1,), generator=gen, device="cuda")) * ng
                                for _ in range(N)]).to(torch.int32)

        idx = [rows() for _ in range(n_sets)]
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1
        wg = flat["w_gateT_flat"] if gated else None
        kw = dict(act=act, bu_sel=bu)
        args = lambda i: (x, idx[i % n_sets], gp, flat["w_upT_flat"], wg, flat["w_down_flat"])
        got = v6(*args(0), **kw)
        torch.cuda.synchronize()
        ref = v6_plain(*args(0), **kw)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"v6 N={N} {act}: non-finite output")
        check(err <= KERNEL_TOL * scale,
              f"v6 N={N} {act}: max|kernel-plain| {err:.3e} > {KERNEL_TOL} * {scale:.3e}")
        ms = graph_ms(lambda i: v6(*args(i), **kw), n_sets)
        host_ms = events_ms(lambda i: v6(*args(i), **kw), 200)
        plain_ms = graph_ms(lambda i: v6_plain(*args(i), **kw), 8)
        n_proj = 3 if gated else 2
        # least work per call, averaged over the row sets: each distinct
        # selected row read once, x/gp/bu/idx read and out written once;
        # 2 flops per weight and token
        rows_read = sum(len(torch.unique(t)) for t in idx) / n_sets
        nbytes = (n_proj * rows_read * G * E * 2 + N * E * 2 + 2 * N * C * G * 4
                  + N * C * 4 + N * E * 4)
        flops = 2 * n_proj * N * C * G * E
        bound_ms = max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S) * 1e3
        row = dict(N=N, act=act, max_abs_err=err, tol=KERNEL_TOL * scale, ms=ms,
                   eager_call_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by="bytes" if nbytes / PEAK_BYTES_S >= flops / PEAK_F32_FLOP_S
                   else "operations", GB_s=nbytes / (ms * 1e-3) / 1e9)
        print("kernel check:", json.dumps(row))
        results.append(row)
    return results[0]  # N=1 fatrelu: the main path's decode shape


def profile_decode(eng, prompt, steps: int = 8):
    """Device time by kernel over a few sparse decode steps (torch.profiler),
    and the share of the window in which the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    tok, cache, st = eng.decode_step(tok, n, cache, st)  # warm
    n += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache, st = eng.decode_step(tok, n, cache, st)
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies), so no time counts twice
    rows = [(e.key, (e.self_device_time_total or e.device_time_total) / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile: {steps} sparse decode steps, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy / steps:.3f} ms/step ({100 * busy / wall_ms:.1f}%)")
    for key, ms, count in rows[:12]:
        print(f"  {ms / steps:8.4f} ms/step  {count // steps:5d}/step  {key[:90]}")


def run_generate(eng, prompt, n_new):
    """Greedy generate, checking every logit row the engine produced."""
    import torch

    toks = []
    for tok in eng.generate(prompt, n_new, stream=True):
        check(bool(torch.isfinite(eng.last_logits).all()), "non-finite logits")
        toks.append(tok)
    check(len(toks) == n_new, f"generated {len(toks)} of {n_new} tokens")
    return toks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from sparkinfer_tpu_torch.ops import _build
    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6,
        sparse_ffn_block_v6_plain,
    )
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 2. build, every source at once
    kernels = ["sparse_ffn_v6"]
    for name, (lib, secs, log) in _build.build_all(kernels).items():
        if not log:
            print(f"build: {name} -> {lib.name} was already built")
            continue
        print(f"build: {name} -> {lib.name} in {secs:.2f} s; ptxas:")
        print("\n".join("  " + ln for ln in log.splitlines() if "ptxas info" in ln
                        and ("Used" in ln or "entry" in ln)))

    greedy = SamplerConfig(temp=0.0)

    # 3. f32 references on small inputs: kernel path == plain path
    phase_reference(SparseConfig, Engine, greedy)

    # 5a. the 7B-width model and its sparse engine (the flat stores serve phase 4)
    cfg = prosparse_config(32, 4096, 32, 11008, 32000, 1024)
    scfg = SparseConfig(group_size=128, capacity_groups=12)  # 12 of 86 groups, 12.5%
    t0 = time.perf_counter()
    model = random_model(cfg, torch.bfloat16, "cuda", SEED)
    sparse_eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, device="cuda")
    torch.cuda.synchronize()
    print(f"model: ProSparse-Llama-2-7B widths, L={cfg.n_layer} E={cfg.n_embd} "
          f"F={cfg.n_ff} V={cfg.n_vocab} R={cfg.max_pred_rank}, bf16, built with "
          f"sparse stores in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # 4. kernels against their plain versions
    ng = scfg.n_groups(cfg.n_ff)
    v6_row = phase_kernels(sparse_ffn_block_v6, sparse_ffn_block_v6_plain,
                           sparse_eng.params["sparse_flat"], cfg.n_layer, ng)

    # 5b. main path: counts to 0 just before, read just after
    prompt = torch.randint(cfg.n_vocab, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    n_new = 64
    torch.cuda.reset_peak_memory_stats()
    sparse_ffn_block_v6.launches = 0
    sparse_toks = run_generate(sparse_eng, prompt, n_new)
    launches = {"sparse_ffn_block_v6": sparse_ffn_block_v6.launches}
    steps = sparse_eng.perf.n_decode
    check(steps == n_new - 1, f"{steps} decode steps for {n_new} tokens")
    for name, n in launches.items():
        check(n == cfg.n_layer * steps,
              f"{name} launched {n} times, want n_layer * steps = {cfg.n_layer * steps}")
    sp = sparse_eng.perf.summary()
    sp_mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path sparse: prefill {sp['prefill_tps']} tok/s, decode "
          f"{sp['decode_tps']} tok/s ({steps} steps), peak {sp_mem:.2f} GiB, "
          f"v6 launches {launches['sparse_ffn_block_v6']}")
    print(f"main path sparse tokens: {sparse_toks}")

    profile_decode(sparse_eng, prompt)

    # the dense engine on the same weights
    dense_eng = Engine(model, max_seq=1024, sampler=greedy, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run_generate(dense_eng, prompt, n_new)
    dp = dense_eng.perf.summary()
    print(f"main path dense: prefill {dp['prefill_tps']} tok/s, decode "
          f"{dp['decode_tps']} tok/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"sparse/dense decode {sp['decode_tps'] / dp['decode_tps']:.3f}x")

    out = {"kernels": [{
        "name": "sparse_ffn_block_v6", "route": "cuda",
        "source": "sparkinfer_tpu_torch/csrc/sparse_ffn_v6.cu",
        "replaces": "sparkinfer_tpu/ops/sparse_ffn_pallas.py:564",
        "launches": launches["sparse_ffn_block_v6"],
        "max_abs_err": v6_row["max_abs_err"], "tol": v6_row["tol"],
        "ms": v6_row["ms"], "plain_ms": v6_row["plain_ms"],
        "bound_ms": v6_row["bound_ms"], "bound_by": v6_row["bound_by"],
        "library_ms": None, "shape": "N=1 C=12 G=128 E=4096 bf16 fatrelu",
    }]}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
