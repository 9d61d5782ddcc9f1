#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparkinfer_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card (an H100 for
the numbers in PERF.md). It exits non-zero, printing no result, where torch
sees no card or the package is missing. Phases, each of which fails the run:

  1. device: name, count, nvidia-smi name and power limit;
  2. build: every CUDA kernel of the main paths, one nvcc per source, all
     started at once from csrc/;
  3. reference, f32 on small inputs, kernel path against plain path, the
     engines' and Scheduler's decode steps replaying CUDA graphs: tokens
     equal and first-decode logits within 1e-4 of their scale:
       serving (v1): a tiny model served by the Scheduler, 4 requests on 2
       slots, on the card against the CPU;
       union (v7u): ProSparse-Llama-2-7B widths cut to 2 layers, B=8, the
       union FFN of layer 1 on the card against "gather_union" at one
       selection (v7u rounds the hidden and W_down to bf16, so a full f32
       forward is chaotic: within 1e-2 of the output's scale, UNION_TOL),
       and the full forward finite;
       bench path (v2, v1): ProSparse-Llama-2-7B widths cut to 2 layers,
       sparkinfer-bench's pipelined decode over the v1 row layout, greedy
       through a bare forward: the v2 path (SPIF_KERNEL_V2) and the v1 path
       against the "gather" math, all on the card, each kernel launched
       n_layer times per forward;
       bf16 stores (v6): a tiny model on the card against the CPU, and
       ProSparse-Llama-2-7B widths cut to 2 layers, kernel against "gather"
       mode, both on the card;
       Q8_0 (v6q, quant_matmul): a tiny Q8_0 model (attention, head, flat
       stores, predictor stacks) on the card against the CPU; and
       ProSparse-Llama-2-13B widths cut to 2 layers, kernel against
       "gather" mode on the card, layer by layer: the plain path decodes 8
       greedy steps and feeds each layer's FFN input (its normed residual
       and carried selection) to the kernel FFN too, whose output must lie
       within 1e-4 of the plain one's scale and whose carried selection
       must be equal, at weight seeds 27, 3-9, 20 and 22. Whole forwards
       are no gate there: the quant products round their activations to
       bf16, so where the two FFNs differ in the last f32 bit an activation
       next to a bf16 rounding midpoint rounds apart and the difference
       cascades (0 to 1.4e-3 of the logits' scale over seeds on an H100);
       their first decode logits are printed and their greedy tokens
       checked equal at seed 27;
  4. kernels: each kernel against its plain torch version on the card at
     its main path's decode shapes, over stores that keep the 50 MB L2
     cold (CUDA-graph replay): 64 random row sets of the flat stores, 64
     of the model's attention matrices, 64 random Q4_0 stores, the 40
     layers of each predictor stack, and the 184 MB head alone; with
     max_abs_err, tol, ms, plain_ms, bound_ms and library_ms (the bf16
     torch.matmul of the dequantized weight for the quant products):
       sparse_ffn_block_v6 at 7B widths (E=4096, G=128, C=12 of 86, bf16),
       N=1 and 4, with the kernel one call launches and its span
       (torch.profiler: v6_ffn alone) and its launch plan;
       sparse_ffn_block (v1) at 7B widths, N=1 and 4, over the Scheduler's
       row stores, and v3 and v5 over the same stores, v4 over their
       interleave (L, ng, 3, G, E), v2 over the bench path's concatenated
       store (L, 3*ng, G, E), these four with an up bias; all five run one
       strided kernel (csrc/sparse_ffn_v1.cu), each row with the kernel one
       call launches and its span (torch.profiler: v1_ffn alone), the time
       of an eager call and its launch plan; sparse_ffn_block_v7u at 7B
       widths, B=1, 4 and 8, Cu=48, over the model's stores, and at 13B
       widths, B=8, Cu=64 of 108, E=5120, over one layer's bf16 stores, each
       with the kernels one call launches (torch.profiler: v7u_up then
       v7u_down) and its launch plan (clusters, blocks, wave ratios);
       sparse_ffn_block_v6q at 13B widths (E=5120, G=128, C=16 of 108), N=1
       and 4, with the kernels one call launches and their spans
       (torch.profiler: v6q_up then v6q_down) and its launch plan;
       quant_matmul_2d Q8_0/Q4_0 5120x5120 at N=1 and 32 and Q8_0 at N=4, 8
       and 512, Q8_0 head 5120x32000 at N=1 and 32; quant_matmul_flat at the
       predictor shapes 5120x1280 and 1280x13824, N=1 and 32, and 1280x13824
       at N=4; each with the kernels one call launches (torch.profiler: one,
       qmm_decode at N <= 4, qmm_prefill above) and the launch plan (tile, K
       splits, wave ratio);
  5. main paths, each decode step (or tick forward) one replay of a CUDA
     graph, each with every launch count set to 0 just before and read just
     after (a replay credits the launches its capture recorded; a capture's
     warm-up is one more step forward, counted), all logits finite, a
     profile of a few decode steps (torch.profiler, which sees the kernels
     inside the graphs: the independent count) and peak memory:
       ProSparse-Llama-2-7B widths, bf16 (bench.py "7b" preset scales),
       sparse greedy generate of 64 tokens from a 32-token prompt: v6
       n_layer times per decode step, with v6's device time and launches (1
       kernel a call) and the f32 copies' in the profiled steps;
       the Scheduler at the same widths: 8 greedy requests (32-token
       prompts, 32 new tokens) on 4 slots, so half of them queue, with
       sparse_batch_max = 4: v1 n_layer times per tick and no other kernel,
       with v1's device time and launches (1 kernel a call) and the f32
       copies' in a profile of 6 ticks;
       batched decode at the same widths (bench.py batch): aggregate tok/s
       of dense, masked-dense, per-token v6, union v7u and the Scheduler's
       v1 step at B = 1, 4, 8, each from its own dense prefill, best of 3
       runs of 8 steps, exact launch counts per run, then a profile of 4
       v7u steps at B = 8 (v7u's share of the step's device time); the
       largest B at which v1 beats masked-dense is the crossover that
       sparse.config.sparse_batch_crossover holds;
       sparkinfer-bench's decode rows at the same widths
       (tools.bench_matrix.bench_tg: a 512-token seed prefill into a
       1024-token cache, tg 16, 3 runs, B = 1 and 4): dense, sparse over the
       v1 row layout (v1 n_layer times per forward, no other kernel) and
       sparse with SPIF_KERNEL_V2 (v2 n_layer times per forward), with tok/s,
       ms per step and peak memory;
       ProSparse-Llama-2-13B widths, Q8_0 (bench.py "13b" preset; random
       weights made and quantized on the card layer by layer, through the
       ggml Q8_0 blocks a GGUF holds): v6q L, quant_matmul_2d 4L+1 and
       quant_matmul_flat 2(L+1) times per decode step, with v6q's device
       time and launches (2 kernels a call) and 6L+3 qmm_decode kernels in
       the profiled steps; a profiled 32-token prefill (device time of the
       qmm_* kernels and their launches, prefill tok/s);
     5h. graph against eager, for the 7B bf16 sparse engine and the dense
       one on the same weights, the Scheduler's tick, the 13B Q8_0 sparse
       engine and the dense one (Q8_0 FFN from the same weights): each eager
       side (cuda_graph=False) over the same params or prepared stores, the
       same greedy requests; the streams equal and the first decode (tick)
       logits bit-equal, or the run fails; two generate calls on one engine
       capture one graph; wall ms a step (tick) and tok/s, device ms and
       busy share over profiled replayed steps (busy share: of the profiled
       window; device share of wall: of the unprofiled step), the device
       span of one replay (CUDA events), the host time of its replay()
       call and the wall time of a replay synchronized after, an engine
       step taken apart (host ms of the fills, the replay call and the token
       read; device ms around the replay), capture seconds and graph pool
       bytes, and the sparse/dense decode tok/s ratio of graph and of eager.
     (At bf16 and random weights, decode is chaotic: a last-bit difference
     can flip a later group selection, so the full-size runs are checked
     for finiteness and counts, and agreement is checked in f32, phase 3.)

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py --prefill-profile

runs only the profiled 32-token prefill of the 13B Q8_0 engine, for the
sparkinfer_tpu_torch beside the script: a copy of the script placed in a
checkout of another revision profiles that revision.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

SEED = 0
KERNEL_TOL = 1e-3  # relative to max|plain|: f32 sums over 4096-5120 terms in other orders
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOP_S = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOP_S = 989e12  # H100 SXM, dense bf16 tensor cores
N_SETS = 64  # cold row sets / distinct stores per kernel timing
# v7u rounds the hidden and W_down to bf16: each product within 2^-8, about
# 2e-3 of the output's scale summed with random signs; a wrong row or mask
# errs by the scale itself
UNION_TOL = 1e-2
BATCHES = (1, 4, 8)
PROFILE_STEPS = 4  # profiled v7u batched decode steps at the largest B


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def prosparse_config(L, E, H, F, V, R):
    from sparkinfer_tpu_torch.models.config import ModelConfig

    return ModelConfig(arch="prosparse_llama", n_layer=L, n_embd=E, n_head=H,
                       n_head_kv=H, n_ff=F, n_vocab=V, head_dim=E // H,
                       pred_lora=(R,) * L)


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


class Q8Weights:
    """Random weights of one ProSparse model, each tensor drawn on the device
    from its own seeded generator (so a tensor can be drawn again, equal, for
    the dense engine), and packed as a Q8_0 GGUF load packs them: the ggml
    blocks of the (out, in) weight (gguf.quants.quantize, on the card), the
    loader's repack, the IN-major QuantTensor."""

    NAMES = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "output",
             "tok_embd", "pred_up", "pred_down", "pred_down_b")

    def __init__(self, cfg, dtype, device, seed):
        self.cfg, self.dtype, self.device, self.seed = cfg, dtype, device, seed

    def draw(self, name, il, shape, scale=0.02, shift=0.0):
        import torch

        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * len(self.NAMES) + self.NAMES.index(name)) * 4096 + il)
        t = torch.randn(shape, generator=gen, device=self.device, dtype=self.dtype)
        return t.mul_(scale).add_(shift)

    def pack(self, w_oi, kind="q8_0"):
        """(out, in) weight -> IN-major (packed, scales) on its device."""
        import torch

        from sparkinfer_tpu_torch.gguf.constants import GGMLType
        from sparkinfer_tpu_torch.gguf.quants import quantize
        from sparkinfer_tpu_torch.ops.quant_matmul import REPACK

        raw = quantize(w_oi, getattr(GGMLType, kind.upper())).cpu().numpy()
        qw, sc = REPACK[kind](raw, *w_oi.shape)
        return (torch.from_numpy(qw).to(w_oi.device).T,
                torch.from_numpy(sc).to(w_oi.device).T)

    def packed_stack(self, name, out, inn):
        """A layer-stacked Q8_0 QuantTensor of W (in, out), filled per layer."""
        import torch

        from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor

        L = self.cfg.n_layer
        qt = QuantTensor(torch.empty((L, inn, out), dtype=torch.int8, device=self.device),
                         torch.empty((L, inn // 32, out), dtype=torch.float32,
                                     device=self.device), "q8_0")
        for il in range(L):
            q, s = self.pack(self.draw(name, il, (out, inn)))
            qt.q[il].copy_(q)
            qt.s[il].copy_(s)
        return qt

    def dense_stack(self, name, out, inn):
        """(L, in, out) in the model's dtype, the same draws as packed_stack."""
        import torch

        L = self.cfg.n_layer
        w = torch.empty((L, inn, out), dtype=self.dtype, device=self.device)
        for il in range(L):
            w[il].copy_(self.draw(name, il, (out, inn)).T)
        return w

    def ffn_shapes(self):
        E, F = self.cfg.n_embd, self.cfg.n_ff
        return {"w_up": (F, E), "w_gate": (F, E), "w_down": (E, F)}

    def sparse_model(self, scfg):
        """The Q8_0 sparse model: Q8_0 attention and head, Q8_0 flat FFN
        stores (prepare_pipelined_params(layout="v6", quant="q8_0", drop_dense=True),
        quantized one layer at a time) and Q8_0 predictor stacks."""
        import torch

        from sparkinfer_tpu_torch.models.loader import LoadedModel
        from sparkinfer_tpu_torch.ops.quant_matmul import QuantTensor, flat_quantize
        from sparkinfer_tpu_torch.sparse.ffn import prepare_pipelined_params

        cfg, dev = self.cfg, self.device
        L, E, V, R = cfg.n_layer, cfg.n_embd, cfg.n_vocab, cfg.max_pred_rank
        HD, KD = cfg.n_head * cfg.head_dim, cfg.n_head_kv * cfg.head_dim
        ones = dict(dtype=torch.float32, device=dev)
        layers = {"attn_norm_w": torch.ones((L, E), **ones),
                  "ffn_norm_w": torch.ones((L, E), **ones),
                  "wq": self.packed_stack("wq", HD, E), "wk": self.packed_stack("wk", KD, E),
                  "wv": self.packed_stack("wv", KD, E), "wo": self.packed_stack("wo", E, HD)}
        layers.update({k: self.dense_stack(k, *shape)
                       for k, shape in self.ffn_shapes().items()})
        q, s = self.pack(self.draw("output", 0, (V, E)))
        params = {"tok_embd": self.draw("tok_embd", 0, (V, E)),
                  "output_norm_w": torch.ones((E,), **ones),
                  "output": QuantTensor(q.contiguous(), s.contiguous(), "q8_0"),
                  "layers": layers}
        params = prepare_pipelined_params(params, cfg, scfg, drop_dense=True, layout="v6",
                                          quant="q8_0")
        del layers  # the bf16 FFN: only the flat Q8_0 stores stay
        flat = params["sparse_flat"]
        pu = torch.stack([self.draw("pred_up", il, (E, R), scale=0.05) for il in range(L)])
        flat["pred_up_qt"] = flat_quantize(pu)
        del pu
        pd = torch.stack([self.draw("pred_down", il, (R, cfg.n_ff), scale=0.6)
                          for il in range(L)])
        flat["pred_down_qt"] = flat_quantize(pd)
        del pd
        flat["pred_up_b_all"] = torch.zeros((L, R), dtype=self.dtype, device=dev)
        flat["pred_down_b_all"] = torch.stack([
            self.draw("pred_down_b", il, (cfg.n_ff,), scale=0.5, shift=-1.2)
            for il in range(L)])
        return LoadedModel(config=cfg, params=params)

    def dense_ffn(self):
        """The same FFN weights as Q8_0 QuantTensors (a Q8_0 GGUF's FFN)."""
        return {k: self.packed_stack(k, *shape) for k, shape in self.ffn_shapes().items()}


def to_device(obj, device):
    """params (dicts of tensors and packed tensors) on another device"""
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj.to(device)


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
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak_flop_s: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare(label, got, ref, tol_rel=KERNEL_TOL):
    import torch

    check(bool(torch.isfinite(got).all()), f"{label}: non-finite kernel output")
    err = (got - ref).abs().max().item()
    tol = tol_rel * ref.abs().max().item()
    check(err <= tol, f"{label}: max|kernel-plain| {err:.3e} > tol {tol:.3e}")
    return err, tol


def first_decode_and_tokens(eng, prompt, n_new):
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    eng.decode_step(tok, n, cache, st)
    return eng.last_logits.float().cpu(), eng.generate(prompt, n_new)


def check_pair(label, outs):
    err = (outs[0][0] - outs[1][0]).abs().max().item()
    scale = outs[1][0].abs().max().item()
    print(f"reference ({label}): first decode logits max diff {err:.3e} "
          f"(scale {scale:.3e}); tokens {outs[0][1]} vs {outs[1][1]}")
    check(err <= 1e-4 * scale, f"{label}: logits differ")
    check(outs[0][1] == outs[1][1], f"{label}: token streams differ")


def q8_layer_gate(model, scfg, prompt, engine_cls, sampler, steps: int = 8):
    """The f32 Q8_0 FFNs held layer by layer: greedy decode through the plain
    ("gather") path, whose FFN at every layer and step also feeds its own
    input (the normed residual and the carried selection) to the kernel FFN
    (v6q, with quant_matmul_flat for the next layer's predictor). Returns
    the largest max|kernel - plain| / max|plain| over the layers and steps,
    whether every carried selection the two emitted was equal, and the
    number of FFN calls compared. No difference cascades from one layer to
    the next: each layer's inputs are the plain path's."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.sparse.ffn import make_pipelined_sparse_ffn

    cfg, dev = model.config, model.params["tok_embd"].device
    eng = engine_cls(model, max_seq=64, sampler=sampler, kv_dtype=torch.float32, sparse=scfg,
                     sparse_decode_mode="gather", sparse_preprepared=True, device=dev,
                     cuda_graph=False)
    plain, carry_init = make_pipelined_sparse_ffn(cfg, scfg, mode="gather")
    kernel, _ = make_pipelined_sparse_ffn(cfg, scfg, mode="kernel")
    rows = []

    def both(lp, x, carry, il):
        y, nxt = plain(lp, x, carry, il)
        yk, nxt_k = kernel(lp, x, carry, il)
        rows.append(((yk - y).abs().max() / y.abs().max(), torch.equal(nxt["idx"], nxt_k["idx"])))
        return y, nxt

    fwd = make_forward(cfg, ffn_fn=both, ffn_carry_init=carry_init)
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    with torch.inference_mode():
        for i in range(steps):
            logits = fwd(eng.params, torch.tensor([[tok]], device=dev),
                         torch.tensor([[n + i]], device=dev), cache)
            tok = int(logits[0, -1].argmax())
    return (torch.stack([e for e, _ in rows]).max().item(), all(eq for _, eq in rows),
            len(rows))


def phase_reference(sparse_cfg_cls, engine_cls, sampler):
    """f32 references on small inputs, kernel path against plain path."""
    import torch

    prompt = list(range(3, 40, 3))
    # bf16-layout stores (v6)
    cases = (
        ("tiny, card kernel vs CPU plain", prosparse_config(2, 256, 8, 512, 1024, 64),
         sparse_cfg_cls(group_size=128, capacity_groups=2), ("cuda", "kernel"),
         ("cpu", "kernel")),
        ("7B widths 2 layers, card kernel vs card gather",
         prosparse_config(2, 4096, 32, 11008, 32000, 1024),
         sparse_cfg_cls(group_size=128, capacity_groups=12), ("cuda", "kernel"),
         ("cuda", "gather")),  # the gather math over the v1 row stores, in f32
    )
    for label, cfg, scfg, *sides in cases:
        model = random_model(cfg, torch.float32, "cuda", SEED + 1)
        outs = []
        for dev, mode in sides:
            m = type(model)(config=cfg, params=to_device(model.params, dev))
            eng = engine_cls(m, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                             sparse=scfg, sparse_decode_mode=mode, device=dev)
            outs.append(first_decode_and_tokens(eng, prompt, 16))
            del eng, m
        check_pair(label, outs)
        del model, outs
        torch.cuda.empty_cache()
    # Q8_0 stores, packed attention and head, Q8_0 predictor stacks
    def q8_pair(model, scfg, sides):
        """Both sides' (first decode logits, tokens)."""
        outs = []
        for dev, mode in sides:
            m = type(model)(config=model.config, params=to_device(model.params, dev))
            eng = engine_cls(m, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                             sparse=scfg, sparse_decode_mode=mode,
                             sparse_preprepared=True, device=dev)
            outs.append(first_decode_and_tokens(eng, prompt, 16))
            del eng, m
        return outs

    cfg, scfg = prosparse_config(2, 512, 8, 1024, 1024, 64), sparse_cfg_cls(128, 2)
    model = Q8Weights(cfg, torch.float32, "cuda", SEED + 3).sparse_model(scfg)
    check_pair("Q8_0 tiny, card kernel vs CPU plain",
               q8_pair(model, scfg, (("cuda", "kernel"), ("cpu", "kernel"))))
    # 13B widths: every FFN layer within 1e-4 of its scale, the carried
    # selections equal, at every seed; the greedy tokens of the whole
    # forwards equal at SEED + 27; their logits printed (docstring, phase 3)
    cfg, scfg = prosparse_config(2, 5120, 40, 13824, 32000, 1280), sparse_cfg_cls(128, 16)
    label = "Q8_0 13B widths 2 layers, card kernel vs card plain"
    spread = []
    for seed in (SEED + 27, *range(SEED + 3, SEED + 10), SEED + 20, SEED + 22):
        model = Q8Weights(cfg, torch.float32, "cuda", seed).sparse_model(scfg)
        worst, same_sel, calls = q8_layer_gate(model, scfg, prompt, engine_cls, sampler)
        check(worst <= 1e-4 and same_sel,
              f"{label}, seed {seed}: an FFN layer differs by {worst:.3e} of its scale "
              f"(tolerance 1e-4) or a carried selection differs ({same_sel})")
        outs = q8_pair(model, scfg, (("cuda", "kernel"), ("cuda", "gather")))
        del model
        torch.cuda.empty_cache()
        err = (outs[0][0] - outs[1][0]).abs().max().item() / outs[1][0].abs().max().item()
        same_toks = outs[0][1] == outs[1][1]
        if seed == SEED + 27:
            print(f"reference ({label}): tokens {outs[0][1]} vs {outs[1][1]}")
            check(same_toks, f"{label}: token streams differ")
        spread.append((seed, worst, calls, err, same_toks))
    print(f"reference ({label}), per seed (seed, worst FFN layer max diff / scale, FFN calls "
          f"compared, first decode logits max diff / scale, tokens equal): {spread}")


def rows_sets(gen, n_sets, N, C, ng, L):
    """n_sets random (N, C) row-id sets into a flat (L*ng, ...) store: C
    distinct groups of one random layer per token."""
    import torch

    return [torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                         + int(torch.randint(L, (1,), generator=gen, device="cuda")) * ng
                         for _ in range(N)]).to(torch.int32) for _ in range(n_sets)]


def phase_v6(v6, v6_plain, flat, L, ng):
    """sparse_ffn_block_v6 against its plain version at the 7B decode
    shapes, over the model's flat stores; with the kernels one call launches
    and their spans (torch.profiler in a child process: v6_ffn alone) and
    the launch plan (splits, blocks, wave ratio, stages)."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import v6_plan

    R, E, G = flat["w_upT_flat"].shape
    C = 12
    cases = ((1, "fatrelu"), (4, "fatrelu"), (4, "relu"))
    per_call = kernels_per_call([["v6", N, C, E, G, "bfloat16", act] for N, act in cases],
                                spans=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    results = []
    for (N, act), kernels in zip(cases, per_call):
        names = [k for k, _ in kernels[:-1]]
        check(len(names) == 1 and "v6_ffn" in names[0], f"v6 N={N} {act}: one call launched {names}")
        gated = act != "relu"
        idx = rows_sets(gen, N_SETS, N, C, ng, L)
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1
        wg = flat["w_gateT_flat"] if gated else None
        kw = dict(act=act, bu_sel=bu)
        args = lambda i: (x, idx[i % N_SETS], gp, flat["w_upT_flat"], wg, flat["w_down_flat"])
        got = v6(*args(0), **kw)
        torch.cuda.synchronize()
        err, tol = compare(f"v6 N={N} {act}", got, v6_plain(*args(0), **kw))
        ms = graph_ms(lambda i: v6(*args(i), **kw), N_SETS)
        host_ms = events_ms(lambda i: v6(*args(i), **kw), 200)
        plain_ms = graph_ms(lambda i: v6_plain(*args(i), **kw), 8)
        n_proj = 3 if gated else 2
        # least work per call, averaged over the row sets: each distinct
        # selected row read once, x/gp/bu/idx read and out written once;
        # 2 flops per weight and token
        rows_read = sum(len(torch.unique(t)) for t in idx) / N_SETS
        nbytes = (n_proj * rows_read * G * E * 2 + N * E * 2 + 2 * N * C * G * 4
                  + N * C * 4 + N * E * 4)
        bound_ms, by = bound(nbytes, 2 * n_proj * N * C * G * E, PEAK_F32_FLOP_S)
        row = dict(kernel="sparse_ffn_block_v6", N=N, act=act, max_abs_err=err, tol=tol,
                   ms=ms, eager_call_ms=host_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   GB_s=nbytes / (ms * 1e-3) / 1e9, launches_per_call=len(names),
                   span_us=kernels, plan=v6_plan(x.device, N, C, E, G, gated=gated))
        print("kernel check:", json.dumps(row))
        results.append(row)
    return results[0]  # N=1 fatrelu: the main path's decode shape


def phase_v6q(flat, L, ng, C):
    """sparse_ffn_block_v6q against its plain version at the 13B decode
    shapes, over the model's flat Q8_0 stores; with the kernels one call
    launches and their spans (torch.profiler in a child process: v6q_up
    then v6q_down) and the launch plan (column tiles, clusters, blocks,
    wave ratios)."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6q,
        sparse_ffn_block_v6q_plain,
        v6q_plan,
    )

    R, E, G = flat["qw_upT_flat"].shape
    per_call = kernels_per_call([["v6q", N, C, E, G, "bfloat16"] for N in (1, 4)], spans=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    stores = [flat[k] for k in ("qw_upT_flat", "s_upT_flat", "qw_gateT_flat",
                                "s_gateT_flat", "qw_down_flat", "s_down_flat")]
    results = []
    for N, kernels in zip((1, 4), per_call):
        names = [k for k, _ in kernels[:-1]]
        check(len(names) == 2 and "v6q_up" in names[0] and "v6q_down" in names[1],
              f"v6q N={N}: one call launched {names}")
        idx = rows_sets(gen, N_SETS, N, C, ng, L)
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        kw = dict(act="fatrelu")
        args = lambda i: (x, idx[i % N_SETS], gp, *stores)
        got = sparse_ffn_block_v6q(*args(0), **kw)
        torch.cuda.synchronize()
        err, tol = compare(f"v6q N={N}", got, sparse_ffn_block_v6q_plain(*args(0), **kw))
        ms = graph_ms(lambda i: sparse_ffn_block_v6q(*args(i), **kw), N_SETS)
        plain_ms = graph_ms(lambda i: sparse_ffn_block_v6q_plain(*args(i), **kw), 8)
        # each distinct selected row read once: int8 weights plus one f32
        # scale per 32 (1.125 bytes per weight), three projections
        rows_read = sum(len(torch.unique(t)) for t in idx) / N_SETS
        nbytes = (3 * rows_read * G * E * 1.125 + N * E * 2 + N * C * G * 4
                  + N * C * 4 + N * E * 4)
        bound_ms, by = bound(nbytes, 2 * 3 * N * C * G * E, PEAK_F32_FLOP_S)
        plan = v6q_plan(x.device, N, C, E, G)
        row = dict(kernel="sparse_ffn_block_v6q", N=N, C=C, G=G, E=E, act="fatrelu",
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   GB_s=nbytes / (ms * 1e-3) / 1e9, launches_per_call=len(names),
                   span_us=kernels, plan=plan)
        print("kernel check:", json.dumps(row))
        results.append(row)
    return results[0]


# Run in a child process: inside this one, after phase 4's CUDA graphs, a
# short torch.profiler window records no device activity at all.
KERNELS_PER_CALL = r"""
import json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from sparkinfer_tpu_torch.ops import quant_matmul as qm

gen = torch.Generator(device="cuda").manual_seed(0)
result = []
for kind, N, IN, OUT, L, xdt, *rest in json.loads(sys.argv[1]):
    ld = OUT * L
    if kind == "v6":  # N tokens, IN = C selections of 86 groups, OUT = E, L = G; rest: act
        from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v6
        w = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
             for sh in ((86, OUT, L), (86, OUT, L), (86, L, OUT))]
        if rest[0] == "relu":
            w[1] = None
        idx = torch.stack([torch.randperm(86, generator=gen, device="cuda")[:IN]
                           for _ in range(N)]).to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        bu = torch.randn((N, IN, L), generator=gen, device="cuda") * 0.1
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        fn = lambda: sparse_ffn_block_v6(x, idx, gp, *w, act=rest[0], bu_sel=bu)
    elif kind == "v6q":  # N tokens, IN = C selections of 108 groups, OUT = E, L = G
        from sparkinfer_tpu_torch.ops.sparse_ffn import quantize_rows_q8_0, sparse_ffn_block_v6q
        w = [t for sh in ((108, OUT, L), (108, OUT, L), (108, L, OUT))
             for t in quantize_rows_q8_0(torch.randn(sh, generator=gen, device="cuda") * 0.02)]
        idx = torch.stack([torch.randperm(108, generator=gen, device="cuda")[:IN]
                           for _ in range(N)]).to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        fn = lambda: sparse_ffn_block_v6q(x, idx, gp, *w, act="fatrelu")
    elif kind == "rows":  # N tokens, IN = C selections of 86 groups, OUT = E, L = G; rest: wrapper
        from sparkinfer_tpu_torch.ops import sparse_ffn as sf
        w = (torch.randn((3 * 86, L, OUT), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        idx = torch.stack([torch.randperm(86, generator=gen, device="cuda")[:IN]
                           for _ in range(N)]).to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        bu = torch.randn((N, IN, L), generator=gen, device="cuda") * 0.1
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        if rest[0] == "sparse_ffn_block_v2":
            fn = lambda: sf.sparse_ffn_block_v2(x, idx, gp, w, act="fatrelu", gated=True, R=86,
                                                bu_sel=bu)
        elif rest[0] == "sparse_ffn_block_v4":
            il = sf.interleave_rows(w[:86], w[86:172], w[172:])
            fn = lambda: sf.sparse_ffn_block_v4(x, idx, gp, il, act="fatrelu", gated=True,
                                                bu_sel=bu)
        else:
            fn = lambda: getattr(sf, rest[0])(x, idx, gp, w[:86], w[86:172], w[172:],
                                              act="fatrelu", bu_sel=bu)
    elif kind == "v7u":  # N tokens, IN = Cu union rows, OUT = E, L = G
        from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block_v7u
        w = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
             for sh in ((IN + 3, OUT, L), (IN + 3, OUT, L), (IN + 3, L, OUT))]
        union = torch.randperm(IN + 3, generator=gen, device="cuda")[:IN].to(torch.int32)
        gp = torch.rand((N, IN, L), generator=gen, device="cuda")
        x = torch.randn((N, OUT), generator=gen, device="cuda").to(getattr(torch, xdt))
        fn = lambda: sparse_ffn_block_v7u(x, union, gp, *w, act="fatrelu")
    else:
        if kind == "q8_0":
            q = torch.randint(-127, 128, (IN, ld), generator=gen, device="cuda").to(torch.int8)
        else:
            q = torch.randint(0, 256, (IN // 2, ld), generator=gen, device="cuda").to(torch.uint8)
        s = torch.rand((IN // 32, ld), generator=gen, device="cuda") * 0.01
        x = torch.randn((N, IN), generator=gen, device="cuda").to(getattr(torch, xdt))
        if L == 1:
            fn = lambda: qm.quant_matmul_2d(x, q, s, kind=kind)
        else:
            fn = lambda: qm.quant_matmul_flat(x, q, s, L - 1, kind=kind, out_dim=OUT)
    fn()
    marker = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        marker.fill_(1.0)
        fn()
        marker.fill_(2.0)
        torch.cuda.synchronize()
        time.sleep(0.2)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)
    result.append([[e.name[:120], 1, e.time_range.start, e.time_range.end] for e in kernels])
    del fn
    torch.cuda.empty_cache()
print(json.dumps(result))
"""


def kernels_per_call(specs, names: bool = False, spans: bool = False) -> list:
    """Device kernels that one call launches, for each (kind, N, IN, OUT,
    layers, x dtype) of a quant matmul (layers > 1: quant_matmul_flat on the
    last layer's stripe), ("v7u", B, Cu, E, G, x dtype) of the union FFN
    over bf16 stores, ("v6", N, C, E, G, x dtype, act) of the decode FFN
    over 86 groups of bf16 stores with an up bias, ("rows", N, C, E, G, x
    dtype, wrapper) of a row-store wrapper (v1-v5) over 86 groups of bf16
    stores with an up bias, or ("v6q", N, C, E, G, x dtype) of the Q8_0 FFN
    over 108 groups, by torch.profiler in a child
    process over random stores of
    those shapes. The call lies between two marker kernels (fill_), and the
    window opens and closes with a pause; a window that misses a marker
    fails. names: the kernels' names in launch order; spans: their [name,
    span us] pairs; else their count."""
    proc = subprocess.run([sys.executable, "-c", KERNELS_PER_CALL, json.dumps(specs)],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"kernels-per-call profile failed: {proc.stderr[-2000:]}")
    counts = []
    for spec, rows in zip(specs, json.loads(proc.stdout.strip().splitlines()[-1])):
        fills = sum(c for k, c, *_ in rows if "FillFunctor" in k)
        check(fills == 2, f"{spec}: profile window recorded {fills} of its 2 markers: {rows}")
        calls = [r for r in rows if "FillFunctor" not in r[0]]
        kernels = [r[0] for r in calls]
        # each kernel's span in this one profiled call (us); a dependent
        # launch's span includes its wait for the kernel before it
        span_us = [round(end - start, 3) for _, _, start, end in calls]
        total = round(calls[-1][3] - calls[0][2], 3) if calls else 0
        print(f"kernels per call {spec}: {len(kernels)} {[k[:60] for k in kernels]} "
              f"span us {span_us}, first start to last end {total}")
        if spans:
            counts.append([[k[:60], us] for k, us in zip(kernels, span_us)] + [["all", total]])
        else:
            counts.append(kernels if names else len(kernels))
    return counts


def qmm_row(label, kernel, plain, stores, x, kind, per_call, flat_out=None):
    """Time one quant matmul over its list of cold (packed, scales[, il])
    stores: kernel, plain version and the bf16 torch.matmul of the
    dequantized weights (16 of them, more bytes than L2 holds). per_call:
    the kernels one call launches (kernels_per_call), which must be 1:
    qmm_decode at N <= 4, qmm_prefill above."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.ops.quant_matmul import dequant_bf16

    n = len(stores)
    N, IN = x.shape
    if flat_out is None:
        call = lambda f, i: f(x, *stores[i % n], kind=kind)
        OUT = stores[0][0].shape[1]
    else:
        call = lambda f, i: f(x, *stores[i % n], kind=kind, out_dim=flat_out)
        OUT = flat_out
    got = call(kernel, 0)
    torch.cuda.synchronize()
    err, tol = compare(label, got, call(plain, 0))
    check(per_call == 1, f"{label}: {per_call} kernels in one call")
    ms = graph_ms(lambda i: call(kernel, i), N_SETS)
    plain_ms = graph_ms(lambda i: call(plain, i), 8)

    def weight(i):
        q, s, *il = stores[i % n]
        if il:
            c0 = il[0] * OUT
            q, s = q[:, c0:c0 + OUT], s[:, c0:c0 + OUT]
        return dequant_bf16(q, s, kind)

    dense = [weight(i) for i in range(min(n, 16))]
    xb = x.to(torch.bfloat16)
    library_ms = graph_ms(lambda i: torch.matmul(xb, dense[i % len(dense)]), N_SETS)
    del dense
    div = 2 if kind == "q4_0" else 1
    nbytes = IN // div * OUT + IN // 32 * OUT * 4 + N * IN * x.element_size() + N * OUT * 4
    bound_ms, by = bound(nbytes, 2 * N * IN * OUT, PEAK_BF16_FLOP_S)
    row = dict(kernel=label.split()[0], shape=label, max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
               GB_s=nbytes / (ms * 1e-3) / 1e9, TFLOP_s=2 * N * IN * OUT / (ms * 1e-3) / 1e12,
               launches_per_call=per_call,
               plan=qm.launch_plan(x.device, N, IN, OUT, kind))  # tile, K splits, waves
    print("kernel check:", json.dumps(row))
    torch.cuda.empty_cache()
    return row


def phase_quant_matmul(params):
    """quant_matmul_2d and quant_matmul_flat against their plain versions at
    the 13B shapes: the model's own stores where it has them (64 of its
    160 attention matrices, the 40 layers of each predictor stack, its
    head), 64 random Q4_0 stores."""
    import torch

    from sparkinfer_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    lay, flat = params["layers"], params["sparse_flat"]
    E = lay["wq"].shape[-2]
    q8 = [(t.q[il], t.s[il]) for t in (lay["wq"], lay["wk"]) for il in range(t.q.shape[0])]
    q8 = q8[:N_SETS]
    q4q = torch.randint(0, 256, (N_SETS, E // 2, E), generator=gen, device="cuda",
                        dtype=torch.uint8)
    q4s = torch.rand((N_SETS, E // 32, E), generator=gen, device="cuda") * 0.002
    q4 = [(q4q[i], q4s[i]) for i in range(N_SETS)]
    V = params["output"].q.shape[-1]
    flat_specs = [(key, N, flat[key].shape[0], flat[key].out_dim)
                  for key, N in (("pred_up_qt", 1), ("pred_down_qt", 1), ("pred_down_qt", 4),
                                 ("pred_up_qt", 32), ("pred_down_qt", 32))]
    specs = ([("q8_0", N, E, E, 1, "bfloat16") for N in (1, 4, 8, 32, 512)]
             + [("q4_0", N, E, E, 1, "bfloat16") for N in (1, 32)]
             + [("q8_0", N, E, V, 1, "bfloat16") for N in (1, 32)]
             + [("q8_0", N, IN, OUT, 3, "float32") for _, N, IN, OUT in flat_specs])
    per_call = dict(zip(specs, kernels_per_call(specs)))
    rows = []
    # decode at B = 1 and 4; a batch of 8; a 32-token prefill; a 512-token chunk
    for N in (1, 4, 8, 32, 512):
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(qmm_row(f"quant_matmul_2d q8_0 {E}x{E} N={N}", qm.quant_matmul_2d,
                            qm.quant_matmul_2d_plain, q8, x, "q8_0",
                            per_call[("q8_0", N, E, E, 1, "bfloat16")]))
        if N in (1, 32):
            rows.append(qmm_row(f"quant_matmul_2d q4_0 {E}x{E} N={N}", qm.quant_matmul_2d,
                                qm.quant_matmul_2d_plain, q4, x, "q4_0",
                                per_call[("q4_0", N, E, E, 1, "bfloat16")]))
    del q4, q4q, q4s
    head = params["output"]
    for N in (1, 32):
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(qmm_row(f"quant_matmul_2d q8_0 head {E}x{V} N={N}",
                            qm.quant_matmul_2d, qm.quant_matmul_2d_plain, [(head.q, head.s)],
                            x, "q8_0", per_call[("q8_0", N, E, V, 1, "bfloat16")]))
    flat_rows = []
    for key, N, IN, OUT in flat_specs:
        t = flat[key]
        L = t.q.shape[1] // OUT
        x = torch.randn((N, IN), generator=gen, device="cuda")  # the predictor's f32 input
        flat_rows.append(qmm_row(
            f"quant_matmul_flat q8_0 {IN}x{OUT} N={N}", qm.quant_matmul_flat,
            qm.quant_matmul_flat_plain, [(t.q, t.s, il) for il in range(L)], x, "q8_0",
            per_call[("q8_0", N, IN, OUT, 3, "float32")], flat_out=OUT))
    return rows[0], flat_rows[1]  # the main path's attention and pred_down shapes


def phase_serving_reference(sparse_cfg_cls, sampler):
    """f32 references of the serving paths, kernel against plain: the
    Scheduler on a tiny model (v1) on the card against the CPU, and the
    union FFN (v7u) of a 2-layer 7B-width model against "gather_union"."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.ops.sparse_ffn import sparse_ffn_block, sparse_ffn_block_v7u
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.runtime.scheduler import Request, Scheduler
    from sparkinfer_tpu_torch.sparse import ffn as sffn
    from sparkinfer_tpu_torch.sparse.predictor import predict_activations

    cfg = prosparse_config(2, 256, 8, 512, 1024, 64)
    scfg = sparse_cfg_cls(group_size=128, capacity_groups=2)
    model = random_model(cfg, torch.float32, "cuda", SEED + 6)
    prompts = [list(range(3 + i, 40, 2 + i)) for i in range(4)]
    outs = []
    for dev in ("cuda", "cpu"):
        m = type(model)(config=cfg, params=to_device(model.params, dev))
        sched = Scheduler(m, n_slots=2, max_seq=64, sampler=sampler, kv_dtype=torch.float32,
                          sparse=scfg, sparse_batch_max=2, device=dev)
        sparse_ffn_block.launches = 0
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=12)) for p in prompts]
        sched.step()  # admits two requests and decodes them once
        first = sched.last_logits.float().cpu()
        sched.run_until_idle()
        toks = [r.tokens() for r in reqs]
        check(all(len(t) == 12 for t in toks), f"Scheduler on {dev}: short streams {toks}")
        if dev == "cuda":  # each tick, and the graph's warm-up
            runs = sched.metrics["n_decode_steps"] + sched.graphs.captures
            check(sparse_ffn_block.launches == cfg.n_layer * runs,
                  f"v1 launched {sparse_ffn_block.launches} times in {runs} tick forwards")
        outs.append((first, toks))
        del sched, m
    check_pair("Scheduler tiny, 4 requests on 2 slots, card v1 kernel vs CPU plain", outs)

    cfg = prosparse_config(2, 4096, 32, 11008, 32000, 1024)
    scfg = sparse_cfg_cls(group_size=128, capacity_groups=12)
    model = random_model(cfg, torch.float32, "cuda", SEED + 1)
    params = sffn.prepare_pipelined_params(model.params, cfg, scfg, layout="v6")
    F, E, B = cfg.n_ff, cfg.n_embd, 8
    ng, G = scfg.n_groups(F), scfg.group_size
    lp = {k: v[1] for k, v in params["layers"].items()} | dict(params["sparse_flat"], flat_il=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn((1, B, E), generator=gen, device="cuda")
    probs = predict_activations(lp, x[0])
    idx = sffn.select_groups(probs, scfg, F)
    carry = {"idx": idx, "gp_sel": torch.gather(probs.reshape(B, ng, G), 1,
                                                idx.long()[..., None].expand(-1, -1, G))}
    n_union = len(torch.unique(idx))

    def union_out(mode, union_groups=None):
        ffn, _ = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode=mode, union_groups=union_groups)
        return ffn(lp, x, carry, 1)[0]

    for label, ugroups, ref_mode in (("Cu=48, truncated", None, "gather_union"),
                                     (f"Cu={ng}, the whole union", ng, "gather")):
        got = union_out("kernel_union", ugroups)
        ref = union_out(ref_mode, ugroups)
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        print(f"reference (union FFN, 7B widths, B={B}, {n_union} groups selected, {label}): "
              f"kernel_union vs {ref_mode} max diff {err:.3e} (scale {scale:.3e})")
        check(bool(torch.isfinite(got).all()) and err <= UNION_TOL * scale,
              f"union FFN {label}: {err:.3e} > {UNION_TOL} of {scale:.3e}")
    ffn_u, ci_u = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode="kernel_union")
    toks = torch.randint(cfg.n_vocab, (B, 4), generator=gen, device="cuda")
    pos = torch.arange(4, device="cuda")[None].expand(B, 4)
    sparse_ffn_block_v7u.launches = 0
    logits = make_forward(cfg, ffn_fn=ffn_u, ffn_carry_init=ci_u)(
        params, toks, pos, init_cache(cfg, B, 16, torch.float32, "cuda"))
    check(bool(torch.isfinite(logits).all()), "union forward: non-finite logits")
    check(sparse_ffn_block_v7u.launches == cfg.n_layer, "union forward: v7u launches")
    print(f"reference (union forward, B={B}, 4 tokens each): logits finite, "
          f"v7u launched {cfg.n_layer} times")
    del model, params, lp
    torch.cuda.empty_cache()


ROW_WRAPPERS = ("sparse_ffn_block", "sparse_ffn_block_v2", "sparse_ffn_block_v3",
                "sparse_ffn_block_v4", "sparse_ffn_block_v5")


def row_kernels_per_call(C, E, G) -> dict:
    """{(wrapper, N): [[kernel, span us], ..., ["all", us]]} of one call of
    each row-store wrapper at N = 1 and 4, from one child process."""
    specs = [["rows", N, C, E, G, "bfloat16", name] for name in ROW_WRAPPERS for N in (1, 4)]
    spans = kernels_per_call(specs, spans=True)
    return {(spec[6], spec[1]): kernels for spec, kernels in zip(specs, spans)}


def row_kernel_rows(name, fn, plain, stores_of, layers, ng, C, seed, bias, per_call):
    """A row-store kernel (v1, v2, v3, v4, v5) against its plain version at
    the 7B decode shapes, N = 1 and 4, fatrelu: each call takes C groups of
    one random layer of `layers` per token, stores_of(il) giving that
    layer's store arguments and keyword arguments; bias adds an up bias.
    per_call: row_kernels_per_call's spans, which must be v1_ffn alone."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import v1_plan

    gen = torch.Generator(device="cuda").manual_seed(seed)
    stores, extra = stores_of(layers[0])
    G, E = stores[0].shape[-2:]
    results = []
    for N in (1, 4):
        sets = [(layers[int(torch.randint(len(layers), (1,), generator=gen, device="cuda"))],
                 torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                              for _ in range(N)]).to(torch.int32)) for _ in range(N_SETS)]
        x = torch.randn((N, E), generator=gen, device="cuda").to(torch.bfloat16)
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1 if bias else None

        def call(f, i):
            il, idx = sets[i % N_SETS]
            stores, extra = stores_of(il)
            return f(x, idx, gp, *stores, act="fatrelu", bu_sel=bu, **extra)

        kernels = per_call[(name, N)]
        names = [k for k, _ in kernels[:-1]]
        check(len(names) == 1 and "v1_ffn" in names[0], f"{name} N={N}: one call launched {names}")
        got = call(fn, 0)
        torch.cuda.synchronize()
        err, tol = compare(f"{name} N={N}", got, call(plain, 0))
        ms = graph_ms(lambda i: call(fn, i), N_SETS)
        host_ms = events_ms(lambda i: call(fn, i), 200)
        plain_ms = graph_ms(lambda i: call(plain, i), 8)
        # each distinct selected row of each projection read once; x, gp,
        # (bu,) idx read and out written once; 2 flops per weight and token
        rows_read = sum(len(torch.unique(idx)) for _, idx in sets) / N_SETS
        nbytes = (3 * rows_read * G * E * 2 + N * E * 2 + (2 if bias else 1) * N * C * G * 4
                  + N * C * 4 + N * E * 4)
        bound_ms, by = bound(nbytes, 2 * 3 * N * C * G * E, PEAK_F32_FLOP_S)
        row = dict(kernel=name, N=N, C=C, G=G, E=E, act="fatrelu", up_bias=bias,
                   max_abs_err=err, tol=tol, ms=ms, eager_call_ms=host_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
                   rows_read=rows_read, GB_s=nbytes / (ms * 1e-3) / 1e9,
                   launches_per_call=len(names), span_us=kernels,
                   plan=v1_plan(x.device, N, C, E, G))
        print("kernel check:", json.dumps(row))
        results.append(row)
    return results[0]


def phase_rows(rows, C):
    """v1, v3, v5 over the Scheduler's row stores (L, ng, G, E), and v4 over
    their interleave (L, ng, P, G, E), every layer's rows: v1 without a
    bias, at the draws of its earlier timings, the others with an up bias.
    Returns {kernel: N=1 row} and the five wrappers' kernels per call."""
    import torch

    from sparkinfer_tpu_torch.ops import sparse_ffn as sf

    wu, wg, wd = rows["w_up_rows"], rows["w_gate_rows"], rows["w_down_rows"]
    L, ng, G, E = wu.shape
    layers = list(range(L))
    per_call = row_kernels_per_call(C, E, G)

    def three(il):
        return (wu[il], wg[il], wd[il]), {}

    out = {}
    for seed, name, bias in ((8, "sparse_ffn_block", False), (12, "sparse_ffn_block_v3", True),
                             (13, "sparse_ffn_block_v5", True)):
        out[name] = row_kernel_rows(name, getattr(sf, name), getattr(sf, name + "_plain"),
                                    three, layers, ng, C, SEED + seed, bias, per_call)
    il_store = sf.interleave_rows(wu, wg, wd)  # (L, ng, 3, G, E): 8.7 GB at 7B bf16
    out["sparse_ffn_block_v4"] = row_kernel_rows(
        "sparse_ffn_block_v4", sf.sparse_ffn_block_v4, sf.sparse_ffn_block_v4_plain,
        lambda il: ((il_store[il],), {"gated": True}), layers, ng, C, SEED + 14, True, per_call)
    del il_store
    torch.cuda.empty_cache()
    return out, per_call


def v7u_row(label, stores, unions, B, Cu, C, gen, per_call):
    """sparse_ffn_block_v7u against its plain version over the flat stores,
    timed over the union sets (cold): bf16 x, each token having selected C
    of the Cu groups; with the launches of one call (per_call, which must be
    the up and down kernels) and the launch plan."""
    import torch

    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v7u,
        sparse_ffn_block_v7u_plain,
        v7u_plan,
    )

    R, E, G = stores[0].shape
    x = torch.randn((B, E), generator=gen, device="cuda").to(torch.bfloat16)
    sel = torch.rand((B, Cu), generator=gen, device="cuda").argsort(-1) < C
    gp = torch.rand((B, Cu, G), generator=gen, device="cuda") * sel[..., None]
    kw = dict(act="fatrelu")
    n = len(unions)
    args = lambda i: (x, unions[i % n], gp, *stores)  # noqa: E731
    got = sparse_ffn_block_v7u(*args(0), **kw)
    torch.cuda.synchronize()
    err, tol = compare(f"v7u {label}", got, sparse_ffn_block_v7u_plain(*args(0), **kw))
    check(len(per_call) == 2 and "v7u_up" in per_call[0] and "v7u_down" in per_call[1],
          f"v7u {label}: one call launched {per_call}")
    ms = graph_ms(lambda i: sparse_ffn_block_v7u(*args(i), **kw), N_SETS)
    plain_ms = graph_ms(lambda i: sparse_ffn_block_v7u_plain(*args(i), **kw), 8)
    # each union row of each projection read once, whatever B is; x, gp,
    # the union and out once; 2 flops per weight and token on the bf16
    # tensor cores
    nbytes = 3 * Cu * G * E * 2 + B * E * 2 + B * Cu * G * 4 + Cu * 4 + B * E * 4
    bound_ms, by = bound(nbytes, 2 * 3 * B * Cu * G * E, PEAK_BF16_FLOP_S)
    plan = v7u_plan(x.device, B, Cu, E, G)
    row = dict(kernel="sparse_ffn_block_v7u", shape=label, B=B, Cu=Cu, G=G, E=E, R=R,
               act="fatrelu", max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=by, library_ms=None, x_bound=ms / bound_ms,
               GB_s=nbytes / (ms * 1e-3) / 1e9, launches_per_call=len(per_call),
               blocks={"up": plan["up"]["blocks"], "down": plan["down"]["blocks"]},
               cluster={"up": plan["up"]["cluster"], "down": plan["down"]["cluster"]},
               wave_ratio={"up": plan["up"]["wave_ratio"], "down": plan["down"]["wave_ratio"]})
    print("kernel check:", json.dumps(row))
    return row


def phase_v7u(flat, L, ng, C=12):
    """sparse_ffn_block_v7u against its plain version at the 7B batched
    decode shapes, B = 1, 4, 8 and Cu = 48, over the model's flat stores
    (each call's union is Cu groups of one random layer), and at 13B widths,
    B = 8, Cu = 64 of 108 groups, E = 5120, over one layer's random bf16
    stores (R = 108, 252 MB). Returns the B = 8, Cu = 48 row."""
    import torch

    specs = [["v7u", B, 48, 4096, 128, "bfloat16"] for B in (1, 4, 8)]
    specs.append(["v7u", 8, 64, 5120, 128, "bfloat16"])
    per_call = kernels_per_call(specs, names=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    stores = [flat[k] for k in ("w_upT_flat", "w_gateT_flat", "w_down_flat")]
    unions = [(torch.randperm(ng, generator=gen, device="cuda")[:48]
               + int(torch.randint(L, (1,), generator=gen, device="cuda")) * ng).to(torch.int32)
              for _ in range(N_SETS)]
    rows = {B: v7u_row(f"7B B={B} Cu=48", stores, unions, B, 48, C, gen, names)
            for B, names in zip((1, 4, 8), per_call)}
    E13, G, R13 = 5120, 128, 108
    stores13 = [(torch.randn(shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
                for shape in ((R13, E13, G), (R13, E13, G), (R13, G, E13))]
    unions13 = [torch.randperm(R13, generator=gen, device="cuda")[:64].to(torch.int32)
                for _ in range(N_SETS)]
    v7u_row("13B B=8 Cu=64", stores13, unions13, 8, 64, 16, gen, per_call[3])
    del stores13
    torch.cuda.empty_cache()
    return rows[8]


def scheduler_path(sched, prompts, n_new):
    """The Scheduler's main path: every request served, every tick's
    logits finite, v1 launched n_layer times per tick forward (each replay
    of the tick's graph, and its warm-up) and no other kernel (counts set
    to 0 just before, read just after)."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request

    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    captures = sched.graphs.captures
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
    while sched.step():
        check(bool(torch.isfinite(sched.last_logits).all()), "Scheduler: non-finite logits")
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    toks = [r.tokens() for r in reqs]
    check(all(len(t) == n_new for t in toks), f"Scheduler: short streams {toks}")
    m = sched.metrics_snapshot()
    ticks = m["n_decode_steps"]
    warm = sched.graphs.captures - captures
    L = sched.cfg.n_layer
    for name, n in launches.items():
        want = L * (ticks + warm) if name == "sparse_ffn_block" else 0
        check(n == want, f"Scheduler: {name} launched {n} times, want {want}")
    check(m["n_dense_steps"] == 0, "Scheduler: a tick took the dense step")
    decode_tps = (m["n_tokens_generated"] - m["n_requests"]) / m["t_decode_s"]
    print(f"main path Scheduler 7B bf16 sparse: {len(prompts)} requests on {sched.n_slots} "
          f"slots, {ticks} ticks, decode {decode_tps:.2f} tok/s aggregate "
          f"({1e3 * m['t_decode_s'] / ticks:.2f} ms/tick), prefill {m['prefill_tps']:.1f} "
          f"tok/s, wall {wall:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {json.dumps(launches)} (as expected: {ticks} ticks, {warm} warm-up)")
    print(f"main path Scheduler tokens (first 2): {toks[:2]}")
    # a profile of a few ticks with every slot running: v1's device time
    # and launches (one kernel a call, L a decode tick), the f32 copies'
    for p in prompts[:sched.n_slots]:
        sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
    sched.step()
    ticks0 = sched.metrics_snapshot()["n_decode_steps"]
    rows, _ = profile_steps(f"Scheduler ticks ({sched.n_slots} slots)", sched.step, 6)
    ticks = sched.metrics_snapshot()["n_decode_steps"] - ticks0
    v1_prof = [(k, ms, n) for k, ms, n in rows if "v1_" in k or "sum_row_chunks" in k]
    copies = [(k, ms, n) for k, ms, n in rows if "direct_copy_kernel" in k]
    print("profile: v1 in the Scheduler's ticks:", json.dumps({
        "decode_ticks": ticks,
        "device_ms_per_tick": sum(ms for _, ms, _ in v1_prof) / ticks,
        "launches_per_tick": sum(n for _, _, n in v1_prof) / ticks,
        "kernels": {k[:60]: [ms / ticks, n / ticks] for k, ms, n in v1_prof},
        "f32_copies": {"device_ms_per_tick": sum(ms for _, ms, _ in copies) / ticks,
                       "launches_per_tick": sum(n for _, _, n in copies) / ticks}}))
    check(ticks > 0 and all("v1_ffn" in k for k, _, _ in v1_prof)
          and sum(n for _, _, n in v1_prof) == L * ticks,
          f"the profiled ticks launched {v1_prof} v1 kernels over {ticks} ticks, want {L} a tick")
    sched.run_until_idle()
    return launches["sparse_ffn_block"]


def phase_batched(cfg, scfg, dense_params, flat_params, row_params, steps: int = 8,
                  trials: int = 3):
    """Aggregate decode tok/s at B in BATCHES (bench.py batch): dense,
    masked-dense (the Scheduler's fallback), per-token v6, union v7u and
    the Scheduler's v1 step, each decoding greedily on from its own 32-token
    dense prefill. The modes run in turns, `trials` runs of `steps` steps
    each, and the best run counts (the host's clock varies run to run);
    every run's launch counts are checked. Returns the v7u launches of the
    last timed run (B = 8) and the crossover: the largest B at which v1
    beats masked-dense, 0 where it never does."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache
    from sparkinfer_tpu_torch.sparse import ffn as sffn
    from sparkinfer_tpu_torch.sparse.config import sparse_batch_crossover

    L = cfg.n_layer
    ffn6, ci6 = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode="kernel")
    ffnu, ciu = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode="kernel_union")
    modes = {
        "dense": (make_forward(cfg), dense_params, None),
        "masked_dense": (make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "dense")),
                         row_params, None),
        "v6": (make_forward(cfg, ffn_fn=ffn6, ffn_carry_init=ci6), flat_params,
               "sparse_ffn_block_v6"),
        "v7u": (make_forward(cfg, ffn_fn=ffnu, ffn_carry_init=ciu), flat_params,
                "sparse_ffn_block_v7u"),
        "v1": (make_forward(cfg, ffn_fn=sffn.make_sparse_ffn(cfg, scfg, "kernel")),
               row_params, "sparse_ffn_block"),
    }
    prefill = make_forward(cfg, fresh_prefill=True)
    wrappers = kernel_wrappers()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    table = []
    for B in BATCHES:
        prompt = torch.randint(cfg.n_vocab, (B, 32), generator=gen, device="cuda")
        pos = torch.arange(32, device="cuda")[None].expand(B, 32)
        caches, toks = {}, {}
        for name in modes:  # each mode decodes on from its own 32-token prefill
            caches[name] = init_cache(cfg, B, 32 + 2 + trials * steps + PROFILE_STEPS,
                                      torch.bfloat16, "cuda")
            toks[name] = prefill(dense_params, prompt, pos, caches[name])[:, -1].argmax(
                -1, keepdim=True)
        n_past = 32
        best = dict.fromkeys(modes, float("inf"))
        for trial in range(trials + 1):  # the modes in turns; trial 0 warms up
            n = 1 if trial == 0 else steps
            for name, (fwd, params, kname) in modes.items():
                for w in wrappers.values():
                    w.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for s in range(n):
                    logits = fwd(params, toks[name], torch.full((B, 1), n_past + s, device="cuda"),
                                 caches[name])[:, -1]
                    toks[name] = logits.argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                check(bool(torch.isfinite(logits).all()), f"batched {name} B={B}: non-finite")
                for wname, w in wrappers.items():
                    want = L * n if wname == kname else 0
                    check(w.launches == want,
                          f"batched {name} B={B}: {wname} launched {w.launches}, want {want}")
                if trial > 0:
                    best[name] = min(best[name], dt / n)
            n_past += n
        row = {"B": B, **{name: B / t for name, t in best.items()},
               "ms_per_step": {name: round(1e3 * t, 3) for name, t in best.items()}}
        print("batched decode (aggregate tok/s, best of "
              f"{trials} x {steps} steps):", json.dumps(
                  {k: (round(v, 2) if isinstance(v, float) else v) for k, v in row.items()}))
        table.append(row)
        if B == BATCHES[-1]:  # v7u's share of a profiled batched step's device time
            fwd, params, _ = modes["v7u"]
            at = {"n": n_past}

            def step():
                toks["v7u"] = fwd(params, toks["v7u"], torch.full((B, 1), at["n"], device="cuda"),
                                  caches["v7u"])[:, -1].argmax(-1, keepdim=True)
                at["n"] += 1

            rows, wall_ms = profile_steps(f"v7u batched decode steps (B={B})", step, PROFILE_STEPS)
            v7u = [(k, ms, n) for k, ms, n in rows if "v7u_" in k]
            device_ms = sum(r[1] for r in rows)
            check(sum(r[2] for r in v7u) == 2 * L * PROFILE_STEPS,
                  f"profiled v7u step: {v7u} (want {2 * L} v7u kernels a step)")
            print("v7u step profile:", json.dumps({
                "B": B, "steps": PROFILE_STEPS, "device_ms_per_step": device_ms / PROFILE_STEPS,
                "wall_ms_per_step": wall_ms / PROFILE_STEPS,
                "v7u_ms_per_step": sum(r[1] for r in v7u) / PROFILE_STEPS,
                "v7u_share_of_device_time": sum(r[1] for r in v7u) / device_ms,
                "v7u_kernels": {k[:40]: [ms / PROFILE_STEPS, n // PROFILE_STEPS]
                                for k, ms, n in v7u}}))
        del caches
    crossover = max([r["B"] for r in table if r["v1"] > r["masked_dense"]], default=0)
    print(f"batched decode: v1 beats masked-dense up to B={crossover} "
          f"(sparse_batch_crossover({cfg.n_ff}) gives {sparse_batch_crossover(cfg.n_ff)})")
    return L * steps, crossover


def greedy_forward(fwd, params, cfg, prompt, n_new):
    """Greedy decode through a bare forward, as sparkinfer-bench drives one:
    the prompt through fwd, then n_new steps. Returns (the first decode
    step's logits on the CPU, the tokens, the number of forwards)."""
    import torch

    from sparkinfer_tpu_torch.runtime.kv_cache import init_cache

    cache = init_cache(cfg, 1, len(prompt) + n_new + 1, torch.float32, "cuda")
    logits = fwd(params, torch.tensor([prompt], device="cuda"),
                 torch.arange(len(prompt), device="cuda")[None], cache)[:, -1]
    toks, first = [], None
    for i in range(n_new):
        toks.append(int(logits.argmax(-1)))
        logits = fwd(params, torch.tensor([[toks[-1]]], device="cuda"),
                     torch.tensor([[len(prompt) + i]], device="cuda"), cache)[:, -1]
        first = logits.float().cpu() if first is None else first
    return first, toks, 1 + n_new


def set_kernel_v2(on: bool):
    import os

    if on:
        os.environ["SPIF_KERNEL_V2"] = "1"
    else:
        os.environ.pop("SPIF_KERNEL_V2", None)


def phase_bench_reference(sparse_cfg_cls):
    """f32 reference of sparkinfer-bench's sparse decode at 7B widths cut to
    2 layers: the v2 path (SPIF_KERNEL_V2 over w_all_rows), the v1 path and
    the "gather" math over the row stores, all on the card, give equal
    greedy tokens and first-decode logits within 1e-4 of their scale (in
    f32 the hidden's rounding to the store dtype is exact); each kernel
    path launches its kernel n_layer times per forward and no other."""
    import torch

    from sparkinfer_tpu_torch.models.transformer import make_forward
    from sparkinfer_tpu_torch.sparse import ffn as sffn

    cfg = prosparse_config(2, 4096, 32, 11008, 32000, 1024)
    scfg = sparse_cfg_cls(group_size=128, capacity_groups=12)
    model = random_model(cfg, torch.float32, "cuda", SEED + 15)
    wrappers = kernel_wrappers()
    set_kernel_v2(True)
    try:
        params = sffn.prepare_pipelined_params(model.params, cfg, scfg)
        outs = {}
        for label, mode, v2, kname in (("v2", "kernel", True, "sparse_ffn_block_v2"),
                                       ("v1", "kernel", False, "sparse_ffn_block"),
                                       ("gather", "gather", False, None)):
            set_kernel_v2(v2)
            ffn, ci = sffn.make_pipelined_sparse_ffn(cfg, scfg, mode=mode)
            for w in wrappers.values():
                w.launches = 0
            with torch.inference_mode():
                first, toks, n_fwd = greedy_forward(
                    make_forward(cfg, ffn_fn=ffn, ffn_carry_init=ci), params, cfg,
                    list(range(3, 40, 3)), 16)
            for name, w in wrappers.items():
                want = cfg.n_layer * n_fwd if name == kname else 0
                check(w.launches == want,
                      f"bench reference {label}: {name} launched {w.launches}, want {want}")
            outs[label] = (first, toks)
    finally:
        set_kernel_v2(False)
    for label in ("v2", "v1"):
        check_pair(f"bench path 7B widths 2 layers, card {label} kernel vs card gather",
                   [outs[label], outs["gather"]])
    del model, params
    torch.cuda.empty_cache()


def phase_bench(model, scfg, tg=16, reps=3, ctx=1024):
    """sparkinfer-bench's decode rows (tools.bench_matrix.bench_tg) on the
    7B-width model: a 512-token seed prefill into a ctx-token cache, one
    warm-up step, the median of `reps` runs of `tg` steps, at B = 1 and 4,
    for three paths: dense; sparse over the v1 row layout (v1 n_layer times
    per forward, no other kernel); sparse with SPIF_KERNEL_V2 (v2 n_layer
    times per forward, no other kernel). Every count is set to 0 just
    before each bench_tg call and read just after. Returns the v2 launches
    of the v2 path's runs."""
    import torch

    from sparkinfer_tpu_torch.tools.bench_matrix import bench_tg

    L = model.config.n_layer
    n_fwd = 2 + reps * tg  # the prefill, the warm-up step, the timed steps
    wrappers = kernel_wrappers()
    v2_launches = 0
    try:
        for path, sparse, v2, kname in (("dense", None, False, None),
                                        ("sparse v1", scfg, False, "sparse_ffn_block"),
                                        ("sparse v2", scfg, True, "sparse_ffn_block_v2")):
            set_kernel_v2(v2)
            for B in (1, 4):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for w in wrappers.values():
                    w.launches = 0
                tps = bench_tg(model, tg, reps, torch.bfloat16, ctx=ctx, batch=B, sparse=sparse)
                launches = {name: w.launches for name, w in wrappers.items()}
                for name, n in launches.items():
                    want = L * n_fwd if name == kname else 0
                    check(n == want, f"bench {path} B={B}: {name} launched {n}, want {want}")
                v2_launches += launches["sparse_ffn_block_v2"]
                print("bench path (sparkinfer-bench tg, 7B bf16):", json.dumps({
                    "path": path, "B": B, "ctx": ctx, "tg": tg, "reps": reps, "tok_s": tps,
                    "ms_per_step": 1e3 * B / tps,
                    "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {k: v for k, v in launches.items() if v}}))
    finally:
        set_kernel_v2(False)
    return v2_launches


def phase_v2(model, scfg, C, per_call):
    """sparse_ffn_block_v2 against its plain version at the 7B decode
    shapes over the bench path's concatenated store (L, 3*ng, G, E)."""
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf
    from sparkinfer_tpu_torch.tools.bench_matrix import sparse_params

    set_kernel_v2(True)
    try:
        w_all = sparse_params(model, scfg)["layers"]["w_all_rows"]
    finally:
        set_kernel_v2(False)
    L, ng3 = w_all.shape[:2]
    ng = ng3 // 3
    return row_kernel_rows("sparse_ffn_block_v2", sf.sparse_ffn_block_v2,
                           sf.sparse_ffn_block_v2_plain,
                           lambda il: ((w_all[il],), {"gated": True, "R": ng}),
                           list(range(L)), ng, C, SEED + 16, True, per_call)


def profile_steps(label, step, steps: int = 8):
    """Device time by kernel over `steps` calls of step() (torch.profiler),
    and the share of the window in which the device was busy. Returns the
    (kernel, ms, launches) rows over all steps and the window's wall ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies), so no time counts twice
    rows = [(e.key, (e.self_device_time_total or e.device_time_total) / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile: {steps} {label}, wall {wall_ms / steps:.3f} ms/step, "
          f"device busy {busy / steps:.3f} ms/step ({100 * busy / wall_ms:.1f}%)")
    for key, ms, count in rows[:12]:
        print(f"  {ms / steps:8.4f} ms/step  {count // steps:5d}/step  {key[:90]}")
    return rows, wall_ms


def profile_decode(eng, prompt, steps: int = 8):
    """profile_steps over a few decode steps of the engine on a cache of
    its own (whose graph the first, unprofiled step captures); returns its
    (kernel, ms, launches) rows over all steps, the step count and the
    window's wall ms."""
    cache, st = eng.new_cache(), eng.new_sampler_state()
    tok, cache, st, n = eng.prefill(prompt, cache, st)
    state = {"tok": eng.decode_step(tok, n, cache, st)[0], "n": n + 1}  # warm

    def step():
        state["tok"] = eng.decode_step(state["tok"], state["n"], cache, st)[0]
        state["n"] += 1

    kind = "graph" if eng.graphs.capture else "eager"
    rows, wall_ms = profile_steps(f"decode steps ({kind})", step, steps)
    return rows, steps, wall_ms


def decode_timing(eng, prompt, n_new) -> tuple[list, "torch.Tensor", dict]:
    """One engine's greedy stream of n_new tokens from `prompt` and its
    first decode step's logits (a copy); the decode wall ms a step and tok/s
    of a second generate, which must give the same stream and capture no
    graph (the first captures one unless the engine's cache had one), with
    the median and the largest wall ms between its tokens; then device ms a
    step and busy share over 8 profiled steps."""
    from sparkinfer_tpu_torch.runtime.engine import PerfCounters

    toks, first = [], None
    c0, had_cache = eng.graphs.captures, eng.cache is not None
    for tok in eng.generate(prompt, n_new, stream=True):
        toks.append(tok)
        if len(toks) == 2:  # the first decode step's token: its logits
            first = eng.last_logits.clone()
    c1 = eng.graphs.captures
    eng.perf = PerfCounters()
    stamps, again = [], []
    for tok in eng.generate(prompt, n_new, stream=True):
        stamps.append(time.perf_counter())
        again.append(tok)
    check(again == toks, "a second generate gave another stream")
    # wall ms between tokens: one decode step each, and the generator's turn
    gaps = sorted(1e3 * (b - a) for a, b in zip(stamps, stamps[1:]))
    wall, tok_s = 1e3 * eng.perf.t_decode_s / eng.perf.n_decode, eng.perf.decode_tps
    if eng.graphs.capture:
        check(c1 - c0 == (0 if had_cache else 1) and eng.graphs.captures == c1,
              f"two generate calls captured {eng.graphs.captures - c0} graphs "
              f"(the engine's cache {'had' if had_cache else 'had no'} graph before)")
    rows, steps, wall_ms = profile_decode(eng, prompt)
    busy = sum(r[1] for r in rows)
    return toks, first, {"wall_ms_per_step": wall, "tok_s": tok_s,
                         "step_ms_median": gaps[len(gaps) // 2], "step_ms_max": gaps[-1],
                         "device_ms_per_step": busy / steps, "busy_share": busy / wall_ms,
                         "device_share_of_wall": busy / steps / wall}


def replay_times(step, reps: int = 20) -> dict:
    """Replays of a captured step on its last inputs, which rewrite the same
    cache rows with the same values: the device span of one replay (CUDA
    events around `reps` back-to-back replays: its kernels and the gaps
    between them, the host's part hidden behind the device); the host time
    of one `replay()` call on an idle card, and the wall time from that
    call to the end of a synchronization after it (`reps` calls each). A
    decode step's wall time less the last is the host's part around the
    replay (the static buffers' fills, the token read, Python). These
    replays credit no launch counter."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        step.graph.replay()
    end.record()
    torch.cuda.synchronize()
    launch = synced = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        step.graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch += t1 - t0
        synced += time.perf_counter() - t0
    return {"replay_span_ms": start.elapsed_time(end) / reps,
            "replay_launch_ms": 1e3 * launch / reps, "replay_sync_ms": 1e3 * synced / reps}


def step_breakdown(eng, steps: int = 16) -> dict:
    """Decode steps of the graph engine on its own cache, after the tokens
    generate left there, taken apart as `Engine.decode_step` runs them: host
    ms of the static buffers' fills, of the replay call (with its counter
    credits), and of the token read (the wait for the card); and the device
    ms between CUDA events recorded around the replay call."""
    import torch

    step = eng.graphs.get(eng.cache, 1, "decode", None)
    tok, n_past = int(step.tokens[0, 0]), int(step.positions[0, 0]) + 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host, device = [0.0, 0.0, 0.0], 0.0
    with torch.inference_mode():  # the static buffers are inference tensors
        for i in range(steps):
            t0 = time.perf_counter()
            step.tokens.fill_(tok)
            step.positions.fill_(n_past + i)
            t1 = time.perf_counter()
            start.record()
            _, out = step.run()
            end.record()
            t2 = time.perf_counter()
            tok = int(out[0])
            t3 = time.perf_counter()
            device += start.elapsed_time(end)
            for j, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                host[j] += dt
    return {"fill_ms": 1e3 * host[0] / steps, "replay_call_ms": 1e3 * host[1] / steps,
            "token_read_ms": 1e3 * host[2] / steps, "replay_device_ms": device / steps}


def graph_vs_eager(label, graph_eng, eager_eng, prompt, n_new) -> dict:
    """Phase 5h for one Engine path, graph against eager over the same
    params: greedy streams equal and first decode logits bit-equal, or the
    run fails; wall ms a step, tok/s, device ms a step and busy share of
    each, the graph's capture time and pool bytes."""
    import torch

    (gt, gf, g), (et, ef, e) = (decode_timing(eng, prompt, n_new)
                                for eng in (graph_eng, eager_eng))
    check(gt == et, f"5h {label}: graph stream {gt} differs from eager {et}")
    check(torch.equal(gf, ef), f"5h {label}: first decode logits differ by up to "
                               f"{(gf - ef).abs().max().item():.3e}")
    step = graph_eng.graphs.get(graph_eng.cache, 1, "decode", None)
    row = {"path": label, "graph": g, "eager": e, **replay_times(step),
           "step_breakdown": step_breakdown(graph_eng),
           "capture_s": step.stats["capture_s"], "graph_pool_bytes": step.stats["pool_bytes"],
           "wall_speedup": e["wall_ms_per_step"] / g["wall_ms_per_step"]}
    print("phase 5h, graph vs eager (streams equal, first decode logits bit-equal):",
          json.dumps(row))
    return row


def sparse_dense_ratio(label, sparse_row, dense_row) -> dict:
    ratio = {"path": label, **{k: sparse_row[k]["tok_s"] / dense_row[k]["tok_s"]
                               for k in ("graph", "eager")}}
    print("phase 5h, sparse/dense decode tok/s:", json.dumps(ratio))
    return ratio


def scheduler_graph_vs_eager(graph_sched, eager_sched, prompts, n_new) -> dict:
    """Phase 5h for the Scheduler: the same requests through the graph
    Scheduler (its tick captured already) and an eager one; streams equal
    and the first tick's logits bit-equal, or the run fails; wall ms a
    tick, aggregate decode tok/s, and device ms a tick and busy share over
    6 profiled ticks with every slot running."""
    import torch

    from sparkinfer_tpu_torch.runtime.scheduler import Request

    got = {}
    for name, sched in (("graph", graph_sched), ("eager", eager_sched)):
        m0, c0 = sched.metrics_snapshot(), sched.graphs.captures
        reqs = [sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new)) for p in prompts]
        sched.step()
        first = sched.last_logits.clone()
        sched.run_until_idle()
        m = sched.metrics_snapshot()
        ticks = m["n_decode_steps"] - m0["n_decode_steps"]
        secs = m["t_decode_s"] - m0["t_decode_s"]
        gen = (m["n_tokens_generated"] - m0["n_tokens_generated"]
               - (m["n_requests"] - m0["n_requests"]))
        for p in prompts[:sched.n_slots]:
            sched.submit(Request(prompt_tokens=p, max_new_tokens=n_new))
        sched.step()
        rows, wall_ms = profile_steps(f"Scheduler ticks ({name})", sched.step, 6)
        sched.run_until_idle()
        check(sched.graphs.captures == c0, f"5h Scheduler ({name}): a tick captured again")
        busy = sum(r[1] for r in rows)
        got[name] = ([r.tokens() for r in reqs], first,
                     {"wall_ms_per_tick": 1e3 * secs / ticks, "tok_s": gen / secs,
                      "device_ms_per_tick": busy / 6, "busy_share": busy / wall_ms,
                      "device_share_of_wall": busy / 6 / (1e3 * secs / ticks)})
    (gt, gf, g), (et, ef, e) = got["graph"], got["eager"]
    check(gt == et, "5h Scheduler: graph streams differ from eager")
    check(torch.equal(gf, ef), f"5h Scheduler: first tick logits differ by up to "
                               f"{(gf - ef).abs().max().item():.3e}")
    step = graph_sched.graphs.get(graph_sched.cache, graph_sched.n_slots, "decode", None)
    row = {"path": f"Scheduler 7B bf16 sparse, {graph_sched.n_slots} slots", "graph": g,
           "eager": e, **replay_times(step),
           "capture_s": step.stats["capture_s"], "graph_pool_bytes": step.stats["pool_bytes"],
           "wall_speedup": e["wall_ms_per_tick"] / g["wall_ms_per_tick"]}
    print("phase 5h, graph vs eager (streams equal, first tick logits bit-equal):",
          json.dumps(row))
    return row


def profile_prefill(eng, prompt, steps: int = 4) -> dict:
    """The engine's prefill of `prompt` into one cache: prefill tok/s from
    `steps` synchronized calls, then the same calls under torch.profiler:
    device time per prefill by kernel, and the packed linears' share (every
    kernel named qmm_*) with their launches per prefill."""
    import torch

    cache, st = eng.new_cache(), eng.new_sampler_state()
    eng.prefill(prompt, cache, st)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.prefill(prompt, cache, st)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows, _ = profile_steps(f"{len(prompt)}-token prefills", lambda: eng.prefill(prompt, cache, st),
                            steps)
    qmm = [(k, ms, n) for k, ms, n in rows if "qmm_" in k]
    got = dict(tokens=len(prompt), wall_ms=wall_ms, prefill_tps=len(prompt) / wall_ms * 1e3,
               device_ms=sum(r[1] for r in rows) / steps,
               qmm_ms=sum(r[1] for r in qmm) / steps,
               qmm_launches=sum(r[2] for r in qmm) // steps,
               qmm_kernels={k[:60]: [ms / steps, n // steps] for k, ms, n in qmm})
    print("prefill profile:", json.dumps(got))
    check(got["qmm_launches"] > 0, "the profiled prefill recorded no quant_matmul kernel")
    return got


def q8_13b_engine(greedy):
    """ProSparse-Llama-2-13B widths, Q8_0, random weights made and quantized
    on the card layer by layer, and its sparse engine."""
    import torch

    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    cfg = prosparse_config(40, 5120, 40, 13824, 32000, 1280)
    scfg = SparseConfig(group_size=128, capacity_groups=16)  # 16 of 108 groups, 12.5%
    t0 = time.perf_counter()
    weights = Q8Weights(cfg, torch.bfloat16, "cuda", SEED)
    model = weights.sparse_model(scfg)
    eng = Engine(model, max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
                 device="cuda")
    torch.cuda.synchronize()
    print(f"model: ProSparse-Llama-2-13B widths, L={cfg.n_layer} E={cfg.n_embd} "
          f"F={cfg.n_ff} V={cfg.n_vocab} R={cfg.max_pred_rank}, Q8_0 attention/head/"
          f"FFN stores/predictor stacks, built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return cfg, scfg, weights, model, eng


def prefill_only() -> int:
    """`chip_smoke.py --prefill-profile`: only the profiled 32-token prefill
    of the 13B Q8_0 engine, for whichever sparkinfer_tpu_torch the script's
    directory holds (so a copy of this script beside another revision's
    package profiles that revision). Prints the card and one JSON line."""
    import torch

    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()
    *_, eng = q8_13b_engine(SamplerConfig(temp=0.0))
    print(json.dumps({"prefill_profile": profile_prefill(eng, prompt)}))
    return 0


def run_generate(eng, prompt, n_new):
    """Greedy generate, checking every logit row the engine produced."""
    import torch

    toks = []
    for tok in eng.generate(prompt, n_new, stream=True):
        check(bool(torch.isfinite(eng.last_logits).all()), "non-finite logits")
        toks.append(tok)
    check(len(toks) == n_new, f"generated {len(toks)} of {n_new} tokens")
    return toks


def kernel_wrappers():
    from sparkinfer_tpu_torch.ops import quant_matmul as qm
    from sparkinfer_tpu_torch.ops import sparse_ffn as sf

    return {"sparse_ffn_block_v6": sf.sparse_ffn_block_v6,
            "sparse_ffn_block_v6q": sf.sparse_ffn_block_v6q,
            "sparse_ffn_block": sf.sparse_ffn_block,
            "sparse_ffn_block_v2": sf.sparse_ffn_block_v2,
            "sparse_ffn_block_v3": sf.sparse_ffn_block_v3,
            "sparse_ffn_block_v4": sf.sparse_ffn_block_v4,
            "sparse_ffn_block_v5": sf.sparse_ffn_block_v5,
            "sparse_ffn_block_v7u": sf.sparse_ffn_block_v7u,
            "quant_matmul_2d": qm.quant_matmul_2d,
            "quant_matmul_flat": qm.quant_matmul_flat}


def main_path(label, eng, prompt, n_new, want):
    """Generate with every launch count set to 0 just before and read just
    after; `want(runs)` gives the exact count each kernel must show after
    `runs` decode-step forwards: each step (a replay of its graph) and the
    graph's warm-up where this generate captured it."""
    import torch

    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    captures = eng.graphs.captures
    for w in wrappers.values():
        w.launches = 0
    toks = run_generate(eng, prompt, n_new)
    launches = {name: w.launches for name, w in wrappers.items()}
    steps = eng.perf.n_decode
    check(steps == n_new - 1, f"{steps} decode steps for {n_new} tokens")
    warm = eng.graphs.captures - captures
    check(warm == 1, f"{label}: generate captured {warm} graphs, want 1")
    expect = want(steps + warm)
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"{label}: {name} launched {n} times, want {expect.get(name, 0)}")
    summary = eng.perf.summary()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path {label}: prefill {summary['prefill_tps']} tok/s, decode "
          f"{summary['decode_tps']} tok/s ({steps} steps), peak {peak:.2f} GiB, "
          f"launches {json.dumps(launches)} (as expected: {steps} steps, {warm} warm-up)")
    print(f"main path {label} tokens: {toks}")
    return launches


def kernel_line(name, source, replaces, launches, row, shape):
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **{k: row[k] for k in keys}, "shape": shape}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from sparkinfer_tpu_torch.models.loader import LoadedModel
    from sparkinfer_tpu_torch.ops import _build
    from sparkinfer_tpu_torch.ops.sparse_ffn import (
        sparse_ffn_block_v6,
        sparse_ffn_block_v6_plain,
    )
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.runtime.scheduler import Scheduler
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
    for name, (lib, secs, log) in _build.build_all(
            ["sparse_ffn_v6", "sparse_ffn_v6q", "quant_matmul", "sparse_ffn_v1",
             "sparse_ffn_v7u"]).items():
        if not log:
            print(f"build: {name} -> {lib.name} was already built")
            continue
        print(f"build: {name} -> {lib.name} in {secs:.2f} s; ptxas:")
        print("\n".join("  " + ln for ln in log.splitlines() if "ptxas info" in ln
                        and ("Used" in ln or "entry" in ln)))

    greedy = SamplerConfig(temp=0.0)

    # 3. f32 references on small inputs: kernel path == plain path
    phase_reference(SparseConfig, Engine, greedy)
    phase_serving_reference(SparseConfig, greedy)
    phase_bench_reference(SparseConfig)
    print(f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")

    n_new = 64
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(SEED)).tolist()

    # 5a. the 7B-width bf16 model and its sparse engine (its flat stores serve phase 4)
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

    # 4a. v6 against its plain version
    v6_row = phase_v6(sparse_ffn_block_v6, sparse_ffn_block_v6_plain,
                      sparse_eng.params["sparse_flat"], cfg.n_layer,
                      scfg.n_groups(cfg.n_ff))

    # 5b. the 7B main path
    L = cfg.n_layer
    l7 = main_path("7B bf16 sparse", sparse_eng, prompt, n_new,
                       lambda steps: {"sparse_ffn_block_v6": L * steps})
    rows7, steps7, _ = profile_decode(sparse_eng, prompt)
    v6_prof = [(k, ms, n) for k, ms, n in rows7 if "v6_ffn" in k]
    # the f32 copies: torch's casting copies (direct_copy_kernel_cuda)
    copies = [(k, ms, n) for k, ms, n in rows7 if "direct_copy_kernel" in k]
    print("profile: v6 in a 7B bf16 sparse step:", json.dumps({
        "device_ms": sum(ms for _, ms, _ in v6_prof) / steps7,
        "launches": sum(n for _, _, n in v6_prof) // steps7,
        "f32_copies": {"device_ms": sum(ms for _, ms, _ in copies) / steps7,
                       "launches": sum(n for _, _, n in copies) // steps7}}))
    check(sum(n for _, _, n in v6_prof) == L * steps7,
          f"the profiled 7B step launched {v6_prof} v6 kernels, want {L} a step")
    # 5h. graph against eager: the sparse engine and an eager one over its
    # prepared stores, then the dense engines on the same weights
    h5 = [graph_vs_eager("7B bf16 sparse", sparse_eng, Engine(
        LoadedModel(config=cfg, params=sparse_eng.params), max_seq=1024, sampler=greedy,
        sparse=scfg, sparse_preprepared=True, device="cuda", cuda_graph=False), prompt, n_new)]
    h5.append(graph_vs_eager(
        "7B bf16 dense", Engine(model, max_seq=1024, sampler=greedy, device="cuda"),
        Engine(model, max_seq=1024, sampler=greedy, device="cuda", cuda_graph=False),
        prompt, n_new))
    ratios = [sparse_dense_ratio("7B bf16", *h5[-2:])]
    torch.cuda.empty_cache()
    print(f"7B engine path done at {time.perf_counter() - t_start:.1f} s")

    # 5e. the Scheduler at 7B widths (its row stores serve phase 4c)
    sched = Scheduler(model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg,
                      sparse_batch_max=4, device="cuda")
    row_rows, row_per_call = phase_rows(sched.params["layers"], scfg.capacity(cfg.n_ff))
    gen = torch.Generator().manual_seed(SEED + 11)
    prompts = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    l_v1 = scheduler_path(sched, prompts, 32)
    # 5h. the tick, graph against eager, on requests whose prompts no slot
    # holds (a reused prefix would prefill another way than a fresh slot)
    prompts_h = [torch.randint(cfg.n_vocab, (32,), generator=gen).tolist() for _ in range(8)]
    h5.append(scheduler_graph_vs_eager(sched, Scheduler(
        model, n_slots=4, max_seq=128, sampler=greedy, sparse=scfg, sparse_batch_max=4,
        device="cuda", cuda_graph=False), prompts_h, 32))
    torch.cuda.empty_cache()

    # 4d, 5f. v7u, and batched decode of every decode path at B = 1, 4, 8
    v7u_row = phase_v7u(sparse_eng.params["sparse_flat"], L, scfg.n_groups(cfg.n_ff))
    l_v7u, crossover = phase_batched(cfg, scfg, model.params, sparse_eng.params,
                                     sched.params)
    del sparse_eng, sched
    torch.cuda.empty_cache()

    # 5g, 4e. sparkinfer-bench's decode: dense, v1 and v2 (SPIF_KERNEL_V2),
    # then v2 against its plain version over the bench path's store
    l_v2 = phase_bench(model, scfg)
    row_rows["sparse_ffn_block_v2"] = phase_v2(model, scfg, scfg.capacity(cfg.n_ff),
                                               row_per_call)
    del model
    torch.cuda.empty_cache()
    print(f"7B paths done at {time.perf_counter() - t_start:.1f} s")

    # 5c. the 13B-width Q8_0 model, made and quantized on the card
    cfg, scfg, weights, model, sparse_eng = q8_13b_engine(greedy)
    ng, C = scfg.n_groups(cfg.n_ff), scfg.capacity(cfg.n_ff)

    # 4b. v6q and the quant matmuls against their plain versions
    v6q_row = phase_v6q(model.params["sparse_flat"], cfg.n_layer, ng, C)
    q2d_row, qflat_row = phase_quant_matmul(model.params)

    # 5d. the 13B Q8_0 main path: per decode step v6q L, quant_matmul_2d
    # 4L+1 (wq, wk, wv, wo, head) and quant_matmul_flat 2(L+1) (the next
    # layer's predictor in every layer, layer 0's own); the prefill adds
    # 4L+1 and 2L (the masked-dense FFN's predictor)
    L = cfg.n_layer

    def want13(steps):
        return {"sparse_ffn_block_v6q": L * steps,
                "quant_matmul_2d": (4 * L + 1) * (steps + 1),
                "quant_matmul_flat": 2 * (L + 1) * steps + 2 * L}

    l13 = main_path("13B Q8_0 sparse", sparse_eng, prompt, n_new, want13)
    rows13, steps13, _ = profile_decode(sparse_eng, prompt)
    v6q_prof = [(k, ms, n) for k, ms, n in rows13 if "v6q_" in k]
    qmm_prof = [(k, ms, n) for k, ms, n in rows13 if "qmm_" in k]
    print("profile: v6q and quant_matmul in a 13B Q8_0 sparse step:", json.dumps({
        "device_ms": sum(ms for _, ms, _ in v6q_prof) / steps13,
        "launches": sum(n for _, _, n in v6q_prof) // steps13,
        "kernels": {k[:60]: [ms / steps13, n // steps13] for k, ms, n in v6q_prof + qmm_prof}}))
    check(sum(n for _, _, n in v6q_prof) == 2 * L * steps13,
          f"the profiled 13B step launched {v6q_prof} v6q kernels, want 2 x {L} a step")
    # quant_matmul_2d 4L + 1 and quant_matmul_flat 2(L + 1) a step, qmm_decode each
    check(sum(n for _, _, n in qmm_prof) == (6 * L + 3) * steps13
          and all("qmm_decode" in k for k, _, _ in qmm_prof),
          f"the profiled 13B step launched {qmm_prof}, want {6 * L + 3} qmm_decode a step")
    h5.append(graph_vs_eager("13B Q8_0 sparse", sparse_eng, Engine(
        model, max_seq=1024, sampler=greedy, sparse=scfg, sparse_preprepared=True,
        device="cuda", cuda_graph=False), prompt, n_new))
    profile_prefill(sparse_eng, prompt)
    del sparse_eng
    dense_params = dict(model.params)
    dense_params.pop("sparse_flat")
    dense_params["layers"] = dict(model.params["layers"], **weights.dense_ffn())
    del model
    torch.cuda.empty_cache()
    dense = LoadedModel(config=cfg, params=dense_params)
    h5.append(graph_vs_eager(
        "13B Q8_0 dense", Engine(dense, max_seq=1024, sampler=greedy, device="cuda"),
        Engine(dense, max_seq=1024, sampler=greedy, device="cuda", cuda_graph=False),
        prompt, n_new))
    ratios.append(sparse_dense_ratio("13B Q8_0", h5[-2], h5[-1]))
    print(f"13B path done at {time.perf_counter() - t_start:.1f} s")

    out = {"kernels": [
        kernel_line("sparse_ffn_block_v6", "sparkinfer_tpu_torch/csrc/sparse_ffn_v6.cu",
                    "sparkinfer_tpu/ops/sparse_ffn_pallas.py:564",
                    l7["sparse_ffn_block_v6"], v6_row, "N=1 C=12 G=128 E=4096 bf16 fatrelu"),
        kernel_line("sparse_ffn_block_v6q", "sparkinfer_tpu_torch/csrc/sparse_ffn_v6q.cu",
                    "sparkinfer_tpu/ops/sparse_ffn_pallas.py:706",
                    l13["sparse_ffn_block_v6q"], v6q_row,
                    "N=1 C=16 G=128 E=5120 q8_0 fatrelu"),
        kernel_line("quant_matmul_2d", "sparkinfer_tpu_torch/csrc/quant_matmul.cu",
                    "sparkinfer_tpu/ops/quant_matmul.py:149",
                    l13["quant_matmul_2d"], q2d_row, q2d_row["shape"]),
        kernel_line("quant_matmul_flat", "sparkinfer_tpu_torch/csrc/quant_matmul.cu",
                    "sparkinfer_tpu/ops/quant_matmul.py:243",
                    l13["quant_matmul_flat"], qflat_row, qflat_row["shape"]),
        kernel_line("sparse_ffn_block", "sparkinfer_tpu_torch/csrc/sparse_ffn_v1.cu",
                    "sparkinfer_tpu/ops/sparse_ffn_pallas.py:124", l_v1,
                    row_rows["sparse_ffn_block"], "N=1 C=12 G=128 E=4096 bf16 fatrelu, row stores"),
        # v2 runs on the bench path (SPIF_KERNEL_V2); v3, v4 and v5 on no
        # path of the package (only its TPU probes call them)
        *(kernel_line(name, "sparkinfer_tpu_torch/csrc/sparse_ffn_v1.cu",
                      f"sparkinfer_tpu/ops/sparse_ffn_pallas.py:{line}",
                      l_v2 if name == "sparse_ffn_block_v2" else 0, row_rows[name],
                      f"N=1 C=12 G=128 E=4096 bf16 fatrelu + up bias, {store}")
          for name, line, store in (
              ("sparse_ffn_block_v2", 1044, "concatenated store"),
              ("sparse_ffn_block_v3", 306, "row stores"),
              ("sparse_ffn_block_v4", 446, "interleaved store"),
              ("sparse_ffn_block_v5", 888, "row stores"))),
        kernel_line("sparse_ffn_block_v7u", "sparkinfer_tpu_torch/csrc/sparse_ffn_v7u.cu",
                    "sparkinfer_tpu/ops/sparse_ffn_pallas.py:1172", l_v7u, v7u_row,
                    "B=8 Cu=48 G=128 E=4096 bf16 fatrelu"),
    ]}
    print(f"crossover measured: v1 beats masked-dense up to B={crossover}")
    print("phase 5h summary:", json.dumps({"graph_vs_eager": [
        {"path": r["path"], **{f"{k}_{m}": r[k][m] for k in ("graph", "eager")
                               for m in r["graph"]},
         **{k: r[k] for k in ("replay_span_ms", "replay_launch_ms", "replay_sync_ms",
                              "step_breakdown", "capture_s", "graph_pool_bytes") if k in r}}
        for r in h5],
        "sparse_dense": ratios}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(prefill_only() if sys.argv[1:] == ["--prefill-profile"] else main())
