"""Sparse-FFN configuration: a copy of `SparseConfig` from
sparkinfer_tpu/sparse/config.py, so that the port imports nothing of the JAX
package, and the serving Scheduler's sparse/dense batch crossover as
measured on the H100 (`sparse_batch_crossover`), and a copy of the CLI's
`hbm_budget_to_hot_groups` (sparkinfer_tpu/tools/cli.py:41), which the
server's -vb uses. The tiering fields (dfr_*, hot_groups, reload_*,
swap_hysteresis) configure `sparse/tiering.py` and `sparse/balancer.py`.

Sparsity is expressed as a FIXED-CAPACITY top-k over neuron GROUPS rather than a
data-dependent threshold count (SURVEY.md §7 hard part (b)). The threshold
still gates individual neurons inside selected groups (multiplicative
mask), so the computed function matches the reference's
"rows with sparse_idx < 0.5 contribute zero" semantics for every neuron
that falls inside the top-k group capacity.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    # neurons per group; 128 aligns groups with MXU/VPU lanes
    # (ref: split-file KV `ffn_group_size`)
    group_size: int = 128
    # number of groups computed per token (static top-k capacity).
    # 0 = dense (all groups).
    capacity_groups: int = 0
    # activation-probability threshold gating individual neurons
    # (ref: SPIF_SPARSE_THRESHOLD = 0.5)
    threshold: float = 0.5
    # DFR (decayed firing rate) EMA decay λ (ref: SPIF_INIT_DFR_DECAY=67 -> 0.67)
    dfr_decay: float = 0.67
    # EMA vs plain accumulate (ref: SPIF_DFR_EMA)
    dfr_ema: bool = True
    # number of HBM-resident hot groups per layer (0 = all in HBM / gpu_only).
    # The analogue of n_group_cache[il] (src/llama-sparkinfer.cpp:179-202).
    hot_groups: int = 0
    # window of group copies per reload step (ref: SPIF_RELOAD_WINDOW_SIZE=4)
    reload_window: int = 4
    # hard per-rebalance upload budget in MiB (0 = unlimited). Bounds the
    # serving tick-latency tail: the adaptive window can otherwise grow
    # into multi-GB rebalance uploads at 7B+ shapes — the byte-aware
    # generalization of the reference's per-window copy cap
    # (SPIF_RELOAD_WINDOW_SIZE, ggml-cuda.cu:2556-2604)
    reload_budget_mb: float = 0.0
    # swap hysteresis: a DFR-only challenger must beat the incumbent's
    # score by this fraction of the layer's score range before it swaps
    # in. Kills steady-state churn (measured: with a profiled hot set and
    # near-zero misses, churn alone cost KL 0.0016-0.0069 vs drop's
    # 2e-5, quality_ppl_tool.json) without slowing miss-driven fetches —
    # a missed group's priority bump exceeds any dfr range.
    swap_hysteresis: float = 0.05

    def n_groups(self, n_ff: int) -> int:
        if n_ff % self.group_size:
            raise ValueError(f"n_ff {n_ff} is not a multiple of group_size "
                             f"{self.group_size}")
        return n_ff // self.group_size

    def capacity(self, n_ff: int) -> int:
        ng = self.n_groups(n_ff)
        c = self.capacity_groups if self.capacity_groups > 0 else ng
        return min(c, ng)


# The largest number of rows a Scheduler tick computes, which is its
# n_slots (idle slots step too), at which its sparse tick (v1 over the row
# stores) beat its masked-dense tick, by FFN width, both ticks replayed as
# CUDA graphs as the Scheduler runs them. The Scheduler reads it once, when
# it is built: v1 at every tick when n_slots is at most this, the
# masked-dense step at every tick above it. Measured by
# chip_smoke.py's batched-decode phase (5f) at ProSparse-Llama-2-7B widths
# (bf16, 12 of 86 groups, B rows all live at B = 1, 2, 4, 8, 16) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit: v1 won at B = 1-8 and
# lost at 16. Aggregate tok/s, v1 98.40 / 187.12 / 342.98 / 568.25 against
# masked-dense 81.62 / 162.04 / 293.78 / 561.84 at B = 1-8; device ms of
# one replay, v1 9.98 / 10.53 / 11.25 / 13.87 against 12.16 / 12.25 /
# 12.54 / 14.12 (the masked-dense tick pays the dense FFN's weights at
# every B, v1 grows with the rows its tokens select). At B = 8 the margin,
# 1.1%, is within the spread between runs. At B = 16 (a later run on the
# same card) v1 866.25 tok/s, 18.44 device ms, against masked-dense 968.44
# and 16.40. The eager steps this replaced were bound by the host and gave
# 0. PERF.md sections 5 and 6 list the runs. At n_ff 32768 (ReluFalcon-40B
# widths, bf16, 36 of 256 groups, ungated relu, 34 of its 60 layers),
# chip_smoke.py's phase 5n on an NVIDIA H100 80GB HBM3 at 700.00 W:
# v1 won at B = 1 and 4 and lost at 8. Aggregate tok/s, v1 51.20 / 155.14 /
# 236.78 / 351.59 against masked-dense 35.52 / 136.01 / 254.52 / 495.58 at
# B = 1, 4, 8, 16; device ms of one replay, v1 19.42 / 25.70 / 33.69 /
# 45.41 against 27.90 / 29.17 / 31.20 / 32.01. Widths that were not
# measured take the 7B-width value. SPIF_SPARSE_BATCH_MAX overrides.
_BATCH_CROSSOVER = {11008: 8, 32768: 4}


def sparse_batch_crossover(n_ff: int) -> int:
    """Largest n_slots for which the Scheduler decodes sparse; with more
    slots every tick takes the masked-dense step."""
    env = os.environ.get("SPIF_SPARSE_BATCH_MAX")
    if env is not None:
        return int(env)
    return _BATCH_CROSSOVER.get(n_ff, _BATCH_CROSSOVER[11008])


def hbm_budget_to_hot_groups(budget_gib: float, cfg, group_size: int) -> int:
    """GiB budget -> per-layer hot group count (3 projections, bf16)."""
    bytes_per_group = 3 * group_size * cfg.n_embd * 2
    total_groups = int(budget_gib * (1 << 30) / bytes_per_group)
    return max(total_groups // cfg.n_layer, 1)
