"""Sparse-FFN configuration: a copy of `SparseConfig` from
sparkinfer_tpu/sparse/config.py, so that the port imports nothing of the JAX
package, and the serving Scheduler's sparse/dense batch crossover as
measured on the H100 (`sparse_batch_crossover`). The tiering fields (dfr_*,
hot_groups, reload_*, swap_hysteresis) are carried for the tiered slice;
the port's Engine and Scheduler reject hot_groups > 0.

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


# The largest number of active slots at which the Scheduler's sparse tick
# (v1 over the row stores) beat its masked-dense tick, by FFN width. Measured
# by chip_smoke.py's batched-decode phase at ProSparse-Llama-2-7B widths
# (bf16, 12 of 86 groups, B = 1, 4, 8) on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit: v1 won at no batch size, since the host's launch
# overhead bounds both steps and the sparse one makes more launches. One
# run from a git archive of the tree that added this table gave, in
# aggregate tok/s, v1 14.41 / 58.14 / 128.23 against masked-dense
# 20.80 / 84.48 / 185.16 at B = 1 / 4 / 8; PERF.md sections 5 and 6 list
# every run, none with v1 ahead. Widths that were not measured take the
# 7B-width value. SPIF_SPARSE_BATCH_MAX overrides.
_BATCH_CROSSOVER = {11008: 0}


def sparse_batch_crossover(n_ff: int) -> int:
    """Largest number of active slots for which the Scheduler decodes
    sparse; above it a tick takes the masked-dense step."""
    env = os.environ.get("SPIF_SPARSE_BATCH_MAX")
    if env is not None:
        return int(env)
    return _BATCH_CROSSOVER.get(n_ff, _BATCH_CROSSOVER[11008])
