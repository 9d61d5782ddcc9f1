"""Online neuron balancing, the port of sparkinfer_tpu/sparse/balancer.py.

Between decode steps the balancer reads the (L, ng) DFR array, ranks each
layer's groups, pairs the groups that should enter the hot set with the
slots whose groups should leave (`reload_plan`, at most `window` pairs a
layer, a global byte budget across layers), and copies the entering
blocks from the host cold store into the hot store in place.

The copies run on the current stream, the stream the decode step (or its
CUDA graph) runs on, so the next step reads whole blocks: each entering
block is gathered on the host (transposed to v6's (E, G) for up/gate,
quantized there for a Q8_0 store), staged in pinned memory, copied to the
card without blocking the host and scattered into its rows with
`index_copy_`. `group_map` and `hot_ids` are written in place after them.
An event recorded after the copies is the completion probe: the next
rebalance asks it (`Event.query()`, no wait) whether the copies had landed,
and halves the window when they had not, doubles it when they had (the
reference's anchor mechanism adapts to the same signal).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sparse_ffn import quantize_rows_q8_0
from .config import SparseConfig
from .tiering import ColdStore, TieredParams


def reload_plan(current_hot, desired_hot, window: int) -> list[tuple[int, int]]:
    """Two-pointer diff (ref: sparkinfer_reload_plan): pair groups that
    should enter with slots whose groups should leave; at most `window`
    pairs. Returns [(slot, entering_group), ...].

    The plan itself is truncated to `window` pairs after zipping (the
    reference pairs exhaustively and throttles at its copy step): surplus
    demand on either side is not carried over but recomputed at the next
    rebalance from the fresh DFR ordering."""
    cur = set(int(g) for g in current_hot)
    want = set(int(g) for g in desired_hot)
    entering = sorted(want - cur)
    leaving_slots = [s for s, g in enumerate(current_hot) if int(g) not in want]
    return list(zip(leaving_slots, entering))[: max(window, 0)]


def _nbytes(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclass
class Balancer:
    cold: ColdStore
    scfg: SparseConfig
    # adaptive window state
    window: int = 0
    min_window: int = 1
    max_window: int = 64
    last_reload_s: float = 0.0
    total_swaps: int = 0
    rebalances: int = 0
    overruns: int = 0
    bytes_h2d: int = 0  # bytes copied to the card by every rebalance
    t_total_s: float = 0.0  # host wall time of every rebalance call

    def __post_init__(self):
        if self.window <= 0:
            self.window = self.scfg.reload_window
        self._pending = None  # the previous rebalance's completion event

    def _landed(self) -> bool:
        ev = self._pending
        return ev is True or ev.query()

    def rebalance(self, tp: TieredParams, dfr, miss_g=None) -> TieredParams:
        """dfr (L, ng): swap at most `window` groups per layer into tp, in
        place, and return tp.

        miss_g (fetch mode): per-group cold∩active counts since the last
        rebalance. A group that missed outranks every group that did not
        (ordered by misses, DFR as tiebreak), so repeated misses become
        hits after the next rebalance."""
        t0 = time.perf_counter()
        try:
            return self._rebalance(tp, dfr, miss_g)
        finally:
            self.t_total_s += time.perf_counter() - t0

    def _rebalance(self, tp: TieredParams, dfr, miss_g) -> TieredParams:
        if self._pending is not None:
            done = self._landed()
            self._pending = None
            if not done:
                self.overruns += 1
                self.window = max(self.min_window, self.window // 2)
            elif self.window < self.max_window:
                self.window = min(self.max_window, self.window * 2)
        t0 = time.perf_counter()
        dfr = np.asarray(torch.as_tensor(dfr).cpu(), np.float32)
        if miss_g is not None:
            miss_g = np.asarray(torch.as_tensor(miss_g).cpu(), np.float32)
        hot_ids = tp.hot_ids.cpu().numpy().copy()  # (L, H)
        gmap = tp.group_map.cpu().numpy().copy()  # (L, ng)
        L, H = hot_ids.shape  # H also strides the flat (L*H, ...) stores

        # a GLOBAL swap count across layers from the upload byte budget,
        # spent on the highest-priority (most-missed) swaps first
        window = self.window
        budget_swaps = None
        if self.scfg.reload_budget_mb > 0:
            per_swap = sum(_nbytes(t) for t in (tp.hot_upT, tp.hot_down, tp.hot_gateT,
                                                tp.s_upT, tp.s_down, tp.s_gateT))
            per_swap //= L * H  # bytes per (layer, slot) block swap
            budget_swaps = max(1, int(self.scfg.reload_budget_mb * 2**20)
                               // max(per_swap, 1))

        score = dfr
        if miss_g is not None:
            bump = np.abs(dfr).max() + 1.0
            score = dfr + np.where(miss_g > 0, miss_g + bump, 0.0)
        # swap hysteresis: a challenger must beat the slot's incumbent by a
        # fraction of the layer's DFR range; a group with misses always enters
        hyst = self.scfg.swap_hysteresis
        swaps: list[tuple[int, int, int]] = []  # (layer, slot, group)
        prio: list[float] = []
        for l in range(L):
            order = np.argsort(-score[l], kind="stable")
            desired = order[:H]
            margin = hyst * float(dfr[l].max() - dfr[l].min())
            for slot, g in reload_plan(hot_ids[l], desired, window):
                if ((miss_g is None or miss_g[l, g] <= 0)
                        and score[l, g] <= score[l, hot_ids[l, slot]] + margin):
                    continue
                swaps.append((l, slot, g))
                prio.append(float(score[l, g]))
        if budget_swaps is not None and len(swaps) > budget_swaps:
            keep = np.argsort(-np.asarray(prio), kind="stable")[:budget_swaps]
            swaps = [swaps[i] for i in np.sort(keep)]

        if not swaps:
            self.rebalances += 1
            return tp

        l_idx = torch.tensor([s[0] for s in swaps], dtype=torch.long)
        s_idx = torch.tensor([s[1] for s in swaps], dtype=torch.long)
        g_idx = torch.tensor([s[2] for s in swaps], dtype=torch.long)
        for l, slot, g in swaps:
            old = hot_ids[l, slot]
            gmap[l, old] = -1
            gmap[l, g] = slot
            hot_ids[l, slot] = g

        dev = tp.hot_upT.device
        fj = (l_idx * H + s_idx).to(dev)
        copied = 0

        def put(store: torch.Tensor, blocks: torch.Tensor):
            nonlocal copied
            if dev.type == "cuda":
                stage = torch.empty(blocks.shape, dtype=store.dtype, pin_memory=True)
                stage.copy_(blocks)
                blocks = stage.to(dev, non_blocking=True)
            store.index_copy_(0, fj, blocks.to(store.dtype))
            copied += blocks.numel() * store.element_size()

        # up/gate go up transposed to v6's (E, G) block layout
        up = self.cold.up[l_idx, g_idx].transpose(-1, -2).contiguous()
        gate = (self.cold.gate[l_idx, g_idx].transpose(-1, -2).contiguous()
                if tp.hot_gateT is not None else None)
        down = self.cold.down[l_idx, g_idx]
        if tp.quantized:
            # Q8_0 store: quantize the entering blocks on the host (the
            # store build's scale math) and copy packed bytes and scales
            up, su = quantize_rows_q8_0(up)
            down, sd = quantize_rows_q8_0(down)
            put(tp.s_upT, su)
            put(tp.s_down, sd)
            if gate is not None:
                gate, sg = quantize_rows_q8_0(gate)
                put(tp.s_gateT, sg)
        put(tp.hot_upT, up)
        if gate is not None:
            put(tp.hot_gateT, gate)
        put(tp.hot_down, down)
        tp.group_map.copy_(torch.from_numpy(gmap))
        tp.hot_ids.copy_(torch.from_numpy(hot_ids))
        if dev.type == "cuda":
            self._pending = torch.cuda.Event()
            self._pending.record(torch.cuda.current_stream(dev))
        else:
            self._pending = True

        self.total_swaps += len(swaps)
        self.rebalances += 1
        self.bytes_h2d += copied
        self.last_reload_s = time.perf_counter() - t0
        if os.environ.get("SPIF_DFR_DEBUG"):
            # ref: SPIF_DFR_DEBUG levels print reload counts / trajectories
            # (src/llama-sparkinfer.cpp:408-431)
            print(f"[spif-dfr] rebalance #{self.rebalances}: {len(swaps)} swaps "
                  f"window={self.window} t={self.last_reload_s * 1e3:.2f}ms", flush=True)
            if os.environ.get("SPIF_DFR_DEBUG", "0") >= "2":
                for l, slot, g in swaps[:8]:
                    print(f"[spif-dfr]   layer {l}: slot {slot} <- group {g}", flush=True)
        return tp

    def adapt_window(self, step_s: float):
        """Window adaptation from wall clocks, for callers that cannot probe
        completion: the host plan time against the step time. `rebalance`
        adapts from its completion probe instead."""
        if self.last_reload_s > step_s and self.window > self.min_window:
            self.window = max(self.min_window, self.window // 2)
        elif self.last_reload_s < 0.5 * step_s and self.window < self.max_window:
            self.window = min(self.max_window, self.window * 2)
