"""A decode step captured as one CUDA graph, the port's counterpart of the
jitted decode step of the JAX Engine (sparkinfer_tpu/runtime/engine.py:270)
and of the Scheduler's `_jit_decode` and `_jit_decode_dense`
(runtime/scheduler.py:300, :319).

A `StepGraph` owns a step's static inputs, (B, T) int64 token and position
buffers (T = 1 for a decode step, K + 1 for a speculative verify forward),
and runs `fn(tokens, positions)` over them: eagerly (on the CPU, or
where the owner turns capture off), or on the card as one
torch.cuda.CUDAGraph. Its first run there warms the step up with one eager
call on a side stream, which builds the kernels and reaches every workspace,
launch plan and occupancy query that a kernel allocates or caches at its
first call; then it captures the step (capture does not run it) and replays
it once. Every later run replays. The outputs are then tensors of the
graph's private pool, overwritten by the next replay: a caller that keeps one
clones it. Whatever the graph reads stays at one address: the params and
stores, the KV cache (the int8 cache's codes and scales, each written and
read in place) and the static buffers. The fn holds its cache, so the
cache lives as long as its graph. A failure raises; nothing falls back to an
eager step.

A server runs a Scheduler's loop on one thread and its HTTP handlers on
others, and its router loads a model from a handler thread. A capture is
made in the "thread_local" mode, so that what another thread does on the
card meanwhile (an allocation, a copy, an eager step) neither joins nor
invalidates it, while a stray synchronization inside the step still fails it
loudly. `CAPTURE_LOCK` makes one capture at a time in the process; a model
load on a thread other than its Scheduler's holds it too.

The kernel wrappers count their launches in Python, which a replay does not
run. The graph records the launches its capture made and credits them to the
wrappers' `.launches` at every replay, so a counter still counts the kernel
calls run, the warm-up's included.

A step that updates state of its own in place (the tiered FFN's DFR
statistics, the sampler's ring of recent tokens and mirostat's mu) names
those tensors (`restore`): the warm-up's updates are undone, so a captured
step updates them once, as an eager one does.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from collections import OrderedDict
from typing import Callable

import torch

from ..ops import quant_matmul as qm
from ..ops import sparse_ffn as sf
from .kv_cache import cache_key

# every wrapper that counts its kernel launches
COUNTED = (sf.sparse_ffn_block, sf.sparse_ffn_block_v2, sf.sparse_ffn_block_v3,
           sf.sparse_ffn_block_v4, sf.sparse_ffn_block_v5, sf.sparse_ffn_block_v6,
           sf.sparse_ffn_block_v6q, sf.sparse_ffn_block_v7u, qm.quant_matmul_2d,
           qm.quant_matmul_flat, qm.int8_matmul)


# held by every capture, and by a model load off its Scheduler's thread
CAPTURE_LOCK = threading.RLock()


def resolve_capture(cuda_graph: bool | None, device: torch.device) -> bool:
    """The owners' `cuda_graph` argument: None captures on a CUDA device and
    not on the CPU; True elsewhere than on a CUDA device raises."""
    if cuda_graph is None:
        return device.type == "cuda"
    if cuda_graph and device.type != "cuda":
        raise ValueError(f"cuda_graph=True needs a CUDA device, not {device}")
    return bool(cuda_graph)


class StepGraph:
    """fn(tokens, positions) over static (B, T) buffers, run eagerly or as
    a captured CUDA graph (capture=True). `generator`: a CUDA generator the
    step draws from, registered with the graph, so that each replay draws
    what an eager call would; the warm-up's draws are undone. `log`: a list
    the capture's stats are appended to."""

    def __init__(self, fn: Callable, batch: int, device: torch.device, *, capture: bool,
                 generator: torch.Generator | None = None, label: str = "decode step",
                 log: list | None = None, restore: tuple = (), T: int = 1):
        self.fn = fn
        self.restore = restore  # state the step updates in place, which the warm-up must not
        io = torch.zeros((2, batch, T), dtype=torch.long, device=device)
        self.io = io  # [tokens; positions], for one copy from the host
        self.tokens, self.positions = io[0], io[1]
        self.capture = capture
        self.generator = generator
        self.label = label
        self.log = log
        self.graph = None
        self.outputs = None
        self.credits: tuple[int, ...] = ()
        self.stats: dict | None = None  # capture seconds and bytes, once captured

    def run(self):
        """The step's outputs for the current static inputs."""
        if not self.capture:
            return self.fn(self.tokens, self.positions)
        if self.graph is None:
            with CAPTURE_LOCK:
                self._capture()
        self.graph.replay()
        for w, n in zip(COUNTED, self.credits):
            w.launches += n
        return self.outputs

    def _capture(self):
        dev = self.tokens.device
        cur = torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rng = None if self.generator is None else self.generator.get_state()
        saved = [t.clone() for t in self.restore]
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn(self.tokens, self.positions)  # warm-up: lazy allocations, plans
            for t, v in zip(self.restore, saved):
                t.copy_(v)  # the warm-up's updates undone, as its draws are
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        alloc0, res0 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = [w.launches for w in COUNTED]
        # no garbage collection inside the capture: a collected cycle that
        # holds a dead CUDA graph resets it there, which invalidates the
        # capture (torch's graph context no longer collects before it)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                outputs = self.fn(self.tokens, self.positions)
            credits = tuple(w.launches - n for w, n in zip(COUNTED, before))
        finally:
            if collecting:
                gc.enable()
            for w, n in zip(COUNTED, before):
                w.launches = n
        if rng is not None:
            self.generator.set_state(rng)
        torch.cuda.synchronize(dev)
        alloc1, res1 = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        self.graph, self.outputs, self.credits = graph, outputs, credits
        self.stats = {"label": self.label, "capture_s": time.perf_counter() - t0,
                      "pool_bytes": res1 - res0, "allocated_before": alloc0,
                      "allocated_after": alloc1}
        if self.log is not None:
            self.log.append(self.stats)
        print(f"cuda graph: captured {self.label} (B={self.tokens.shape[0]}, "
              f"T={self.tokens.shape[1]}, "
              f"{sum(credits)} counted kernel calls) in {self.stats['capture_s']:.3f} s; "
              f"memory allocated {alloc0} -> {alloc1} bytes, graph pool {res1 - res0} bytes",
              file=sys.stderr, flush=True)


class StepGraphs:
    """An owner's StepGraphs, keyed by what a graph bakes in: the KV cache's
    storage (every buffer's pointer and shape, an iSWA cache's runs too, and
    its dtypes), the batch, the tokens a row T and the
    forward. At most `limit` are kept, the least recently used dropped
    first."""

    def __init__(self, device: torch.device, capture: bool, limit: int,
                 generator: torch.Generator | None = None):
        self.device, self.capture, self.limit = device, capture, limit
        self.generator = generator
        self._graphs: OrderedDict[tuple, StepGraph] = OrderedDict()
        self.captured: list[dict] = []  # the stats of every capture made, in order

    def get(self, cache, batch: int, forward: str, make_fn: Callable,
            restore: tuple = (), T: int = 1) -> StepGraph:
        key = (cache_key(cache), batch, T, forward)
        step = self._graphs.get(key)
        if step is None:
            step = StepGraph(make_fn(), batch, self.device, capture=self.capture,
                             generator=self.generator, label=f"{forward} step",
                             log=self.captured, restore=restore, T=T)
            self._graphs[key] = step
            while len(self._graphs) > self.limit:
                self._graphs.popitem(last=False)
        self._graphs.move_to_end(key)
        return step

    def __len__(self) -> int:
        return len(self._graphs)

    @property
    def captures(self) -> int:
        """Captures made so far, each with one eager warm-up call."""
        return len(self.captured)
