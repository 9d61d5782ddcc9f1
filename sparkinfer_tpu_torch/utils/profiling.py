"""Profiling and tracing, the port of sparkinfer_tpu/utils/profiling.py.

`trace(dir)` captures a torch.profiler trace of everything run inside the
context (host ops, and the card's kernels and copies where a card is) and
writes it into `dir` as a Chrome trace (`<host>_<pid>.<ns>.pt.trace.json`,
the layout TensorBoard's profiler plugin reads; chrome://tracing or
Perfetto open the file too). `annotate(name)` adds a named region to that
timeline (torch.profiler.record_function).

Usage:
    from sparkinfer_tpu_torch.utils.profiling import trace, annotate
    with trace("traces"):
        with annotate("decode-step"):
            step(...)

CLI surfaces: `python -m sparkinfer_tpu_torch.tools.bench_matrix --trace DIR`
wraps the measured section; `SPIF_TRACE_DIR` does the same for any
`maybe_trace` region.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the context into log_dir."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def annotate(name: str):
    """Named region on the profiler timeline."""
    return record_function(name)


@contextlib.contextmanager
def maybe_trace(log_dir: str | None = None):
    """trace() if a dir is given or SPIF_TRACE_DIR is set; no-op otherwise."""
    log_dir = log_dir or os.environ.get("SPIF_TRACE_DIR")
    if not log_dir:
        yield None
        return
    with trace(log_dir) as d:
        yield d


def device_memory_profile(path: str | None = None) -> bytes:
    """Snapshot of the card's memory: torch's own format, the pickled
    `torch.cuda.memory._snapshot()` that `torch.cuda.memory._dump_snapshot`
    writes and https://pytorch.org/memory_viz reads (not the pprof profile
    of the JAX package). The allocation stacks it holds are recorded only
    after `torch.cuda.memory._record_memory_history()`. Optionally saved to
    path."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device")
    prof = pickle.dumps(torch.cuda.memory._snapshot())
    if path:
        with open(path, "wb") as f:
            f.write(prof)
    return prof
