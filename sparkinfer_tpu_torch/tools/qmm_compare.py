"""Time this tree's packed-linear kernels against another version of their
source, on one card, in turns (other, this, this, other), so that two
versions are compared inside one process on one card.

    python -m sparkinfer_tpu_torch.tools.qmm_compare --other old/quant_matmul.cu

`--other` is a `csrc/quant_matmul.cu` of another revision with the same
`extern "C" quant_matmul` entry point (for example one taken with
`git show <rev>:sparkinfer_tpu_torch/csrc/quant_matmul.cu`). Both are built
with `ops/_build.py`'s flags. Each case calls the entry points directly over
64 cold random stores (4 of the 184 MB head; the 40 layer stripes of one
flat store) inside a CUDA graph and prints one JSON line: the mean
microseconds per call of each turn, and the largest difference between the
two outputs relative to their scale. A library that exports
`quant_matmul_workspace_words` gets its workspace where
`quant_matmul_scratch_floats` asks for no scratch, else that scratch per
call (a revision whose prefill took two launches).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from ..ops import _build

# (kind, N, IN, OUT, layers, x dtype): the 13B attention projection and
# pred_down at decode; at a batch of 8, a 32-token prefill (with the head
# and pred_down) and a 512-token chunk
CASES = (("q8_0", 1, 5120, 5120, 1, torch.bfloat16),
         ("q8_0", 1, 1280, 13824, 40, torch.float32),
         ("q8_0", 8, 5120, 5120, 1, torch.bfloat16),
         ("q8_0", 32, 5120, 5120, 1, torch.bfloat16),
         ("q4_0", 32, 5120, 5120, 1, torch.bfloat16),
         ("q8_0", 32, 5120, 32000, 1, torch.bfloat16),
         ("q8_0", 32, 1280, 13824, 40, torch.float32),
         ("q8_0", 512, 5120, 5120, 1, torch.bfloat16))


def _load(src: Path) -> ctypes.CDLL:
    """Build src with the package's nvcc flags (cached by content) and bind it."""
    digest = hashlib.sha1(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    lib = _build.BUILD_DIR / f"qmm_other-{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quant_matmul.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
    lib.quant_matmul.restype = i
    lib.quant_matmul_scratch_floats.argtypes = [i, i, i]
    lib.quant_matmul_scratch_floats.restype = ll
    if hasattr(lib, "quant_matmul_workspace_words"):
        lib.quant_matmul_workspace_words.restype = ll
    return lib


def _graph_ms(fn, reps: int) -> float:
    """Mean device time of fn(k) over reps calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(reps):
            fn(k)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(other: Path, reps: int = 64) -> list[dict]:
    libs = {"other": _bind(_load(other)), "this": _bind(_build.load("quant_matmul"))}
    scratch_of = {}
    for name, lib in libs.items():
        ws = None
        if hasattr(lib, "quant_matmul_workspace_words"):
            ws = torch.zeros(lib.quant_matmul_workspace_words(), dtype=torch.int32,
                             device="cuda")
        scratch_of[name] = ws
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kind, N, IN, OUT, L, xdt in CASES:
        n, ld, q4 = (1 if L > 1 else 4 if IN * OUT > 1 << 26 else 64), OUT * L, kind == "q4_0"
        if q4:
            q = torch.randint(0, 256, (n, IN // 2, ld), generator=gen, device="cuda",
                              dtype=torch.uint8)
        else:
            q = torch.randint(-127, 128, (n, IN, ld), generator=gen, device="cuda",
                              dtype=torch.int8)
        s = torch.rand((n, IN // 32, ld), generator=gen, device="cuda") * 0.01
        x = torch.randn((N, IN), generator=gen, device="cuda").to(xdt)
        out = torch.empty((N, OUT), device="cuda")
        turns, outs = [], {}
        for name in ("other", "this", "this", "other"):
            lib = libs[name]
            scratch = scratch_of[name]
            floats = lib.quant_matmul_scratch_floats(N, IN, OUT)
            if scratch is None or floats > 0:
                scratch = torch.empty(max(1, floats), device="cuda")

            def call(k, lib=lib, scratch=scratch):
                err = lib.quant_matmul(
                    x.data_ptr(), int(xdt == torch.bfloat16), q[k % n].data_ptr(),
                    s[k % n].data_ptr(), out.data_ptr(), scratch.data_ptr(), N, IN, OUT, ld,
                    (k % L) * OUT, int(q4), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"quant_matmul ({name}) failed: CUDA error {err}")

            call(0)
            torch.cuda.synchronize()
            outs[name] = out.clone()
            turns.append([name, round(_graph_ms(call, reps) * 1e3, 3)])
        diff = (outs["other"] - outs["this"]).abs().max() / outs["other"].abs().max()
        rows.append({"case": f"{kind} {IN}x{OUT} N={N}" + (" flat" if L > 1 else ""),
                     "us": turns, "rel_diff": float(diff)})
        del q, s
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another csrc/quant_matmul.cu to time against this tree's")
    ap.add_argument("--reps", type=int, default=64, help="calls per timed graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("qmm_compare: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in compare(args.other, args.reps):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
