"""Time the phases of one `sparse_ffn_v1` call (the row kernel of
`sparse_ffn_block` and `_v2`-`_v5`), block by block, on one card.

    python -m sparkinfer_tpu_torch.tools.v1_stamps

Builds a copy of `csrc/sparse_ffn_v1.cu` in which every `// stamp: NAME`
comment of the kernel becomes a store of the card's global timer by thread 0
of the block (`tools/v6_stamps.py`'s instrumenter; the `start` stamp also
records the SM). It calls the kernel at the ProSparse-Llama-2-7B decode
shapes of the Scheduler (N = 1 and 4 tokens, C = 12 of 86 groups of one
random layer of bf16 row stores of all 32 layers, bf16 x, fatrelu) on cold
row sets and prints one JSON line per shape: the launch plan; for each stamp
the 0th, 10th, 50th, 90th and 100th percentile over the blocks that reached
it, in us after the earliest start (the `summed` stamp only in the blocks
that added a token's cluster partials); the blocks per SM as a histogram
(entry b: the SMs that ran b blocks); and the median `streamed` stamp of the
blocks by the blocks their SM ran. The timer advances in steps of about
0.26 us on an H100.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import _build
from ..ops.sparse_ffn import ACT_CODES
from .v6_stamps import MAX_BLOCKS, instrument
from .v7u_compare import _load

KERNEL = "template <typename W, typename X, int NQ>\n__global__"  # v1_ffn's first line


def run(reps: int = 4) -> list[dict]:
    src, names = instrument((_build.CSRC / "sparse_ffn_v1.cu").read_text(), anchor=KERNEL)
    path = _build.BUILD_DIR.parent / "v1_stamps.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = _load(path, "v1_stamps")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.sparse_ffn_v1.argtypes = [p] * 11 + [i] * 8 + [ll] * 4 + [f, f, i, p]
    lib.sparse_ffn_v1.restype = i
    lib.sparse_ffn_v1_scratch_floats.argtypes = [i] * 7
    lib.sparse_ffn_v1_scratch_floats.restype = ll
    lib.sparse_ffn_v1_plan.argtypes = [i] * 7 + [ctypes.POINTER(ll)]
    lib.sparse_ffn_v1_plan.restype = i
    lib.ffn_stamps_read.argtypes = [p, ll]
    lib.ffn_stamps_read.restype = i
    width = len(names) + 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    L, ng, C, E, G = 32, 86, 12, 4096, 128
    R = L * ng
    w_all = (torch.randn((3 * R, G, E), generator=gen, device="cuda") * 0.02).bfloat16()
    stores = [w_all[q * R:].data_ptr() for q in range(3)]
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    rows = []
    for N in (1, 4):
        x = torch.randn((N, E), generator=gen, device="cuda").bfloat16()
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        out = torch.empty((N, E), device="cuda")
        part = torch.empty(max(1, lib.sparse_ffn_v1_scratch_floats(N, C, E, G, 1, 1, 1)),
                           device="cuda")
        for _ in range(reps):  # the last call, on cold rows, is the one read
            layer = ng * int(torch.randint(L, (1,), generator=gen, device="cuda"))
            idx = torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C] + layer
                               for _ in range(N)]).to(torch.int32)
            err = lib.sparse_ffn_v1(
                x.data_ptr(), idx.data_ptr(), gp.data_ptr(), None, None, *stores,
                out.data_ptr(), part.data_ptr(), counters.data_ptr(), N, C, E, G, R, 1, 1,
                ACT_CODES["fatrelu"], G * E, 0, 0, 0, 0.0, 0.5, 0,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"sparse_ffn_v1 failed: CUDA error {err}")
        plan = (ctypes.c_longlong * 9)()
        lib.sparse_ffn_v1_plan(N, C, E, G, 1, 1, 1, plan)
        blocks = min(plan[3], MAX_BLOCKS)
        buf = (ctypes.c_ulonglong * (blocks * width))()
        if lib.ffn_stamps_read(buf, blocks):
            raise RuntimeError("v1_stamps: reading the stamps failed")
        t = torch.tensor(list(buf), dtype=torch.float64).view(blocks, width)
        t0 = t[:, 0].min()
        stamps = {}
        for j, name in enumerate(names):
            got = t[:, j][t[:, j] >= t0]  # blocks that reached the stamp
            us = ((got - t0) / 1e3).sort().values
            stamps[name] = [round(float(us[int(q * (len(us) - 1))]), 2)
                            for q in (0, 0.1, 0.5, 0.9, 1.0)] if len(us) else None
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        sm = t[:, -1].long()
        per_sm = torch.bincount(sm, minlength=sms)
        held = per_sm[sm]
        streamed = (t[:, names.index("streamed")] - t0) / 1e3
        by_held = {int(b): round(float(streamed[held == b].median()), 2) for b in held.unique()}
        rows.append({"N": N, "C": C, "G": G, "E": E, "splits": plan[1],
                     "clusters_per_token": plan[2], "blocks": plan[3], "stamps_us": stamps,
                     "blocks_per_sm": torch.bincount(per_sm).tolist(),
                     "streamed_median_us_by_blocks_on_sm": by_held})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v1_stamps: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in run():
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
