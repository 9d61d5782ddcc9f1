"""Time this tree's row kernel (`sparse_ffn_v1`, which serves
`sparse_ffn_block` and `_v2`-`_v5`) against another version of its source,
on one card, in turns (other, this, this, other), so that two versions are
compared inside one process on one card.

    mkdir -p build/v1_other
    git archive <rev> sparkinfer_tpu_torch/csrc | tar -x -C build/v1_other
    python -m sparkinfer_tpu_torch.tools.v1_compare \
        --other build/v1_other/sparkinfer_tpu_torch/csrc/sparse_ffn_v1.cu

`--other` is a `csrc/sparse_ffn_v1.cu` of another revision with the same
`extern "C" sparse_ffn_v1` entry point, built as `tools/v7u_compare.py`
builds its other source; kept beside its own revision's headers, it
includes those (a quoted include searches the source's directory first),
since the shared headers change between revisions. Two entry-point forms
are taken: this tree's (bf16 or f32 x, the per-device counters; it exports
`sparse_ffn_v1_plan`) and the earlier one (f32 x only, three launches),
which is handed an f32 copy of x made outside the timing. Each case calls the entry points directly over 64
cold row sets (each token C groups of one random layer of bf16 row stores)
inside a CUDA graph and prints one JSON line: the mean microseconds per
call of each turn, the largest difference between the two outputs relative
to their scale, and this tree's launch plan.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops.sparse_ffn import ACT_CODES, v1_plan
from .qmm_compare import _graph_ms
from .v7u_compare import _load

# (label, N, C, E, G, layers, groups a layer, layout): ProSparse-Llama-2-7B
# widths (C = 12 of 86 groups, the stores of all 32 layers) at N = 1 and 4
# over three stores, N = 1 over v2's concatenated store, and the odd widths
# of the card tests (E not a multiple of the splits, G = 12)
CASES = (("7B N=1", 1, 12, 4096, 128, 32, 86, "three"),
         ("7B N=4", 4, 12, 4096, 128, 32, 86, "three"),
         ("7B N=1 v2", 1, 12, 4096, 128, 32, 86, "v2"),
         ("odd N=2", 2, 3, 1000, 12, 1, 7, "three"))


def _bind(lib: ctypes.CDLL) -> tuple[ctypes.CDLL, bool]:
    """The library and whether it has this tree's entry-point form."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    current = hasattr(lib, "sparse_ffn_v1_plan")
    lib.sparse_ffn_v1.argtypes = ([p] * (11 if current else 10) + [i] * (8 if current else 7)
                                  + [ll] * 4 + [f, f, i, p])
    lib.sparse_ffn_v1.restype = i
    lib.sparse_ffn_v1_scratch_floats.argtypes = [i] * (7 if current else 4)
    lib.sparse_ffn_v1_scratch_floats.restype = ll
    if current:
        lib.sparse_ffn_v1_workspace_words.argtypes = []
        lib.sparse_ffn_v1_workspace_words.restype = ll
    return lib, current


def compare(other: Path, reps: int = 64) -> list[dict]:
    libs = {"other": _bind(_load(other, "v1_other")),
            "this": _bind(_build.load("sparse_ffn_v1"))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, N, C, E, G, L, ng, layout in CASES:
        R = L * ng
        # one (3R, G, E) store [up; gate; down]: three pointers into it, or
        # v2's one pointer with offsets
        w_all = (torch.randn((3 * R, G, E), generator=gen, device="cuda") * 0.02).bfloat16()
        if layout == "v2":
            ptrs, offs = [w_all.data_ptr()] * 3, [0, R * G * E, 2 * R * G * E]
        else:
            ptrs, offs = [w_all[p * R:].data_ptr() for p in range(3)], [0, 0, 0]
        ids = [torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                            + ng * int(torch.randint(L, (1,), generator=gen, device="cuda"))
                            for _ in range(N)]).to(torch.int32) for _ in range(reps)]
        x = torch.randn((N, E), generator=gen, device="cuda").bfloat16()
        xf = x.float()
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        out = torch.empty((N, E), device="cuda")
        turns, outs = [], {}
        for name in ("other", "this", "this", "other"):
            lib, current = libs[name]
            keys = (1, 1, 1) if current else ()  # gated, bf16 stores, bf16 x
            scratch = torch.empty(max(1, lib.sparse_ffn_v1_scratch_floats(N, C, E, G, *keys)),
                                  device="cuda")
            if current:
                counters = torch.zeros(lib.sparse_ffn_v1_workspace_words(), dtype=torch.int32,
                                       device="cuda")
                head, mid, ints = x.data_ptr(), [counters.data_ptr()], [R, 1, 1]
            else:
                head, mid, ints = xf.data_ptr(), [], [R, 1]

            def call(k, lib=lib, scratch=scratch, head=head, mid=mid, ints=ints):
                err = lib.sparse_ffn_v1(
                    head, ids[k % reps].data_ptr(), gp.data_ptr(), None, None, *ptrs,
                    out.data_ptr(), scratch.data_ptr(), *mid, N, C, E, G, *ints,
                    ACT_CODES["fatrelu"], G * E, *offs, 0.0, 0.5, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"sparse_ffn_v1 ({name}) failed: CUDA error {err}")

            call(0)
            torch.cuda.synchronize()
            outs[name] = out.clone()
            turns.append([name, round(_graph_ms(call, reps) * 1e3, 3)])
        diff = (outs["other"] - outs["this"]).abs().max() / outs["other"].abs().max()
        rows.append({"case": f"{label} fatrelu C={C} G={G} E={E} R={R}", "us": turns,
                     "rel_diff": float(diff), "plan": v1_plan(x.device, N, C, E, G)})
        del w_all
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another csrc/sparse_ffn_v1.cu to time against this tree's")
    ap.add_argument("--reps", type=int, default=64, help="calls per timed graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v1_compare: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in compare(args.other, args.reps):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
