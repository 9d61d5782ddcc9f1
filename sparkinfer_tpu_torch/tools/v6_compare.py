"""Time this tree's decode FFN kernel (`sparse_ffn_v6`) against another
version of its source, on one card, in turns (other, this, this, other), so
that two versions are compared inside one process on one card.

    git show <rev>:sparkinfer_tpu_torch/csrc/sparse_ffn_v6.cu > build/v6_other.cu
    python -m sparkinfer_tpu_torch.tools.v6_compare --other build/v6_other.cu

`--other` is a `csrc/sparse_ffn_v6.cu` of another revision with the same
`extern "C" sparse_ffn_v6` entry point, built as `tools/v7u_compare.py`
builds its other source. Two entry-point forms are taken: this tree's (bf16
or f32 x, the per-device counters; it exports `sparse_ffn_v6_plan`) and the
earlier one (f32 x only, three launches), which is handed an f32 copy of x
made outside the timing. Each case calls the entry points directly over 64
cold row sets (each token C groups of one random layer of bf16 flat stores)
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
from ..ops.sparse_ffn import ACT_CODES, v6_plan
from .qmm_compare import _graph_ms
from .v7u_compare import _load

# (label, N, C, E, G, layers, groups a layer, activation): ProSparse-Llama-2-7B
# widths (C = 12 of 86 groups, the stores of all 32 layers) at N = 1 and 4,
# and the odd widths of the card tests (E not a multiple of the splits, G = 48)
CASES = (("7B N=1", 1, 12, 4096, 128, 32, 86, "fatrelu"),
         ("7B N=4", 4, 12, 4096, 128, 32, 86, "fatrelu"),
         ("7B N=4 relu", 4, 12, 4096, 128, 32, 86, "relu"),
         ("odd N=2", 2, 3, 1000, 48, 1, 7, "silu"))


def _bind(lib: ctypes.CDLL) -> tuple[ctypes.CDLL, bool]:
    """The library and whether it has this tree's entry-point form."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    current = hasattr(lib, "sparse_ffn_v6_plan")
    lib.sparse_ffn_v6.argtypes = ([p] * (10 if current else 9) + [i] * (8 if current else 7)
                                  + [f, f, i, p])
    lib.sparse_ffn_v6.restype = i
    lib.sparse_ffn_v6_scratch_floats.argtypes = [i] * 4
    lib.sparse_ffn_v6_scratch_floats.restype = ll
    if current:
        lib.sparse_ffn_v6_workspace_words.argtypes = []
        lib.sparse_ffn_v6_workspace_words.restype = ll
    return lib, current


def compare(other: Path, reps: int = 64) -> list[dict]:
    libs = {"other": _bind(_load(other, "v6_other")),
            "this": _bind(_build.load("sparse_ffn_v6"))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, N, C, E, G, L, ng, act in CASES:
        R = L * ng
        gated = act != "relu"
        stores = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).bfloat16()
                  for sh in ((R, E, G), (R, E, G), (R, G, E))]
        if not gated:
            stores[1] = None
        ids = [torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                            + ng * int(torch.randint(L, (1,), generator=gen, device="cuda"))
                            for _ in range(N)]).to(torch.int32) for _ in range(reps)]
        x = torch.randn((N, E), generator=gen, device="cuda").bfloat16()
        xf = x.float()
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1
        out = torch.empty((N, E), device="cuda")
        turns, outs = [], {}
        for name in ("other", "this", "this", "other"):
            lib, current = libs[name]
            scratch = torch.empty(max(1, lib.sparse_ffn_v6_scratch_floats(N, C, E, G)),
                                  device="cuda")
            if current:
                counters = torch.zeros(lib.sparse_ffn_v6_workspace_words(), dtype=torch.int32,
                                       device="cuda")
                head, mid, tail = x.data_ptr(), [counters.data_ptr()], [R, 1, 1]
            else:
                head, mid, tail = xf.data_ptr(), [], [R, 1]

            def call(k, lib=lib, scratch=scratch, head=head, mid=mid, tail=tail):
                err = lib.sparse_ffn_v6(
                    head, ids[k % reps].data_ptr(), gp.data_ptr(), bu.data_ptr(),
                    *(None if t is None else t.data_ptr() for t in stores), out.data_ptr(),
                    scratch.data_ptr(), *mid, N, C, E, G, *tail, ACT_CODES[act], 0.0, 0.5, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"sparse_ffn_v6 ({name}) failed: CUDA error {err}")

            call(0)
            torch.cuda.synchronize()
            outs[name] = out.clone()
            turns.append([name, round(_graph_ms(call, reps) * 1e3, 3)])
        diff = (outs["other"] - outs["this"]).abs().max() / outs["other"].abs().max()
        rows.append({"case": f"{label} {act} C={C} G={G} E={E} R={R}", "us": turns,
                     "rel_diff": float(diff), "plan": v6_plan(x.device, N, C, E, G, gated=gated)})
        del stores
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another csrc/sparse_ffn_v6.cu to time against this tree's")
    ap.add_argument("--reps", type=int, default=64, help="calls per timed graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v6_compare: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in compare(args.other, args.reps):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
