"""Time this tree's Q8_0 sparse FFN kernel (`sparse_ffn_v6q`) against another
version of its source, on one card, in turns (other, this, this, other), so
that two versions are compared inside one process on one card.

    git show <rev>:sparkinfer_tpu_torch/csrc/sparse_ffn_v6q.cu > build/v6q_other.cu
    python -m sparkinfer_tpu_torch.tools.v6q_compare --other build/v6q_other.cu

`--other` is a `csrc/sparse_ffn_v6q.cu` of another revision with the same
`extern "C" sparse_ffn_v6q` entry point, built as `tools/v7u_compare.py`
builds its other source. Two entry-point forms are taken: this tree's (bf16
or f32 x; it exports `sparse_ffn_v6q_plan`) and the earlier one (f32 x
only), which is handed an f32 copy of x made outside the timing. Each case
calls the entry points directly over 64 cold row sets (each token C groups
of one random layer of Q8_0 flat stores) inside a CUDA graph and prints one
JSON line: the mean microseconds per call of each turn, the largest
difference between the two outputs relative to their scale, and this
tree's launch plan.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from ..ops import _build
from ..ops.sparse_ffn import ACT_CODES, v6q_plan
from .qmm_compare import _graph_ms
from .v7u_compare import _load

# (label, N, C, E, G, layers, groups a layer): ProSparse-Llama-2-13B widths
# (C = 16 of 108 groups, the stores of all 40 layers) at N = 1 and 4,
# ProSparse-Llama-2-7B widths (C = 12 of 86, 32 layers) at N = 1, and the
# odd widths of the card tests (E not a multiple of the tiles, G = 96)
CASES = (("13B N=1", 1, 16, 5120, 128, 40, 108),
         ("13B N=4", 4, 16, 5120, 128, 40, 108),
         ("7B N=1", 1, 12, 4096, 128, 32, 86),
         ("odd N=2", 2, 3, 1056, 96, 1, 7))


def _bind(lib: ctypes.CDLL) -> tuple[ctypes.CDLL, bool]:
    """The library and whether it has this tree's entry-point form."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    current = hasattr(lib, "sparse_ffn_v6q_plan")
    lib.sparse_ffn_v6q.argtypes = [p] * 12 + [i] * (7 if current else 6) + [f, f, i, p]
    lib.sparse_ffn_v6q.restype = i
    lib.sparse_ffn_v6q_scratch_floats.argtypes = [i] * 4
    lib.sparse_ffn_v6q_scratch_floats.restype = ll
    return lib, current


def _store(gen, R, rows, cols):
    """Random int8 (R, rows, cols) and f32 scales (R, rows / 32, cols)."""
    q = torch.randint(-127, 128, (R, rows, cols), generator=gen, device="cuda",
                      dtype=torch.int8)
    return q, torch.rand((R, rows // 32, cols), generator=gen, device="cuda") * 4e-4


def compare(other: Path, reps: int = 64) -> list[dict]:
    libs = {"other": _bind(_load(other, "v6q_other")),
            "this": _bind(_build.load("sparse_ffn_v6q"))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, N, C, E, G, L, ng in CASES:
        R = L * ng
        stores = [*_store(gen, R, E, G), *_store(gen, R, E, G), *_store(gen, R, G, E)]
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
            scratch = torch.empty(lib.sparse_ffn_v6q_scratch_floats(N, C, E, G), device="cuda")
            head = (x if current else xf).data_ptr()
            tail = (R, 1, ACT_CODES["fatrelu"]) if current else (R, ACT_CODES["fatrelu"])

            def call(k, lib=lib, scratch=scratch, head=head, tail=tail):
                err = lib.sparse_ffn_v6q(
                    head, ids[k % reps].data_ptr(), gp.data_ptr(), None,
                    *(t.data_ptr() for t in stores), out.data_ptr(), scratch.data_ptr(), N,
                    C, E, G, *tail, 0.0, 0.5, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"sparse_ffn_v6q ({name}) failed: CUDA error {err}")

            call(0)
            torch.cuda.synchronize()
            outs[name] = out.clone()
            turns.append([name, round(_graph_ms(call, reps) * 1e3, 3)])
        diff = (outs["other"] - outs["this"]).abs().max() / outs["other"].abs().max()
        rows.append({"case": f"{label} C={C} G={G} E={E} R={R}", "us": turns,
                     "rel_diff": float(diff), "plan": v6q_plan(x.device, N, C, E, G)})
        del stores
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another csrc/sparse_ffn_v6q.cu to time against this tree's")
    ap.add_argument("--reps", type=int, default=64, help="calls per timed graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v6q_compare: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in compare(args.other, args.reps):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
