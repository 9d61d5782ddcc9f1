"""Time this tree's union FFN kernel (`sparse_ffn_v7u`) against another
version of its source, on one card, in turns (other, this, this, other), so
that two versions are compared inside one process on one card.

    git show <rev>:sparkinfer_tpu_torch/csrc/sparse_ffn_v7u.cu > build/v7u_other.cu
    python -m sparkinfer_tpu_torch.tools.v7u_compare --other build/v7u_other.cu

`--other` is a `csrc/sparse_ffn_v7u.cu` of another revision with the same
`extern "C" sparse_ffn_v7u` entry point. It is built with `ops/_build.py`'s
flags against this tree's `csrc/*.cuh`. Two entry-point forms are taken:
this tree's (bf16 or f32 x, a batch stride for the up bias; it exports
`sparse_ffn_v7u_plan`) and the earlier one (f32 x, `round_w`), which is
handed an f32 copy of x made outside the timing. Each case calls the entry
points directly over 64 cold union sets (each Cu groups of one random
layer's flat stores) inside a CUDA graph and prints one JSON line: the
mean microseconds per call of each turn, the largest difference between
the two outputs relative to their scale, and this tree's launch plan.
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
from ..ops.sparse_ffn import ACT_CODES, v7u_plan
from .qmm_compare import _graph_ms

# (label, B, Cu, E, G, layers, groups a layer): ProSparse-Llama-2-7B widths
# (Cu = 48 of 86 groups, the stores of all 32 layers) at B = 1, 4, 8, and
# 13B widths over one layer's stores (Cu = 64 of 108)
CASES = (("7B B=1", 1, 48, 4096, 128, 32, 86),
         ("7B B=4", 4, 48, 4096, 128, 32, 86),
         ("7B B=8", 8, 48, 4096, 128, 32, 86),
         ("13B B=8", 8, 64, 5120, 128, 1, 108))


def _load(src: Path, stem: str = "v7u_other") -> ctypes.CDLL:
    """Build src with the package's nvcc flags against this tree's headers
    (cached by content, as build/kernels/<stem>-<hash>.so) and load it."""
    digest = hashlib.sha1(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    for header in sorted(_build.CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = _build.BUILD_DIR / f"{stem}-{digest.hexdigest()[:12]}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(lib), str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _bind(lib: ctypes.CDLL) -> tuple[ctypes.CDLL, bool]:
    """The library and whether it has this tree's entry-point form."""
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    current = hasattr(lib, "sparse_ffn_v7u_plan")
    lib.sparse_ffn_v7u.argtypes = [p] * 9 + [i] * (9 if current else 8) + [f, f, i, p]
    lib.sparse_ffn_v7u.restype = i
    lib.sparse_ffn_v7u_scratch_floats.argtypes = [i] * 4
    lib.sparse_ffn_v7u_scratch_floats.restype = ll
    return lib, current


def compare(other: Path, reps: int = 64) -> list[dict]:
    libs = {"other": _bind(_load(other)), "this": _bind(_build.load("sparse_ffn_v7u"))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, B, Cu, E, G, L, ng in CASES:
        R = L * ng
        wu, wg = ((torch.randn((R, E, G), generator=gen, device="cuda") * 0.05).bfloat16()
                  for _ in range(2))
        wd = (torch.randn((R, G, E), generator=gen, device="cuda") * 0.05).bfloat16()
        unions = [(torch.randperm(ng, generator=gen, device="cuda")[:Cu]
                   + ng * int(torch.randint(L, (1,), generator=gen, device="cuda"))).to(torch.int32)
                  for _ in range(reps)]
        x = torch.randn((B, E), generator=gen, device="cuda").bfloat16()
        xf = x.float()
        sel = torch.rand((B, Cu, 1), generator=gen, device="cuda") < 0.6
        gp = torch.rand((B, Cu, G), generator=gen, device="cuda") * sel
        out = torch.empty((B, E), device="cuda")
        turns, outs = [], {}
        for name in ("other", "this", "this", "other"):
            lib, current = libs[name]
            scratch = torch.empty(max(1, lib.sparse_ffn_v7u_scratch_floats(B, Cu, E, G)),
                                  device="cuda")
            head = (x if current else xf).data_ptr()
            tail = ((1, 1, ACT_CODES["fatrelu"], Cu * G) if current
                    else (1, 0, ACT_CODES["fatrelu"]))

            def call(k, lib=lib, scratch=scratch, head=head, tail=tail):
                err = lib.sparse_ffn_v7u(
                    head, unions[k % reps].data_ptr(), gp.data_ptr(), None, wu.data_ptr(),
                    wg.data_ptr(), wd.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, Cu, E,
                    G, R, *tail, 0.0, 0.5, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"sparse_ffn_v7u ({name}) failed: CUDA error {err}")

            call(0)
            torch.cuda.synchronize()
            outs[name] = out.clone()
            turns.append([name, round(_graph_ms(call, reps) * 1e3, 3)])
        diff = (outs["other"] - outs["this"]).abs().max() / outs["other"].abs().max()
        rows.append({"case": f"{label} Cu={Cu} G={G} E={E} R={R}", "us": turns,
                     "rel_diff": float(diff), "plan": v7u_plan(x.device, B, Cu, E, G)})
        del wu, wg, wd
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="another csrc/sparse_ffn_v7u.cu to time against this tree's")
    ap.add_argument("--reps", type=int, default=64, help="calls per timed graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v7u_compare: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in compare(args.other, args.reps):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
