"""Time the phases of one `sparse_ffn_v6` call, block by block, on one card.

    python -m sparkinfer_tpu_torch.tools.v6_stamps [--splits K]

Builds a copy of `csrc/sparse_ffn_v6.cu` in which every `// stamp: NAME`
comment of the kernel (`// stamp: NAME if COND` for a conditional one)
becomes a store of the card's global timer (`%globaltimer`, ns) by thread 0
of the block, and the `start` stamp also records the SM the block runs on.
It calls the kernel at the ProSparse-Llama-2-7B decode shapes (N = 1 and 4,
C = 12 of 86 groups, bf16 x and stores of all 32 layers, fatrelu) on cold
row sets and prints one JSON line per shape: the launch plan, for each stamp
the 0th, 10th, 50th, 90th and 100th percentile over the blocks in us after
the earliest start, and the blocks per SM as a histogram (entry b: the SMs
that ran b blocks). `--splits` forces the cluster size in place of the
planned one. The timer advances in steps of about 0.26 us on an H100.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from ..ops import _build
from ..ops.sparse_ffn import ACT_CODES
from .v7u_compare import _load

MARK = re.compile(r"^(\s*)// stamp: (\w+)(?: if (.+))?$", re.M)
MAX_BLOCKS = 8192


KERNEL = "template <typename W, typename X>\n__global__"  # v6_ffn's first line


def instrument(src: str, splits: int | None = None,
               anchor: str = KERNEL) -> tuple[str, list[str]]:
    """The source with its stamp comments made stores (the store function
    and its buffer placed before `anchor`), and the stamp names."""
    names: list[str] = []

    def store(m):
        names.append(m.group(2))
        cond = f" && ({m.group(3)})" if m.group(3) else ""
        return f"{m.group(1)}if (threadIdx.x == 0{cond}) ffn_stamp({len(names) - 1});"

    body = MARK.sub(store, src)
    if not names or names[0] != "start":
        raise SystemExit("stamps: the kernel source has no '// stamp: start' comment first")
    width = len(names) + 1  # the stamps, then the SM
    head = f"""
__device__ unsigned long long ffn_stamps[{MAX_BLOCKS} * {width}];
__device__ __forceinline__ void ffn_stamp(int i) {{
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (b >= {MAX_BLOCKS}) return;
  ffn_stamps[b * {width} + i] = now;
  if (i == 0) {{
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    ffn_stamps[b * {width} + {width - 1}] = sm;
  }}
}}
"""
    subs = [(anchor, head + anchor)]
    if splits is not None:
        subs += [("const int max_ks = most < kMaxSplits ? most : kMaxSplits;",
                  f"const int max_ks = {splits};"),
                 ("&sh->split, false, min_ks, true);", f"&sh->split, false, {splits}, true);")]
    for old, new in subs:
        if old not in body:
            raise SystemExit(f"stamps: the kernel source lacks {old!r}")
        body = body.replace(old, new, 1)
    body += f"""
extern "C" int ffn_stamps_read(void* dst, long long blocks) {{
  return (int)cudaMemcpyFromSymbol(dst, ffn_stamps, (size_t)blocks * {width} * 8);
}}
"""
    return body, names


def run(splits: int | None = None, reps: int = 4) -> list[dict]:
    src, names = instrument((_build.CSRC / "sparse_ffn_v6.cu").read_text(), splits)
    path = _build.BUILD_DIR.parent / f"v6_stamps_{splits or 0}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = _load(path, f"v6_stamps_{splits or 0}")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.sparse_ffn_v6.argtypes = [p] * 10 + [i] * 8 + [f, f, i, p]
    lib.sparse_ffn_v6.restype = i
    lib.sparse_ffn_v6_plan.argtypes = [i] * 7 + [ctypes.POINTER(ll)]
    lib.sparse_ffn_v6_plan.restype = i
    lib.ffn_stamps_read.argtypes = [p, ll]
    lib.ffn_stamps_read.restype = i
    width = len(names) + 1

    gen = torch.Generator(device="cuda").manual_seed(0)
    L, ng, C, E, G = 32, 86, 12, 4096, 128
    R = L * ng
    stores = [(torch.randn(sh, generator=gen, device="cuda") * 0.02).bfloat16()
              for sh in ((R, E, G), (R, E, G), (R, G, E))]
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    rows = []
    for N in (1, 4):
        x = torch.randn((N, E), generator=gen, device="cuda").bfloat16()
        gp = torch.rand((N, C, G), generator=gen, device="cuda")
        bu = torch.randn((N, C, G), generator=gen, device="cuda") * 0.1
        out = torch.empty((N, E), device="cuda")
        part = torch.empty(N * C * E, device="cuda")
        for _ in range(reps):  # the last call, on cold rows, is the one read
            idx = torch.stack([torch.randperm(ng, generator=gen, device="cuda")[:C]
                               + ng * int(torch.randint(L, (1,), generator=gen, device="cuda"))
                               for _ in range(N)]).to(torch.int32)
            err = lib.sparse_ffn_v6(
                x.data_ptr(), idx.data_ptr(), gp.data_ptr(), bu.data_ptr(),
                *(t.data_ptr() for t in stores), out.data_ptr(), part.data_ptr(),
                counters.data_ptr(), N, C, E, G, R, 1, 1, ACT_CODES["fatrelu"], 0.0, 0.5, 0,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"sparse_ffn_v6 failed: CUDA error {err}")
        plan = (ctypes.c_longlong * 9)()
        lib.sparse_ffn_v6_plan(N, C, E, G, 1, 1, 1, plan)
        blocks = min(plan[2], MAX_BLOCKS)
        buf = (ctypes.c_ulonglong * (blocks * width))()
        if lib.ffn_stamps_read(buf, blocks):
            raise RuntimeError("v6_stamps: reading the stamps failed")
        t = torch.tensor(list(buf), dtype=torch.float64).view(blocks, width)
        t0 = t[:, 0].min()
        stamps = {}
        for j, name in enumerate(names):
            us = ((t[:, j] - t0) / 1e3).sort().values
            stamps[name] = [round(float(us[int(q * (blocks - 1))]), 2)
                            for q in (0, 0.1, 0.5, 0.9, 1.0)]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = torch.bincount(t[:, -1].long(), minlength=sms)
        rows.append({"N": N, "C": C, "G": G, "E": E, "splits": plan[1], "blocks": plan[2],
                     "stamps_us": stamps, "blocks_per_sm": torch.bincount(per_sm).tolist()})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, default=None,
                    help="cluster size to force (1-16) in place of the planned one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("v6_stamps: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for row in run(args.splits):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
