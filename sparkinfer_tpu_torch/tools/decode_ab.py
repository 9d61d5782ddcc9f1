"""The 7B-width bf16 decode step of one checkout, for comparing two
revisions on one card: run as a file, so that the package it times is the
one under ROOT,

    python sparkinfer_tpu_torch/tools/decode_ab.py ROOT

with ROOT a checkout (this one, or another revision unpacked with `git
archive`). It builds `chip_smoke.py`'s random 7B-width model (seed 0), the
sparse (SparseConfig(128, 12)) and the dense Engine on the card, and prints
one JSON line: for each, the median wall ms between tokens of three
64-token greedy generates after a first one (which captures the graph).
Alternate the revisions within one call (parent, change, change, parent).
"""

from __future__ import annotations

import json
import statistics
import sys
import time


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    import sparkinfer_tpu_torch
    from sparkinfer_tpu_torch.runtime.engine import Engine
    from sparkinfer_tpu_torch.runtime.sampling import SamplerConfig
    from sparkinfer_tpu_torch.sparse.config import SparseConfig

    if not sparkinfer_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {sparkinfer_tpu_torch.__file__}, not the package under {root}")
    cfg = chip_smoke.prosparse_config(32, 4096, 32, 11008, 32000, 1024)
    model = chip_smoke.random_model(cfg, torch.bfloat16, "cuda", 0)
    prompt = torch.randint(32000, (32,), generator=torch.Generator().manual_seed(0)).tolist()
    out = {"root": root}
    for label, sparse in (("sparse", SparseConfig(128, 12)), ("dense", None)):
        eng = Engine(model, max_seq=1024, sampler=SamplerConfig(temp=0.0), sparse=sparse,
                     device="cuda")
        eng.generate(prompt, 64)
        medians = []
        for _ in range(3):
            stamps = [time.perf_counter() for _ in eng.generate(prompt, 64, stream=True)]
            medians.append(1e3 * statistics.median(b - a for a, b in zip(stamps[1:], stamps[2:])))
        out[label] = medians
        del eng
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1])))
