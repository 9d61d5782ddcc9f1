"""sparkinfer-torch-export-lora, the port of sparkinfer_tpu/tools/export_lora.py
(ref: tools/export-lora): merge a LoRA adapter into a base GGUF and write the
merged model. Host-only (numpy): no device is touched.

    python -m sparkinfer_tpu_torch.tools.export_lora -m base.gguf --lora a.gguf -o out.gguf
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparkinfer-torch-export-lora")
    ap.add_argument("-m", "--model", required=True, help="base GGUF")
    ap.add_argument("--lora", required=True, help="adapter GGUF")
    ap.add_argument("-o", "--outfile", required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    import numpy as np

    from ..gguf.constants import GGMLType
    from ..gguf.reader import GGUFReader
    from ..gguf.writer import GGUFWriter
    from ..models.lora import _TARGETS, load_lora

    ad = load_lora(args.lora)
    s_by_pair = {}
    for (layer, key), (A, B) in ad["deltas"].items():
        r = A.shape[0]
        s = args.scale * ad["alpha"] / max(r, 1)
        # delta in (out, in) orientation, the GGUF storage layout
        s_by_pair[(layer, key)] = s * (B @ A)

    inv = {v: k for k, v in _TARGETS.items()}
    rd = GGUFReader(args.model)
    w = GGUFWriter(args.outfile, rd.arch())
    for k, v in rd.kv.items():
        if k == "general.architecture":
            continue
        try:
            w.add_kv(k, v)
        except Exception:
            w.add_array(k, v)
    n_merged = 0
    for name, t in rd.tensors.items():
        data = None
        parts = name.split(".")
        if parts[0] == "blk" and len(parts) >= 4 and parts[3] == "weight":
            key = _TARGETS.get(parts[2])
            pair = (int(parts[1]), key) if key else None
            if pair in s_by_pair:
                data = t.to_f32() + s_by_pair[pair].astype(np.float32)
                w.add_tensor(name, data, GGMLType.F32)
                n_merged += 1
                continue
        w.add_tensor(name, t.raw(), t.ggml_type, raw=True, ne=t.ne)
    w.write()
    rd.close()
    print(f"merged {n_merged} tensors -> {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
