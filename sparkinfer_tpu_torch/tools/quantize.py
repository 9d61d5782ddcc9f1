"""GGUF -> GGUF requantizer (ref: tools/quantize + src/llama-quant.cpp), the
port of sparkinfer_tpu/tools/quantize.py (host numpy, no device).

Per-tensor type rules mirror the reference defaults:
  - 2D matmul weights -> the target quant type (row size must divide the
    block size, else fall back to F16 like llama_tensor_get_type's
    fallback chain);
  - token_embd / output kept at q8_0 for q4 targets (quality-sensitive,
    ref llama-quant.cpp default rules), overridable;
  - 1D tensors (norms, biases) stay F32;
  - sparse predictor tensors stay F32 (they gate the whole FFN);
  - ffn_reorder_perms / I32 metadata copied verbatim.

    python -m sparkinfer_tpu_torch.tools.quantize in.gguf out.gguf q4_k \
        [--output-tensor-type q8_0] [--imatrix imatrix.gguf] [-v]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..gguf.constants import GGMLType, type_block_size
from ..gguf.quants import quantize, supported_encode_types
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter

_NAMES = {
    "q4_0": GGMLType.Q4_0,
    "q4_1": GGMLType.Q4_1,
    "q5_0": GGMLType.Q5_0,
    "q5_1": GGMLType.Q5_1,
    "q8_0": GGMLType.Q8_0,
    "q4_k": GGMLType.Q4_K,
    "q6_k": GGMLType.Q6_K,
    "f16": GGMLType.F16,
    "bf16": GGMLType.BF16,
    "f32": GGMLType.F32,
}


def tensor_target_type(
    name: str, shape: tuple[int, ...], target: GGMLType,
    output_type: GGMLType | None = None,
) -> GGMLType:
    if len(shape) < 2:
        return GGMLType.F32
    if "pred" in name or "norm" in name:
        return GGMLType.F32
    if name in ("token_embd.weight", "output.weight"):
        if output_type is not None:
            return output_type
        # low-bit targets keep embeddings/head at q8_0 (ref default rules)
        if target in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q4_K):
            return GGMLType.Q8_0
        return target
    row = shape[-1]
    bs = type_block_size(target) if target in supported_encode_types() else 1
    if row % bs != 0:
        return GGMLType.F16
    return target


def quantize_file(
    src: str, dst: str, target: GGMLType, output_type: GGMLType | None = None,
    verbose: bool = False, imatrix: str | None = None,
) -> dict:
    imat = {}
    if imatrix:
        from .imatrix import read_imatrix

        imat = {k[: -len(".imatrix")]: np.asarray(v, np.float32)
                for k, v in read_imatrix(imatrix).items()
                if k.endswith(".imatrix")}
    r = GGUFReader(src)
    arch = r.arch()
    w = GGUFWriter(dst, arch)
    for key, val in r.kv.items():
        if key == "general.architecture":
            continue
        try:
            w.add_kv(key, val)
        except Exception:
            w.add_array(key, val)
    w.add_kv("general.quantization_version", np.uint32(2))

    stats = {"tensors": 0, "bytes_in": 0, "bytes_out": 0}
    for name, t in r.tensors.items():
        if t.ggml_type == GGMLType.I32:
            w.add_tensor(name, t.astype_np(), GGMLType.I32)
            continue
        data = t.to_f32()
        tt = tensor_target_type(name, t.shape, target, output_type)
        if tt not in supported_encode_types() and tt not in (
            GGMLType.F32, GGMLType.F16, GGMLType.BF16
        ):
            tt = GGMLType.F16
        # importance-weighted rounding (ref: llama-quant.cpp:599+ hands
        # the imatrix per input channel into the row quantizers). The
        # imatrix vector spans the tensor's input dim = last numpy axis;
        # a shape mismatch (e.g. sparse-transposed ffn_down) skips it.
        qw = imat.get(name)
        if qw is not None and len(t.shape) >= 2 and qw.shape == (t.shape[-1],):
            buf = quantize(data, tt, qw=np.broadcast_to(qw, t.shape))
            w.add_tensor(name, buf, tt, raw=True,
                         ne=tuple(reversed(t.shape)))
            stats["imatrix_used"] = stats.get("imatrix_used", 0) + 1
        else:
            w.add_tensor(name, data, tt)
        stats["tensors"] += 1
        stats["bytes_in"] += t.nbytes
        from ..gguf.constants import tensor_nbytes

        stats["bytes_out"] += tensor_nbytes(t.n_elems, tt)
        if verbose:
            print(f"{name}: {t.ggml_type.name} -> {tt.name}", file=sys.stderr)
    w.write()
    r.close()
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparkinfer_tpu_torch.tools.quantize")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("type", choices=sorted(_NAMES))
    ap.add_argument("--output-tensor-type", choices=sorted(_NAMES), default=None)
    ap.add_argument("--imatrix", default=None,
                    help="importance matrix GGUF from tools/imatrix "
                         "(weights the K-quant rounding per input channel)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    ot = _NAMES[args.output_tensor_type] if args.output_tensor_type else None
    stats = quantize_file(args.src, args.dst, _NAMES[args.type], ot,
                          args.verbose, imatrix=args.imatrix)
    ratio = stats["bytes_in"] / max(stats["bytes_out"], 1)
    im = (f", imatrix on {stats['imatrix_used']} tensors"
          if stats.get("imatrix_used") else "")
    print(f"{stats['tensors']} tensors, {stats['bytes_in']/1e6:.1f} MB -> "
          f"{stats['bytes_out']/1e6:.1f} MB ({ratio:.2f}x){im}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
