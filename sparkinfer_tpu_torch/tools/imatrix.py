"""Importance-matrix files: the reader of sparkinfer_tpu/tools/imatrix.py.

An imatrix GGUF holds one F32 `<tensor>.imatrix` vector per matmul (the
mean squared input activation of each input channel over a calibration
corpus) and the `imatrix.n_tokens` KV. tools/quantize.py --imatrix reads
it to weight the K-quant rounding per input channel. The collector, which
runs a model over a corpus, is not ported yet.
"""

from __future__ import annotations


def read_imatrix(path: str) -> dict:
    """{"n_tokens": int, "<tensor>.imatrix": f32 numpy vector, ...}"""
    from ..gguf.reader import GGUFReader

    r = GGUFReader(path)
    out = {"n_tokens": int(r.kv.get("imatrix.n_tokens", 0))}
    for name, t in r.tensors.items():
        out[name] = t.to_f32()
    r.close()
    return out
