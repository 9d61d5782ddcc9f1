"""GGUF v2/v3 container reader (memory-mapped, zero-copy tensor views).

A copy of sparkinfer_tpu/gguf/reader.py, kept in the port so that it
imports nothing of the JAX package.

Format semantics match ggml's reader (ref: ggml/src/gguf.cpp,
gguf-py/gguf/gguf_reader.py): little-endian header (magic, version,
n_tensors, n_kv), typed KV section, tensor directory (name, n_dims, dims,
type, offset), then alignment-padded tensor data.

ggml stores dims as ne[0..n) with ne[0] the contiguous (fastest) dim; numpy
shape convention is the reverse, so `TensorInfo.shape` here is
`tuple(reversed(ne))` — a (n_ff, n_embd) weight in llama.cpp terms reads as
a numpy array of shape (n_ff, n_embd) whose rows are neuron rows.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)
from .quants import dequantize_tensor

_SCALAR_FMT = {
    GGUFValueType.UINT8: ("<B", 1),
    GGUFValueType.INT8: ("<b", 1),
    GGUFValueType.UINT16: ("<H", 2),
    GGUFValueType.INT16: ("<h", 2),
    GGUFValueType.UINT32: ("<I", 4),
    GGUFValueType.INT32: ("<i", 4),
    GGUFValueType.FLOAT32: ("<f", 4),
    GGUFValueType.BOOL: ("<?", 1),
    GGUFValueType.UINT64: ("<Q", 8),
    GGUFValueType.INT64: ("<q", 8),
    GGUFValueType.FLOAT64: ("<d", 8),
}

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.BOOL: np.bool_,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


@dataclass
class TensorInfo:
    name: str
    ggml_type: GGMLType
    ne: tuple[int, ...]  # ggml order: ne[0] fastest
    offset: int  # relative to data section start
    _reader: "GGUFReader" = field(repr=False, default=None)

    @property
    def shape(self) -> tuple[int, ...]:
        """numpy-order shape (slowest dim first)."""
        return tuple(reversed(self.ne))

    @property
    def n_elems(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return tensor_nbytes(self.n_elems, self.ggml_type)

    def raw(self) -> np.ndarray:
        """Zero-copy uint8 view over the mmapped file."""
        start = self._reader.data_offset + self.offset
        return np.frombuffer(self._reader.buf, dtype=np.uint8, count=self.nbytes, offset=start)

    def to_f32(self) -> np.ndarray:
        """Dequantize to a float32 numpy array of `.shape`."""
        return dequantize_tensor(self.raw(), self.ggml_type, self.shape)

    def astype_np(self) -> np.ndarray:
        """Plain types as a zero-copy typed view; quant types dequantized."""
        if self.ggml_type == GGMLType.F32:
            return self.raw().view(np.float32).reshape(self.shape)
        if self.ggml_type == GGMLType.F16:
            return self.raw().view(np.float16).reshape(self.shape)
        if self.ggml_type == GGMLType.I32:
            return self.raw().view(np.int32).reshape(self.shape)
        return self.to_f32()


class GGUFReader:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self.buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        magic, version = self._read_struct("<II")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        self.version = version
        n_tensors, n_kv = self._read_struct("<QQ")
        self.kv: dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._read_string()
            (vtype,) = self._read_struct("<I")
            self.kv[key] = self._read_value(GGUFValueType(vtype))
        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        self.tensors: dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = self._read_string()
            (n_dims,) = self._read_struct("<I")
            ne = self._read_struct(f"<{n_dims}Q") if n_dims else ()
            ttype, = self._read_struct("<I")
            (offset,) = self._read_struct("<Q")
            self.tensors[name] = TensorInfo(
                name=name, ggml_type=GGMLType(ttype), ne=tuple(int(d) for d in ne),
                offset=int(offset), _reader=self,
            )
        pad = -self._pos % self.alignment
        self.data_offset = self._pos + pad

    # --- low-level parsing ---

    def _read_struct(self, fmt: str) -> tuple:
        size = struct.calcsize(fmt)
        out = struct.unpack_from(fmt, self.buf, self._pos)
        self._pos += size
        return out

    def _read_string(self) -> str:
        (n,) = self._read_struct("<Q")
        s = bytes(self.buf[self._pos : self._pos + n])
        self._pos += n
        return s.decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            (etype_raw, n) = self._read_struct("<IQ")
            etype = GGUFValueType(etype_raw)
            if etype == GGUFValueType.STRING:
                return [self._read_string() for _ in range(n)]
            if etype == GGUFValueType.ARRAY:
                return [self._read_value(GGUFValueType.ARRAY) for _ in range(n)]
            dt = np.dtype(_SCALAR_NP[etype]).newbyteorder("<")
            arr = np.frombuffer(self.buf, dtype=dt, count=n, offset=self._pos).copy()
            self._pos += arr.nbytes
            return arr
        fmt, _ = _SCALAR_FMT[vtype]
        (v,) = self._read_struct(fmt)
        return v

    # --- convenience ---

    def get(self, key: str, default: Any = None) -> Any:
        return self.kv.get(key, default)

    def arch(self) -> str:
        return self.kv["general.architecture"]

    def field(self, template_key: str, default: Any = None) -> Any:
        """Look up an `{arch}.`-templated key."""
        return self.kv.get(template_key.format(arch=self.arch()), default)

    def close(self):
        # tensor .raw() views are zero-copy over the mmap; closing is
        # best-effort while such views are still alive
        try:
            self.buf.close()
        except BufferError:
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["GGUFReader", "TensorInfo"]
