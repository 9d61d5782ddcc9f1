"""GGUF v3 container writer.

Produces files readable by ggml's reader (ref: ggml/src/gguf.cpp) and by
gguf.reader. A copy of sparkinfer_tpu/gguf/writer.py; it encodes every type
the port's gguf.quants encodes.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)
from .quants import quantize

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.bool_): GGUFValueType.BOOL,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
}

_VTYPE_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NP_PLAIN_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.int8): GGMLType.I8,
    np.dtype(np.int16): GGMLType.I16,
    np.dtype(np.int32): GGMLType.I32,
    np.dtype(np.int64): GGMLType.I64,
    np.dtype(np.float64): GGMLType.F64,
}


def _infer_vtype(v: Any) -> GGUFValueType:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if iv < 0:
            return GGUFValueType.INT64 if iv < -(2**31) else GGUFValueType.INT32
        return GGUFValueType.UINT64 if iv >= 2**32 else GGUFValueType.UINT32
    if isinstance(v, (float, np.floating)):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(v)}")


class GGUFWriter:
    def __init__(self, path: str | Path, arch: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, Any]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []
        self.add_kv("general.architecture", arch)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add_kv("general.alignment", np.uint32(alignment))

    # --- KV ---

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self._kv.append((key, vtype or _infer_vtype(value), value))

    def add_array(self, key: str, values: Sequence | np.ndarray):
        self.add_kv(key, values, GGUFValueType.ARRAY)

    # --- tensors ---

    def add_tensor(
        self,
        name: str,
        data: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw: bool = False,
        ne: tuple[int, ...] | None = None,
    ):
        """Add a tensor.

        `data` is in numpy order (slowest dim first); stored ne is reversed.
        If `raw`, `data` is an already-encoded uint8 buffer and `ne` is required.
        """
        if raw:
            assert ne is not None and ggml_type is not None
            buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
            assert buf.nbytes == tensor_nbytes(int(np.prod(ne)), ggml_type)
            self._tensors.append((name, tuple(ne), ggml_type, buf))
            return
        if ggml_type is None:
            ggml_type = _NP_PLAIN_GGML.get(np.asarray(data).dtype, GGMLType.F32)
        ne_out = tuple(reversed(np.asarray(data).shape)) or (1,)
        if ggml_type in _NP_PLAIN_GGML.values() and np.asarray(data).dtype in _NP_PLAIN_GGML and _NP_PLAIN_GGML[np.asarray(data).dtype] == ggml_type:
            buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        else:
            buf = quantize(np.asarray(data), ggml_type)
        self._tensors.append((name, ne_out, ggml_type, buf))

    # --- serialization ---

    def _w_string(self, f, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _w_value(self, f, vtype: GGUFValueType, v: Any):
        if vtype == GGUFValueType.STRING:
            self._w_string(f, v)
            return
        if vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray) and v.dtype in _NP_TO_VTYPE:
                etype = _NP_TO_VTYPE[v.dtype]
                f.write(struct.pack("<IQ", etype, v.size))
                f.write(np.ascontiguousarray(v).astype(v.dtype.newbyteorder("<")).tobytes())
                return
            items = list(v)
            if not items:
                f.write(struct.pack("<IQ", GGUFValueType.UINT32, 0))
                return
            etype = _infer_vtype(items[0])
            if etype in (GGUFValueType.UINT32, GGUFValueType.INT32, GGUFValueType.UINT64, GGUFValueType.INT64) and any(
                isinstance(x, (int, np.integer)) for x in items
            ):
                # promote to a common int width
                lo, hi = min(int(x) for x in items), max(int(x) for x in items)
                if lo < 0:
                    etype = GGUFValueType.INT64 if (lo < -(2**31) or hi >= 2**31) else GGUFValueType.INT32
                else:
                    etype = GGUFValueType.UINT64 if hi >= 2**32 else GGUFValueType.UINT32
            f.write(struct.pack("<IQ", etype, len(items)))
            for x in items:
                self._w_value(f, etype, x)
            return
        f.write(struct.pack(_VTYPE_FMT[vtype], v))

    def write(self):
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv)))
            for key, vtype, v in self._kv:
                self._w_string(f, key)
                f.write(struct.pack("<I", vtype))
                self._w_value(f, vtype, v)
            offset = 0
            offsets = []
            for name, ne, ttype, buf in self._tensors:
                self._w_string(f, name)
                f.write(struct.pack("<I", len(ne)))
                f.write(struct.pack(f"<{len(ne)}Q", *ne))
                f.write(struct.pack("<I", ttype))
                f.write(struct.pack("<Q", offset))
                offsets.append(offset)
                offset += buf.nbytes
                offset += -offset % self.alignment
            pad = -f.tell() % self.alignment
            f.write(b"\x00" * pad)
            for (_, _, _, buf), off in zip(self._tensors, offsets):
                f.write(buf.tobytes())
                pad = -buf.nbytes % self.alignment
                f.write(b"\x00" * pad)


__all__ = ["GGUFWriter"]
