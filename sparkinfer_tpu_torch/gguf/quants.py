"""Dequantization of the GGML tensor types the port loads.

A subset of sparkinfer_tpu/gguf/quants.py: F32/F16/BF16 and the Q8_0/Q4_0
block formats. Other types raise NotImplementedError until a later slice of
the port needs them. The wire layouts match ggml's block structs
(ggml/src/ggml-common.h).

`quantize` encodes Q8_0 and Q4_0 in torch on the tensor's device (seconds
for a 13B model's weights on the card, where the numpy encoder takes
minutes), byte for byte as the JAX package's numpy encoder does.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import GGML_TYPE_TRAITS, GGMLType


def _f16(buf: np.ndarray) -> np.ndarray:
    return buf.view(np.float16).astype(np.float32)


def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _dec_q4_0(blocks: np.ndarray) -> np.ndarray:
    # block: [d:f16][qs:16]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))  # (nb, 1)
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return out * d


def _dec_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return qs * d


_DECODERS = {GGMLType.Q4_0: _dec_q4_0, GGMLType.Q8_0: _dec_q8_0}
_PLAIN_DTYPES = {GGMLType.F32: np.dtype(np.float32),
                 GGMLType.F16: np.dtype(np.float16)}


def dequantize(data: bytes | np.ndarray, ggml_type: GGMLType, n_elems: int) -> np.ndarray:
    """Decode a flat GGML-typed buffer to float32 (F16 stays float16)."""
    raw = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    raw = raw.reshape(-1).view(np.uint8)
    if ggml_type in _PLAIN_DTYPES:
        dt = _PLAIN_DTYPES[ggml_type]
        return raw[: n_elems * dt.itemsize].view(dt)[:n_elems]
    if ggml_type == GGMLType.BF16:
        return _bf16_to_f32(raw[: n_elems * 2].view(np.uint16)[:n_elems])
    dec = _DECODERS.get(ggml_type)
    if dec is None:
        raise NotImplementedError(
            f"the port does not decode {ggml_type.name} yet (F32, F16, BF16, "
            "Q8_0 and Q4_0 only)")
    bs, tsz = GGML_TYPE_TRAITS[ggml_type]
    nb = n_elems // bs
    blocks = raw[: nb * tsz].reshape(nb, tsz)
    return dec(blocks).reshape(-1)[:n_elems]


def dequantize_tensor(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Decode to the given (row-major, numpy-order) shape."""
    n = int(np.prod(shape)) if shape else 1
    return dequantize(data, ggml_type, n).reshape(shape)


def _rdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    # a true division: torch on CUDA turns `t / python_scalar` into a
    # multiply by the reciprocal, which is not numpy's rounding
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _inv_f16(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f16 block scale and 1 / scale (0 where the scale is 0)."""
    d16 = d.to(torch.float16)
    dd = d16.float()
    inv = torch.where(dd != 0, 1.0 / torch.where(dd == 0, 1.0, dd), 0.0)
    return d16, inv


def _enc_q8_0(x: torch.Tensor) -> torch.Tensor:
    d16, inv = _inv_f16(_rdiv(x.abs().amax(dim=1), 127.0))
    q = torch.round(x * inv[:, None]).clamp_(-127, 127).to(torch.int8)
    return torch.cat([d16.view(torch.uint8).reshape(-1, 2), q.view(torch.uint8)], dim=1)


def _enc_q4_0(x: torch.Tensor) -> torch.Tensor:
    # scale by the max-|x| element, keeping its sign (d = that / -8)
    idx = x.abs().argmax(dim=1, keepdim=True)
    d16, inv = _inv_f16(_rdiv(torch.gather(x, 1, idx)[:, 0], -8.0))
    q = (x * inv[:, None] + 8.5).clamp_(0, 15).to(torch.uint8)
    qs = q[:, :16] | (q[:, 16:] << 4)
    return torch.cat([d16.view(torch.uint8).reshape(-1, 2), qs], dim=1)


_ENCODERS = {GGMLType.Q4_0: _enc_q4_0, GGMLType.Q8_0: _enc_q8_0}


def quantize(x: torch.Tensor, ggml_type: GGMLType) -> torch.Tensor:
    """Encode a float tensor (row-major, ggml's element order) to a flat
    uint8 tensor of ggml blocks on the same device. Q8_0 and Q4_0 only."""
    enc = _ENCODERS.get(ggml_type)
    if enc is None:
        raise NotImplementedError(
            f"the port does not encode {ggml_type.name} (Q8_0 and Q4_0 only)")
    bs, _ = GGML_TYPE_TRAITS[ggml_type]
    flat = x.reshape(-1).float()
    if flat.numel() % bs:
        raise ValueError(f"size {flat.numel()} not a multiple of {bs} for {ggml_type.name}")
    return enc(flat.reshape(-1, bs)).reshape(-1)
