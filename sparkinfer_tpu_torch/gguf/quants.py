"""Codecs for the GGML tensor types: the port of sparkinfer_tpu/gguf/quants.py.

Decode: F32/F16/BF16/F64/I8/I16/I32/I64, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0,
Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_K, IQ4_NL, IQ4_XS, IQ1_S, IQ1_M, IQ2_XXS,
IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, TQ1_0, TQ2_0, MXFP4 (ggml-quants.c's set).
Encode: F32/F16/BF16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K,
Q6_K, Q8_K, IQ4_NL, IQ4_XS; the Q4_K/Q5_K/Q6_K/IQ4 encoders run the
reference's error-weighted scale search (make_qx_quants /
make_qkx2_quants, ggml/src/ggml-quants.c) and take per-element importance
weights (an imatrix) as llama-quant.cpp passes them.

The numpy codecs are copies of the JAX package's, vectorized over blocks,
run on the host at load. The wire layouts match ggml's block structs
(ggml/src/ggml-common.h). Element order is ggml's: row-major over ne[0].

`quantize` is the one encoder entry point. Q8_0 and Q4_0 have one
encoder, written in torch: a tensor is encoded on its own device (seconds
for a 13B model's weights on the card), a numpy array on the host, byte
for byte as the JAX package's numpy encoder does. The other types go
through the numpy encoders, and a torch tensor comes back as a uint8
tensor on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import GGML_TYPE_TRAITS, GGMLType

# ---------------------------------------------------------------------------
# helpers


def _f16(buf: np.ndarray) -> np.ndarray:
    return buf.view(np.float16).astype(np.float32)


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8)


def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 (as uint16)."""
    u = x.astype(np.float32).view(np.uint32)
    rounding = ((u >> 16) & 1) + np.uint32(0x7FFF)
    return ((u + rounding) >> 16).astype(np.uint16)


# ---------------------------------------------------------------------------
# simple 32-element block formats


def _dec_q4_0(blocks: np.ndarray) -> np.ndarray:
    # block: [d:f16][qs:16]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))  # (nb, 1)
    qs = blocks[:, 2:18]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return out * d


def _dec_q4_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    m = _f16(blocks[:, 2:4].copy().view(np.uint16))
    qs = blocks[:, 4:20]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _enc_q4_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    d16 = d.astype(np.float16)
    m16 = mn.astype(np.float16)
    dd = d16.astype(np.float32)
    inv = np.where(dd != 0, 1.0 / np.where(dd == 0, 1, dd), 0.0)
    q = np.clip((x - m16.astype(np.float32)[:, None]) * inv[:, None] + 0.5, 0, 15).astype(np.uint8)
    qs = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    return np.concatenate(
        [d16.view(np.uint8).reshape(-1, 2), m16.view(np.uint8).reshape(-1, 2), qs], axis=1
    )


def _dec_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qh = blocks[:, 2:6].copy().view(np.uint32)  # (nb, 1)
    qs = blocks[:, 6:22]
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((qh >> shifts[None, :]) & 1).astype(np.uint8)  # (nb, 32)
    lo = (qs & 0x0F) | (bits[:, :16] << 4)
    hi = (qs >> 4) | (bits[:, 16:] << 4)
    out = np.concatenate([lo, hi], axis=1).astype(np.int16) - 16
    return out.astype(np.float32) * d


def _enc_q5_0(x: np.ndarray) -> np.ndarray:
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), idx]
    d = maxv / -16.0
    d16 = d.astype(np.float16)
    dd = d16.astype(np.float32)
    inv = np.where(dd != 0, 1.0 / np.where(dd == 0, 1, dd), 0.0)
    q = np.clip(x * inv[:, None] + 16.5, 0, 31).astype(np.uint8)
    qs = ((q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)).astype(np.uint8)
    bits = (q >> 4).astype(np.uint32)
    qh = (bits << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)
    return np.concatenate(
        [d16.view(np.uint8).reshape(-1, 2), qh.astype(np.uint32).view(np.uint8).reshape(-1, 4), qs],
        axis=1,
    )


def _dec_q5_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    m = _f16(blocks[:, 2:4].copy().view(np.uint16))
    qh = blocks[:, 4:8].copy().view(np.uint32)
    qs = blocks[:, 8:24]
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((qh >> shifts[None, :]) & 1).astype(np.uint8)
    lo = (qs & 0x0F) | (bits[:, :16] << 4)
    hi = (qs >> 4) | (bits[:, 16:] << 4)
    out = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return out * d + m


def _enc_q5_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    d16 = d.astype(np.float16)
    m16 = mn.astype(np.float16)
    dd = d16.astype(np.float32)
    inv = np.where(dd != 0, 1.0 / np.where(dd == 0, 1, dd), 0.0)
    q = np.clip((x - m16.astype(np.float32)[:, None]) * inv[:, None] + 0.5, 0, 31).astype(np.uint8)
    qs = ((q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)).astype(np.uint8)
    bits = (q >> 4).astype(np.uint32)
    qh = (bits << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)
    return np.concatenate(
        [
            d16.view(np.uint8).reshape(-1, 2),
            m16.view(np.uint8).reshape(-1, 2),
            qh.astype(np.uint32).view(np.uint8).reshape(-1, 4),
            qs,
        ],
        axis=1,
    )


def _dec_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return qs * d


# ---------------------------------------------------------------------------
# MXFP4 (32-elem block: 1-byte E8M0 scale + 16 bytes of e2m1 nibbles)

_MXFP4_TABLE = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], dtype=np.float32
)


def _e8m0_to_f32_half(e: np.ndarray) -> np.ndarray:
    # 2^(e-127) / 2, as a float32; e==0 -> 2^-128 (handled via exp2)
    return np.exp2(e.astype(np.float32) - 128.0)


def _dec_mxfp4(blocks: np.ndarray) -> np.ndarray:
    d = _e8m0_to_f32_half(blocks[:, 0:1])
    qs = blocks[:, 1:17]
    lo = _MXFP4_TABLE[qs & 0x0F]
    hi = _MXFP4_TABLE[qs >> 4]
    return np.concatenate([lo, hi], axis=1) * d


# ---------------------------------------------------------------------------
# K-quants (256-elem super-blocks)


def _unpack_kscales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min packing shared by Q4_K/Q5_K.

    Layout (ref: ggml-quants.c get_scale_min_k4): for sub-block j<4,
    sc=scales[j]&63, m=scales[j+4]&63; for j>=4, sc=(scales[j+4]&0xF)|
    ((scales[j-4]>>6)<<4), m=(scales[j+4]>>4)|((scales[j]>>6)<<4).
    Returns (sc, m) each (nb, 8) uint8.
    """
    s = scales
    sc = np.empty(s.shape[:-1] + (8,), dtype=np.uint8)
    mn = np.empty_like(sc)
    sc[..., :4] = s[..., :4] & 63
    mn[..., :4] = s[..., 4:8] & 63
    sc[..., 4:] = (s[..., 8:12] & 0x0F) | ((s[..., 0:4] >> 6) << 4)
    mn[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, mn


def _pack_kscales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_kscales. sc, mn: (nb, 8) uint8 in [0,63]."""
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    out[..., 0:4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (mn[..., :4] & 63) | ((mn[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0x0F) | ((mn[..., 4:] & 0x0F) << 4)
    return out


# ---------------------------------------------------------------------------
# weighted scale search (ref: ggml/src/ggml-quants.c make_qx_quants /
# make_qkx2_quants — the error-weighted codebook search the K-quant
# encoders use; vectorized over all groups, looped over the ~20 scale
# candidates so memory stays O(tensor), not O(tensor x candidates))


def _wsearch_symmetric(
    xs: np.ndarray, w: np.ndarray, nmax: int
) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric weighted-LS scale search (make_qx_quants, rmse_type=1).

    xs, w: (N, n) groups + per-element weights. Returns (scale (N,),
    L (N, n) int32 in [-nmax, nmax-1]). scale is the weighted
    least-squares optimum sum(w*x*l)/sum(w*l^2) for the best of 19
    candidate rounding grids iscale_k = -(nmax + 0.1*k)/max, k=-9..9.
    """
    N, n = xs.shape
    idx = np.argmax(np.abs(xs), axis=1)
    maxv = np.take_along_axis(xs, idx[:, None], 1)[:, 0]
    zero = np.abs(maxv) < 1e-30
    safe_max = np.where(zero, 1.0, maxv)
    best_scale = np.zeros(N, np.float64)
    best_score = np.full(N, -1.0, np.float64)
    best_L = np.zeros((N, n), np.int32)
    wx = w * xs
    for k in range(-9, 10):
        iscale = -(nmax + 0.1 * k) / safe_max
        L = np.clip(np.rint(iscale[:, None] * xs), -nmax, nmax - 1)
        sumlx = (wx * L).sum(1, dtype=np.float64)
        suml2 = (w * L * L).sum(1, dtype=np.float64)
        s2 = np.where(suml2 > 0, suml2, 1.0)
        score = np.where(suml2 > 0, sumlx * sumlx / s2, -1.0)
        upd = score > best_score
        best_score = np.where(upd, score, best_score)
        best_scale = np.where(upd, sumlx / s2, best_scale)
        best_L = np.where(upd[:, None], L.astype(np.int32), best_L)
    best_scale = np.where(zero, 0.0, best_scale)
    return best_scale.astype(np.float32), best_L


def _wsearch_affine(
    xs: np.ndarray, w: np.ndarray, nmax: int,
    rmin: float = -1.0, rdelta: float = 0.1, nstep: int = 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Affine weighted search (make_qkx2_quants): for each group find
    (scale, min) minimizing sum(w * (scale*l - min_eff - x)^2) over
    nstep+1 candidate rounding grids, solving the 2-var weighted
    regression in closed form per candidate.

    Returns (scale (N,), the_min (N,)) with the_min = -min >= 0 (the
    stored non-negative min convention of block_q4_K/q5_K).
    """
    N, n = xs.shape
    mn = np.minimum(xs.min(1), 0.0)
    mx = xs.max(1)
    degen = mx <= mn
    rng = np.where(degen, 1.0, mx - mn)
    sw = w.sum(1, dtype=np.float64)
    swx = (w * xs).sum(1, dtype=np.float64)
    # init grid: iscale = nmax/(max-min), plain affine
    L0 = np.clip(np.rint((nmax / rng)[:, None] * (xs - mn[:, None])), 0, nmax)
    scale0 = rng / nmax
    diff0 = scale0[:, None] * L0 + mn[:, None] - xs
    best_err = (w * diff0 * diff0).sum(1, dtype=np.float64)
    best_scale = scale0.astype(np.float64)
    best_min = mn.astype(np.float64)
    for step in range(nstep + 1):
        iscale = (rmin + rdelta * step + nmax) / rng
        L = np.clip(np.rint(iscale[:, None] * (xs - mn[:, None])), 0, nmax)
        sl = (w * L).sum(1, dtype=np.float64)
        sl2 = (w * L * L).sum(1, dtype=np.float64)
        sxl = (w * xs * L).sum(1, dtype=np.float64)
        D = sw * sl2 - sl * sl
        ok = D > 0
        Ds = np.where(ok, D, 1.0)
        sc = (sw * sxl - swx * sl) / Ds
        m = (sl2 * swx - sl * sxl) / Ds
        # a positive min is clamped to 0 and the scale re-solved 1-var
        pos = m > 0
        sl2s = np.where(sl2 > 0, sl2, 1.0)
        sc = np.where(pos, np.where(sl2 > 0, sxl / sl2s, sc), sc)
        m = np.where(pos, 0.0, m)
        diff = sc[:, None] * L + m[:, None] - xs
        err = (w * diff * diff).sum(1, dtype=np.float64)
        upd = ok & (err < best_err)
        best_err = np.where(upd, err, best_err)
        best_scale = np.where(upd, sc, best_scale)
        best_min = np.where(upd, m, best_min)
    best_scale = np.where(degen, 0.0, best_scale)
    best_min = np.where(degen, mn, best_min)
    return best_scale.astype(np.float32), (-best_min).astype(np.float32)


def _kquant_weights(
    xs: np.ndarray, qw: np.ndarray | None, default: str
) -> np.ndarray:
    """Per-element search weights over (nb, groups, n) sub-blocks.

    With an importance matrix (qw, same shape as xs): w = qw * sqrt(
    sigma2 + x^2) with sigma2 = 2*mean(x^2) per 256-superblock — the
    reference's imatrix weighting (llama-quant.cpp -> ggml-quants.c
    quantize_row_*_impl). Without: "absx" -> av_x + |x| (Q4_K/Q5_K),
    "x2" -> x^2 (Q6_K rmse_type=1).
    """
    nb = xs.shape[0]
    flat = xs.reshape(nb, -1)
    sigma2 = 2.0 * (flat * flat).mean(1)
    if qw is not None:
        w = qw * np.sqrt(sigma2[:, None, None] + xs * xs)
        return w + 1e-12  # dead-channel guard: keep sums positive
    if default == "absx":
        return np.sqrt(sigma2)[:, None, None] + np.abs(xs)
    return xs * xs + 1e-12


def _dec_q4_k(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
    sc, mn = _unpack_kscales(blocks[:, 4:16])
    qs = blocks[:, 16:144]  # (nb, 128)
    nb = blocks.shape[0]
    # chunk l in 0..3 covers elements 64l..64l+63 from bytes 32l..32l+31
    qs4 = qs.reshape(nb, 4, 32)
    lo = (qs4 & 0x0F).astype(np.float32)  # sub-block 2l
    hi = (qs4 >> 4).astype(np.float32)  # sub-block 2l+1
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32)
    scf = sc.astype(np.float32) * d  # (nb, 8)
    mnf = mn.astype(np.float32) * dmin
    return (q * scf[:, :, None] - mnf[:, :, None]).reshape(nb, 256)


def _enc_q45_k(x: np.ndarray, qw: np.ndarray | None, nmax: int):
    """Shared Q4_K/Q5_K search + 6-bit superscale pass: weighted affine
    search per 32-sub-block (make_qkx2_quants), then requantize against
    the f16/6-bit-quantized effective scales (quantize_row_q4_K_impl's
    second pass). Returns (d, dmin, sc, mn, q) with q in [0, nmax]."""
    nb = x.shape[0]
    xs = x.reshape(nb, 8, 32)
    w = _kquant_weights(xs, qw.reshape(nb, 8, 32) if qw is not None else None,
                        "absx")
    scale, the_min = _wsearch_affine(xs.reshape(-1, 32), w.reshape(-1, 32),
                                     nmax)
    scales = scale.reshape(nb, 8)
    mins = the_min.reshape(nb, 8)
    max_scale = scales.max(axis=1)
    max_min = mins.max(axis=1)
    d = (max_scale / 63.0).astype(np.float16)
    dmin = (max_min / 63.0).astype(np.float16)
    df = d.astype(np.float32)
    dminf = dmin.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    inv_m = np.where(dminf > 0, 1.0 / np.where(dminf == 0, 1, dminf), 0.0)
    sc = np.clip(np.rint(scales * inv_d[:, None]), 0, 63).astype(np.uint8)
    mn = np.clip(np.rint(mins * inv_m[:, None]), 0, 63).astype(np.uint8)
    eff_scale = df[:, None] * sc.astype(np.float32)  # (nb, 8)
    eff_min = dminf[:, None] * mn.astype(np.float32)
    inv_s = np.where(eff_scale > 0,
                     1.0 / np.where(eff_scale == 0, 1, eff_scale), 0.0)
    q = np.clip(np.rint((xs + eff_min[:, :, None]) * inv_s[:, :, None]),
                0, nmax).astype(np.uint8)
    return d, dmin, sc, mn, q


def _enc_q4_k(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q4_K encoder with the reference's weighted scale/min search
    (ggml-quants.c quantize_row_q4_K_impl); qw = optional per-element
    importance (imatrix column tiled over rows)."""
    nb = x.shape[0]
    d, dmin, sc, mn, q = _enc_q45_k(x, qw, 15)
    qp = q.reshape(nb, 4, 2, 32)
    qs = (qp[:, :, 0] | (qp[:, :, 1] << 4)).reshape(nb, 128).astype(np.uint8)
    return np.concatenate(
        [
            d.view(np.uint8).reshape(-1, 2),
            dmin.view(np.uint8).reshape(-1, 2),
            _pack_kscales(sc, mn),
            qs,
        ],
        axis=1,
    )


def _dec_q5_k(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    dmin = _f16(blocks[:, 2:4].copy().view(np.uint16))
    sc, mn = _unpack_kscales(blocks[:, 4:16])
    qh = blocks[:, 16:48]  # (nb, 32)
    qs = blocks[:, 48:176]  # (nb, 128)
    nb = blocks.shape[0]
    qs4 = qs.reshape(nb, 4, 32)
    lo = (qs4 & 0x0F).astype(np.uint8)
    hi = (qs4 >> 4).astype(np.uint8)
    # qh bit 2l gates sub-block 2l (lo), bit 2l+1 gates 2l+1 (hi)
    l_idx = np.arange(4, dtype=np.uint8)
    bit_lo = ((qh[:, None, :] >> (2 * l_idx)[None, :, None]) & 1).astype(np.uint8)
    bit_hi = ((qh[:, None, :] >> (2 * l_idx + 1)[None, :, None]) & 1).astype(np.uint8)
    lo = lo | (bit_lo << 4)
    hi = hi | (bit_hi << 4)
    q = np.stack([lo, hi], axis=2).reshape(nb, 8, 32).astype(np.float32)
    scf = sc.astype(np.float32) * d
    mnf = mn.astype(np.float32) * dmin
    return (q * scf[:, :, None] - mnf[:, :, None]).reshape(nb, 256)


def _dec_q2_k(blocks: np.ndarray) -> np.ndarray:
    """block_q2_K (ggml-common.h): scales[16] (4b sc | 4b min), qs[64]
    (2-bit), d f16, dmin f16. Element order per dequantize_row_q2_K: two
    128-halves; per half, shift j in {0,2,4,6} over the half's 32 qs
    bytes, split 16+16, one packed scale byte per 16 elems."""
    nb = blocks.shape[0]
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82].copy().view(np.uint16))  # (nb, 1)
    dmin = _f16(blocks[:, 82:84].copy().view(np.uint16))
    q2 = qs.reshape(nb, 2, 32)  # halves
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    q = (q2[:, :, None, :] >> shifts[None, None, :, None]) & 3  # (nb,2,4,32)
    q = q.reshape(nb, 2, 4, 2, 16).astype(np.float32)
    sc = (scales & 0x0F).reshape(nb, 2, 4, 2).astype(np.float32)
    mn = (scales >> 4).reshape(nb, 2, 4, 2).astype(np.float32)
    out = (d[:, :, None, None, None] * sc[..., None] * q
           - dmin[:, :, None, None, None] * mn[..., None])
    return out.reshape(nb, 256)


def _q3k_scales(sb: np.ndarray) -> np.ndarray:
    """12-byte Q3_K scale unpack -> (nb, 16) int16 in [-32, 31] (the
    kmask1/kmask2 aux shuffle of dequantize_row_q3_K, byte-wise)."""
    s0 = (sb[:, 0:4] & 0x0F) | ((sb[:, 8:12] & 3) << 4)
    s1 = (sb[:, 4:8] & 0x0F) | (((sb[:, 8:12] >> 2) & 3) << 4)
    s2 = (sb[:, 0:4] >> 4) | (((sb[:, 8:12] >> 4) & 3) << 4)
    s3 = (sb[:, 4:8] >> 4) | (((sb[:, 8:12] >> 6) & 3) << 4)
    return np.concatenate([s0, s1, s2, s3], axis=1).astype(np.int16) - 32


def _dec_q3_k(blocks: np.ndarray) -> np.ndarray:
    """block_q3_K: hmask[32] (high bit, CLEAR bit means subtract 4),
    qs[64] (2-bit), scales[12] (16 x 6-bit signed-32), d f16."""
    nb = blocks.shape[0]
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales = _q3k_scales(blocks[:, 96:108])  # (nb, 16)
    d = _f16(blocks[:, 108:110].copy().view(np.uint16))
    q2 = qs.reshape(nb, 2, 32)
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    q = ((q2[:, :, None, :] >> shifts[None, None, :, None]) & 3).astype(np.int16)
    # hmask bit index = 4*half + j, applied to all 32 bytes of the half's
    # elements (the hm pointer never advances across halves)
    bit = (np.arange(8, dtype=np.uint8)).reshape(2, 4)
    hb = (hmask[:, None, None, :] >> bit[None, :, :, None]) & 1  # (nb,2,4,32)
    q = q - np.where(hb == 0, 4, 0).astype(np.int16)
    q = q.reshape(nb, 2, 4, 2, 16).astype(np.float32)
    sc = scales.reshape(nb, 2, 4, 2).astype(np.float32)
    out = d[:, :, None, None, None] * sc[..., None] * q
    return out.reshape(nb, 256)


def _dec_q8_k(blocks: np.ndarray) -> np.ndarray:
    """block_q8_K: d f32, qs[256] int8, bsums[16] int16 (dot-product
    helper, ignored on dequant)."""
    d = blocks[:, 0:4].copy().view(np.float32)  # (nb, 1)
    qs = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return qs * d


def _enc_q8_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    amax = np.abs(x).max(axis=1)
    # ggml stores iscale = -127/max and d = 1/iscale (quantize_row_q8_K_ref
    # uses the max-|x| SIGNED value); match its math exactly
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(nb), idx]
    iscale = np.where(amax != 0, -127.0 / np.where(maxv == 0, 1, maxv), 0.0)
    q = np.clip(np.rint(x * iscale[:, None]), -128, 127).astype(np.int8)
    d = np.where(iscale != 0, 1.0 / np.where(iscale == 0, 1, iscale), 0.0)
    bsums = q.reshape(nb, 16, 16).astype(np.int32).sum(axis=2).astype(np.int16)
    return np.concatenate(
        [d.astype(np.float32).view(np.uint8).reshape(nb, 4),
         q.view(np.uint8), bsums.view(np.uint8).reshape(nb, 32)], axis=1)


def _enc_q5_k(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q5_K encoder with the reference's weighted scale/min search
    (quantize_row_q5_K_impl); layout per _dec_q5_k / block_q5_K."""
    nb = x.shape[0]
    d, dmin, sc, mn, q = _enc_q45_k(x, qw, 31)
    qpair = q.reshape(nb, 4, 2, 32)  # chunk l -> sub-blocks 2l (lo), 2l+1 (hi)
    qs = ((qpair[:, :, 0] & 0x0F) | ((qpair[:, :, 1] & 0x0F) << 4)).reshape(nb, 128)
    l_idx = np.arange(4, dtype=np.uint8)
    qh = (((qpair[:, :, 0] >> 4) << (2 * l_idx)[None, :, None])
          | ((qpair[:, :, 1] >> 4) << (2 * l_idx + 1)[None, :, None]))
    qh = qh.sum(axis=1, dtype=np.uint16).astype(np.uint8)  # (nb, 32)
    return np.concatenate(
        [d.view(np.uint8).reshape(-1, 2), dmin.view(np.uint8).reshape(-1, 2),
         _pack_kscales(sc, mn), qh, qs.astype(np.uint8)], axis=1)


def _enc_q2_k(x: np.ndarray) -> np.ndarray:
    """Simple (non-search) Q2_K encoder: per-16-elem affine 3-level grid
    with 4-bit packed scales/mins, layout per _dec_q2_k."""
    nb = x.shape[0]
    xs = x.reshape(nb, 16, 16)
    mins = np.minimum(xs.min(axis=2), 0.0)
    maxs = xs.max(axis=2)
    scales = (maxs - mins) / 3.0
    d = (scales.max(axis=1) / 15.0).astype(np.float16)
    dmin = ((-mins).max(axis=1) / 15.0).astype(np.float16)
    df = d.astype(np.float32)
    dminf = dmin.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    inv_m = np.where(dminf > 0, 1.0 / np.where(dminf == 0, 1, dminf), 0.0)
    sc = np.clip(np.rint(scales * inv_d[:, None]), 0, 15).astype(np.uint8)
    mn = np.clip(np.rint((-mins) * inv_m[:, None]), 0, 15).astype(np.uint8)
    eff_s = df[:, None] * sc.astype(np.float32)
    eff_m = dminf[:, None] * mn.astype(np.float32)
    inv_s = np.where(eff_s > 0, 1.0 / np.where(eff_s == 0, 1, eff_s), 0.0)
    q = np.clip(np.rint((xs + eff_m[:, :, None]) * inv_s[:, :, None]),
                0, 3).astype(np.uint8)
    # inverse of the decode order: (half, shift j, group g, l)
    q5 = q.reshape(nb, 2, 4, 2, 16)
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    qs = (q5.reshape(nb, 2, 4, 32) << shifts[None, None, :, None]).sum(
        axis=2, dtype=np.uint16).astype(np.uint8).reshape(nb, 64)
    packed_sc = (sc | (mn << 4)).astype(np.uint8)
    return np.concatenate(
        [packed_sc, qs, d.view(np.uint8).reshape(-1, 2),
         dmin.view(np.uint8).reshape(-1, 2)], axis=1)


def _pack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """Inverse of _q3k_scales: (nb, 16) int values in [-32, 31] -> 12
    bytes."""
    u = (sc + 32).astype(np.uint8)  # 6-bit
    s0, s1, s2, s3 = u[:, 0:4], u[:, 4:8], u[:, 8:12], u[:, 12:16]
    out = np.zeros((sc.shape[0], 12), np.uint8)
    out[:, 0:4] = (s0 & 0x0F) | ((s2 & 0x0F) << 4)
    out[:, 4:8] = (s1 & 0x0F) | ((s3 & 0x0F) << 4)
    out[:, 8:12] = ((s0 >> 4) | ((s1 >> 4) << 2)
                    | ((s2 >> 4) << 4) | ((s3 >> 4) << 6))
    return out


def _enc_q3_k(x: np.ndarray) -> np.ndarray:
    """Simple Q3_K encoder: per-16-elem signed 6-bit scale over the
    [-4, 3] grid, layout per _dec_q3_k."""
    nb = x.shape[0]
    xs = x.reshape(nb, 16, 16)
    idx = np.argmax(np.abs(xs), axis=2)
    maxv = np.take_along_axis(xs, idx[:, :, None], axis=2)[:, :, 0]
    f = maxv / -4.0  # (nb, 16)
    fmax = f[np.arange(nb), np.argmax(np.abs(f), axis=1)]
    d = (fmax / -32.0).astype(np.float16)
    df = d.astype(np.float32)
    inv_d = np.where(df != 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    sc = np.clip(np.rint(f * inv_d[:, None]), -32, 31).astype(np.int16)
    eff = df[:, None] * sc.astype(np.float32)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = np.clip(np.rint(xs * inv_s[:, :, None]), -4, 3).astype(np.int16) + 4
    q5 = q.reshape(nb, 2, 4, 2, 16).astype(np.uint8)  # stored 0..7
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    qs = ((q5 & 3).reshape(nb, 2, 4, 32)
          << shifts[None, None, :, None]).sum(
        axis=2, dtype=np.uint16).astype(np.uint8).reshape(nb, 64)
    bit = np.arange(8, dtype=np.uint8).reshape(2, 4)
    hm = ((q5 >> 2).reshape(nb, 2, 4, 32).astype(np.uint16)
          << bit[None, :, :, None]).sum(axis=(1, 2)).astype(np.uint8)
    return np.concatenate(
        [hm, qs, _pack_q3k_scales(sc), d.view(np.uint8).reshape(-1, 2)],
        axis=1)


# IQ4 non-linear 4-bit codebook (ggml-common.h kvalues_iq4nl — a format
# constant, identical by necessity)
_IQ4NL_TABLE = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32)


def _dec_iq4_nl(blocks: np.ndarray) -> np.ndarray:
    """block_iq4_nl (32 elems): d f16 + qs[16]; values via the non-linear
    kvalues_iq4nl codebook (low nibbles = elems 0..15, high = 16..31)."""
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs = blocks[:, 2:18]
    lo = _IQ4NL_TABLE[qs & 0x0F]
    hi = _IQ4NL_TABLE[qs >> 4]
    return np.concatenate([lo, hi], axis=1) * d


def _nearest_iq4(v: np.ndarray) -> np.ndarray:
    """Nearest codebook index for scaled values v (any shape)."""
    return np.abs(v[..., None] - _IQ4NL_TABLE).argmin(axis=-1).astype(np.uint8)


def _wsearch_iq4(xs: np.ndarray, w: np.ndarray):
    """Weighted scale search over the nonlinear iq4nl codebook (ref:
    quantize_row_iq4_nl_impl's ntry sweep): candidate inverse scales
    around the sign-matched codebook anchor, nearest-codebook rounding,
    weighted-LS scale refit per candidate, best by sumlx^2/suml2.

    Returns (scale (N,), q (N, n) uint8 codebook indices)."""
    N, n = xs.shape
    idx = np.argmax(np.abs(xs), axis=1)
    maxv = xs[np.arange(N), idx]
    zero = np.abs(maxv) < 1e-30
    safe = np.where(zero, 1.0, maxv)
    d0 = np.where(safe < 0, safe / -127.0, safe / 113.0)
    best_score = np.full(N, -1.0, np.float64)
    best_d = d0.astype(np.float64)
    best_q = np.zeros((N, n), np.uint8)
    wx = w * xs
    for k in range(-9, 10):
        d = d0 * (1.0 + 0.02 * k)
        inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
        q = _nearest_iq4(xs * inv[:, None])
        lv = _IQ4NL_TABLE[q]
        sumlx = (wx * lv).sum(1, dtype=np.float64)
        suml2 = (w * lv * lv).sum(1, dtype=np.float64)
        s2 = np.where(suml2 > 0, suml2, 1.0)
        score = np.where(suml2 > 0, sumlx * sumlx / s2, -1.0)
        upd = score > best_score
        best_score = np.where(upd, score, best_score)
        best_d = np.where(upd, sumlx / s2, best_d)
        best_q = np.where(upd[:, None], q, best_q)
    best_d = np.where(zero, 0.0, best_d)
    return best_d.astype(np.float32), best_q


def _enc_iq4_nl(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ4_NL encoder with the reference's weighted codebook-scale
    search (quantize_row_iq4_nl_impl); qw = optional imatrix weights."""
    nb = x.shape[0]
    w = _kquant_weights(x.reshape(nb, 1, 32),
                        qw.reshape(nb, 1, 32) if qw is not None else None,
                        "x2").reshape(nb, 32)
    d, q = _wsearch_iq4(x, w)
    d16 = d.astype(np.float16)
    # re-round against the f16-stored scale so decode sees consistent
    # indices
    dd = d16.astype(np.float32)
    inv = np.where(dd != 0, 1.0 / np.where(dd == 0, 1, dd), 0.0)
    q = _nearest_iq4(x * inv[:, None])
    qs = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    return np.concatenate([d16.view(np.uint8).reshape(-1, 2), qs], axis=1)


def _enc_iq4_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ4_XS encoder: per-32 sub-block 6-bit scale over the iq4nl
    codebook, with the reference's weighted scale search per sub-block
    (quantize_row_iq4_xs path); layout per _dec_iq4_xs."""
    nb = x.shape[0]
    xs = x.reshape(nb, 8, 32)
    w = _kquant_weights(xs, qw.reshape(nb, 8, 32) if qw is not None else None,
                        "x2")
    f, _ = _wsearch_iq4(xs.reshape(-1, 32), w.reshape(-1, 32))
    f = f.reshape(nb, 8)  # per-sub scale (weighted-LS, may be signed)
    fmax = np.abs(f).max(axis=1)
    d = (fmax / 31.0).astype(np.float16)  # ls-32 in [-32,31]; use 0..31
    df = d.astype(np.float32)
    inv_d = np.where(df > 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    ls = np.clip(np.rint(f * inv_d[:, None]) + 32, 0, 63).astype(np.uint8)
    eff = df[:, None] * (ls.astype(np.float32) - 32.0)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = _nearest_iq4(xs * inv_s[:, :, None])  # (nb, 8, 32)
    qs = (q[:, :, :16] | (q[:, :, 16:] << 4)).reshape(nb, 128).astype(np.uint8)
    ib = np.arange(8)
    sl = np.zeros((nb, 4), np.uint8)
    sl[:, :] = ((ls[:, 0::2] & 0x0F) | ((ls[:, 1::2] & 0x0F) << 4))
    sh = ((ls.astype(np.uint32) >> 4) << (2 * ib)[None, :]).sum(
        axis=1).astype(np.uint16)
    return np.concatenate(
        [d.view(np.uint8).reshape(-1, 2), sh.view(np.uint8).reshape(-1, 2),
         sl, qs], axis=1)


def _dec_iq4_xs(blocks: np.ndarray) -> np.ndarray:
    """block_iq4_xs (256): d f16, scales_h u16, scales_l[4], qs[128];
    8 sub-blocks of 32 with 6-bit scales (ls - 32) over the iq4nl
    codebook (dequantize_row_iq4_xs)."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))  # (nb, 1)
    sh = blocks[:, 2:4].copy().view(np.uint16).astype(np.uint32)  # (nb, 1)
    sl = blocks[:, 4:8]  # (nb, 4)
    qs = blocks[:, 8:136].reshape(nb, 8, 16)
    ib = np.arange(8)
    ls_l = (sl[:, ib // 2] >> (4 * (ib % 2))[None, :]) & 0x0F  # (nb, 8)
    ls_h = (sh >> (2 * ib)[None, :]) & 3
    ls = (ls_l | (ls_h << 4)).astype(np.float32) - 32.0
    dl = d * ls  # (nb, 8)
    lo = _IQ4NL_TABLE[qs & 0x0F]  # (nb, 8, 16)
    hi = _IQ4NL_TABLE[qs >> 4]
    vals = np.concatenate([lo, hi], axis=2)  # (nb, 8, 32)
    return (vals * dl[:, :, None]).reshape(nb, 256)


def _dec_tq1_0(blocks: np.ndarray) -> np.ndarray:
    """block_tq1_0 (256 elems, 54 bytes): ternary {-1,0,1} packed base-3^5
    per byte (qs[48]) + base-3^4 (qh[4]), d f16 last
    (ggml-common.h block_tq1_0; dequantize_row_tq1_0 pow3 ladder)."""
    nb = blocks.shape[0]
    qs = blocks[:, 0:48]
    qh = blocks[:, 48:52]
    d = _f16(blocks[:, 52:54].copy().view(np.uint16))
    pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)

    def tern(bytes_, npow):
        # digit j of byte b: ((b * pow3[j]) & 0xFF) * 3 >> 8, minus 1
        b = bytes_.astype(np.uint16)[..., None]  # (..., 1)
        xi = ((b * pow3[:npow]) & 0xFF) * 3 >> 8  # (..., npow)
        return xi.astype(np.float32) - 1.0

    # qs[0:32]: elems 0..159 (5 digits, stride 32); qs[32:48]: elems
    # 160..239 (5 digits, stride 16); qh: elems 240..255 (4 digits, stride 4)
    p1 = tern(qs[:, 0:32], 5).transpose(0, 2, 1).reshape(nb, 160)
    p2 = tern(qs[:, 32:48], 5).transpose(0, 2, 1).reshape(nb, 80)
    p3 = tern(qh, 4).transpose(0, 2, 1).reshape(nb, 16)
    return np.concatenate([p1, p2, p3], axis=1) * d


def _dec_tq2_0(blocks: np.ndarray) -> np.ndarray:
    """block_tq2_0 (256 elems, 66 bytes): 2-bit {-1,0,1} (qs[64]), d f16
    last; elem order: per 32-byte group, shift j in {0,2,4,6} over the
    group's bytes (dequantize_row_tq2_0)."""
    nb = blocks.shape[0]
    qs = blocks[:, 0:64].reshape(nb, 2, 32)
    d = _f16(blocks[:, 64:66].copy().view(np.uint16))
    shifts = np.arange(0, 8, 2, dtype=np.uint8)
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3  # (nb,2,4,32)
    return (q.reshape(nb, 256).astype(np.float32) - 1.0) * d


def _dec_q6_k(blocks: np.ndarray) -> np.ndarray:
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)  # (nb, 16)
    d = _f16(blocks[:, 208:210].copy().view(np.uint16))
    nb = blocks.shape[0]
    # two 128-element halves, each from ql[64], qh[32]
    ql2 = ql.reshape(nb, 2, 2, 32)  # [half][lo/hi group of 32 bytes]
    qh2 = qh.reshape(nb, 2, 32)
    q1 = (ql2[:, :, 0] & 0x0F) | ((qh2 & 0x03) << 4)  # elems l+0
    q2 = (ql2[:, :, 1] & 0x0F) | (((qh2 >> 2) & 0x03) << 4)  # elems l+32
    q3 = (ql2[:, :, 0] >> 4) | (((qh2 >> 4) & 0x03) << 4)  # elems l+64
    q4 = (ql2[:, :, 1] >> 4) | (((qh2 >> 6) & 0x03) << 4)  # elems l+96
    q = np.stack([q1, q2, q3, q4], axis=2).reshape(nb, 2, 4, 32).astype(np.int16) - 32
    # scale index: half h, quarter c (0..3), element l (0..31): is = 8h + 2c + l//16
    sc = scales.reshape(nb, 2, 8)  # per half: 8 scales
    l16 = np.arange(32) // 16  # (32,)
    c_idx = np.arange(4)
    sidx = (2 * c_idx[:, None] + l16[None, :]).astype(np.int64)  # (4, 32)
    scale_per_elem = sc[:, :, sidx]  # (nb, 2, 4, 32)
    out = q.astype(np.float32) * scale_per_elem
    return (out * d[:, None, None]).reshape(nb, 256)


def _enc_q6_k(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q6_K encoder with the reference's weighted scale search
    (quantize_row_q6_K_impl -> make_qx_quants, rmse_type=1); qw =
    optional per-element importance."""
    nb = x.shape[0]
    xs = x.reshape(nb, 16, 16)  # 16 sub-blocks of 16
    w = _kquant_weights(xs, qw.reshape(nb, 16, 16) if qw is not None else None,
                        "x2")
    f, _ = _wsearch_symmetric(xs.reshape(-1, 16), w.reshape(-1, 16), 32)
    f = f.reshape(nb, 16)  # per-sub signed scale (weighted-LS optimum)
    fmax_idx = np.argmax(np.abs(f), axis=1)
    fmax = f[np.arange(nb), fmax_idx]
    d = (fmax / -128.0).astype(np.float16)
    df = d.astype(np.float32)
    inv_d = np.where(df != 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    sc = np.clip(np.rint(f * inv_d[:, None]), -128, 127).astype(np.int8)
    eff = df[:, None] * sc.astype(np.float32)  # (nb, 16)
    inv_s = np.where(eff != 0, 1.0 / np.where(eff == 0, 1, eff), 0.0)
    q = np.clip(np.rint(xs * inv_s[:, :, None]) + 32, 0, 63).astype(np.uint8)  # (nb,16,16)
    q = q.reshape(nb, 2, 4, 32)  # [half][quarter q1..q4][l]
    # ql[l] = low4(q1) | low4(q3)<<4 ; ql[l+32] = low4(q2) | low4(q4)<<4
    ql = np.empty((nb, 2, 2, 32), dtype=np.uint8)
    ql[:, :, 0] = (q[:, :, 0] & 0x0F) | ((q[:, :, 2] & 0x0F) << 4)
    ql[:, :, 1] = (q[:, :, 1] & 0x0F) | ((q[:, :, 3] & 0x0F) << 4)
    # qh[l]: bits 0-1 = q1>>4, 2-3 = q2>>4, 4-5 = q3>>4, 6-7 = q4>>4
    qh = (
        ((q[:, :, 0] >> 4) & 0x03)
        | (((q[:, :, 1] >> 4) & 0x03) << 2)
        | (((q[:, :, 2] >> 4) & 0x03) << 4)
        | (((q[:, :, 3] >> 4) & 0x03) << 6)
    ).astype(np.uint8)
    return np.concatenate(
        [
            ql.reshape(nb, 128),
            qh.reshape(nb, 64),
            sc.view(np.uint8),
            d.view(np.uint8).reshape(-1, 2),
        ],
        axis=1,
    )


# ---------------------------------------------------------------------------
# importance-quantized (IQ) lattice formats — codebook grids in _iq_grids
# (wire-format constants; see that module's docstring). Block layouts per
# ggml-common.h block_iq2_xxs..block_iq1_m; reference dequant loops in
# ggml/src/ggml-quants.c. QK_K = 256 throughout.

from ._iq_grids import grid as _iq_grid  # noqa: E402


def _popcount8(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype(np.uint8).reshape(-1, 1), axis=1).sum(
        axis=1).reshape(x.shape).astype(np.uint8)


# IQ2/IQ3_XXS store signs as 7-bit codes; the 8th sign bit is the code's odd
# parity (ggml's ksigns_iq2xs table is exactly byte i = i | parity(i) << 7).
_KSIGNS = (np.arange(128, dtype=np.uint8)
           | (_popcount8(np.arange(128, dtype=np.uint8)) & 1) << 7)


def _sign_codes(codes: np.ndarray) -> np.ndarray:
    """7-bit sign codes (any shape) -> (..., 8) of ±1 float32."""
    return _byte_signs(_KSIGNS[codes])


def _byte_signs(byte: np.ndarray) -> np.ndarray:
    """Raw sign bytes (any shape) -> (..., 8) of ±1 float32 (bit set = -1)."""
    bits = (byte[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return 1.0 - 2.0 * bits.astype(np.float32)


def _nibbles(b: np.ndarray) -> np.ndarray:
    """(nb, k) bytes -> (nb, 2k) low-then-high 4-bit fields, float32."""
    nb = b.shape[0]
    return np.stack([b & 0x0F, b >> 4], axis=-1).reshape(nb, -1).astype(np.float32)


def _dec_iq2_xxs(blocks: np.ndarray) -> np.ndarray:
    """block_iq2_xxs: d f16 + 8x(2 u32) per 32 elems — u32#0 = 4 codebook
    bytes, u32#1 = 4x7-bit sign codes + 4-bit sub-scale in the top bits."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))  # (nb, 1)
    u = blocks[:, 2:66].copy().view(np.uint32).reshape(nb, 8, 2)
    gidx = ((u[:, :, 0, None] >> np.array([0, 8, 16, 24], np.uint32))
            & 0xFF).astype(np.int64)                      # (nb, 8, 4)
    scode = ((u[:, :, 1, None] >> np.array([0, 7, 14, 21], np.uint32))
             & 0x7F).astype(np.uint8)                     # (nb, 8, 4)
    sub = d * (0.5 + (u[:, :, 1] >> 28).astype(np.float32)) * 0.25  # (nb, 8)
    vals = _iq_grid("iq2xxs")[gidx].astype(np.float32)    # (nb, 8, 4, 8)
    return (sub[:, :, None, None] * vals * _sign_codes(scode)).reshape(nb, 256)


def _dec_iq2_xs(blocks: np.ndarray) -> np.ndarray:
    """block_iq2_xs: d f16 + 32 u16 (9-bit codebook index | 7-bit sign code)
    + 8 bytes of 4-bit sub-scales (one per 16 elems)."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs = blocks[:, 2:66].copy().view(np.uint16)           # (nb, 32)
    sub = d * (0.5 + _nibbles(blocks[:, 66:74])) * 0.25   # (nb, 16)
    vals = _iq_grid("iq2xs")[(qs & 511).astype(np.int64)].astype(np.float32)
    signed = vals * _sign_codes((qs >> 9).astype(np.uint8))  # (nb, 32, 8)
    return (sub[:, :, None, None] * signed.reshape(nb, 16, 2, 8)).reshape(nb, 256)


def _dec_iq2_s(blocks: np.ndarray) -> np.ndarray:
    """block_iq2_s: d f16 + 32 low-index bytes + 32 raw sign bytes + 8 qh
    bytes (2 index-extension bits per 8-elem group) + 8 sub-scale bytes."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs, signs_b = blocks[:, 2:34], blocks[:, 34:66]
    qh, sc = blocks[:, 66:74], blocks[:, 74:82]
    hi = ((qh[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3)
    idx = qs.astype(np.int64) | (hi.reshape(nb, 32).astype(np.int64) << 8)
    sub = d * (0.5 + _nibbles(sc)) * 0.25                 # (nb, 16)
    signed = _iq_grid("iq2s")[idx].astype(np.float32) * _byte_signs(signs_b)
    return (sub[:, :, None, None] * signed.reshape(nb, 16, 2, 8)).reshape(nb, 256)


def _dec_iq3_xxs(blocks: np.ndarray) -> np.ndarray:
    """block_iq3_xxs: d f16 + 64 codebook bytes (width-4 grid) + 8 u32 of
    4x7-bit sign codes + 4-bit sub-scale (one u32 per 32 elems)."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs = blocks[:, 2:66]
    sc = blocks[:, 66:98].copy().view(np.uint32)          # (nb, 8)
    sub = d * (0.5 + (sc >> 28).astype(np.float32)) * 0.5  # (nb, 8)
    scode = ((sc[:, :, None] >> np.array([0, 7, 14, 21], np.uint32))
             & 0x7F).astype(np.uint8)                     # (nb, 8, 4)
    vals = _iq_grid("iq3xxs")[qs.astype(np.int64)].reshape(nb, 8, 32)
    signs = _sign_codes(scode).reshape(nb, 8, 32)
    return (sub[:, :, None] * vals.astype(np.float32) * signs).reshape(nb, 256)


def _dec_iq3_s(blocks: np.ndarray) -> np.ndarray:
    """block_iq3_s: d f16 + 64 low-index bytes + 8 qh bytes (1 extension bit
    per codebook byte) + 32 raw sign bytes + 4 sub-scale bytes (nibble per
    32 elems); sub-scale formula d * (1 + 2*s)."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs, qh = blocks[:, 2:66], blocks[:, 66:74]
    signs_b, sc = blocks[:, 74:106], blocks[:, 106:110]
    hi = ((qh[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1).reshape(nb, 64)
    idx = qs.astype(np.int64) | (hi.astype(np.int64) << 8)
    sub = d * (1.0 + 2.0 * _nibbles(sc))                  # (nb, 8)
    vals = _iq_grid("iq3s")[idx].reshape(nb, 8, 32).astype(np.float32)
    signs = _byte_signs(signs_b).reshape(nb, 8, 32)
    return (sub[:, :, None] * vals * signs).reshape(nb, 256)


def _dec_iq1_s(blocks: np.ndarray) -> np.ndarray:
    """block_iq1_s: d f16 + 32 low-index bytes + 8 u16 qh — per 32 elems:
    4x3 index-extension bits, 3-bit sub-scale, 1 block-delta sign bit.
    Values are dl * (grid ± 0.125) with grid entries in {-1, 0, 1}."""
    nb = blocks.shape[0]
    d = _f16(blocks[:, 0:2].copy().view(np.uint16))
    qs = blocks[:, 2:34].reshape(nb, 8, 4)
    qh = blocks[:, 34:50].copy().view(np.uint16)          # (nb, 8)
    hi = ((qh[:, :, None] >> np.array([0, 3, 6, 9], np.uint16)) & 7)
    idx = qs.astype(np.int64) | (hi.astype(np.int64) << 8)
    dl = d * (2.0 * ((qh >> 12) & 7).astype(np.float32) + 1.0)  # (nb, 8)
    delta = np.where((qh & 0x8000) != 0, np.float32(-0.125), np.float32(0.125))
    vals = _iq_grid("iq1")[idx].astype(np.float32)        # (nb, 8, 4, 8)
    return (dl[:, :, None, None]
            * (vals + delta[:, :, None, None])).reshape(nb, 256)


def _dec_iq1_m(blocks: np.ndarray) -> np.ndarray:
    """block_iq1_m: 32 low-index bytes + 16 qh bytes (per 8 elems: nibble =
    3 index-extension bits + delta sign) + 4 u16 scales. The f16 block scale
    rides the TOP nibble of each scale u16; 16 3-bit sub-scales (one per 16
    elems) ride bits [0,3),[3,6),[6,9) of each."""
    nb = blocks.shape[0]
    qs, qh = blocks[:, 0:32], blocks[:, 32:48]
    sc = blocks[:, 48:56].copy().view(np.uint16)          # (nb, 4)
    dparts = (sc & np.uint16(0xF000)) >> np.array([12, 8, 4, 0], np.uint16)
    d = (dparts[:, 0] | dparts[:, 1] | dparts[:, 2] | dparts[:, 3]).astype(
        np.uint16).view(np.float16).astype(np.float32)[:, None]  # (nb, 1)
    sub = ((sc[:, :, None] >> np.array([0, 3, 6, 9], np.uint16)) & 7
           ).reshape(nb, 16).astype(np.float32)
    dl = d * (2.0 * sub + 1.0)                            # (nb, 16)
    qhn = np.stack([qh & 0x0F, qh >> 4], axis=-1).reshape(nb, 32)
    idx = qs.astype(np.int64) | ((qhn & 7).astype(np.int64) << 8)
    delta = np.where((qhn & 8) != 0, np.float32(-0.125), np.float32(0.125))
    vals = _iq_grid("iq1")[idx].astype(np.float32) + delta[:, :, None]
    return (dl[:, :, None] * vals.reshape(nb, 16, 16)).reshape(nb, 256)


# ---------------------------------------------------------------------------
# public API

_DECODERS = {
    GGMLType.Q4_0: _dec_q4_0,
    GGMLType.Q4_1: _dec_q4_1,
    GGMLType.Q5_0: _dec_q5_0,
    GGMLType.Q5_1: _dec_q5_1,
    GGMLType.Q8_0: _dec_q8_0,
    GGMLType.Q2_K: _dec_q2_k,
    GGMLType.Q3_K: _dec_q3_k,
    GGMLType.Q4_K: _dec_q4_k,
    GGMLType.Q5_K: _dec_q5_k,
    GGMLType.Q6_K: _dec_q6_k,
    GGMLType.Q8_K: _dec_q8_k,
    GGMLType.IQ4_NL: _dec_iq4_nl,
    GGMLType.IQ4_XS: _dec_iq4_xs,
    GGMLType.IQ2_XXS: _dec_iq2_xxs,
    GGMLType.IQ2_XS: _dec_iq2_xs,
    GGMLType.IQ2_S: _dec_iq2_s,
    GGMLType.IQ3_XXS: _dec_iq3_xxs,
    GGMLType.IQ3_S: _dec_iq3_s,
    GGMLType.IQ1_S: _dec_iq1_s,
    GGMLType.IQ1_M: _dec_iq1_m,
    GGMLType.TQ1_0: _dec_tq1_0,
    GGMLType.TQ2_0: _dec_tq2_0,
    GGMLType.MXFP4: _dec_mxfp4,
}

_ENCODERS = {
    GGMLType.Q4_1: _enc_q4_1,
    GGMLType.Q5_0: _enc_q5_0,
    GGMLType.Q5_1: _enc_q5_1,
    GGMLType.Q2_K: _enc_q2_k,
    GGMLType.Q3_K: _enc_q3_k,
    GGMLType.Q4_K: _enc_q4_k,
    GGMLType.Q5_K: _enc_q5_k,
    GGMLType.Q6_K: _enc_q6_k,
    GGMLType.Q8_K: _enc_q8_k,
    GGMLType.IQ4_NL: _enc_iq4_nl,
    GGMLType.IQ4_XS: _enc_iq4_xs,
}

_PLAIN_DTYPES = {
    GGMLType.F32: np.dtype(np.float32),
    GGMLType.F16: np.dtype(np.float16),
    GGMLType.F64: np.dtype(np.float64),
    GGMLType.I8: np.dtype(np.int8),
    GGMLType.I16: np.dtype(np.int16),
    GGMLType.I32: np.dtype(np.int32),
    GGMLType.I64: np.dtype(np.int64),
}


def dequantize(data: bytes | np.ndarray, ggml_type: GGMLType, n_elems: int) -> np.ndarray:
    """Decode a flat GGML-typed buffer to float32 (or native int dtype)."""
    raw = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    raw = raw.reshape(-1).view(np.uint8)
    if ggml_type in _PLAIN_DTYPES:
        dt = _PLAIN_DTYPES[ggml_type]
        return raw[: n_elems * dt.itemsize].view(dt)[:n_elems]
    if ggml_type == GGMLType.BF16:
        return _bf16_to_f32(raw[: n_elems * 2].view(np.uint16)[:n_elems])
    bs, tsz = GGML_TYPE_TRAITS[ggml_type]
    nb = n_elems // bs
    blocks = raw[: nb * tsz].reshape(nb, tsz)
    dec = _DECODERS.get(ggml_type)
    if dec is None:
        raise NotImplementedError(f"no decoder for {ggml_type.name}")
    return dec(blocks).reshape(-1)[:n_elems]


# encoders that take an importance-weight array (imatrix consumers)
_QW_TYPES = {GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
             GGMLType.IQ4_NL, GGMLType.IQ4_XS}


def dequantize_tensor(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Decode to the given (row-major, numpy-order) shape."""
    n = int(np.prod(shape)) if shape else 1
    return dequantize(data, ggml_type, n).reshape(shape)


# ---------------------------------------------------------------------------
# Q8_0 / Q4_0 in torch, on the tensor's device


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


def _enc_q8_0_torch(x: torch.Tensor) -> torch.Tensor:
    d16, inv = _inv_f16(_rdiv(x.abs().amax(dim=1), 127.0))
    q = torch.round(x * inv[:, None]).clamp_(-127, 127).to(torch.int8)
    return torch.cat([d16.view(torch.uint8).reshape(-1, 2), q.view(torch.uint8)], dim=1)


def _enc_q4_0_torch(x: torch.Tensor) -> torch.Tensor:
    # scale by the max-|x| element, keeping its sign (d = that / -8)
    idx = x.abs().argmax(dim=1, keepdim=True)
    d16, inv = _inv_f16(_rdiv(torch.gather(x, 1, idx)[:, 0], -8.0))
    q = (x * inv[:, None] + 8.5).clamp_(0, 15).to(torch.uint8)
    qs = q[:, :16] | (q[:, 16:] << 4)
    return torch.cat([d16.view(torch.uint8).reshape(-1, 2), qs], dim=1)


_TORCH_ENCODERS = {GGMLType.Q4_0: _enc_q4_0_torch, GGMLType.Q8_0: _enc_q8_0_torch}


def _quantize_np(
    x: np.ndarray, ggml_type: GGMLType, qw: np.ndarray | None = None
) -> np.ndarray:
    """Encode a float array to a flat GGML-typed uint8 buffer.

    qw: optional per-element importance weights (same element count as
    x; e.g. an imatrix column vector tiled over the tensor's rows).
    Consumed by the weighted-search K-quant encoders (ref:
    src/llama-quant.cpp:599+ passing the imatrix into
    quantize_row_*_impl); ignored by types without a weighted encoder.
    """
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if ggml_type == GGMLType.F32:
        return flat.view(np.uint8)
    if ggml_type == GGMLType.F16:
        return flat.astype(np.float16).view(np.uint8)
    if ggml_type == GGMLType.BF16:
        return _f32_to_bf16(flat).view(np.uint8)
    bs, _ = GGML_TYPE_TRAITS[ggml_type]
    if flat.size % bs != 0:
        raise ValueError(f"size {flat.size} not a multiple of {bs} for {ggml_type.name}")
    if ggml_type in _TORCH_ENCODERS:
        # Q8_0 / Q4_0 have one encoder, the torch one, here on the host
        blocks = torch.from_numpy(flat if flat.flags.writeable else flat.copy())
        return _TORCH_ENCODERS[ggml_type](blocks.reshape(-1, bs)).reshape(-1).numpy()
    enc = _ENCODERS.get(ggml_type)
    if enc is None:
        raise NotImplementedError(f"no encoder for {ggml_type.name}")
    if qw is not None and ggml_type in _QW_TYPES:
        qwf = np.ascontiguousarray(qw, dtype=np.float32).reshape(-1)
        if qwf.size != flat.size:
            raise ValueError(f"qw size {qwf.size} != x size {flat.size}")
        return enc(flat.reshape(-1, bs), qw=qwf.reshape(-1, bs)).reshape(-1)
    return enc(flat.reshape(-1, bs)).reshape(-1)


def quantize(x, ggml_type: GGMLType, qw=None):
    """Encode a float array or tensor (row-major, ggml's element order) to
    a flat uint8 buffer of ggml blocks: numpy in, numpy out; a torch tensor
    in, a uint8 tensor on its device out. qw: optional per-element
    importance weights, read by the encoders of `_QW_TYPES` and ignored by
    the others."""
    if not isinstance(x, torch.Tensor):
        return _quantize_np(x, ggml_type, qw)
    enc = _TORCH_ENCODERS.get(ggml_type)
    if enc is None:
        q = None if qw is None else np.asarray(torch.as_tensor(qw).float().cpu())
        out = _quantize_np(x.detach().float().cpu().numpy(), ggml_type, q)
        return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)
    bs, _ = GGML_TYPE_TRAITS[ggml_type]
    flat = x.reshape(-1).float()
    if flat.numel() % bs:
        raise ValueError(f"size {flat.numel()} not a multiple of {bs} for {ggml_type.name}")
    return enc(flat.reshape(-1, bs)).reshape(-1)


def supported_decode_types() -> list[GGMLType]:
    return sorted(set(_DECODERS) | set(_PLAIN_DTYPES) | {GGMLType.BF16})


def supported_encode_types() -> list[GGMLType]:
    return sorted(set(_ENCODERS) | set(_TORCH_ENCODERS)
                  | {GGMLType.F32, GGMLType.F16, GGMLType.BF16})
