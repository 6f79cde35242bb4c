"""Vectorized numpy VP8 transforms — the spec oracle of the port's kernels.

Forward DCT uses the reference's integer constants
(reference intra_part.h:114-157, GPU_kernels.cl:85-190); inverse
DCT/WHT are the normative RFC 6386 §14.3/§14.4 transforms
(reference intra_part.h:42-111, GPU_kernels.cl:192-401).
Quantization uses symmetric q/2 rounding everywhere (the reference rounds on
the host intra path only and truncates on the GPU inter path,
GPU_kernels.cl:1478 — either is stream-legal; rounding is higher quality, and
we deliberately do not reproduce the reference's quant4x4 sign bug at
intra_part.h:227).

All functions operate on arrays of shape (..., 4, 4) (row-major spatial /
coefficient layout) in int32.
"""
from __future__ import annotations

import numpy as np

from vp8oclenc_tpu_torch.tables import (COSPI8SQRT2MINUS1, INV_ZIGZAG,
                                        SINPI8SQRT2, ZIGZAG)


def fdct4x4(block: np.ndarray) -> np.ndarray:
    """Forward 4x4 DCT. block: (..., 4, 4) int residual -> (..., 4, 4) coeffs."""
    x = block.astype(np.int64)
    # pass 1: horizontal (within rows)
    a1 = (x[..., :, 0] + x[..., :, 3]) << 3
    b1 = (x[..., :, 1] + x[..., :, 2]) << 3
    c1 = (x[..., :, 1] - x[..., :, 2]) << 3
    d1 = (x[..., :, 0] - x[..., :, 3]) << 3
    t = np.empty_like(x)
    t[..., :, 0] = a1 + b1
    t[..., :, 2] = a1 - b1
    t[..., :, 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12
    t[..., :, 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12
    # pass 2: vertical (within columns)
    a1 = t[..., 0, :] + t[..., 3, :]
    b1 = t[..., 1, :] + t[..., 2, :]
    c1 = t[..., 1, :] - t[..., 2, :]
    d1 = t[..., 0, :] - t[..., 3, :]
    o = np.empty_like(x)
    o[..., 0, :] = (a1 + b1 + 7) >> 4
    o[..., 2, :] = (a1 - b1 + 7) >> 4
    o[..., 1, :] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
    o[..., 3, :] = (d1 * 2217 - c1 * 5352 + 51000) >> 16
    return o.astype(np.int32)


def quant4x4(coeffs: np.ndarray, dc_q, ac_q) -> np.ndarray:
    """Quantize with symmetric q/2 rounding, truncating toward zero.

    dc_q/ac_q broadcast against coeffs[..., 0, 0] / the rest.
    """
    c = coeffs.astype(np.int64)
    q = np.broadcast_to(np.asarray(ac_q)[..., None, None], c.shape).copy()
    q[..., 0, 0] = np.broadcast_to(np.asarray(dc_q), c[..., 0, 0].shape)
    a = c + np.where(c < 0, -(q // 2), q // 2)
    lev = np.where(a < 0, -((-a) // q), a // q)
    return lev.astype(np.int32)


def dequant4x4(levels: np.ndarray, dc_q, ac_q) -> np.ndarray:
    c = levels.astype(np.int64)
    q = np.broadcast_to(np.asarray(ac_q)[..., None, None], c.shape).copy()
    q[..., 0, 0] = np.broadcast_to(np.asarray(dc_q), c[..., 0, 0].shape)
    return (c * q).astype(np.int32)


def idct4x4(dq: np.ndarray) -> np.ndarray:
    """Inverse 4x4 DCT of *dequantized* coefficients -> spatial residual."""
    ip = dq.astype(np.int64)
    # pass 1: vertical (within columns)
    a1 = ip[..., 0, :] + ip[..., 2, :]
    b1 = ip[..., 0, :] - ip[..., 2, :]
    t1 = (ip[..., 1, :] * SINPI8SQRT2) >> 16
    t2 = ip[..., 3, :] + ((ip[..., 3, :] * COSPI8SQRT2MINUS1) >> 16)
    c1 = t1 - t2
    t1 = ip[..., 1, :] + ((ip[..., 1, :] * COSPI8SQRT2MINUS1) >> 16)
    t2 = (ip[..., 3, :] * SINPI8SQRT2) >> 16
    d1 = t1 + t2
    t = np.empty_like(ip)
    t[..., 0, :] = a1 + d1
    t[..., 3, :] = a1 - d1
    t[..., 1, :] = b1 + c1
    t[..., 2, :] = b1 - c1
    # pass 2: horizontal (within rows), with (x+4)>>3
    a1 = t[..., :, 0] + t[..., :, 2]
    b1 = t[..., :, 0] - t[..., :, 2]
    t1 = (t[..., :, 1] * SINPI8SQRT2) >> 16
    t2 = t[..., :, 3] + ((t[..., :, 3] * COSPI8SQRT2MINUS1) >> 16)
    c1 = t1 - t2
    t1 = t[..., :, 1] + ((t[..., :, 1] * COSPI8SQRT2MINUS1) >> 16)
    t2 = (t[..., :, 3] * SINPI8SQRT2) >> 16
    d1 = t1 + t2
    o = np.empty_like(ip)
    o[..., :, 0] = (a1 + d1 + 4) >> 3
    o[..., :, 3] = (a1 - d1 + 4) >> 3
    o[..., :, 1] = (b1 + c1 + 4) >> 3
    o[..., :, 2] = (b1 - c1 + 4) >> 3
    return o.astype(np.int32)


def fwht4x4(dcs: np.ndarray) -> np.ndarray:
    """Forward Walsh-Hadamard of the 4x4 grid of Y DC values, with the
    reference's (+1 if positive, >>1) normalization (GPU_kernels.cl:257-331).
    Output is the un-quantized Y2 coefficient block.
    """
    x = dcs.astype(np.int64)
    # vertical pass
    a = x[..., 0, :] + x[..., 3, :]
    b = x[..., 1, :] + x[..., 2, :]
    c = x[..., 1, :] - x[..., 2, :]
    d = x[..., 0, :] - x[..., 3, :]
    t = np.empty_like(x)
    t[..., 0, :] = a + b
    t[..., 1, :] = c + d
    t[..., 2, :] = a - b
    t[..., 3, :] = d - c
    # horizontal pass
    a = t[..., :, 0] + t[..., :, 3]
    b = t[..., :, 1] + t[..., :, 2]
    c = t[..., :, 1] - t[..., :, 2]
    d = t[..., :, 0] - t[..., :, 3]
    o = np.empty_like(x)
    o[..., :, 0] = a + b
    o[..., :, 1] = c + d
    o[..., :, 2] = a - b
    o[..., :, 3] = d - c
    o = (o + (o > 0)) >> 1
    return o.astype(np.int32)


def iwht4x4(dq: np.ndarray) -> np.ndarray:
    """Inverse WHT of *dequantized* Y2 coefficients -> 4x4 grid of Y DCs."""
    x = dq.astype(np.int64)
    # horizontal pass
    a = x[..., :, 0] + x[..., :, 3]
    b = x[..., :, 1] + x[..., :, 2]
    c = x[..., :, 1] - x[..., :, 2]
    d = x[..., :, 0] - x[..., :, 3]
    t = np.empty_like(x)
    t[..., :, 0] = a + b
    t[..., :, 1] = c + d
    t[..., :, 2] = a - b
    t[..., :, 3] = d - c
    # vertical pass
    a = t[..., 0, :] + t[..., 3, :]
    b = t[..., 1, :] + t[..., 2, :]
    c = t[..., 1, :] - t[..., 2, :]
    d = t[..., 0, :] - t[..., 3, :]
    o = np.empty_like(x)
    o[..., 0, :] = a + b
    o[..., 1, :] = c + d
    o[..., 2, :] = a - b
    o[..., 3, :] = d - c
    return ((o + 3) >> 3).astype(np.int32)


def zigzag(block: np.ndarray) -> np.ndarray:
    """(..., 4, 4) raster coeffs -> (..., 16) zigzag-scanned levels."""
    flat = block.reshape(*block.shape[:-2], 16)
    return flat[..., ZIGZAG]


def inv_zigzag(scan: np.ndarray) -> np.ndarray:
    """(..., 16) zigzag levels -> (..., 4, 4) raster coeffs."""
    return scan[..., INV_ZIGZAG].reshape(*scan.shape[:-1], 4, 4)


def dct_cost(quads16: np.ndarray) -> np.ndarray:
    """Normative ME/mode cost metric of this encoder (see tables.COST_M16):
    a linear integer DCT-domain SAD with DC de-weighted /4, same scale and
    role as the reference `weight()` (intra_part.h:159-210,
    GPU_kernels.cl:83-190) but exactly linear, so a device can evaluate
    it as a matrix product.  quads16: (..., 16) row-major 4x4 residuals."""
    from vp8oclenc_tpu_torch.tables import COST_M16, COST_SHIFT
    c = np.abs(quads16.astype(np.int64) @ COST_M16.T)
    s = 4 * c.sum(axis=-1) - 3 * c[..., 0]
    return (s >> COST_SHIFT).astype(np.int64)


def dct_weight(residual: np.ndarray) -> np.ndarray:
    """Cost of (..., 4, 4) spatial residuals via `dct_cost`."""
    return dct_cost(residual.reshape(*residual.shape[:-2], 16))


def dct_cost_rows64(rows64: np.ndarray) -> np.ndarray:
    """8x8-block ME cost from row-major (..., 64) residual rows: each 4x4
    quadrant's weighted |DCT| sum is shifted (>> COST_SHIFT) separately and
    the four quadrant costs added — exactly what the search kernels evaluate
    (ops/transforms.dct_cost_rows64) and what spec/motion.py scores per
    quadrant.  Numpy oracle for parity tests."""
    from vp8oclenc_tpu_torch.tables import COST_M16, COST_SHIFT
    lead = rows64.shape[:-1]
    q = rows64.reshape(*lead, 2, 4, 2, 4).transpose(
        *range(len(lead)), -4, -2, -3, -1).reshape(*lead, 4, 16)
    c = np.abs(q.astype(np.int64) @ COST_M16.T)
    s = 4 * c.sum(axis=-1) - 3 * c[..., 0]          # (..., 4) per-quad
    return ((s >> COST_SHIFT).sum(axis=-1)).astype(np.int64)
