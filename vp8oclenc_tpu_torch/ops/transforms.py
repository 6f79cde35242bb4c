"""PyTorch VP8 transforms: integer-exact int32 counterparts of the JAX
package's ops/transforms.py.

Every function takes and returns int32 tensors of shape (..., 4, 4) (or
(..., 16) for the zigzag scan) on any device.  Right shifts on negative
int32 are arithmetic in PyTorch, as the VP8 transforms require.  The mode
cost `dct_weight` is evaluated as the exact separable integer product
|C4 . X . C4^T| (tables.COST_M16 = kron(COST_C, COST_C)), never in float.
"""
from __future__ import annotations

import torch

from vp8oclenc_tpu_torch.tables import (COSPI8SQRT2MINUS1, COST_SHIFT,
                                        SINPI8SQRT2, ZIGZAG)

_I32 = torch.int32


def fdct4x4(block: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 DCT: (..., 4, 4) residual -> (..., 4, 4) coefficients."""
    x = block.to(_I32)
    a1 = (x[..., :, 0] + x[..., :, 3]) << 3
    b1 = (x[..., :, 1] + x[..., :, 2]) << 3
    c1 = (x[..., :, 1] - x[..., :, 2]) << 3
    d1 = (x[..., :, 0] - x[..., :, 3]) << 3
    t = torch.stack([a1 + b1,
                     (c1 * 2217 + d1 * 5352 + 14500) >> 12,
                     a1 - b1,
                     (d1 * 2217 - c1 * 5352 + 7500) >> 12], dim=-1)
    a1 = t[..., 0, :] + t[..., 3, :]
    b1 = t[..., 1, :] + t[..., 2, :]
    c1 = t[..., 1, :] - t[..., 2, :]
    d1 = t[..., 0, :] - t[..., 3, :]
    return torch.stack([(a1 + b1 + 7) >> 4,
                        ((c1 * 2217 + d1 * 5352 + 12000) >> 16)
                        + (d1 != 0).to(_I32),
                        (a1 - b1 + 7) >> 4,
                        (d1 * 2217 - c1 * 5352 + 51000) >> 16], dim=-2)


_CONSTS: dict = {}


def device_const(arr, dtype, device) -> torch.Tensor:
    """A module-level host table as a tensor on `device`, copied there once.
    A copy from pageable host memory synchronizes the CUDA stream, so the
    device path must not make one per call."""
    key = (id(arr), dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return t


def _q_grid(c: torch.Tensor, dc_q, ac_q) -> torch.Tensor:
    """Per-coefficient quantizer: dc_q at [0, 0], ac_q elsewhere.  dc_q and
    ac_q are Python ints or int tensors that broadcast against
    c.shape[:-2] (per-block quantizers, e.g. (mbc, 1) against
    (mbc, 16, 4, 4)); ints stay kernel arguments, never device copies."""
    q = lambda v: v.to(_I32)[..., None, None] \
        if isinstance(v, torch.Tensor) else int(v)
    is_dc = torch.arange(16, device=c.device).reshape(4, 4) == 0
    return torch.where(is_dc, q(dc_q), q(ac_q)).to(_I32).expand(c.shape)


def quant4x4(coeffs: torch.Tensor, dc_q, ac_q) -> torch.Tensor:
    """Symmetric q/2 rounding, truncating toward zero.  Only non-negative
    values are divided (the sign is split off first), so floor and
    truncating division agree."""
    c = coeffs.to(_I32)
    q = _q_grid(c, dc_q, ac_q)
    a = c + torch.where(c < 0, -(q // 2), q // 2)
    return torch.where(a < 0, -((-a) // q), a // q)


def dequant4x4(levels: torch.Tensor, dc_q, ac_q) -> torch.Tensor:
    c = levels.to(_I32)
    return c * _q_grid(c, dc_q, ac_q)


def idct4x4(dq: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 DCT of dequantized coefficients -> spatial residual."""
    ip = dq.to(_I32)
    a1 = ip[..., 0, :] + ip[..., 2, :]
    b1 = ip[..., 0, :] - ip[..., 2, :]
    c1 = ((ip[..., 1, :] * SINPI8SQRT2) >> 16) \
        - (ip[..., 3, :] + ((ip[..., 3, :] * COSPI8SQRT2MINUS1) >> 16))
    d1 = (ip[..., 1, :] + ((ip[..., 1, :] * COSPI8SQRT2MINUS1) >> 16)) \
        + ((ip[..., 3, :] * SINPI8SQRT2) >> 16)
    t = torch.stack([a1 + d1, b1 + c1, b1 - c1, a1 - d1], dim=-2)
    a1 = t[..., :, 0] + t[..., :, 2]
    b1 = t[..., :, 0] - t[..., :, 2]
    c1 = ((t[..., :, 1] * SINPI8SQRT2) >> 16) \
        - (t[..., :, 3] + ((t[..., :, 3] * COSPI8SQRT2MINUS1) >> 16))
    d1 = (t[..., :, 1] + ((t[..., :, 1] * COSPI8SQRT2MINUS1) >> 16)) \
        + ((t[..., :, 3] * SINPI8SQRT2) >> 16)
    return torch.stack([(a1 + d1 + 4) >> 3,
                        (b1 + c1 + 4) >> 3,
                        (b1 - c1 + 4) >> 3,
                        (a1 - d1 + 4) >> 3], dim=-1)


def fwht4x4(dcs: torch.Tensor) -> torch.Tensor:
    """Forward Walsh-Hadamard transform of (..., 4, 4) luma DCs (Y2)."""
    x = dcs.to(_I32)
    a = x[..., 0, :] + x[..., 3, :]
    b = x[..., 1, :] + x[..., 2, :]
    c = x[..., 1, :] - x[..., 2, :]
    d = x[..., 0, :] - x[..., 3, :]
    t = torch.stack([a + b, c + d, a - b, d - c], dim=-2)
    a = t[..., :, 0] + t[..., :, 3]
    b = t[..., :, 1] + t[..., :, 2]
    c = t[..., :, 1] - t[..., :, 2]
    d = t[..., :, 0] - t[..., :, 3]
    o = torch.stack([a + b, c + d, a - b, d - c], dim=-1)
    return (o + (o > 0).to(_I32)) >> 1


def iwht4x4(dq: torch.Tensor) -> torch.Tensor:
    """Inverse Walsh-Hadamard transform of dequantized Y2 coefficients."""
    x = dq.to(_I32)
    a = x[..., :, 0] + x[..., :, 3]
    b = x[..., :, 1] + x[..., :, 2]
    c = x[..., :, 1] - x[..., :, 2]
    d = x[..., :, 0] - x[..., :, 3]
    t = torch.stack([a + b, c + d, a - b, d - c], dim=-1)
    a = t[..., 0, :] + t[..., 3, :]
    b = t[..., 1, :] + t[..., 2, :]
    c = t[..., 1, :] - t[..., 2, :]
    d = t[..., 0, :] - t[..., 3, :]
    o = torch.stack([a + b, c + d, a - b, d - c], dim=-2)
    return (o + 3) >> 3


def zigzag(block: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) raster coefficients -> (..., 16) zigzag scan."""
    flat = block.reshape(*block.shape[:-2], 16)
    return flat[..., device_const(ZIGZAG, torch.long, block.device)]


def _cost_c4(x0, x1, x2, x3):
    """The four rows of tables.COST_C applied to (x0, x1, x2, x3)."""
    s03, d03, s12, d12 = x0 + x3, x0 - x3, x1 + x2, x1 - x2
    return (8 * (s03 + s12), 10 * d03 + 4 * d12, 8 * (s03 - s12),
            4 * d03 - 10 * d12)


def dct_weight(residual: torch.Tensor) -> torch.Tensor:
    """Mode cost of (..., 4, 4) residuals -> (...,) int32:
    (|c_dc| + 4 * sum|c_ac|) >> COST_SHIFT with c = C4 . X . C4^T, the
    exact separable form of tables.COST_M16 (|c| < 2^18, the weighted sum
    < 2^25, so int32 never overflows).  Written as butterflies on the rows
    and columns, so no intermediate is larger than the input."""
    x = residual.to(_I32)
    cx = _cost_c4(*(x[..., k, :] for k in range(4)))       # rows of C . X
    s = 0
    for i, row in enumerate(cx):
        for j, c in enumerate(_cost_c4(*(row[..., l] for l in range(4)))):
            s = s + c.abs() * (1 if i == j == 0 else 4)
    return s >> COST_SHIFT


def dct_cost_8x8(residual: torch.Tensor) -> torch.Tensor:
    """Motion-search cost of (..., 8, 8) residuals -> (...,) int32: the sum
    of the four 4x4 quadrants' `dct_weight`, each shifted >> COST_SHIFT
    before the sum (the contract of the JAX package's dct_cost_rows64)."""
    q = residual.reshape(*residual.shape[:-2], 2, 4, 2, 4).transpose(-3, -2)
    return dct_weight(q).sum(dim=(-2, -1), dtype=_I32)
