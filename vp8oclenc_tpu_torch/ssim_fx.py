"""Integer (Q15 fixed-point) per-MB SSIM: the port's copy of the JAX
package's ssim_fx.py, on torch tensors.

Definition (per block pair X, Y of n pixels, n in {256, 64}):
  s1=ΣX, s2=ΣY, q1=ΣX², q2=ΣY², q12=ΣXY
  va=n·q1−s1², vb=n·q2−s2², cv=n·q12−s1·s2
  L-term  = (2·t1·t2+C1') / (t1²+t2²+C1'),  t=s>>p  (p=2 luma, 0 chroma)
  CS-term = (2·(cv>>1)+C2'>>1) / ((va>>1)+(vb>>1)+(C2'>>1))
  ssim_q15 = divq15(L) · divq15(CS) >> 15
  DC penalty: if |s1−s2| > 4n:  ssim_q15 −= (|s1−s2|·655) >> log2(n)
with C1'=round(6.5025·n²)>>2p, C2'=round(58.5225·n²) and divq15 a 15-step
restoring long division (exact floor(a·32768/d)).

n·q1 and s1² exceed int32 for 16x16 blocks (255² · 256² > 2^31) although
their difference fits.  The JAX package relies on int32 two's-complement
wrap for that; here va, vb and cv are computed exactly in int64 and cast
back to int32, so no step depends on signed overflow.  Everything else
stays inside int32.

Per-MB score = Y + U + V plane values (avg·3 in Q15, i.e. "1.0" = 98304).
UNCODED_FX marks MBs that no pass has coded yet.
"""
from __future__ import annotations

import math

import torch

Q1 = 32768                      # 1.0 for one plane
Q3 = 3 * Q1                     # 1.0 for the 3-plane MB score
UNCODED_FX = -2 * Q3            # below every real score
WEAKEN_FX = (95 * Q3) // 100    # minSSIM > 0.95 weakens the loop filter

_C1 = {n: int(round(6.5025 * n * n)) for n in (256, 64)}
_C2 = {n: int(round(58.5225 * n * n)) for n in (256, 64)}

_I32 = torch.int32
_I64 = torch.int64


def target_fx(ssim_target: float) -> int:
    """Config SSIM target (0..1 float) -> 3-plane Q15 threshold."""
    return int(math.floor(ssim_target * Q3))


def fx_to_float(fx) -> float:
    """3-plane Q15 MB score -> the conventional [0..1] SSIM average."""
    return float(fx) / Q3


def _divq15(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """floor(a * 32768 / d) for int32 tensors with 0 <= a <= d,
    1 <= d < 2^30 (so rem << 1 < 2^31)."""
    q = torch.zeros_like(a)
    rem = a
    for _ in range(15):
        rem = rem << 1
        ge = (rem >= d).to(a.dtype)
        rem = rem - ge * d
        q = (q << 1) | ge
    return q


def ssim_fx_blocks(sx: torch.Tensor, rx: torch.Tensor, n: int) -> torch.Tensor:
    """sx/rx: (..., n) source/recon pixel blocks -> (...,) int32 Q15."""
    sx = sx.to(_I64)
    rx = rx.to(_I64)
    s1 = sx.sum(dim=-1)
    s2 = rx.sum(dim=-1)
    va = (n * (sx * sx).sum(dim=-1) - s1 * s1).to(_I32)
    vb = (n * (rx * rx).sum(dim=-1) - s2 * s2).to(_I32)
    cv = (n * (sx * rx).sum(dim=-1) - s1 * s2).to(_I32)
    s1 = s1.to(_I32)
    s2 = s2.to(_I32)

    p = 2 if n == 256 else 0
    c1 = _C1[n] >> (2 * p)
    c2 = _C2[n]
    t1, t2 = s1 >> p, s2 >> p

    a1 = 2 * t1 * t2 + c1                      # 0 <= a1 <= d1 (2ab <= a²+b²)
    d1 = t1 * t1 + t2 * t2 + c1
    b1 = 2 * (cv >> 1) + (c2 >> 1)
    d2 = (va >> 1) + (vb >> 1) + (c2 >> 1)

    l_fx = _divq15(a1, d1)
    neg = b1 < 0
    b1a = torch.minimum(torch.where(neg, -b1, b1), d2)
    cs_fx = _divq15(b1a, d2)
    fx = (l_fx * cs_fx) >> 15
    fx = torch.where(neg, -fx, fx)

    ds = (s1 - s2).abs()
    log2n = 8 if n == 256 else 6
    pen = (ds * 655) >> log2n
    return (fx - torch.where(ds > 4 * n, pen, torch.zeros_like(pen))).to(_I32)


def _plane_mb_blocks(plane: torch.Tensor, size: int) -> torch.Tensor:
    H, W = plane.shape[-2], plane.shape[-1]
    b = plane.reshape(H // size, size, W // size, size).transpose(1, 2)
    return b.reshape((H // size) * (W // size), size * size)


def mb_ssim_fx(y, ry, u, ru, v, rv) -> torch.Tensor:
    """Per-MB 3-plane Q15 SSIM score: (mbc,) int32 ("1.0" = 98304)."""
    fy = ssim_fx_blocks(_plane_mb_blocks(y, 16), _plane_mb_blocks(ry, 16), 256)
    fu = ssim_fx_blocks(_plane_mb_blocks(u, 8), _plane_mb_blocks(ru, 8), 64)
    fv = ssim_fx_blocks(_plane_mb_blocks(v, 8), _plane_mb_blocks(rv, 8), 64)
    return fy + fu + fv


def mb_ssim_fx_16x16(sy, ry, su, ru, sv, rv) -> torch.Tensor:
    """Per-MB score on patches: (..., 16, 16) luma and (..., 8, 8) chroma
    source/recon pairs -> (...,) int32 Q15."""
    fy = ssim_fx_blocks(sy.flatten(-2), ry.flatten(-2), 256)
    fu = ssim_fx_blocks(su.flatten(-2), ru.flatten(-2), 64)
    fv = ssim_fx_blocks(sv.flatten(-2), rv.flatten(-2), 64)
    return fy + fu + fv
