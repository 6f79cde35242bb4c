"""Integer (Q15 fixed-point) per-MB SSIM in numpy: the spec backend's copy
of the JAX package's ssim_fx.py, in its formulation.

The reference scores quality with float SSIM (count_SSIM_luma/chroma,
reference GPU_kernels.cl:1610-2095) and pays for it with
platform-dependent output (README.md:20-21: linux32 vs linux64 streams
diverge because x87 and SSE2 round differently).  The integer formulation
makes every SSIM-driven decision (progressive segment requantization, intra
replacement, forced keyframes, filter weakening) bit-identical between this
oracle and the torch path (vp8oclenc_tpu_torch/ssim_fx.py), which computes
the same scores on tensors: no float op whose rounding a compiler could
change is used.  Here n·q1 − s1² relies on int32 two's-complement wrap, as
in the JAX package; the torch copy takes that term in int64 instead.

Definition (per block pair X, Y of n pixels, n in {256, 64}):
  s1=ΣX, s2=ΣY, q1=ΣX², q2=ΣY², q12=ΣXY                  (exact int32)
  va=n·q1−s1², vb=n·q2−s2², cv=n·q12−s1·s2               (exact via two's-
                                                          complement wrap)
  L-term  = (2·t1·t2+C1') / (t1²+t2²+C1'),  t=s>>p  (p=2 luma, 0 chroma)
  CS-term = (2·(cv>>1)+C2'>>1) / ((va>>1)+(vb>>1)+(C2'>>1))
  ssim_q15 = divq15(L) · divq15(CS) >> 15
  DC penalty: if |s1−s2| > 4n:  ssim_q15 −= (|s1−s2|·655) >> log2(n)
with C1'=round(6.5025·n²)>>2p, C2'=round(58.5225·n²) (SSIM standard
constants, matching SSIM_C1/C2 of the reference kernels), and divq15 a
15-step restoring long division (exact floor(a·32768/d)).

Per-MB score = Y + U + V plane values (avg·3 in Q15, i.e. "1.0" = 98304).
UNCODED_FX marks not-yet-coded MBs (the reference's MB_SSIM = -2).
"""
from __future__ import annotations

import numpy as np

Q1 = 32768                      # 1.0 for one plane
Q3 = 3 * Q1                     # 1.0 for the 3-plane MB score
UNCODED_FX = -2 * Q3            # reference inits MB_SSIM to -2
WEAKEN_FX = (95 * Q3) // 100    # minSSIM > 0.95 weakens the loop filter
                                # (reference check_SSIM, vp8enc.cpp:260-261)

_C1 = {n: int(round(6.5025 * n * n)) for n in (256, 64)}
_C2 = {n: int(round(58.5225 * n * n)) for n in (256, 64)}


def target_fx(ssim_target: float) -> int:
    """Config SSIM target (0..1 float) -> 3-plane Q15 threshold."""
    return int(np.floor(ssim_target * Q3))


def fx_to_float(fx) -> float:
    """3-plane Q15 MB score -> the conventional [0..1] SSIM average."""
    return float(fx) / Q3


def _divq15(a, d, xp):
    """floor(a * 32768 / d) for int32 arrays with 0 <= a <= d, 1 <= d < 2^30.
    15-step restoring long division — pure integer, deterministic."""
    q = xp.zeros_like(a)
    rem = a
    for _ in range(15):
        rem = rem << 1
        ge = (rem >= d).astype(a.dtype)
        rem = rem - ge * d
        q = (q << 1) | ge
    return q


def ssim_fx_blocks(sx, rx, n: int, xp=np):
    """sx/rx: (..., n) int32 source/recon pixel blocks -> (...,) int32 Q15."""
    i32 = xp.int32
    sx = sx.astype(i32)
    rx = rx.astype(i32)
    s1 = sx.sum(axis=-1, dtype=i32)
    s2 = rx.sum(axis=-1, dtype=i32)
    q1 = (sx * sx).sum(axis=-1, dtype=i32)
    q2 = (rx * rx).sum(axis=-1, dtype=i32)
    q12 = (sx * rx).sum(axis=-1, dtype=i32)

    p = 2 if n == 256 else 0
    c1 = i32(_C1[n] >> (2 * p))
    c2 = i32(_C2[n])
    t1, t2 = s1 >> p, s2 >> p

    a1 = 2 * t1 * t2 + c1                      # 0 <= a1 <= d1 (2ab <= a²+b²)
    d1 = t1 * t1 + t2 * t2 + c1
    # n*q may exceed int31; two's-complement wrap keeps the difference exact
    # because the true value fits (va <= n²·127.5² < 2^31)
    nn = i32(n)
    va = nn * q1 - s1 * s1
    vb = nn * q2 - s2 * s2
    cv = nn * q12 - s1 * s2
    b1 = 2 * (cv >> 1) + (c2 >> 1)
    d2 = (va >> 1) + (vb >> 1) + (c2 >> 1)

    l_fx = _divq15(a1, d1, xp)
    neg = b1 < 0
    b1a = xp.where(neg, -b1, b1)
    b1a = xp.minimum(b1a, d2)
    cs_fx = _divq15(b1a, d2, xp)
    fx = (l_fx * cs_fx) >> 15
    fx = xp.where(neg, -fx, fx)

    ds = xp.abs(s1 - s2)
    log2n = 8 if n == 256 else 6
    pen = (ds * 655) >> log2n
    return (fx - xp.where(ds > 4 * n, pen, 0)).astype(i32)


def _plane_mb_blocks(plane, size: int, xp):
    H, W = plane.shape[-2], plane.shape[-1]
    b = plane.reshape(H // size, size, W // size, size)
    b = xp.swapaxes(b, 1, 2)
    return b.reshape((H // size) * (W // size), size * size)


def mb_ssim_fx(y, ry, u, ru, v, rv, xp=np):
    """Per-MB 3-plane Q15 SSIM score: (mbc,) int32 ("1.0" = 98304)."""
    fy = ssim_fx_blocks(_plane_mb_blocks(y, 16, xp),
                        _plane_mb_blocks(ry, 16, xp), 256, xp)
    fu = ssim_fx_blocks(_plane_mb_blocks(u, 8, xp),
                        _plane_mb_blocks(ru, 8, xp), 64, xp)
    fv = ssim_fx_blocks(_plane_mb_blocks(v, 8, xp),
                        _plane_mb_blocks(rv, 8, xp), 64, xp)
    return fy + fu + fv


def mb_ssim_fx_16x16(sy, ry, su, ru, sv, rv, xp=np):
    """One-MB variant on (...,16,16)/(…,8,8) patches -> (...,) int32 Q15."""
    lead = sy.shape[:-2]
    fy = ssim_fx_blocks(sy.reshape(*lead, 256), ry.reshape(*lead, 256), 256, xp)
    fu = ssim_fx_blocks(su.reshape(*lead, 64), ru.reshape(*lead, 64), 64, xp)
    fv = ssim_fx_blocks(sv.reshape(*lead, 64), rv.reshape(*lead, 64), 64, xp)
    return fy + fu + fv
