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
restoring long division: floor(a·32768/d) for 0 <= a < d, but 32767, not
32768, for a == d (identical or flat blocks reach it), which every
implementation of this contract must keep.

n·q1 and s1² exceed int32 for 16x16 blocks (255² · 256² > 2^31) although
their difference fits.  The JAX package relies on int32 two's-complement
wrap for that; here va, vb and cv are computed exactly in int64 and cast
back to int32, so no step depends on signed overflow.  Everything else
stays inside int32.

Per-MB score = Y + U + V plane values (avg·3 in Q15, i.e. "1.0" = 98304).
UNCODED_FX marks MBs that no pass has coded yet.

`mb_ssim_fx` and `mb_ssim_fx_16x16` take uint8 or int32 pixels in
0..255.  For CUDA tensors they launch csrc/ssim.cu's kernel once a call
(`mb_ssim_cuda`, which counts its launches), reading every operand where
it lies: as vector rows where its columns are unit stride and aligned,
else through its strides.  The sums are taken in int32 and the scores in
the integer arithmetic above (csrc/ssim_fx.cuh, which the inter frame's
segment pass shares), so the result equals the plain version's bit for
bit.  For CPU tensors they run the plain versions, `mb_ssim_fx_plain` and
`mb_ssim_fx_16x16_plain`.
"""
from __future__ import annotations

import ctypes
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
    """15-step restoring division of int32 tensors with 0 <= a <= d,
    1 <= d < 2^30 (so rem << 1 < 2^31): floor(a * 32768 / d) for a < d;
    for a == d every step subtracts, so the result saturates at 32767."""
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


def mb_ssim_fx_plain(y, ry, u, ru, v, rv) -> torch.Tensor:
    """Per-MB 3-plane Q15 SSIM score of whole planes, y/ry (H, W) and
    u/ru, v/rv (H/2, W/2): (mbc,) int32 ("1.0" = 98304)."""
    fy = ssim_fx_blocks(_plane_mb_blocks(y, 16), _plane_mb_blocks(ry, 16), 256)
    fu = ssim_fx_blocks(_plane_mb_blocks(u, 8), _plane_mb_blocks(ru, 8), 64)
    fv = ssim_fx_blocks(_plane_mb_blocks(v, 8), _plane_mb_blocks(rv, 8), 64)
    return fy + fu + fv


def mb_ssim_fx_16x16_plain(sy, ry, su, ru, sv, rv) -> torch.Tensor:
    """Per-MB score on patches: (..., 16, 16) luma and (..., 8, 8) chroma
    source/recon pairs -> (...,) int32 Q15."""
    fy = ssim_fx_blocks(sy.flatten(-2), ry.flatten(-2), 256)
    fu = ssim_fx_blocks(su.flatten(-2), ru.flatten(-2), 64)
    fv = ssim_fx_blocks(sv.flatten(-2), rv.flatten(-2), 64)
    return fy + fu + fv


_ESZ = {torch.uint8: 1, torch.int32: 4}


def _on_cpu(what: str, ts) -> bool:
    """True if every tensor lies on the CPU; False if every one lies on
    one CUDA device; else ValueError."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev or dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{what}: every input must lie on the CPU or "
                             f"on one CUDA device, got {t.device} beside "
                             f"{dev}")
        if t.dtype not in _ESZ:
            raise ValueError(f"{what}: pixels must be uint8 or int32, got "
                             f"{t.dtype}")
    return dev.type == "cpu"


_SIZES = (16, 16, 8, 8, 8, 8)   # block side of Y, Y, U, U, V, V


def mb_ssim_cuda(ts, strides, mbw: int, lead) -> torch.Tensor:
    """One launch of csrc/ssim.cu.  ts: the six operands source Y, recon
    Y, source U, recon U, source V, recon V, uint8 or int32, on one CUDA
    device; strides[i]: ts[i]'s element strides (s_my, s_mx, s_r4, s_r,
    s_c4, s_c), pixel row 4R+r, column 4C+c of MB (my, mx) lying at
    my*s_my + mx*s_mx + R*s_r4 + r*s_r + C*s_c4 + c*s_c, less than 2^31
    elements from the first.  Returns the int32 scores of MBs m = my*mbw
    + mx, shaped `lead`.  The kernel's constants C1' and C2' are
    csrc/ssim_fx.cuh's copies of _C1 and _C2."""
    from vp8oclenc_tpu_torch.ops import cuda_build
    dev = ts[0].device
    out = torch.empty(lead, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    desc = []
    for t, st in zip(ts, strides):
        desc += [t.data_ptr(), _ESZ[t.dtype], *st]
    rc = cuda_build.library("ssim").vp8_mb_ssim(
        (ctypes.c_longlong * len(desc))(*desc),
        ctypes.c_void_p(out.data_ptr()), out.numel(), mbw,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(rc, "vp8_mb_ssim")
    mb_ssim_cuda.launches += 1
    return out


mb_ssim_cuda.launches = 0


def mb_ssim_fx(y, ry, u, ru, v, rv) -> torch.Tensor:
    """Per-MB 3-plane Q15 SSIM score of whole planes (contract of
    `mb_ssim_fx_plain`): csrc/ssim.cu's kernel for CUDA tensors, the plain
    version for CPU tensors."""
    ts = (y, ry, u, ru, v, rv)
    if _on_cpu("mb_ssim_fx", ts):
        return mb_ssim_fx_plain(*ts)
    if y.dim() != 2 or y.shape[0] % 16 or y.shape[1] % 16:
        raise ValueError(f"mb_ssim_fx: y must be an (H, W) plane of whole "
                         f"MBs, got {tuple(y.shape)}")
    H, W = y.shape
    strides = []
    for t, n in zip(ts, _SIZES):
        if tuple(t.shape) != (H * n // 16, W * n // 16):
            raise ValueError(f"mb_ssim_fx: planes of {H}x{W} luma need "
                             f"{n}/16 of it, got {tuple(t.shape)}")
        a, b = t.stride()
        strides.append((n * a, n * b, 4 * a, a, 4 * b, b))
    return mb_ssim_cuda(ts, strides, W // 16, ((H // 16) * (W // 16),))


def mb_ssim_fx_16x16(sy, ry, su, ru, sv, rv) -> torch.Tensor:
    """Per-MB score on patches (contract of `mb_ssim_fx_16x16_plain`),
    with at most two leading dimensions on the card: csrc/ssim.cu's kernel
    for CUDA tensors, the plain version for CPU tensors."""
    ts = (sy, ry, su, ru, sv, rv)
    if _on_cpu("mb_ssim_fx_16x16", ts):
        return mb_ssim_fx_16x16_plain(*ts)
    lead = tuple(sy.shape[:-2])
    if len(lead) > 2:
        raise ValueError(f"mb_ssim_fx_16x16: at most two leading "
                         f"dimensions on the card, got {tuple(sy.shape)}")
    strides = []
    for t, n in zip(ts, _SIZES):
        if tuple(t.shape) != lead + (n, n):
            raise ValueError(f"mb_ssim_fx_16x16: expected {lead + (n, n)}, "
                             f"got {tuple(t.shape)}")
        *ls, a, b = t.stride()
        strides.append((0,) * (2 - len(lead)) + tuple(ls)
                       + (4 * a, a, 4 * b, b))
    return mb_ssim_cuda(ts, strides, lead[-1] if lead else 1, lead)
