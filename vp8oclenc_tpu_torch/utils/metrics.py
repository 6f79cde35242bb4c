"""Quality metrics: PSNR and single-scale SSIM (frame- and plane-level).

Counterpart of the reference's quality instrumentation (per-MB SSIM buffers
G16/G17 and the -print-info SSIM/bitrate lines, vp8enc.cpp:258-259, 482-483);
used by tests and the quality benchmark.
"""
from __future__ import annotations

import numpy as np

_C1 = (0.01 * 255) ** 2
_C2 = (0.03 * 255) ** 2


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(255.0 ** 2 / mse))


def frame_psnr(src, rec) -> dict:
    """src/rec: (y, u, v) planes.  Returns per-plane and combined PSNR."""
    py = psnr(src[0], rec[0])
    pu = psnr(src[1], rec[1])
    pv = psnr(src[2], rec[2])
    # combined over all samples
    num = sum(np.sum((s.astype(np.float64) - r.astype(np.float64)) ** 2)
              for s, r in zip(src, rec))
    den = sum(s.size for s in src)
    mse = num / den
    pall = float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))
    return {"y": py, "u": pu, "v": pv, "all": pall}


def ssim_plane(a: np.ndarray, b: np.ndarray, win: int = 8) -> float:
    """Mean single-scale SSIM over non-overlapping win x win blocks."""
    H, W = a.shape
    nh, nw = H // win, W // win
    x = a[: nh * win, : nw * win].astype(np.float64) \
        .reshape(nh, win, nw, win).swapaxes(1, 2)
    y = b[: nh * win, : nw * win].astype(np.float64) \
        .reshape(nh, win, nw, win).swapaxes(1, 2)
    mx = x.mean(axis=(2, 3))
    my = y.mean(axis=(2, 3))
    vx = x.var(axis=(2, 3))
    vy = y.var(axis=(2, 3))
    cov = (x * y).mean(axis=(2, 3)) - mx * my
    s = ((2 * mx * my + _C1) * (2 * cov + _C2)) / \
        ((mx * mx + my * my + _C1) * (vx + vy + _C2))
    return float(s.mean())
