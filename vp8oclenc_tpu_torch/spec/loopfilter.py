"""VP8 normal in-loop deblocking filter — numpy spec oracle.

Exact decoder semantics (RFC 6386 §15; reference
CPU_kernels.cl:829-1439): MBs in raster order, per MB all
vertical edges (left MB edge then internal x=4,8,12) then all horizontal edges
(top MB edge then internal y=4,8,12), operating on values shifted to -128..127.
Internal (subblock) edges are filtered only when the MB has coefficients or is
split (B_PRED/SPLITMV); an MB whose segment filter level is 0 is skipped.

The filter math lives in the `filter_mb_edge` / `filter_b_edge` functions.
"""
from __future__ import annotations

import numpy as np


def _c128(x, xp):
    return xp.clip(x, -128, 127)


def filter_mask(p3, p2, p1, p0, q0, q1, q2, q3, edge_lim, int_lim, xp=np):
    m = (xp.abs(p3 - p2) > int_lim)
    m = m | (xp.abs(p2 - p1) > int_lim)
    m = m | (xp.abs(p1 - p0) > int_lim)
    m = m | (xp.abs(q1 - q0) > int_lim)
    m = m | (xp.abs(q2 - q1) > int_lim)
    m = m | (xp.abs(q3 - q2) > int_lim)
    m = m | ((xp.abs(p0 - q0) * 2 + xp.abs(p1 - q1) // 2) > edge_lim)
    return ~m


def hev_mask(p1, p0, q0, q1, hev_thr, xp=np):
    return (xp.abs(p1 - p0) > hev_thr) | (xp.abs(q1 - q0) > hev_thr)


def filter_mb_edge(p3, p2, p1, p0, q0, q1, q2, q3,
                   mb_lim, int_lim, hev_thr, xp=np):
    """Macroblock-edge filter; returns updated (p2, p1, p0, q0, q1, q2).

    All args are int32 arrays in the -128..127 domain; the limit args
    broadcast along the lane axis.
    """
    mask = filter_mask(p3, p2, p1, p0, q0, q1, q2, q3, mb_lim, int_lim, xp)
    hev = hev_mask(p1, p0, q0, q1, hev_thr, xp)
    w = _c128(_c128(p1 - q1, xp) + 3 * (q0 - p0), xp)
    w = xp.where(mask, w, 0)
    a = xp.where(hev, w, 0)
    b = _c128(a + 3, xp) >> 3
    a = _c128(a + 4, xp) >> 3
    q0 = q0 - a
    p0 = p0 + b
    w = xp.where(hev, 0, w)
    a = _c128((27 * w + 63) >> 7, xp)
    q0 = q0 - a
    p0 = p0 + a
    a = _c128((18 * w + 63) >> 7, xp)
    q1 = q1 - a
    p1 = p1 + a
    a = _c128((9 * w + 63) >> 7, xp)
    q2 = q2 - a
    p2 = p2 + a
    return p2, p1, p0, q0, q1, q2


def filter_b_edge(p3, p2, p1, p0, q0, q1, q2, q3,
                  b_lim, int_lim, hev_thr, xp=np):
    """Subblock-edge filter; returns updated (p1, p0, q0, q1)."""
    mask = filter_mask(p3, p2, p1, p0, q0, q1, q2, q3, b_lim, int_lim, xp)
    hev = hev_mask(p1, p0, q0, q1, hev_thr, xp)
    a = _c128(p1 - q1, xp)
    a = xp.where(hev, a, 0)
    a = _c128(a + 3 * (q0 - p0), xp)
    a = xp.where(mask, a, 0)
    b = _c128(a + 3, xp) >> 3
    a = _c128(a + 4, xp) >> 3
    q0 = q0 - a
    p0 = p0 + b
    a = (a + 1) >> 1
    a = xp.where(hev, 0, a)
    q1 = q1 - a
    p1 = p1 + a
    return p1, p0, q0, q1


def _filter_vertical_edge(plane, x, y0, n, kind, lims):
    """Filter the vertical edge at column x for rows y0..y0+n (in place)."""
    mb_lim, b_lim, int_lim, hev_thr = lims
    cols = plane[y0:y0 + n, x - 4:x + 4].astype(np.int32) - 128
    p3, p2, p1, p0, q0, q1, q2, q3 = [cols[:, i] for i in range(8)]
    if kind == "mb":
        p2, p1, p0, q0, q1, q2 = filter_mb_edge(
            p3, p2, p1, p0, q0, q1, q2, q3, mb_lim, int_lim, hev_thr)
        out = np.stack([p2, p1, p0, q0, q1, q2], axis=1)
        plane[y0:y0 + n, x - 3:x + 3] = np.clip(out + 128, 0, 255).astype(plane.dtype)
    else:
        p1, p0, q0, q1 = filter_b_edge(
            p3, p2, p1, p0, q0, q1, q2, q3, b_lim, int_lim, hev_thr)
        out = np.stack([p1, p0, q0, q1], axis=1)
        plane[y0:y0 + n, x - 2:x + 2] = np.clip(out + 128, 0, 255).astype(plane.dtype)


def _filter_horizontal_edge(plane, y, x0, n, kind, lims):
    mb_lim, b_lim, int_lim, hev_thr = lims
    rows = plane[y - 4:y + 4, x0:x0 + n].astype(np.int32) - 128
    p3, p2, p1, p0, q0, q1, q2, q3 = [rows[i] for i in range(8)]
    if kind == "mb":
        p2, p1, p0, q0, q1, q2 = filter_mb_edge(
            p3, p2, p1, p0, q0, q1, q2, q3, mb_lim, int_lim, hev_thr)
        out = np.stack([p2, p1, p0, q0, q1, q2], axis=0)
        plane[y - 3:y + 3, x0:x0 + n] = np.clip(out + 128, 0, 255).astype(plane.dtype)
    else:
        p1, p0, q0, q1 = filter_b_edge(
            p3, p2, p1, p0, q0, q1, q2, q3, b_lim, int_lim, hev_thr)
        out = np.stack([p1, p0, q0, q1], axis=0)
        plane[y - 2:y + 2, x0:x0 + n] = np.clip(out + 128, 0, 255).astype(plane.dtype)


def loop_filter_plane(plane: np.ndarray, mb_size: int, segment_ids: np.ndarray,
                      inner_mask: np.ndarray, seg) -> None:
    """Filter one plane in place.  mb_size: 16 (luma) or 8 (chroma).
    inner_mask (mbc,): filter subblock edges.  seg: SegmentData."""
    H, W = plane.shape
    mbh, mbw = H // mb_size, W // mb_size
    for mby in range(mbh):
        for mbx in range(mbw):
            mbn = mby * mbw + mbx
            sid = int(segment_ids[mbn])
            if int(seg.loop_filter_level[sid]) == 0:
                continue
            lims = (int(seg.mbedge_limit[sid]), int(seg.sub_bedge_limit[sid]),
                    int(seg.interior_limit[sid]), int(seg.hev_threshold[sid]))
            x0, y0 = mbx * mb_size, mby * mb_size
            # vertical edges (left MB edge, then internal)
            if mbx > 0:
                _filter_vertical_edge(plane, x0, y0, mb_size, "mb", lims)
            if inner_mask[mbn]:
                for dx in range(4, mb_size, 4):
                    _filter_vertical_edge(plane, x0 + dx, y0, mb_size, "b", lims)
            # horizontal edges (top MB edge, then internal)
            if mby > 0:
                _filter_horizontal_edge(plane, y0, x0, mb_size, "mb", lims)
            if inner_mask[mbn]:
                for dy in range(4, mb_size, 4):
                    _filter_horizontal_edge(plane, y0 + dy, x0, mb_size, "b", lims)


def loop_filter_frame(recon_y, recon_u, recon_v, segment_ids, inner_mask, seg):
    """Filter all three planes in place (Y then U then V)."""
    loop_filter_plane(recon_y, 16, segment_ids, inner_mask, seg)
    loop_filter_plane(recon_u, 8, segment_ids, inner_mask, seg)
    loop_filter_plane(recon_v, 8, segment_ids, inner_mask, seg)
