"""Motion search / compensation — numpy spec oracle.

Hierarchical full-search over the 1/16..1x downsample pyramid for 8x8 blocks
(reference luma_search_1step, GPU_kernels.cl:459-560), quarter-pel refinement
with on-the-fly six-tap interpolation (luma_search_2step, 1068-1203), and the
block-wise six-tap motion-compensated prediction (construct /
prepare_predictors_and_residual, 563-774, 1285-1344).

All vectorized over blocks; candidate loops are Python (25 per level).
"""
from __future__ import annotations

import numpy as np

from vp8oclenc_tpu_torch.spec import transforms as T
from vp8oclenc_tpu_torch.tables import SIXTAP_FILTERS

VECTOR_DIFF_WEIGHT = 64   # smoothness penalty (GPU_kernels.cl:82)


def downsample2(p: np.ndarray) -> np.ndarray:
    """2x2 box average with +2 rounding (downsample_x2, GPU_kernels.cl:429-451)."""
    h, w = p.shape
    h2, w2 = h // 2, w // 2
    q = p[:h2 * 2, :w2 * 2].astype(np.int32)
    s = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
    return ((s + 2) // 4).astype(np.uint8)


def build_pyramid(y: np.ndarray) -> list[np.ndarray]:
    """[1x, 2x, 4x, 8x, 16x] downsampled planes."""
    pyr = [y]
    for _ in range(4):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def _block_cost_8x8(cur_blocks: np.ndarray, ref_blocks: np.ndarray) -> np.ndarray:
    """DCT-weighted cost of 8x8 residuals: sum of the 4 quadrant 4x4 costs."""
    res = cur_blocks.astype(np.int32) - ref_blocks.astype(np.int32)
    n = res.shape[0]
    quads = res.reshape(n, 2, 4, 2, 4).transpose(0, 1, 3, 2, 4).reshape(n, 4, 4, 4)
    return T.dct_weight(quads).sum(axis=1)


def _gather_blocks(plane: np.ndarray, py: np.ndarray, px: np.ndarray,
                   size: int) -> np.ndarray:
    """Gather size x size blocks at (py, px) top-left positions (clipped)."""
    H, W = plane.shape
    ys = np.clip(py[:, None] + np.arange(size)[None, :], 0, H - 1)
    xs = np.clip(px[:, None] + np.arange(size)[None, :], 0, W - 1)
    return plane[ys[:, :, None], xs[:, None, :]]


def search_level(cur: np.ndarray, ref: np.ndarray, src_vec: np.ndarray,
                 pixel_rate: int, penalty: bool) -> np.ndarray:
    """One pyramid level of the hierarchical full search.

    cur/ref: planes at this level; src_vec: (nby_c, nbx_c, 2) coarser-level
    vectors in full-res pixel units (or None at the coarsest level).
    Returns (nby, nbx, 2) vectors in full-res pixel units.
    """
    H, W = cur.shape
    nbx, nby = W // 8, H // 8
    n = nbx * nby
    cx = (np.arange(nbx) * 8)[None, :].repeat(nby, 0).reshape(n)
    cy = (np.arange(nby) * 8)[:, None].repeat(nbx, 1).reshape(n)

    if src_vec is None:
        v0x = np.zeros(n, dtype=np.int32)
        v0y = np.zeros(n, dtype=np.int32)
    else:
        # inherited vector: coarser block containing (c/2); C-style
        # truncating division from full-res pixel units to this level's
        v0 = src_vec[np.clip((cy // 2) // 8, 0, src_vec.shape[0] - 1),
                     np.clip((cx // 2) // 8, 0, src_vec.shape[1] - 1)]
        v0 = np.sign(v0) * (np.abs(v0) // pixel_rate)
        v0x, v0y = v0[:, 0].astype(np.int32), v0[:, 1].astype(np.int32)

    cur_blocks = _gather_blocks(cur, cy, cx, 8)

    best_cost = np.full(n, np.int64(1) << 60, dtype=np.int64)
    best_x = cx + v0x
    best_y = cy + v0y
    zeros = np.zeros_like(v0x)
    # dual-window search: the reference scans +-2 around the inherited vector
    # only (GPU_kernels.cl:518-554); we also scan +-2 around zero so a
    # noise-poisoned coarse level cannot lock blocks away from the
    # zero-motion basin.  Strictly a quality improvement; stream-legal.
    for bx_, by_ in ((v0x, v0y), (zeros, zeros)):
        for dxy in range(25):
            dx, dy = (dxy % 5) - 2, (dxy // 5) - 2
            px = cx + bx_ + dx
            py = cy + by_ + dy
            ref_blocks = _gather_blocks(ref, py, px, 8)
            cost = _block_cost_8x8(cur_blocks, ref_blocks)
            if penalty:
                cost = cost + (np.abs(px - cx - v0x)
                               + np.abs(py - cy - v0y)) * (VECTOR_DIFF_WEIGHT // 2)
            invalid = (px < 0) | (px > W - 8) | (py < 0) | (py > H - 8)
            cost = np.where(invalid, np.int64(1) << 40, cost)
            better = cost < best_cost
            best_x = np.where(better, px, best_x)
            best_y = np.where(better, py, best_y)
            best_cost = np.where(better, cost, best_cost)

    vx = (best_x - cx) * pixel_rate
    vy = (best_y - cy) * pixel_rate
    return np.stack([vx, vy], axis=1).reshape(nby, nbx, 2).astype(np.int32)


def _sixtap_blocks(ref: np.ndarray, fy: np.ndarray, fx: np.ndarray,
                   phy: np.ndarray, phx: np.ndarray, size: int) -> np.ndarray:
    """Vectorized six-tap interpolation of size x size blocks.

    fy/fx: (n,) full-pel top-left; phy/phx: (n,) eighth-pel phases.
    Intermediate rows are clamped to 0..255 between passes
    (construct, GPU_kernels.cl:574-774)."""
    n = fy.shape[0]
    H, W = ref.shape
    ext = size + 5
    ys = np.clip(fy[:, None] + np.arange(-2, size + 3)[None, :], 0, H - 1)
    xs = np.clip(fx[:, None] + np.arange(-2, size + 3)[None, :], 0, W - 1)
    patch = ref[ys[:, :, None], xs[:, None, :]].astype(np.int64)   # (n,ext,ext)

    tx = SIXTAP_FILTERS[phx]                                        # (n, 6)
    h = np.zeros((n, ext, size), dtype=np.int64)
    for k in range(6):
        h += patch[:, :, k:k + size] * tx[:, None, k:k + 1]
    h = np.clip((h + 64) >> 7, 0, 255)

    ty = SIXTAP_FILTERS[phy]
    v = np.zeros((n, size, size), dtype=np.int64)
    for k in range(6):
        v += h[:, k:k + size, :] * ty[:, k:k + 1, None]
    return np.clip((v + 64) >> 7, 0, 255).astype(np.int32)


def search_qpel(cur: np.ndarray, ref: np.ndarray, fullpel_vec: np.ndarray):
    """Quarter-pel refinement: 25 candidates +-2 qpel around 4x the full-pel
    vector plus the (0,0) candidate; returns ((nby,nbx,2) qpel vectors,
    (nby,nbx) Bdiff costs with the smoothness penalty removed)."""
    H, W = cur.shape
    nbx, nby = W // 8, H // 8
    n = nbx * nby
    cx = ((np.arange(nbx) * 8)[None, :].repeat(nby, 0).reshape(n)) * 4
    cy = ((np.arange(nby) * 8)[:, None].repeat(nbx, 1).reshape(n)) * 4
    v0 = fullpel_vec.reshape(n, 2) * 4
    v0x, v0y = v0[:, 0], v0[:, 1]

    cur_blocks = _gather_blocks(cur, cy // 4, cx // 4, 8)

    best_cost = np.full(n, np.int64(1) << 60, dtype=np.int64)
    best_x = np.zeros(n, dtype=np.int64)
    best_y = np.zeros(n, dtype=np.int64)
    for cand in range(26):
        if cand < 25:
            dx, dy = (cand % 5) - 2, (cand // 5) - 2
            px = cx + v0x + dx
            py = cy + v0y + dy
        else:
            px, py = cx.copy(), cy.copy()
        fx, fy = px // 4, py // 4
        phx, phy = (px % 4) * 2, (py % 4) * 2
        # 8x8 prediction = the 4 interpolated 4x4 quadrants
        cost = np.zeros(n, dtype=np.int64)
        pred = np.empty((n, 8, 8), dtype=np.int32)
        for q, (qdy, qdx) in enumerate(((0, 0), (0, 4), (4, 0), (4, 4))):
            blk = _sixtap_blocks(ref, fy + qdy, fx + qdx, phy, phx, 4)
            pred[:, qdy:qdy + 4, qdx:qdx + 4] = blk
        cost = _block_cost_8x8(cur_blocks, pred)
        if cand < 25:
            cost = cost + (np.abs(px - cx - v0x) + np.abs(py - cy - v0y)) \
                * (VECTOR_DIFF_WEIGHT // 2)
        invalid = (px < 0) | (px > W * 4 - 32) | (py < 0) | (py > H * 4 - 32)
        cost = np.where(invalid, np.int64(1) << 40, cost)
        better = cost < best_cost
        best_x = np.where(better, px, best_x)
        best_y = np.where(better, py, best_y)
        best_cost = np.where(better, cost, best_cost)

    vx = best_x - cx
    vy = best_y - cy
    nonzero = (vx != 0) | (vy != 0)
    best_cost = best_cost - np.where(
        nonzero,
        (np.abs(vx - v0x) + np.abs(vy - v0y)) * (VECTOR_DIFF_WEIGHT // 2), 0)
    return (np.stack([vx, vy], axis=1).reshape(nby, nbx, 2).astype(np.int32),
            best_cost.reshape(nby, nbx))


def hierarchical_search(cur_pyr: list, ref_pyr: list):
    """Full 5-level search + qpel refine.  Returns (qpel vectors (nby,nbx,2),
    Bdiff (nby,nbx)) over full-res 8x8 blocks."""
    vec = None
    for lvl, rate in ((4, 16), (3, 8), (2, 4), (1, 2), (0, 1)):
        h, w = cur_pyr[lvl].shape
        if (w // 8) == 0 or (h // 8) == 0:
            continue   # level too small to hold any 8x8 block
        vec = search_level(cur_pyr[lvl], ref_pyr[lvl], vec, rate,
                           penalty=(rate < 4))
    return search_qpel(cur_pyr[0], ref_pyr[0], vec)


def mc_predict_plane(ref: np.ndarray, mvs: np.ndarray, quarter_of_block,
                     scale: int) -> np.ndarray:
    """Motion-compensated prediction of a whole plane.

    ref: reference plane; mvs: (mbc, 4, 2) quarter vectors (luma qpel);
    quarter_of_block: maps 4x4 block (nby,nbx) -> (mb index, quarter index);
    scale: 4 for luma (qpel), 8 for chroma (eighth-pel, same numeric MV).
    """
    H, W = ref.shape
    nbx, nby = W // 4, H // 4
    n = nbx * nby
    bx = np.arange(nbx)[None, :].repeat(nby, 0).reshape(n)
    by = np.arange(nby)[:, None].repeat(nbx, 1).reshape(n)
    mb_idx, q_idx = quarter_of_block(by, bx)
    v = mvs[mb_idx, q_idx]                                   # (n, 2)
    ax = bx * 4 * scale + v[:, 0]
    ay = by * 4 * scale + v[:, 1]
    blocks = _sixtap_blocks(ref, ay // scale, ax // scale,
                            (ay % scale) * (8 // scale), (ax % scale) * (8 // scale),
                            4)
    out = np.zeros((H, W), dtype=np.int32)
    out = blocks.reshape(nby, nbx, 4, 4).transpose(0, 2, 1, 3).reshape(H, W)
    return out
