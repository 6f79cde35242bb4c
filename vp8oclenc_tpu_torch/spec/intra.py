"""Spec-reference (numpy) intra path: keyframe encoding and intra MB re-encode.

Sequential oracle implementation of the keyframe pipeline
(reference intra_part.h:517-741,1089-1129): per-4x4 exhaustive
10-mode B_PRED selection scored by DCT-domain cost, chroma whole-MB TM_PRED,
DCT->quant->iDCT reconstruction in place, zigzag.  The port's intra
kernels (vp8oclenc_tpu_torch.ops.intra) match this bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from vp8oclenc_tpu_torch.spec import transforms as T
from vp8oclenc_tpu_torch.spec.predict import bpred_all_modes, tm_predict_8x8


def luma_block_neighbors(recon_y: np.ndarray, bx: int, by: int, w4: int):
    """(A[8], L[4], P) for global 4x4 block (bx, by) using the reference's
    border rules: above row -> 127, left col -> 129, and the above-right
    MB-boundary rule (intra_part.h:540-618)."""
    x, y = bx * 4, by * 4
    if by == 0:
        A = np.full(8, 127, dtype=np.int32)
        P = np.int32(127)
    else:
        A = np.empty(8, dtype=np.int32)
        A[:4] = recon_y[y - 1, x:x + 4]
        if bx % 4 < 3:
            A[4:] = recon_y[y - 1, x + 4:x + 8]
        else:
            # rightmost block column of the MB: above-right pixels come from
            # the row above the MB (loaded once per MB in the reference,
            # intra_part.h:600-610); 127 when the MB is in the top row.
            mb_top = (by // 4) * 16
            if mb_top == 0:
                A[4:] = 127
            elif bx == w4 - 1:
                A[4:] = recon_y[mb_top - 1, x + 3]
            else:
                A[4:] = recon_y[mb_top - 1, x + 4:x + 8]
        P = np.int32(129) if bx == 0 else recon_y[y - 1, x - 1].astype(np.int32)
    if bx == 0:
        L = np.full(4, 129, dtype=np.int32)
    else:
        L = recon_y[y:y + 4, x - 1].astype(np.int32)
    if by == 0:
        P = np.int32(127)
    elif bx == 0:
        P = np.int32(129)
    return A, L, P


def encode_luma_block(src: np.ndarray, A, L, P, dc_q: int, ac_q: int):
    """Pick best bmode for one 4x4; returns (mode, levels[16] zigzag, recon4x4)."""
    preds = bpred_all_modes(A, L, P)                 # (10, 4, 4)
    residuals = src[None].astype(np.int32) - preds   # (10, 4, 4)
    costs = T.dct_weight(residuals)                  # (10,)
    mode = int(np.argmin(costs))
    coeffs = T.fdct4x4(residuals[mode])
    levels = T.quant4x4(coeffs, dc_q, ac_q)
    dq = T.dequant4x4(levels, dc_q, ac_q)
    rec = np.clip(T.idct4x4(dq) + preds[mode], 0, 255)
    return mode, T.zigzag(levels).astype(np.int16), rec.astype(np.uint8)


def encode_chroma_mb(src_plane: np.ndarray, recon_plane: np.ndarray,
                     mbx: int, mby: int, dc_q: int, ac_q: int):
    """TM_PRED one 8x8 chroma MB; writes recon in place; returns levels (4,16)."""
    x, y = mbx * 8, mby * 8
    if mby == 0:
        top = np.full(8, 127, dtype=np.int32)
    else:
        top = recon_plane[y - 1, x:x + 8].astype(np.int32)
    if mbx == 0:
        left = np.full(8, 129, dtype=np.int32)
    else:
        left = recon_plane[y:y + 8, x - 1].astype(np.int32)
    if mby == 0:
        tl = np.int32(127)
    elif mbx == 0:
        tl = np.int32(129)
    else:
        tl = recon_plane[y - 1, x - 1].astype(np.int32)

    pred = tm_predict_8x8(top, left, tl)             # (8, 8)
    res = src_plane[y:y + 8, x:x + 8].astype(np.int32) - pred
    # 4 blocks in raster order [0 1; 2 3]
    blocks = res.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)      # (2,2,4,4)
    coeffs = T.fdct4x4(blocks)
    levels = T.quant4x4(coeffs, dc_q, ac_q)
    dq = T.dequant4x4(levels, dc_q, ac_q)
    rec_res = T.idct4x4(dq)
    pred_blocks = pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
    rec = np.clip(rec_res + pred_blocks, 0, 255)
    recon_plane[y:y + 8, x:x + 8] = \
        rec.transpose(0, 2, 1, 3).reshape(8, 8).astype(np.uint8)
    return T.zigzag(levels).reshape(4, 16).astype(np.int16)


def encode_intra_mb(y, u, v, recon_y, recon_u, recon_v, mbx: int, mby: int,
                    mbw: int, y_dc_q, y_ac_q, uv_dc_q, uv_ac_q):
    """Encode one MB fully intra (B_PRED luma + TM chroma), updating recon
    planes in place.  Returns (levels (25,16) int16, modes (16,) int8)."""
    w4 = mbw * 4
    levels = np.zeros((25, 16), dtype=np.int16)
    modes = np.zeros(16, dtype=np.int8)
    for br in range(4):
        for bc in range(4):
            bx, by = mbx * 4 + bc, mby * 4 + br
            A, L, P = luma_block_neighbors(recon_y, bx, by, w4)
            src = y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            mode, lev, rec = encode_luma_block(
                src, A, L, P, int(y_dc_q), int(y_ac_q))
            modes[br * 4 + bc] = mode
            levels[br * 4 + bc] = lev
            recon_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = rec
    levels[16:20] = encode_chroma_mb(u, recon_u, mbx, mby, int(uv_dc_q), int(uv_ac_q))
    levels[20:24] = encode_chroma_mb(v, recon_v, mbx, mby, int(uv_dc_q), int(uv_ac_q))
    return levels, modes


def encode_intra_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray, seg):
    """Full keyframe: all MBs B_PRED/TM at segment 0 quantizers.

    Returns (levels (mbc,25,16) int16, modes (mbc,16) int8,
    recon (y,u,v) uint8 planes)."""
    H, W = y.shape
    mbh, mbw = H // 16, W // 16
    mbc = mbh * mbw
    recon_y = np.zeros((H, W), dtype=np.uint8)
    recon_u = np.zeros((H // 2, W // 2), dtype=np.uint8)
    recon_v = np.zeros((H // 2, W // 2), dtype=np.uint8)
    levels = np.zeros((mbc, 25, 16), dtype=np.int16)
    modes = np.zeros((mbc, 16), dtype=np.int8)
    sid = 0
    for mby in range(mbh):
        for mbx in range(mbw):
            lv, md = encode_intra_mb(
                y, u, v, recon_y, recon_u, recon_v, mbx, mby, mbw,
                seg.y_dc_q[sid], seg.y_ac_q[sid], seg.uv_dc_q[sid], seg.uv_ac_q[sid])
            levels[mby * mbw + mbx] = lv
            modes[mby * mbw + mbx] = md
    return levels, modes, (recon_y, recon_u, recon_v)
