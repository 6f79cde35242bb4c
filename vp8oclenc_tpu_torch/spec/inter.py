"""Spec-reference (numpy) inter frame path.

The full inter pipeline of the reference GPU sequencer
(reference inter_part.h:96-384): hierarchical ME over 3 reference
frames, qpel refinement, reference selection, 8x8->16x16 packing, six-tap
predictors, progressive per-segment requantization (LQ->UQ) driven by per-MB
SSIM, WHT/Y2 for 16x16 MBs, reconstruction, and the SSIM quality controller
with intra replacement (vp8enc.cpp:231-263, intra_part.h:855-1087).
"""
from __future__ import annotations

import numpy as np

from vp8oclenc_tpu_torch.pipeline.segments import SegmentData
from vp8oclenc_tpu_torch.spec import intra as SPEC_INTRA
from vp8oclenc_tpu_torch.spec import motion as M
from vp8oclenc_tpu_torch.spec import transforms as T
from vp8oclenc_tpu_torch.spec.ssim_fx import (UNCODED_FX, WEAKEN_FX,
                                              mb_ssim_fx, mb_ssim_fx_16x16,
                                              target_fx)
from vp8oclenc_tpu_torch.tables import (ALTREF, ARE4X4, ARE8X8, ARE16X16,
                                        GOLDEN, LAST, LQ_SEGMENT)


def _quarter_map_luma(mbw):
    def f(by, bx):
        mb = (by // 4) * mbw + (bx // 4)
        q = ((by % 4) // 2) * 2 + ((bx % 4) // 2)
        return mb, q
    return f


def _quarter_map_chroma(mbw):
    def f(by, bx):
        mb = (by // 2) * mbw + (bx // 2)
        q = (by % 2) * 2 + (bx % 2)
        return mb, q
    return f


def transform_mb_luma(res_blocks: np.ndarray, parts: np.ndarray,
                      y_dc_q, y_ac_q, y2_dc_q, y2_ac_q):
    """Per-MB luma transform with Y2 handling.

    res_blocks: (mbc, 16, 4, 4) int32 residuals (block raster order in MB).
    Quant args: scalars or (mbc,) arrays.  Returns (levels (mbc,16,16) zigzag,
    y2_levels (mbc,16) zigzag, rec_res (mbc,16,4,4) reconstructed residual).
    """
    mbc = res_blocks.shape[0]
    coeffs = T.fdct4x4(res_blocks)                         # (mbc,16,4,4)
    has_y2 = (parts == ARE16X16)

    bc = lambda q: np.broadcast_to(np.asarray(q), (mbc,)).astype(np.int64)
    y_dc_q, y_ac_q = bc(y_dc_q), bc(y_ac_q)
    y2_dc_q, y2_ac_q = bc(y2_dc_q), bc(y2_ac_q)

    # DC of 16x16 MBs goes through Y2 (quantizer 1 on the Y path)
    dc_q_eff = np.where(has_y2, 1, y_dc_q)
    levels = T.quant4x4(coeffs, dc_q_eff[:, None], y_ac_q[:, None])
    dq = T.dequant4x4(levels, dc_q_eff[:, None], y_ac_q[:, None])

    # Y2: WHT of the 16 raw DCs
    dcs = coeffs[:, :, 0, 0].reshape(mbc, 4, 4)
    y2c = T.fwht4x4(dcs)
    y2_levels = T.quant4x4(y2c, y2_dc_q, y2_ac_q)
    y2_dq = T.dequant4x4(y2_levels, y2_dc_q, y2_ac_q)
    y2_rec_dc = T.iwht4x4(y2_dq).reshape(mbc, 16)

    dq[:, :, 0, 0] = np.where(has_y2[:, None], y2_rec_dc, dq[:, :, 0, 0])
    rec_res = T.idct4x4(dq)

    levels_z = T.zigzag(levels)
    levels_z[:, :, 0] = np.where(has_y2[:, None], 0, levels_z[:, :, 0])
    y2_z = np.where(has_y2[:, None], T.zigzag(y2_levels), 0)
    return levels_z, y2_z, rec_res


def transform_mb_chroma(res_blocks: np.ndarray, dc_q, ac_q):
    """res_blocks: (mbc, 4, 4, 4) -> (levels zigzag (mbc,4,16), rec_res)."""
    mbc = res_blocks.shape[0]
    coeffs = T.fdct4x4(res_blocks)
    dc_q = np.broadcast_to(np.asarray(dc_q), (mbc,)).astype(np.int64)[:, None]
    ac_q = np.broadcast_to(np.asarray(ac_q), (mbc,)).astype(np.int64)[:, None]
    levels = T.quant4x4(coeffs, dc_q, ac_q)
    rec_res = T.idct4x4(T.dequant4x4(levels, dc_q, ac_q))
    return T.zigzag(levels), rec_res


def _mb_blocks_luma(plane: np.ndarray, mbw: int, mbh: int) -> np.ndarray:
    """(H,W) -> (mbc, 16, 4, 4) 4x4 blocks in raster order within each MB."""
    b = plane.reshape(mbh, 4, 4, mbw, 4, 4)
    # dims: mby, block_row, pix_row, mbx, block_col, pix_col
    return b.transpose(0, 3, 1, 4, 2, 5).reshape(mbh * mbw, 16, 4, 4)


def _luma_from_mb_blocks(blocks: np.ndarray, mbw: int, mbh: int) -> np.ndarray:
    b = blocks.reshape(mbh, mbw, 4, 4, 4, 4).transpose(0, 2, 4, 1, 3, 5)
    return b.reshape(mbh * 16, mbw * 16)


def _mb_blocks_chroma(plane: np.ndarray, mbw: int, mbh: int) -> np.ndarray:
    b = plane.reshape(mbh, 2, 4, mbw, 2, 4)
    return b.transpose(0, 3, 1, 4, 2, 5).reshape(mbh * mbw, 4, 4, 4)


def _chroma_from_mb_blocks(blocks: np.ndarray, mbw: int, mbh: int) -> np.ndarray:
    b = blocks.reshape(mbh, mbw, 2, 2, 4, 4).transpose(0, 2, 4, 1, 3, 5)
    return b.reshape(mbh * 8, mbw * 8)


def encode_inter_frame(cfg, refs, usable, y, u, v, seg: SegmentData,
                       is_golden: bool, is_altref: bool):
    """Full inter frame before the loop filter.

    refs: the LAST, GOLDEN and ALTREF planes (y, u, v); usable: whether
    GOLDEN and ALTREF may be used (pipeline/control.RefSchedule.usable).
    seg takes the weakened filter when min SSIM > WEAKEN_FX.  Returns
    (FrameData, [recon y, u, v], reason): reason is None, or "ssim" /
    "replaced" when the SSIM controller asks for the frame to be done again
    as a keyframe."""
    from vp8oclenc_tpu_torch.pipeline.encoder import FrameData

    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    mbc = mbw * mbh
    (last_y, last_u, last_v), golden, altref = refs
    use_golden, use_altref = usable

    cur_pyr = M.build_pyramid(y)
    refs = {LAST: (last_y, last_u, last_v)}
    vecs = {}
    diffs = {}
    vecs[LAST], diffs[LAST] = M.hierarchical_search(cur_pyr,
                                                    M.build_pyramid(last_y))
    if use_golden:
        refs[GOLDEN] = golden
        vecs[GOLDEN], diffs[GOLDEN] = M.hierarchical_search(
            cur_pyr, M.build_pyramid(golden[0]))
    if use_altref:
        refs[ALTREF] = altref
        vecs[ALTREF], diffs[ALTREF] = M.hierarchical_search(
            cur_pyr, M.build_pyramid(altref[0]))

    # select_reference: per MB, sum of the 4 8x8 Bdiffs; ties prefer
    # LAST over ALTREF over GOLDEN (GPU_kernels.cl:1205-1283)
    def mb_sum(d):
        return d.reshape(mbh, 2, mbw, 2).sum(axis=(1, 3)).reshape(mbc)

    big = np.int64(1) << 62
    d_last = mb_sum(diffs[LAST])
    d_alt = mb_sum(diffs[ALTREF]) if use_altref else np.full(mbc, big)
    d_gold = mb_sum(diffs[GOLDEN]) if use_golden else np.full(mbc, big)
    ref_sel = np.where(d_last <= d_alt, LAST, ALTREF)
    d_best = np.minimum(d_last, d_alt)
    ref_sel = np.where(d_best <= d_gold, ref_sel, GOLDEN)

    # per-MB quarter vectors from the selected reference
    def mb_quarters(vgrid):
        q = vgrid.reshape(mbh, 2, mbw, 2, 2).transpose(0, 2, 1, 3, 4)
        return q.reshape(mbc, 4, 2)

    mvs = mb_quarters(vecs[LAST]).copy()
    if use_golden:
        g = mb_quarters(vecs[GOLDEN])
        mvs = np.where((ref_sel == GOLDEN)[:, None, None], g, mvs)
    if use_altref:
        a = mb_quarters(vecs[ALTREF])
        mvs = np.where((ref_sel == ALTREF)[:, None, None], a, mvs)
    mvs = mvs.astype(np.int16)

    # pack 8x8 -> 16x16 where all quarters agree
    same = np.all(mvs == mvs[:, :1, :], axis=(1, 2))
    parts = np.where(same, ARE16X16, ARE8X8).astype(np.int32)

    # motion-compensated predictors (per selected reference, whole planes)
    pred_y = np.zeros_like(y, dtype=np.int32)
    pred_u = np.zeros_like(u, dtype=np.int32)
    pred_v = np.zeros_like(v, dtype=np.int32)
    qmap_l = _quarter_map_luma(mbw)
    qmap_c = _quarter_map_chroma(mbw)
    for r, (ry_, ru_, rv_) in refs.items():
        sel = ref_sel == r
        if not np.any(sel):
            continue
        py = M.mc_predict_plane(ry_, mvs, qmap_l, 4)
        pu = M.mc_predict_plane(ru_, mvs, qmap_c, 8)
        pv = M.mc_predict_plane(rv_, mvs, qmap_c, 8)
        selg = sel.reshape(mbh, mbw)
        m_l = np.kron(selg, np.ones((16, 16), dtype=bool))
        m_c = np.kron(selg, np.ones((8, 8), dtype=bool))
        pred_y = np.where(m_l, py, pred_y)
        pred_u = np.where(m_c, pu, pred_u)
        pred_v = np.where(m_c, pv, pred_v)

    res_y = _mb_blocks_luma(y.astype(np.int32) - pred_y, mbw, mbh)
    res_u = _mb_blocks_chroma(u.astype(np.int32) - pred_u, mbw, mbh)
    res_v = _mb_blocks_chroma(v.astype(np.int32) - pred_v, mbw, mbh)
    pred_y_b = _mb_blocks_luma(pred_y, mbw, mbh)
    pred_u_b = _mb_blocks_chroma(pred_u, mbw, mbh)
    pred_v_b = _mb_blocks_chroma(pred_v, mbw, mbh)

    # progressive per-segment requantization LQ -> UQ
    ssim_on = cfg.ssim_target > 0.0
    tfx3 = target_fx(cfg.ssim_target) if ssim_on else -1
    levels = np.zeros((mbc, 25, 16), dtype=np.int16)
    segment_ids = np.full(mbc, LQ_SEGMENT, dtype=np.int32)
    cur_fx = np.full(mbc, UNCODED_FX, dtype=np.int32)
    rec_y_b = np.zeros_like(pred_y_b)
    rec_u_b = np.zeros_like(pred_u_b)
    rec_v_b = np.zeros_like(pred_v_b)

    n_passes = 4 if ssim_on else 1       # single LQ pass when SSIM is off
    for sid in range(LQ_SEGMENT, LQ_SEGMENT - n_passes, -1):
        active = cur_fx <= tfx3
        if not np.any(active):
            break
        lz, y2z, rr = transform_mb_luma(
            res_y, parts, int(seg.y_dc_q[sid]), int(seg.y_ac_q[sid]),
            int(seg.y2_dc_q[sid]), int(seg.y2_ac_q[sid]))
        uz, ur = transform_mb_chroma(res_u, int(seg.uv_dc_q[sid]),
                                     int(seg.uv_ac_q[sid]))
        vz, vr = transform_mb_chroma(res_v, int(seg.uv_dc_q[sid]),
                                     int(seg.uv_ac_q[sid]))
        am = active
        segment_ids = np.where(am, sid, segment_ids)
        levels[am, :16, :] = lz[am].astype(np.int16)
        levels[am, 16:20, :] = uz[am].astype(np.int16)
        levels[am, 20:24, :] = vz[am].astype(np.int16)
        levels[am, 24, :] = y2z[am].astype(np.int16)
        rec_y_b[am] = np.clip(pred_y_b[am] + rr[am], 0, 255)
        rec_u_b[am] = np.clip(pred_u_b[am] + ur[am], 0, 255)
        rec_v_b[am] = np.clip(pred_v_b[am] + vr[am], 0, 255)
        ry = _luma_from_mb_blocks(rec_y_b, mbw, mbh)
        ru = _chroma_from_mb_blocks(rec_u_b, mbw, mbh)
        rv = _chroma_from_mb_blocks(rec_v_b, mbw, mbh)
        new_fx = mb_ssim_fx(y, ry, u, ru, v, rv)
        cur_fx = np.where(am, new_fx, cur_fx)

    recon_y = _luma_from_mb_blocks(rec_y_b, mbw, mbh).astype(np.uint8)
    recon_u = _chroma_from_mb_blocks(rec_u_b, mbw, mbh).astype(np.uint8)
    recon_v = _chroma_from_mb_blocks(rec_v_b, mbw, mbh).astype(np.uint8)

    is_inter = np.ones(mbc, dtype=bool)
    modes = np.zeros((mbc, 16), dtype=np.int8)
    replaced = 0

    # SSIM quality controller: try failing MBs as intra (AQ -> HQ -> UQ)
    if ssim_on:
        replaced = _intra_replace(mbw, mbh, y, u, v, recon_y, recon_u, recon_v,
                                  levels, modes, parts, segment_ids,
                                  cur_fx, is_inter, seg, tfx3)
    # weaken the loop filter on near-perfect frames (check_SSIM,
    # vp8enc.cpp:260-261) — runs regardless of the SSIM target
    if int(cur_fx.min()) > WEAKEN_FX:
        from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
        seg2 = prepare_segments(cfg, y, False, is_altref, weaken_filter=True,
                                strength=seg.raw_strength)
        seg.__dict__.update(seg2.__dict__)
    reason = None
    if ssim_on:
        sum_fx = int(np.maximum(cur_fx, -98304).astype(np.int64).sum())
        if replaced > mbc // 6 or sum_fx < tfx3 * mbc:
            reason = "ssim" if sum_fx < tfx3 * mbc else "replaced"

    fd = FrameData(
        mbw=mbw, mbh=mbh, is_key=False, is_golden=is_golden,
        is_altref=is_altref, levels=levels, parts=parts,
        segment_ids=segment_ids, modes=modes, is_inter=is_inter,
        ref_frame=ref_sel.astype(np.int32), mvs=mvs, replaced=replaced)
    fd.ssim_min_fx = int(cur_fx.min())
    fd.ssim_sum_fx = int(np.maximum(cur_fx, -98304).astype(np.int64).sum())
    return fd, [recon_y, recon_u, recon_v], reason


def _intra_replace(mbw, mbh, y, u, v, recon_y, recon_u, recon_v, levels, modes,
                   parts, segment_ids, cur_fx, is_inter, seg, tfx3) -> int:
    """test_inter_on_intra over failing MBs, AQ -> HQ -> UQ
    (intra_part.h:855-1087; vp8enc.cpp:242-251), re-specified for batch
    parallelism: every trial predicts from the FROZEN pre-replacement
    reconstruction (the reference re-reads the evolving recon in raster
    order), and a winner is applied only when none of the four neighbor MBs
    feeding its intra prediction (left, above-left, above, above-right —
    all earlier in raster order) is itself a winner.  That suppression rule
    guarantees every applied MB's predictor pixels equal the decoder's
    state, so recon stays bit-exact, while all trials are independent —
    the torch backend runs them as one batched kernel."""
    mbc = mbw * mbh

    # pass 1: frozen-neighbor trials (scratch-restore keeps recon unchanged)
    win = np.zeros(mbc, dtype=bool)
    results = {}
    for mbn in range(mbc):
        if cur_fx[mbn] > tfx3:
            continue
        mby, mbx = divmod(mbn, mbw)
        ys, xs = slice(mby * 16, mby * 16 + 16), slice(mbx * 16, mbx * 16 + 16)
        yc, xc = slice(mby * 8, mby * 8 + 8), slice(mbx * 8, mbx * 8 + 8)
        save = (recon_y[ys, xs].copy(), recon_u[yc, xc].copy(),
                recon_v[yc, xc].copy())
        cur = int(cur_fx[mbn])
        best = None
        for sid in (2, 1, 0):   # AQ, HQ, UQ
            if cur > tfx3:
                break
            lv, md = SPEC_INTRA.encode_intra_mb(
                y, u, v, recon_y, recon_u, recon_v, mbx, mby, mbw,
                seg.y_dc_q[sid], seg.y_ac_q[sid],
                seg.uv_dc_q[sid], seg.uv_ac_q[sid])
            test = int(mb_ssim_fx_16x16(
                y[ys, xs][None], recon_y[ys, xs][None],
                u[yc, xc][None], recon_u[yc, xc][None],
                v[yc, xc][None], recon_v[yc, xc][None])[0])
            if test > cur:
                cur = test
                best = (sid, test, lv, md, recon_y[ys, xs].copy(),
                        recon_u[yc, xc].copy(), recon_v[yc, xc].copy())
            # restore the frozen recon for the next trial / next MB
            recon_y[ys, xs], recon_u[yc, xc], recon_v[yc, xc] = save
        if best is not None:
            win[mbn] = True
            results[mbn] = best

    # pass 2: suppression + apply
    replaced = 0
    for mbn, (sid, test, lv, md, sy, su, sv) in results.items():
        mby, mbx = divmod(mbn, mbw)
        conflict = (
            (mbx > 0 and win[mbn - 1])
            or (mby > 0 and mbx > 0 and win[mbn - mbw - 1])
            or (mby > 0 and win[mbn - mbw])
            or (mby > 0 and mbx < mbw - 1 and win[mbn - mbw + 1]))
        if conflict:
            continue
        cur_fx[mbn] = test
        levels[mbn] = lv
        levels[mbn, 24] = 0
        modes[mbn] = md
        parts[mbn] = ARE4X4
        segment_ids[mbn] = sid
        is_inter[mbn] = False
        ys, xs = slice(mby * 16, mby * 16 + 16), slice(mbx * 16, mbx * 16 + 16)
        yc, xc = slice(mby * 8, mby * 8 + 8), slice(mbx * 8, mbx * 8 + 8)
        recon_y[ys, xs] = sy
        recon_u[yc, xc] = su
        recon_v[yc, xc] = sv
        replaced += 1
    return replaced
