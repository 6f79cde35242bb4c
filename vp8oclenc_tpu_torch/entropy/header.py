"""VP8 frame header (first partition) writer.

Complete bitstream parity with the reference header coder
(reference entropy_host.cpp:709-1256): uncompressed frame tag,
keyframe start code/dims, segmentation block with absolute per-segment
quantizers and filter levels, filter/partition/quant fields, reference
refresh flags, token probability updates, skip prob, intra/last/gf probs,
per-frame MV probability adaptation, and all per-MB headers (segment id,
skip, ref selection, modes and motion vectors).
"""
from __future__ import annotations

import numpy as np

from vp8oclenc_tpu_torch import tables as TBL
from vp8oclenc_tpu_torch.entropy.boolcoder import BoolEncoder, BoolRecorder
from vp8oclenc_tpu_torch.entropy import mv as MV
from vp8oclenc_tpu_torch.tables import (ARE8X8, ARE16X16, ALTREF, B_DC_PRED,
                                  GOLDEN, LAST)


def _native():
    try:
        from vp8oclenc_tpu_torch.native import packer
        return packer if packer.available() else None
    except Exception:
        return None


def _write_tree(enc: BoolEncoder, probs, tree, bits: int, size: int) -> None:
    i = 0
    for s in range(size - 1, -1, -1):
        b = (bits >> s) & 1
        enc.put(int(probs[i >> 1]), b)
        i = int(tree[i + b])


def _write_quant_delta(enc: BoolEncoder, delta: int) -> None:
    if delta == 0:
        enc.put_flag(0)
    else:
        enc.put_flag(1)
        enc.put_literal(abs(delta), 4)
        enc.put_flag(1 if delta < 0 else 0)


def _segment_tree_probs(segment_ids: np.ndarray, mbc: int) -> np.ndarray:
    cnt = np.bincount(segment_ids, minlength=4)
    p = np.zeros(3, dtype=np.int64)
    p[0] = (cnt[0] + cnt[1]) * 255 // mbc
    d = max(int(cnt[0] + cnt[1]), 1)
    p[1] = cnt[0] * 255 // d
    d = max(int(cnt[2] + cnt[3]), 1)
    p[2] = cnt[2] * 255 // d
    return p.astype(np.uint8)


def encode_frame_header(fd, seg, cfg, width: int, height: int) -> bytes:
    """Encode the complete first partition (tag + header + per-MB headers).

    fd: FrameData-like object (see pipeline.encoder) with at least:
      is_key, is_golden, is_altref, segment_ids, skip (per-MB no-coeff flags),
      skip_prob, coeff_probs, coeff_update_flags, modes, parts, is_inter,
      ref_frame, mvs (mbc,4,2), replaced, mbw, mbh
    seg: SegmentData; cfg: EncoderConfig.
    """
    mbw, mbh = fd.mbw, fd.mbh
    mbc = mbw * mbh
    native = _native()
    enc = BoolRecorder()

    if fd.is_key:
        enc.put_flag(0)   # color space
        enc.put_flag(0)   # clamping type
    segmentation = not fd.is_key
    enc.put_flag(segmentation)
    seg_probs = None
    if segmentation:
        enc.put_flag(1)   # update_mb_segmentation_map
        enc.put_flag(1)   # update_segment_feature_data
        enc.put_flag(1)   # absolute values
        for i in range(4):
            enc.put_flag(1)
            enc.put_literal(int(seg.y_ac_i[i]), 7)
            enc.put_flag(0)
        for i in range(4):
            enc.put_flag(1)
            enc.put_literal(int(seg.loop_filter_level[i]), 6)
            enc.put_flag(0)
        seg_probs = _segment_tree_probs(fd.segment_ids, mbc)
        for i in range(3):
            enc.put_flag(1)
            enc.put_literal(int(seg_probs[i]), 8)

    enc.put_flag(cfg.loop_filter_type)
    enc.put_literal(int(seg.loop_filter_level[0]), 6)
    enc.put_literal(int(seg.sharpness), 3)
    enc.put_flag(0)   # loop_filter_adj_enable
    enc.put_literal(cfg.partitions_log2, 2)

    # quantizer block (segment 0 baseline; segments override absolutely)
    enc.put_literal(int(seg.y_ac_i[0]), 7)
    _write_quant_delta(enc, seg.y_dc_idelta)
    _write_quant_delta(enc, seg.y2_dc_idelta)
    _write_quant_delta(enc, seg.y2_ac_idelta)
    _write_quant_delta(enc, seg.uv_dc_idelta)
    _write_quant_delta(enc, seg.uv_ac_idelta)

    if fd.is_key:
        enc.put_flag(0)   # refresh_entropy_probs
    else:
        enc.put_flag(fd.is_golden)
        enc.put_flag(fd.is_altref)
        if not fd.is_golden:
            enc.put_literal(0, 2)   # copy_buffer_to_golden: none
        if not fd.is_altref:
            enc.put_literal(0, 2)   # copy_buffer_to_alternate: none
        enc.put_flag(0)   # sign_bias_golden
        enc.put_flag(0)   # sign_bias_alternate
        enc.put_flag(0)   # refresh_entropy_probs
        enc.put_flag(1)   # refresh_last

    # token probability updates
    upd = TBL.COEFF_UPDATE_PROBS
    flags = fd.coeff_update_flags
    probs = fd.coeff_probs
    for i in range(4):
        for j in range(8):
            for k in range(3):
                for l in range(11):
                    if flags[i, j, k, l]:
                        enc.put(int(upd[i, j, k, l]), 1)
                        enc.put_literal(int(probs[i, j, k, l]), 8)
                    else:
                        enc.put(int(upd[i, j, k, l]), 0)

    enc.put_flag(1)   # mb_no_skip_coeff
    enc.put_literal(int(fd.skip_prob), 8)

    new_mv_probs = None
    prob_intra = prob_last = prob_gf = None
    ymode_probs = TBL.YMODE_PROB
    uvmode_probs = TBL.UV_MODE_PROB
    census = None
    if not fd.is_key:
        replaced = int(fd.replaced)
        prob_intra = replaced * 255 // mbc
        if replaced > 0 and prob_intra < 2:
            prob_intra = 2
        if replaced < mbc and prob_intra > 254:
            prob_intra = 254
        n_last = int(np.sum(fd.ref_frame[fd.is_inter] == LAST)) \
            if np.any(fd.is_inter) else 0
        n_gf = int(np.sum(fd.ref_frame[fd.is_inter] == GOLDEN)) \
            if np.any(fd.is_inter) else 0
        prob_gf = np.clip((n_gf * 256) // (mbc - n_last + 1), 1, 255)
        prob_last = np.clip((n_last * 256) // mbc, 1, 255)
        enc.put_literal(int(prob_intra), 8)
        enc.put_literal(int(prob_last), 8)
        enc.put_literal(int(prob_gf), 8)
        if replaced > 7:
            # pin intra modes: ymode probs force B_PRED, uv probs force TM
            enc.put_flag(1)
            for _ in range(4):
                enc.put_literal(0, 8)
            enc.put_flag(1)
            for _ in range(3):
                enc.put_literal(0, 8)
            ymode_probs = np.zeros(4, dtype=np.uint8)
            uvmode_probs = np.zeros(3, dtype=np.uint8)
        else:
            enc.put_flag(0)
            enc.put_flag(0)

        # MV prob adaptation: census + count pass over all NEW-MV deltas
        census = MV.find_near_mvs(fd.mvs[:, 3, :], fd.is_inter, fd.parts, mbw, mbh)
        if native is not None:
            num, den = native.mb_headers(0, fd, None, 0, 0, 0, 0, census,
                                         None, ymode_probs, uvmode_probs)
        else:
            deltas = _collect_new_mv_deltas(fd, census)
            num, den = MV.count_mv_components(deltas)
        new_mv_probs = MV.adapt_mv_probs(num, den)
        for i in range(2):
            for j in range(19):
                enc.put(int(TBL.VP8_MV_UPDATE_PROBS[i, j]), 1)
                enc.put_literal(int(new_mv_probs[i, j]) >> 1, 7)

    # ---- per-MB headers ----
    if native is not None:
        mb_p, mb_b = native.mb_headers(
            1, fd, seg_probs, int(fd.skip_prob),
            prob_intra, prob_last, prob_gf, census, new_mv_probs,
            ymode_probs, uvmode_probs)
        enc.put_arrays(mb_p, mb_b)
    else:
        _encode_mb_headers(enc, fd, seg_probs, prob_intra, prob_last, prob_gf,
                           ymode_probs, uvmode_probs, census, new_mv_probs)

    body = enc.pack()

    # uncompressed frame tag
    first_part_size = len(body)
    tag = (0 if fd.is_key else 1) | (0 << 1) | 0x10 | (first_part_size << 5)
    head = bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
    if fd.is_key:
        head += bytes([0x9D, 0x01, 0x2A,
                       width & 0xFF, (width >> 8) & 0x3F,
                       height & 0xFF, (height >> 8) & 0x3F])
    return head + body


# the frame tag's first-partition size field has 19 bits
FIRST_PARTITION_LIMIT = 1 << 19


def tag_first_partition_size(frame: bytes) -> int:
    """The first partition's size as a frame's tag states it: bits 5..23
    of the 3-byte tag, so a partition of FIRST_PARTITION_LIMIT bytes or
    more is stated modulo that limit (the writer above, like the JAX
    package's, does not refuse one)."""
    return (frame[0] | frame[1] << 8 | frame[2] << 16) >> 5


def _collect_new_mv_deltas(fd, census) -> np.ndarray:
    """All MV deltas that will be coded as NEW (16x16 NEWMV or SPLITMV NEW4x4)."""
    deltas = []
    mbw = fd.mbw
    nearest, near, best = census["nearest_raw"], census["near_raw"], census["best_raw"]
    bestv = census["best"]
    for mbn in np.nonzero(fd.is_inter)[0]:
        raw = MV._pack(fd.mvs[mbn, 3, :][None])[0]
        if fd.parts[mbn] == ARE16X16:
            if raw != 0 and raw != nearest[mbn] and raw != near[mbn]:
                deltas.append(fd.mvs[mbn, 3, :] - bestv[mbn])
        else:  # SPLITMV quarters
            for b in range(4):
                left_mv, above_mv = _sub_mv_neighbors(fd, mbn, b, mbw)
                this = fd.mvs[mbn, b, :]
                traw = MV._pack(this[None])[0]
                if (traw != MV._pack(left_mv[None])[0]
                        and traw != MV._pack(above_mv[None])[0]
                        and traw != 0):
                    deltas.append(this - bestv[mbn])
    if not deltas:
        return np.zeros((0, 2), dtype=np.int64)
    return np.stack(deltas).astype(np.int64)


def _sub_mv_neighbors(fd, mbn: int, b: int, mbw: int):
    """left/above quarter MVs for SPLITMV sub-mode contexts
    (entropy_host.cpp:336-366)."""
    b_row, b_col = b // 2, b % 2
    if b_col > 0:
        left = fd.mvs[mbn, b - 1, :]
    elif mbn % mbw > 0 and fd.is_inter[mbn - 1]:
        left = fd.mvs[mbn - 1, b + 1, :]
    else:
        left = np.zeros(2, dtype=np.int32)
    if b_row > 0:
        above = fd.mvs[mbn, b - 2, :]
    elif mbn >= mbw and fd.is_inter[mbn - mbw]:
        above = fd.mvs[mbn - mbw, b + 2, :]
    else:
        above = np.zeros(2, dtype=np.int32)
    return left, above


def _write_mv(enc: BoolEncoder, delta, probs: np.ndarray) -> None:
    """Write one MV delta: y (row, context 0) then x (column, context 1)."""
    for comp, row in ((1, 0), (0, 1)):
        ps, bs = MV.mv_component_bools(int(delta[comp]), probs[row])
        for p, b in zip(ps, bs):
            enc.put(int(p), b)


def _encode_mb_headers(enc, fd, seg_probs, prob_intra, prob_last, prob_gf,
                       ymode_probs, uvmode_probs, census, new_mv_probs) -> None:
    mbw, mbh = fd.mbw, fd.mbh
    mbc = mbw * mbh
    modes = fd.modes
    for mbn in range(mbc):
        if seg_probs is not None:
            _write_tree(enc, seg_probs, TBL.MB_SEGMENT_TREE,
                        int(fd.segment_ids[mbn]), 2)
        enc.put(int(fd.skip_prob), 1 if fd.skip[mbn] else 0)
        if not fd.is_key:
            enc.put(prob_intra, 1 if fd.is_inter[mbn] else 0)
        if (not fd.is_key) and fd.is_inter[mbn]:
            ref = int(fd.ref_frame[mbn])
            enc.put(int(prob_last), 0 if ref == LAST else 1)
            if ref != LAST:
                enc.put(int(prob_gf), 1 if ref == ALTREF else 0)
            _encode_inter_modes_and_mvs(enc, fd, mbn, census, new_mv_probs)
        elif fd.is_key:
            # kf: ymode B_PRED ("0" under kf tree), bmodes with kf contexts, uv TM
            _write_tree(enc, TBL.KF_YMODE_PROB, TBL.KF_YMODE_TREE, 0, 1)
            for b in range(16):
                if mbn < mbw and b < 4:
                    ctx_a = B_DC_PRED
                else:
                    src = mbn - mbw if b < 4 else mbn
                    ctx_a = int(modes[src, b + 12 if b < 4 else b - 4])
                if mbn % mbw == 0 and (b & 3) == 0:
                    ctx_l = B_DC_PRED
                else:
                    src = mbn - 1 if (b & 3) == 0 else mbn
                    ctx_l = int(modes[src, b + 3 if (b & 3) == 0 else b - 1])
                m = int(modes[mbn, b])
                _write_tree(enc, TBL.KF_BMODE_PROB[ctx_a, ctx_l], TBL.BMODE_TREE,
                            int(TBL.BMODE_BITS[m]), int(TBL.BMODE_SIZE[m]))
            _write_tree(enc, TBL.KF_UV_MODE_PROB, TBL.UV_MODE_TREE, 7, 3)
        else:
            # intra MB in inter frame: ymode B_PRED ("111"), context-free bmodes
            _write_tree(enc, ymode_probs, TBL.YMODE_TREE, 7, 3)
            for b in range(16):
                m = int(modes[mbn, b])
                _write_tree(enc, TBL.BMODE_PROB, TBL.BMODE_TREE,
                            int(TBL.BMODE_BITS[m]), int(TBL.BMODE_SIZE[m]))
            _write_tree(enc, uvmode_probs, TBL.UV_MODE_TREE, 7, 3)


def _encode_inter_modes_and_mvs(enc, fd, mbn, census, new_mv_probs) -> None:
    mode_probs = census["mode_probs"][mbn]
    nearest, near = census["nearest_raw"][mbn], census["near_raw"][mbn]
    best = census["best"][mbn]
    raw = MV._pack(fd.mvs[mbn, 3, :][None])[0]
    if fd.parts[mbn] == ARE8X8:
        # SPLITMV ("1111"), split type QUARTERS ("10")
        _write_tree(enc, mode_probs, TBL.MV_REF_TREE, 15, 4)
        _write_tree(enc, TBL.SPLIT_MV_PROBS, TBL.SPLIT_MV_TREE, 2, 2)
        for b in range(4):
            left_mv, above_mv = _sub_mv_neighbors(fd, mbn, b, fd.mbw)
            lraw = MV._pack(left_mv[None])[0]
            araw = MV._pack(above_mv[None])[0]
            this = fd.mvs[mbn, b, :]
            traw = MV._pack(this[None])[0]
            lez, aez, lea = lraw == 0, araw == 0, lraw == araw
            if lea and lez:
                ctx = 4
            elif lea:
                ctx = 3
            elif aez:
                ctx = 2
            elif lez:
                ctx = 1
            else:
                ctx = 0
            sp = TBL.SUBMV_REF_PROBS2[ctx]
            if traw == lraw:
                _write_tree(enc, sp, TBL.SUBMV_REF_TREE, 0, 1)       # LEFT
            elif traw == araw:
                _write_tree(enc, sp, TBL.SUBMV_REF_TREE, 2, 2)       # ABOVE
            elif traw == 0:
                _write_tree(enc, sp, TBL.SUBMV_REF_TREE, 6, 3)       # ZERO
            else:
                _write_tree(enc, sp, TBL.SUBMV_REF_TREE, 7, 3)       # NEW
                _write_mv(enc, this - best, new_mv_probs)
    else:  # ARE16X16
        if raw == 0:
            _write_tree(enc, mode_probs, TBL.MV_REF_TREE, 0, 1)      # ZEROMV
        elif raw == nearest:
            _write_tree(enc, mode_probs, TBL.MV_REF_TREE, 2, 2)      # NEARESTMV
        elif raw == near:
            _write_tree(enc, mode_probs, TBL.MV_REF_TREE, 6, 3)      # NEARMV
        else:
            _write_tree(enc, mode_probs, TBL.MV_REF_TREE, 14, 4)     # NEWMV
            _write_mv(enc, fd.mvs[mbn, 3, :] - best, new_mv_probs)
