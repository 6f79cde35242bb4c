"""VP8 decoder — the framework's bitstream-validity oracle.

Implements RFC 6386 decoding for the feature set the encoder emits (keyframes
with B_PRED/TM_PRED, interframes with segmentation, LAST/GOLDEN/ALTREF,
ZERO/NEAREST/NEAR/NEW/SPLITMV-quarters motion, 1-8 token partitions, normal
loop filter).  A stream is valid iff this decoder's reconstruction equals the
encoder's — the automated version of the reference's dump()-and-diff oracle
(reference debug.h:8-37, README.md:20-21).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vp8oclenc_tpu_torch import tables as TBL
from vp8oclenc_tpu_torch.decoder import primitives as PRIM
from vp8oclenc_tpu_torch.decoder.primitives import RangeDecoder as BoolDecoder
from vp8oclenc_tpu_torch.tables import (
    ALTREF, ARE4X4, ARE8X8, ARE16X16, CAT_BASE, CAT_NBITS, COEFF_BANDS,
    COEFF_TREE, DCT_EOB, DCT_0, GOLDEN, LAST, MVP_BITS, MVP_IS_SHORT,
    MVP_SHORT, MVP_SIGN, MV_LONG_WIDTH, SIXTAP_FILTERS, SMALL_MV_TREE)


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    is_key: bool


def _read_mv_component(bd: BoolDecoder, probs) -> int:
    if bd.get(int(probs[MVP_IS_SHORT])):
        # long: bits 0..2, 9..4, then 3 (implicit 1 if high bits all zero)
        a = 0
        for i in range(3):
            a |= bd.get(int(probs[MVP_BITS + i])) << i
        for i in range(MV_LONG_WIDTH - 1, 3, -1):
            a |= bd.get(int(probs[MVP_BITS + i])) << i
        if a & 0xFFF0:
            a |= bd.get(int(probs[MVP_BITS + 3])) << 3
        else:
            a |= 8
        return -a if bd.get(int(probs[MVP_SIGN])) else a
    a = bd.get_tree(SMALL_MV_TREE, probs[MVP_SHORT:])
    if a == 0:
        return 0
    return -a if bd.get(int(probs[MVP_SIGN])) else a


def _read_mv(bd: BoolDecoder, mv_probs) -> np.ndarray:
    y = _read_mv_component(bd, mv_probs[0])
    x = _read_mv_component(bd, mv_probs[1])
    return np.array([x, y], dtype=np.int32)


def _sixtap_patch(ref: np.ndarray, x0: int, y0: int, px: int, py: int,
                  size: int) -> np.ndarray:
    """Six-tap interpolated size x size patch at full-pel (x0, y0) with
    eighth-pel phases (px, py); edges clamped (RFC 6386 §18.3)."""
    H, W = ref.shape
    ys = np.clip(np.arange(y0 - 2, y0 + size + 3), 0, H - 1)
    xs = np.clip(np.arange(x0 - 2, x0 + size + 3), 0, W - 1)
    patch = ref[np.ix_(ys, xs)].astype(np.int64)
    fx = SIXTAP_FILTERS[px]
    h = np.zeros((size + 5, size), dtype=np.int64)
    for k in range(6):
        h += patch[:, k:k + size] * fx[k]
    h = np.clip((h + 64) >> 7, 0, 255)
    fy = SIXTAP_FILTERS[py]
    v = np.zeros((size, size), dtype=np.int64)
    for k in range(6):
        v += h[k:k + size, :] * fy[k]
    v = np.clip((v + 64) >> 7, 0, 255)
    return v.astype(np.int32)


class VP8Decoder:
    def __init__(self) -> None:
        self.last = None       # (y, u, v) uint8 planes, padded
        self.golden = None
        self.altref = None
        self.width = self.height = 0
        self.wrk_w = self.wrk_h = 0

    # ------------------------------------------------------------------
    def decode_frame(self, data: bytes) -> DecodedFrame:
        tag = data[0] | (data[1] << 8) | (data[2] << 16)
        is_key = (tag & 1) == 0
        first_part_size = tag >> 5
        pos = 3
        if is_key:
            assert data[3:6] == b"\x9d\x01\x2a", "bad start code"
            w = data[6] | ((data[7] & 0x3F) << 8)
            h = data[8] | ((data[9] & 0x3F) << 8)
            self.width, self.height = w, h
            self.wrk_w, self.wrk_h = (w + 15) & ~15, (h + 15) & ~15
            pos = 10
        mbw, mbh = self.wrk_w // 16, self.wrk_h // 16
        mbc = mbw * mbh

        bd = BoolDecoder(data[pos:pos + first_part_size])

        if is_key:
            assert bd.get_flag() == 0, "unsupported color space"
            bd.get_flag()   # clamping type

        # --- segmentation ---
        seg_enabled = bd.get_flag()
        seg_abs = True
        seg_qi = np.zeros(4, dtype=np.int32)
        seg_lf = np.zeros(4, dtype=np.int32)
        seg_tree_probs = np.full(3, 255, dtype=np.uint8)
        update_map = False
        if seg_enabled:
            update_map = bool(bd.get_flag())
            update_data = bool(bd.get_flag())
            if update_data:
                seg_abs = bool(bd.get_flag())
                assert seg_abs, "delta segment features unsupported"
                for i in range(4):
                    if bd.get_flag():
                        seg_qi[i] = bd.get_literal(7)
                        if bd.get_flag():
                            seg_qi[i] = -seg_qi[i]
                for i in range(4):
                    if bd.get_flag():
                        seg_lf[i] = bd.get_literal(6)
                        if bd.get_flag():
                            seg_lf[i] = -seg_lf[i]
            if update_map:
                for i in range(3):
                    if bd.get_flag():
                        seg_tree_probs[i] = bd.get_literal(8)

        # --- filter ---
        filter_type = bd.get_flag()
        filter_level = bd.get_literal(6)
        sharpness = bd.get_literal(3)
        assert bd.get_flag() == 0, "lf delta adjustments unsupported"

        num_parts = 1 << bd.get_literal(2)

        # --- quantizers ---
        y_ac_qi = bd.get_literal(7)

        def qdelta():
            if bd.get_flag():
                v = bd.get_literal(4)
                return -v if bd.get_flag() else v
            return 0

        y_dc_d, y2_dc_d, y2_ac_d, uv_dc_d, uv_ac_d = (qdelta() for _ in range(5))

        if is_key:
            bd.get_flag()   # refresh_entropy_probs
            refresh_golden = refresh_alt = True
        else:
            refresh_golden = bool(bd.get_flag())
            refresh_alt = bool(bd.get_flag())
            if not refresh_golden:
                assert bd.get_literal(2) == 0, "golden copy unsupported"
            if not refresh_alt:
                assert bd.get_literal(2) == 0, "altref copy unsupported"
            bd.get_flag()   # sign_bias_golden
            bd.get_flag()   # sign_bias_altref
            bd.get_flag()   # refresh_entropy
            assert bd.get_flag() == 1, "refresh_last=0 unsupported"

        # --- token prob updates (baseline = defaults; we never refresh) ---
        coeff_probs = TBL.DEFAULT_COEFF_PROBS.copy()
        for i in range(4):
            for j in range(8):
                for k in range(3):
                    for l in range(11):
                        if bd.get(int(TBL.COEFF_UPDATE_PROBS[i, j, k, l])):
                            coeff_probs[i, j, k, l] = bd.get_literal(8)

        mb_no_skip = bd.get_flag()
        skip_prob = bd.get_literal(8) if mb_no_skip else 0

        ymode_probs = TBL.YMODE_PROB.copy()
        uvmode_probs = TBL.UV_MODE_PROB.copy()
        mv_probs = TBL.DEFAULT_MV_CONTEXT.copy()
        prob_intra = prob_last = prob_gf = 0
        if not is_key:
            prob_intra = bd.get_literal(8)
            prob_last = bd.get_literal(8)
            prob_gf = bd.get_literal(8)
            if bd.get_flag():
                for i in range(4):
                    ymode_probs[i] = bd.get_literal(8)
            if bd.get_flag():
                for i in range(3):
                    uvmode_probs[i] = bd.get_literal(8)
            for i in range(2):
                for j in range(19):
                    if bd.get(int(TBL.VP8_MV_UPDATE_PROBS[i, j])):
                        p = bd.get_literal(7) << 1
                        mv_probs[i, j] = p if p else 1

        # --- per-MB headers ---
        seg_ids = np.zeros(mbc, dtype=np.int32)
        skip = np.zeros(mbc, dtype=bool)
        is_inter = np.zeros(mbc, dtype=bool)
        ref_frame = np.full(mbc, LAST, dtype=np.int32)
        parts = np.full(mbc, ARE4X4, dtype=np.int32)
        bmodes = np.zeros((mbc, 16), dtype=np.int32)
        mvs = np.zeros((mbc, 4, 2), dtype=np.int32)

        for mbn in range(mbc):
            if seg_enabled and update_map:
                seg_ids[mbn] = bd.get_tree(TBL.MB_SEGMENT_TREE, seg_tree_probs)
            if mb_no_skip:
                skip[mbn] = bool(bd.get(skip_prob))
            if not is_key:
                is_inter[mbn] = bool(bd.get(prob_intra))
            if is_inter[mbn]:
                if bd.get(prob_last):
                    ref_frame[mbn] = ALTREF if bd.get(prob_gf) else GOLDEN
                self._decode_inter_modes(bd, mbn, mbw, parts, bmodes, mvs,
                                         is_inter, ref_frame, mv_probs)
            else:
                if is_key:
                    ym = bd.get_tree(TBL.KF_YMODE_TREE, TBL.KF_YMODE_PROB)
                    assert ym == TBL.B_PRED, f"unsupported intra ymode {ym}"
                    for b in range(16):
                        if mbn < mbw and b < 4:
                            ca = TBL.B_DC_PRED
                        else:
                            src = mbn - mbw if b < 4 else mbn
                            ca = int(bmodes[src, b + 12 if b < 4 else b - 4])
                        if mbn % mbw == 0 and (b & 3) == 0:
                            cl = TBL.B_DC_PRED
                        else:
                            src = mbn - 1 if (b & 3) == 0 else mbn
                            cl = int(bmodes[src, b + 3 if (b & 3) == 0 else b - 1])
                        bmodes[mbn, b] = bd.get_tree(
                            TBL.BMODE_TREE, TBL.KF_BMODE_PROB[ca, cl])
                    uvm = bd.get_tree(TBL.UV_MODE_TREE, TBL.KF_UV_MODE_PROB)
                    assert uvm == TBL.TM_PRED, f"unsupported uv mode {uvm}"
                else:
                    ym = bd.get_tree(TBL.YMODE_TREE, ymode_probs)
                    assert ym == TBL.B_PRED, f"unsupported inter-frame intra ymode {ym}"
                    for b in range(16):
                        bmodes[mbn, b] = bd.get_tree(TBL.BMODE_TREE, TBL.BMODE_PROB)
                    uvm = bd.get_tree(TBL.UV_MODE_TREE, uvmode_probs)
                    assert uvm == TBL.TM_PRED, f"unsupported uv mode {uvm}"
                parts[mbn] = ARE4X4

        # --- residual partitions ---
        body = data[pos + first_part_size:]
        part_sizes = []
        off = 3 * (num_parts - 1)
        for p in range(num_parts - 1):
            s = body[p * 3] | (body[p * 3 + 1] << 8) | (body[p * 3 + 2] << 16)
            part_sizes.append(s)
        part_sizes.append(len(body) - off - sum(part_sizes))
        bds = []
        for p in range(num_parts):
            bds.append(BoolDecoder(body[off:off + part_sizes[p]]))
            off += part_sizes[p]

        levels = self._decode_coefficients(
            bds, num_parts, mbw, mbh, parts, skip, coeff_probs)

        # --- reconstruction ---
        qs = PRIM.quantizers_from_indices(
            seg_qi if seg_enabled else np.full(4, y_ac_qi, dtype=np.int32),
            y_dc_d, y2_dc_d, y2_ac_d, uv_dc_d, uv_ac_d)
        recon = self._reconstruct(levels, parts, seg_ids, bmodes, mvs,
                                  is_inter, ref_frame, qs, mbw, mbh)

        # --- loop filter ---
        lf_levels = seg_lf if seg_enabled else np.full(4, filter_level, np.int32)
        if filter_type == 0 and np.any(lf_levels > 0):
            interior, mbe, sbe, hev = PRIM.filter_limits_from_levels(
                lf_levels, sharpness, is_key)
            inner = (parts != ARE16X16) | (~skip)
            for plane, msz in ((recon[0], 16), (recon[1], 8), (recon[2], 8)):
                PRIM.loop_filter(plane, msz, seg_ids, inner, lf_levels,
                                 mbe, sbe, interior, hev)

        if is_key or True:   # refresh_last is always 1 in our streams
            self.last = recon
        if refresh_golden:
            self.golden = tuple(p.copy() for p in recon)
        if refresh_alt:
            self.altref = tuple(p.copy() for p in recon)
        return DecodedFrame(recon[0], recon[1], recon[2], is_key)

    # ------------------------------------------------------------------
    def _decode_inter_modes(self, bd, mbn, mbw, parts, bmodes, mvs,
                            is_inter, ref_frame, mv_probs) -> None:
        # census over already-decoded neighbors (raster order guarantees
        # above/left/above-left are final before this MB)
        mbx_, mby_ = mbn % mbw, mbn // mbw
        best, nearest_mv, near_mv, probs = PRIM.near_mv_census(
            mvs[:, 3, :], is_inter, parts != ARE16X16, mbx_, mby_, mbw)
        mode = bd.get_tree(TBL.MV_REF_TREE, probs)
        if mode == TBL.ZEROMV:
            parts[mbn] = ARE16X16
            mvs[mbn, :, :] = 0
        elif mode == TBL.NEARESTMV:
            parts[mbn] = ARE16X16
            mvs[mbn, :, :] = nearest_mv
        elif mode == TBL.NEARMV:
            parts[mbn] = ARE16X16
            mvs[mbn, :, :] = near_mv
        elif mode == TBL.NEWMV:
            parts[mbn] = ARE16X16
            mvs[mbn, :, :] = best + _read_mv(bd, mv_probs)
        else:  # SPLITMV
            parts[mbn] = ARE8X8
            split = bd.get_tree(TBL.SPLIT_MV_TREE, TBL.SPLIT_MV_PROBS)
            assert split == TBL.MV_QUARTERS, f"unsupported split {split}"
            for b in range(4):
                b_row, b_col = b // 2, b % 2
                if b_col > 0:
                    left = mvs[mbn, b - 1]
                elif mbn % mbw > 0 and is_inter[mbn - 1]:
                    left = mvs[mbn - 1, b + 1]
                else:
                    left = np.zeros(2, dtype=np.int32)
                if b_row > 0:
                    above = mvs[mbn, b - 2]
                elif mbn >= mbw and is_inter[mbn - mbw]:
                    above = mvs[mbn - mbw, b + 2]
                else:
                    above = np.zeros(2, dtype=np.int32)
                lez = not left.any()
                aez = not above.any()
                lea = bool((left == above).all())
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
                sm = bd.get_tree(TBL.SUBMV_REF_TREE, TBL.SUBMV_REF_PROBS2[ctx])
                if sm == TBL.LEFT4X4:
                    mvs[mbn, b] = left
                elif sm == TBL.ABOVE4X4:
                    mvs[mbn, b] = above
                elif sm == TBL.ZERO4X4:
                    mvs[mbn, b] = 0
                else:
                    mvs[mbn, b] = best + _read_mv(bd, mv_probs)

    # ------------------------------------------------------------------
    def _decode_coefficients(self, bds, num_parts, mbw, mbh, parts, skip,
                             coeff_probs):
        mbc = mbw * mbh
        levels = np.zeros((mbc, 25, 16), dtype=np.int16)
        # persistent above contexts; per-row left contexts
        above_y = np.zeros((mbw, 4), dtype=np.int32)
        above_u = np.zeros((mbw, 2), dtype=np.int32)
        above_v = np.zeros((mbw, 2), dtype=np.int32)
        above_y2 = np.zeros(mbw, dtype=np.int32)

        def decode_block(bd, out, ctx1, first, ctx3):
            i = first
            ctx4 = 0
            nz = 0
            while i < 16:
                band = COEFF_BANDS[i]
                p = coeff_probs[ctx1, band, ctx3]
                tok = bd.get_tree(COEFF_TREE, p, start=ctx4)
                if tok == DCT_EOB:
                    break
                if tok == DCT_0:
                    out[i] = 0
                    ctx3 = 0
                    ctx4 = 2   # next token cannot be EOB; implicit leading ONE
                    i += 1
                    continue
                ctx4 = 0
                if tok <= 4:
                    val = tok
                else:
                    cat = tok - 5
                    extra = 0
                    for pb in TBL.PCATS[cat]:
                        extra = (extra << 1) | bd.get(int(pb))
                    val = int(CAT_BASE[cat]) + extra
                if bd.get(128):
                    val = -val
                out[i] = val
                ctx3 = 1 if tok == 1 else 2
                nz = 1 if i >= first else nz
                i += 1
            return int(np.any(out[first:] != 0))

        for mby in range(mbh):
            bd = bds[mby % num_parts]
            left_y = np.zeros(4, dtype=np.int32)
            left_u = np.zeros(2, dtype=np.int32)
            left_v = np.zeros(2, dtype=np.int32)
            left_y2 = 0
            for mbx in range(mbw):
                mbn = mby * mbw + mbx
                has_y2 = parts[mbn] == ARE16X16
                if skip[mbn]:
                    left_y[:] = 0
                    above_y[mbx, :] = 0
                    left_u[:] = 0
                    above_u[mbx, :] = 0
                    left_v[:] = 0
                    above_v[mbx, :] = 0
                    if has_y2:
                        left_y2 = 0
                        above_y2[mbx] = 0
                    continue
                if has_y2:
                    ctx3 = above_y2[mbx] + left_y2
                    nz = decode_block(bd, levels[mbn, 24], 1, 0, ctx3)
                    above_y2[mbx] = nz
                    left_y2 = nz
                    first, ctx1 = 1, 0
                else:
                    first, ctx1 = 0, 3
                for b in range(16):
                    br, bc = b // 4, b % 4
                    ctx3 = above_y[mbx, bc] + left_y[br]
                    nz = decode_block(bd, levels[mbn, b], ctx1, first, ctx3)
                    above_y[mbx, bc] = nz
                    left_y[br] = nz
                for b in range(4):
                    br, bc = b // 2, b % 2
                    ctx3 = above_u[mbx, bc] + left_u[br]
                    nz = decode_block(bd, levels[mbn, 16 + b], 2, 0, ctx3)
                    above_u[mbx, bc] = nz
                    left_u[br] = nz
                for b in range(4):
                    br, bc = b // 2, b % 2
                    ctx3 = above_v[mbx, bc] + left_v[br]
                    nz = decode_block(bd, levels[mbn, 20 + b], 2, 0, ctx3)
                    above_v[mbx, bc] = nz
                    left_v[br] = nz
        return levels

    # ------------------------------------------------------------------
    def _reconstruct(self, levels, parts, seg_ids, bmodes, mvs, is_inter,
                     ref_frame, qs, mbw, mbh):
        y_dc_q, y_ac_q, y2_dc_q, y2_ac_q, uv_dc_q, uv_ac_q = qs
        H, W = self.wrk_h, self.wrk_w
        ry = np.zeros((H, W), dtype=np.uint8)
        ru = np.zeros((H // 2, W // 2), dtype=np.uint8)
        rv = np.zeros((H // 2, W // 2), dtype=np.uint8)
        refs = {LAST: self.last, GOLDEN: self.golden, ALTREF: self.altref}

        for mby in range(mbh):
            for mbx in range(mbw):
                mbn = mby * mbw + mbx
                sid = int(seg_ids[mbn])
                if is_inter[mbn]:
                    self._recon_inter_mb(ry, ru, rv, refs[int(ref_frame[mbn])],
                                         levels[mbn], int(parts[mbn]),
                                         mvs[mbn], mbx, mby,
                                         int(y_dc_q[sid]), int(y_ac_q[sid]),
                                         int(y2_dc_q[sid]), int(y2_ac_q[sid]),
                                         int(uv_dc_q[sid]), int(uv_ac_q[sid]))
                else:
                    self._recon_intra_mb(ry, ru, rv, levels[mbn],
                                         bmodes[mbn], mbx, mby, mbw,
                                         int(y_dc_q[sid]), int(y_ac_q[sid]),
                                         int(uv_dc_q[sid]), int(uv_ac_q[sid]))
        return [ry, ru, rv]

    def _recon_intra_mb(self, ry, ru, rv, lv, modes, mbx, mby, mbw,
                        y_dc_q, y_ac_q, uv_dc_q, uv_ac_q) -> None:
        w4 = mbw * 4
        for b in range(16):
            br, bc = b // 4, b % 4
            bx, by = mbx * 4 + bc, mby * 4 + br
            A, L, P = PRIM.block_neighbors(ry, bx, by, w4)
            pred = PRIM.predict_b_mode(int(modes[b]), A, L, P)
            dq = PRIM.dequantize(PRIM.unzigzag(lv[b].astype(np.int32)),
                                 y_dc_q, y_ac_q)
            rec = np.clip(PRIM.idct_4x4(dq) + pred, 0, 255)
            ry[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = rec.astype(np.uint8)
        for plane, off, out in ((0, 16, ru), (1, 20, rv)):
            x, y = mbx * 8, mby * 8
            top = np.full(8, 127, np.int32) if mby == 0 else \
                out[y - 1, x:x + 8].astype(np.int32)
            left = np.full(8, 129, np.int32) if mbx == 0 else \
                out[y:y + 8, x - 1].astype(np.int32)
            if mby == 0:
                tl = np.int32(127)
            elif mbx == 0:
                tl = np.int32(129)
            else:
                tl = out[y - 1, x - 1].astype(np.int32)
            pred = PRIM.predict_tm_8x8(top, left, tl)
            dq = PRIM.dequantize(PRIM.unzigzag(lv[off:off + 4].astype(np.int32)),
                                 uv_dc_q, uv_ac_q)
            res = PRIM.idct_4x4(dq)                  # (4,4,4) blocks
            res88 = res.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
            out[y:y + 8, x:x + 8] = np.clip(pred + res88, 0, 255).astype(np.uint8)

    def _recon_inter_mb(self, ry, ru, rv, ref, lv, part, mv4, mbx, mby,
                        y_dc_q, y_ac_q, y2_dc_q, y2_ac_q, uv_dc_q, uv_ac_q) -> None:
        has_y2 = part == ARE16X16
        dq = PRIM.dequantize(PRIM.unzigzag(lv[:16].astype(np.int32)),
                             y_dc_q, y_ac_q)
        if has_y2:
            y2dq = PRIM.dequantize(PRIM.unzigzag(lv[24].astype(np.int32)),
                                   y2_dc_q, y2_ac_q)
            dcs = PRIM.iwht_4x4(y2dq)                # (4,4)
            dq[:, 0, 0] = dcs.reshape(16)
        res = PRIM.idct_4x4(dq)                      # (16,4,4)
        # luma MC per 4x4, quarter vectors
        for b in range(16):
            br, bc = b // 4, b % 4
            q = (br // 2) * 2 + (bc // 2)
            vx, vy = int(mv4[q, 0]), int(mv4[q, 1])
            px_abs = (mbx * 16 + bc * 4) * 4 + vx
            py_abs = (mby * 16 + br * 4) * 4 + vy
            pred = _sixtap_patch(ref[0], px_abs // 4, py_abs // 4,
                                 (px_abs % 4) * 2, (py_abs % 4) * 2, 4)
            y0, x0 = mby * 16 + br * 4, mbx * 16 + bc * 4
            ry[y0:y0 + 4, x0:x0 + 4] = np.clip(pred + res[b], 0, 255).astype(np.uint8)
        # chroma MC per 4x4, eighth-pel
        for plane, off, out, refp in ((0, 16, ru, ref[1]), (1, 20, rv, ref[2])):
            dqc = PRIM.dequantize(PRIM.unzigzag(lv[off:off + 4].astype(np.int32)),
                                  uv_dc_q, uv_ac_q)
            resc = PRIM.idct_4x4(dqc)
            for b in range(4):
                br, bc = b // 2, b % 2
                vx, vy = int(mv4[b, 0]), int(mv4[b, 1])
                px_abs = (mbx * 8 + bc * 4) * 8 + vx
                py_abs = (mby * 8 + br * 4) * 8 + vy
                pred = _sixtap_patch(refp, px_abs // 8, py_abs // 8,
                                     px_abs % 8, py_abs % 8, 4)
                y0, x0 = mby * 8 + br * 4, mbx * 8 + bc * 4
                out[y0:y0 + 4, x0:x0 + 4] = \
                    np.clip(pred + resc[b], 0, 255).astype(np.uint8)
