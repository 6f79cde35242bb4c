"""Decoder-side primitives — independent of the encoder's spec/ modules.

The decoder is the framework's bitstream oracle: if it shared the encoder's
inverse transforms / predictors / loop filter / bool coder, a transcription
bug in those would cancel out and every "bit-exact round trip" test would
pass vacuously.  Everything here
is therefore implemented from the RFC 6386 pseudo-code directly — literal
per-edge/per-coefficient transcriptions, structured differently from the
encoder's vectorized formulations — and shares ONLY the normative constant
tables (vp8oclenc_tpu_torch.tables).

RFC references: bool decoder §7.3, quantizer derivation §9.6 + §14.1,
inverse DCT/WHT §14.3-§14.4, intra prediction §12.2-§12.3, loop filter §15.
"""
from __future__ import annotations

import numpy as np

from vp8oclenc_tpu_torch import tables as TBL


# ---------------------------------------------------------------------------
# boolean (arithmetic) decoder — RFC 6386 §7.3 bool_decoder
# ---------------------------------------------------------------------------

class RangeDecoder:
    """Literal transcription of the RFC's bool_decoder (value/range/bitcount)."""

    def __init__(self, buf: bytes) -> None:
        self._b = bytes(buf)
        self._pos = 2
        self.value = (self._byte(0) << 8) | self._byte(1)
        self.range = 255
        self.bit_count = 0

    def _byte(self, i: int) -> int:
        return self._b[i] if i < len(self._b) else 0

    def get(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        SPLIT = split << 8
        if self.value >= SPLIT:
            ret = 1
            self.range -= split
            self.value -= SPLIT
        else:
            ret = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self.value |= self._byte(self._pos)
                self._pos += 1
            self.value &= 0xFFFF
        return ret

    def get_flag(self) -> int:
        return self.get(128)

    def get_literal(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.get(128)
        return v

    def get_signed_literal(self, nbits: int) -> int:
        v = self.get_literal(nbits)
        if v and self.get(128):
            v = -v
        return v

    def get_tree(self, tree, probs, start: int = 0) -> int:
        i = start
        while True:
            i = int(tree[i + self.get(int(probs[i >> 1]))])
            if i <= 0:
                return -i


# ---------------------------------------------------------------------------
# quantizer / filter-limit derivation — RFC §9.6 / §15.4 table lookups
# ---------------------------------------------------------------------------

def quantizers_from_indices(y_ac_qis, y_dc_d, y2_dc_d, y2_ac_d, uv_dc_d,
                            uv_ac_d):
    """Per-segment quantizer values from the frame's y_ac index + deltas
    (RFC §9.6/§14.1 with the y2 x2 / x31/20-min-8 / uv-dc-cap-132 rules).
    Returns six (nseg,) int32 arrays in the order
    (y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac)."""
    qi = lambda base, d: int(max(0, min(127, int(base) + d)))
    y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac = ([] for _ in range(6))
    for base in np.asarray(y_ac_qis).reshape(-1):
        y_ac.append(int(TBL.AC_QLOOKUP[qi(base, 0)]))
        y_dc.append(int(TBL.DC_QLOOKUP[qi(base, y_dc_d)]))
        y2_dc.append(int(TBL.DC_QLOOKUP[qi(base, y2_dc_d)]) * 2)
        v = (int(TBL.AC_QLOOKUP[qi(base, y2_ac_d)]) * 31) // 20
        y2_ac.append(max(v, 8))
        uv_dc.append(min(int(TBL.DC_QLOOKUP[qi(base, uv_dc_d)]), 132))
        uv_ac.append(int(TBL.AC_QLOOKUP[qi(base, uv_ac_d)]))
    mk = lambda v: np.asarray(v, np.int32)
    return mk(y_dc), mk(y_ac), mk(y2_dc), mk(y2_ac), mk(uv_dc), mk(uv_ac)


def filter_limits_from_levels(levels, sharpness: int, is_key: bool):
    """Per-segment (interior, mbedge, sub_bedge, hev) from filter levels
    (RFC §15.2 filter_parameters)."""
    interior, mbedge, sub_bedge, hev = [], [], [], []
    for level in np.asarray(levels).reshape(-1):
        level = int(level)
        il = level
        if sharpness:
            il >>= 2 if sharpness > 4 else 1
            il = min(il, 9 - sharpness)
        il = max(il, 1)
        h = 0
        if is_key:
            h = 2 if level >= 40 else (1 if level >= 15 else 0)
        else:
            h = 3 if level >= 40 else (
                2 if level >= 20 else (1 if level >= 15 else 0))
        interior.append(il)
        mbedge.append(((level + 2) * 2) + il)
        sub_bedge.append((level * 2) + il)
        hev.append(h)
    mk = lambda v: np.asarray(v, np.int32)
    return mk(interior), mk(mbedge), mk(sub_bedge), mk(hev)


# ---------------------------------------------------------------------------
# inverse transforms — RFC §14.3 (iDCT) / §14.4 (iWHT), literal two-pass
# ---------------------------------------------------------------------------

_C1 = 20091      # sqrt(2)*cos(pi/8) - 1 in Q16 (RFC cospi8sqrt2minus1)
_C2 = 35468      # sqrt(2)*sin(pi/8) in Q16 (RFC sinpi8sqrt2)


def dequantize(levels4x4, dc_q: int, ac_q: int) -> np.ndarray:
    q = np.full((4, 4), ac_q, np.int64)
    q[0, 0] = dc_q
    return levels4x4.astype(np.int64) * q


def idct_4x4(coeffs) -> np.ndarray:
    """(..., 4, 4) dequantized coefficients -> (..., 4, 4) residual."""
    x = np.asarray(coeffs, np.int64)
    t = np.empty_like(x)
    # vertical pass (columns)
    a1 = x[..., 0, :] + x[..., 2, :]
    b1 = x[..., 0, :] - x[..., 2, :]
    t1 = (x[..., 1, :] * _C2) >> 16
    t2 = x[..., 3, :] + ((x[..., 3, :] * _C1) >> 16)
    c1 = t1 - t2
    t1 = x[..., 1, :] + ((x[..., 1, :] * _C1) >> 16)
    t2 = (x[..., 3, :] * _C2) >> 16
    d1 = t1 + t2
    t[..., 0, :] = a1 + d1
    t[..., 3, :] = a1 - d1
    t[..., 1, :] = b1 + c1
    t[..., 2, :] = b1 - c1
    # horizontal pass (rows), with the final +4 >> 3 rounding
    out = np.empty_like(x)
    a1 = t[..., :, 0] + t[..., :, 2]
    b1 = t[..., :, 0] - t[..., :, 2]
    t1 = (t[..., :, 1] * _C2) >> 16
    t2 = t[..., :, 3] + ((t[..., :, 3] * _C1) >> 16)
    c1 = t1 - t2
    t1 = t[..., :, 1] + ((t[..., :, 1] * _C1) >> 16)
    t2 = (t[..., :, 3] * _C2) >> 16
    d1 = t1 + t2
    out[..., :, 0] = (a1 + d1 + 4) >> 3
    out[..., :, 3] = (a1 - d1 + 4) >> 3
    out[..., :, 1] = (b1 + c1 + 4) >> 3
    out[..., :, 2] = (b1 - c1 + 4) >> 3
    return out


def iwht_4x4(coeffs) -> np.ndarray:
    """Y2 inverse Walsh-Hadamard (RFC §14.3 second stage)."""
    x = np.asarray(coeffs, np.int64)
    t = np.empty_like(x)
    a1 = x[..., 0, :] + x[..., 3, :]
    b1 = x[..., 1, :] + x[..., 2, :]
    c1 = x[..., 1, :] - x[..., 2, :]
    d1 = x[..., 0, :] - x[..., 3, :]
    t[..., 0, :] = a1 + b1
    t[..., 1, :] = c1 + d1
    t[..., 2, :] = a1 - b1
    t[..., 3, :] = d1 - c1
    out = np.empty_like(x)
    a1 = t[..., :, 0] + t[..., :, 3]
    b1 = t[..., :, 1] + t[..., :, 2]
    c1 = t[..., :, 1] - t[..., :, 2]
    d1 = t[..., :, 0] - t[..., :, 3]
    out[..., :, 0] = (a1 + b1 + 3) >> 3
    out[..., :, 1] = (c1 + d1 + 3) >> 3
    out[..., :, 2] = (a1 - b1 + 3) >> 3
    out[..., :, 3] = (d1 - c1 + 3) >> 3
    return out


def unzigzag(scan16) -> np.ndarray:
    out = np.zeros(scan16.shape[:-1] + (16,), scan16.dtype)
    for k in range(16):
        out[..., int(TBL.ZIGZAG[k])] = scan16[..., k]
    return out.reshape(scan16.shape[:-1] + (4, 4))


# ---------------------------------------------------------------------------
# intra prediction — RFC §12.2 (chroma TM) / §12.3 (B_PRED), per-pixel
# ---------------------------------------------------------------------------

def _a2(p, q):
    return (int(p) + int(q) + 1) >> 1


def _a3(p, q, r):
    return (int(p) + 2 * int(q) + int(r) + 2) >> 2


def predict_b_mode(mode: int, above8, left4, corner) -> np.ndarray:
    """One 4x4 B_PRED predictor, per-pixel per the RFC §12.3 mode text.
    above8: 8 above pixels (incl. above-right), left4: 4, corner: scalar."""
    A = [int(v) for v in above8]
    L = [int(v) for v in left4]
    P = int(corner)
    E = A[:4] + A[4:]            # the RFC's "E" array view (A then AR)
    out = np.zeros((4, 4), np.int32)
    if mode == 0:                # B_DC_PRED
        out[:] = (sum(A[:4]) + sum(L) + 4) >> 3
    elif mode == 1:              # B_TM_PRED
        for r in range(4):
            for c in range(4):
                out[r, c] = min(max(A[c] + L[r] - P, 0), 255)
    elif mode == 2:              # B_VE_PRED
        row = [_a3(P, A[0], A[1]), _a3(A[0], A[1], A[2]),
               _a3(A[1], A[2], A[3]), _a3(A[2], A[3], A[4])]
        out[:] = row
    elif mode == 3:              # B_HE_PRED
        col = [_a3(P, L[0], L[1]), _a3(L[0], L[1], L[2]),
               _a3(L[1], L[2], L[3]), _a3(L[2], L[3], L[3])]
        for r in range(4):
            out[r, :] = col[r]
    elif mode == 4:              # B_LD_PRED: f(r + c)
        f = [_a3(E[i], E[i + 1], E[i + 2 if i + 2 < 8 else 7])
             for i in range(7)]
        for r in range(4):
            for c in range(4):
                out[r, c] = f[r + c]
    elif mode == 5:              # B_RD_PRED: e(4 + r - c)
        e = [_a3(E[3], E[2], E[1]), _a3(E[2], E[1], E[0]),
             _a3(E[1], E[0], P), _a3(E[0], P, L[0]),
             _a3(P, L[0], L[1]), _a3(L[0], L[1], L[2]),
             _a3(L[1], L[2], L[3])]
        # e indexed so that e[3] is the main diagonal (L0,P,A0)
        for r in range(4):
            for c in range(4):
                out[r, c] = e[3 + r - c]
    elif mode == 6:              # B_VR_PRED (RFC §12.3 figure)
        even = [_a2(P, A[0]), _a2(A[0], A[1]), _a2(A[1], A[2]),
                _a2(A[2], A[3])]
        odd = [_a3(P, A[0], A[1]), _a3(A[0], A[1], A[2]),
               _a3(A[1], A[2], A[3])]
        lft = [_a3(L[0], P, A[0]), _a3(L[1], L[0], P), _a3(L[2], L[1], L[0])]
        out[0] = [even[0], even[1], even[2], even[3]]
        out[1] = [lft[0], odd[0], odd[1], odd[2]]
        out[2] = [lft[1], even[0], even[1], even[2]]
        out[3] = [lft[2], lft[0], odd[0], odd[1]]
    elif mode == 7:              # B_VL_PRED
        a2 = [_a2(A[i], A[i + 1]) for i in range(7)]
        a3 = [_a3(A[i], A[i + 1], A[i + 2 if i + 2 < 8 else 7])
              for i in range(7)]
        out[0] = [a2[0], a2[1], a2[2], a2[3]]
        out[1] = [a3[0], a3[1], a3[2], a3[3]]
        out[2] = [a2[1], a2[2], a2[3], a3[4]]
        out[3] = [a3[1], a3[2], a3[3], a3[5]]
    elif mode == 8:              # B_HD_PRED
        h2 = [_a2(L[0], P), _a2(L[1], L[0]), _a2(L[2], L[1]),
              _a2(L[3], L[2])]
        h3 = [_a3(L[0], P, A[0]), _a3(L[1], L[0], P), _a3(L[2], L[1], L[0]),
              _a3(L[3], L[2], L[1])]
        up = [_a3(P, A[0], A[1]), _a3(A[0], A[1], A[2])]
        out[0] = [h2[0], h3[0], up[0], up[1]]
        out[1] = [h2[1], h3[1], h2[0], h3[0]]
        out[2] = [h2[2], h3[2], h2[1], h3[1]]
        out[3] = [h2[3], h3[3], h2[2], h3[2]]
    elif mode == 9:              # B_HU_PRED
        u2 = [_a2(L[0], L[1]), _a2(L[1], L[2]), _a2(L[2], L[3])]
        u3 = [_a3(L[0], L[1], L[2]), _a3(L[1], L[2], L[3]),
              _a3(L[2], L[3], L[3])]
        out[0] = [u2[0], u3[0], u2[1], u3[1]]
        out[1] = [u2[1], u3[1], u2[2], u3[2]]
        out[2] = [u2[2], u3[2], L[3], L[3]]
        out[3] = [L[3]] * 4
    else:
        raise ValueError(f"bad bmode {mode}")
    return out


def predict_tm_8x8(above8, left8, corner) -> np.ndarray:
    out = np.empty((8, 8), np.int32)
    P = int(corner)
    for r in range(8):
        for c in range(8):
            out[r, c] = min(max(int(above8[c]) + int(left8[r]) - P, 0), 255)
    return out


def block_neighbors(plane, bx: int, by: int, w4: int):
    """Above(8, incl. above-right), Left(4), corner for luma subblock
    (bx, by) on the reconstructed plane: 127 above the frame, 129 left of
    it (RFC §12.1), and the MB-boundary above-right rule — the rightmost
    subblock column of an MB takes its above-right pixels from the row
    above the whole MB (already final), replicating the last column at the
    frame's right edge (reference intra_part.h:540-618)."""
    x, y = bx * 4, by * 4
    above = np.empty(8, np.int32)
    if by == 0:
        above[:] = 127
        corner = 127
    else:
        above[:4] = plane[y - 1, x:x + 4]
        if bx % 4 < 3:                       # interior subblock column
            above[4:] = plane[y - 1, x + 4:x + 8]
        else:
            mb_top = (by // 4) * 16
            if mb_top == 0:
                above[4:] = 127
            elif bx == w4 - 1:               # frame right edge
                above[4:] = plane[mb_top - 1, x + 3]
            else:
                above[4:] = plane[mb_top - 1, x + 4:x + 8]
        corner = 129 if bx == 0 else int(plane[y - 1, x - 1])
    if bx == 0:
        left = np.full(4, 129, np.int32)
    else:
        left = plane[y:y + 4, x - 1].astype(np.int32)
    return above, left, corner


# ---------------------------------------------------------------------------
# loop filter — RFC §15.2/§15.3, literal per-edge transcription
# ---------------------------------------------------------------------------

def _c(x):
    return np.clip(x, -128, 127)


def _simple_segment(arr8, hev, mask):
    """arr8: list of (n,) int32 [p3..q3]; the subblock filter (RFC §15.3):
    outer taps participate only on high-edge-variance pixels; p1/q1 are
    nudged by (F+1)>>1 only on low-variance ones."""
    p3, p2, p1, p0, q0, q1, q2, q3 = arr8
    outer = np.where(hev, _c(p1 - q1), 0)
    a = _c(outer + 3 * (q0 - p0))
    a = np.where(mask, a, 0)
    F = _c(a + 4) >> 3
    E = _c(a + 3) >> 3
    q0 = _c(q0 - F)
    p0 = _c(p0 + E)
    a2 = (F + 1) >> 1
    a2 = np.where(hev, 0, a2)
    q1 = _c(q1 - a2)
    p1 = _c(p1 + a2)
    return p3, p2, p1, p0, q0, q1, q2, q3


def _mb_segment(arr8, hev, mask):
    """Macroblock-edge filter (RFC §15.3 mbfilter): hev pixels take the
    subblock adjustment, the rest the 27/18/9 wide taps on p2..q2."""
    p3, p2, p1, p0, q0, q1, q2, q3 = arr8
    w = _c(_c(p1 - q1) + 3 * (q0 - p0))
    w = np.where(mask, w, 0)
    ah = np.where(hev, w, 0)
    F = _c(ah + 4) >> 3
    E = _c(ah + 3) >> 3
    q0 = _c(q0 - F)
    p0 = _c(p0 + E)
    wl = np.where(hev, 0, w)
    a = _c((27 * wl + 63) >> 7)
    q0 = _c(q0 - a)
    p0 = _c(p0 + a)
    a = _c((18 * wl + 63) >> 7)
    q1 = _c(q1 - a)
    p1 = _c(p1 + a)
    a = _c((9 * wl + 63) >> 7)
    q2 = _c(q2 - a)
    p2 = _c(p2 + a)
    return p3, p2, p1, p0, q0, q1, q2, q3


def _masks(arr8, edge_limit, interior_limit, hev_t):
    p3, p2, p1, p0, q0, q1, q2, q3 = arr8
    mask = (abs(p0 - q0) * 2 + abs(p1 - q1) // 2) <= edge_limit
    for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        mask &= abs(a - b) <= interior_limit
    hev = (abs(p1 - p0) > hev_t) | (abs(q1 - q0) > hev_t)
    return mask, hev


def _edge_apply(plane, rows, cols, horizontal, kind, mbe, sbe, il, hev_t):
    """Filter one edge: 8 pixel lines perpendicular to it, vectorized over
    the edge length."""
    if horizontal:
        arr8 = [plane[rows + k, cols].astype(np.int32) - 128
                for k in range(-4, 4)]
    else:
        arr8 = [plane[rows, cols + k].astype(np.int32) - 128
                for k in range(-4, 4)]
    lim = mbe if kind == "mb" else sbe
    mask, hev = _masks(arr8, lim, il, hev_t)
    fn = _mb_segment if kind == "mb" else _simple_segment
    arr8 = fn(arr8, hev, mask)
    ks = range(-3, 3) if kind == "mb" else range(-2, 2)
    for k in ks:
        v = np.clip(arr8[k + 4] + 128, 0, 255).astype(plane.dtype)
        if horizontal:
            plane[rows + k, cols] = v
        else:
            plane[rows, cols + k] = v


def loop_filter(plane, mb_size, seg_ids, inner, levels, mbe, sbe, il, hev_t):
    """Whole-plane in-place filter, raster MB order (RFC §15.1: vertical
    edges left-to-right, then horizontal top-to-bottom, per MB)."""
    H, W = plane.shape
    mbw = W // mb_size
    for mbn in range(len(seg_ids)):
        mby, mbx = divmod(mbn, mbw)
        s = int(seg_ids[mbn])
        if int(levels[s]) == 0:
            continue
        x0, y0 = mbx * mb_size, mby * mb_size
        rows = np.arange(y0, y0 + mb_size)
        cols = np.arange(x0, x0 + mb_size)
        args = (int(mbe[s]), int(sbe[s]), int(il[s]), int(hev_t[s]))
        if mbx > 0:
            _edge_apply(plane, rows, x0, False, "mb", *args)
        if inner[mbn]:
            for dx in range(4, mb_size, 4):
                _edge_apply(plane, rows, x0 + dx, False, "b", *args)
        if mby > 0:
            _edge_apply(plane, y0, cols, True, "mb", *args)
        if inner[mbn]:
            for dy in range(4, mb_size, 4):
                _edge_apply(plane, y0 + dy, cols, True, "b", *args)


# ---------------------------------------------------------------------------
# near-MV census — the canonical 3-entry scan (vp8_find_near_mvs semantics)
# ---------------------------------------------------------------------------

def near_mv_census(mvs, is_inter, is_split, mbx: int, mby: int, mbw: int):
    """Scalar per-MB census over the above / left / above-left neighbors
    (weights 2/2/1, dedup against the newest entry, third-entry merge,
    nearest/near swap, best selection).  Independent transcription of the
    canonical decoder algorithm — the encoder's vectorized census
    (entropy/mv.py) must agree with it for streams to round-trip.

    mvs: (mbc, 2) int arrays of each MB's base vector (sub-MV 3);
    is_inter/is_split: (mbc,) bool.  Returns (best(2,), nearest(2,),
    near(2,), mode_probs(4,))."""
    entries = [np.zeros(2, np.int64)]        # list[0] unused sentinel slot
    cnt = [0, 0, 0, 0]

    def consider(nx, ny, weight):
        if nx < 0 or ny < 0:
            return
        n = ny * mbw + nx
        if not is_inter[n]:
            return
        v = mvs[n].astype(np.int64)
        if v[0] == 0 and v[1] == 0:
            cnt[0] += weight
            return
        if len(entries) == 1 or not np.array_equal(v, entries[-1]):
            entries.append(v)
        cnt[len(entries) - 1] += weight

    consider(mbx, mby - 1, 2)
    consider(mbx - 1, mby, 2)
    consider(mbx - 1, mby - 1, 1)

    while len(entries) < 4:
        entries.append(np.zeros(2, np.int64))
    # a third entry equal to the first strengthens NEAREST
    if cnt[3] and np.array_equal(entries[3], entries[1]):
        cnt[1] += 1
    # SPLITMV context: how much of the neighborhood is split
    def split_at(nx, ny):
        if nx < 0 or ny < 0:
            return False
        n = ny * mbw + nx
        return bool(is_inter[n]) and bool(is_split[n])

    cnt[3] = (2 * split_at(mbx, mby - 1) + 2 * split_at(mbx - 1, mby)
              + split_at(mbx - 1, mby - 1))
    if cnt[2] > cnt[1]:
        cnt[1], cnt[2] = cnt[2], cnt[1]
        entries[1], entries[2] = entries[2], entries[1]
    best = entries[1] if cnt[1] >= cnt[0] else np.zeros(2, np.int64)
    probs = np.asarray([TBL.VP8_MODE_CONTEXTS[cnt[i], i] for i in range(4)],
                       np.uint8)
    return (best.astype(np.int32), entries[1].astype(np.int32),
            entries[2].astype(np.int32), probs)
