"""Intra predictors (RFC 6386 §12.2/§12.3), numpy.

All ten B_PRED subblock modes plus whole-block TM used for chroma.  The
formulas match the reference implementation at
reference intra_part.h:252-515 (which matches the RFC).

Functions are written with stacking only (no in-place assignment).
"""
from __future__ import annotations

import numpy as np


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def bpred_all_modes(A, L, P, xp=np):
    """All 10 B_PRED predictors.

    A: (..., 8) above row incl. above-right; L: (..., 4) left column;
    P: (...) above-left corner.  Returns (..., 10, 4, 4) int32.
    """
    A0, A1, A2, A3, A4, A5, A6, A7 = (A[..., i] for i in range(8))
    L0, L1, L2, L3 = (L[..., i] for i in range(4))

    def grid(rows):
        # rows: list of 4 lists of 4 scalars (...,) -> (..., 4, 4)
        return xp.stack([xp.stack(r, axis=-1) for r in rows], axis=-2)

    # B_DC_PRED
    dc = (A0 + A1 + A2 + A3 + L0 + L1 + L2 + L3 + 4) >> 3
    m_dc = grid([[dc] * 4] * 4)

    # B_TM_PRED: clamp(A[j] + L[i] - P)
    tm = xp.clip(A[..., None, :4] + L[..., :, None] - P[..., None, None], 0, 255)

    # B_VE_PRED
    v0 = _avg3(P, A0, A1)
    v1 = _avg3(A0, A1, A2)
    v2 = _avg3(A1, A2, A3)
    v3 = _avg3(A2, A3, A4)
    m_ve = grid([[v0, v1, v2, v3]] * 4)

    # B_HE_PRED
    h0 = _avg3(P, L0, L1)
    h1 = _avg3(L0, L1, L2)
    h2 = _avg3(L1, L2, L3)
    h3 = _avg3(L2, L3, L3)
    m_he = grid([[h0] * 4, [h1] * 4, [h2] * 4, [h3] * 4])

    # B_LD_PRED (diagonal down-left), f(d) over d = r + c
    f0 = _avg3(A0, A1, A2)
    f1 = _avg3(A1, A2, A3)
    f2 = _avg3(A2, A3, A4)
    f3 = _avg3(A3, A4, A5)
    f4 = _avg3(A4, A5, A6)
    f5 = _avg3(A5, A6, A7)
    f6 = _avg3(A6, A7, A7)
    m_ld = grid([[f0, f1, f2, f3], [f1, f2, f3, f4],
                 [f2, f3, f4, f5], [f3, f4, f5, f6]])

    # B_RD_PRED (diagonal down-right), e(d) over d = r - c in -3..3
    em3 = _avg3(A1, A2, A3)
    em2 = _avg3(A0, A1, A2)
    em1 = _avg3(P, A0, A1)
    e0 = _avg3(L0, P, A0)
    e1 = _avg3(L1, L0, P)
    e2 = _avg3(L2, L1, L0)
    e3 = _avg3(L3, L2, L1)
    m_rd = grid([[e0, em1, em2, em3], [e1, e0, em1, em2],
                 [e2, e1, e0, em1], [e3, e2, e1, e0]])

    # B_VR_PRED
    vr_c = _avg3(L2, L1, L0)
    vr_b = _avg3(L1, L0, P)
    vr_a = _avg3(L0, P, A0)
    vr0 = _avg2(P, A0)
    vr1 = _avg3(P, A0, A1)
    vr2 = _avg2(A0, A1)
    vr3 = _avg3(A0, A1, A2)
    vr4 = _avg2(A1, A2)
    vr5 = _avg3(A1, A2, A3)
    vr6 = _avg2(A2, A3)
    m_vr = grid([[vr0, vr2, vr4, vr6], [vr_a, vr1, vr3, vr5],
                 [vr_b, vr0, vr2, vr4], [vr_c, vr_a, vr1, vr3]])

    # B_VL_PRED
    vl0 = _avg2(A0, A1)
    vl1 = _avg3(A0, A1, A2)
    vl2 = _avg2(A1, A2)
    vl3 = _avg3(A1, A2, A3)
    vl4 = _avg2(A2, A3)
    vl5 = _avg3(A2, A3, A4)
    vl6 = _avg2(A3, A4)
    vl7 = _avg3(A3, A4, A5)
    vl8 = _avg3(A4, A5, A6)
    vl9 = _avg3(A5, A6, A7)
    m_vl = grid([[vl0, vl2, vl4, vl6], [vl1, vl3, vl5, vl7],
                 [vl2, vl4, vl6, vl8], [vl3, vl5, vl7, vl9]])

    # B_HD_PRED
    hd0 = _avg2(L0, P)
    hd1 = _avg3(L0, P, A0)
    hd2 = _avg3(P, A0, A1)
    hd3 = _avg3(A0, A1, A2)
    hd4 = _avg2(L1, L0)
    hd5 = _avg3(L1, L0, P)
    hd6 = _avg2(L2, L1)
    hd7 = _avg3(L2, L1, L0)
    hd8 = _avg2(L3, L2)
    hd9 = _avg3(L3, L2, L1)
    m_hd = grid([[hd0, hd1, hd2, hd3], [hd4, hd5, hd0, hd1],
                 [hd6, hd7, hd4, hd5], [hd8, hd9, hd6, hd7]])

    # B_HU_PRED
    hu0 = _avg2(L0, L1)
    hu1 = _avg3(L0, L1, L2)
    hu2 = _avg2(L1, L2)
    hu3 = _avg3(L1, L2, L3)
    hu4 = _avg2(L2, L3)
    hu5 = _avg3(L2, L3, L3)
    m_hu = grid([[hu0, hu1, hu2, hu3], [hu2, hu3, hu4, hu5],
                 [hu4, hu5, L3, L3], [L3, L3, L3, L3]])

    out = xp.stack([m_dc, tm, m_ve, m_he, m_ld, m_rd, m_vr, m_vl, m_hd, m_hu],
                   axis=-3)
    return out.astype(np.int32)


def tm_predict_8x8(top, left, tl, xp=np):
    """Whole-MB chroma TM_PRED: top (..., 8), left (..., 8), tl (...,) ->
    (..., 8, 8) clamped to 0..255 (RFC 6386 §12.2)."""
    return xp.clip(top[..., None, :] + left[..., :, None] - tl[..., None, None],
                   0, 255)
