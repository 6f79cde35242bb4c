"""Row-tile sharding of a frame over a lane's tile group: the counterpart
of the JAX package's parallel/tile.py, one process per rank.

Tile rank t of T owns MB rows [t*mbh/T, (t+1)*mbh/T) of every frame.  What
its pixel work can reach beyond its rows is bounded (ops/inter.PAD_Y_FULL,
PAD_C_FULL), so instead of whole frames the ranks exchange:

  * reference strips, once per new reference frame: at levels 0 and 1 of
    the luma pyramid and for chroma the band with the halo rows above and
    below it that a valid candidate can read (taken from as many ranks
    above and below as the halo spans; rows beyond the frame repeat its
    first or last row), at levels 2..4 the whole plane (level 2
    all-gathered, 3 and 4 derived);
  * the current frame's level-2 plane (all-gathered: the coarse levels are
    searched on the whole frame by every rank);
  * under an SSIM target, one ghost recon row of each plane and the last
    MB row's winner flags from the rank above;
  * the frame-global minimum SSIM (the weaken rule);
  * the loop filter's 4 lines above each band and the 3 that come back
    (`filter_band_handoff`: the bands one after the other down the group,
    so the frame's filter takes as long as on one rank).

Every output equals the single-rank encoder's for the rank's rows, bit for
bit (tests/test_torch_tile.py).  A strip here is the band plus its halo
rows, the band's first row at index `pad`: the port's searches read
unpadded planes with clamped reads and take that offset, not the JAX
package's tiled aprons.
"""
from __future__ import annotations

import torch

from vp8oclenc_tpu_torch.ops.inter import PAD_C_FULL, PAD_Y_FULL, downsample2
from vp8oclenc_tpu_torch.tables import ARE4X4, INTRA_SEGMENT


class TileShard:
    """The band a tile rank codes (ops/inter.inter_body's `shard`): its
    first row `row0` in a frame of `full_h` rows, and the exchanges over
    the tile group that the band's pixel work makes."""

    def __init__(self, layout, rows: int, full_h: int) -> None:
        self.layout = layout
        self.row0 = layout.t * rows
        self.full_h = full_h

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return self.layout.all_gather_rows(t)

    def from_above(self, ts: list) -> list:
        """Each of ts from the rank above (None at the frame top), while
        this rank's go to the rank below."""
        lay = self.layout
        down = {lay.t + 1: [t.to(torch.uint8) if t.dtype == torch.bool
                            else t for t in ts]} \
            if lay.t + 1 < lay.tile else {}
        up = {lay.t - 1: [(tuple(t.shape), torch.uint8 if t.dtype ==
                           torch.bool else t.dtype) for t in ts]} \
            if lay.t > 0 else {}
        got = lay.exchange(down, up)
        if not got:
            return [None] * len(ts)
        return [g.to(torch.bool) if t.dtype == torch.bool else g
                for g, t in zip(got[lay.t - 1], ts)]


def halo_strip(band: torch.Tensor, pad: int, layout) -> torch.Tensor:
    """(rows, W) band of tile rank t -> (pad + rows + pad, W) strip: the
    frame's rows from row0 - pad to row0 + rows + pad, the halo rows taken
    from every rank that holds some (several ranks away when pad > rows),
    rows beyond the frame repeating its first or last row."""
    rows, W = band.shape
    T, t = layout.tile, layout.t
    H, row0 = rows * T, t * rows

    def window(s):
        return max(0, s * rows - pad), min(H, s * rows + rows + pad)

    lo, hi = window(t)
    sends, recvs = {}, {}
    for s in range(T):
        if s == t:
            continue
        a, b = max(lo, s * rows), min(hi, (s + 1) * rows)
        if a < b:
            recvs[s] = [((b - a, W), band.dtype)]
        slo, shi = window(s)
        a, b = max(slo, row0), min(shi, row0 + rows)
        if a < b:
            sends[s] = [band[a - row0:b - row0]]
    got = layout.exchange(sends, recvs)
    mid = torch.cat([band if s == t else got[s][0] for s in range(T)
                     if s == t or s in got])
    return torch.cat([mid[:1].expand(lo - (row0 - pad), W), mid,
                      mid[-1:].expand(row0 + rows + pad - hi, W)])


def build_ref_strips(ry, ru, rv, layout):
    """A reference's search state for a tile rank, from its band of the
    post-filter planes, in the layout of ops/inter.ref_state: ((level 0
    strip, level 1 strip, whole levels 2, 3, 4), U strip, V strip).  The
    pyramid is downsampled from the band's own rows before any halo, so
    every level equals the single-rank pyramid's rows."""
    d1 = downsample2(ry)
    full2 = layout.all_gather_rows(downsample2(d1))
    full3 = downsample2(full2)
    pyr = (halo_strip(ry, PAD_Y_FULL, layout),
           halo_strip(d1, PAD_Y_FULL >> 1, layout), full2, full3,
           downsample2(full3))
    return (pyr, halo_strip(ru, PAD_C_FULL, layout),
            halo_strip(rv, PAD_C_FULL, layout))


def filter_band_handoff(ry, ru, rv, seg_of_mb, inner_mask, lf, layout):
    """The loop filter of a tile rank's band (ops/loopfilter.filter_band),
    handed down the tile group: rank t waits for the 4 final lines above
    its band from rank t-1, filters, passes its last 4 lines to rank t+1
    and the 3 lines its top edge changed back to rank t-1, and writes in
    the 3 lines rank t+1 sends back.  lf: (5, 4) per-segment limits.
    Returns the band's filtered planes."""
    from vp8oclenc_tpu_torch.ops.loopfilter import filter_band
    T, t = layout.tile, layout.t
    shapes = [(4, p.shape[1]) for p in (ry, ru, rv)]
    halo = None
    if t > 0:
        halo = layout.exchange({}, {t - 1: [(s, torch.uint8)
                                            for s in shapes]})[t - 1]
    planes, wb = filter_band(ry, ru, rv, halo, seg_of_mb, inner_mask, *lf)
    sends = {}
    if t + 1 < T:
        sends[t + 1] = [p[-4:] for p in planes]
    if t > 0:
        sends[t - 1] = list(wb)
    layout.exchange(sends, {})
    if t + 1 < T:
        back = layout.exchange({}, {t + 1: [((3, s[1]), torch.uint8)
                                            for s in shapes]})[t + 1]
        for p, b in zip(planes, back):
            p[-3:] = b
    return tuple(planes)


def sharded_frame_step(y, u, v, states, ref_valid, quant, lf, ssim_target,
                       layout, full_h: int):
    """One inter frame's band on a tile rank: the inter body in shard
    mode, the loop filter from its outputs (the weakened limits when the
    frame-global minimum SSIM, a MIN over the tile group, exceeds
    WEAKEN_FX), the band filter, the wire pack of the band's MBs and the
    next LAST's strips.

    y, u, v: the band's source rows on the rank's device; states: three
    `build_ref_strips` states; ref_valid, quant, ssim_target as in
    ops/inter.inter_body; lf (2, 5, 4) int32 normal and weakened limits.
    Returns (head, body, modes4 or None, levels_pack, filtered planes,
    new LAST state)."""
    from vp8oclenc_tpu_torch.ops.backend import filter_limits, inner_mask
    from vp8oclenc_tpu_torch.ops.inter import inter_body
    from vp8oclenc_tpu_torch.ops.wire import pack_modes4, pack_wire
    shard = TileShard(layout, y.shape[0], full_h)
    levels_pack, meta, cur_ssim, ry, ru, rv, modes, replaced = inter_body(
        y, u, v, states, ref_valid, quant, ssim_target, shard)
    min_fx = layout.all_reduce_min(cur_ssim.min().reshape(1))[0]
    planes = filter_band_handoff(ry, ru, rv, meta[:, 0],
                                 inner_mask(levels_pack, meta),
                                 filter_limits(min_fx, lf), layout)
    head, body, _ = pack_wire(levels_pack, meta, cur_ssim,
                              0 if replaced is None else replaced)
    modes4 = None if modes is None else pack_modes4(modes)
    return head, body, modes4, levels_pack, planes, \
        build_ref_strips(*planes, layout)


def sharded_key_step(y, u, v, qs, lf, layout):
    """One keyframe's band on a tile rank.  The intra wavefront's raster
    dependency spans the frame, so every rank of the lane all-gathers the
    frame and runs the whole-frame luma and chroma kernels (the same work
    on each rank, as in the JAX package: a keyframe starts a GOP); its own
    MB rows are then cut out for the band filter, the wire pack and the
    strips.  Every rank of a lane calls it, or none (the leader's redo
    decision is broadcast).

    qs: (y_dc, y_ac, uv_dc, uv_ac) intra quantizers (ints); lf (5, 4)
    int32 keyframe limits.  Returns (head, body, modes (mbc_loc, 16) i8,
    levels_pack, filtered planes, new LAST state)."""
    from vp8oclenc_tpu_torch.ops.intra import intra_body
    from vp8oclenc_tpu_torch.ops.wire import pack_wire
    rows, W = y.shape
    t = layout.t
    mbw = W // 16
    mbc_loc = mbw * (rows // 16)
    full = [layout.all_gather_rows(p) for p in (y, u, v)]
    ry, ru, rv, levels_pack, modes = intra_body(*full, *qs)
    mine = slice(t * mbc_loc, (t + 1) * mbc_loc)
    ry = ry[t * rows:(t + 1) * rows]
    ru, rv = (p[t * rows // 2:(t + 1) * rows // 2] for p in (ru, rv))
    dev = y.device
    seg = torch.full((mbc_loc,), INTRA_SEGMENT, dtype=torch.int32,
                     device=dev)
    planes = filter_band_handoff(
        ry, ru, rv, seg, torch.ones(mbc_loc, dtype=torch.uint8, device=dev),
        lf, layout)
    meta = torch.zeros((mbc_loc, 11), dtype=torch.int32, device=dev)
    meta[:, 0] = INTRA_SEGMENT
    meta[:, 1] = ARE4X4
    lv = levels_pack[mine]
    head, body, _ = pack_wire(lv, meta, torch.zeros(mbc_loc, dtype=torch.int32,
                                                    device=dev), 0)
    return head, body, modes[mine], lv, planes, \
        build_ref_strips(*planes, layout)
