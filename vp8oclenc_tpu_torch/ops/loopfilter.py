"""VP8 normal loop filter: the PyTorch counterpart of the JAX package's
ops/loopfilter.py (`filter_planes`) and of the edge filters of its
spec/loopfilter.py.

The decoder's MB raster order is relaxed to the anti-diagonal wavefront
d = mbx + 2*mby: an MB's filtering reads and writes only its own pixels and
the 3-4 pixel borders of its left and top neighbours, which are final by
stage d, and the MBs of one stage touch disjoint pixels.  Inside an MB the
order is the decoder's: left MB edge, inner vertical edges, top MB edge,
inner horizontal edges.

`filter_planes_plain` is plain PyTorch, one vectorized pass per edge and
stage (`filter_step` on the MBs of one diagonal), on any device;
`filter_planes` launches the csrc/loopfilter.cu kernel for CUDA tensors and
takes the plain version for CPU tensors.  The kernel is out of place: it
reads the unfiltered planes and writes new ones.  It orders the MBs by a
weaker rule than the diagonal (MB row r takes MB bx once row r-1 is past
bx+1); tests/test_torch_wavefront_order.py holds that rule against the
plain version through `filter_step`.

Band mode (`filter_band_plain`, `filter_band`) filters the MB rows of one
row shard of a taller frame: given the 4 lines above the band from the
shard above, it filters the band's first MB row's top edge too and
returns, besides the band, the 3 of those lines that the edge changed, for
the shard above to write back.  The shard above's own filtering needs
nothing of the band, so its lines are final before the band starts, and
bands filtered one after the other down the frame equal the whole-plane
filter.  Without a halo the band is a frame.
"""
from __future__ import annotations

import ctypes

import torch

_I32 = torch.int32


def _c128(x):
    return torch.clamp(x, -128, 127)


def filter_mask(p3, p2, p1, p0, q0, q1, q2, q3, edge_lim, int_lim):
    m = (p3 - p2).abs() > int_lim
    m = m | ((p2 - p1).abs() > int_lim)
    m = m | ((p1 - p0).abs() > int_lim)
    m = m | ((q1 - q0).abs() > int_lim)
    m = m | ((q2 - q1).abs() > int_lim)
    m = m | ((q3 - q2).abs() > int_lim)
    m = m | (((p0 - q0).abs() * 2 + (p1 - q1).abs() // 2) > edge_lim)
    return ~m


def hev_mask(p1, p0, q0, q1, hev_thr):
    return ((p1 - p0).abs() > hev_thr) | ((q1 - q0).abs() > hev_thr)


def filter_mb_edge(p3, p2, p1, p0, q0, q1, q2, q3, mb_lim, int_lim, hev_thr):
    """Macroblock-edge filter on int32 values in the -128..127 domain;
    returns the updated (p2, p1, p0, q0, q1, q2), not yet clamped."""
    mask = filter_mask(p3, p2, p1, p0, q0, q1, q2, q3, mb_lim, int_lim)
    hev = hev_mask(p1, p0, q0, q1, hev_thr)
    zero = torch.zeros_like(p0)
    w = _c128(_c128(p1 - q1) + 3 * (q0 - p0))
    w = torch.where(mask, w, zero)
    a = torch.where(hev, w, zero)
    b = _c128(a + 3) >> 3
    a = _c128(a + 4) >> 3
    q0 = q0 - a
    p0 = p0 + b
    w = torch.where(hev, zero, w)
    a = _c128((27 * w + 63) >> 7)
    q0 = q0 - a
    p0 = p0 + a
    a = _c128((18 * w + 63) >> 7)
    q1 = q1 - a
    p1 = p1 + a
    a = _c128((9 * w + 63) >> 7)
    q2 = q2 - a
    p2 = p2 + a
    return p2, p1, p0, q0, q1, q2


def filter_b_edge(p3, p2, p1, p0, q0, q1, q2, q3, b_lim, int_lim, hev_thr):
    """Subblock-edge filter; returns the updated (p1, p0, q0, q1)."""
    mask = filter_mask(p3, p2, p1, p0, q0, q1, q2, q3, b_lim, int_lim)
    hev = hev_mask(p1, p0, q0, q1, hev_thr)
    zero = torch.zeros_like(p0)
    a = torch.where(hev, _c128(p1 - q1), zero)
    a = _c128(a + 3 * (q0 - p0))
    a = torch.where(mask, a, zero)
    b = _c128(a + 3) >> 3
    a = _c128(a + 4) >> 3
    q0 = q0 - a
    p0 = p0 + b
    a = torch.where(hev, zero, (a + 1) >> 1)
    q1 = q1 - a
    p1 = p1 + a
    return p1, p0, q0, q1


def _filter_edges(S, n: int, y0, x0, vertical: bool, off: int, kind: str,
                  lims):
    """Filter one edge of K MBs in the int32 plane S (in place).

    y0, x0 (K,): MB origins; the edge lies `off` pixels into the MB, across
    columns (vertical) or rows; n = MB size.  lims: (edge, interior, hev)
    limits, each (K,)."""
    dev = S.device
    along = torch.arange(n, device=dev)
    across = torch.arange(-4, 4, device=dev)
    if vertical:
        rows = (y0[:, None, None] + along[None, :, None]).expand(-1, -1, 8)
        cols = (x0[:, None, None] + off + across[None, None, :]) \
            .expand(-1, n, -1)
    else:
        rows = (y0[:, None, None] + off + across[None, None, :]) \
            .expand(-1, n, -1)
        cols = (x0[:, None, None] + along[None, :, None]).expand(-1, -1, 8)
    px = S[rows, cols]                                       # (K, n, 8)
    taps = [px[..., i] for i in range(8)]
    e, i, h = (l[:, None] for l in lims)
    if kind == "mb":
        out, lo = filter_mb_edge(*taps, e, i, h), 1
    else:
        out, lo = filter_b_edge(*taps, e, i, h), 2
    new = torch.stack([_c128(o) for o in out], dim=-1)
    S[rows[..., lo:8 - lo], cols[..., lo:8 - lo]] = new


def filter_state(ry, ru, rv, seg_of_mb, inner_mask, levels, mbe, sbe, intr,
                 hev, halo=None):
    """The working state of a frame's filter: the planes as int32 in the
    -128..127 domain (filtered in place by `filter_step`) with their MB
    sizes, and the per-MB and per-segment parameters on the planes'
    device.  halo: None for a frame, or a band's (4, W) lines above each
    plane (Y, U, V); they are kept as the bottom of an MB row above the
    band's first."""
    dev = ry.device
    planes = []
    for k, p in enumerate((ry, ru, rv)):
        n = 16 if k == 0 else 8
        S = p.to(_I32) - 128
        if halo is not None:
            S = torch.cat([torch.zeros((n - 4, S.shape[1]), dtype=_I32,
                                       device=dev),
                           halo[k].to(device=dev, dtype=_I32) - 128, S])
        planes.append((S, n))
    seg_of_mb = seg_of_mb.to(device=dev, dtype=torch.long)
    inner_mask = inner_mask.to(device=dev, dtype=torch.bool)
    lim = [t.to(device=dev, dtype=_I32) for t in (levels, mbe, sbe, intr, hev)]
    return (planes, seg_of_mb, inner_mask, lim, ry.shape[1] // 16,
            int(halo is not None))


def filter_step(state, by, bx) -> None:
    """Filter the MBs (by, bx) (index tensors of one length) in all three
    planes of `state`, in place.  The MBs of one call must touch disjoint
    pixels; the caller keeps the decoder's dependencies: before (by, bx)
    come (by, bx-1) and (by-1, bx+1) (whose left edge writes into
    (by-1, bx)), and through them everything above and to the left."""
    planes, seg_of_mb, inner_mask, lim, mbw, above = state
    mbn = by * mbw + bx
    sid = seg_of_mb[mbn]
    on = lim[0][sid] > 0
    left = on & (bx > 0)
    top = on & (by + above > 0)
    inner = on & inner_mask[mbn]
    for S, n in planes:
        def edges(sel, vertical, off, kind):
            if not bool(sel.any()):
                return
            s = sid[sel]
            e = lim[1][s] if kind == "mb" else lim[2][s]
            _filter_edges(S, n, (by[sel] + above) * n, bx[sel] * n,
                          vertical, off, kind, (e, lim[3][s], lim[4][s]))
        edges(left, True, 0, "mb")
        for off in range(4, n, 4):
            edges(inner, True, off, "b")
        edges(top, False, 0, "mb")
        for off in range(4, n, 4):
            edges(inner, False, off, "b")


def filter_result(state):
    """The u8 planes of a filter state (the band's, without a halo)."""
    return tuple((S[n * state[5]:] + 128).clamp(0, 255).to(torch.uint8)
                 for S, n in state[0])


def filter_writeback(state):
    """The 3 halo lines of each plane that a band's top edge changed: the
    lines above the band's first row, nearest last."""
    return tuple((S[n - 3:n] + 128).clamp(0, 255).to(torch.uint8)
                 for S, n in state[0])


def filter_planes_plain(ry, ru, rv, seg_of_mb, inner_mask, levels, mbe, sbe,
                        intr, hev):
    """Whole-frame loop filter of u8 planes ry (H, W), ru/rv (H/2, W/2).

    seg_of_mb (mbc,) segment id per MB; inner_mask (mbc,) bool: filter the
    subblock edges; levels/mbe/sbe/intr/hev (4,) per-segment filter level,
    MB-edge limit, subblock-edge limit, interior limit and HEV threshold.
    An MB whose segment level is 0 is skipped.  Returns new u8 planes."""
    return filter_band_plain(ry, ru, rv, None, seg_of_mb, inner_mask, levels,
                             mbe, sbe, intr, hev)[0]


def filter_band_plain(ry, ru, rv, halo, seg_of_mb, inner_mask, levels, mbe,
                      sbe, intr, hev):
    """Loop filter of a band of MB rows (contract of `filter_planes_plain`
    for the band's planes and per-MB parameters).  halo: None for a band at
    the frame top, else the (4, W) final lines above each plane (Y, U, V)
    from the band above.  Returns (the band's filtered u8 planes, the 3
    lines of each plane nearest the band that its top edge changed, None
    without a halo)."""
    H, W = ry.shape
    mbh, mbw = H // 16, W // 16
    state = filter_state(ry, ru, rv, seg_of_mb, inner_mask, levels, mbe, sbe,
                         intr, hev, halo)
    bands = torch.arange(mbh, device=ry.device)
    D = (mbw - 1) + 2 * (mbh - 1) + 1
    for d in range(D):
        lo = max(0, (d - (mbw - 1) + 1) // 2)
        by = bands[lo:min(mbh - 1, d // 2) + 1]
        filter_step(state, by, d - 2 * by)
    return filter_result(state), \
        None if halo is None else filter_writeback(state)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor at a 16-byte boundary (a slice of a packed
    buffer may lie elsewhere; the kernel loads 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def filter_planes(ry, ru, rv, seg_of_mb, inner_mask, levels, mbe, sbe, intr,
                  hev):
    """Loop filter (contract of `filter_planes_plain`): the
    csrc/loopfilter.cu kernels for CUDA planes (the full-row kernel where
    the row fits a CTA, the ring kernel above that), the plain version for
    CPU planes."""
    if ry.device.type == "cpu":
        return filter_planes_plain(ry, ru, rv, seg_of_mb, inner_mask, levels,
                                   mbe, sbe, intr, hev)
    return _launch(ry, ru, rv, None, seg_of_mb, inner_mask, levels, mbe, sbe,
                   intr, hev)[0]


filter_planes.launches = 0


def filter_band(ry, ru, rv, halo, seg_of_mb, inner_mask, levels, mbe, sbe,
                intr, hev):
    """Band loop filter (contract of `filter_band_plain`): the
    csrc/loopfilter.cu kernels for CUDA planes, the plain version for CPU
    planes.  Counted in `filter_planes.launches` and in
    `filter_band.launches`."""
    if ry.device.type == "cpu":
        return filter_band_plain(ry, ru, rv, halo, seg_of_mb, inner_mask,
                                 levels, mbe, sbe, intr, hev)
    out = _launch(ry, ru, rv, halo, seg_of_mb, inner_mask, levels, mbe, sbe,
                  intr, hev)
    filter_band.launches += 1
    return out


filter_band.launches = 0


def _launch(ry, ru, rv, halo, seg_of_mb, inner_mask, levels, mbe, sbe, intr,
            hev):
    """One launch of the row-pipelined kernel on a frame (halo None) or a
    band; returns (planes, write-back lines or None)."""
    dev = ry.device
    for t, nm in ((ry, "ry"), (ru, "ru"), (rv, "rv")):
        if t.device != dev or t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"filter_planes: {nm} must be a 2-D uint8 "
                             f"tensor on {dev}")
    H, W = ry.shape
    if H % 16 or W % 16 or ru.shape != (H // 2, W // 2) \
            or rv.shape != (H // 2, W // 2):
        raise ValueError("filter_planes: plane shapes do not match")
    from vp8oclenc_tpu_torch.ops import cuda_build
    mbc = (H // 16) * (W // 16)
    seg = seg_of_mb.to(device=dev, dtype=torch.int32).contiguous()
    inner = inner_mask.to(device=dev, dtype=torch.uint8).contiguous()
    lf = torch.stack([t.to(device=dev, dtype=torch.int32)
                      for t in (levels, mbe, sbe, intr, hev)]).contiguous()
    if seg.shape != (mbc,) or inner.shape != (mbc,) or lf.shape != (5, 4):
        raise ValueError("filter_planes: bad per-MB or per-segment shapes")
    src = [_aligned(t) for t in (ry, ru, rv)]
    out = [torch.empty_like(t) for t in src]
    hal = wb = [None] * 3
    if halo is not None:
        hal = [_aligned(t) for t in halo]
        if [tuple(t.shape) for t in hal] != [(4, W), (4, W // 2),
                                             (4, W // 2)] \
                or any(t.device != dev or t.dtype != torch.uint8
                       for t in hal):
            raise ValueError("filter_band: the halo must be 4 uint8 lines "
                             "of each plane's width on the planes' device")
        wb = [torch.empty((3, t.shape[1]), dtype=torch.uint8, device=dev)
              for t in hal]
    # the kernel's 3 progress counters per MB row and its row ticket: a
    # fresh zeroed buffer per call (one fill on the caller's stream, no
    # host sync), so frames in flight never share counters
    sync = torch.zeros(3 * (H // 16) + 1, dtype=torch.int32, device=dev)
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = cuda_build.library("loopfilter")
    rc = lib.vp8_loop_filter(
        *map(p, src), *map(p, out), *map(p, hal), *map(p, wb), p(seg),
        p(inner), p(lf), p(sync), W // 16, H // 16,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(rc, "vp8_loop_filter")
    filter_planes.launches += 1
    return tuple(out), None if halo is None else tuple(wb)
