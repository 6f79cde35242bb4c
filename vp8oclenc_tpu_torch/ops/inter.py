"""Inter-frame (P-frame) pixel path: the PyTorch counterpart of the JAX
package's ops/inter.py body (`build_inter_kernel`).

Per frame: the current 5-level pyramid, the hierarchical full-pel search
over LAST, GOLDEN and ALTREF at once (levels 4..0), the quarter-pel
refinement with the luma prediction kept from the winning candidate,
reference selection (LAST <= ALTREF <= GOLDEN on ties), 8x8 -> 16x16
packing, the chroma six-tap motion compensation, the transform passes
with Y2/WHT (one LQ pass with SSIM control off; with it on, four passes
LQ -> UQ over the MBs still below the target, then the batched intra
replacement of ops/intra_replace.py), and the per-MB integer SSIM that
steers those passes and feeds the loop filter's weaken rule.

Reference state is one tuple per reference: its 5-level pyramid (level 0
is the post-filter luma plane itself) and its chroma planes, built once
when a frame becomes a reference (`ref_state`).  The JAX package pads
every level with an edge-replicated apron and tiles it for the TPU's
gather; here every read is clamped into the level's own plane instead,
which is the same thing (spec/motion._gather_blocks): every read of a
valid candidate stays inside the apron.

A row shard of a taller frame (a tile rank of the multi-GPU layer,
parallel/tile.py) searches reference strips: its band with PAD_Y_FULL >> l
halo rows above and below at levels 0 and 1, the whole plane at levels
2..4 (`hierarchical_search` in shard mode); the searches take the strip's row
offset, the band's first row `row0` and the frame's height `full_h`, and
judge a candidate by its row in the frame.

The two searches and the segment pass have two versions with one contract
each:
  * `fullpel_search_plain`, `qpel_search_plain`, `inter_pass_plain`: plain
    PyTorch on any device, the reference the CUDA kernels are held
    against;
  * `fullpel_search`, `qpel_search`, `inter_pass`: for CUDA tensors they
    launch the hand-written kernels of csrc/search.cu and
    csrc/transform.cu, for CPU tensors they take the plain versions.
A segment pass (residual, transforms with Y2, recon, the MB's integer
SSIM and its merge into cur_ssim, written in place for the pass's MBs, as
the JAX package's `seg_pass` fuses them) is one `inter_pass` launch.
Chroma MC is plain PyTorch on either device.
"""
from __future__ import annotations

import ctypes

import torch

from vp8oclenc_tpu_torch.ops import transforms as T
from vp8oclenc_tpu_torch.ssim_fx import mb_ssim_fx_plain
from vp8oclenc_tpu_torch.tables import (ARE4X4, ARE8X8, ARE16X16,
                                        LQ_SEGMENT, SIXTAP_FILTERS)

_I32 = torch.int32
VECTOR_DIFF_WEIGHT = 64
PEN = VECTOR_DIFF_WEIGHT // 2   # smoothness penalty per pel of |delta|
BIG = 1 << 28                   # cost of a candidate outside the frame
# Halo rows of a row shard's reference strips: the farthest a valid
# candidate reads at full resolution (|v| <= 62 full pels, the window's 2,
# the six-tap apron's 3 and the quarter-pel shift's 1) is below 80 luma
# rows, and chroma reads reach below 48 rows of the half-size plane.
PAD_Y_FULL = 80
PAD_C_FULL = 48
_CHUNK = 2048                   # blocks per step of the plain searches


# ---------------------------------------------------------------------------
# pyramid and per-reference state
# ---------------------------------------------------------------------------

def downsample2(p: torch.Tensor) -> torch.Tensor:
    """2x2 box average with +2 rounding on int32 sums: (..., H, W) u8 ->
    (..., H//2, W//2) u8."""
    h, w = p.shape[-2] // 2, p.shape[-1] // 2
    q = p[..., :h * 2, :w * 2].to(_I32)
    s = q.reshape(*q.shape[:-2], h, 2, w, 2).sum(dim=(-3, -1), dtype=_I32)
    return ((s + 2) // 4).to(torch.uint8)


def build_pyramid(plane: torch.Tensor) -> list:
    """[1x, 1/2, 1/4, 1/8, 1/16] planes; level 0 is `plane` itself."""
    pyr = [plane]
    for _ in range(4):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def ref_state(ry: torch.Tensor, ru: torch.Tensor, rv: torch.Tensor):
    """Search state of one reference frame: (5-level luma pyramid, U, V)."""
    return (tuple(build_pyramid(ry)), ru, rv)


# ---------------------------------------------------------------------------
# plain searches
# ---------------------------------------------------------------------------

def _block_origins(nby: int, nbx: int, device):
    """(cy, cx) top-left pixel of each 8x8 block in raster order."""
    b = torch.arange(nby * nbx, device=device)
    return (b // nbx) * 8, (b % nbx) * 8


def _gather(planes: torch.Tensor, pidx, py, px, size: int) -> torch.Tensor:
    """planes (P, H, W); pidx/py/px broadcastable (...) -> (..., size, size)
    int32 windows whose top-left is (py, px) in plane pidx, every read
    clamped into the plane."""
    _, H, W = planes.shape
    ar = torch.arange(size, device=planes.device)
    ys = (py[..., None] + ar).clamp(0, H - 1)
    xs = (px[..., None] + ar).clamp(0, W - 1)
    return planes[pidx[..., None, None], ys[..., :, None],
                  xs[..., None, :]].to(_I32)


def _first_min(costs: torch.Tensor) -> torch.Tensor:
    """Index of the earliest minimum along the last axis."""
    m = costs.min(dim=-1, keepdim=True).values
    idx = torch.arange(costs.shape[-1], device=costs.device)
    return torch.where(costs == m, idx, costs.shape[-1]).min(dim=-1).values


def fullpel_search_plain(cur: torch.Tensor, refs: torch.Tensor,
                         v0: torch.Tensor, penalty: bool, ref_off: int = 0,
                         row0: int = 0, full_h: int = 0) -> torch.Tensor:
    """Dual-window full-pel search of every 8x8 block of one pyramid level.

    cur (H, W) u8; refs (R, HR, W) u8; v0 (R, n, 2) int32 inherited vectors
    (x, y) in this level's pels, n = (H//8)*(W//8) blocks in raster order.
    Candidates: window 1 = +-2 around v0 (indices 0..24, dy-major), then
    window 0 = +-2 around zero (25..49).  Cost = dct_cost_8x8 of the
    residual, plus 32*(|dx|+|dy|) from v0 when `penalty`; a candidate whose
    block leaves the frame costs BIG.  The earliest minimum wins.  Returns
    (R, n, 2) int32 offsets (x, y) of the winner from the block.

    Row shards: cur is the band of a `full_h`-row frame (0: H) that starts
    at the frame's row `row0`, and cur's row 0 is row `ref_off` of the
    reference planes (a strip: the band with halo rows above and below).
    A candidate is out of the frame when its global row py + row0 leaves
    [0, full_h - 8]; reads are clamped into the strip."""
    R, HR, W = refs.shape
    H = cur.shape[0]
    full_h = full_h or H
    nby, nbx = H // 8, W // 8
    n = nby * nbx
    dev = cur.device
    cy, cx = _block_origins(nby, nbx, dev)
    d = torch.arange(25, device=dev)
    ddx, ddy = d % 5 - 2, d // 5 - 2
    ridx = torch.arange(R, device=dev)[None, :, None]
    out = torch.empty((R, n, 2), dtype=_I32, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        bcy, bcx = cy[s:e], cx[s:e]
        cur_b = _gather(cur[None], zero, bcy, bcx, 8)               # (nb, 8, 8)
        v = v0[:, s:e].long()
        wx = torch.stack([v[..., 0], torch.zeros_like(v[..., 0])])  # (2, R, nb)
        wy = torch.stack([v[..., 1], torch.zeros_like(v[..., 1])])
        win = _gather(refs, ridx, bcy + wy - 2 + ref_off, bcx + wx - 2, 12)
        cand = win.unfold(-2, 8, 1).unfold(-2, 8, 1)       # (2,R,nb,5,5,8,8)
        cost = T.dct_cost_8x8(cand - cur_b[:, None, None]).flatten(-2)
        px = bcx[:, None] + wx[..., None] + ddx                # (2, R, nb, 25)
        py = bcy[:, None] + wy[..., None] + ddy
        if penalty:
            cost = cost + ((px - bcx[:, None] - v[None, ..., 0, None]).abs()
                           + (py - bcy[:, None] - v[None, ..., 1, None])
                           .abs()) * PEN
        bad = (px < 0) | (px > W - 8) | (py + row0 < 0) \
            | (py + row0 > full_h - 8)
        cost = torch.where(bad, BIG, cost)
        flat = lambda a: a.permute(1, 2, 0, 3).reshape(R, e - s, 50)
        best = _first_min(flat(cost))[..., None]
        out[:, s:e, 0] = (flat(px).gather(-1, best)[..., 0] - bcx).to(_I32)
        out[:, s:e, 1] = (flat(py).gather(-1, best)[..., 0] - bcy).to(_I32)
    return out


def qpel_search_plain(cur: torch.Tensor, refs: torch.Tensor,
                      fv: torch.Tensor, ref_off: int = 0, row0: int = 0,
                      full_h: int = 0):
    """Quarter-pel refinement of every 8x8 block of the full-res plane.

    cur (H, W) u8; refs (R, HR, W) u8; fv (R, n, 2) int32 full-pel vectors;
    ref_off, row0, full_h: row shards as in `fullpel_search_plain`, the
    bounds in quarter pels.
    Candidates 0..24: +-2 qpel around 4*fv (dy-major), each interpolated
    six-tap H then V with clip((x+64)>>7, 0, 255) after each pass, cost
    dct_cost_8x8 + 32*(|dx|+|dy|), BIG outside [0, 4W-32] x [0, 4H-32];
    candidate 25: the zero vector, no penalty.  The earliest minimum wins.

    Returns (vec (R, n, 2) int32 qpel, cost (R, n) int32 with the penalty
    taken back out for a nonzero vector, pred (R, n, 64) u8: the winner's
    prediction, the luma motion-compensated prediction)."""
    R, W = refs.shape[0], refs.shape[2]
    H = cur.shape[0]
    full_h = full_h or H
    nby, nbx = H // 8, W // 8
    n = nby * nbx
    dev = cur.device
    cy, cx = _block_origins(nby, nbx, dev)
    taps = T.device_const(SIXTAP_FILTERS, _I32, dev)
    d = torch.arange(25, device=dev)
    ddx, ddy = d % 5 - 2, d // 5 - 2
    pen = torch.cat([(ddx.abs() + ddy.abs()) * PEN,
                     torch.zeros(1, dtype=torch.long, device=dev)])
    ridx = torch.arange(R, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.long, device=dev)
    vec = torch.empty((R, n, 2), dtype=_I32, device=dev)
    cost_out = torch.empty((R, n), dtype=_I32, device=dev)
    pred_out = torch.empty((R, n, 64), dtype=torch.uint8, device=dev)

    def tap6(a, dim, off, ph):
        """sum_k taps[ph][k] * a[off + k : off + k + 8] along dim, then
        clip((x + 64) >> 7, 0, 255)."""
        t = taps[ph]
        s = sum(t[k] * a.narrow(dim, off + k, 8) for k in range(6))
        return ((s + 64) >> 7).clamp(0, 255)

    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        bcy, bcx = cy[s:e], cx[s:e]
        cur_b = _gather(cur[None], zero, bcy, bcx, 8)              # (nb, 8, 8)
        f = fv[:, s:e].long()
        # rows/cols -3..+10 around the full-pel base cover every candidate
        # and its six-tap apron
        win = _gather(refs, ridx, bcy + f[..., 1] - 3 + ref_off,
                      bcx + f[..., 0] - 3, 14)                    # (R,nb,14,14)
        hs = [tap6(win, -1, (dx >> 2) + 1, (dx & 3) * 2)
              for dx in range(-2, 3)]                             # (R,nb,14,8)
        preds = [tap6(hs[dx + 2], -2, (dy >> 2) + 1, (dy & 3) * 2)
                 for dy in range(-2, 3) for dx in range(-2, 3)]
        preds.append(_gather(refs, ridx, bcy + ref_off, bcx, 8))  # zero vector
        preds = torch.stack(preds, dim=2)                         # (R,nb,26,8,8)
        cost = T.dct_cost_8x8(preds - cur_b[:, None])             # (R, nb, 26)
        px = torch.cat([(bcx * 4)[:, None] + f[..., 0, None] * 4 + ddx,
                        (bcx * 4)[None, :, None].expand(R, -1, 1)], dim=-1)
        py = torch.cat([(bcy * 4)[:, None] + f[..., 1, None] * 4 + ddy,
                        (bcy * 4)[None, :, None].expand(R, -1, 1)], dim=-1)
        gy = py + row0 * 4
        bad = (px < 0) | (px > W * 4 - 32) | (gy < 0) \
            | (gy > full_h * 4 - 32)
        cost = torch.where(bad, BIG, cost + pen)
        best = _first_min(cost)[..., None]
        vx = px.gather(-1, best)[..., 0] - bcx * 4
        vy = py.gather(-1, best)[..., 0] - bcy * 4
        bc = cost.gather(-1, best)[..., 0]
        bc = bc - torch.where((vx != 0) | (vy != 0),
                              ((vx - f[..., 0] * 4).abs()
                               + (vy - f[..., 1] * 4).abs()) * PEN, 0)
        vec[:, s:e, 0] = vx.to(_I32)
        vec[:, s:e, 1] = vy.to(_I32)
        cost_out[:, s:e] = bc.to(_I32)
        pred_out[:, s:e] = preds.flatten(-2).gather(
            2, best[..., None].expand(-1, -1, 1, 64))[:, :, 0] \
            .to(torch.uint8)
    return vec, cost_out, pred_out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_search(name: str, cur, refs, vecs, ref_off: int) -> None:
    for t, what, dt, nd in ((cur, "cur", torch.uint8, 2),
                            (refs, "refs", torch.uint8, 3),
                            (vecs, "vectors", _I32, 3)):
        if t.device != cur.device or t.device.type != "cuda":
            raise ValueError(f"{name}: {what} must be a CUDA tensor on "
                             f"{cur.device}, or every input on the CPU")
        if t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {nd}-D "
                             f"{dt} tensor, got {t.dtype} {tuple(t.shape)}")
    R, HR, W = refs.shape
    H = cur.shape[0]
    if cur.shape[1] != W or H < 8 or W < 8 \
            or vecs.shape != (R, (H // 8) * (W // 8), 2) \
            or not 0 <= ref_off <= HR - H:
        raise ValueError(f"{name}: shapes cur {tuple(cur.shape)}, refs "
                         f"{tuple(refs.shape)}, vectors {tuple(vecs.shape)} "
                         f"and ref_off {ref_off} do not match")


def fullpel_search(cur: torch.Tensor, refs: torch.Tensor, v0: torch.Tensor,
                   penalty: bool, ref_off: int = 0, row0: int = 0,
                   full_h: int = 0) -> torch.Tensor:
    """Full-pel search (contract of `fullpel_search_plain`): the
    csrc/search.cu kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if cur.device.type == "cpu":
        return fullpel_search_plain(cur, refs, v0, penalty, ref_off, row0,
                                    full_h)
    _check_search("fullpel_search", cur, refs, v0, ref_off)
    from vp8oclenc_tpu_torch.ops import cuda_build
    R, HR, W = refs.shape
    H = cur.shape[0]
    out = torch.empty_like(v0)
    rc = cuda_build.library("search").vp8_fullpel_search(
        _ptr(cur), _ptr(refs), _ptr(v0), _ptr(out), R, W, H, HR, ref_off,
        row0, full_h or H, int(penalty),
        ctypes.c_void_p(torch.cuda.current_stream(cur.device).cuda_stream))
    cuda_build.check(rc, "vp8_fullpel_search")
    fullpel_search.launches += 1
    fullpel_search.shard_launches += HR != H
    return out


fullpel_search.launches = 0
fullpel_search.shard_launches = 0     # of them on a strip (a row shard)


def qpel_search(cur: torch.Tensor, refs: torch.Tensor, fv: torch.Tensor,
                ref_off: int = 0, row0: int = 0, full_h: int = 0):
    """Quarter-pel search (contract of `qpel_search_plain`): the
    csrc/search.cu kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if cur.device.type == "cpu":
        return qpel_search_plain(cur, refs, fv, ref_off, row0, full_h)
    _check_search("qpel_search", cur, refs, fv, ref_off)
    from vp8oclenc_tpu_torch.ops import cuda_build
    R, n = fv.shape[:2]
    vec = torch.empty_like(fv)
    cost = torch.empty((R, n), dtype=_I32, device=cur.device)
    pred = torch.empty((R, n, 64), dtype=torch.uint8, device=cur.device)
    H, W = cur.shape
    rc = cuda_build.library("search").vp8_qpel_search(
        _ptr(cur), _ptr(refs), _ptr(fv), _ptr(vec), _ptr(cost), _ptr(pred),
        R, W, H, refs.shape[1], ref_off, row0, full_h or H,
        ctypes.c_void_p(torch.cuda.current_stream(cur.device).cuda_stream))
    cuda_build.check(rc, "vp8_qpel_search")
    qpel_search.launches += 1
    qpel_search.shard_launches += refs.shape[1] != H
    return vec, cost, pred


qpel_search.launches = 0
qpel_search.shard_launches = 0        # of them on a strip (a row shard)


# ---------------------------------------------------------------------------
# hierarchical search
# ---------------------------------------------------------------------------

def search_level(cur: torch.Tensor, refs: torch.Tensor, src_vec,
                 pixel_rate: int, penalty: bool, ref_off: int = 0,
                 row0: int = 0, full_h: int = 0,
                 src_off: int = 0) -> torch.Tensor:
    """One pyramid level: cur (H, W), refs (R, HR, W), src_vec (R, nbyc,
    nbxc, 2) coarser-level vectors in full-res pels or None.  Each block
    inherits the vector of the coarser block holding (c/2), divided by
    pixel_rate toward zero.  Returns (R, H//8, W//8, 2) int32 vectors in
    full-res pels.  ref_off, row0, full_h: row shards (`fullpel_search`);
    src_off: cur's first row in the rows of src_vec's plane, when src_vec
    covers the whole frame and cur is a band."""
    H, W = cur.shape
    R = refs.shape[0]
    nby, nbx = H // 8, W // 8
    v0 = inherit_vectors(src_vec, R, nby, nbx, pixel_rate, cur.device,
                         src_off)
    off = fullpel_search(cur, refs, v0, penalty, ref_off, row0, full_h)
    return (off * pixel_rate).reshape(R, nby, nbx, 2)


def inherit_vectors(src_vec, R: int, nby: int, nbx: int, pixel_rate: int,
                    device, src_off: int = 0) -> torch.Tensor:
    """(R, nby*nbx, 2) int32 start vectors of a level's blocks in its own
    pels: the vector of the coarser block holding ((c + src_off)/2),
    divided by pixel_rate toward zero; zero without a coarser level."""
    if src_vec is None:
        return torch.zeros((R, nby * nbx, 2), dtype=_I32, device=device)
    cy, cx = _block_origins(nby, nbx, device)
    pby = (((cy + src_off) // 2) // 8).clamp(max=src_vec.shape[1] - 1)
    pbx = ((cx // 2) // 8).clamp(max=src_vec.shape[2] - 1)
    v = src_vec[:, pby, pbx]
    return (v.sign() * (v.abs() // pixel_rate)).to(_I32).contiguous()


def search_qpel(cur: torch.Tensor, refs: torch.Tensor,
                fullpel_vec: torch.Tensor, ref_off: int = 0, row0: int = 0,
                full_h: int = 0):
    """(vectors (R, nby, nbx, 2) qpel, Bdiff (R, nby, nbx), best_pred (R,
    n, 8, 8) u8) from the full-pel vectors of level 0."""
    H, W = cur.shape
    R = refs.shape[0]
    nby, nbx = H // 8, W // 8
    vec, cost, pred = qpel_search(
        cur, refs, fullpel_vec.reshape(R, nby * nbx, 2).contiguous(),
        ref_off, row0, full_h)
    return (vec.reshape(R, nby, nbx, 2), cost.reshape(R, nby, nbx),
            pred.reshape(R, nby * nbx, 8, 8))


def hierarchical_search(cur_pyr, ref_pyr, cur_full2=None, row0: int = 0,
                        full_h: int = 0, pad: int = 0):
    """cur_pyr: 5 planes (level l is (H>>l, W>>l)); ref_pyr: 5 stacked (R,
    H_l, W_l) reference levels.  Levels 4..1 (a level too small for one
    8x8 block is skipped), level 0 at full pel, then quarter pel.

    A row shard of a taller frame passes cur_full2, the frame's level-2
    plane, its band's first row `row0`, the frame's height `full_h` and
    the strips' halo `pad` (PAD_Y_FULL).  Levels 4, 3, 2 cannot be cut
    into bands exactly (a band's 8-pel block grid leaves the frame's at
    level l >= 2 unless the band starts on a multiple of 8 << l), and they
    are small, so every rank searches them on the whole frame: levels 3
    and 4 are derived from cur_full2 and ref_pyr[2..4] are whole levels.
    Levels 1 and 0 and the quarter pel run on the band's rows:
    cur_pyr[0..1] are the band's levels, ref_pyr[0..1] strips with
    pad >> l halo rows above and below (parallel/tile.build_ref_strips),
    and level 1 reads the whole-frame level-2 vectors at the band's global
    rows.  The shard's vectors equal the whole-frame search's on its
    blocks."""
    if cur_full2 is None:
        coarse = cur_pyr[2:]
    else:
        cur3 = downsample2(cur_full2)
        coarse = (cur_full2, cur3, downsample2(cur3))
    vec = None
    for lvl in (4, 3, 2, 1, 0):
        cur_l = coarse[lvl - 2] if lvl >= 2 else cur_pyr[lvl]
        h, w = cur_l.shape
        if lvl and ((w // 8) == 0 or (h // 8) == 0):
            continue
        band = lvl < 2            # the band's own rows (whole frame: all)
        vec = search_level(cur_l, ref_pyr[lvl], vec, 1 << lvl,
                           penalty=(lvl < 2),
                           ref_off=(pad >> lvl) if band else 0,
                           row0=(row0 >> lvl) if band else 0,
                           full_h=(full_h >> lvl) if band else 0,
                           src_off=(row0 >> 1) if lvl == 1 else 0)
    return search_qpel(cur_pyr[0], ref_pyr[0], vec, pad, row0, full_h)


# ---------------------------------------------------------------------------
# chroma motion compensation
# ---------------------------------------------------------------------------

def mc_predict_selected_uv(refs_u: torch.Tensor, refs_v: torch.Tensor,
                           mvs: torch.Tensor, sel: torch.Tensor,
                           H2: int = 0, ref_off: int = 0):
    """U and V prediction from each MB's selected reference.

    refs_u/refs_v (R, HR, W2) u8; mvs (mbc, 4, 2) quarter vectors in luma
    qpel, read as 1/8 pel at half resolution; sel (mbc,) reference index.
    Each 4x4 block takes the vector of its MB quarter and is six-tap
    interpolated from a 9x9 clamped patch with its own taps (H pass, clip,
    V pass, clip).  Returns (pred_u, pred_v), int32 (H2, W2).  A row shard
    predicts its H2 rows (0: HR) from strips whose row ref_off is its
    first row."""
    R, HR, W2 = refs_u.shape
    H2 = H2 or HR
    dev = refs_u.device
    nby, nbx = H2 // 4, W2 // 4
    b = torch.arange(nby * nbx, device=dev)
    by, bx = b // nbx, b % nbx
    mb = (by // 2) * (W2 // 8) + bx // 2
    v = mvs[mb, (by % 2) * 2 + bx % 2].long()                       # (n, 2)
    ax = bx * 32 + v[:, 0]
    ay = by * 32 + v[:, 1]
    planes = torch.cat([refs_u, refs_v])                            # (2R, ...)
    s = sel.long()[mb]
    patch = _gather(planes, torch.stack([s, s + R]), (ay >> 3) - 2 + ref_off,
                    (ax >> 3) - 2, 9)                               # (2,n,9,9)
    taps = T.device_const(SIXTAP_FILTERS, _I32, dev)
    tx = taps[ax & 7][:, None, None, :]                             # (n,1,1,6)
    ty = taps[ay & 7][:, None, None, :]
    h = sum(patch[..., k:k + 4] * tx[..., k] for k in range(6))
    h = ((h + 64) >> 7).clamp(0, 255)                               # (2,n,9,4)
    p = sum(h[..., k:k + 4, :] * ty[..., k] for k in range(6))
    p = ((p + 64) >> 7).clamp(0, 255)                               # (2,n,4,4)
    p = p.reshape(2, nby, nbx, 4, 4).transpose(2, 3).reshape(2, H2, W2)
    return p[0], p[1]


# ---------------------------------------------------------------------------
# transforms over MB blocks
# ---------------------------------------------------------------------------

def _mb_blocks_luma(plane, mbw: int, mbh: int):
    """(H, W) -> (mbc, 16, 4, 4) 4x4 blocks in raster order in each MB."""
    b = plane.reshape(mbh, 4, 4, mbw, 4, 4)
    return b.permute(0, 3, 1, 4, 2, 5).reshape(mbh * mbw, 16, 4, 4)


def _luma_from_mb_blocks(blocks, mbw: int, mbh: int):
    b = blocks.reshape(mbh, mbw, 4, 4, 4, 4).permute(0, 2, 4, 1, 3, 5)
    return b.reshape(mbh * 16, mbw * 16)


def _mb_blocks_chroma(plane, mbw: int, mbh: int):
    b = plane.reshape(mbh, 2, 4, mbw, 2, 4)
    return b.permute(0, 3, 1, 4, 2, 5).reshape(mbh * mbw, 4, 4, 4)


def _chroma_from_mb_blocks(blocks, mbw: int, mbh: int):
    b = blocks.reshape(mbh, mbw, 2, 2, 4, 4).permute(0, 2, 4, 1, 3, 5)
    return b.reshape(mbh * 8, mbw * 8)


def _blocks8_to_plane(blocks, nby: int, nbx: int):
    """(n, 8, 8) -> (nby*8, nbx*8) raster plane."""
    return blocks.reshape(nby, nbx, 8, 8).transpose(1, 2) \
        .reshape(nby * 8, nbx * 8)


def transform_mb_luma(res_blocks, parts, y_dc_q, y_ac_q, y2_dc_q, y2_ac_q):
    """res_blocks (mbc, 16, 4, 4) residuals; parts (mbc,).  A 16x16 MB
    (ARE16X16) sends its 16 DCs through Y2 (WHT): its Y blocks quantize DC
    with 1 and their zigzag DC is zeroed.  Returns (levels (mbc, 16, 16)
    zigzag, y2 levels (mbc, 16) zigzag, zero for split MBs, reconstructed
    residual (mbc, 16, 4, 4)), all int32."""
    mbc = res_blocks.shape[0]
    coeffs = T.fdct4x4(res_blocks)
    has_y2 = parts == ARE16X16
    dc_q_eff = torch.where(has_y2, 1, y_dc_q).to(_I32)[:, None]
    levels = T.quant4x4(coeffs, dc_q_eff, y_ac_q)
    dq = T.dequant4x4(levels, dc_q_eff, y_ac_q)
    y2c = T.fwht4x4(coeffs[:, :, 0, 0].reshape(mbc, 4, 4))
    y2_levels = T.quant4x4(y2c, y2_dc_q, y2_ac_q)
    y2_rec_dc = T.iwht4x4(T.dequant4x4(y2_levels, y2_dc_q, y2_ac_q)) \
        .reshape(mbc, 16)
    dq[:, :, 0, 0] = torch.where(has_y2[:, None], y2_rec_dc, dq[:, :, 0, 0])
    rec_res = T.idct4x4(dq)
    levels_z = T.zigzag(levels)
    levels_z[:, :, 0] = torch.where(has_y2[:, None], 0, levels_z[:, :, 0])
    y2_z = torch.where(has_y2[:, None], T.zigzag(y2_levels), 0)
    return levels_z, y2_z, rec_res


def transform_mb_chroma(res_blocks, dc_q, ac_q):
    """res_blocks (mbc, 4, 4, 4) -> (levels (mbc, 4, 16) zigzag,
    reconstructed residual (mbc, 4, 4, 4))."""
    levels = T.quant4x4(T.fdct4x4(res_blocks), dc_q, ac_q)
    return T.zigzag(levels), T.idct4x4(T.dequant4x4(levels, dc_q, ac_q))


# ---------------------------------------------------------------------------
# one segment pass
# ---------------------------------------------------------------------------

def _mb_where(mask, new, plane, n: int):
    """`new` where the (mbc,) mask holds, else `plane`: (H, W) planes of
    n x n MBs."""
    h, w = plane.shape
    m = mask.reshape(h // n, 1, w // n, 1)
    return torch.where(m, new.reshape(h // n, n, w // n, n),
                       plane.reshape(h // n, n, w // n, n)).reshape(h, w)


def inter_pass_plain(y, u, v, pred_y, pred_u, pred_v, parts, sid: int,
                     quant, ssim_target: int = -1, state=None):
    """One segment pass of the inter frame over every MB.

    y (H, W), u/v (H/2, W/2) u8 source planes (MB-aligned); pred_* the
    prediction planes of the same shapes, u8 or int32; parts (mbc,) int32
    partitionings; sid the segment and quant its six quantizers (y_dc,
    y_ac, y2_dc, y2_ac, uv_dc, uv_ac; host ints).  An active MB is coded:
    residual, fdct, quantization (a 16x16 MB's DCs through Y2), dequant,
    idct, recon = clamp(pred + residual, 0, 255), and the MB's
    three-plane Q15 SSIM of source against recon (ssim_fx).

    state None: the first pass; every MB is active, and the state
    (levels_pack (mbc, 25, 16) i16: Y 16 zigzag blocks, U 4, V 4, Y2 (zero
    for split MBs); seg_ids (mbc,) i32; recon ry, ru, rv u8 planes;
    active (mbc,) bool; cur_ssim (mbc,) i32, every MB's score) is
    allocated and returned.  Otherwise the MBs whose state cur_ssim (as
    before the pass) is <= ssim_target are active, and `state` is updated
    in place for them (`active` for every MB) and returned: cur_ssim is
    where(active, new score, cur_ssim), the JAX `seg_pass`'s merge."""
    H, W = y.shape
    mbw, mbh = W // 16, H // 16
    y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac = (int(q) for q in quant)
    py, pu, pv = (p.to(_I32) for p in (pred_y, pred_u, pred_v))
    lz, y2z, rr = transform_mb_luma(
        _mb_blocks_luma(y.to(_I32) - py, mbw, mbh), parts, y_dc, y_ac,
        y2_dc, y2_ac)
    uz, ur = transform_mb_chroma(
        _mb_blocks_chroma(u.to(_I32) - pu, mbw, mbh), uv_dc, uv_ac)
    vz, vr = transform_mb_chroma(
        _mb_blocks_chroma(v.to(_I32) - pv, mbw, mbh), uv_dc, uv_ac)
    pack = torch.cat([lz, uz, vz, y2z[:, None]], dim=1).to(torch.int16)
    rec = [(plane(r, mbw, mbh) + p).clamp(0, 255).to(torch.uint8)
           for plane, r, p in ((_luma_from_mb_blocks, rr, py),
                               (_chroma_from_mb_blocks, ur, pu),
                               (_chroma_from_mb_blocks, vr, pv))]
    new_ssim = mb_ssim_fx_plain(y, rec[0], u, rec[1], v, rec[2])
    if state is None:
        mbc = mbw * mbh
        return (pack, torch.full((mbc,), sid, dtype=_I32, device=y.device),
                *rec, torch.ones((mbc,), dtype=torch.bool, device=y.device),
                new_ssim)
    levels_pack, seg_ids, ry, ru, rv, active, cur_ssim = state
    act = cur_ssim <= ssim_target
    active.copy_(act)
    levels_pack.copy_(torch.where(act[:, None, None], pack, levels_pack))
    seg_ids.copy_(torch.where(act, sid, seg_ids))
    for plane, new, n in zip((ry, ru, rv), rec, (16, 8, 8)):
        plane.copy_(_mb_where(act, new, plane, n))
    cur_ssim.copy_(torch.where(act, new_ssim, cur_ssim))
    return state


_STATE = ("levels_pack", "seg_ids", "ry", "ru", "rv", "active", "cur_ssim")


def _check_pass(planes, preds, parts, state) -> None:
    y = planes[0]
    H, W = y.shape if y.dim() == 2 else (0, 0)
    mbc = (H // 16) * (W // 16)
    shapes = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    if H == 0 or W == 0 or H % 16 or W % 16:
        raise ValueError(f"inter_pass: y must be an (H, W) plane of whole "
                         f"MBs, got {tuple(y.shape)}")
    ops = [(t, f"source {'yuv'[i]}", (torch.uint8,), shapes[i], False)
           for i, t in enumerate(planes)]
    ops += [(t, f"prediction {'yuv'[i]}",
             (torch.uint8, _I32) if i else (torch.uint8,), shapes[i], False)
            for i, t in enumerate(preds)]
    ops.append((parts, "parts", (_I32,), (mbc,), True))
    if state is not None:
        if len(state) != len(_STATE):
            raise ValueError(f"inter_pass: state is ({', '.join(_STATE)})")
        ops += [(t, what, (dt,), shape, True) for t, what, dt, shape in zip(
            state, _STATE, (torch.int16, _I32, torch.uint8, torch.uint8,
                            torch.uint8, torch.bool, _I32),
            ((mbc, 25, 16), (mbc,), *shapes, (mbc,), (mbc,)))]
    for t, what, dts, shape, contiguous in ops:
        if not isinstance(t, torch.Tensor) or t.device != y.device \
                or t.device.type != "cuda":
            raise ValueError(f"inter_pass: {what} must be a CUDA tensor on "
                             f"{y.device}, or every input on the CPU")
        layout_ok = t.is_contiguous() if contiguous else t.stride(-1) == 1
        if t.dtype not in dts or tuple(t.shape) != shape or not layout_ok:
            kind = "contiguous" if contiguous else "unit column stride"
            raise ValueError(f"inter_pass: {what} must be a "
                             f"{' or '.join(map(str, dts))} tensor of shape "
                             f"{shape} ({kind}), got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if preds[1].dtype != preds[2].dtype:
        raise ValueError(f"inter_pass: the chroma predictions must share a "
                         f"dtype, got {preds[1].dtype} and {preds[2].dtype}")
    if state is not None and state[0].data_ptr() % 16:
        raise ValueError("inter_pass: levels_pack must be 16-byte aligned")


def inter_pass(y, u, v, pred_y, pred_u, pred_v, parts, sid: int, quant,
               ssim_target: int = -1, state=None):
    """One segment pass with its SSIM (contract of `inter_pass_plain`):
    one launch of csrc/transform.cu's kernel for CUDA tensors (a u8 luma
    prediction and u8 or int32 chroma predictions of one type, as the
    inter path makes them), the plain version for CPU tensors."""
    if y.device.type == "cpu":
        return inter_pass_plain(y, u, v, pred_y, pred_u, pred_v, parts, sid,
                                quant, ssim_target, state)
    planes, preds = (y, u, v), (pred_y, pred_u, pred_v)
    _check_pass(planes, preds, parts, state)
    from vp8oclenc_tpu_torch.ops import cuda_build
    H, W = y.shape
    mbc = (H // 16) * (W // 16)
    first = state is None
    if first:
        dev = y.device
        state = (torch.empty((mbc, 25, 16), dtype=torch.int16, device=dev),
                 torch.empty((mbc,), dtype=_I32, device=dev),
                 *(torch.empty(p.shape, dtype=torch.uint8, device=dev)
                   for p in planes),
                 torch.empty((mbc,), dtype=torch.bool, device=dev),
                 torch.empty((mbc,), dtype=_I32, device=dev))
    levels_pack, seg_ids, ry, ru, rv, active, cur_ssim = state
    desc = []
    for t in (*planes, *preds, ry, ru, rv):
        desc += [t.data_ptr(), t.element_size(), t.stride(0)]
    rc = cuda_build.library("transform").vp8_inter_pass(
        (ctypes.c_longlong * len(desc))(*desc), _ptr(parts),
        _ptr(cur_ssim), _ptr(levels_pack),
        _ptr(seg_ids), _ptr(active), mbc, W // 16, int(sid), int(first),
        int(ssim_target), *(int(q) for q in quant),
        ctypes.c_void_p(torch.cuda.current_stream(y.device).cuda_stream))
    cuda_build.check(rc, "vp8_inter_pass")
    inter_pass.launches += 1
    return state


inter_pass.launches = 0


# ---------------------------------------------------------------------------
# the inter frame
# ---------------------------------------------------------------------------

def inter_body(y, u, v, states, ref_valid, quant, ssim_target: int = -1,
               shard=None):
    """Whole inter frame on one device, or one row shard of it.

    y (H, W), u/v (H/2, W/2) u8 source planes (MB-aligned); states: three
    `ref_state` tuples (LAST, GOLDEN, ALTREF; an unused reference may be
    any valid state); ref_valid: three bools; quant: the per-segment
    quantizers (y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac), each indexed by
    segment id and holding host ints; ssim_target: the 3-plane Q15 SSIM
    threshold, or -1 with SSIM control off.

    With SSIM control off every MB is coded once, in the LQ segment.  With
    it on, four passes LQ -> AQ -> HQ -> UQ re-code, each at its segment's
    quantizers, the MBs whose SSIM is still at or below the target (all
    four run under per-MB masks: nothing waits for the host), and then the
    batched intra replacement (ops/intra_replace.py) turns the MBs it
    applies into B_PRED MBs.

    Returns (levels_pack (mbc, 25, 16) i16: Y 16 blocks, U 4, V 4, Y2;
    meta (mbc, 11) i32: segment, partitioning, reference, 4 quarter
    vectors (x, y); cur_ssim (mbc,) i32; recon y, u, v u8; modes (mbc, 16)
    i8: the B_PRED modes of replaced MBs, zero elsewhere; replaced: 0-d i32
    count of replaced MBs), laid out as the JAX package lays them out;
    modes and replaced are None with SSIM control off.

    shard: None, or the row shard of a taller frame that y, u, v are (an
    object with `row0` and `full_h`, the frame's first row of the band and
    the frame's height, and the tile group's exchanges `all_gather_rows`
    and `from_above`, parallel/tile.TileShard).  The states are then the
    references' strips (parallel/tile.build_ref_strips), the search is
    `hierarchical_search` in shard mode, chroma is predicted from its strips,
    and the intra replacement takes its ghost rows and the winner flags of
    the band above.  Every output covers the band's MBs only."""
    H, W = y.shape
    mbw, mbh = W // 16, H // 16
    mbc = mbw * mbh
    nby, nbx = H // 8, W // 8
    dev = y.device
    ref_pyr = [torch.stack([s[0][lvl] for s in states]) for lvl in range(5)]
    cur_pyr = build_pyramid(y)
    if shard is None:
        vecs, diffs, best_pred = hierarchical_search(cur_pyr, ref_pyr)
    else:
        vecs, diffs, best_pred = hierarchical_search(
            cur_pyr, ref_pyr, shard.all_gather_rows(cur_pyr[2]), shard.row0,
            shard.full_h, PAD_Y_FULL)

    # reference selection: per MB the sum of its four 8x8 Bdiffs
    d = diffs.reshape(3, mbh, 2, mbw, 2).sum(dim=(2, 4), dtype=_I32) \
        .reshape(3, mbc)
    for r, ok in enumerate(ref_valid):
        if not ok:
            d[r].fill_(BIG * 4)      # fill_, not setitem: no host copy
    ref_sel = torch.where(d[0] <= d[2], 0, 2)
    ref_sel = torch.where(torch.minimum(d[0], d[2]) <= d[1], ref_sel, 1)

    q = vecs.reshape(3, mbh, 2, mbw, 2, 2).permute(0, 1, 3, 2, 4, 5) \
        .reshape(3, mbc, 4, 2)
    mvs = q[ref_sel, torch.arange(mbc, device=dev)]                 # (mbc,4,2)
    same = (mvs == mvs[:, :1, :]).flatten(1).all(dim=1)
    parts = torch.where(same, ARE16X16, ARE8X8).to(_I32)

    # luma prediction: each 8x8 block's qpel winner from its MB's reference
    blk = torch.arange(nby * nbx, device=dev)
    sel_blk = ref_sel.reshape(mbh, 1, mbw, 1).expand(mbh, 2, mbw, 2) \
        .reshape(-1)
    pred_y = _blocks8_to_plane(best_pred[sel_blk, blk], nby, nbx)
    pred_u, pred_v = mc_predict_selected_uv(
        torch.stack([s[1] for s in states]),
        torch.stack([s[2] for s in states]), mvs, ref_sel, H // 2,
        0 if shard is None else PAD_C_FULL)

    # progressive segment requantization LQ -> UQ: each pass codes and
    # scores the MBs whose SSIM is still at or below the target (every MB
    # in the first, where nothing is coded yet) and updates the state,
    # cur_ssim included, in place
    ssim_on = ssim_target >= 0
    state = None
    for i in range(4 if ssim_on else 1):
        sid = LQ_SEGMENT - i
        state = inter_pass(y, u, v, pred_y, pred_u, pred_v, parts, sid,
                           [q[sid] for q in quant], ssim_target, state)
    levels_pack, seg_ids, ry, ru, rv, _, cur_ssim = state

    modes = replaced = None
    if ssim_on:
        from vp8oclenc_tpu_torch.ops.intra_replace import intra_replace_device
        y_dc, y_ac, _, _, uv_dc, uv_ac = quant
        (applied, b_sid, b_modes, b_lv_y, b_lv_u, b_lv_v, b_ry, b_ru, b_rv,
         cur_ssim) = intra_replace_device(
            y, u, v, ry, ru, rv, cur_ssim, y_dc, y_ac, uv_dc, uv_ac,
            ssim_target, mbw, mbh, shard)
        seg_ids = torch.where(applied, b_sid, seg_ids)
        parts = torch.where(applied, ARE4X4, parts).to(_I32)
        # a replaced MB has no Y2
        b_pack = torch.cat([b_lv_y, b_lv_u, b_lv_v,
                            torch.zeros_like(b_lv_u[:, :1])], dim=1)
        levels_pack = torch.where(applied[:, None, None], b_pack,
                                  levels_pack)
        ry, ru, rv = (_mb_where(applied, b.reshape(
            mbh, mbw, n, n).transpose(1, 2), p, n).contiguous()
            for b, p, n in ((b_ry, ry, 16), (b_ru, ru, 8), (b_rv, rv, 8)))
        replaced = applied.sum(dtype=_I32)
        modes = torch.where(applied[:, None], b_modes, 0).to(torch.int8)

    meta = torch.cat([seg_ids[:, None], parts[:, None],
                      ref_sel.to(_I32)[:, None],
                      mvs.reshape(mbc, 8).to(_I32)], dim=1)
    return levels_pack, meta, cur_ssim, ry, ru, rv, modes, replaced
