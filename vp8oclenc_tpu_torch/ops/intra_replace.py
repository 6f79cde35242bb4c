"""Batched SSIM intra replacement: the PyTorch counterpart of the JAX
package's ops/intra_replace.py.

After the segment loop of an inter frame, every MB whose SSIM is still at
or below the target is tried as an intra MB (4x4 B_PRED luma, TM_PRED
chroma) at the AQ, HQ and UQ quantizers.  Every trial predicts from the
FROZEN pre-replacement reconstruction, and a winner is applied only when
none of the four neighbour MBs that feed its prediction (left, above-left,
above, above-right) also won.  That makes all trials independent, so one
trial is one batched step over all MBs:

  * the frozen neighbour rows and columns of every MB are cut from the
    planes (`_frozen_luma_neighbors`, `_frozen_chroma_neighbors`), border
    rules applied (127 above the frame, 129 left of it);
  * the luma trial walks the 16 blocks of an MB in raster order, each block
    reading the MB's own trial reconstruction for in-MB neighbours;
  * the chroma trial (TM_PRED), the MB's three-plane score and the merge
    of a strictly better score into the best-trial buffers follow;
  * the trials run AQ -> HQ -> UQ under per-MB masks; nothing on this path
    waits for the host.

Each trial is two steps with two versions each, one contract per step:
  * `trial_luma_plain` and `trial_chroma_merge_plain` (the chroma trial,
    the score and the merge): plain PyTorch on any device, the references
    the CUDA kernels are held against;
  * `trial_luma` and `trial_chroma_merge`: for CUDA tensors they launch
    the hand-written kernels of csrc/intra.cu and csrc/transform.cu (the
    latter reads its frozen neighbours from the recon planes itself), for
    CPU tensors they take the plain versions.
The suppression after the trials is plain PyTorch.

A row shard of a taller frame (the multi-GPU layer's tile ranks) needs
two things from the shard above: its last recon row of each plane (the
ghost row its first MB row predicts from) and its last MB row's winner
flags (for the suppression rule); the frame-top shard keeps the all-127
row and has no winners above.
"""
from __future__ import annotations

import ctypes
import math

import torch

from vp8oclenc_tpu_torch.ops import transforms as T
from vp8oclenc_tpu_torch.ops.intra import _first_min
from vp8oclenc_tpu_torch.ops.predict import bpred_all_modes, tm_predict_8x8
from vp8oclenc_tpu_torch.ssim_fx import mb_ssim_fx_16x16_plain

_I32 = torch.int32
_U8 = torch.uint8


def _plane_mb(plane: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W) -> (mbc, size, size) per-MB patches, the plane's dtype."""
    H, W = plane.shape
    b = plane.reshape(H // size, size, W // size, size)
    return b.transpose(1, 2).reshape(-1, size, size)


def _bordered_top_rows(recon: torch.Tensor, size: int, rpad: int,
                       ghost=None):
    """(mbh, 1 + W + rpad) rows above each MB row of a u8 plane: [corner,
    row, last pixel x rpad].  Above the frame everything is 127; below it
    the corner is 129.  ghost: None at the frame top, else the (W,) row
    above the plane (the last row of the row shard above)."""
    H, W = recon.shape
    above = recon[size - 1:H - 1:size]                        # (mbh - 1, W)
    if ghost is not None:
        above = torch.cat([ghost[None].to(_U8), above])
    n = above.shape[0]
    rest = torch.cat([torch.full((n, 1), 129, dtype=_U8,
                                 device=recon.device),
                      above, above[:, -1:].expand(n, rpad)], dim=1)
    if ghost is not None:
        return rest
    first = torch.full((1, 1 + W + rpad), 127, dtype=_U8,
                       device=recon.device)
    return torch.cat([first, rest], dim=0)


def _bordered_left_cols(recon: torch.Tensor, size: int, mbw: int, mbh: int):
    """(mbc, size) column left of each MB of a u8 plane; 129 left of the
    frame."""
    H, W = recon.shape
    cols = torch.cat([torch.full((H, 1), 129, dtype=_U8,
                                 device=recon.device),
                      recon[:, size - 1:W - 1:size]], dim=1)  # (H, mbw)
    return cols.reshape(mbh, size, mbw).permute(0, 2, 1).reshape(-1, size)


def _frozen_luma_neighbors(recon_y: torch.Tensor, mbw: int, mbh: int,
                           ghost=None):
    """Frozen per-MB neighbours from the pre-replacement luma recon (u8).

    Returns (ftop (mbc, 21) u8 = [P, A(x)..A(x+19)], fleft (mbc, 16) u8).
    Border rules: above row 127, left column 129, above-left 127 at the
    frame top and 129 below it; the above-right pixels of the MB's last
    block column come from the row above the MB, the row's last pixel
    replicated four times at the frame's right edge.  ghost: the row above
    a row shard (`_bordered_top_rows`)."""
    top = _bordered_top_rows(recon_y, 16, 4, ghost)           # (mbh, W + 5)
    ftop = top.unfold(1, 21, 16)                              # (mbh, mbw, 21)
    return (ftop.reshape(-1, 21).contiguous(),
            _bordered_left_cols(recon_y, 16, mbw, mbh).contiguous())


def _frozen_chroma_neighbors(recon_c: torch.Tensor, mbw: int, mbh: int,
                             ghost=None):
    """(ctop (mbc, 8), cleft (mbc, 8), ctl (mbc,)) u8 of one chroma plane:
    top 127, left 129, top-left 127 at the frame top and 129 at its left;
    ghost as in `_frozen_luma_neighbors`."""
    top = _bordered_top_rows(recon_c, 8, 0, ghost)            # (mbh, W2 + 1)
    ctop = top[:, 1:].unfold(1, 8, 8)                         # (mbh, mbw, 8)
    ctl = top[:, 0:-1:8]                                      # (mbh, mbw)
    return (ctop.reshape(-1, 8), _bordered_left_cols(recon_c, 8, mbw, mbh),
            ctl.reshape(-1))


def trial_state(y_mb: torch.Tensor, ftop: torch.Tensor,
                fleft: torch.Tensor):
    """The working state of a luma trial, filled by `trial_step`.

    "edge" (mbc, 17, 21) int32 holds, per MB, every pixel a block may
    predict from at [1 + row, 1 + col]: the frozen row above the MB (row
    -1: P, A0..A19), the frozen column left of it (col -1), the MB's own
    trial reconstruction (rows and cols 0..15, zeros until coded), and
    ftop[17:21] again at cols 16..19 of rows 3, 7 and 11, where block
    column 3 of block rows 1..3 finds its above-right pixels.  Every block
    then reads the same way (A = row r0-1, cols c0..c0+7; L = col c0-1,
    rows r0..r0+3; P = (r0-1, c0-1))."""
    mbc = y_mb.shape[0]
    edge = torch.zeros((mbc, 17, 21), dtype=_I32, device=y_mb.device)
    edge[:, 0] = ftop.to(_I32)
    edge[:, 1:, 0] = fleft.to(_I32)
    edge[:, 4::4, 17:] = ftop[:, None, 17:].to(_I32)
    return {"src": y_mb.to(_I32), "edge": edge,
            "levels": torch.zeros((mbc, 16, 16), dtype=_I32,
                                  device=y_mb.device),
            "modes": torch.zeros((mbc, 16), dtype=_I32, device=y_mb.device)}


def trial_step(st, mb: torch.Tensor, blk: torch.Tensor, dc_q: int,
               ac_q: int) -> None:
    """Code block `blk` (in-MB raster index) of MB `mb` (index tensors of
    one length) in the state `st`.  A block's left, above, above-left and,
    for block columns 0..2, above-right neighbours inside the MB must be
    coded; every read of a call happens before its writes, so the blocks of
    one call must not depend on each other."""
    edge = st["edge"]
    r0, c0 = (blk // 4) * 4, (blk % 4) * 4
    k = torch.arange(8, device=edge.device)
    A = edge[mb[:, None], r0[:, None], c0[:, None] + 1 + k]      # (K, 8)
    L = edge[mb[:, None], r0[:, None] + 1 + k[:4], c0[:, None]]  # (K, 4)
    P = edge[mb, r0, c0]
    rows = r0[:, None] + k[:4]
    cols = c0[:, None] + k[:4]
    src = st["src"][mb[:, None, None], rows[:, :, None], cols[:, None, :]]
    preds = bpred_all_modes(A, L, P)                         # (K, 10, 4, 4)
    mode = _first_min(T.dct_weight(src[:, None] - preds))
    pred = preds[torch.arange(len(mb), device=edge.device), mode]
    lev = T.quant4x4(T.fdct4x4(src - pred), dc_q, ac_q)
    edge[mb[:, None, None], 1 + rows[:, :, None], 1 + cols[:, None, :]] = \
        torch.clamp(T.idct4x4(T.dequant4x4(lev, dc_q, ac_q)) + pred, 0, 255)
    st["levels"][mb, blk] = T.zigzag(lev)
    st["modes"][mb, blk] = mode


def trial_result(st):
    """(levels i16, modes i8, rec u8) of a finished state, in the layout
    of `trial_luma_plain`."""
    return (st["levels"].to(torch.int16), st["modes"].to(torch.int8),
            st["edge"][:, 1:, 1:17].to(_U8))


def trial_luma_plain(y_mb: torch.Tensor, ftop: torch.Tensor,
                     fleft: torch.Tensor, dc_q: int, ac_q: int):
    """One whole-frame batched B_PRED trial at fixed quantizers.

    y_mb (mbc, 16, 16) u8 source patches; ftop (mbc, 21) u8 and fleft
    (mbc, 16) u8 frozen neighbours (`_frozen_luma_neighbors`).  The 16
    blocks of an MB are coded in raster order; a block inside the MB reads
    the MB's own trial reconstruction, a block on its top row or left
    column the frozen neighbours, and the above-right of block column 3 in
    rows 1-3 is ftop[17:21] (the row above the MB).  The earliest mode of
    least cost wins.  Returns (levels (mbc, 16, 16) i16 zigzag, modes
    (mbc, 16) i8, rec (mbc, 16, 16) u8)."""
    mbc = y_mb.shape[0]
    st = trial_state(y_mb, ftop, fleft)
    mb = torch.arange(mbc, device=y_mb.device)
    for b in range(16):
        trial_step(st, mb, torch.full_like(mb, b), dc_q, ac_q)
    return trial_result(st)


def trial_luma(y_mb: torch.Tensor, ftop: torch.Tensor, fleft: torch.Tensor,
               dc_q: int, ac_q: int):
    """Frozen-neighbour luma trial (contract of `trial_luma_plain`): the
    csrc/intra.cu kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if y_mb.device.type == "cpu":
        return trial_luma_plain(y_mb, ftop, fleft, dc_q, ac_q)
    mbc = y_mb.shape[0]
    for t, what, shape in ((y_mb, "y_mb", (mbc, 16, 16)),
                           (ftop, "ftop", (mbc, 21)),
                           (fleft, "fleft", (mbc, 16))):
        if t.device != y_mb.device or t.device.type != "cuda":
            raise ValueError(f"trial_luma: {what} must be a CUDA tensor on "
                             f"{y_mb.device}, or every input on the CPU")
        if t.dtype != _U8 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"trial_luma: {what} must be a contiguous uint8 "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    from vp8oclenc_tpu_torch.ops import cuda_build
    dev = y_mb.device
    levels = torch.empty((mbc, 16, 16), dtype=torch.int16, device=dev)
    modes = torch.empty((mbc, 16), dtype=torch.int8, device=dev)
    rec = torch.empty((mbc, 16, 16), dtype=_U8, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = cuda_build.library("intra").vp8_trial_luma(
        ptr(y_mb), ptr(ftop), ptr(fleft), ptr(levels), ptr(modes), ptr(rec),
        mbc, int(dc_q), int(ac_q),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(rc, "vp8_trial_luma")
    trial_luma.launches += 1
    return levels, modes, rec


trial_luma.launches = 0


def _trial_chroma(c_mb, ctop, cleft, ctl, dc_q: int, ac_q: int):
    """Batched TM_PRED chroma trial of one plane: c_mb (mbc, 8, 8) source
    patches and the frozen neighbours -> (levels (mbc, 4, 16) zigzag i32,
    rec (mbc, 8, 8) i32)."""
    mbc = c_mb.shape[0]
    blocks = lambda a: a.reshape(mbc, 2, 4, 2, 4).permute(0, 1, 3, 2, 4)
    pred = tm_predict_8x8(ctop.to(_I32), cleft.to(_I32), ctl.to(_I32))
    lev = T.quant4x4(T.fdct4x4(blocks(c_mb.to(_I32) - pred)), dc_q, ac_q)
    rec = torch.clamp(T.idct4x4(T.dequant4x4(lev, dc_q, ac_q))
                      + blocks(pred), 0, 255)
    return (T.zigzag(lev).reshape(mbc, 4, 16),
            rec.permute(0, 1, 3, 2, 4).reshape(mbc, 8, 8))


def trial_chroma_plain(u_mb, v_mb, un, vn, dc_q: int, ac_q: int):
    """The chroma trial of both planes: u_mb, v_mb (mbc, 8, 8) u8 source
    patches, un and vn each (ctop (mbc, 8), cleft (mbc, 8), ctl (mbc,)) u8
    frozen neighbours (`_frozen_chroma_neighbors`).  Returns (levels_u,
    rec_u, levels_v, rec_v) as `_trial_chroma` gives them."""
    return (*_trial_chroma(u_mb, *un, dc_q, ac_q),
            *_trial_chroma(v_mb, *vn, dc_q, ac_q))


# The merge state of one frame's trials, carved from one zeroed byte
# buffer: (name, dtype, per-MB shape).  The fields whose rows are whole
# multiples of 16 bytes come first, so that every field starts 16-byte
# aligned.
_MERGE_FIELDS = (("lv_y", torch.int16, (16, 16)),
                 ("lv_u", torch.int16, (4, 16)),
                 ("lv_v", torch.int16, (4, 16)),
                 ("rec_y", _U8, (16, 16)),
                 ("rec_u", _U8, (8, 8)),
                 ("rec_v", _U8, (8, 8)),
                 ("modes", torch.int8, (16,)),
                 ("sid", _I32, ()),
                 ("cur", _I32, ()),
                 ("win", torch.bool, ()))


def merge_state(mbc: int, device) -> dict:
    """The trials' merge state of mbc MBs, zeroed in one launch: "cur"
    (mbc,) i32, the score after the trials so far (written by the first
    trial); "win" (mbc,) bool, some trial won; and the best trial of each
    MB: "sid" (mbc,) i32, "modes" (mbc, 16) i8, "lv_y" (mbc, 16, 16),
    "lv_u", "lv_v" (mbc, 4, 16) i16 zigzag levels, "rec_y" (mbc, 16, 16),
    "rec_u", "rec_v" (mbc, 8, 8) u8."""
    sizes = [mbc * math.prod(shape) * dt.itemsize
             for _, dt, shape in _MERGE_FIELDS]
    buf = torch.zeros(sum(sizes), dtype=_U8, device=device)
    st, off = {}, 0
    for (name, dt, shape), n in zip(_MERGE_FIELDS, sizes):
        st[name] = buf[off:off + n].view(dt).view(mbc, *shape)
        off += n
    return st


def trial_chroma_merge_plain(y_mb, luma, u, v, ru, rv, ghosts, cur_in, st,
                             sid: int, dc_q: int, ac_q: int,
                             ssim_target: int) -> None:
    """The second half of one trial, in place on the merge state `st`
    (`merge_state`).

    y_mb (mbc, 16, 16) u8 luma source patches; luma = (levels, modes, rec)
    of `trial_luma` on them; u, v (8 mbh, 8 mbw) u8 source planes; ru, rv
    the frozen u8 recon planes; ghosts (gu, gv): the rows above ru and rv
    in a row shard (`_bordered_top_rows`), or (None, None) at the frame
    top; cur_in (mbc,) i32: the score before this trial (st["cur"] itself
    after the first).  The chroma trial of both planes at (dc_q, ac_q) from
    the frozen neighbours, the MB's three-plane score against the luma
    trial's recon, and where cur_in <= ssim_target and the score beats
    cur_in strictly: st["cur"] = score, st["win"] set, the trial (with
    `sid`) in the best fields.  Elsewhere st["cur"] = cur_in."""
    lv_y, md, ry_t = luma
    mbh, mbw = ru.shape[0] // 8, ru.shape[1] // 8
    u_mb, v_mb = _plane_mb(u, 8), _plane_mb(v, 8)
    trial = trial_chroma_plain(
        u_mb, v_mb, _frozen_chroma_neighbors(ru, mbw, mbh, ghosts[0]),
        _frozen_chroma_neighbors(rv, mbw, mbh, ghosts[1]), dc_q, ac_q)
    lv_u, ru_t, lv_v, rv_t = trial
    test = mb_ssim_fx_16x16_plain(y_mb, ry_t, u_mb, ru_t, v_mb, rv_t)
    better = (cur_in <= ssim_target) & (test > cur_in)
    st["cur"].copy_(torch.where(better, test, cur_in))
    st["win"] |= better
    for name, t in (("sid", torch.full_like(cur_in, sid)), ("modes", md),
                    ("lv_y", lv_y), ("lv_u", lv_u), ("lv_v", lv_v),
                    ("rec_y", ry_t), ("rec_u", ru_t), ("rec_v", rv_t)):
        b = st[name]
        b.copy_(torch.where(better.reshape(-1, *([1] * (b.dim() - 1))),
                            t.to(b.dtype), b))


def _merge_operand(t, what, dev, dtype, shape, rows=False, aligned=False):
    """Refuse an operand of `trial_chroma_merge` that is not on the CUDA
    device dev, of dtype and shape, and contiguous (for aligned=True also
    16-byte aligned: the kernel moves its rows as vectors) or, for
    rows=True, a plane of unit column stride."""
    if t.device != dev:
        raise ValueError(f"trial_chroma_merge: {what} must be a CUDA tensor "
                         f"on {dev}, or every input on the CPU; got "
                         f"{t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape or (
            t.stride(-1) != 1 if rows
            else not t.is_contiguous() or aligned and t.data_ptr() % 16):
        kind = "unit column stride" if rows else \
            "16-byte aligned contiguous" if aligned else "contiguous"
        raise ValueError(f"trial_chroma_merge: {what} must be a {kind} "
                         f"{dtype} tensor of shape {shape}, got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()}")


def trial_chroma_merge(y_mb, luma, u, v, ru, rv, ghosts, cur_in, st,
                       sid: int, dc_q: int, ac_q: int,
                       ssim_target: int) -> None:
    """The second half of one trial (contract of `trial_chroma_merge_plain`):
    one csrc/transform.cu launch for CUDA tensors, the plain version for
    CPU tensors."""
    if y_mb.device.type == "cpu":
        return trial_chroma_merge_plain(y_mb, luma, u, v, ru, rv, ghosts,
                                        cur_in, st, sid, dc_q, ac_q,
                                        ssim_target)
    dev = y_mb.device
    if dev.type != "cuda":
        raise ValueError(f"trial_chroma_merge: operands must lie on a CUDA "
                         f"device or on the CPU, got {dev}")
    mbc = y_mb.shape[0]
    h2, w2 = ru.shape
    if h2 % 8 or w2 % 8 or (h2 // 8) * (w2 // 8) != mbc:
        raise ValueError(f"trial_chroma_merge: a recon plane of {h2}x{w2} "
                         f"does not hold {mbc} MBs")
    lv_y, md, ry_t = luma
    ops = []
    for t, what, dt, shape in ((y_mb, "y_mb", _U8, (mbc, 16, 16)),
                               (ry_t, "the luma recon", _U8, (mbc, 16, 16)),
                               (lv_y, "the luma levels", torch.int16,
                                (mbc, 16, 16)),
                               (md, "the luma modes", torch.int8, (mbc, 16))):
        _merge_operand(t, what, dev, dt, shape, aligned=True)
        ops.append(t.data_ptr())
    for t, what in ((u, "u"), (v, "v"), (ru, "ru"), (rv, "rv")):
        _merge_operand(t, what, dev, _U8, (h2, w2), rows=True)
        ops += [t.data_ptr(), t.stride(0)]
    if (ghosts[0] is None) != (ghosts[1] is None):
        raise ValueError("trial_chroma_merge: both ghost rows or neither")
    for g in ghosts:
        if g is not None:
            _merge_operand(g, "a ghost row", dev, _U8, (w2,))
        ops.append(0 if g is None else g.data_ptr())
    _merge_operand(cur_in, "cur_in", dev, _I32, (mbc,))
    ops.append(cur_in.data_ptr())
    fields = {name: (dt, shape) for name, dt, shape in _MERGE_FIELDS}
    for name in ("cur", "win", "sid", "modes", "lv_y", "lv_u", "lv_v",
                 "rec_y", "rec_u", "rec_v"):
        dt, shape = fields[name]
        _merge_operand(st[name], f'st["{name}"]', dev, dt, (mbc, *shape),
                       aligned=bool(shape))
        ops.append(st[name].data_ptr())
    from vp8oclenc_tpu_torch.ops import cuda_build
    rc = cuda_build.library("transform").vp8_trial_chroma_merge(
        (ctypes.c_longlong * len(ops))(*ops), mbc, w2 // 8, int(sid),
        int(ssim_target), int(dc_q), int(ac_q),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_build.check(rc, "vp8_trial_chroma_merge")
    trial_chroma_merge.launches += 1


trial_chroma_merge.launches = 0


def intra_replace_device(y, u, v, recon_y, recon_u, recon_v, cur_ssim,
                         seg_y_dc, seg_y_ac, seg_uv_dc, seg_uv_ac,
                         ssim_target: int, mbw: int, mbh: int, shard=None):
    """The whole batched controller on one device.

    y, u, v and recon_*: whole u8 planes, the recon frozen as the segment
    loop left it; cur_ssim (mbc,) i32: the per-MB Q15 SSIM after that
    loop; seg_*: per-segment quantizers (host ints); ssim_target: the Q15
    threshold.  Returns (applied (mbc,) bool, sid (mbc,) i32, modes
    (mbc, 16), lv_y (mbc, 16, 16), lv_u, lv_v (mbc, 4, 16), rec_y
    (mbc, 16, 16), rec_u, rec_v (mbc, 8, 8), new_cur (mbc,) i32); the
    per-MB entries are meaningful where `applied` is set.

    shard: None, or the row shard the planes are (ops/inter.inter_body);
    its `from_above(t)` returns the shard above's t, or None at the frame
    top."""
    ghosts = (None, None, None) if shard is None else \
        shard.from_above([p[-1] for p in (recon_y, recon_u, recon_v)])
    ftop, fleft = _frozen_luma_neighbors(recon_y, mbw, mbh, ghosts[0])
    y_mb = _plane_mb(y, 16).contiguous()

    st = merge_state(mbw * mbh, y.device)
    cur = cur_ssim
    for sid in (2, 1, 0):            # AQ -> HQ -> UQ
        luma = trial_luma(y_mb, ftop, fleft, int(seg_y_dc[sid]),
                          int(seg_y_ac[sid]))
        # strictly better only; a later, finer trial overwrites an earlier
        # winner
        trial_chroma_merge(y_mb, luma, u, v, recon_u, recon_v, ghosts[1:],
                           cur, st, sid, int(seg_uv_dc[sid]),
                           int(seg_uv_ac[sid]), ssim_target)
        cur = st["cur"]
    win = st["win"]

    # suppression: a winner is applied only when none of the 4 neighbour MBs
    # feeding its prediction (left, above-left, above, above-right) also won
    top_win = None if shard is None else shard.from_above([win[-mbw:]])[0]
    if top_win is None:
        top_win = torch.zeros_like(win[:mbw])
    pw = torch.nn.functional.pad(torch.cat([top_win, win]).reshape(
        mbh + 1, mbw), (1, 1))
    conflict = pw[1:, :-2] | pw[:-1, :-2] | pw[:-1, 1:-1] | pw[:-1, 2:]
    applied = win & ~conflict.reshape(-1)
    new_cur = torch.where(applied, cur, cur_ssim)
    return (applied, *(st[k] for k in ("sid", "modes", "lv_y", "lv_u", "lv_v",
                                       "rec_y", "rec_u", "rec_v")), new_cur)
