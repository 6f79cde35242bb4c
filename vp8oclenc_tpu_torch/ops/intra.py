"""Keyframe (intra) pixel path: the PyTorch counterpart of the JAX package's
ops/intra.py.

Luma is sequential 4x4 B_PRED with the VP8 border rules, scheduled as the
anti-diagonal wavefront d = bx + 2*by over the 4x4-block grid
(`luma_step` on the blocks of one diagonal; the kernel orders them by the
weaker rule "block (bx, by) after (bx+1, by-1)", which
tests/test_torch_wavefront_order.py holds against this one): a block
reads only its left, above and above-right neighbours (the above-right of
an MB's last block column comes from the row above the whole MB), all of
which lie on earlier diagonals.  Chroma is whole-MB TM_PRED for U and V
together, on the wavefront d = mbx + mby (`chroma_step`; the kernel's
rule is "MB (bx, by) after (bx, by-1)", a lag of one, held against this
one by the same test).

Each wavefront has two versions with one contract:
  * `*_plain`: plain PyTorch, one vectorized step per diagonal; it runs on
    any device and is the reference the CUDA kernel is held against;
  * the wrapper (`luma_wavefront`, `chroma_wavefront`): for a CUDA tensor
    it launches the hand-written kernel from csrc/, for a CPU tensor it
    takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from vp8oclenc_tpu_torch.ops import transforms as T
from vp8oclenc_tpu_torch.ops.predict import bpred_all_modes, tm_predict_8x8

_I32 = torch.int32


def _first_min(costs: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (strict <), written
    out rather than left to argmin's tie rule on each device."""
    best = costs[..., 0]
    mode = torch.zeros_like(best)
    for m in range(1, costs.shape[-1]):
        better = costs[..., m] < best
        best = torch.where(better, costs[..., m], best)
        mode = torch.where(better, torch.full_like(mode, m), mode)
    return mode


def _luma_neighbors(rec: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
                    w4: int):
    """A (K, 8) above incl. above-right, L (K, 4) left, P (K,) above-left
    of the luma blocks at (by, bx), int32, with the VP8 border rules: 127
    above the frame, 129 left of it; the above-right of an MB's last block
    column comes from the row above the MB (127 in the top MB row, the
    replicated last pixel at the frame's right edge)."""
    ar4 = torch.arange(4, device=rec.device)
    x = bx * 4
    yy = by * 4
    row_above = torch.clamp(yy - 1, min=0)
    a03 = rec[row_above[:, None], x[:, None] + ar4[None, :]]
    mb_top = (by // 4) * 16
    is3 = bx % 4 == 3
    tr_row = torch.where(is3, torch.clamp(mb_top - 1, min=0), row_above)
    tr_cols = torch.clamp(x[:, None] + 4 + ar4[None, :], max=w4 * 4 - 1)
    a47 = rec[tr_row[:, None], tr_cols]
    rep = rec[torch.clamp(mb_top - 1, min=0),
              torch.clamp(x + 3, max=w4 * 4 - 1)]
    a47 = torch.where(((bx == w4 - 1) & is3)[:, None], rep[:, None], a47)
    a47 = torch.where((is3 & (mb_top == 0))[:, None], 127, a47)
    A = torch.cat([a03, a47], dim=1)
    A = torch.where((by == 0)[:, None], 127, A)

    col_left = torch.clamp(x - 1, min=0)
    L = rec[yy[:, None] + ar4[None, :], col_left[:, None]]
    L = torch.where((bx == 0)[:, None], 129, L)

    P = rec[row_above, col_left]
    P = torch.where(by == 0, 127, torch.where(bx == 0, 129, P))
    return A, L, P


def _mb_order(a: torch.Tensor, h4: int, w4: int) -> torch.Tensor:
    """(h4*w4, ...) block raster -> (mbc, 16, ...) in-MB raster order."""
    tail = a.shape[1:]
    mbw = w4 // 4
    return a.reshape(h4 // 4, 4, mbw, 4, *tail).transpose(1, 2) \
        .reshape((h4 // 4) * mbw, 16, *tail)


def luma_state(y: torch.Tensor):
    """The working state of a frame's luma encode: source blocks, the int32
    reconstruction (zeros where nothing is coded yet) and the per-block
    levels and modes, filled by `luma_step`."""
    H, W = y.shape
    h4, w4 = H // 4, W // 4
    dev = y.device
    return {"src4": y.to(_I32).reshape(h4, 4, w4, 4),
            "rec": torch.zeros((H, W), dtype=_I32, device=dev),
            "levels": torch.zeros((h4, w4, 16), dtype=_I32, device=dev),
            "modes": torch.zeros((h4, w4), dtype=_I32, device=dev)}


def luma_step(st, by, bx, dc_q: int, ac_q: int) -> None:
    """Code the 4x4 blocks (by, bx) (index tensors of one length) of the
    state `st`.  A block's left, above and above-right neighbours (for an
    MB's last block column: the row above the MB) must be coded, and the
    blocks of one call must not be neighbours of each other."""
    rec = st["rec"]
    h4, _, w4, _ = st["src4"].shape
    A, L, P = _luma_neighbors(rec, by, bx, w4)
    src = st["src4"][by, :, bx, :]                          # (K, 4, 4)
    preds = bpred_all_modes(A, L, P)                        # (K, 10, 4, 4)
    mode = _first_min(T.dct_weight(src[:, None] - preds))
    pred = preds[torch.arange(len(by), device=rec.device), mode]
    lev = T.quant4x4(T.fdct4x4(src - pred), dc_q, ac_q)
    rec.view(h4, 4, w4, 4)[by, :, bx, :] = torch.clamp(
        T.idct4x4(T.dequant4x4(lev, dc_q, ac_q)) + pred, 0, 255)
    st["levels"][by, bx] = T.zigzag(lev)
    st["modes"][by, bx] = mode


def luma_result(st):
    """(recon u8, levels i16, modes i8) of a finished state, in the layout
    of `luma_wavefront_plain`."""
    h4, _, w4, _ = st["src4"].shape
    return (st["rec"].to(torch.uint8),
            _mb_order(st["levels"].reshape(h4 * w4, 16), h4, w4)
            .to(torch.int16),
            _mb_order(st["modes"].reshape(h4 * w4), h4, w4).to(torch.int8))


def luma_wavefront_plain(y: torch.Tensor, dc_q: int, ac_q: int):
    """Sequential 4x4 B_PRED encode of a (h4*4, w4*4) u8 luma plane.

    Returns (recon u8 (H, W), levels (mbc, 16, 16) i16 zigzag with the 16
    blocks in in-MB raster order, modes (mbc, 16) i8)."""
    H, W = y.shape
    h4, w4 = H // 4, W // 4
    st = luma_state(y)
    bands = torch.arange(h4, device=y.device)
    D = (w4 - 1) + 2 * (h4 - 1) + 1
    for d in range(D):
        lo = max(0, (d - (w4 - 1) + 1) // 2)
        by = bands[lo:min(h4 - 1, d // 2) + 1]
        luma_step(st, by, d - 2 * by, dc_q, ac_q)
    return luma_result(st)


def chroma_state(uv: torch.Tensor):
    """The working state of a frame's chroma encode: source MBs of both
    planes, the int32 reconstruction (zeros where nothing is coded yet)
    and the per-MB levels, filled by `chroma_step`."""
    _, H2, W2 = uv.shape
    mbh, mbw = H2 // 8, W2 // 8
    dev = uv.device
    return {"src8": uv.to(_I32).reshape(2, mbh, 8, mbw, 8),
            "rec": torch.zeros((2, H2, W2), dtype=_I32, device=dev),
            "levels": torch.zeros((2, mbh, mbw, 4, 16), dtype=_I32,
                                  device=dev)}


def chroma_step(st, by, bx, dc_q: int, ac_q: int) -> None:
    """Code the chroma MBs (by, bx) (index tensors of one length) of both
    planes of the state `st`.  An MB's left and above neighbours must be
    coded (TM_PRED reads the right column of the one, the bottom line of
    the other and, as its corner, the last pixel of the above-left MB's
    bottom line; nothing above-right), and the MBs of one call must not be
    neighbours of each other."""
    rec = st["rec"]
    dev = rec.device
    _, mbh, _, mbw, _ = st["src8"].shape
    ar8 = torch.arange(8, device=dev)
    row_above = torch.clamp(by * 8 - 1, min=0)
    col_left = torch.clamp(bx * 8 - 1, min=0)
    top = rec[:, row_above[:, None], bx[:, None] * 8 + ar8[None, :]]
    top = torch.where((by == 0)[None, :, None], 127, top)
    left = rec[:, by[:, None] * 8 + ar8[None, :], col_left[:, None]]
    left = torch.where((bx == 0)[None, :, None], 129, left)
    tl = rec[:, row_above, col_left]
    tl = torch.where((by == 0)[None, :], 127,
                     torch.where((bx == 0)[None, :], 129, tl))
    pred = tm_predict_8x8(top, left, tl)                     # (2, K, 8, 8)
    src = st["src8"][:, by, :, bx, :].transpose(0, 1)        # (2, K, 8, 8)
    quads = lambda a: a.reshape(2, -1, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5)
    lev = T.quant4x4(T.fdct4x4(quads(src - pred)), dc_q, ac_q)
    rq = torch.clamp(T.idct4x4(T.dequant4x4(lev, dc_q, ac_q))
                     + quads(pred), 0, 255)
    rec.view(2, mbh, 8, mbw, 8)[:, by, :, bx, :] = \
        rq.permute(0, 1, 2, 4, 3, 5).reshape(2, -1, 8, 8).transpose(0, 1)
    st["levels"][:, by, bx] = T.zigzag(lev).reshape(2, -1, 4, 16)


def chroma_result(st):
    """(recon u8, levels i16) of a finished state, in the layout of
    `chroma_wavefront_plain`."""
    _, mbh, _, mbw, _ = st["src8"].shape
    return (st["rec"].to(torch.uint8),
            st["levels"].reshape(2, mbh * mbw, 4, 16).to(torch.int16))


def chroma_wavefront_plain(uv: torch.Tensor, dc_q: int, ac_q: int):
    """Sequential TM_PRED encode of U and V together: uv (2, mbh*8, mbw*8)
    u8 -> (recon (2, mbh*8, mbw*8) u8, levels (2, mbc, 4, 16) i16 zigzag,
    the 4 blocks of each MB in raster order)."""
    _, H2, W2 = uv.shape
    mbh, mbw = H2 // 8, W2 // 8
    st = chroma_state(uv)
    bands = torch.arange(mbh, device=uv.device)
    for d in range(mbw + mbh - 1):
        by = bands[max(0, d - mbw + 1):min(mbh - 1, d) + 1]
        chroma_step(st, by, d - by, dc_q, ac_q)
    return chroma_result(st)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_plane(t: torch.Tensor, ndim: int, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != torch.uint8 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D uint8 "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def luma_wavefront(y: torch.Tensor, dc_q: int, ac_q: int):
    """Luma B_PRED wavefront (contract of `luma_wavefront_plain`): the
    csrc/intra.cu kernel for a CUDA tensor, the plain version for a CPU
    one."""
    if y.device.type == "cpu":
        return luma_wavefront_plain(y, dc_q, ac_q)
    _check_plane(y, 2, "luma_wavefront")
    H, W = y.shape
    if H % 16 or W % 16:
        raise ValueError(f"luma_wavefront: {W}x{H} is not MB-aligned")
    from vp8oclenc_tpu_torch.ops import cuda_build
    mbc = (H // 16) * (W // 16)
    if y.data_ptr() % 16:           # the kernel loads 16 bytes at a time
        y = y.clone()
    recon = torch.empty_like(y)
    levels = torch.empty((mbc, 16, 16), dtype=torch.int16, device=y.device)
    modes = torch.empty((mbc, 16), dtype=torch.int8, device=y.device)
    # the kernel's per-MB-row progress counters and its row ticket: a fresh
    # zeroed buffer per call (one fill on the caller's stream, no host
    # sync), so frames in flight never share counters
    sync = torch.zeros(H // 16 + 1, dtype=torch.int32, device=y.device)
    lib = cuda_build.library("intra")
    rc = lib.vp8_luma_wavefront(
        _ptr(y), _ptr(recon), _ptr(levels), _ptr(modes), _ptr(sync), W // 4,
        H // 4, int(dc_q), int(ac_q), _stream(y))
    cuda_build.check(rc, "vp8_luma_wavefront")
    luma_wavefront.launches += 1
    return recon, levels, modes


luma_wavefront.launches = 0


def chroma_wavefront(uv: torch.Tensor, dc_q: int, ac_q: int):
    """Chroma TM_PRED wavefront (contract of `chroma_wavefront_plain`):
    the csrc/intra.cu kernel for a CUDA tensor, the plain version for a
    CPU one."""
    if uv.device.type == "cpu":
        return chroma_wavefront_plain(uv, dc_q, ac_q)
    _check_plane(uv, 3, "chroma_wavefront")
    _, H2, W2 = uv.shape
    if uv.shape[0] != 2 or H2 % 8 or W2 % 8:
        raise ValueError(f"chroma_wavefront: bad shape {tuple(uv.shape)}")
    from vp8oclenc_tpu_torch.ops import cuda_build
    mbc = (H2 // 8) * (W2 // 8)
    if uv.data_ptr() % 16:          # the kernel loads 16 bytes at a time
        uv = uv.clone()
    recon = torch.empty_like(uv)
    levels = torch.empty((2, mbc, 4, 16), dtype=torch.int16, device=uv.device)
    # per-plane, per-MB-row progress counters and the row ticket, zeroed
    # per call as in `luma_wavefront`
    sync = torch.zeros(2 * (H2 // 8) + 1, dtype=torch.int32, device=uv.device)
    lib = cuda_build.library("intra")
    rc = lib.vp8_chroma_wavefront(
        _ptr(uv), _ptr(recon), _ptr(levels), _ptr(sync), W2 // 8, H2 // 8,
        int(dc_q), int(ac_q), _stream(uv))
    cuda_build.check(rc, "vp8_chroma_wavefront")
    chroma_wavefront.launches += 1
    return recon, levels


chroma_wavefront.launches = 0


def intra_body(y, u, v, y_dc_q: int, y_ac_q: int, uv_dc_q: int,
               uv_ac_q: int):
    """Whole-frame keyframe encode of u8 planes on one device.

    Returns (recon_y, recon_u, recon_v u8, levels_pack (mbc, 25, 16) i16
    with Y 16 blocks, U 4, V 4 and a zero Y2 row, modes (mbc, 16) i8)."""
    recon_y, levels_y, modes = luma_wavefront(y, y_dc_q, y_ac_q)
    recon_uv, levels_uv = chroma_wavefront(torch.stack([u, v]), uv_dc_q,
                                           uv_ac_q)
    mbc = levels_y.shape[0]
    levels_pack = torch.cat(
        [levels_y, levels_uv[0], levels_uv[1],
         torch.zeros((mbc, 1, 16), dtype=torch.int16, device=y.device)],
        dim=1)
    return recon_y, recon_uv[0], recon_uv[1], levels_pack, modes
