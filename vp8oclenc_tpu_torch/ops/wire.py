"""Compacted wire format of one frame's (or one row shard's) entropy
inputs: the PyTorch counterpart of the JAX package's ops/wire.py.

Coefficient levels are mostly zero, so what a tile rank sends its lane's
leader is a small fixed-size HEAD and a BODY of which only the used prefix
travels, in place of the dense int16 levels (6.5 MB a 1080p frame):

HEAD (fixed, ~31 B/MB):
  [0:4]    n_active  i32   number of 4x4 blocks with any nonzero level
  [4:8]    flags     i32   bit0: escape overflow somewhere (dense levels
                           must be sent instead)
  [8:12]   ssim_min  i32   per-MB Q15 SSIM aggregates (the weaken-filter
  [12:16]  sum_hi    i32   and redo rules); the sum travels as 12-bit
  [16:20]  sum_lo    i32   hi/lo words of the biased per-MB score so that
                           it cannot wrap int32 at any frame size:
                           sum_fx = (hi<<12) + lo - 98304*mbc
  [20:24]  replaced  i32   SSIM-controller intra-replaced MB count
  [24:+ceil(25*mbc/8)]     active-block bitmap (little-endian bits)
  [+mbc*20]                meta8: seg, part, ref, esc_ovf, mvs 8xi16
  [+mbc*4]                 esc_off: (mbc, 2) u16 dense-coord escape offsets
  [+mbc*4]                 esc_val: (mbc, 2) i16 escape values

BODY: (25*mbc*16,) u8 -- int8 levels of the active blocks compacted to
the front in block order.

Escapes (|level| > 127, at most ESC_SLOTS per MB before the dense
fallback) are patched on the host after reconstruction.

`pack_wire` runs on the tensors' device; the unpackers are numpy.
"""
from __future__ import annotations

import numpy as np
import torch

ESC_SLOTS = 2


def _u8(t: torch.Tensor) -> torch.Tensor:
    """Little-endian bytes of a tensor, flat."""
    return t.contiguous().view(torch.uint8).reshape(-1)


def pack_wire(levels_pack, meta, cur_ssim, replaced):
    """(mbc, 25, 16) int levels + (mbc, 11) i32 meta + (mbc,) i32 Q15 SSIM
    + i32 replaced count (a 0-d tensor or an int) -> (head u8, body u8,
    stats (4,) i32 [replaced, ssim_min, sum_hi, sum_lo])."""
    dev = levels_pack.device
    mbc = levels_pack.shape[0]
    nb = mbc * 25
    blocks = levels_pack.reshape(nb, 16).to(torch.int16)
    active = (blocks != 0).any(dim=1)
    n_active = active.sum(dtype=torch.int32)

    nb8 = -(-nb // 8) * 8
    apad = torch.zeros(nb8, dtype=torch.int32, device=dev)
    apad[:nb] = active.to(torch.int32)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=dev)
    bitmap = (apad.reshape(nb8 // 8, 8) * weights).sum(dim=1) \
        .to(torch.uint8)

    # active blocks to the front in their order; the rest are all-zero
    order = torch.argsort((~active).to(torch.int8), stable=True)
    body = _u8(blocks[order].clamp(-128, 127).to(torch.int8))

    # per-MB escapes in dense (mb, 400) coordinates: the first ESC_SLOTS
    flat = levels_pack.reshape(mbc, 400).to(torch.int32)
    esc = flat != flat.clamp(-128, 127)
    pos = torch.arange(400, dtype=torch.int32, device=dev)
    score = torch.where(esc, 400 - pos, 0)
    v, idx = torch.topk(score, ESC_SLOTS, dim=1)
    valid = v > 0
    esc_off = torch.where(valid, idx.to(torch.int32), 0xFFFF) \
        .to(torch.int32)
    esc_val = torch.where(valid, flat.gather(1, idx), 0).to(torch.int16)
    esc_ovf = (esc.sum(dim=1) > ESC_SLOTS).to(torch.uint8)
    flags = esc_ovf.any().to(torch.int32)

    meta8 = torch.cat([
        meta[:, 0:3].to(torch.uint8), esc_ovf[:, None],
        meta[:, 3:11].to(torch.int16).contiguous().view(torch.uint8)],
        dim=1)

    # each MB clamps at -1.0 (-Q3), then the biased score (0..196608) is
    # split into 12-bit hi/lo so neither partial sum can wrap int32
    ssim_min = cur_ssim.min().to(torch.int32)
    w = torch.clamp(cur_ssim.to(torch.int32), min=-98304) + 98304
    sum_hi = (w >> 12).sum(dtype=torch.int32)
    sum_lo = (w & 4095).sum(dtype=torch.int32)
    rep = torch.as_tensor(replaced, dtype=torch.int32, device=dev)
    scalars = torch.stack([n_active, flags, ssim_min, sum_hi, sum_lo,
                           rep.reshape(())])
    head = torch.cat([
        _u8(scalars), bitmap, meta8.reshape(-1),
        _u8(esc_off.to(torch.int16)), _u8(esc_val)])
    stats = torch.stack([rep.reshape(()), ssim_min, sum_hi, sum_lo])
    return head, body, stats


def pack_modes4(modes: torch.Tensor) -> torch.Tensor:
    """(mbc, 16) B_PRED modes (0..9) -> (mbc*8,) u8, two modes a byte, the
    even block in the low nibble."""
    m = modes.to(torch.uint8).reshape(-1, 8, 2)
    return (m[:, :, 0] | (m[:, :, 1] << 4)).reshape(-1)


def head_size(mbc: int) -> int:
    nb = mbc * 25
    return 24 + (-(-nb // 8)) + mbc * 20 + mbc * ESC_SLOTS * 4


def stats_sum_fx(sum_hi: int, sum_lo: int, mbc: int) -> int:
    """Reassemble the exact int ssim_sum from the hi/lo split words."""
    return (int(sum_hi) << 12) + int(sum_lo) - 98304 * mbc


def body_capacity(mbc: int) -> int:
    return mbc * 25 * 16


def unpack_head(head: np.ndarray, mbc: int) -> dict:
    """numpy: head buffer -> dict of parsed fields (no levels yet)."""
    head = np.ascontiguousarray(head, dtype=np.uint8)
    nb = mbc * 25
    nbm = -(-nb // 8)
    n_active = int(head[0:4].view("<i4")[0])
    flags = int(head[4:8].view("<i4")[0])
    ssim_min_fx = int(head[8:12].view("<i4")[0])
    sum_hi = int(head[12:16].view("<i4")[0])
    sum_lo = int(head[16:20].view("<i4")[0])
    ssim_sum_fx = stats_sum_fx(sum_hi, sum_lo, mbc)
    replaced = int(head[20:24].view("<i4")[0])
    o = 24
    bitmap = head[o:o + nbm]
    o += nbm
    meta8 = head[o:o + mbc * 20].reshape(mbc, 20)
    o += mbc * 20
    esc_off = head[o:o + mbc * ESC_SLOTS * 2].view("<u2").reshape(mbc, ESC_SLOTS)
    o += mbc * ESC_SLOTS * 2
    esc_val = head[o:o + mbc * ESC_SLOTS * 2].view("<i2").reshape(mbc, ESC_SLOTS)

    active = np.unpackbits(bitmap, bitorder="little")[:nb].astype(bool)
    return dict(
        n_active=n_active, esc_overflow=bool(flags & 1),
        ssim_min_fx=ssim_min_fx, ssim_sum_fx=ssim_sum_fx, replaced=replaced,
        active=active,
        seg=meta8[:, 0].astype(np.int32), part=meta8[:, 1].astype(np.int32),
        ref=meta8[:, 2].astype(np.int32), ovf=meta8[:, 3].copy(),
        mvs=np.ascontiguousarray(meta8[:, 4:20]).view("<i2").reshape(mbc, 4, 2),
        esc_off=esc_off, esc_val=esc_val)


def unpack_modes4(modes4: np.ndarray, mbc: int) -> np.ndarray:
    """numpy: (mbc*8,) u8 nibble-packed bmodes -> (mbc, 16) int8."""
    m = np.ascontiguousarray(modes4, dtype=np.uint8).reshape(mbc, 8)
    out = np.empty((mbc, 16), np.int8)
    out[:, 0::2] = (m & 0x0F).astype(np.int8)
    out[:, 1::2] = (m >> 4).astype(np.int8)
    return out


def unpack_levels(info: dict, body_prefix: np.ndarray, mbc: int) -> np.ndarray:
    """numpy: parsed head + the fetched body[:n_active*16] prefix
    -> dense (mbc, 25, 16) int16 levels."""
    nb = mbc * 25
    lo = np.zeros((nb, 16), dtype=np.int16)
    rows = np.nonzero(info["active"])[0]
    if info["n_active"]:
        lo[rows] = np.ascontiguousarray(
            body_prefix[: info["n_active"] * 16], dtype=np.uint8) \
            .view(np.int8).astype(np.int16).reshape(info["n_active"], 16)
    levels = lo.reshape(mbc, 25, 16)
    m = info["esc_off"] != 0xFFFF
    r = np.nonzero(m)[0]
    levels.reshape(mbc, 400)[r, info["esc_off"][m]] = info["esc_val"][m]
    return levels
