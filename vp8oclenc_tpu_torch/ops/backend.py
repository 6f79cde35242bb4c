"""Torch backend: device-resident encoder state and the per-frame device
chains (the counterpart of the JAX package's ops/backend.py TPUBackend).

Keyframe chain: H2D of the frame, the luma and chroma intra wavefront
kernels, the loop-filter kernel.  Inter chain: H2D, the inter body
(pyramid, full-pel and quarter-pel search kernels, reference selection,
chroma MC, the LQ pass and per-MB SSIM; under an SSIM target also the
AQ/HQ/UQ passes and the batched intra replacement with the luma trial
kernel), then the loop filter fed from the body's outputs, with the
inner-edge mask and the weakened limits chosen on the device.  Each chain
ends with an asynchronous D2H of what the host entropy stage needs into
pinned host buffers with a CUDA event recorded behind it;
`finalize_framedata` waits on that event only when the host needs the
frame, so the host codes frame N while the card runs frame N+1.  The
post-filter planes stay on the device as the LAST/GOLDEN/ALTREF
references, each with its search state (5-level pyramid and chroma planes,
ops/inter.ref_state), built once when the frame becomes a reference.
"""
from __future__ import annotations

import numpy as np
import torch

from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.pipeline.control import redo_reason, take_weak_filter
from vp8oclenc_tpu_torch.ssim_fx import Q3, WEAKEN_FX, target_fx
from vp8oclenc_tpu_torch.tables import (ALTREF, ARE4X4, ARE16X16, GOLDEN,
                                        INTRA_SEGMENT, LAST, SEGMENT_COUNT)


def resolve_device(device=None) -> torch.device:
    """None means cuda; a cuda device must exist (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(CLI: -device cpu) to run the plain PyTorch "
                           "versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start a D2H copy into a fresh pinned buffer (CPU tensors pass
    through).  The caching host allocator keeps the buffer out of reuse
    until the copy has completed, so frames in flight never share one."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """H2D of a host array through a pinned staging buffer (asynchronous
    on the current stream); on the CPU the array is wrapped as it is."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class TorchBackend:
    def __init__(self, cfg: EncoderConfig, wrk_w: int, wrk_h: int,
                 device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.wrk_w = wrk_w
        self.wrk_h = wrk_h
        self.mbw = wrk_w // 16
        self.mbh = wrk_h // 16
        self.mbc = self.mbw * self.mbh
        # device state: post-filter reference planes (y, u, v) and their
        # search states (ops/inter.ref_state); each chain runs its own
        # loop filter
        self.last = None
        self.golden = None
        self.altref = None
        self.last_state = None
        self.golden_state = None
        self.altref_state = None
        # keyframe per-MB constants: every MB in INTRA_SEGMENT, every MB
        # split (ARE4X4), so the inner-edge mask is all true
        self._key_seg = torch.full((self.mbc,), INTRA_SEGMENT,
                                   dtype=torch.int32, device=self.device)
        self._key_inner = torch.ones((self.mbc,), dtype=torch.uint8,
                                     device=self.device)

    def _split_yuv(self, yuv_dev):
        ny = self.wrk_h * self.wrk_w
        nc = (self.wrk_h // 2) * (self.wrk_w // 2)
        return (yuv_dev[:ny].view(self.wrk_h, self.wrk_w),
                yuv_dev[ny:ny + nc].view(self.wrk_h // 2, self.wrk_w // 2),
                yuv_dev[ny + nc:].view(self.wrk_h // 2, self.wrk_w // 2))

    def upload_frame(self, y, u, v) -> torch.Tensor:
        """One H2D transfer of the concatenated padded planes."""
        return upload(np.concatenate([y.ravel(), u.ravel(), v.ravel()]),
                      self.device)

    # -------------------------------------------------- intra
    def encode_intra_frame(self, y, u, v, seg, yuv_dev=None):
        """Dispatch the keyframe chain; returns (device_outputs,
        PendingRecon).  Nothing here waits for the device."""
        from vp8oclenc_tpu_torch.ops.intra import intra_body
        from vp8oclenc_tpu_torch.ops.loopfilter import filter_planes

        if yuv_dev is None:
            yuv_dev = self.upload_frame(y, u, v)
        yd, ud, vd = self._split_yuv(yuv_dev)
        sid = INTRA_SEGMENT
        ry, ru, rv, levels_pack, modes = intra_body(
            yd, ud, vd, int(seg.y_dc_q[sid]), int(seg.y_ac_q[sid]),
            int(seg.uv_dc_q[sid]), int(seg.uv_ac_q[sid]))
        lf_dev = upload(lf_rows(seg), self.device)
        filtered = filter_planes(ry, ru, rv, self._key_seg, self._key_inner,
                                 *lf_dev)
        self._set_last(filtered)
        return self._to_host(levels_pack, modes), PendingRecon(filtered)

    def _to_host(self, *tensors):
        """(event, host copies): asynchronous D2H of each tensor, with a
        CUDA event recorded behind the copies (None on the CPU)."""
        host = tuple(_to_host_async(t) for t in tensors)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return (event,) + host

    def _set_last(self, planes) -> None:
        """LAST becomes `planes`, with its search state."""
        from vp8oclenc_tpu_torch.ops.inter import ref_state
        self.last = planes
        self.last_state = ref_state(*planes)

    # -------------------------------------------------- inter
    def encode_inter_frame(self, enc, y, u, v, seg, is_golden, is_altref,
                           yuv_dev=None):
        """Dispatch one inter frame's chain; returns the FrameData with
        its levels and metadata (under an SSIM target also the B_PRED modes
        and the count of replaced MBs) still on their way to the host.  A
        reference the frame may not use (GOLDEN right after a
        golden frame, ALTREF right after an altref or while it equals
        GOLDEN) is stood in for by LAST's state and marked invalid."""
        from vp8oclenc_tpu_torch.ops.inter import inter_body
        from vp8oclenc_tpu_torch.pipeline.encoder import FrameData
        from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

        use_golden, use_altref = enc.refs.usable()
        ls = self.last_state
        gs = self.golden_state \
            if (use_golden and self.golden_state is not None) else ls
        als = self.altref_state \
            if (use_altref and self.altref_state is not None) else ls

        if yuv_dev is None:
            yuv_dev = self.upload_frame(y, u, v)
        yd, ud, vd = self._split_yuv(yuv_dev)
        quant = tuple([int(x) for x in q] for q in (
            seg.y_dc_q, seg.y_ac_q, seg.y2_dc_q, seg.y2_ac_q, seg.uv_dc_q,
            seg.uv_ac_q))
        ssim_on = self.cfg.ssim_target > 0.0
        levels_pack, meta, cur_ssim, ry, ru, rv, modes, replaced = \
            inter_body(yd, ud, vd, (ls, gs, als),
                       (True, use_golden, use_altref), quant,
                       target_fx(self.cfg.ssim_target) if ssim_on else -1)

        # the loop filter runs on the device outputs; the weakened limits
        # are selected there when min SSIM > WEAKEN_FX
        weak = prepare_segments(self.cfg, y, False, is_altref,
                                weaken_filter=True, strength=seg.raw_strength)
        lf = upload(np.stack([lf_rows(s_) for s_ in (seg, weak)]),
                    self.device)
        filtered = filter_from_meta(ry, ru, rv, levels_pack, meta, cur_ssim,
                                    lf)
        self._set_last(filtered)

        mbc = self.mbc
        fd = FrameData(
            mbw=self.mbw, mbh=self.mbh, is_key=False, is_golden=is_golden,
            is_altref=is_altref, levels=None, parts=None, segment_ids=None,
            modes=np.zeros((mbc, 16), dtype=np.int8),
            is_inter=None, ref_frame=None, mvs=None)
        fd.device_outputs = self._to_host(
            levels_pack, meta, cur_ssim,
            *((modes, replaced) if ssim_on else ()))
        fd.weak_seg = weak
        enc.recon = PendingRecon(filtered)
        return fd

    def finalize_framedata(self, fd, seg):
        """Wait for the frame's D2H and fill the FrameData: levels and
        modes for a keyframe; levels, segment ids, partitionings,
        references, vectors and the SSIM statistics for an inter frame,
        whose header takes the weakened filter when min SSIM > WEAKEN_FX
        (the device chose the same limits), and under an SSIM target the
        B_PRED modes and the count of replaced MBs.  Returns None, or
        "ssim" / "replaced" when the SSIM controller asks for the frame to
        be done again as a keyframe (mean SSIM below the target, or more
        than a sixth of the MBs replaced): the caller then rolls back to
        its snapshot from before the frame."""
        outs = getattr(fd, "device_outputs", None)
        if outs is None:
            return None
        fd.device_outputs = None
        if outs[0] is not None:
            outs[0].synchronize()
        fd.levels = outs[1].numpy()
        if fd.is_key:
            fd.modes = outs[2].numpy()
            return None
        meta = outs[2].numpy()
        cur_ssim = outs[3].numpy()
        fd.segment_ids = meta[:, 0].copy()
        fd.parts = meta[:, 1].copy()
        fd.is_inter = fd.parts != ARE4X4
        fd.ref_frame = np.array([LAST, GOLDEN, ALTREF],
                                dtype=np.int32)[meta[:, 2]]
        fd.mvs = meta[:, 3:].reshape(-1, 4, 2).astype(np.int16)
        fd.ssim_min_fx = int(cur_ssim.min())
        fd.ssim_sum_fx = int(np.maximum(cur_ssim, -Q3)
                             .astype(np.int64).sum())
        if len(outs) > 4:
            fd.modes = outs[4].numpy()
            fd.replaced = int(outs[5])
            reason = redo_reason(fd.ssim_sum_fx, fd.replaced, self.mbc,
                                 target_fx(self.cfg.ssim_target))
            if reason:
                return reason
        take_weak_filter(seg, fd.weak_seg, fd.ssim_min_fx)
        return None

    def promote_refs(self, is_golden: bool, is_altref: bool) -> None:
        if is_golden:
            self.golden, self.golden_state = self.last, self.last_state
        if is_altref:
            self.altref, self.altref_state = self.last, self.last_state

    def set_refs(self, last, golden=None, altref=None) -> None:
        """Install host reference planes (a restored checkpoint) and build
        their search states."""
        from vp8oclenc_tpu_torch.ops.inter import ref_state
        put = lambda t: None if t is None else \
            tuple(upload(np.array(p), self.device) for p in t)
        state = lambda t: None if t is None else ref_state(*t)
        self._set_last(put(last))
        self.golden = put(golden)
        self.altref = put(altref)
        self.golden_state = state(self.golden)
        self.altref_state = state(self.altref)

    def host_refs(self):
        """Copies of (LAST, GOLDEN, ALTREF) as numpy planes."""
        get = lambda t: None if t is None else \
            tuple(p.cpu().numpy().copy() for p in t)
        return get(self.last), get(self.golden), get(self.altref)

    _SNAPSHOT = ("last", "last_state", "golden", "golden_state", "altref",
                 "altref_state")

    def snapshot(self):
        """The references before a frame.  They are device tensors that
        later frames replace and never write into, so holding them is
        enough."""
        return [getattr(self, k) for k in self._SNAPSHOT]

    def restore(self, snap) -> None:
        for k, val in zip(self._SNAPSHOT, snap):
            setattr(self, k, val)


def lf_rows(seg) -> np.ndarray:
    """(5, 4) int32 per-segment filter level, MB-edge limit, subblock
    limit, interior limit and HEV threshold."""
    return np.stack([np.asarray(a, dtype=np.int32).reshape(SEGMENT_COUNT)
                     for a in (seg.loop_filter_level, seg.mbedge_limit,
                               seg.sub_bedge_limit, seg.interior_limit,
                               seg.hev_threshold)])


def filter_from_meta(ry, ru, rv, levels_pack, meta, cur_ssim, lf):
    """Loop filter fed from the inter body's device outputs: the inner-edge
    mask (a split MB or any nonzero level) and segment ids come from
    `levels_pack` and `meta`, and lf (2, 5, 4) holds the normal and the
    weakened per-segment limits, the weakened ones taken when
    min(cur_ssim) > WEAKEN_FX.  Nothing waits for the host.  Returns the
    filtered planes."""
    from vp8oclenc_tpu_torch.ops.loopfilter import filter_planes
    return filter_planes(ry, ru, rv, meta[:, 0],
                         inner_mask(levels_pack, meta),
                         *filter_limits(cur_ssim.min(), lf))


def filter_limits(min_fx, lf):
    """The limits of lf (2, 5, 4) that the frame is filtered with, chosen
    on the device: the weakened ones when the frame's minimum MB SSIM
    min_fx (a 0-d tensor) exceeds WEAKEN_FX, the rule the frame header
    follows (pipeline/control.take_weak_filter)."""
    return torch.where(min_fx > WEAKEN_FX, lf[1], lf[0])


def inner_mask(levels_pack, meta):
    """Per MB: filter its inner edges (a split MB, or any nonzero level)."""
    return (meta[:, 1] != ARE16X16) | (levels_pack != 0).flatten(1).any(1)


class PendingRecon:
    """Lazy device-backed reconstruction triple (one frame's post-filter
    Y, U, V); copies to numpy on first indexing."""

    def __init__(self, planes) -> None:
        self.planes = planes
        self._np = None

    def _mat(self):
        if self._np is None:
            self._np = tuple(p.cpu().numpy() for p in self.planes)
        return self._np

    def __getitem__(self, i):
        return self._mat()[i]

    def __iter__(self):
        return iter(self._mat())

    def __len__(self):
        return 3
