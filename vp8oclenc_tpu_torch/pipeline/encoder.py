"""Frame-loop driver: the per-frame state machine, the counterpart of the
JAX package's pipeline/encoder.py.

Two pixel backends give the same streams: "torch" (ops/backend.py, the
CUDA kernels on the card, or their plain PyTorch versions on the CPU), the
default, and "spec" (spec/backend.py, the sequential numpy oracle, the JAX
package's "spec").

Reference-frame bookkeeping (golden = key; altref every altref_range),
key/inter dispatch, the chroma scene-change detector, entropy coding and
partition assembly are as in the JAX package, so streams are byte-identical
to it.  Under an SSIM target the verdict on an inter frame (done again as
a keyframe when its mean SSIM is below the target or too many MBs were
replaced) is read when the frame's outputs reach the host, `depth` frames
after its dispatch: the frame loop is speculative and rolls back to a
snapshot taken before the frame.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.entropy import tokens as TOK
from vp8oclenc_tpu_torch.entropy.boolcoder import pack_bools
from vp8oclenc_tpu_torch.entropy.header import encode_frame_header
from vp8oclenc_tpu_torch.io.y4m import Frame, pad_frame
from vp8oclenc_tpu_torch.ops.backend import TorchBackend
from vp8oclenc_tpu_torch.pipeline.control import RefSchedule
from vp8oclenc_tpu_torch.pipeline.segments import SegmentData, prepare_segments
from vp8oclenc_tpu_torch.tables import ARE4X4, INTRA_SEGMENT, LAST


@dataclass
class FrameData:
    """Everything the entropy layer needs about one encoded frame."""
    mbw: int
    mbh: int
    is_key: bool
    is_golden: bool
    is_altref: bool
    levels: np.ndarray            # (mbc, 25, 16) int16 zigzag levels
    parts: np.ndarray             # (mbc,)
    segment_ids: np.ndarray       # (mbc,)
    modes: np.ndarray             # (mbc, 16) bmodes for intra MBs
    is_inter: np.ndarray          # (mbc,) bool
    ref_frame: np.ndarray         # (mbc,)
    mvs: np.ndarray               # (mbc, 4, 2) int16 (x, y) qpel quarters
    replaced: int = 0
    # filled by entropy stage
    skip: np.ndarray = None
    skip_prob: int = 0
    coeff_probs: np.ndarray = None
    coeff_update_flags: np.ndarray = None


@dataclass
class EncoderStats:
    scene_changes_by_color: int = 0
    scene_changes_by_ssim: int = 0
    scene_changes_by_replaced: int = 0


def scene_change_step(frame_number: int, last_key_detect: int,
                      holdover: bool, last_u, last_v, u, v):
    """One step of the chroma-SAD scene-change detector: returns
    (change, last_key_detect, holdover)."""
    udiff = int(np.abs(last_u.astype(np.int64) - u).sum()) // u.size
    vdiff = int(np.abs(last_v.astype(np.int64) - v).sum()) // v.size
    detect = (udiff > 7) or (vdiff > 7) or (udiff + vdiff > 10)
    if detect and (frame_number - last_key_detect) < 4:
        return False, frame_number, True
    if detect and (frame_number - last_key_detect) >= 4:
        return True, last_key_detect, holdover
    if holdover:
        if (frame_number - last_key_detect) >= 4:
            return True, last_key_detect, False
        return False, last_key_detect, holdover
    return False, last_key_detect, holdover


def _own_padded(frame: Frame) -> Frame:
    """Padded planes that no longer alias the caller's buffers (pad_frame
    returns an already aligned plane as it is)."""
    p = pad_frame(frame)
    return Frame(*(q.copy() if q is src else q
                   for q, src in zip((p.y, p.u, p.v),
                                     (frame.y, frame.u, frame.v))))


class EntropyCoder:
    """The host half of a frame: tokens, probabilities, boolean-coded
    partitions, the frame header and the assembled payload.  It holds no
    device state, so the multi-GPU layer's lane leaders run it on frames
    assembled from their tile ranks' wire buffers."""

    def __init__(self, cfg: EncoderConfig, width: int, height: int) -> None:
        self.cfg = cfg
        self.width = width
        self.height = height
        self.mbw = ((width + 15) & ~15) // 16
        self.mbh = ((height + 15) & ~15) // 16
        self.mbc = self.mbw * self.mbh
        self._pool = None              # lazy per-partition packing pool
        # the last frame's first partition in bytes, as written: the frame
        # tag states it in 19 bits (header.tag_first_partition_size)
        self.first_partition_bytes = 0

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            nw = min(max(self.cfg.num_partitions, 1), self.cfg.threads)
            self._pool = ThreadPoolExecutor(max_workers=nw)
        return self._pool

    def close(self) -> None:
        """Shut down the packing pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def finish(self, fd: FrameData, seg: SegmentData,
               require_native: bool) -> bytes:
        """The frame's payload.  require_native: the encode runs beside a
        card, where the Python tokenizer may not stand in for the native
        packer."""
        cfg = self.cfg
        from vp8oclenc_tpu_torch.native import packer as native
        use_native = native.available()
        if not use_native and require_native:
            # the Python tokenizer is the CPU path's stand-in; beside a
            # card it would hide a broken build behind a far slower stage
            raise RuntimeError(
                "the native entropy packer did not build (g++ is needed); "
                "device='cpu' falls back to the Python tokenizer")

        if use_native:
            records, num, den, skip = native.tokenize_frame(
                fd.levels, fd.parts, self.mbw, self.mbh, cfg.num_partitions)
            probs, flags = TOK.probs_from_counts(num, den, cfg.num_partitions)
        else:
            skip, _ = TOK.mb_skip_flags(fd.levels, fd.parts)
            tokdata = TOK.tokenize_frame(fd.levels, fd.parts, self.mbw, self.mbh)
            probs, flags = TOK.count_probs(tokdata, cfg.num_partitions,
                                           self.mbw, self.mbh)
            order = TOK.emission_order(fd.parts, skip, self.mbw, self.mbh,
                                       cfg.num_partitions)
            records = TOK.build_token_records(tokdata, order)

        fd.skip = skip
        n_coded = int(np.sum(~skip))
        fd.skip_prob = int(np.clip(n_coded * 256 // self.mbc, 2, 254))
        fd.coeff_probs = probs
        fd.coeff_update_flags = flags

        if use_native and len(records) > 1 and self.cfg.threads > 1:
            # parallel per-partition boolcoders (ctypes releases the GIL)
            partitions = list(self._executor().map(
                lambda rec: native.pack_tokens(rec, probs), records))
        else:
            partitions = []
            for rec in records:
                if use_native:
                    partitions.append(native.pack_tokens(rec, probs))
                else:
                    p, b = TOK.records_to_bools(rec, probs)
                    partitions.append(pack_bools(p, b))

        header = encode_frame_header(fd, seg, cfg, self.width, self.height)
        self.first_partition_bytes = len(header) - (10 if fd.is_key else 3)
        out = bytearray(header)
        for part in partitions[:-1]:
            n = len(part)
            out += bytes([n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF])
        for part in partitions:
            out += part
        return bytes(out)


class Encoder:
    """Single-stream VP8 encoder.  backend="torch" runs on one device
    ("cuda" unless the caller asks for "cpu"); backend="spec" runs the
    numpy oracle on the host and takes no device."""

    def __init__(self, cfg: EncoderConfig, width: int, height: int,
                 device=None, backend: str = "torch") -> None:
        self.cfg = cfg
        self.width = width
        self.height = height
        self.wrk_w = (width + 15) & ~15
        self.wrk_h = (height + 15) & ~15
        self.mbw = self.wrk_w // 16
        self.mbh = self.wrk_h // 16
        self.mbc = self.mbw * self.mbh
        self.stats = EncoderStats()
        self.last_frame_stats = None
        # frame state
        self.frame_number = 0
        self.frames_until_key = 1
        self.last_key_detect = 0
        self._scene_holdover = False
        self.refs = RefSchedule(cfg.altref_range)  # GOLDEN/ALTREF schedule
        self.recon = None                         # LAST (y, u, v), lazy
        self.last_u = None                        # previous source chroma
        self.last_v = None
        if backend == "torch":
            self.backend = TorchBackend(cfg, self.wrk_w, self.wrk_h, device)
        elif backend == "spec":
            if device is not None and str(device) != "cpu":
                raise ValueError("the spec backend runs on the host; "
                                 "device applies to the torch backend")
            from vp8oclenc_tpu_torch.spec.backend import SpecBackend
            self.backend = SpecBackend(cfg, self.wrk_w, self.wrk_h)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.entropy = EntropyCoder(cfg, width, height)

    def close(self) -> None:
        """Shut down the packing pool (idempotent)."""
        self.entropy.close()

    def _scene_change(self, u: np.ndarray, v: np.ndarray) -> bool:
        if self.last_u is None:
            return False
        change, self.last_key_detect, self._scene_holdover = \
            scene_change_step(self.frame_number, self.last_key_detect,
                              self._scene_holdover, self.last_u, self.last_v,
                              u, v)
        return change

    # ---- keyframe path ----
    def _encode_key(self, y, u, v, seg: SegmentData,
                    yuv_dev=None) -> FrameData:
        self.frames_until_key = self.cfg.gop_size
        self.last_key_detect = self.frame_number

        dev_out, self.recon = self.backend.encode_intra_frame(
            y, u, v, seg, yuv_dev=yuv_dev)
        mbc = self.mbc
        fd = FrameData(
            mbw=self.mbw, mbh=self.mbh, is_key=True, is_golden=True,
            is_altref=True, levels=None,            # filled by finalize
            parts=np.full(mbc, ARE4X4, dtype=np.int32),
            segment_ids=np.full(mbc, INTRA_SEGMENT, dtype=np.int32),
            modes=None,
            is_inter=np.zeros(mbc, dtype=bool),
            ref_frame=np.full(mbc, LAST, dtype=np.int32),
            mvs=np.zeros((mbc, 4, 2), dtype=np.int16))
        fd.device_outputs = dev_out
        return fd

    # ---- inter path ----
    def _encode_inter(self, y, u, v, seg, is_golden, is_altref,
                      yuv_dev=None):
        return self.backend.encode_inter_frame(self, y, u, v, seg, is_golden,
                                               is_altref, yuv_dev=yuv_dev)

    # ---- entropy + assembly ----
    def _finish_frame(self, fd: FrameData, seg: SegmentData) -> bytes:
        out = self.entropy.finish(fd, seg,
                                  self.backend.device.type == "cuda")
        self.last_frame_stats = {
            "is_key": fd.is_key, "replaced": fd.replaced,
            "first_partition_bytes": self.entropy.first_partition_bytes,
            "ssim_min_fx": getattr(fd, "ssim_min_fx", None),
            "ssim_sum_fx": getattr(fd, "ssim_sum_fx", None)}
        return out

    def encode_frame(self, frame: Frame) -> bytes:
        """Sequential encode of one frame (self.recon is this frame's)."""
        fd, seg = self._frame_pixels(_own_padded(frame))
        if self._finalize_fd(fd, seg):
            fd, seg = self._redo_as_key(fd)
            self._finalize_fd(fd, seg)
        return self._finish_frame(fd, seg)

    def _upload_frame(self, padded: Frame):
        """Device upload of one padded frame: (padded Frame, device yuv
        buffer).  Runs on the upload thread, one frame ahead."""
        return padded, self.backend.upload_frame(padded.y, padded.u,
                                                 padded.v)

    def encode_frames(self, frames, depth: int = 3):
        """Pipelined stream encode, `depth` frames in flight: the host
        entropy stage of frame N-depth and the uploads of the next frames
        overlap the device chain of frame N.

        Each frame pulled from `frames` is copied (padded) on this thread at
        once, so an iterator may recycle its buffers.  Up to depth + 1
        uploads are queued on one background thread besides the `depth`
        frames in flight, so up to 2 * depth + 1 frames are held in host
        and device memory.  Frame order is kept by FIFOs of futures.

        Under an SSIM target the redo-as-key check is speculative at depth
        `depth`: a frame whose check fails is rolled back to its snapshot
        and coded again as a keyframe, and every successor already in
        flight is dispatched again from its kept planes and device buffer
        against the corrected references, so the bytes equal the
        sequential encoder's."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        it = iter(frames)
        inflight = deque()       # (fd, seg, (padded, device buffer))
        uploads = deque()        # futures of _upload_frame, frame order
        pool = ThreadPoolExecutor(max_workers=1)

        def pull() -> bool:
            f = next(it, None)
            if f is None:
                return False
            uploads.append(pool.submit(self._upload_frame, _own_padded(f)))
            return True

        try:
            more = True
            for _ in range(depth + 1):
                more = pull()
                if not more:
                    break
            while True:
                while uploads and len(inflight) < depth:
                    src = uploads.popleft().result()
                    if more:
                        more = pull()
                    inflight.append((*self._frame_pixels(*src), src))
                if not inflight:
                    break
                fd, seg, _ = inflight.popleft()
                if self._finalize_fd(fd, seg):
                    fd, seg = self._redo_as_key(fd)
                    self._finalize_fd(fd, seg)
                    stale = [src for _, _, src in inflight]
                    inflight.clear()
                    for src in stale:
                        inflight.append((*self._frame_pixels(*src), src))
                yield self._finish_frame(fd, seg)
        finally:
            for fut in uploads:
                fut.cancel()
            pool.shutdown(wait=True)

    def _finalize_fd(self, fd: FrameData, seg: SegmentData):
        """Wait for the frame's outputs; truthy when the SSIM controller
        asks for the frame to be done again as a keyframe."""
        reason = self.backend.finalize_framedata(fd, seg)
        if reason == "ssim":
            self.stats.scene_changes_by_ssim += 1
        elif reason == "replaced":
            self.stats.scene_changes_by_replaced += 1
        return reason

    _SNAPSHOT = ("frame_number", "frames_until_key", "last_key_detect",
                 "_scene_holdover", "last_u", "last_v", "recon")

    def _snapshot_state(self):
        """Counters, detector state and the backend's references before a
        frame (each backend says how it keeps them); the reference schedule
        is copied."""
        return ([getattr(self, k) for k in self._SNAPSHOT],
                copy.copy(self.refs), self.backend.snapshot())

    def _restore_state(self, snap) -> None:
        for k, val in zip(self._SNAPSHOT, snap[0]):
            setattr(self, k, val)
        self.refs = copy.copy(snap[1])
        self.backend.restore(snap[2])

    def _redo_as_key(self, fd: FrameData):
        """Code fd's source frame again, as a keyframe, from the snapshot
        taken before it."""
        self._restore_state(fd.ssim_snapshot)
        return self._frame_pixels(*fd.src_pre, force_key=True)

    def _frame_pixels(self, p: Frame, yuv_dev=None, force_key=False):
        """Dispatch one padded frame's pixel work; returns (fd, seg) with
        the levels still on their way to the host."""
        y, u, v = p.y, p.u, p.v
        snap = None
        if self.cfg.ssim_target > 0.0 and not force_key:
            snap = self._snapshot_state()

        self.frames_until_key -= 1
        is_key = self.frames_until_key < 1 or force_key
        if force_key:
            # replay the detector's side effects exactly as the discarded
            # pass made them, whatever its verdict
            self._scene_change(u, v)
        elif not is_key and self._scene_change(u, v):
            self.stats.scene_changes_by_color += 1
            is_key = True

        is_golden = is_key
        is_altref = self.refs.next_is_altref(is_key)

        seg = prepare_segments(self.cfg, y, is_key, is_altref)
        if is_key:
            fd = self._encode_key(y, u, v, seg, yuv_dev=yuv_dev)
        else:
            fd = self._encode_inter(y, u, v, seg, is_golden, is_altref,
                                    yuv_dev=yuv_dev)
        if snap is not None:
            fd.ssim_snapshot = snap
            fd.src_pre = (p, yuv_dev)

        self.backend.promote_refs(is_golden, is_altref)
        self.refs.coded(self.frame_number, is_golden, is_altref)
        self.last_u = u.copy()
        self.last_v = v.copy()
        self.frame_number += 1
        return fd, seg

    # ---- checkpoint / resume (the JAX package's dict format) ----
    _REFS_KEYS = ("frames_until_altref", "prev_is_golden", "prev_is_altref",
                  "golden_frame_number", "altref_frame_number")

    def checkpoint(self) -> dict:
        """Serializable encoder state at a frame boundary: counters,
        detector state and, inside a GOP, the three reference frames.  At a
        GOP boundary the planes are left out: the next frame is a key."""
        st = {
            "frame_number": self.frame_number,
            "frames_until_key": self.frames_until_key,
            "last_key_detect": self.last_key_detect,
            "scene_holdover": self._scene_holdover,
            **{k: getattr(self.refs, k) for k in self._REFS_KEYS},
            "last_u": None if self.last_u is None else self.last_u.copy(),
            "last_v": None if self.last_v is None else self.last_v.copy(),
        }
        if self.frames_until_key > 1:
            st["last"], st["golden"], st["altref"] = self.backend.host_refs()
        return st

    def restore(self, st: dict) -> None:
        """Resume from a checkpoint() dict (of this package or of the JAX
        package): the stream continues byte-identically."""
        self.frame_number = st["frame_number"]
        self.frames_until_key = st["frames_until_key"]
        self.last_key_detect = st["last_key_detect"]
        self._scene_holdover = st["scene_holdover"]
        self.refs = RefSchedule(self.cfg.altref_range,
                                **{k: st[k] for k in self._REFS_KEYS})
        self.last_u = st["last_u"]
        self.last_v = st["last_v"]
        if st.get("last") is None:
            return                      # GOP boundary: next frame is a key
        self.backend.set_refs(st["last"], st.get("golden"), st.get("altref"))
        self.recon = [np.asarray(p).copy() for p in st["last"]]
