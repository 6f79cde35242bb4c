"""Multi-GPU encode: GOP lanes x row tiles over torch.distributed, the
counterpart of the JAX package's parallel/encoder.py.

The frames are split into keyframe-aligned GOPs by a host pre-pass that
replays the sequential encoder's key schedule (`plan_gops`: the GOP
counter and the chroma scene-change detector, which reads source chroma
only).  GOPs go to the gop lanes in the JAX package's order, batches of
`gop` consecutive GOPs, GOP i to lane i % gop.  A lane's `tile` ranks code
each frame's row bands (parallel/tile), and its leader (tile rank 0)
gathers the bands' wire buffers (ops/wire: head, the used body prefix,
B_PRED modes, and the dense levels of a band whose escapes overflow),
assembles the frame, decides an SSIM redo-as-key and broadcasts it,
entropy-codes the frame on the host and keeps the payloads.  Lanes never
wait for each other: there is no lockstep, so nothing of the JAX
package's lane masks or lockstep accounting is needed.  Global rank 0
collects every lane's payloads and returns them in stream order, which is
byte-identical to the sequential encoder's (tests/test_torch_multichip.py).

A lane spans whole GOPs, so an SSIM redo resets only its own altref
schedule, as in the JAX package; like that package's plan, the pre-pass
does not see a redo's reset of the sequential GOP counter, so the streams
are equal when no redo falls in a GOP that a later planned boundary
follows at a distance other than the redo's own.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch
import torch.distributed as dist

from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.y4m import pad_frame
from vp8oclenc_tpu_torch.ops.backend import lf_rows, upload
from vp8oclenc_tpu_torch.ops.wire import (head_size, unpack_head,
                                          unpack_levels, unpack_modes4)
from vp8oclenc_tpu_torch.parallel.mesh import band_rows
from vp8oclenc_tpu_torch.pipeline.control import (RefSchedule, redo_reason,
                                                  take_weak_filter)
from vp8oclenc_tpu_torch.pipeline.encoder import (EntropyCoder, FrameData,
                                                  scene_change_step)
from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
from vp8oclenc_tpu_torch.ssim_fx import target_fx
from vp8oclenc_tpu_torch.tables import (ALTREF, ARE4X4, GOLDEN,
                                        INTRA_SEGMENT, LAST)

_U8 = torch.uint8


def plan_gops(cfg: EncoderConfig, frames, width, height):
    """Replay the sequential key schedule (GOP counter and scene-change
    detector) over `frames` and split them into keyframe-aligned runs of
    padded frames."""
    last_key_detect, holdover = 0, False
    last_u = last_v = None
    gops, cur = [], None
    frames_until_key = 1
    for fn, f in enumerate(frames):
        p = pad_frame(f)
        frames_until_key -= 1
        is_key = frames_until_key < 1
        if not is_key and last_u is not None:
            change, last_key_detect, holdover = scene_change_step(
                fn, last_key_detect, holdover, last_u, last_v, p.u, p.v)
            is_key = change
        if is_key:
            frames_until_key = cfg.gop_size
            last_key_detect = fn
            if cur:
                gops.append(cur)
            cur = []
        cur.append(p)
        last_u, last_v = p.u, p.v
    if cur:
        gops.append(cur)
    return gops


class LaneEncoder:
    """One tile rank of a gop lane: codes its band of every frame of the
    lane's GOPs; on the leader also assembles and entropy-codes them."""

    def __init__(self, cfg: EncoderConfig, width: int, height: int,
                 layout) -> None:
        self.cfg = cfg
        self.layout = layout
        self.wrk_w = (width + 15) & ~15
        self.wrk_h = (height + 15) & ~15
        self.mbh = self.wrk_h // 16
        self.mbw = self.wrk_w // 16
        self.mbc = self.mbw * self.mbh
        # each rank's (first MB, MBs) of the frame, and this rank's rows
        self.spans = [(r0 * self.mbw, n * self.mbw)
                      for r0, n in band_rows(self.mbh, layout.tile)]
        self.mb0, self.mbc_loc = self.spans[layout.t]
        self.row0 = self.mb0 // self.mbw * 16
        self.rows = self.mbc_loc // self.mbw * 16
        self.tfx = target_fx(cfg.ssim_target) if cfg.ssim_target > 0 else -1
        self.entropy = EntropyCoder(cfg, width, height) \
            if layout.is_leader else None

    def close(self) -> None:
        if self.entropy is not None:
            self.entropy.close()

    def _band(self, f):
        """The rank's rows of a padded frame, on its device."""
        r0 = self.row0
        dev = self.layout.device
        return (upload(f.y[r0:r0 + self.rows], dev),
                upload(f.u[r0 // 2:(r0 + self.rows) // 2], dev),
                upload(f.v[r0 // 2:(r0 + self.rows) // 2], dev))

    def _gather_wire(self, head, body, extra, levels):
        """The tile ranks' wire buffers at the leader: per rank (head info,
        body prefix, extra (modes) as numpy or None, dense levels where the
        rank's escapes overflowed, else None).  None on other ranks."""
        lay = self.layout
        head_h = head.cpu().numpy()
        info = unpack_head(head_h, self.mbc_loc)
        extras = [] if extra is None else [extra]
        if not lay.is_leader:
            lay.exchange({0: [head] + extras}, {})
            second = [body[:info["n_active"] * 16]] if info["n_active"] \
                else []
            if info["esc_overflow"]:
                second.append(levels)
            if second:
                lay.exchange({0: second}, {})
            return None
        n = [c for _, c in self.spans]
        # a rank's extra (modes) has as many rows a MB as the leader's
        first = lay.exchange({}, {s: [((head_size(n[s]),), _U8)] + [
            ((e.shape[0] // n[0] * n[s], *e.shape[1:]), e.dtype)
            for e in extras] for s in range(1, lay.tile)})
        got = [[head_h] + [e.cpu().numpy() for e in extras]] + \
            [[t.cpu().numpy() for t in first[s]] for s in range(1, lay.tile)]
        infos = [info] + [unpack_head(got[s][0], n[s])
                          for s in range(1, lay.tile)]
        recvs = {}
        for s in range(1, lay.tile):
            spec = [((infos[s]["n_active"] * 16,), _U8)] \
                if infos[s]["n_active"] else []
            if infos[s]["esc_overflow"]:
                spec.append(((n[s], 25, 16), torch.int16))
            if spec:
                recvs[s] = spec
        second = lay.exchange({}, recvs)
        out = []
        for s in range(lay.tile):
            if s == 0:
                bod = body[:info["n_active"] * 16].cpu().numpy()
                lv = levels.cpu().numpy() if info["esc_overflow"] else None
            else:
                rest = [t.cpu().numpy() for t in second.get(s, [])]
                bod = rest.pop(0) if infos[s]["n_active"] else \
                    np.zeros(0, np.uint8)
                lv = rest.pop(0) if infos[s]["esc_overflow"] else None
            out.append((infos[s], bod, got[s][1] if extras else None, lv))
        return out

    def _framedata(self, parts, is_key: bool, is_altref: bool):
        """The frame's FrameData from its bands' wire buffers; returns (fd,
        min SSIM, SSIM sum, replaced count)."""
        mbc = self.mbc
        levels = np.zeros((mbc, 25, 16), np.int16)
        seg_ids = np.zeros(mbc, np.int32)
        parts_ = np.zeros(mbc, np.int32)
        refs = np.zeros(mbc, np.int32)
        mvs = np.zeros((mbc, 4, 2), np.int16)
        modes = np.zeros((mbc, 16), np.int8)
        min_fx, sum_fx, replaced = 1 << 30, 0, 0
        for (mb0, n), (info, body, extra, lv) in zip(self.spans, parts):
            sl = slice(mb0, mb0 + n)
            levels[sl] = lv if lv is not None else \
                unpack_levels(info, body, n)
            seg_ids[sl] = info["seg"]
            parts_[sl] = info["part"]
            refs[sl] = info["ref"]
            mvs[sl] = info["mvs"]
            min_fx = min(min_fx, info["ssim_min_fx"])
            sum_fx += info["ssim_sum_fx"]
            replaced += info["replaced"]
            if is_key:
                modes[sl] = extra
            elif info["replaced"]:
                modes[sl] = unpack_modes4(extra, n)
        if is_key:
            fd = FrameData(
                mbw=self.mbw, mbh=mbc // self.mbw, is_key=True,
                is_golden=True, is_altref=True, levels=levels,
                parts=np.full(mbc, ARE4X4, np.int32),
                segment_ids=np.full(mbc, INTRA_SEGMENT, np.int32),
                modes=modes, is_inter=np.zeros(mbc, bool),
                ref_frame=np.full(mbc, LAST, np.int32),
                mvs=np.zeros((mbc, 4, 2), np.int16))
        else:
            fd = FrameData(
                mbw=self.mbw, mbh=mbc // self.mbw, is_key=False,
                is_golden=False, is_altref=is_altref, levels=levels,
                parts=parts_, segment_ids=seg_ids, modes=modes,
                is_inter=parts_ != ARE4X4,
                ref_frame=np.array([LAST, GOLDEN, ALTREF],
                                   np.int32)[refs],
                mvs=mvs, replaced=replaced)
            fd.ssim_min_fx, fd.ssim_sum_fx = min_fx, sum_fx
        return fd, min_fx, sum_fx, replaced

    def _key(self, f, seg):
        """A keyframe of the lane: (FrameData on the leader, else None; the
        new LAST state)."""
        from vp8oclenc_tpu_torch.parallel.tile import sharded_key_step
        s = INTRA_SEGMENT
        qs = (int(seg.y_dc_q[s]), int(seg.y_ac_q[s]), int(seg.uv_dc_q[s]),
              int(seg.uv_ac_q[s]))
        lf = upload(lf_rows(seg), self.layout.device)
        head, body, modes, lv, _planes, strips = sharded_key_step(
            *self._band(f), qs, lf, self.layout, self.mbh)
        parts = self._gather_wire(head, body, modes, lv)
        fd = None if parts is None else self._framedata(parts, True, True)[0]
        return fd, strips

    def encode_gop(self, frames):
        """Code one GOP of padded frames (the first becomes a keyframe).
        Returns the payloads on the leader, None on other ranks."""
        from vp8oclenc_tpu_torch.parallel.tile import sharded_frame_step
        cfg, lay = self.cfg, self.layout
        native = lay.device.type == "cuda"
        out = []
        seg = prepare_segments(cfg, frames[0].y, True, True)
        fd, strips = self._key(frames[0], seg)
        if lay.is_leader:
            out.append(self.entropy.finish(fd, seg, native))
        refs = RefSchedule(cfg.altref_range)
        refs.coded(0, True, refs.next_is_altref(True))
        last = golden = altref = strips
        for i, f in enumerate(frames[1:], 1):
            pre = copy.copy(refs)
            is_altref = refs.next_is_altref(False)
            seg = prepare_segments(cfg, f.y, False, is_altref)
            weak = prepare_segments(cfg, f.y, False, is_altref,
                                    weaken_filter=True,
                                    strength=seg.raw_strength)
            use_g, use_a = refs.usable()
            states = (last, golden if use_g else last,
                      altref if use_a else last)
            quant = tuple([int(x) for x in q] for q in (
                seg.y_dc_q, seg.y_ac_q, seg.y2_dc_q, seg.y2_ac_q,
                seg.uv_dc_q, seg.uv_ac_q))
            lf = upload(np.stack([lf_rows(s_)
                                  for s_ in (seg, weak)]), lay.device)
            head, body, modes4, lv, _planes, last = sharded_frame_step(
                *self._band(f), states, (True, use_g, use_a), quant, lf,
                self.tfx, lay, self.wrk_h)
            parts = self._gather_wire(head, body, modes4, lv)
            redo = None
            if parts is not None:
                fd, min_fx, sum_fx, replaced = self._framedata(
                    parts, False, is_altref)
                redo = redo_reason(sum_fx, replaced, self.mbc, self.tfx)
                if not redo:
                    take_weak_filter(seg, weak, min_fx)
            is_key = lay.broadcast_flag(bool(redo))
            if is_key:
                # as the sequential encoder does: back to the schedule
                # before the frame, and the frame again as a keyframe
                refs = pre
                is_altref = refs.next_is_altref(True)
                seg = prepare_segments(cfg, f.y, True, True)
                fd, last = self._key(f, seg)
                golden = last
            if is_altref:
                altref = last
            refs.coded(i, is_key, is_altref)
            if lay.is_leader:
                out.append(self.entropy.finish(fd, seg, native))
        return out if lay.is_leader else None


def encode_frames_multirank(cfg: EncoderConfig, frames, width: int,
                            height: int, layout):
    """Every rank's part of a multi-rank encode of `frames` (each rank
    holds the frames; it uploads only its bands).  Returns the payloads in
    stream order on global rank 0, None on the others."""
    gops = plan_gops(cfg, frames, width, height)
    lane = LaneEncoder(cfg, width, height, layout)
    try:
        mine = [lane.encode_gop(g) for g in gops[layout.g::layout.gop]]
    finally:
        lane.close()
    lanes = [None] * layout.world if layout.rank == 0 else None
    dist.gather_object(mine if layout.is_leader else None, lanes, dst=0)
    if layout.rank != 0:
        return None
    out = []
    for i in range(len(gops)):
        out.extend(lanes[(i % layout.gop) * layout.tile][i // layout.gop])
    return out


def launch_counts() -> dict:
    """This process's kernel launch counters, by kernel."""
    from vp8oclenc_tpu_torch import ssim_fx as S
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    return {"luma_wavefront": I.luma_wavefront.launches,
            "chroma_wavefront": I.chroma_wavefront.launches,
            "loop_filter": LF.filter_planes.launches,
            "loop_filter_band": LF.filter_band.launches,
            "fullpel_search": IN.fullpel_search.launches,
            "fullpel_search_shard": IN.fullpel_search.shard_launches,
            "qpel_search": IN.qpel_search.launches,
            "qpel_search_shard": IN.qpel_search.shard_launches,
            "trial_luma": IR.trial_luma.launches,
            "trial_chroma_merge": IR.trial_chroma_merge.launches,
            "inter_pass": IN.inter_pass.launches,
            "mb_ssim": S.mb_ssim_cuda.launches}


def _encode_rank(layout, cfg, frames, width, height):
    base = launch_counts()
    t0 = time.monotonic()
    out = encode_frames_multirank(cfg, frames, width, height, layout)
    if layout.device.type == "cuda":
        torch.cuda.synchronize(layout.device)
    seconds = time.monotonic() - t0
    counts = {k: v - base[k] for k, v in launch_counts().items()}
    every = [None] * layout.world
    dist.all_gather_object(every, (counts, seconds))
    if layout.rank != 0:
        return None
    total = {k: sum(c[k] for c, _ in every) for k in counts}
    return out, total, max(s for _, s in every)


def encode_frames_spawned(cfg: EncoderConfig, frames, width: int,
                          height: int, world: int, backend: str,
                          devices=None, gop=None, tile=None):
    """A multi-rank encode on `world` spawned ranks (parallel/launch.run:
    backend "nccl" or "gloo", the caller's choice; devices None means the
    card, and the CPU runs only when asked for).  Returns (payloads in stream order, kernel launches summed over the
    ranks, the slowest rank's seconds from its first GOP to its last
    payload)."""
    from vp8oclenc_tpu_torch.parallel.launch import run
    return run(_encode_rank, world, backend, devices,
               args=(cfg, frames, width, height), gop=gop, tile=tile)
