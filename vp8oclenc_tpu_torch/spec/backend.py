"""Spec backend: the sequential numpy oracle behind `backend="spec"` (CLI
`-backend spec`), the counterpart of the JAX package's spec path.

It gives the port's Encoder the interface of ops/backend.TorchBackend, in
numpy on the host: the keyframe (spec/intra), the inter frame (spec/inter:
motion search over LAST, GOLDEN and ALTREF, the segment passes and under
an SSIM target the intra replacement) and the loop filter
(spec/loopfilter), all done at once when the frame is dispatched.  The
SSIM verdict is handed back through finalize_framedata, as the torch
backend hands back its device's, so the Encoder's speculative frame loop
runs unchanged.  The references are the post-filter planes as numpy
arrays; each frame's planes are fresh arrays, filtered before they become
LAST, and a snapshot copies them.
"""
from __future__ import annotations

import numpy as np
import torch

from vp8oclenc_tpu_torch.entropy import tokens as TOK
from vp8oclenc_tpu_torch.spec import inter as SPEC_INTER
from vp8oclenc_tpu_torch.spec import intra as SPEC_INTRA
from vp8oclenc_tpu_torch.spec import loopfilter as SPEC_LF
from vp8oclenc_tpu_torch.tables import ARE4X4, ARE16X16, INTRA_SEGMENT


def _copy(planes):
    return None if planes is None else tuple(np.array(p) for p in planes)


class SpecBackend:
    def __init__(self, cfg, wrk_w: int, wrk_h: int) -> None:
        self.cfg = cfg
        self.device = torch.device("cpu")
        self.mbc = (wrk_w // 16) * (wrk_h // 16)
        # post-filter reference planes (y, u, v)
        self.last = None
        self.golden = None
        self.altref = None

    def upload_frame(self, y, u, v):
        """Nothing to upload: the planes are read where they are."""
        return None

    def _loop_filter(self, recon, segment_ids, parts, levels, seg) -> None:
        """Filter recon in place and make it LAST."""
        skip, _ = TOK.mb_skip_flags(levels, parts)
        inner = (parts != ARE16X16) | (~skip)
        SPEC_LF.loop_filter_frame(*recon, segment_ids, inner, seg)
        self.last = tuple(recon)

    def encode_intra_frame(self, y, u, v, seg, yuv_dev=None):
        """Code and filter a keyframe; returns ((levels, modes), recon)."""
        levels, modes, recon = SPEC_INTRA.encode_intra_frame(y, u, v, seg)
        recon = [r.copy() for r in recon]
        self._loop_filter(recon, np.full(self.mbc, INTRA_SEGMENT, np.int32),
                          np.full(self.mbc, ARE4X4, np.int32), levels, seg)
        return (levels, modes), recon

    def encode_inter_frame(self, enc, y, u, v, seg, is_golden, is_altref,
                           yuv_dev=None):
        """Code and filter an inter frame against the references that
        enc.refs allows; the SSIM verdict waits on the FrameData for
        finalize_framedata."""
        fd, recon, reason = SPEC_INTER.encode_inter_frame(
            self.cfg, (self.last, self.golden, self.altref),
            enc.refs.usable(), y, u, v, seg, is_golden, is_altref)
        fd.redo = reason
        self._loop_filter(recon, fd.segment_ids, fd.parts, fd.levels, seg)
        enc.recon = recon
        return fd

    def finalize_framedata(self, fd, seg):
        """Fill a keyframe's levels and modes; for an inter frame return
        the SSIM controller's verdict (None, "ssim" or "replaced")."""
        outs = getattr(fd, "device_outputs", None)
        if outs is not None:
            fd.device_outputs = None
            fd.levels, fd.modes = outs
        return getattr(fd, "redo", None)

    def promote_refs(self, is_golden: bool, is_altref: bool) -> None:
        if is_golden:
            self.golden = self.last
        if is_altref:
            self.altref = self.last

    def set_refs(self, last, golden=None, altref=None) -> None:
        """Install host reference planes (a restored checkpoint)."""
        self.last, self.golden, self.altref = \
            _copy(last), _copy(golden), _copy(altref)

    def host_refs(self):
        """Copies of (LAST, GOLDEN, ALTREF) as numpy planes."""
        return _copy(self.last), _copy(self.golden), _copy(self.altref)

    def snapshot(self):
        """The references before a frame, copied."""
        return self.host_refs()

    def restore(self, snap) -> None:
        self.last, self.golden, self.altref = snap
