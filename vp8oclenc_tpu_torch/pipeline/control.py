"""Frame-level policies that the single-rank encoder (pipeline/encoder.py
with ops/backend.py) and the multi-rank lanes (parallel/encoder.py) both
follow, kept in one place so that their streams stay equal: the
GOLDEN/ALTREF schedule, the SSIM controller's redo-as-key verdict and the
weakened loop filter of the frame header."""
from __future__ import annotations

from dataclasses import dataclass

from vp8oclenc_tpu_torch.ssim_fx import WEAKEN_FX


@dataclass
class RefSchedule:
    """Which frames become GOLDEN (every keyframe) and ALTREF (every
    keyframe and every altref_range-th frame), and which references an
    inter frame may use: GOLDEN not right after a golden frame, ALTREF not
    right after an altref frame nor while it is the same frame as GOLDEN.
    The fields carry the names of the encoder's checkpoint keys."""
    altref_range: int
    frames_until_altref: int = 2
    prev_is_golden: bool = False
    prev_is_altref: bool = False
    golden_frame_number: int = -1
    altref_frame_number: int = -1

    def next_is_altref(self, is_key: bool) -> bool:
        """Count the next frame down the altref schedule; True when it
        becomes ALTREF."""
        self.frames_until_altref -= 1
        is_altref = self.frames_until_altref < 1 or is_key
        if is_altref:
            self.frames_until_altref = self.altref_range
        return is_altref

    def usable(self):
        """(GOLDEN usable, ALTREF usable) for the next inter frame."""
        return (not self.prev_is_golden,
                (not self.prev_is_altref)
                and self.altref_frame_number != self.golden_frame_number)

    def coded(self, frame_number: int, is_golden: bool,
              is_altref: bool) -> None:
        """Record that frame `frame_number` was coded and promoted."""
        if is_golden:
            self.golden_frame_number = frame_number
        if is_altref:
            self.altref_frame_number = frame_number
        self.prev_is_golden = is_golden
        self.prev_is_altref = is_altref


def redo_reason(sum_fx: int, replaced: int, mbc: int, tfx: int):
    """The SSIM controller's verdict on an inter frame of mbc MBs: "ssim"
    when its SSIM sum is below tfx per MB, "replaced" when more than a
    sixth of its MBs were replaced by intra MBs, None when the frame
    stands or SSIM control is off (tfx < 0)."""
    if tfx < 0:
        return None
    if sum_fx < tfx * mbc:
        return "ssim"
    if replaced > mbc // 6:
        return "replaced"
    return None


def take_weak_filter(seg, weak, min_fx: int) -> None:
    """The frame header carries the weakened loop filter `weak` when the
    frame's minimum MB SSIM is above WEAKEN_FX (the device made the same
    choice when it filtered the frame)."""
    if min_fx > WEAKEN_FX:
        seg.__dict__.update(weak.__dict__)
