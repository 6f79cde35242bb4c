"""Encoder configuration.

Same knob set as the reference CLI (reference init.h:1295-1608):
qmin/qmax, GOP size, token partitions, threads, SSIM target, altref range —
plus TPU-specific mesh controls.  Derived state (segment quantizer ladders,
geometry) mirrors init.h:375-394 and the ladder derivation at init.h:1593-1604.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from vp8oclenc_tpu_torch.tables import UQ_SEGMENT, HQ_SEGMENT, AQ_SEGMENT, LQ_SEGMENT

DEFAULT_ALTREF_RANGE = 5


@dataclass
class EncoderConfig:
    qi_min: int = 0
    qi_max: int = 48
    gop_size: int = 150
    num_partitions: int = 1
    threads: int = 2
    ssim_target: float = -1.0     # disabled unless in (0, 1)
    altref_range: int = DEFAULT_ALTREF_RANGE
    loop_filter_type: int = 0     # 0 = normal filter (the only mode, like the reference)
    print_info: bool = False
    # TPU mesh controls (new scope vs the reference)
    gop_parallel: int = 1         # chips along the GOP (data-parallel) axis
    tile_parallel: int = 1        # chips along the in-frame tile axis

    # derived
    lastqi: list = field(default_factory=list, init=False)
    altrefqi: list = field(default_factory=list, init=False)
    partitions_log2: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        if self.qi_max < self.qi_min:
            self.qi_min, self.qi_max = self.qi_max, self.qi_min
        self.qi_min = max(0, min(127, self.qi_min))
        self.qi_max = max(0, min(127, self.qi_max))
        if self.num_partitions not in (1, 2, 4, 8):
            self.num_partitions = 1
        if self.ssim_target >= 1.0:
            raise ValueError(
                f"ssim_target must be a fraction in (0, 1) (got "
                f"{self.ssim_target}); the CLI's -SSIM-target takes percent "
                f"and divides by 100 (config_from_args)")
        self.partitions_log2 = {1: 0, 2: 1, 4: 2, 8: 3}[self.num_partitions]

        qmin, qmax = self.qi_min, self.qi_max
        lastqi = [0] * 4
        lastqi[UQ_SEGMENT] = (qmax + qmin * 3 + 2) // 4
        lastqi[HQ_SEGMENT] = (qmax + qmin + 1) // 2
        lastqi[AQ_SEGMENT] = (qmax * 3 + qmin + 2) // 4
        lastqi[LQ_SEGMENT] = qmax
        altrefqi = [0] * 4
        altrefqi[UQ_SEGMENT] = max(lastqi[UQ_SEGMENT] // 4, qmin)
        altrefqi[HQ_SEGMENT] = lastqi[HQ_SEGMENT] // 3
        altrefqi[AQ_SEGMENT] = lastqi[AQ_SEGMENT] // 3
        altrefqi[LQ_SEGMENT] = lastqi[LQ_SEGMENT] // 2
        self.lastqi = lastqi
        self.altrefqi = altrefqi


def build_arg_parser():
    import argparse
    p = argparse.ArgumentParser(
        prog="vp8oclenc_tpu_torch",
        description="VP8 encoder on an NVIDIA GPU (Y4M in, IVF out)")
    p.add_argument("-i", dest="input", required=True,
                   help="input Y4M path ('@' = stdin)")
    p.add_argument("-o", dest="output", required=True, help="output IVF path")
    p.add_argument("-qmin", type=int, default=0, help="min quantizer index (keyframes)")
    p.add_argument("-qmax", type=int, default=48, help="max quantizer index")
    p.add_argument("-g", dest="gop", type=int, default=150, help="GOP size")
    p.add_argument("-partitions", type=int, default=1, choices=(1, 2, 4, 8),
                   help="token partitions")
    p.add_argument("-threads", type=int, default=2, help="host packer threads")
    p.add_argument("-SSIM-target", dest="ssim_target", type=int, default=-1,
                   help="per-MB SSIM target in percent (0-99); -1 disables")
    p.add_argument("-altref-range", dest="altref_range", type=int,
                   default=DEFAULT_ALTREF_RANGE, help="frames between altrefs")
    p.add_argument("-print-info", dest="print_info", action="store_true")
    p.add_argument("-frames", type=int, default=0, help="max frames to encode (0 = all)")
    p.add_argument("-backend", choices=("torch", "spec"), default="torch",
                   help="pixel pipeline: the torch backend (see -device) or "
                        "the numpy spec reference on the host")
    p.add_argument("-device", choices=("cuda", "cpu"), default="cuda",
                   help="torch backend's device: hand-written CUDA kernels, "
                        "or their plain PyTorch versions on the CPU")
    return p


def config_from_args(args) -> EncoderConfig:
    return EncoderConfig(
        qi_min=args.qmin, qi_max=args.qmax, gop_size=args.gop,
        num_partitions=args.partitions, threads=args.threads,
        ssim_target=(args.ssim_target / 100.0) if args.ssim_target >= 0 else -1.0,
        altref_range=args.altref_range, print_info=args.print_info)
