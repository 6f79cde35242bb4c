"""The end-to-end phases of chip_smoke.py alone, for running two trees in
turns on one card: the 10-frame 1080p default-GOP encode and the 10-frame
`-g 1` encode, or with `--ssim` the 10-frame SSIM-target encode, each with
its frames per second, frame interval, host split and its byte comparison
against the plain CPU stream.

    python3 tools/e2e_phases_cuda.py [--root DIR] [--ssim]

`--root` names the checkout whose chip_smoke.py and package are run
(default: the one this file is in).  The paths are host-bound and the
machine's CPU cores are shared, so one run says little: alternate the two
trees several times inside one command (parent, change, change, parent,
...) and compare the spreads.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--ssim", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if not torch.cuda.is_available():
        print("e2e_phases_cuda: no CUDA device", file=sys.stderr)
        return 1
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke
    dev = torch.device("cuda", 0)
    print(f"== {root} | {chip_smoke.nvidia_smi_line()}", flush=True)
    if args.ssim:
        chip_smoke.phase_ssim_target(dev)
    else:
        chip_smoke.phase_default_gop(dev)
        chip_smoke.phase_end_to_end(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
