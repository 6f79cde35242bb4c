"""Where one 1080p (UHD, 8K) inter frame of the PyTorch/CUDA port spends
its time, on one NVIDIA GPU, from a torch.profiler trace.

    python3 tools/profile_inter_cuda.py [--ssim] [--uhd | --wide]

Encodes the keyframe and one inter frame of chip_smoke.py's panned canvas
(default GOP, qi 10..40) to warm up, then traces 3 more inter frames, each
dispatched (`Encoder._frame_pixels`), synchronized and finalized.  With
`--ssim` the frames are chip_smoke.py's replacement content under its SSIM
target (qi 50..112, target 0.98): the segment loop, the three luma trials
and the replacement merge are in the trace.  With `--uhd` the frames are
3840x2160 (chip_smoke.py's UHD content and settings, GOPs long enough
that every traced frame is an inter frame); with `--wide` they are
7680x4320 at the same settings (chip_smoke.py's 8K content; under
`--ssim` 4x UHD's replacement cells; the trace's name ends in `_wide`
in place of `_uhd`).  Prints,
per inter frame: device time by kernel name (the top entries and the
rest), the number of device kernels, the host time of the dispatch and
the number of kernel launches it made.  The Chrome trace goes to
chiprun_out/profile_inter_cuda[_ssim][_uhd].json.  Exits non-zero without a card or
when the trace holds no device time.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRACED = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_inter_cuda: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import (SSIM_CFG, UHD_CFG, UHD_H, UHD_REGIONS,
                            UHD_SSIM_CFG, UHD_W, WIDE_H, WIDE_W,
                            nvidia_smi_line, synth_moving,
                            synth_replacement, W, H)
    from torch.profiler import ProfilerActivity, profile
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder, _own_padded

    ssim = "--ssim" in sys.argv[1:]
    wide = "--wide" in sys.argv[1:]
    uhd = "--uhd" in sys.argv[1:] or wide      # UHD's settings
    w, h = (WIDE_W, WIDE_H) if wide else (UHD_W, UHD_H) if uhd else (W, H)
    print(nvidia_smi_line())
    if ssim:
        frames = synth_replacement(
            2 + N_TRACED, seed=1, w=w, h=h,
            **({"regions": UHD_REGIONS * (4 if wide else 1)} if uhd
               else {}))
        cfg = EncoderConfig(**(UHD_SSIM_CFG if uhd else SSIM_CFG))
    else:
        frames = synth_moving(2 + N_TRACED, seed=1, w=w, h=h)
        cfg = EncoderConfig(**dict(UHD_CFG, gop_size=150)) if uhd else \
            EncoderConfig(qi_min=10, qi_max=40, gop_size=150,
                          altref_range=5)
    enc = Encoder(cfg, w, h, device="cuda")
    for f in frames[:2]:
        fd, seg = enc._frame_pixels(_own_padded(f))
        enc._finalize_fd(fd, seg)
        enc._finish_frame(fd, seg)
    padded = [_own_padded(f) for f in frames[2:]]
    torch.cuda.synchronize()

    dispatch_ms = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for p in padded:
            t0 = time.perf_counter()
            fd, seg = enc._frame_pixels(p)
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            if enc._finalize_fd(fd, seg) or fd.is_key:
                raise AssertionError("a traced frame was a keyframe or "
                                     "asked to be done again as one")
    enc.close()

    device, launches = {}, 0
    for ev in prof.events():
        dt = getattr(ev, "device_type", None)
        if dt == torch.autograd.DeviceType.CUDA:
            device.setdefault(ev.name, [0, 0.0])
            device[ev.name][0] += 1
            device[ev.name][1] += ev.time_range.elapsed_us() / 1e3
        elif ev.name in ("cudaLaunchKernel", "cuLaunchKernel",
                         "cudaLaunchKernelExC"):
            launches += 1
    total = sum(ms for _, ms in device.values())
    if total <= 0:
        raise AssertionError("the trace holds no device time")
    rows = sorted(device.items(), key=lambda kv: -kv[1][1])
    print(f"per {'SSIM-on ' if ssim else ''}inter frame, mean of "
          f"{N_TRACED} ({w}x{(h + 15) // 16 * 16}): device time "
          f"{total / N_TRACED:.3f} ms in "
          f"{sum(c for c, _ in device.values()) / N_TRACED:.1f} device "
          f"kernels and copies; host dispatch "
          f"{sum(dispatch_ms) / N_TRACED:.3f} ms with "
          f"{launches / N_TRACED:.1f} kernel launches")
    top = [{"name": name[:90], "calls": c / N_TRACED,
            "ms": round(ms / N_TRACED, 4),
            "share": round(ms / total, 4)} for name, (c, ms) in rows[:20]]
    rest = sum(ms for _, (_, ms) in rows[20:])
    for r in top:
        print(json.dumps(r))
    print(json.dumps({"name": "(all others)", "ms": round(rest / N_TRACED, 4),
                      "share": round(rest / total, 4)}))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out, "profile_inter_cuda" + "_ssim" * ssim
        + ("_wide" if wide else "_uhd" if uhd else "") + ".json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
