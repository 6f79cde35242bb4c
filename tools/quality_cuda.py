"""Quality curve of the port: PSNR and SSIM against bitrate over a
quantizer sweep, by the procedure of the JAX package's bench_quality.py,
through the port's Encoder, decoder and metrics.

    python3 tools/quality_cuda.py [--device cuda|cpu] [--hd1080]

By default the ten 352x288 rows (six all-intra quantizers and four
full-feature ranges: three references, segments, SSIM target 0.93), 8
frames of a synthetic textured pan each; `--hd1080` gives the 8-frame
1920x1080 `full_1080p_q12-40` row instead.  Every decoded frame must
equal the encoder's reconstruction in Y, U and V, and PSNR and SSIM are
taken from the reconstruction.  The rows are printed as JSON to be held
against bench_quality.json; nothing is written.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def synth_sequence(w, h, n, seed=0):
    from vp8oclenc_tpu_torch.io.y4m import Frame
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 64, 0:w + 64]
    base = (128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
            + 40 * np.sin((xx + yy) / 11.0))
    base = (base + rng.integers(0, 24, base.shape)).clip(0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        ox, oy = 3 * t, 2 * t
        y = np.ascontiguousarray(base[oy:oy + h, ox:ox + w])
        u = np.ascontiguousarray(base[oy // 2:oy // 2 + h // 2,
                                      ox // 2:ox // 2 + w // 2] // 2 + 60)
        v = np.ascontiguousarray(base[oy // 2 + 8:oy // 2 + 8 + h // 2,
                                      ox // 2 + 4:ox // 2 + 4 + w // 2] // 2 + 50)
        frames.append(Frame(y, u, v))
    return frames


def run_config(name, cfg_kwargs, frames, w, h, device="cuda", fps=30,
               decode_frames=None, timings=None):
    """Encode `frames` frame by frame and return the row: kbps, mean PSNR
    over all samples and mean SSIM (luma twice, each chroma plane once).
    The first `decode_frames` frames (all when None) are decoded and must
    equal the reconstruction; `timings`, a dict, receives the seconds spent
    encoding, decoding and scoring."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.decoder.vp8dec import VP8Decoder
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
    from vp8oclenc_tpu_torch.utils.metrics import frame_psnr, ssim_plane

    enc = Encoder(EncoderConfig(**cfg_kwargs), w, h, device=device)
    dec = VP8Decoder()
    total = 0
    psnrs, ssims = [], []
    spent = {"encode_s": 0.0, "decode_s": 0.0, "metrics_s": 0.0,
             "decoded": 0}
    try:
        for i, f in enumerate(frames):
            t0 = time.perf_counter()
            payload = enc.encode_frame(f)
            total += len(payload)
            rec_planes = [np.asarray(p) for p in enc.recon]
            t1 = time.perf_counter()
            if decode_frames is None or i < decode_frames:
                out = dec.decode_frame(payload)
                for plane, got, ref in zip("YUV", (out.y, out.u, out.v),
                                           rec_planes):
                    if not np.array_equal(got, ref):
                        raise AssertionError(f"{name} frame {i}: decoded "
                                             f"{plane} differs from the "
                                             f"recon")
                spent["decoded"] += 1
            t2 = time.perf_counter()
            ry, ru, rv = rec_planes
            src = (f.y, f.u, f.v)
            rec = (ry[:h, :w], ru[:h // 2, :w // 2], rv[:h // 2, :w // 2])
            psnrs.append(frame_psnr(src, rec)["all"])
            ssims.append((ssim_plane(src[0], rec[0]) * 2
                          + ssim_plane(src[1], rec[1])
                          + ssim_plane(src[2], rec[2])) / 4)
            t3 = time.perf_counter()
            spent["encode_s"] += t1 - t0
            spent["decode_s"] += t2 - t1
            spent["metrics_s"] += t3 - t2
    finally:
        enc.close()
    if timings is not None:
        timings.update(spent)
    kbps = total * 8 * fps / len(frames) / 1000.0
    return {"config": name, "kbps": round(kbps, 1),
            "psnr": round(float(np.mean(psnrs)), 3),
            "ssim": round(float(np.mean(ssims)), 4), **cfg_kwargs}


FULL = dict(gop_size=100, altref_range=5, ssim_target=0.93)
HD1080 = ("full_1080p_q12-40", 1920, 1080, 8, dict(qi_min=12, qi_max=40,
                                                   **FULL))


def rows_352x288(device):
    """The ten rows of bench_quality.json's `rows`, in its order."""
    w, h = 352, 288
    seq = synth_sequence(w, h, 8)
    rows = []
    for qi in (8, 20, 36, 56, 80, 104):
        rows.append(run_config(f"intra_qi{qi}",
                               dict(qi_min=qi, qi_max=qi, gop_size=1),
                               seq, w, h, device))
    for qi_min, qi_max in ((4, 24), (12, 40), (24, 63), (40, 100)):
        rows.append(run_config(f"full_q{qi_min}-{qi_max}",
                               dict(qi_min=qi_min, qi_max=qi_max, **FULL),
                               seq, w, h, device))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--hd1080", action="store_true",
                    help="the 8-frame 1920x1080 full-feature row instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    if args.hd1080:
        name, w, h, n, cfg = HD1080
        timings = {}
        row = run_config(name, cfg, synth_sequence(w, h, n), w, h,
                         args.device, decode_frames=3, timings=timings)
        print(json.dumps({"hd_rows": [dict(row, size=f"{w}x{h}", frames=n)],
                          "timings": timings}))
        return 0
    print(json.dumps({"size": "352x288", "frames": 8,
                      "rows": rows_352x288(args.device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
