"""CLI entry point: Y4M in, IVF out, encoded on an NVIDIA GPU (or with the
kernels' plain PyTorch versions on the CPU under `-device cpu`, or with the
numpy spec reference on the host under `-backend spec`).

    python -m vp8oclenc_tpu_torch -i in.y4m -o out.ivf

SSIM control is off by default; `-SSIM-target N` (percent) turns on the
per-MB quantizer segments, the intra replacement and the quality-forced
keyframes."""
from __future__ import annotations

import sys
import time

from vp8oclenc_tpu_torch.config import build_arg_parser, config_from_args
from vp8oclenc_tpu_torch.io.ivf import IVFWriter
from vp8oclenc_tpu_torch.io.y4m import Y4MReader, Y4MWriter, crop_frame, Frame
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
from vp8oclenc_tpu_torch.ssim_fx import fx_to_float


def main(argv=None) -> int:
    parser = build_arg_parser()
    parser.add_argument("-dump-recon", dest="dump_recon", default=None,
                        help="write the encoder's reconstruction as Y4M")
    parser.add_argument("-devices", action="store_true",
                        help="print the CUDA device inventory and exit")
    args = parser.parse_args(argv)
    if args.devices:
        import torch
        for i in range(torch.cuda.device_count()):
            print(f"{i}. cuda: {torch.cuda.get_device_name(i)}")
        return 0
    cfg = config_from_args(args)

    reader = Y4MReader(args.input)
    info = reader.info
    enc = Encoder(cfg, info.width, info.height,
                  device=args.device if args.backend == "torch" else None,
                  backend=args.backend)

    dump = None
    dump_fh = None
    if args.dump_recon:
        dump_fh = open(args.dump_recon, "wb")
        dump = Y4MWriter(dump_fh, info.width, info.height,
                         info.fps_num, info.fps_den)

    try:
        with open(args.output, "wb") as fh:
            writer = IVFWriter(fh, info.width, info.height,
                               framerate=info.framerate, timescale=1)
            total_bytes = 0
            t0 = time.monotonic()

            def frame_iter():
                for n, frame in enumerate(reader):
                    if args.frames and n >= args.frames:
                        return
                    yield frame

            if dump is not None:
                # sequential path: enc.recon must be the frame just written
                payloads = (enc.encode_frame(f) for f in frame_iter())
            else:
                payloads = enc.encode_frames(frame_iter())
            for n, payload in enumerate(payloads):
                writer.write_frame(payload)
                total_bytes += len(payload)
                if dump is not None:
                    ry, ru, rv = enc.recon
                    dump.write_frame(crop_frame(Frame(ry, ru, rv),
                                                info.width, info.height))
                if cfg.print_info:
                    fps = info.framerate
                    br = total_bytes * fps * 8 // (n + 1) // 1024
                    line = (f"{n}> br={br}k, "
                            f"frame~{(len(payload) + 512) // 1024}k")
                    fs = enc.last_frame_stats
                    if fs and fs["ssim_sum_fx"] is not None:
                        avg = fx_to_float(fs["ssim_sum_fx"] / enc.mbc)
                        mn = fx_to_float(fs["ssim_min_fx"])
                        line += (f" avg_SSIM={avg:.4f} min_SSIM={mn:.4f}"
                                 f" blocks_replaced={fs['replaced']}")
                    print(line)
            writer.finalize()
            dt = time.monotonic() - t0
            print(f"encoded {writer.frame_count} frames in {dt:.2f}s "
                  f"({writer.frame_count / max(dt, 1e-9):.2f} fps), "
                  f"{total_bytes} bytes")
            st = enc.stats
            print(f"{st.scene_changes_by_color} scene changes detected by "
                  f"color change")
            print(f"{st.scene_changes_by_ssim} scene changes detected by low "
                  f"ssim value")
            print(f"{st.scene_changes_by_replaced} scene changes detected by "
                  f"high amount of replaced blocks")
    finally:
        enc.close()
        if dump_fh is not None:
            dump_fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
