"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit (nvidia-smi); the integer
     instruction rate the bounds use, reckoned as SMs x 64 lanes x the SM
     clock (the SM count from torch, the clock from nvidia-smi) and
     measured beside it with a probe kernel of independent integer chains;
  2. build: every kernel of csrc/ with nvcc (one process per source, in
     parallel), and the host entropy packer with g++; ptxas's registers and
     spills for every kernel go to the log;
  3. kernels: each intra and loop-filter kernel against its plain PyTorch
     version on the same card at 1920x1088, on synthetic planes made from a
     seed at two quantizer pairs, the three row pipelines (luma wavefront,
     chroma wavefront, loop filter: one CTA per MB row, rows pipelined
     through progress counters) five launches each, every one compared;
     the three again on a 64x2176 frame (136 MB rows, more than the card
     has SMs; chroma also as two 32x2176 planes, 272 rows), on 16x16,
     16x1088 and 1920x16 frames, with a mixed inner-edge mask and two
     segments of which one has level 0; their time on one MB row of width
     1920, which no row above holds up, scaled to the frame's chain of
     steps (the "chain" figure: what of the 1080p time is step latency,
     the rest is waiting for the row above); then the full-pel and
     quarter-pel search kernels against theirs on the real pyramid levels
     4..0 of two contents (a panned canvas searched level by level, and
     noise searched from random vectors that reach past the frame edges),
     both also at 16x16, 8x40, 56x8, 10x8, 11x9, 22x18 and 64x2176 (full
     pel with the penalty off and on); then the frozen-neighbour luma trial
     against its plain version at 8160 MBs, at the AQ, HQ and UQ quantizers
     of -qmin 50 -qmax 112, on neighbours cut from a keyframe-coded plane
     and on random sources and neighbours with all-0 and all-255 MBs, and
     at 1, 7 and 8161 MBs; then the integer per-MB SSIM kernel (which no
     encoder path launches any more: the passes and the trials score
     their MBs) against its plain version in every operand form (whole
     planes
     with an int32 and a u8 recon, per-MB patches, non-contiguous views of
     the planes: its vector path; misaligned planes: its strided path),
     with edge MBs (identical, flat, all 0 against all 255, all 255
     against both), at 1920x1088, 3840x2160 and 16384x128, timed on the
     trials' patches, and at 1, 7 and 8161 MBs; then the transform pass
     kernel (one segment pass of an inter frame with its MBs' SSIM and
     the cur_ssim merge) and the chroma trial kernel with its score and
     merge (csrc/transform.cu) against their plain versions at 1920x1088,
     3840x2160 and 16384x128, the pass four times at the SSIM segments'
     quantizers (the later passes masked to about half the MBs), twice at
     the extremes and twice with a u8 chroma prediction, with +-255
     residuals, the trial three times chained at the three SSIM quantizer
     pairs from the pass's scores (about half the MBs active, some
     winning), with and without a ghost row and with none active; outputs
     must be bit-identical; kernels are timed
     by the card's clock (`cuda_ms`), plain versions with CUDA events
     around one call (`span_ms`);
  4. all-keyframe path: 10 synthetic 1920x1080 frames through
     Encoder.encode_frames with gop_size=1 on cuda, with each kernel's
     launch counter set to 0 before and read after; then the first 2
     frames again with the plain versions on the CPU, whose bytes must be
     identical;
  5. default-GOP path: 10 frames of a panned canvas with gop_size=150,
     altref_range=5 (1 keyframe, then inter frames over LAST, GOLDEN and
     ALTREF), counters as in 4; at least 8 inter frames, every kernel
     launched (the transform pass once per inter frame; the SSIM kernel
     never: the pass scores its MBs), some vectors nonzero
     and GOLDEN or ALTREF chosen somewhere;
     the inter device-chain time and the sequential host split; the first 3
     frames again on the CPU, whose bytes must be identical;
  6. SSIM-target path: 10 frames of static noise with 200 regions of 32x32
     that get a fresh smooth gradient every frame, constant chroma, at
     -qmin 50 -qmax 112 -SSIM-target 98, gop_size=150: at least 8 inter
     frames, the luma and chroma trial kernels launched 3 times per inter
     frame, the transform pass 4 times and the SSIM kernel never (the
     passes and the trials score their MBs), some MBs
     replaced on some frame and never more than a sixth, more than one
     segment in use, no frame done again as a key; an SSIM-on inter frame
     dispatched with stream synchronization an error; the inter
     device-chain time and the host split; the first 3 frames again on the
     CPU, whose bytes must be identical;
  7. redo-as-key: 5 smooth 1920x1080 frames whose luma is replaced
     wholesale at frame 2 while chroma stays constant, at qi 95..127 and
     ssim_target=0.985 through encode_frames at depth 3, so frames 3 and 4
     are in flight when frame 2's verdict arrives: at least one redo, the
     frame comes out as a key, every frame's bytes identical to the CPU's;
  8. the search kernels in row-shard mode (a reference strip, the shard's
     first row, the frame's height) against their plain versions on strips
     of 1080p pyramid levels 1 and 0: 2 and 4 shards, the top, an interior
     and the bottom one, vectors to the halo's edge; timed on a 2-tile
     shard (1920x544 and 80 halo rows each side);
  9. the loop filter in band mode: 2 and 4 bands of a 1080p frame handed
     down with their 4 halo lines in and 3 lines back, equal to the
     whole-plane kernel, each launch equal to its plain version; timed on
     a 1920x544 band;
  10. the multi-GPU layer (parallel/) on the one card, ranks over gloo
     (NCCL refuses two ranks on one device): 10 frames of the panned
     canvas at gop_size=5 over 4 ranks (2 gop lanes x 2 row tiles), and 5
     frames of the SSIM-target replacement content over 2 ranks (1 lane x
     2 tiles), each byte-identical to the single-rank encode of the same
     frames on the card; the ranks' launch counters (zero at their start,
     summed over them) must show every kernel of the path, the searches
     and the filter in their shard and band modes; fps is logged as that
     of ranks sharing one card, not a scaling figure;
  11. quality: the `full_1080p_q12-40` row of bench_quality.json
     reproduced through tools/quality_cuda.run_config on the card
     (synth_sequence seed 0, 8 frames of 1920x1080, qi 12..40,
     gop_size=100, altref_range=5, ssim_target=0.93: a keyframe, inter
     frames over three references and the SSIM controller, so every
     kernel runs, counters as in 4); its kbps, PSNR and SSIM equal to the
     row at the row's rounding; frames 0-1 decoded by the port's decoder
     (vp8oclenc_tpu_torch/decoder), Y, U and V bit-exact against the
     card's recon; then a 96x80 default-GOP stream through the spec
     backend (the numpy oracle) byte-identical to the card's; a
     `quality` JSON line;
  12. UHD (3840x2160, 240 x 135 MB rows): the six kernels against their
     plain versions on the card at that size (luma and chroma on a frame
     of the panned canvas, the loop filter whole plane and as bands of 68
     and 67 MB rows handed down, both searches on the five levels of the
     canvas's pyramid, the luma trial at 32400 MBs at the three SSIM
     quantizer pairs), each timed with its bound and share; then, at 4
     token partitions and 6 packer threads, 6 frames of the panned canvas
     in GOPs of 3 and 3 frames of replacement content under the SSIM
     target through Encoder.encode_frames on cuda, counters as in 4, every
     kernel of each path launched (the trial 3 times per inter frame), the
     first 2 frames of each byte-identical to the plain CPU encode, fps,
     frame interval, device chains and host split logged; the 6 frames
     over 4 ranks (2 gop lanes x 2 row tiles of 68 and 67 MB rows, halos
     exchanged) sharing the card over gloo, byte-identical to one rank,
     the searches and the filter in their shard and band modes; a `uhd`
     JSON line;
  13. wide planes (`[wide]`): the row kernels' shared memory at 16384
     pixels (VP8's widest, padded to MBs) against the card's opt-in
     limit; the six kernels against their plain versions at 16384x128
     (luma and chroma on the panned canvas, the filter on their recon
     with four segments, the searches on its pyramid level by level, the
     trial at the HQ quantizers), each timed with bound and share; the
     filter and luma at 7680x1088, the filter also as 2 bands of 34 MB
     rows handed down (the lower band's launch against its plain
     version, the bands equal to the whole plane); the two timed at 8K
     (7680x4320, 270 MB rows); 2 frames of 7680x1088 at 4 partitions and
     6 threads through encode_frames byte-identical to the plain CPU
     encode; 4 frames of 8K (GOPs of 3: keys at 0 and 3) through
     encode_frames on the card, every kernel of the path launched, the
     keyframe byte-identical to the plain CPU encode, each frame's first
     partition printed against the frame tag's 19-bit field, fps, device
     chains and host split; a `wide` JSON line;
  14. a `kernels` JSON line (each kernel with its launches on the
     default-GOP path, the trials' on the SSIM-target path, the SSIM
     kernel's and the transform pass's on both; its launches on the multi-rank path and, for the
     three with one, its shard or band mode's time, bound and launches;
     its UHD and wide records, the latter with the 8K stream's launches
     and, for the filter and luma, their card ms at 1080p, UHD and 8K),
     the nvidia-smi line, and as the last line {"ok": true, "device":
     {...}}.
The SSIM kernel (csrc/ssim.cu) stays in the `kernels` line with its
checks and times, its launches 0: no encoder path launches it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
# An SM of compute capability 9.0 has two pipes that take 32-bit integer
# instructions, 64 lanes each: one runs multiply-adds (IMAD, dp4a; nvcc also
# sends plain adds there as IMAD.IADD), the other adds, logic, shifts,
# compares, min/max and byte permutes.  They run side by side, so a
# stream that splits evenly between them runs at 128 results a clock, which
# `phase_int_rate` measures; the bounds use that rate, which no integer
# kernel can beat.
INT_LANES_PER_PIPE, INT_PIPES = 64, 2
MAC8_PER_LANE = 4             # 8-bit multiply-adds of one dp4a
# 32-bit integer instructions a second, all SMs and both pipes: set by
# `phase_int_rate` from this card's SM count and clock
INT_OPS_PER_S = None
# torch.cuda._sleep counts SM clock cycles; sized at the card's highest
# clock, a sleep is at least as long as asked for
SLEEP_HZ = 1.98e9
W, H = 1920, 1080
QI_PAIRS = (10, 40)           # keyframe quantizer indices held to the plain
REPEATS = 5                   # launches of a row kernel, each compared
N_FRAMES, N_CPU_FRAMES = 10, 2
N_CPU_GOP_FRAMES = 3          # 1 keyframe and 2 inter frames
SSIM_CFG = dict(qi_min=50, qi_max=112, gop_size=150, ssim_target=0.98)
SSIM_REGIONS = 200            # of 32x32: 800 MBs of 8160, under a sixth
REDO_CFG = dict(qi_min=95, qi_max=127, gop_size=150, ssim_target=0.985)
N_REDO_FRAMES, REDO_AT = 5, 2
N_MULTI_FRAMES, N_MULTI_SSIM_FRAMES = 10, 5   # multi-rank encodes
N_QUALITY_DECODED = 2         # the keyframe and an inter frame
N_SPEC_FRAMES = 5
# UHD (3840x2160: 240 x 135 MBs) at the reference's launch configuration,
# 4 token partitions and 6 packer threads (bench.py's base): 6 frames of
# the panned canvas in GOPs of 3 (2 keyframes, 4 inter frames), 3 of
# replacement content under the SSIM target, 2 of each re-encoded on the
# CPU; the same 6 frames over 2 gop lanes x 2 row tiles (68 + 67 MB rows)
UHD_W, UHD_H = 3840, 2160
UHD_CFG = dict(qi_min=10, qi_max=40, gop_size=3, altref_range=3,
               num_partitions=4, threads=6)
UHD_SSIM_CFG = dict(SSIM_CFG, num_partitions=4, threads=6)
UHD_REGIONS = 800             # of 32x32: 3200 MBs of 32400, 1080p's share
N_UHD_FRAMES, N_UHD_SSIM_FRAMES, N_UHD_CPU_FRAMES = 6, 3, 2
# Planes up to VP8's widest: the six kernels at 16384x128 (the widest
# plane padded to MBs; 128 rows so that pyramid level 4 keeps a block
# row), the loop filter and luma at 7680x1088 whole and as 2 bands, 2
# frames of 7680x1088 on the card and the CPU; 8K (7680x4320: 480 x 270
# MBs) at UHD's settings, 4 frames of the panned canvas (keys at 0 and 3),
# the first also on the CPU
WIDEST_W, WIDEST_H = 16384, 128
WIDE_W, WIDE_H = 7680, 4320
WIDE_STRIP_H = 1088
N_WIDE_FRAMES, N_WIDE_CPU_FRAMES = 4, 2
FULLPEL_FEW_BLOCKS = 1024     # csrc/search.cu kFewBlocks: <1> below, <3> at

# integer operations per unit of work, counted from the kernels' arithmetic
# (each add, multiply, shift, compare, select, abs, clamp and store counts
# one): a luma 4x4 block scores 10 predictors (~16 prediction, 16 residual,
# 128 separable cost transform, 34 abs/sum) and codes the winner (~420 for
# prediction, fdct, quantize, dequantize, idct, clamp, stores); a chroma
# quadrant costs ~440 (prediction, coding, stores); one loop-filter line
# (8 taps) ~45.
OPS_LUMA_BLOCK = 10 * (16 + 16 + 128 + 34) + 420
OPS_CHROMA_QUAD = 440
OPS_FILTER_LINE = 45
# The searches: an 8x8 candidate's cost is 64 residuals, four 4x4
# separable cost transforms (~128 each), four abs/sum/shift tails (~34
# each) and ~12 for the sums, penalty, bounds and select; a full-pel
# candidate outside the frame is only bounds-checked (~12).  A six-tap
# pixel is six 8-bit multiply-adds (pixels and taps fit a byte: counted at
# four a lane and clock, the dp4a rate) and ~4 32-bit operations (shift,
# two clamps, store); at phase 0 it is a copy (1).  A qpel block shares its
# horizontal passes (4 filtered and 1 copied, 14 x 8 pixels each) among
# its candidates; each qpel candidate in the frame adds its vertical pass
# of 64 pixels (a copy where dy is 0) to the cost; the zero vector adds a
# 64-pixel copy.
OPS_COST8 = 64 + 4 * 128 + 4 * 34 + 12
OPS_INVALID = 12
# The full-pel kernel's formulation needs fewer: the cost is linear up
# to the abs, so the column stage of C4 (R - C) C4^T is taken once per
# window position (9 row starts x 12 columns of a 12x12 window, ~12
# operations each: butterflies and the 5/2 products) and once for the
# current block (16 columns, then its 16 rows), and each in-frame candidate
# adds per quadrant four row stages with the current block's subtracted
# (12 + 4), 16 abs, 16 sums and a ~7-operation weighted tail, then ~15 for
# the quadrant sums, penalty, bounds and key.  Both counts are logged; the
# bound uses this one.
OPS_C4 = 12
OPS_CAND_STAGED = 4 * (4 * (OPS_C4 + 4) + 16 + 16 + 7) + 15
OPS_WINDOW_COLUMNS = 9 * 12 * OPS_C4
OPS_SIXTAP_INT, OPS_SIXTAP_MAC8 = 4, 6
# The integer SSIM: five sums a pixel pair (two adds, three multiply-adds),
# which the kernels take four pixels at a time with `dp4a`
# (`ssimfx::add_sums4`), so the bounds count them as 8-bit multiply-adds
# (`bound`'s mac8); an MB reduces its 15 sums over 5 shuffle rounds (a
# shuffle and an add each) and scores three planes: two 15-step divisions
# (~4 a step) and ~40 for the variances, terms, sign, product and penalty
# each
OPS_SSIM_PIXEL = 5
OPS_SSIM_MB = 15 * 5 * 2 + 3 * (2 * 15 * 4 + 40)
# The transform pass: a 4x4 block costs ~16 for the residual, ~168 for
# the fdct's two passes, ~160 to quantize and dequantize, ~176 for the
# idct, ~64 for recon and clamp and ~20 for the zigzag and stores; a 16x16
# MB's Y2 ~400 (two WHTs, quantize, dequantize).  The chroma trial's block
# adds ~64 for TM_PRED.
OPS_TRANSFORM_BLOCK = 600
OPS_Y2 = 400
OPS_TM_BLOCK = 64
MAX_SCORE = 3 * 32767          # three planes at a == d: no MB scores more
LOW_SCORE = -2 * 3 * 32768     # below every score: an active MB wins
QPEL_HPASS_FILTERED, QPEL_HPASS_COPIED = 4 * 14 * 8, 14 * 8


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def synth_plane(rng, h, w, t):
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 7 + yy * 3 + 5 * t) % 256) // 2 + 40
    return (base + rng.integers(0, 90, (h, w))).clip(0, 255).astype(np.uint8)


def synth_frames(n, seed=0):
    from vp8oclenc_tpu_torch.io.y4m import Frame
    rng = np.random.default_rng(seed)
    return [Frame(synth_plane(rng, H, W, t),
                  synth_plane(rng, H // 2, W // 2, t),
                  synth_plane(rng, H // 2, W // 2, t + 1)) for t in range(n)]


def synth_moving(n, seed=0, w=W, h=H):
    """A smooth, textured canvas panned by 3-4 pixels across and 2 down per
    frame, with a little fresh noise: a real inter stream.  (Independent
    noise per frame, as `synth_frames` makes, trips the chroma
    scene-change detector and turns every frame into a keyframe.)"""
    from vp8oclenc_tpu_torch.io.y4m import Frame
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 64, 0:w + 64]
    smooth = 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0) \
        + 40 * np.sin((xx + 2 * yy) / 91.0)
    luma = 120 + smooth + rng.integers(0, 48, smooth.shape)
    cu = 128 + 0.5 * smooth[::2, ::2]
    cv = 128 - 0.4 * smooth[1::2, 1::2]
    out = []
    for t in range(n):
        oy, ox = 2 * t, 3 * t + (t % 2)
        cut = lambda a, y0, x0, ch, cw, e: (
            a[y0:y0 + ch, x0:x0 + cw] + rng.integers(-e, e + 1, (ch, cw))) \
            .clip(0, 255).astype(np.uint8)
        out.append(Frame(cut(luma, oy, ox, h, w, 2),
                         cut(cu, oy // 2, ox // 2, h // 2, w // 2, 1),
                         cut(cv, oy // 2, ox // 2, h // 2, w // 2, 1)))
    return out


def synth_replacement(n, seed=0, w=W, h=H, regions=SSIM_REGIONS):
    """Content that fires the SSIM controller without tripping the redo: a
    static noise background (inter predicts it with a zero vector),
    constant chroma (the scene-change detector watches only U and V), and
    `regions` cells of a 32x32 grid, chosen once, that get a fresh smooth
    gradient every frame: inter mispredicts them, the coarse segments
    cannot repair the residual, and the intra trial reconstructs the ramp
    with a higher SSIM."""
    from vp8oclenc_tpu_torch.io.y4m import Frame
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    gw, gh = w // 32, h // 32
    cells = rng.choice(gw * gh, size=regions, replace=False)
    yy, xx = np.mgrid[0:32, 0:32]
    out = []
    for _ in range(n):
        y = base.copy()
        ab = rng.uniform(-6, 6, (regions, 2))
        for c, (a, b) in zip(cells, ab):
            oy, ox = (c // gw) * 32, (c % gw) * 32
            y[oy:oy + 32, ox:ox + 32] = (128 + a * (xx - 16) + b * (yy - 16)
                                         ).clip(0, 255).astype(np.uint8)
        out.append(Frame(y, u.copy(), v.copy()))
    return out


def synth_redo(n, at, seed=0, w=W, h=H):
    """Constant chroma and a little luma noise over a high-contrast wave;
    from frame `at` on the luma is a gentle, unrelated pattern, so that
    frame's inter residual is large everywhere, its coding noise drowns
    the gentle source (mean SSIM about 0.85), the scene-change detector
    sees nothing, and the SSIM controller must ask for a keyframe.  The
    frames before and after it are static and pass."""
    from vp8oclenc_tpu_torch.io.y4m import Frame
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = 128 + 90 * np.cos((xx - 2 * yy) / 9.0)
    b = 128 + 70 * np.sin(xx / 41.0) * np.cos(yy / 29.0)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    return [Frame(((b if t >= at else a) + rng.integers(-1, 2, (h, w)))
                  .clip(0, 255).astype(np.uint8), u.copy(), v.copy())
            for t in range(n)]


def cuda_ms(fn, reps: int) -> float:
    """Device time of one call of `fn` (ms), by the card's clock: after a
    warm-up call, a `torch.cuda._sleep` goes into the stream first and the
    `reps` calls queue behind it while the card sleeps, so the CUDA events
    around them time the card running them back to back, not the host
    issuing them (a wrapper's checks, allocation and ctypes launch take
    longer than a short kernel).  The sleep is sized from the warm-up
    call's host time and made longer until the host has issued every call
    before it ends."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = max(4 * reps * (time.perf_counter() - t0), 2e-3)
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(sleep_s * SLEEP_HZ))
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if issued < sleep_s:
            return a.elapsed_time(b) / reps
        sleep_s *= 4
    raise AssertionError("the host did not issue the timed calls within "
                         "the card's sleep")


def span_ms(fn) -> float:
    """CUDA events around one call of `fn` issued with the card idle: the
    host's issue pace where it is slower than the card (a plain version's
    hundreds of launches, an inter frame's chain), else the card's time."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        err = max(err, int((x.to(torch.int32) - y.to(torch.int32))
                           .abs().max()))
    return err


def bound(nbytes: float, ops: float, mac8: float = 0.0):
    """The least time (ms) the card could take: bytes over the memory rate
    or 32-bit integer operations (plus 8-bit multiply-adds at four an
    instruction) over the integer instruction rate, whichever is more."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (ops + mac8 / MAC8_PER_LANE) / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def phase_int_rate(dev):
    """Set INT_OPS_PER_S from the card (SMs x 2 pipes x 64 lanes x the SM
    clock) and log the probe kernel's measured rates beside it: multiply-adds
    alone fill one pipe, adds and exclusive-ors (or all three) both.  A card
    held below its clock by its power limit shows here as a lower share."""
    global INT_OPS_PER_S
    from vp8oclenc_tpu_torch.ops import cuda_build
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0].split(",")
    max_mhz, idle_mhz = float(q[0]), float(q[1])
    one_pipe = sms * INT_LANES_PER_PIPE * max_mhz * 1e6
    INT_OPS_PER_S = one_pipe * INT_PIPES
    log(f"  {sms} SMs x {INT_LANES_PER_PIPE} integer lanes x {max_mhz:.0f} "
        f"MHz (clocks.max.sm; clocks.sm read {idle_mhz:.0f} MHz before the "
        f"probe) = {one_pipe / 1e12:.3f} x 10^12 integer instructions a "
        f"second reckoned for one pipe, {INT_OPS_PER_S / 1e12:.3f} for the "
        f"{INT_PIPES} pipes together (the rate of the bounds)")
    lib = cuda_build.library("probe")
    ctas, iters, chains = sms * 8, 4096, 8
    out = torch.empty(ctas * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for mode, what, per_step, pipes in (
            (0, "multiply-add", 1.0, 1), (1, "add, xor", 2.0, 2),
            (2, "multiply-add beside add, xor", 1.5, 2)):
        def run():
            cuda_build.check(lib.vp8_int_rate(
                out.data_ptr(), ctas, iters, mode, 3, 7, stream),
                "vp8_int_rate")
        ms = min(cuda_ms(run, reps=5) for _ in range(3))
        rate = ctas * 256 * chains * iters * per_step / (ms * 1e-3)
        share = rate / (one_pipe * pipes)
        log(f"  probe, {what}: {rate / 1e12:.3f} x 10^12 integer "
            f"instructions a second measured ({share:.1%} of the reckoned "
            f"rate of {pipes} pipe{'s' if pipes > 1 else ''}; {ms:.3f} ms)")
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"  clocks.sm after the probe: {q.splitlines()[0]} MHz")


def phase_kernels(dev):
    """Each kernel against its plain version at 1920x1088, bit-exact."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    f = pad_frame(synth_frames(1, seed=7)[0])
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    Hp, Wp = f.y.shape
    mbc = (Hp // 16) * (Wp // 16)
    rows = {}
    for qi in QI_PAIRS:
        seg = prepare_segments(EncoderConfig(qi_min=qi, qi_max=qi), f.y,
                               True, True)
        ydq, yaq = int(seg.y_dc_q[0]), int(seg.y_ac_q[0])
        cdq, caq = int(seg.uv_dc_q[0]), int(seg.uv_ac_q[0])
        lf = [torch.as_tensor(np.asarray(a, np.int32), device=dev) for a in
              (seg.loop_filter_level, seg.mbedge_limit, seg.sub_bedge_limit,
               seg.interior_limit, seg.hev_threshold)]
        sid = torch.zeros(mbc, dtype=torch.int32, device=dev)
        inner = torch.ones(mbc, dtype=torch.uint8, device=dev)

        k_l = I.luma_wavefront(y, ydq, yaq)
        k_c = I.chroma_wavefront(uv, cdq, caq)
        planes = (k_l[0], k_c[0][0].contiguous(), k_c[0][1].contiguous())
        k_f = LF.filter_planes(*planes, sid, inner, *lf)
        t0 = time.monotonic()
        p_l = I.luma_wavefront_plain(y, ydq, yaq)
        p_c = I.chroma_wavefront_plain(uv, cdq, caq)
        p_f = LF.filter_planes_plain(*planes, sid, inner, *lf)
        torch.cuda.synchronize()
        log(f"  qi={qi}: plain versions on the card took "
            f"{time.monotonic() - t0:.1f} s")
        level = int(seg.loop_filter_level[0])
        specs = [
            ("luma_wavefront", k_l, p_l,
             lambda: I.luma_wavefront(y, ydq, yaq),
             lambda: I.luma_wavefront_plain(y, ydq, yaq),
             Hp * Wp * 2 + mbc * 16 * 16 * 2 + mbc * 16,
             (Hp // 4) * (Wp // 4) * OPS_LUMA_BLOCK),
            ("chroma_wavefront", k_c, p_c,
             lambda: I.chroma_wavefront(uv, cdq, caq),
             lambda: I.chroma_wavefront_plain(uv, cdq, caq),
             uv.numel() * 2 + 2 * mbc * 4 * 16 * 2,
             2 * mbc * 4 * OPS_CHROMA_QUAD),
            ("loop_filter", k_f, p_f,
             lambda: LF.filter_planes(*planes, sid, inner, *lf),
             lambda: LF.filter_planes_plain(*planes, sid, inner, *lf),
             2 * sum(p.numel() for p in planes),
             (mbc * (16 * 4 * 2 + 2 * 8 * 2 * 2) * OPS_FILTER_LINE
              if level > 0 else 0)),
        ]
        for name, kout, pout, kfn, pfn, nbytes, ops in specs:
            err = max_abs_err(kout, pout)
            if err != 0:
                raise AssertionError(f"{name} at qi={qi}: kernel differs "
                                     f"from its plain version by {err}")
            for i in range(REPEATS):          # rows race if the rule is off
                if max_abs_err(kfn(), pout) != 0:
                    raise AssertionError(f"{name} at qi={qi}: launch "
                                         f"{i + 2} differs")
            ms = cuda_ms(kfn, reps=10)
            pms = span_ms(pfn)
            bms, by = bound(nbytes, ops)
            log(f"  {name} qi={qi}: bit-exact, kernel {ms:.3f} ms, plain "
                f"{pms:.1f} ms, bound {bms:.5f} ms ({by})")
            r = rows.setdefault(name, {"max_abs_err": 0, "ms": [],
                                       "plain_ms": [], "bound_ms": [],
                                       "bound_by": by})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"].append(ms)
            r["plain_ms"].append(pms)
            r["bound_ms"].append(bms)

        # one MB row of width 1920: no row above to wait for, so its time
        # over its steps is a step's latency; times the frame's steps it
        # is the chain a 1080p launch cannot go below
        mbw, mbh = Wp // 16, Hp // 16
        y1 = y[:16].contiguous()
        uv1 = uv[:, :8].contiguous()
        row = [p[:n].contiguous() for p, n in zip(planes, (16, 8, 8))]
        sid1, inner1 = sid[:mbw].contiguous(), inner[:mbw].contiguous()
        for name, fn, row_steps, steps in (
                ("luma_wavefront", lambda: I.luma_wavefront(y1, ydq, yaq),
                 Wp // 4 + 6, Wp // 4 + 2 * (Hp // 4 - 1)),
                ("chroma_wavefront",
                 lambda: I.chroma_wavefront(uv1, cdq, caq),
                 mbw, mbw + mbh - 1),
                ("loop_filter",
                 lambda: LF.filter_planes(*row, sid1, inner1, *lf),
                 mbw, mbw + 2 * (mbh - 1))):
            row_ms = cuda_ms(fn, reps=10)
            chain = row_ms / row_steps * steps
            log(f"  {name} qi={qi}: one MB row of {Wp} in {row_ms:.4f} ms, "
                f"{row_ms / row_steps * 1e3:.3f} us a step; chain of "
                f"{steps} steps {chain:.3f} ms")
            rows[name].setdefault("chain_ms", []).append(chain)
    return rows


def phase_row_shapes(dev):
    """The three row-pipelined kernels where the pipeline has its edges:
    more MB rows than SMs, one MB, one MB column, one MB row; the filter
    with a mixed inner-edge mask and two segments, one of level 0."""
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import loopfilter as LF

    for w, h in ((64, 2176), (16, 16), (16, 1088), (1920, 16)):
        rng = np.random.default_rng(w + h)
        mbc = (w // 16) * (h // 16)
        ramp = np.add.outer(np.arange(h) // 4 * 7, np.arange(w) // 4 * 5) % 60
        planes = [torch.from_numpy(a.astype(np.uint8)).to(dev) for a in (
            ramp + 100 + rng.integers(0, 10, (h, w)),
            ramp[::2, ::2] + 90 + rng.integers(0, 4, (h // 2, w // 2)),
            rng.integers(90, 140, (h // 2, w // 2)))]
        sid = torch.as_tensor(rng.integers(0, 2, mbc), dtype=torch.int32,
                              device=dev)
        inner = torch.as_tensor(rng.random(mbc) < 0.5, device=dev)
        lf = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in
              ([0, 40, 0, 0], [0, 90, 0, 0], [0, 80, 0, 0], [0, 6, 0, 0],
               [0, 1, 0, 0])]
        pf = LF.filter_planes_plain(*planes, sid, inner, *lf)
        if mbc > 1 and max_abs_err(pf[:1], planes[:1]) == 0:
            raise AssertionError(f"{w}x{h}: the filter changed nothing")
        y = torch.from_numpy(synth_plane(rng, h, w, 0)).to(dev)
        pl = I.luma_wavefront_plain(y, 12, 15)
        uvs = [torch.stack([torch.from_numpy(synth_plane(rng, h // 2, w // 2,
                                                         t)).to(dev)
                            for t in (1, 2)])]
        if h > 2000:      # the luma plane as two chroma planes: 272 MB rows
            uvs.append(torch.stack([y[:, :w // 2].contiguous(),
                                    y[:, w // 2:].contiguous()]))
        pcs = [I.chroma_wavefront_plain(uv, 12, 15) for uv in uvs]
        for i in range(REPEATS):
            for name, k, p in [
                    ("loop_filter",
                     LF.filter_planes(*planes, sid, inner, *lf), pf),
                    ("luma_wavefront", I.luma_wavefront(y, 12, 15), pl)] + [
                    ("chroma_wavefront", I.chroma_wavefront(uv, 12, 15), pc)
                    for uv, pc in zip(uvs, pcs)]:
                err = max_abs_err(k, p)
                if err != 0:
                    raise AssertionError(f"{name} at {w}x{h}, launch "
                                         f"{i + 1}: differs from its plain "
                                         f"version by {err}")
        log(f"  {w}x{h} ({h // 16} MB rows): loop_filter, luma_wavefront and "
            f"chroma_wavefront bit-exact over {REPEATS} launches")


def _fullpel_counts(v0, Hl, Wl, row0=0, full_h=0):
    """(valid, invalid) candidate counts of one full-pel launch: the
    work its data needs (invalid candidates are only bounds-checked).
    A row shard's candidates are bounded by the frame's rows."""
    from vp8oclenc_tpu_torch.ops.inter import _block_origins
    cy, cx = _block_origins(Hl // 8, Wl // 8, v0.device)
    cy, Hl = cy + row0, full_h or Hl
    d = torch.arange(-2, 3, device=v0.device)
    valid = 0
    for wx, wy in ((v0[..., 0], v0[..., 1]), (0 * v0[..., 0], 0 * v0[..., 1])):
        okx = ((cx + wx)[..., None] + d >= 0) & ((cx + wx)[..., None] + d
                                                  <= Wl - 8)
        oky = ((cy + wy)[..., None] + d >= 0) & ((cy + wy)[..., None] + d
                                                  <= Hl - 8)
        valid += int((okx.sum(-1) * oky.sum(-1)).sum())
    return valid, v0.shape[0] * v0.shape[1] * 50 - valid


def _qpel_valid(fv, Hl, Wl, row0=0, full_h=0):
    """(in-frame qpel candidates of 25 per job, those of them with dy = 0,
    whose vertical pass is a copy) of one launch; row0, full_h as in
    `_fullpel_counts`."""
    from vp8oclenc_tpu_torch.ops.inter import _block_origins
    cy, cx = _block_origins(Hl // 8, Wl // 8, fv.device)
    cy, Hl = cy + row0, full_h or Hl
    d = torch.arange(-2, 3, device=fv.device)
    px = ((cx + fv[..., 0]) * 4)[..., None] + d
    py = ((cy + fv[..., 1]) * 4)[..., None] + d
    okx = ((px >= 0) & (px <= Wl * 4 - 32)).sum(-1)
    oky = (py >= 0) & (py <= Hl * 4 - 32)
    return int((okx * oky.sum(-1)).sum()), int((okx * oky[..., 2]).sum())


def _fullpel_work(c, r, v0, row0=0, full_h=0):
    """(bytes, operations, operations by the per-candidate count, in-frame
    candidates, candidates) of one full-pel launch on level c, references
    r, start vectors v0; row0, full_h as in `_fullpel_counts`."""
    valid, invalid = _fullpel_counts(v0, *c.shape, row0, full_h)
    nbytes = c.numel() + r.numel() + 2 * v0.numel() * 4
    ops_old = valid * OPS_COST8 + invalid * OPS_INVALID
    ops = valid * OPS_CAND_STAGED + invalid * OPS_INVALID \
        + v0.shape[0] * v0.shape[1] * 2 * OPS_WINDOW_COLUMNS \
        + v0.shape[1] * 32 * OPS_C4
    return nbytes, ops, ops_old, valid, valid + invalid


def _qpel_bound(c, r, fv, row0=0, full_h=0):
    """(bound ms, bound by, jobs, in-frame candidates) of one quarter-pel
    launch; row0, full_h as in `_fullpel_counts`."""
    jobs = fv.shape[0] * fv.shape[1]
    valid, copied = _qpel_valid(fv, *c.shape, row0, full_h)
    filtered = jobs * QPEL_HPASS_FILTERED + (valid - copied) * 64
    nbytes = c.numel() + r.numel() + fv.numel() * 4 + jobs * (8 + 4 + 64)
    ops = jobs * (QPEL_HPASS_COPIED + OPS_COST8 + 64) + valid * OPS_COST8 \
        + copied * 64 + filtered * OPS_SIXTAP_INT \
        + (jobs * 25 - valid) * OPS_INVALID
    return (*bound(nbytes, ops, filtered * OPS_SIXTAP_MAC8), jobs, valid)


def _search_small_shapes(dev):
    """Both search kernels where their staging and lane mappings have their
    edges: one block, a block column, block rows, widths that are no
    multiple of 4 (pyramid levels of a 176-wide frame: 11x9, 22x18; 10x8),
    and a tall plane; vectors point past every edge, full pel with and
    without the penalty."""
    from vp8oclenc_tpu_torch.ops import inter as IN
    shapes = ((16, 16), (8, 40), (56, 8), (10, 8), (11, 9), (22, 18),
              (64, 2176))
    for w, h in shapes:
        rng = np.random.default_rng(w * h)
        cur = torch.from_numpy(synth_plane(rng, h, w, 0)).to(dev)
        refs = torch.stack([torch.from_numpy(synth_plane(rng, h, w, t))
                            for t in (0, 1, 2)]).to(dev)
        refs[0] = cur.roll((1, -1), (0, 1))
        n = (h // 8) * (w // 8)
        for reach in (6, 12):
            v = rng.integers(-reach, reach + 1, (3, n, 2))
            v[:, 0], v[:, -1] = -reach, reach
            vec = torch.as_tensor(v, dtype=torch.int32, device=dev)
            cases = [("fullpel_search", pen,
                      [IN.fullpel_search(cur, refs, vec, pen)],
                      [IN.fullpel_search_plain(cur, refs, vec, pen)])
                     for pen in (False, True)]
            if reach == 6:
                cases.append(("qpel_search", None,
                              IN.qpel_search(cur, refs, vec),
                              IN.qpel_search_plain(cur, refs, vec)))
            for name, pen, k, p in cases:
                err = max_abs_err(k, p)
                if err != 0:
                    raise AssertionError(f"{name} at {w}x{h} (reach {reach}"
                                         f", penalty {pen}): kernel differs "
                                         f"from its plain version by {err}")
    log("  fullpel_search (vectors to +-6 and +-12, penalty off and on) and "
        "qpel_search at " + ", ".join(f"{w}x{h}" for w, h in shapes)
        + ": bit-exact")


def phase_search(dev):
    """Both search kernels against their plain versions on the levels of
    real 1920x1088 pyramids, bit-exact.  Content "moving": the panned
    canvas, searched level by level from the kernel's own vectors as the
    encoder does.  Content "edges": noise, searched from random start
    vectors with the corner blocks' pointing 12 pels past the frame, so
    windows, clamping and candidate validity all meet the edges.  Times
    and bounds are per inter frame: the 5 full-pel launches summed, and
    the qpel launch."""
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import inter as IN

    _search_small_shapes(dev)
    contents = {"moving": synth_moving(4, seed=3),
                "edges": synth_frames(4, seed=5)}
    rows = {}
    for ci, (label, frames) in enumerate(contents.items()):
        planes = [torch.from_numpy(pad_frame(f).y).to(dev) for f in frames]
        cur = IN.build_pyramid(planes[3])
        refs = [torch.stack(lv).contiguous() for lv in
                zip(*(IN.build_pyramid(p) for p in planes[:3]))]
        rng = np.random.default_rng(ci)
        fp = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0,
              "ops": 0, "ops_old": 0}
        vec = None
        for lvl, rate in ((4, 16), (3, 8), (2, 4), (1, 2), (0, 1)):
            c, r = cur[lvl], refs[lvl]
            Hl, Wl = c.shape
            nby, nbx = Hl // 8, Wl // 8
            if label == "edges":
                v = rng.integers(-12, 13, (3, nby * nbx, 2))
                v[:, 0], v[:, -1] = -12, 12
                v0 = torch.as_tensor(v, dtype=torch.int32, device=dev)
            else:
                v0 = IN.inherit_vectors(vec, 3, nby, nbx, rate, dev)
            pen = rate < 4
            k = IN.fullpel_search(c, r, v0, pen)
            p = IN.fullpel_search_plain(c, r, v0, pen)
            err = max_abs_err([k], [p])
            if err != 0:
                raise AssertionError(f"fullpel_search ({label}, level {lvl})"
                                     f": kernel differs from its plain "
                                     f"version by {err}")
            ms = cuda_ms(lambda: IN.fullpel_search(c, r, v0, pen), reps=10)
            pms = span_ms(lambda: IN.fullpel_search_plain(c, r, v0, pen))
            nbytes, ops, ops_old, valid, cands = _fullpel_work(c, r, v0)
            bms, by = bound(nbytes, ops)
            log(f"  fullpel_search {label} level {lvl} ({Wl}x{Hl}, "
                f"{v0.shape[1]} blocks x 3 refs, {valid} of "
                f"{cands} candidates in frame): bit-exact, kernel "
                f"{ms:.4f} ms, plain {pms:.1f} ms, bound {bms:.5f} ms ({by}; "
                f"{ops} operations, {ops_old} by the per-candidate count, "
                f"bound {bound(nbytes, ops_old)[0]:.5f} ms)")
            for key, val in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                             ("bytes", nbytes), ("ops", ops),
                             ("ops_old", ops_old)):
                fp[key] += val
            vec = (k * rate).reshape(3, nby, nbx, 2)
        c, r = cur[0], refs[0]
        fv = vec.reshape(3, -1, 2).contiguous()
        if label == "edges":
            v = rng.integers(-6, 7, tuple(fv.shape))
            v[:, 0], v[:, -1] = -6, 6
            fv = torch.as_tensor(v, dtype=torch.int32, device=dev)
        k = IN.qpel_search(c, r, fv)
        p = IN.qpel_search_plain(c, r, fv)
        err = max_abs_err(k, p)
        if err != 0:
            raise AssertionError(f"qpel_search ({label}): kernel differs from "
                                 f"its plain version by {err}")
        ms = cuda_ms(lambda: IN.qpel_search(c, r, fv), reps=10)
        pms = span_ms(lambda: IN.qpel_search_plain(c, r, fv))
        bms, by, jobs, valid = _qpel_bound(c, r, fv)
        moved = float((k[0] != 0).any(-1).float().mean())
        log(f"  qpel_search {label} ({jobs} jobs, {valid} of {jobs * 25} "
            f"qpel candidates in frame, {moved:.1%} nonzero vectors): "
            f"bit-exact, kernel {ms:.4f} ms, plain {pms:.1f} ms, bound "
            f"{bms:.5f} ms ({by})")
        fbms, fby = bound(fp["bytes"], fp["ops"])
        log(f"  fullpel_search {label}, 5 levels: kernel {fp['ms']:.4f} ms, "
            f"plain {fp['plain_ms']:.1f} ms, bound {fbms:.5f} ms ({fby}; by "
            f"the per-candidate count "
            f"{bound(fp['bytes'], fp['ops_old'])[0]:.5f} ms)")
        for name, vals in (("fullpel_search", (fp["ms"], fp["plain_ms"],
                                               fbms, fby)),
                           ("qpel_search", (ms, pms, bms, by))):
            row = rows.setdefault(name, {"max_abs_err": 0, "ms": [],
                                         "plain_ms": [], "bound_ms": [],
                                         "bound_by": vals[3]})
            row["ms"].append(vals[0])
            row["plain_ms"].append(vals[1])
            row["bound_ms"].append(vals[2])
    return rows


def phase_trial(dev):
    """The frozen-neighbour luma trial against its plain version at 8160
    MBs, bit-exact, at the three quantizer pairs the SSIM-target path uses
    (AQ, HQ, UQ of -qmin 50 -qmax 112).  Input "recon": sources from one
    synthetic frame, neighbours cut from another's keyframe-coded
    reconstruction.  Input "random": random sources and neighbours, with
    all-0 and all-255 MBs.  Then 1, 7 and 8161 MBs."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    f0, f1 = (pad_frame(f) for f in synth_frames(2, seed=11))
    Hp, Wp = f0.y.shape
    mbw, mbh = Wp // 16, Hp // 16
    mbc = mbw * mbh
    seg = prepare_segments(EncoderConfig(**SSIM_CFG), f0.y, False, False)
    recon = I.luma_wavefront(torch.from_numpy(f1.y).to(dev),
                             int(seg.y_dc_q[3]), int(seg.y_ac_q[3]))[0]
    rng = np.random.default_rng(13)
    rnd = lambda *shape: torch.from_numpy(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
    y_rand = rnd(mbc, 16, 16)
    y_rand[:64], y_rand[64:128] = 0, 255
    inputs = {
        "recon": (IR._plane_mb(torch.from_numpy(f0.y).to(dev), 16)
                  .contiguous(), *IR._frozen_luma_neighbors(recon, mbw, mbh)),
        "random": (y_rand, rnd(mbc, 21), rnd(mbc, 16))}
    nbytes = mbc * (256 + 21 + 16 + 256 * 2 + 16 + 256)
    bms, by = bound(nbytes, mbc * 16 * OPS_LUMA_BLOCK)
    row = {"max_abs_err": 0, "ms": [], "plain_ms": [], "bound_ms": [bms],
           "bound_by": by}
    for label, (y_mb, ftop, fleft) in inputs.items():
        for sid in (2, 1, 0):
            q = (int(seg.y_dc_q[sid]), int(seg.y_ac_q[sid]))
            k = IR.trial_luma(y_mb, ftop, fleft, *q)
            p = IR.trial_luma_plain(y_mb, ftop, fleft, *q)
            err = max_abs_err(k, p)
            if err != 0:
                raise AssertionError(f"trial_luma ({label}, q={q}): kernel "
                                     f"differs from its plain version by "
                                     f"{err}")
            ms = cuda_ms(lambda: IR.trial_luma(y_mb, ftop, fleft, *q),
                         reps=10)
            pms = span_ms(lambda: IR.trial_luma_plain(y_mb, ftop, fleft, *q))
            log(f"  trial_luma {label} segment {sid} q={q} ({mbc} MBs, "
                f"{len(torch.unique(k[1]))} modes in use): bit-exact, "
                f"kernel {ms:.4f} ms, plain {pms:.1f} ms, bound {bms:.5f} "
                f"ms ({by})")
            row["ms"].append(ms)
            row["plain_ms"].append(pms)
    # where the CTAs of 8 MBs have their edges: one MB, a CTA that is not
    # full, one MB past the 1080p frame's 8160
    for n in (1, 7, mbc + 1):
        y_mb, ftop, fleft = rnd(n, 16, 16), rnd(n, 21), rnd(n, 16)
        y_mb[:n // 3], y_mb[n // 3:2 * n // 3] = 0, 255
        for sid in (2, 1, 0):
            q = (int(seg.y_dc_q[sid]), int(seg.y_ac_q[sid]))
            err = max_abs_err(IR.trial_luma(y_mb, ftop, fleft, *q),
                              IR.trial_luma_plain(y_mb, ftop, fleft, *q))
            if err != 0:
                raise AssertionError(f"trial_luma ({n} MBs, q={q}): kernel "
                                     f"differs from its plain version by "
                                     f"{err}")
    log(f"  trial_luma at 1, 7 and {mbc + 1} MBs (a third all 0, a third "
        f"all 255), three quantizer pairs: bit-exact")
    return {"trial_luma": row}


def _ssim_inputs(mbw, mbh, seed, dev):
    """Source planes (u8) and a recon (int32) of mbw x mbh MBs: a textured
    source, the recon the source plus noise, and edge MBs at the start:
    identical source and recon (every L and CS division at a == d), flat
    against flat, all 0 against all 255, all 255 against all 255 and
    all 255 against all 0."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mbh, 16 * mbw
    src = [synth_plane(rng, h, w, seed)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    rec = [(p.astype(np.int32) + rng.integers(-12, 13, p.shape)).clip(0, 255)
           for p in src]
    for k, pair in enumerate([None, (100, 100), (0, 255), (255, 255),
                              (255, 0)][:mbw * mbh]):
        for s, r, n in zip(src, rec, (16, 8, 8)):
            cut = np.s_[(k // mbw) * n:(k // mbw + 1) * n,
                        (k % mbw) * n:(k % mbw + 1) * n]
            if pair is None:
                r[cut] = s[cut]
            else:
                s[cut], r[cut] = pair
    return ([torch.from_numpy(a).to(dev) for a in src],
            [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
             for a in rec])


def _ssim_forms(src, rec):
    """The operand forms the callers pass, as (label, wrapper, plain,
    args): whole planes (u8 source, int32 recon), the same with a u8
    recon, the trial path's per-MB patches (u8 luma source and recon,
    chroma source cut by `_plane_mb`, int32 chroma recon), and
    non-contiguous (mbh, mbw, n, n) views of the planes, all on the
    kernel's vector path; and on its strided path the planes one column
    into wider buffers (misaligned)."""
    from vp8oclenc_tpu_torch import ssim_fx as S
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    planes = [t for pair in zip(src, rec) for t in pair]
    u8 = [t.to(torch.uint8) for t in planes]
    patches = [IR._plane_mb(t, n).contiguous()
               for t, n in zip(u8[:2], (16, 16))]
    for s_, r_ in zip(src[1:], rec[1:]):
        patches += [IR._plane_mb(s_, 8), IR._plane_mb(r_, 8).contiguous()]
    views = [t.reshape(t.shape[0] // n, n, t.shape[1] // n, n).transpose(1, 2)
             for t, n in zip(planes, (16, 16, 8, 8, 8, 8))]
    misaligned = []
    for t in planes:
        wide = torch.zeros((t.shape[0], t.shape[1] + 1), dtype=t.dtype,
                           device=t.device)
        wide[:, 1:] = t
        misaligned.append(wide[:, 1:])
    return [("planes, int32 recon", S.mb_ssim_fx, S.mb_ssim_fx_plain, planes),
            ("misaligned planes", S.mb_ssim_fx, S.mb_ssim_fx_plain,
             misaligned),
            ("planes, u8 recon", S.mb_ssim_fx, S.mb_ssim_fx_plain, u8),
            ("patches", S.mb_ssim_fx_16x16, S.mb_ssim_fx_16x16_plain,
             patches),
            ("plane views", S.mb_ssim_fx_16x16, S.mb_ssim_fx_16x16_plain,
             views)]


def _ssim_same(what, src, rec):
    """Every form of `_ssim_forms` against its plain version, bit-exact."""
    for label, fn, plain, args in _ssim_forms(src, rec):
        err = max_abs_err([fn(*args)], [plain(*args)])
        if err:
            raise AssertionError(f"mb_ssim ({what}, {label}): kernel differs "
                                 f"from its plain version by {err}")


def _ssim_record(what, src, rec):
    """The kernel in its callers' form, the trials' per-MB patches (u8
    source and luma recon, int32 chroma recon), timed by the card's
    clock, the plain version by events, and the bound: each operand byte
    read once, 4 bytes an MB written.  Beside it the whole planes against
    an int32 recon (`planes_ms`)."""
    from vp8oclenc_tpu_torch import ssim_fx as S
    forms = {label: args for label, _, _, args in _ssim_forms(src, rec)}
    trial, planes = forms["patches"], forms["planes, int32 recon"]
    mbc = src[0].numel() // 256
    ms = cuda_ms(lambda: S.mb_ssim_fx_16x16(*trial), reps=20)
    planes_ms = cuda_ms(lambda: S.mb_ssim_fx(*planes), reps=20)
    _, pms = _plain(lambda: S.mb_ssim_fx_16x16_plain(*trial))
    nbytes = sum(t.numel() * t.element_size() for t in trial) + 4 * mbc
    bms, by = bound(nbytes, mbc * OPS_SSIM_MB,
                    mac8=mbc * 384 * OPS_SSIM_PIXEL)
    log(f"  mb_ssim ({what}, {mbc} MBs): bit-exact in every form, kernel "
        f"{ms:.4f} ms on the trials' patches ({nbytes / 1e6:.2f} MB; "
        f"planes with an int32 recon {planes_ms:.4f} ms), plain {pms:.1f} "
        f"ms, bound {bms:.5f} ms ({by}), share {bms / ms:.4f}")
    return {"shape": what, "form": "trial patches", "max_abs_err": 0,
            "ms": ms, "planes_ms": planes_ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "share": bms / ms}


def phase_ssim(dev):
    """The integer per-MB SSIM kernel against its plain version, bit-exact,
    in every operand form its callers pass (`_ssim_forms`) with edge MBs
    (`_ssim_inputs`): at 1920x1088 (8160 MBs), 3840x2160 (32400) and
    16384x128 (8192, 1024 MB columns), each timed with its bound, and at
    1, 7 and 8161 MBs in one row.  Returns (the 1080p row, the UHD record,
    the wide record)."""
    rows = {}
    for label, (mbw, mbh) in (("1920x1088", (W // 16, (H + 15) // 16)),
                              ("3840x2160", (UHD_W // 16, UHD_H // 16)),
                              (f"{WIDEST_W}x{WIDEST_H}",
                               (WIDEST_W // 16, WIDEST_H // 16))):
        src, rec = _ssim_inputs(mbw, mbh, mbw + mbh, dev)
        _ssim_same(label, src, rec)
        rows[label] = _ssim_record(label, src, rec)
    for n in (1, 7, W // 16 * ((H + 15) // 16) + 1):
        _ssim_same(f"{n} MBs in a row", *_ssim_inputs(n, 1, n, dev))
    log("  mb_ssim at 1, 7 and 8161 MBs in a row: bit-exact in every form")
    row = rows["1920x1088"]
    return ({"max_abs_err": 0, "ms": [row["ms"]],
             "plain_ms": [row["plain_ms"]], "bound_ms": [row["bound_ms"]],
             "bound_by": row["bound_by"], "form": row["form"],
             "planes_ms": row["planes_ms"]},
            rows["3840x2160"], rows[f"{WIDEST_W}x{WIDEST_H}"])


def _pass_inputs(mbw, mbh, seed, dev):
    """The transform pass's operands as the inter path hands them over:
    u8 source planes, the prediction planes (u8 luma, int32 chroma: the
    source plus noise, small residuals as after a search) with +-255
    residuals in the first MBs, mixed partitionings, and a cur_ssim
    around 0 for the masked passes (about half the MBs active)."""
    rng = np.random.default_rng(seed)
    H, W = 16 * mbh, 16 * mbw
    src = [synth_plane(rng, h, w, seed)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    pred = [(p.astype(np.int32) + rng.integers(-12, 13, p.shape)).clip(0, 255)
            for p in src]
    for s, p, n in zip(src, pred, (16, 8, 8)):
        s[:n, :n], p[:n, :n] = 255, 0
        s[n // 2:n, n // 2:n], p[n // 2:n, n // 2:n] = 0, 255
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    return ([t(a, np.uint8) for a in src],
            [t(pred[0], np.uint8), t(pred[1], np.int32),
             t(pred[2], np.int32)],
            t(rng.integers(0, 2, mbw * mbh), np.int32),
            t(rng.integers(-3, 3, mbw * mbh), np.int32))


def _pass_same(what, src, pred, parts, cur, quants):
    """The kernel's passes (the first, then masked ones at cur_ssim <= 0,
    `cur` injected into both states before each) against the plain
    version's, every state bit-exact, cur_ssim included; one launch a
    pass."""
    from vp8oclenc_tpu_torch.ops import inter as IN
    ks = ps = None
    for i, q in enumerate(quants):
        if i:
            ks[6].copy_(cur)
            ps[6].copy_(cur)
        before = IN.inter_pass.launches
        ks = IN.inter_pass(*src, *pred, parts, 3 - i, q, 0, ks)
        if IN.inter_pass.launches != before + 1:
            raise AssertionError("inter_pass did not count its launch")
        ps = IN.inter_pass_plain(*src, *pred, parts, 3 - i, q, 0, ps)
        err = max_abs_err(ks, ps)
        if err:
            raise AssertionError(f"inter_pass ({what}, pass {i}, q={q}): "
                                 f"kernel differs from its plain version "
                                 f"by {err}")


def _merge_inputs(src, pred):
    """The operands of the SSIM controller's trials as it passes them: the
    luma source patches, the luma trial's frozen neighbours, and the
    chroma source and frozen recon planes (u, v, ru, rv), the recon here
    the prediction planes as u8."""
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    mbh, mbw = src[0].shape[0] // 16, src[0].shape[1] // 16
    y_mb = IR._plane_mb(src[0], 16).contiguous()
    ftop, fleft = IR._frozen_luma_neighbors(pred[0], mbw, mbh)
    return y_mb, ftop, fleft, (src[1], src[2],
                               *(p.to(torch.uint8) for p in pred[1:]))


def _merge_chain(what, y_mb, lumas, planes, ghosts, cur, target, quants):
    """Three chained trials of the chroma trial with its score and merge,
    the kernel's merge state against the plain version's after each,
    bit-exact, one launch a trial.  Returns the MBs that won."""
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    mbc = y_mb.shape[0]
    ks, ps = IR.merge_state(mbc, y_mb.device), IR.merge_state(mbc, y_mb.device)
    kc = pc = cur
    for sid, luma, q in zip((2, 1, 0), lumas, quants):
        before = IR.trial_chroma_merge.launches
        IR.trial_chroma_merge(y_mb, luma, *planes, ghosts, kc, ks, sid,
                              q[4], q[5], target)
        if IR.trial_chroma_merge.launches != before + 1:
            raise AssertionError("trial_chroma_merge did not count its "
                                 "launch")
        IR.trial_chroma_merge_plain(y_mb, luma, *planes, ghosts, pc, ps, sid,
                                    q[4], q[5], target)
        kc, pc = ks["cur"], ps["cur"]
        err = max_abs_err([ks[k] for k in ks], [ps[k] for k in ks])
        if err:
            raise AssertionError(f"trial_chroma_merge ({what}, trial {sid}): "
                                 f"kernel differs from its plain version by "
                                 f"{err}")
    return int(ks["win"].sum())


def _merge_checks(label, y_mb, lumas, planes, cur, target, quants):
    """The chains of `_merge_chain` without and with a ghost row (the
    source planes' first rows, standing for a shard's above), with no MB
    active, and with every MB winning (each cur far below any score, every
    MB active).  Returns the winners of the first three."""
    mbc = y_mb.shape[0]
    won = _merge_chain(label, y_mb, lumas, planes, (None, None), cur, target,
                       quants)
    g_won = _merge_chain(label + ", ghost row", y_mb, lumas, planes,
                         tuple(p[0].contiguous() for p in planes[:2]), cur,
                         target, quants)
    none = _merge_chain(label + ", none active", y_mb, lumas, planes,
                        (None, None), cur, int(cur.min()) - 1, quants)
    every = _merge_chain(label + ", every MB winning", y_mb, lumas, planes,
                         (None, None), torch.full_like(cur, LOW_SCORE),
                         MAX_SCORE, quants)
    if none or every != mbc:
        raise AssertionError(f"trial_chroma_merge ({label}): {none} winners "
                             f"with none active, {every} of {mbc} with "
                             f"every MB winning")
    return won, g_won, none


def _merge_record(label, y_mb, lumas, planes, cur, target, quants):
    """`_merge_checks`, and the kernel timed by the card's clock in three
    forms of the first trial, each with the bound of the MBs that it finds
    active and that win (`_merge_bound`): from `cur` at `target` (cur_in
    left as it is, so that every launch does the same work), the plain
    version beside it by events; every MB active and none winning (each at
    the highest score there is); every MB active and winning (each far
    below any score)."""
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    mbc = y_mb.shape[0]
    won, g_won, _ = _merge_checks(label, y_mb, lumas, planes, cur, target,
                                  quants)
    if not 0 < won < mbc or not 0 < g_won < mbc:
        raise AssertionError(f"trial_chroma_merge ({label}): winners {won}, "
                             f"{g_won} with a ghost row; some (not all) "
                             f"expected")
    args = (y_mb, lumas[0], *planes, (None, None))
    qs = (2, quants[0][4], quants[0][5])
    forms = {}
    for form, c, t in (("from the pass", cur, target),
                       ("every MB active, none winning",
                        torch.full_like(cur, MAX_SCORE), MAX_SCORE),
                       ("every MB winning", torch.full_like(cur, LOW_SCORE),
                        MAX_SCORE)):
        st = IR.merge_state(mbc, y_mb.device)
        ms = cuda_ms(lambda: IR.trial_chroma_merge(*args, c, st, *qs, t),
                     reps=20)
        active, wins = int((c <= t).sum()), int(st["win"].sum())
        bms, by = _merge_bound(mbc, active, wins)
        forms[form] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                       "share": bms / ms, "active": active, "winners": wins}
    if forms["every MB active, none winning"]["winners"] \
            or forms["every MB winning"]["winners"] != mbc:
        raise AssertionError(f"trial_chroma_merge ({label}): the timed "
                             f"forms' winners are not none and all")
    _, pms = _plain(lambda: IR.trial_chroma_merge_plain(
        *args, cur, IR.merge_state(mbc, y_mb.device), *qs, target))
    log(f"  trial_chroma_merge ({label}, {mbc} MBs): bit-exact over 3 "
        f"chained trials with and without a ghost row, with none active and "
        f"with every MB winning ({won} and {g_won} MBs won from the pass); "
        f"plain {pms:.1f} ms; the first trial timed:")
    for form, f in forms.items():
        log(f"    {form}: {f['active']} active, {f['winners']} winners, "
            f"kernel {f['ms']:.4f} ms, bound {f['bound_ms']:.5f} ms "
            f"({f['bound_by']}), share {f['share']:.4f}")
    first = forms.pop("from the pass")
    return {"shape": label, "max_abs_err": 0, "plain_ms": pms, **first,
            "all_active_no_winner": forms["every MB active, none winning"],
            "all_winning": forms["every MB winning"]}


def _merge_bound(mbc, active, wins):
    """(bound ms, by) of one chroma trial with its score and merge: each
    active MB reads its luma source and trial recon, chroma source and the
    row above and column left of it in the recon (672 bytes), every MB
    reads and writes its cur (8), and a winner reads the luma trial's
    levels and modes and writes its trial to the best buffers (1701).  The
    score's sums are 8-bit multiply-adds (`dp4a`)."""
    return bound(active * 672 + mbc * 8 + wins * 1701,
                 active * (8 * (OPS_TRANSFORM_BLOCK + OPS_TM_BLOCK)
                           + OPS_SSIM_MB),
                 mac8=active * 384 * OPS_SSIM_PIXEL)


def phase_transform(dev):
    """The transform pass kernel with its SSIM (csrc/transform.cu
    inter_pass_kernel) and the chroma trial kernel with its score and
    merge (trial_chroma_merge_kernel) against their plain versions,
    bit-exact: at 1920x1088 (8160 MBs), 3840x2160 (32400) and 16384x128
    (8192, 1024 MB columns).  The pass four times at the segment
    quantizers of -qmin 50 -qmax 112 (LQ first, then AQ, HQ, UQ over about
    half the MBs) and twice at the extremes (4, 4, 8, 8, 4, 4) and (157,
    284, 314, 440, 132, 284); the trial at the three SSIM quantizer pairs,
    chained, from the first pass's scores with the median as the target
    (about half the MBs active), with and without a ghost row, with no
    MB active and with every MB winning, there and at 1, 7 and 8161 MBs in
    one row.  Each timed by the card's clock (the first pass, all MBs;
    the first trial in `_merge_record`'s three forms) with its bound.
    Returns ({kernel: the 1080p row}, {kernel: UHD record}, {kernel: wide
    record})."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    rows, q1080 = {}, None
    for label, (mbw, mbh) in (("1920x1088", (W // 16, (H + 15) // 16)),
                              ("3840x2160", (UHD_W // 16, UHD_H // 16)),
                              (f"{WIDEST_W}x{WIDEST_H}",
                               (WIDEST_W // 16, WIDEST_H // 16))):
        mbc = mbw * mbh
        src, pred, parts, cur = _pass_inputs(mbw, mbh, mbw + mbh, dev)
        seg = prepare_segments(EncoderConfig(**SSIM_CFG),
                               src[0].cpu().numpy(), False, False)
        quants = [[int(a[s]) for a in (seg.y_dc_q, seg.y_ac_q, seg.y2_dc_q,
                                       seg.y2_ac_q, seg.uv_dc_q,
                                       seg.uv_ac_q)] for s in (3, 2, 1, 0)]
        _pass_same(label, src, pred, parts, cur, quants)
        _pass_same(label, src, pred, parts, cur,
                   [(4, 4, 8, 8, 4, 4), (157, 284, 314, 440, 132, 284)])
        u8_pred = [pred[0]] + [p.to(torch.uint8) for p in pred[1:]]
        _pass_same(label + ", u8 chroma prediction", src, u8_pred, parts,
                   cur, quants[:2])
        args = (*src, *pred, parts, 3, quants[0])
        ms = cuda_ms(lambda: IN.inter_pass(*args), reps=20)
        out, pms = _plain(lambda: IN.inter_pass_plain(*args))
        # the first pass: cur_ssim written, not read
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*src, *pred, parts, *out))
        bms, by = bound(nbytes, mbc * (24 * OPS_TRANSFORM_BLOCK + OPS_Y2
                                       + OPS_SSIM_MB),
                        mac8=mbc * 384 * OPS_SSIM_PIXEL)
        log(f"  inter_pass ({label}, {mbc} MBs): bit-exact over 4 + 2 + 2 "
            f"passes, kernel {ms:.4f} ms, plain {pms:.1f} ms, bound "
            f"{bms:.5f} ms ({by}), share {bms / ms:.4f}")
        rec = {"inter_pass": {"shape": label, "max_abs_err": 0, "ms": ms,
                              "plain_ms": pms, "bound_ms": bms,
                              "bound_by": by, "share": bms / ms}}

        y_mb, ftop, fleft, planes = _merge_inputs(src, pred)
        lumas = [IR.trial_luma(y_mb, ftop, fleft, q[0], q[1])
                 for q in quants[1:]]
        cur = out[6]
        rec["trial_chroma_merge"] = _merge_record(
            label, y_mb, lumas, planes, cur, int(cur.float().median()),
            quants[1:])
        rows[label] = rec
        q1080 = q1080 or quants
    # the trial at the edges of its shapes, at 1080p's quantizers
    for n in (1, 7, W // 16 * ((H + 15) // 16) + 1):
        src, pred, parts, _ = _pass_inputs(n, 1, n, dev)
        cur = IN.inter_pass(*src, *pred, parts, 3, q1080[0])[6]
        y_mb, ftop, fleft, planes = _merge_inputs(src, pred)
        lumas = [IR.trial_luma(y_mb, ftop, fleft, q[0], q[1])
                 for q in q1080[1:]]
        _merge_checks(f"{n} MBs in a row", y_mb, lumas, planes, cur,
                      int(cur.float().median()), q1080[1:])
    log("  trial_chroma_merge at 1, 7 and 8161 MBs in a row: bit-exact over "
        "3 chained trials with and without a ghost row, with none active "
        "and with every MB winning")
    first = rows["1920x1088"]
    return ({name: {"max_abs_err": 0, "ms": [r["ms"]],
                    "plain_ms": [r["plain_ms"]], "bound_ms": [r["bound_ms"]],
                    "bound_by": r["bound_by"]} for name, r in first.items()},
            rows["3840x2160"], rows[f"{WIDEST_W}x{WIDEST_H}"])


def phase_end_to_end(dev):
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

    frames = synth_frames(N_FRAMES, seed=1)
    cfg = dict(qi_min=10, qi_max=40, gop_size=1)
    warm = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    list(warm.encode_frames(frames[:1]))          # first-use costs
    warm.close()
    torch.cuda.synchronize()

    enc = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    for c in (I.luma_wavefront, I.chroma_wavefront, LF.filter_planes,
              IN.fullpel_search, IN.qpel_search):
        c.launches = 0
    stamps, out = [], []
    t0 = time.monotonic()
    for payload in enc.encode_frames(frames):
        out.append(payload)
        stamps.append(time.monotonic())
    dt = time.monotonic() - t0
    launches = {"luma_wavefront": I.luma_wavefront.launches,
                "chroma_wavefront": I.chroma_wavefront.launches,
                "loop_filter": LF.filter_planes.launches}
    enc.close()
    if len(out) != N_FRAMES or min(len(p) for p in out) == 0:
        raise AssertionError("end-to-end encode produced empty frames")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log(f"  {N_FRAMES} frames {W}x{H} gop 1 in {dt:.3f} s: "
        f"{N_FRAMES / dt:.3f} fps end to end, median frame interval "
        f"{statistics.median(gaps):.3f} ms, {sum(map(len, out))} bytes")
    log(f"  launches on the main path: {json.dumps(launches)}")

    # device time of one keyframe chain (H2D excluded: frame pre-uploaded)
    probe = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    p = pad_frame(frames[0])
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    seg = prepare_segments(probe.cfg, p.y, True, True)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    key_ms = [span_ms(lambda: probe.backend.encode_intra_frame(
        p.y, p.u, p.v, seg, yuv_dev=yuv)) for _ in range(5)]
    probe.close()
    log(f"  keyframe device chain (intra + filter + D2H), median of 5: "
        f"{statistics.median(key_ms):.3f} ms")

    # where a frame's time goes on the host, frame by frame without overlap
    from vp8oclenc_tpu_torch.pipeline.encoder import _own_padded
    seq = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    split = {"pad_upload_dispatch": [], "wait_device_d2h": [],
             "entropy_and_headers": []}
    for f in frames[:4]:
        ta = time.perf_counter()
        fd, seg = seq._frame_pixels(_own_padded(f))
        tb = time.perf_counter()
        seq.backend.finalize_framedata(fd, seg)
        tc = time.perf_counter()
        seq._finish_frame(fd, seg)
        td = time.perf_counter()
        for k, v in zip(split, (tb - ta, tc - tb, td - tc)):
            split[k].append(v * 1e3)
    seq.close()
    log("  sequential host split per frame, median of 4 (ms): " + json.dumps(
        {k: round(statistics.median(v), 3) for k, v in split.items()}))

    _same_as_cpu("gop-1", cfg, frames[:N_CPU_FRAMES], out)
    return launches


def phase_default_gop(dev):
    """The default encode: gop_size=150, altref_range=5, SSIM control off,
    10 frames of the panned canvas (1 keyframe, then inter frames)."""
    from vp8oclenc_tpu_torch import ssim_fx as S
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder, _own_padded
    from vp8oclenc_tpu_torch.tables import GOLDEN, LAST

    frames = synth_moving(N_FRAMES, seed=1)
    cfg = dict(qi_min=10, qi_max=40, gop_size=150, altref_range=5)
    warm = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    list(warm.encode_frames(frames[:2]))          # first-use costs
    warm.close()
    torch.cuda.synchronize()

    counters = {"luma_wavefront": I.luma_wavefront,
                "chroma_wavefront": I.chroma_wavefront,
                "loop_filter": LF.filter_planes,
                "fullpel_search": IN.fullpel_search,
                "qpel_search": IN.qpel_search,
                "inter_pass": IN.inter_pass}
    enc = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    for c in (*counters.values(), S.mb_ssim_cuda):
        c.launches = 0
    stamps, out = [], []
    t0 = time.monotonic()
    for payload in enc.encode_frames(frames):
        out.append(payload)
        stamps.append(time.monotonic())
    dt = time.monotonic() - t0
    launches = {name: c.launches for name, c in counters.items()}
    enc.close()
    if len(out) != N_FRAMES or min(len(p) for p in out) == 0:
        raise AssertionError("default-GOP encode produced empty frames")
    n_inter = sum(p[0] & 1 for p in out)          # frame tag: 1 = inter
    if n_inter < 8:
        raise AssertionError(f"only {n_inter} of {N_FRAMES} frames were "
                             f"inter frames")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"default-GOP path")
    if launches["inter_pass"] != n_inter:     # one segment pass a frame
        raise AssertionError(f"inter_pass was launched "
                             f"{launches['inter_pass']} times for {n_inter} "
                             f"inter frames, not once each")
    if S.mb_ssim_cuda.launches:               # the pass scores its MBs
        raise AssertionError(f"mb_ssim was launched "
                             f"{S.mb_ssim_cuda.launches} times with SSIM "
                             f"control off")
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log(f"  {N_FRAMES} frames {W}x{H} gop 150 ({n_inter} inter) in "
        f"{dt:.3f} s: {N_FRAMES / dt:.3f} fps end to end, median frame "
        f"interval {statistics.median(gaps):.3f} ms, "
        f"{sum(map(len, out))} bytes (keyframe {len(out[0])}, inter "
        f"median {statistics.median(len(p) for p in out[1:])})")
    log(f"  launches on the default-GOP path: {json.dumps(launches)}")

    # device time of one inter chain (H2D excluded: frame pre-uploaded)
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    probe = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    fd, seg = probe._frame_pixels(_own_padded(frames[0]))
    probe.backend.finalize_framedata(fd, seg)
    p = _own_padded(frames[1])
    seg = prepare_segments(probe.cfg, p.y, False, False)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    inter_ms = [span_ms(lambda: probe.backend.encode_inter_frame(
        probe, p.y, p.u, p.v, seg, False, False, yuv_dev=yuv))
        for _ in range(5)]
    probe.close()
    log(f"  inter device chain (search kernels, body, filter, next LAST "
        f"pyramid, D2H), median of 5: {statistics.median(inter_ms):.3f} ms")

    # the host's share, frame by frame without overlap; the frames' data
    split = {"pad_upload_dispatch": [], "wait_device_d2h": [],
             "entropy_and_headers": []}
    refs, mv_abs = np.zeros(3, np.int64), []
    seq = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    for i, f in enumerate(frames):
        ta = time.perf_counter()
        # an inter frame's dispatch must never wait for the card
        torch.cuda.set_sync_debug_mode("error" if i else "default")
        fd, seg = seq._frame_pixels(_own_padded(f))
        torch.cuda.set_sync_debug_mode("default")
        tb = time.perf_counter()
        seq.backend.finalize_framedata(fd, seg)
        tc = time.perf_counter()
        seq._finish_frame(fd, seg)
        td = time.perf_counter()
        if not fd.is_key:
            for k, v in zip(split, (tb - ta, tc - tb, td - tc)):
                split[k].append(v * 1e3)
            refs += np.bincount(fd.ref_frame, minlength=3)
            mv_abs.append(np.abs(fd.mvs.astype(np.int64)).sum(-1).mean())
    seq.close()
    log("  sequential host split per inter frame, median of "
        f"{len(split['entropy_and_headers'])} (ms): " + json.dumps(
            {k: round(statistics.median(v), 3) for k, v in split.items()}))
    share = refs / refs.sum()
    log(f"  reference shares over inter MBs: LAST {share[LAST]:.4f}, "
        f"GOLDEN {share[GOLDEN]:.4f}, ALTREF {share[2]:.4f}; mean "
        f"|mv_x|+|mv_y| {float(np.mean(mv_abs)):.3f} qpel")
    if not mv_abs or max(mv_abs) == 0:
        raise AssertionError("no MB carried a nonzero vector")
    if refs[GOLDEN] + refs[2] == 0:
        raise AssertionError("neither GOLDEN nor ALTREF was ever selected")

    _same_as_cpu("default-GOP", cfg, frames[:N_CPU_GOP_FRAMES], out)
    return launches


def _counters():
    from vp8oclenc_tpu_torch import ssim_fx as S
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    return {"luma_wavefront": I.luma_wavefront,
            "chroma_wavefront": I.chroma_wavefront,
            "loop_filter": LF.filter_planes,
            "fullpel_search": IN.fullpel_search,
            "qpel_search": IN.qpel_search,
            "trial_luma": IR.trial_luma,
            "trial_chroma_merge": IR.trial_chroma_merge,
            "inter_pass": IN.inter_pass,
            "mb_ssim": S.mb_ssim_cuda}


def _check_launched(launches, where):
    """Every kernel of `_counters` launched on the path, but the SSIM
    kernel, which no encoder path launches (the passes and the trials
    score their MBs), never."""
    for name, n in launches.items():
        if name == "mb_ssim" and n:
            raise AssertionError(f"mb_ssim was launched {n} times on {where}")
        if name != "mb_ssim" and n <= 0:
            raise AssertionError(f"{name} was never launched on {where}")


def _same_as_cpu(what, cfg, frames, out, depth=3, w=W, h=H):
    """Encode `frames` again with the plain versions on the CPU and hold
    the card's bytes against them."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
    t1 = time.monotonic()
    cpu = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    ref = list(cpu.encode_frames(frames, depth=depth))
    cpu.close()
    log(f"  plain CPU encode of {len(frames)} frames: "
        f"{time.monotonic() - t1:.1f} s")
    for i, (a, b) in enumerate(zip(out, ref)):
        if a != b:
            raise AssertionError(f"{what} frame {i}: card bytes differ from "
                                 f"the plain CPU bytes")
    log(f"  first {len(ref)} frames byte-identical to the plain CPU stream")
    return cpu.stats


def phase_ssim_target(dev):
    """The -SSIM-target encode: segment loop, batched intra replacement
    with the luma trial kernel, speculative redo check (which must not
    fire on this content)."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder, _own_padded
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    from vp8oclenc_tpu_torch.ssim_fx import Q3
    from vp8oclenc_tpu_torch.tables import ARE4X4

    frames = synth_replacement(N_FRAMES, seed=1)
    warm = Encoder(EncoderConfig(**SSIM_CFG), W, H, device=dev)
    list(warm.encode_frames(frames[:2]))          # first-use costs
    warm.close()
    torch.cuda.synchronize()

    counters = _counters()
    enc = Encoder(EncoderConfig(**SSIM_CFG), W, H, device=dev)
    mbc = enc.mbc
    for c in counters.values():
        c.launches = 0
    stamps, out, replaced, avg = [], [], [], []
    t0 = time.monotonic()
    for payload in enc.encode_frames(frames):
        out.append(payload)
        stamps.append(time.monotonic())
        fs = enc.last_frame_stats
        replaced.append(fs["replaced"])
        if not fs["is_key"]:
            avg.append(fs["ssim_sum_fx"] / mbc / Q3)
    dt = time.monotonic() - t0
    launches = {name: c.launches for name, c in counters.items()}
    enc.close()
    if len(out) != N_FRAMES or min(len(p) for p in out) == 0:
        raise AssertionError("SSIM-target encode produced empty frames")
    n_inter = sum(p[0] & 1 for p in out)          # frame tag: 1 = inter
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log(f"  {N_FRAMES} frames {W}x{H} SSIM target 0.98 ({n_inter} inter) in "
        f"{dt:.3f} s: {N_FRAMES / dt:.3f} fps end to end, median frame "
        f"interval {statistics.median(gaps):.3f} ms, "
        f"{sum(map(len, out))} bytes (keyframe {len(out[0])}, inter "
        f"median {statistics.median(len(p) for p in out[1:])})")
    log(f"  launches on the SSIM-target path: {json.dumps(launches)}")
    log(f"  MBs replaced per frame: {replaced} of {mbc} (redo above "
        f"{mbc // 6}); mean SSIM per inter frame "
        f"{[round(a, 4) for a in avg]}")
    if n_inter < 8:
        raise AssertionError(f"only {n_inter} of {N_FRAMES} frames were "
                             f"inter frames")
    st = enc.stats
    if st.scene_changes_by_ssim + st.scene_changes_by_replaced \
            + st.scene_changes_by_color:
        raise AssertionError(f"a frame was done again as a key: {st}")
    # four segment passes and three trials an inter frame, each scoring
    # its MBs
    for name, each in (("trial_luma", 3), ("trial_chroma_merge", 3),
                       ("inter_pass", 4)):
        if launches[name] != each * n_inter:
            raise AssertionError(f"{name} was launched {launches[name]} "
                                 f"times for {n_inter} inter frames, not "
                                 f"{each} each")
    _check_launched(launches, "the SSIM-target path")
    if max(replaced) <= 0 or max(replaced) > mbc // 6:
        raise AssertionError(f"replaced MBs per frame {replaced}: none, or "
                             f"above a sixth of {mbc}")

    # device time of one SSIM-on inter chain (frame pre-uploaded)
    probe = Encoder(EncoderConfig(**SSIM_CFG), W, H, device=dev)
    fd, seg = probe._frame_pixels(_own_padded(frames[0]))
    probe._finalize_fd(fd, seg)
    p = _own_padded(frames[1])
    seg = prepare_segments(probe.cfg, p.y, False, False)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    inter_ms = [span_ms(lambda: probe.backend.encode_inter_frame(
        probe, p.y, p.u, p.v, seg, False, False, yuv_dev=yuv))
        for _ in range(5)]
    probe.close()
    log(f"  SSIM-on inter device chain (search, 4 segment passes, 3 trials, "
        f"merge, filter, next LAST pyramid, D2H), median of 5: "
        f"{statistics.median(inter_ms):.3f} ms")

    # the host's share, frame by frame without overlap; the frames' data
    split = {"pad_upload_dispatch": [], "wait_device_d2h": [],
             "entropy_and_headers": []}
    seg_hist = np.zeros(4, np.int64)
    seq = Encoder(EncoderConfig(**SSIM_CFG), W, H, device=dev)
    for i, f in enumerate(frames[:6]):
        ta = time.perf_counter()
        # an inter frame's dispatch must never wait for the card
        torch.cuda.set_sync_debug_mode("error" if i else "default")
        fd, seg = seq._frame_pixels(_own_padded(f))
        torch.cuda.set_sync_debug_mode("default")
        tb = time.perf_counter()
        if seq._finalize_fd(fd, seg):
            raise AssertionError(f"frame {i} asked for a redo")
        tc = time.perf_counter()
        seq._finish_frame(fd, seg)
        td = time.perf_counter()
        if not fd.is_key:
            for k, v in zip(split, (tb - ta, tc - tb, td - tc)):
                split[k].append(v * 1e3)
            seg_hist += np.bincount(fd.segment_ids, minlength=4)
            if fd.replaced != replaced[i]:
                raise AssertionError(f"frame {i}: {fd.replaced} MBs replaced "
                                     f"sequentially, {replaced[i]} pipelined")
            if int((fd.parts == ARE4X4).sum()) != fd.replaced \
                    or (fd.modes[fd.parts != ARE4X4] != 0).any():
                raise AssertionError(f"frame {i}: B_PRED MBs and modes do "
                                     f"not match the replaced count")
    seq.close()
    log("  sequential host split per SSIM-on inter frame, median of "
        f"{len(split['entropy_and_headers'])} (ms): " + json.dumps(
            {k: round(statistics.median(v), 3) for k, v in split.items()}))
    log(f"  MBs per segment over those frames (UQ, HQ, AQ, LQ): "
        f"{seg_hist.tolist()}")
    if (seg_hist > 0).sum() < 2:
        raise AssertionError("only one segment id among the coded MBs")

    _same_as_cpu("SSIM-target", SSIM_CFG, frames[:N_CPU_GOP_FRAMES], out)
    return launches


def phase_redo(dev):
    """Redo-as-key on the card with successors in flight."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

    frames = synth_redo(N_REDO_FRAMES, REDO_AT, seed=2)
    counters = _counters()
    before = {name: c.launches for name, c in counters.items()}
    enc = Encoder(EncoderConfig(**REDO_CFG), W, H, device=dev)
    t0 = time.monotonic()
    out = list(enc.encode_frames(frames, depth=3))
    dt = time.monotonic() - t0
    enc.close()
    st = enc.stats
    tags = [p[0] & 1 for p in out]
    log(f"  {N_REDO_FRAMES} frames in {dt:.3f} s, frame tags (1 = inter) "
        f"{tags}; redone for low SSIM {st.scene_changes_by_ssim}, for "
        f"replaced MBs {st.scene_changes_by_replaced}; launches "
        + json.dumps({n: c.launches - before[n]
                      for n, c in counters.items()}))
    if st.scene_changes_by_ssim + st.scene_changes_by_replaced < 1:
        raise AssertionError("no frame was done again as a key")
    if st.scene_changes_by_color:
        raise AssertionError("the scene-change detector fired")
    if tags[REDO_AT] != 0 or tags[REDO_AT - 1] != 1:
        raise AssertionError(f"frame tags {tags}: frame {REDO_AT} should be "
                             f"a key after an inter frame")
    cpu_stats = _same_as_cpu("redo", REDO_CFG, frames, out)
    if cpu_stats != st:
        raise AssertionError(f"counters differ: card {st}, CPU {cpu_stats}")

def _strip(plane, row0, rows, pad):
    """Rows row0 - pad .. row0 + rows + pad - 1 of (..., H, W) planes,
    clamped into them: a row shard's reference strip."""
    idx = torch.arange(row0 - pad, row0 + rows + pad,
                       device=plane.device).clamp(0, plane.shape[-2] - 1)
    return plane[..., idx, :].contiguous()


def phase_shard_search(dev):
    """Both search kernels in row-shard mode (a strip of the reference,
    the shard's first row row0, the frame's height full_h) against their
    plain versions on strips of real 1920x1088 pyramid levels 1 and 0,
    bit-exact: 2 and 4 shards, the top, an interior and the bottom one,
    from random vectors reaching to the halo's edge (62 pels at level 0,
    31 at level 1, past the frame at its edges).  Times and bounds: the
    top shard of a 2-tile 1080p frame (1920x544 own rows, 80 halo rows
    each side), searched from the vectors the whole-frame levels 4..2
    give, as a tile rank does: full pel at levels 1 and 0 summed, and
    quarter pel."""
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import inter as IN

    frames = synth_moving(4, seed=3)
    planes = [torch.from_numpy(pad_frame(f).y).to(dev) for f in frames]
    cur = IN.build_pyramid(planes[3])
    refs = [torch.stack(lv).contiguous() for lv in
            zip(*(IN.build_pyramid(p) for p in planes[:3]))]
    rng = np.random.default_rng(11)
    n_cases = 0
    for T in (2, 4):
        for t in sorted({0, 1, T - 1}):
            for lvl in (1, 0):
                hl, wl = cur[lvl].shape
                rows, pad = hl // T, IN.PAD_Y_FULL >> lvl
                row0 = t * rows
                strip = _strip(refs[lvl], row0, rows, pad)
                c = cur[lvl][row0:row0 + rows].contiguous()
                n = (rows // 8) * (wl // 8)
                reach = 62 >> lvl
                v = rng.integers(-reach, reach + 1, (3, n, 2))
                v[:, 0], v[:, -1] = -reach, reach
                v0 = torch.as_tensor(v, dtype=torch.int32, device=dev)
                args = (pad, row0, hl)
                cases = [("fullpel_search",
                          [IN.fullpel_search(c, strip, v0, True, *args)],
                          [IN.fullpel_search_plain(c, strip, v0, True,
                                                   *args)])]
                if lvl == 0:
                    fv = torch.as_tensor(v.clip(-60, 60), dtype=torch.int32,
                                         device=dev)
                    cases.append(("qpel_search",
                                  IN.qpel_search(c, strip, fv, *args),
                                  IN.qpel_search_plain(c, strip, fv,
                                                       *args)))
                for name, k, p in cases:
                    err = max_abs_err(k, p)
                    if err != 0:
                        raise AssertionError(
                            f"{name} shard {t} of {T}, level {lvl}: kernel "
                            f"differs from its plain version by {err}")
                    n_cases += 1
    log(f"  {n_cases} shard cases (2 and 4 shards; top, interior, bottom; "
        f"levels 1 and 0; vectors to the halo's edge): bit-exact")

    # a 2-tile rank's search: whole-frame levels 4..2, then its shard
    T, t = 2, 0
    vec = None
    for lvl, rate in ((4, 16), (3, 8), (2, 4)):
        vec = IN.search_level(cur[lvl], refs[lvl], vec, rate, rate < 4)
    rows_out = {}
    fp = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0, "err": 0}
    for lvl, rate in ((1, 2), (0, 1)):
        hl, wl = cur[lvl].shape
        rows, pad = hl // T, IN.PAD_Y_FULL >> lvl
        row0 = t * rows
        strip = _strip(refs[lvl], row0, rows, pad)
        c = cur[lvl][row0:row0 + rows].contiguous()
        v0 = IN.inherit_vectors(vec, 3, rows // 8, wl // 8, rate, dev, row0)
        args = (pad, row0, hl)
        k = IN.fullpel_search(c, strip, v0, True, *args)
        fp["err"] = max(fp["err"], max_abs_err(
            [k], [IN.fullpel_search_plain(c, strip, v0, True, *args)]))
        fp["ms"] += cuda_ms(lambda: IN.fullpel_search(c, strip, v0, True,
                                                      *args), reps=10)
        fp["plain_ms"] += span_ms(lambda: IN.fullpel_search_plain(
            c, strip, v0, True, *args))
        nbytes, ops, *_ = _fullpel_work(c, strip, v0, row0, hl)
        fp["bytes"] += nbytes
        fp["ops"] += ops
        vec = (k * rate).reshape(3, rows // 8, wl // 8, 2)
    bms, by = bound(fp["bytes"], fp["ops"])
    shape = f"{W}x{rows} rows of {hl}, {IN.PAD_Y_FULL} halo rows each side"
    log(f"  fullpel_search, a 2-tile shard ({shape}), levels 1 and 0: "
        f"bit-exact, kernel {fp['ms']:.4f} ms, plain {fp['plain_ms']:.1f} "
        f"ms, bound {bms:.5f} ms ({by})")
    rows_out["fullpel_search"] = {
        "shape": shape + "; levels 1 and 0", "max_abs_err": fp["err"],
        "ms": fp["ms"], "plain_ms": fp["plain_ms"], "bound_ms": bms,
        "bound_by": by}
    fv = vec.reshape(3, -1, 2).contiguous()
    args = (IN.PAD_Y_FULL, row0, hl)
    k = IN.qpel_search(c, strip, fv, *args)
    err = max_abs_err(k, IN.qpel_search_plain(c, strip, fv, *args))
    ms = cuda_ms(lambda: IN.qpel_search(c, strip, fv, *args), reps=10)
    pms = span_ms(lambda: IN.qpel_search_plain(c, strip, fv, *args))
    bms, by, jobs, _ = _qpel_bound(c, strip, fv, row0, hl)
    log(f"  qpel_search, a 2-tile shard ({shape}, {jobs} jobs): max error "
        f"{err}, kernel {ms:.4f} ms, plain {pms:.1f} ms, bound {bms:.5f} ms "
        f"({by})")
    rows_out["qpel_search"] = {
        "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": pms,
        "bound_ms": bms, "bound_by": by}
    if fp["err"] or err:
        raise AssertionError("a shard search differs from its plain version")
    return rows_out


def phase_band_filter(dev):
    """The loop-filter kernel in band mode: 1920x1088 planes cut into 2
    and 4 bands, filtered one after the other with the 4 lines above each
    band handed in and the 3 it changes handed back (the tile ranks'
    order), must equal the whole-plane kernel, and every band launch its
    plain version (planes and write-back lines); four segments with their
    own limits, a mixed inner-edge mask.  Time and bound: the lower band
    of 2 (1920x544 and its halo)."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    f = pad_frame(synth_moving(1, seed=9)[0])
    planes = [torch.from_numpy(p).to(dev) for p in (f.y, f.u, f.v)]
    Hp, Wp = f.y.shape
    mbc = (Hp // 16) * (Wp // 16)
    seg = prepare_segments(EncoderConfig(qi_min=30, qi_max=90), f.y, False,
                           False)
    lf = [torch.as_tensor(np.asarray(a, np.int32), device=dev) for a in
          (seg.loop_filter_level, seg.mbedge_limit, seg.sub_bedge_limit,
           seg.interior_limit, seg.hev_threshold)]
    rng = np.random.default_rng(5)
    sid = torch.as_tensor(rng.integers(0, 4, mbc), dtype=torch.int32,
                          device=dev)
    inner = torch.as_tensor(rng.random(mbc) < 0.5, device=dev)
    whole = LF.filter_planes(*planes, sid, inner, *lf)
    row = {}
    for T in (2, 4):
        n = mbc // T
        bands, halo, err = [], None, 0
        for t in range(T):
            cut = [p[t * (p.shape[0] // T):(t + 1) * (p.shape[0] // T)]
                   .contiguous() for p in planes]
            args = (*cut, halo, sid[t * n:(t + 1) * n].contiguous(),
                    inner[t * n:(t + 1) * n].contiguous(), *lf)
            out, wb = LF.filter_band(*args)
            pout, pwb = LF.filter_band_plain(*args)
            err = max(err, max_abs_err(out, pout))
            if wb is not None:
                err = max(err, max_abs_err(wb, pwb))
                for k in range(3):
                    bands[-1][k][-3:] = wb[k]
            if T == 2 and t == 1:
                row = {"ms": cuda_ms(lambda: LF.filter_band(*args), reps=10),
                       "plain_ms": span_ms(
                           lambda: LF.filter_band_plain(*args)),
                       "band": (cut, n, halo)}
            bands.append([o.clone() for o in out])
            halo = [o[-4:].contiguous() for o in out]
        if err:
            raise AssertionError(f"filter_band over {T} bands differs from "
                                 f"its plain version by {err}")
        got = [torch.cat([b[k] for b in bands]) for k in range(3)]
        werr = max_abs_err(got, whole)
        if werr:
            raise AssertionError(f"{T} bands differ from the whole-plane "
                                 f"kernel by {werr}")
        log(f"  {T} bands handed down: equal to the whole-plane kernel; "
            f"each band launch bit-exact against its plain version")
    cut, n, halo = row.pop("band")
    nbytes = 2 * sum(p.numel() for p in cut) + sum(h.numel() for h in halo) \
        + 3 * sum(h.shape[1] for h in halo)
    ops = n * (16 * 4 * 2 + 2 * 8 * 2 * 2) * OPS_FILTER_LINE
    bms, by = bound(nbytes, ops)
    shape = f"{Wp}x{cut[0].shape[0]} band with 4 halo lines"
    log(f"  loop_filter band mode ({shape}): kernel {row['ms']:.3f} ms, "
        f"plain {row['plain_ms']:.1f} ms, bound {bms:.5f} ms ({by})")
    row.update(shape=shape, max_abs_err=0, bound_ms=bms, bound_by=by)
    return {"loop_filter": row}


def _multirank(what, cfg, frames, world, gop, tile, dev, w=W, h=H,
               devices=None, backend="gloo"):
    """`frames` through the single-rank port encoder on `dev` and through a
    `world`-rank encode, by default sharing that card over gloo (else rank
    r on devices[r] over `backend`); the streams must be byte-identical.
    Returns (the ranks' kernel launches, MBs replaced, fps over the
    slowest rank, single-rank fps)."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.parallel.encoder import encode_frames_spawned
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

    shared = devices is None
    devices = [dev] * world if shared else devices
    enc = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    t0 = time.monotonic()
    want, replaced = [], 0
    for p in enc.encode_frames(frames):
        want.append(p)
        replaced += enc.last_frame_stats["replaced"]
    dt = time.monotonic() - t0
    enc.close()
    t0 = time.monotonic()
    got, launches, secs = encode_frames_spawned(
        EncoderConfig(**cfg), frames, w, h, world, backend, devices,
        gop=gop, tile=tile)
    wall = time.monotonic() - t0
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} frames of {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            raise AssertionError(f"{what}: frame {i} differs from the "
                                 f"single-rank stream ({len(b)} vs {len(a)} "
                                 f"bytes)")
    where = ("sharing one card over gloo (NCCL refuses two ranks on one "
             "device)" if shared else
             f"on {', '.join(map(str, devices))} over {backend}")
    note = (": a correctness figure for ranks that share one card, not a "
            "scaling one" if shared else "")
    log(f"  {what}: {len(frames)} frames {w}x{h}, {world} ranks (gop {gop} "
        f"x tile {tile}) {where}: byte-identical to the single-rank stream "
        f"({sum(map(len, got))} bytes, {replaced} MBs replaced); "
        f"{len(frames) / secs:.3f} fps over the slowest rank's encode "
        f"({secs:.2f} s; {wall:.1f} s with the ranks' start), single rank "
        f"{len(frames) / dt:.3f} fps{note}; launches "
        + json.dumps(launches))
    return launches, replaced, len(frames) / secs, len(frames) / dt


def phase_multirank(dev):
    """The multi-GPU layer at 1080p on the one card: the panned canvas
    with gop_size=5 (two GOPs) over 4 ranks (2 gop lanes x 2 tiles), then
    the SSIM-target replacement content over 2 ranks (1 lane x 2 tiles),
    each byte-identical to the single-rank port encode on the card; every
    kernel of the path launched in the ranks (the searches and the filter
    in their shard and band modes)."""
    total = {}
    launches, *_ = _multirank(
        "panned canvas, gop_size=5", dict(qi_min=10, qi_max=40, gop_size=5,
                                          altref_range=3),
        synth_moving(N_MULTI_FRAMES, seed=4), 4, 2, 2, dev)
    for name in ("luma_wavefront", "chroma_wavefront", "loop_filter",
                 "loop_filter_band", "fullpel_search", "fullpel_search_shard",
                 "qpel_search", "qpel_search_shard", "inter_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched by the ranks")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    launches, replaced, *_ = _multirank(
        "replacement content, SSIM target 0.98", SSIM_CFG,
        synth_replacement(N_MULTI_SSIM_FRAMES, seed=6), 2, 1, 2, dev)
    if launches["trial_luma"] <= 0 or launches["trial_chroma_merge"] <= 0 \
            or replaced <= 0:
        raise AssertionError("the SSIM controller did not run in the ranks")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_quality(dev):
    """The 1080p quality row of bench_quality.json on the card, decoded by
    the port's decoder, and a small stream of the spec backend held against
    the card's.  Returns the `quality` record."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tools"))
    import quality_cuda

    name, w, h, n, cfg = quality_cuda.HD1080
    with open(os.path.join(root, "bench_quality.json")) as fh:
        want = next(r for r in json.load(fh)["hd_rows"]
                    if r["config"] == name)
    frames = quality_cuda.synth_sequence(w, h, n, seed=0)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    spent = {}
    t0 = time.monotonic()
    got = quality_cuda.run_config(name, cfg, frames, w, h, device=dev,
                                  decode_frames=N_QUALITY_DECODED,
                                  timings=spent)
    wall = time.monotonic() - t0
    launches = {k: c.launches for k, c in counters.items()}
    log(f"  {name}: {n} frames {w}x{h} in {wall:.1f} s (encode "
        f"{spent['encode_s']:.2f} s, decode of {spent['decoded']} frames "
        f"{spent['decode_s']:.1f} s, metrics {spent['metrics_s']:.2f} s); "
        f"launches {json.dumps(launches)}")
    keys = ("kbps", "psnr", "ssim")
    measured = {k: got[k] for k in keys}
    recorded = {k: want[k] for k in keys}
    log(f"  measured {json.dumps(measured)}, recorded {json.dumps(recorded)}")
    if spent["decoded"] != N_QUALITY_DECODED:
        raise AssertionError(f"{spent['decoded']} frames decoded")
    for k in keys:
        if got[k] != want[k]:
            raise AssertionError(f"{name}: {k} {got[k]} differs from the "
                                 f"recorded {want[k]}")
    _check_launched(launches, "the quality stream")

    sw, sh = 96, 80
    small = quality_cuda.synth_sequence(sw, sh, N_SPEC_FRAMES, seed=0)
    spec_cfg = dict(qi_min=10, qi_max=40)       # default GOP
    t1 = time.monotonic()
    card = Encoder(EncoderConfig(**spec_cfg), sw, sh, device=dev)
    on_card = list(card.encode_frames(small))
    card.close()
    spec = Encoder(EncoderConfig(**spec_cfg), sw, sh, backend="spec")
    on_host = list(spec.encode_frames(small))
    spec.close()
    if on_card != on_host:
        raise AssertionError("the spec backend's 96x80 stream differs from "
                             "the card's")
    n_inter = sum(p[0] & 1 for p in on_host)
    log(f"  spec backend: {N_SPEC_FRAMES} frames {sw}x{sh} default GOP "
        f"({n_inter} inter) byte-identical to the card's "
        f"({sum(map(len, on_host))} bytes, {time.monotonic() - t1:.1f} s)")
    if n_inter != N_SPEC_FRAMES - 1:
        raise AssertionError(f"only {n_inter} inter frames in the spec "
                             f"stream")
    return {"config": name, "size": f"{w}x{h}", "frames": n,
            "measured": measured, "recorded": recorded,
            "decoded_frames": spent["decoded"], "decoded_bit_exact": True,
            "decode_s_per_frame": spent["decode_s"] / spent["decoded"],
            "encode_s": spent["encode_s"], "launches": launches,
            "spec_stream_equal": True, "spec_frames": N_SPEC_FRAMES}


def _plain(fn):
    """(output, ms) of one call of a plain version (`span_ms`)."""
    out = []
    ms = span_ms(lambda: out.append(fn()))
    return out[0], ms


def phase_uhd_kernels(dev):
    """The six kernels at 3840x2160 against their plain versions on the
    card, bit-exact, each timed by the card's clock with its bound and
    share: luma and chroma on a frame of the panned canvas (240 MB columns,
    135 MB rows: more rows than SMs, taken by ticket), the loop filter on
    their recon with four segments and a mixed inner-edge mask, whole
    plane and as 2 bands of 68 and 67 MB rows handed down (equal to the
    whole plane), both searches on the real UHD pyramid of the canvas
    level by level (levels 4..2 leave 7, 6 and 4 rows below their last
    block row; level 3 takes fullpel_kernel<3>), and the luma trial at
    32400 MBs at the AQ, HQ and UQ quantizers of the SSIM-target path.
    Returns {kernel: its UHD record}."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.parallel.mesh import band_rows
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    frames = [pad_frame(f) for f in synth_moving(4, seed=3, w=UHD_W,
                                                 h=UHD_H)]
    f = frames[3]
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    Hp, Wp = f.y.shape
    mbw, mbh = Wp // 16, Hp // 16
    mbc = mbw * mbh
    rows = {}

    def same(what, k, p):
        err = max_abs_err(k, p)
        if err:
            raise AssertionError(f"{what} at {Wp}x{Hp}: kernel differs from "
                                 f"its plain version by {err}")

    def record(name, what, ms, pms, bms, by):
        log(f"  {name} ({what}): bit-exact, kernel {ms:.4f} ms, plain "
            f"{pms:.1f} ms, bound {bms:.5f} ms ({by}), share {bms / ms:.4f}")
        return {"shape": what, "max_abs_err": 0, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "share": bms / ms}

    seg = prepare_segments(EncoderConfig(qi_min=QI_PAIRS[0],
                                         qi_max=QI_PAIRS[0]), f.y, True, True)
    k_l = I.luma_wavefront(y, int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))
    k_c = I.chroma_wavefront(uv, int(seg.uv_dc_q[0]), int(seg.uv_ac_q[0]))
    # the filter on their recon: four segments with their own limits
    planes, sid, inner, lf, on = _filter_inputs(f, k_l[0], k_c[0], 5, dev)
    line_ops = (16 * 4 * 2 + 2 * 8 * 2 * 2) * OPS_FILTER_LINE
    outs = {}
    for name, fn, pfn, nbytes, ops in _row_specs(y, uv, seg, planes, sid,
                                                 inner, lf, on):
        p, pms = _plain(pfn)
        for _ in range(3):                  # rows race if the rule is off
            outs[name] = fn()
            same(name, outs[name], p)
        rows[name] = record(name, f"{Wp}x{Hp}, {mbh} MB rows", cuda_ms(
            fn, reps=10), pms, *bound(nbytes, ops))
    whole = outs["loop_filter"]
    halo, bands, spans = None, [], band_rows(mbh, 2)
    for t, (r0, n) in enumerate(spans):
        cut = [q[r0 * s:(r0 + n) * s].contiguous()
               for q, s in zip(planes, (16, 8, 8))]
        mbs = slice(r0 * mbw, (r0 + n) * mbw)
        args = (*cut, halo, sid[mbs].contiguous(), inner[mbs].contiguous(),
                *lf)
        out, wb = LF.filter_band(*args)
        if wb is not None:
            for k in range(3):
                bands[-1][k][-3:] = wb[k]
        if t == len(spans) - 1:         # the lower band, with its halo
            ms = cuda_ms(lambda: LF.filter_band(*args), reps=10)
            nbytes = 2 * sum(q.numel() for q in cut) \
                + sum(h.numel() for h in halo) \
                + 3 * sum(h.shape[1] for h in halo)
            bms, by = bound(nbytes, int(on[mbs].sum()) * line_ops)
            what = f"{Wp}x{n * 16} band of {mbh} MB rows with 4 halo lines"
            log(f"  loop_filter band mode ({what}): kernel {ms:.3f} ms, bound "
                f"{bms:.5f} ms ({by}), share {bms / ms:.4f}")
            rows["loop_filter"]["band_mode"] = {
                "shape": what, "ms": ms, "bound_ms": bms, "bound_by": by,
                "share": bms / ms}
        bands.append([o.clone() for o in out])
        halo = [o[-4:].contiguous() for o in out]
    err = max_abs_err([torch.cat([b[k] for b in bands]) for k in range(3)],
                      whole)
    if err:
        raise AssertionError(f"the bands {spans} differ from the whole-plane "
                             f"filter by {err}")
    log(f"  loop_filter as bands of {[n for _, n in spans]} MB rows handed "
        f"down: equal to the whole plane")

    # the searches on the canvas's pyramid, level by level
    ys = [torch.from_numpy(fr.y).to(dev) for fr in frames]
    cur = IN.build_pyramid(ys[3])
    refs = [torch.stack(lv).contiguous() for lv in
            zip(*(IN.build_pyramid(q) for q in ys[:3]))]
    fp = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    vec = None
    for lvl, rate in ((4, 16), (3, 8), (2, 4), (1, 2), (0, 1)):
        c, r = cur[lvl], refs[lvl]
        Hl, Wl = c.shape
        nby, nbx = Hl // 8, Wl // 8
        v0 = IN.inherit_vectors(vec, 3, nby, nbx, rate, dev)
        pen = rate < 4
        k = IN.fullpel_search(c, r, v0, pen)
        p, pms = _plain(lambda: IN.fullpel_search_plain(c, r, v0, pen))
        same(f"fullpel_search level {lvl}", [k], [p])
        ms = cuda_ms(lambda: IN.fullpel_search(c, r, v0, pen), reps=10)
        nbytes, ops, _, valid, cands = _fullpel_work(c, r, v0)
        log(f"  fullpel_search level {lvl} ({Wl}x{Hl}, {nby * nbx} blocks x "
            f"3 refs, fullpel_kernel<"
            f"{1 if nby * nbx < FULLPEL_FEW_BLOCKS else 3}>, {Hl - nby * 8} "
            f"rows below the last block row, {valid} of {cands} candidates "
            f"in frame): bit-exact, kernel {ms:.4f} ms, plain {pms:.1f} ms, "
            f"bound {bound(nbytes, ops)[0]:.5f} ms")
        for key, val in (("ms", ms), ("plain_ms", pms), ("bytes", nbytes),
                         ("ops", ops)):
            fp[key] += val
        vec = (k * rate).reshape(3, nby, nbx, 2)
    rows["fullpel_search"] = record(
        "fullpel_search", f"5 levels of a {Wp}x{Hp} pyramid", fp["ms"],
        fp["plain_ms"], *bound(fp["bytes"], fp["ops"]))
    c, r = cur[0], refs[0]
    fv = vec.reshape(3, -1, 2).contiguous()
    k = IN.qpel_search(c, r, fv)
    p, pms = _plain(lambda: IN.qpel_search_plain(c, r, fv))
    same("qpel_search", k, p)
    bms, by, jobs, valid = _qpel_bound(c, r, fv)
    rows["qpel_search"] = record(
        "qpel_search", f"{Wp}x{Hp}, {jobs} jobs, {valid} of {jobs * 25} "
        f"candidates in frame", cuda_ms(lambda: IN.qpel_search(c, r, fv),
                                        reps=10), pms, bms, by)

    # the luma trial: sources of one frame, frozen neighbours cut from
    # another's keyframe-coded recon
    sseg = prepare_segments(EncoderConfig(**SSIM_CFG), f.y, False, False)
    recon = I.luma_wavefront(ys[2], int(sseg.y_dc_q[3]),
                             int(sseg.y_ac_q[3]))[0]
    y_mb = IR._plane_mb(y, 16).contiguous()
    ftop, fleft = IR._frozen_luma_neighbors(recon, mbw, mbh)
    t_ms, t_pms = [], []
    for s in (2, 1, 0):
        q = (int(sseg.y_dc_q[s]), int(sseg.y_ac_q[s]))
        k = IR.trial_luma(y_mb, ftop, fleft, *q)
        p, pms = _plain(lambda: IR.trial_luma_plain(y_mb, ftop, fleft, *q))
        same(f"trial_luma q={q}", k, p)
        t_ms.append(cuda_ms(lambda: IR.trial_luma(y_mb, ftop, fleft, *q),
                            reps=10))
        t_pms.append(pms)
    rows["trial_luma"] = record(
        "trial_luma", f"{mbc} MBs, median of the 3 SSIM quantizer pairs",
        statistics.median(t_ms), statistics.median(t_pms),
        *bound(mbc * (256 + 21 + 16 + 256 * 2 + 16 + 256),
               mbc * 16 * OPS_LUMA_BLOCK))
    return rows


def _timed_stream(enc, frames, first_partitions=None):
    """(payloads, launches by kernel, seconds, frame intervals in ms, MBs
    replaced per frame) of `frames` through `enc.encode_frames`, the
    counters set to 0 just before it and read just after; each frame's
    first partition in bytes is appended to `first_partitions`."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    stamps, out, replaced = [], [], []
    t0 = time.monotonic()
    for payload in enc.encode_frames(frames):
        out.append(payload)
        stamps.append(time.monotonic())
        replaced.append(enc.last_frame_stats["replaced"])
        if first_partitions is not None:
            first_partitions.append(
                enc.last_frame_stats["first_partition_bytes"])
    dt = time.monotonic() - t0
    launches = {name: c.launches for name, c in counters.items()}
    return out, launches, dt, [(b - a) * 1e3 for a, b in
                               zip(stamps, stamps[1:])], replaced


def phase_uhd_streams(dev):
    """UHD through the entry points at 4 partitions and 6 threads: the
    default GOP (6 frames of the panned canvas, GOPs of 3) and the SSIM
    target (3 frames of replacement content) on one rank, each with its
    first 2 frames byte-identical to the plain CPU encode and every kernel
    of its path launched; the 6 frames again over 4 ranks (2 gop lanes x 2
    row tiles of 68 and 67 MB rows) sharing the card over gloo,
    byte-identical to one rank, the searches and the filter in their
    shard and band modes.  Returns (the `uhd` record, launches by
    stream)."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.parallel.mesh import band_rows
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder, _own_padded
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    size = f"{UHD_W}x{UHD_H}"
    frames = synth_moving(N_UHD_FRAMES, seed=1, w=UHD_W, h=UHD_H)
    cfg = EncoderConfig(**UHD_CFG)
    warm = Encoder(cfg, UHD_W, UHD_H, device=dev)
    list(warm.encode_frames(frames[:2]))          # first-use costs
    warm.close()
    torch.cuda.synchronize()
    enc = Encoder(cfg, UHD_W, UHD_H, device=dev)
    out, launches, dt, gaps, _ = _timed_stream(enc, frames)
    enc.close()
    tags = [p[0] & 1 for p in out]                 # frame tag: 1 = inter
    if tags != [0, 1, 1] * (N_UHD_FRAMES // 3):
        raise AssertionError(f"UHD default GOP: frame tags {tags}")
    for name in ("luma_wavefront", "chroma_wavefront", "loop_filter",
                 "fullpel_search", "qpel_search", "inter_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the UHD "
                                 f"default-GOP path")
    gop = {"frames": N_UHD_FRAMES, "inter": sum(tags), "fps": N_UHD_FRAMES
           / dt, "median_interval_ms": statistics.median(gaps),
           "bytes": sum(map(len, out)),
           "keyframe_bytes": [len(p) for p, t in zip(out, tags) if not t],
           "inter_bytes_median": statistics.median(
               len(p) for p, t in zip(out, tags) if t)}
    log(f"  default GOP: {N_UHD_FRAMES} frames {size} ({sum(tags)} inter) in "
        f"{dt:.3f} s: {gop['fps']:.3f} fps end to end, median frame interval "
        f"{gop['median_interval_ms']:.3f} ms, {gop['bytes']} bytes "
        f"(keyframes {gop['keyframe_bytes']}, inter median "
        f"{gop['inter_bytes_median']}); launches {json.dumps(launches)}")

    # device chains, frames pre-uploaded: a keyframe, then an inter frame
    probe = Encoder(cfg, UHD_W, UHD_H, device=dev)
    p = _own_padded(frames[0])
    seg = prepare_segments(probe.cfg, p.y, True, True)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    key_ms = [span_ms(lambda: probe.backend.encode_intra_frame(
        p.y, p.u, p.v, seg, yuv_dev=yuv)) for _ in range(3)]
    fd, seg = probe._frame_pixels(_own_padded(frames[0]))
    probe.backend.finalize_framedata(fd, seg)
    p = _own_padded(frames[1])
    seg = prepare_segments(probe.cfg, p.y, False, False)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    inter_ms = [span_ms(lambda: probe.backend.encode_inter_frame(
        probe, p.y, p.u, p.v, seg, False, False, yuv_dev=yuv))
        for _ in range(3)]
    probe.close()
    gop["key_chain_ms"] = statistics.median(key_ms)
    gop["inter_chain_ms"] = statistics.median(inter_ms)
    log(f"  device chain, median of 3: keyframe (intra, filter, D2H) "
        f"{gop['key_chain_ms']:.3f} ms; inter frame (search, body, filter, "
        f"next LAST pyramid, D2H) {gop['inter_chain_ms']:.3f} ms")

    # the host's share, frame by frame without overlap
    split = {"key": {}, "inter": {}}
    seq = Encoder(cfg, UHD_W, UHD_H, device=dev)
    for i, f in enumerate(frames):
        ta = time.perf_counter()
        # an inter frame's dispatch must never wait for the card
        torch.cuda.set_sync_debug_mode("error" if tags[i] else "default")
        fd, seg = seq._frame_pixels(_own_padded(f))
        torch.cuda.set_sync_debug_mode("default")
        tb = time.perf_counter()
        seq.backend.finalize_framedata(fd, seg)
        tc = time.perf_counter()
        seq._finish_frame(fd, seg)
        td = time.perf_counter()
        part = split["key" if fd.is_key else "inter"]
        for k, v in zip(("pad_upload_dispatch", "wait_device_d2h",
                         "entropy_and_headers"), (tb - ta, tc - tb, td - tc)):
            part.setdefault(k, []).append(v * 1e3)
    seq.close()
    gop["host_split_ms"] = {
        kind: {k: statistics.median(v) for k, v in part.items()}
        for kind, part in split.items()}
    log("  sequential host split, medians per keyframe (of 2) and inter "
        "frame (of 4), ms: " + json.dumps(gop["host_split_ms"]))
    _same_as_cpu("UHD default-GOP", UHD_CFG, frames[:N_UHD_CPU_FRAMES], out,
                  w=UHD_W, h=UHD_H)
    by_stream = {"default_gop": launches}

    # the SSIM target
    sframes = synth_replacement(N_UHD_SSIM_FRAMES, seed=1, w=UHD_W, h=UHD_H,
                                regions=UHD_REGIONS)
    scfg = EncoderConfig(**UHD_SSIM_CFG)
    warm = Encoder(scfg, UHD_W, UHD_H, device=dev)
    list(warm.encode_frames(sframes[:2]))
    warm.close()
    torch.cuda.synchronize()
    enc = Encoder(scfg, UHD_W, UHD_H, device=dev)
    sout, slaunches, sdt, sgaps, replaced = _timed_stream(enc, sframes)
    enc.close()
    st, mbc = enc.stats, enc.mbc
    n_inter = sum(p[0] & 1 for p in sout)
    log(f"  SSIM target 0.98: {N_UHD_SSIM_FRAMES} frames {size} ({n_inter} "
        f"inter) in {sdt:.3f} s: {N_UHD_SSIM_FRAMES / sdt:.3f} fps end to "
        f"end, median frame interval {statistics.median(sgaps):.3f} ms, "
        f"MBs replaced per frame {replaced} of {mbc}; launches "
        + json.dumps(slaunches))
    if n_inter != N_UHD_SSIM_FRAMES - 1:
        raise AssertionError(f"only {n_inter} inter frames")
    if st.scene_changes_by_ssim + st.scene_changes_by_replaced \
            + st.scene_changes_by_color:
        raise AssertionError(f"a frame was done again as a key: {st}")
    for name in ("trial_luma", "trial_chroma_merge"):
        if slaunches[name] != 3 * n_inter:
            raise AssertionError(f"{name} was launched {slaunches[name]} "
                                 f"times for {n_inter} inter frames, not 3 "
                                 f"each")
    _check_launched(slaunches, "the UHD SSIM-target path")
    if max(replaced) <= 0 or max(replaced) > mbc // 6:
        raise AssertionError(f"replaced MBs per frame {replaced}: none, or "
                             f"above a sixth of {mbc}")
    _same_as_cpu("UHD SSIM-target", UHD_SSIM_CFG,
                 sframes[:N_UHD_CPU_FRAMES], sout, w=UHD_W, h=UHD_H)
    by_stream["ssim_target"] = slaunches
    ssim = {"frames": N_UHD_SSIM_FRAMES, "inter": n_inter,
            "fps": N_UHD_SSIM_FRAMES / sdt,
            "median_interval_ms": statistics.median(sgaps),
            "replaced": replaced, "bytes": sum(map(len, sout))}

    # row tiles with halo exchange
    mlaunches, _, mfps, sfps = _multirank(
        "UHD panned canvas, gop_size=3", UHD_CFG, frames, 4, 2, 2, dev,
        UHD_W, UHD_H)
    for name in ("luma_wavefront", "chroma_wavefront", "loop_filter_band",
                 "fullpel_search_shard", "qpel_search_shard", "inter_pass"):
        if mlaunches[name] <= 0:
            raise AssertionError(f"{name} was never launched by the UHD "
                                 f"ranks")
    by_stream["multirank"] = mlaunches
    multi = {"frames": N_UHD_FRAMES, "ranks": 4, "gop": 2, "tile": 2,
             "tile_mb_rows": [n for _, n in band_rows(UHD_H // 16, 2)],
             "fps_slowest_rank": mfps,
             "fps_single_rank": sfps, "equal_to_single_rank": True}
    return ({"size": size, "config": UHD_CFG, "default_gop": gop,
             "ssim_target": ssim, "multirank": multi,
             "cpu_frames_equal": N_UHD_CPU_FRAMES}, by_stream)


GLOBAL_KERNELS = {"luma_wavefront": "luma_rows_kernel",
                  "chroma_wavefront": "chroma_rows_kernel",
                  "fullpel_search": "fullpel_kernel",
                  "qpel_search": "qpel_kernel",
                  "trial_luma": "trial_luma_kernel",
                  "mb_ssim": "mb_ssim_kernel",
                  "inter_pass": "inter_pass_kernel",
                  "trial_chroma_merge": "trial_chroma_merge_kernel"}


def global_kernel(name, width):
    """The __global__ function that the wrapper `name` launches on a luma
    plane `width` pixels wide: the loop filter's full-row kernel where the
    row fits a CTA of this card, its ring kernel above that."""
    if name != "loop_filter":
        return GLOBAL_KERNELS[name]
    from vp8oclenc_tpu_torch.ops import cuda_build
    return ("loop_filter_ring_kernel"
            if cuda_build.library("loopfilter").vp8_filter_ring(width)
            else "loop_filter_rows_kernel")


def _row_specs(y, uv, seg, planes, sid, inner, lf, on):
    """(name, kernel call, plain call, bytes, operations) of the three row
    kernels on one frame: luma and chroma on its source at `seg`'s first
    quantizers, the filter on `planes` with the limits `lf`."""
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    Hp, Wp = y.shape
    mbc = (Hp // 16) * (Wp // 16)
    yq = (int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))
    cq = (int(seg.uv_dc_q[0]), int(seg.uv_ac_q[0]))
    line_ops = (16 * 4 * 2 + 2 * 8 * 2 * 2) * OPS_FILTER_LINE
    return [
        ("luma_wavefront", lambda: I.luma_wavefront(y, *yq),
         lambda: I.luma_wavefront_plain(y, *yq),
         Hp * Wp * 2 + mbc * 16 * 16 * 2 + mbc * 16,
         (Hp // 4) * (Wp // 4) * OPS_LUMA_BLOCK),
        ("chroma_wavefront", lambda: I.chroma_wavefront(uv, *cq),
         lambda: I.chroma_wavefront_plain(uv, *cq),
         uv.numel() * 2 + 2 * mbc * 4 * 16 * 2,
         2 * mbc * 4 * OPS_CHROMA_QUAD),
        ("loop_filter", lambda: LF.filter_planes(*planes, sid, inner, *lf),
         lambda: LF.filter_planes_plain(*planes, sid, inner, *lf),
         2 * sum(q.numel() for q in planes), int(on.sum()) * line_ops)]


def _filter_inputs(f, y_rec, uv_rec, seed, dev):
    """The filter's inputs on a recon: four segments with their own limits
    (qi 30..90), a mixed inner-edge mask; (planes, sid, inner, lf, MBs
    whose segment filters)."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    fseg = prepare_segments(EncoderConfig(qi_min=30, qi_max=90), f.y, False,
                            False)
    lf = [torch.as_tensor(np.asarray(a, np.int32), device=dev) for a in
          (fseg.loop_filter_level, fseg.mbedge_limit, fseg.sub_bedge_limit,
           fseg.interior_limit, fseg.hev_threshold)]
    mbc = y_rec.numel() // 256
    rng = np.random.default_rng(seed)
    sid = torch.as_tensor(rng.integers(0, 4, mbc), dtype=torch.int32,
                          device=dev)
    inner = torch.as_tensor(rng.random(mbc) < 0.5, device=dev)
    planes = (y_rec, uv_rec[0].contiguous(), uv_rec[1].contiguous())
    return planes, sid, inner, lf, lf[0][sid.long()] > 0


def phase_wide_kernels(dev):
    """Planes wider than a whole-row CTA held (the filter from 7264
    pixels, luma from 11072), up to VP8's widest: the six kernels at
    16384x128 against their plain versions on the card (the panned
    canvas; searches level by level on its pyramid, whose level 4 is
    1024x8; the trial on its 8192 MBs); the filter and luma at 7680x1088,
    the filter also as 2 bands of 34 MB rows handed down (equal to the
    whole plane, the lower band's launch equal to its plain version);
    the filter and luma timed at 8K (7680x4320, 270 MB rows) on a frame
    of the canvas, with bound and share.  Returns {kernel: its wide
    record}."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import cuda_build
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.parallel.mesh import band_rows
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    rows = {}

    def same(what, k, p):
        err = max_abs_err(k, p)
        if err:
            raise AssertionError(f"{what}: kernel differs from its plain "
                                 f"version by {err}")

    def record(name, what, ms, pms, bms, by):
        log(f"  {name} ({what}): bit-exact, kernel {ms:.4f} ms, plain "
            f"{pms:.1f} ms, bound {bms:.5f} ms ({by}), share {bms / ms:.4f}")
        return {"shape": what, "max_abs_err": 0, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "share": bms / ms}

    intra, filt = cuda_build.library("intra"), cuda_build.library(
        "loopfilter")
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    smem = {"luma_wavefront": intra.vp8_luma_smem(WIDEST_W),
            "chroma_wavefront": intra.vp8_chroma_smem(WIDEST_W // 2),
            "loop_filter": filt.vp8_filter_smem(WIDEST_W)}
    log(f"  dynamic shared memory a CTA at {WIDEST_W} pixels: "
        f"{json.dumps(smem)} bytes; this card's opt-in limit {limit}")
    if max(smem.values()) > limit:
        raise AssertionError("a row kernel does not fit the widest plane")

    # the six at 16384x128
    frames = [pad_frame(f) for f in synth_moving(4, seed=3, w=WIDEST_W,
                                                 h=WIDEST_H)]
    f = frames[3]
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    Hp, Wp = f.y.shape
    mbw, mbh = Wp // 16, Hp // 16
    mbc = mbw * mbh
    seg = prepare_segments(EncoderConfig(qi_min=QI_PAIRS[0],
                                         qi_max=QI_PAIRS[0]), f.y, True, True)
    y_rec = I.luma_wavefront(y, int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))[0]
    uv_rec = I.chroma_wavefront(uv, int(seg.uv_dc_q[0]),
                                int(seg.uv_ac_q[0]))[0]
    size = f"{Wp}x{Hp}, {mbw} MB columns"
    for name, fn, pfn, nbytes, ops in _row_specs(
            y, uv, seg, *_filter_inputs(f, y_rec, uv_rec, 5, dev)):
        p, pms = _plain(pfn)
        same(f"{name} at {size}", fn(), p)
        same(f"{name} at {size}, again", fn(), p)
        rows[name] = record(name, size, cuda_ms(fn, reps=10), pms,
                            *bound(nbytes, ops))
    ys = [torch.from_numpy(fr.y).to(dev) for fr in frames]
    cur = IN.build_pyramid(ys[3])
    refs = [torch.stack(lv).contiguous() for lv in
            zip(*(IN.build_pyramid(q) for q in ys[:3]))]
    fp = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    vec = None
    for lvl, rate in ((4, 16), (3, 8), (2, 4), (1, 2), (0, 1)):
        c, r = cur[lvl], refs[lvl]
        Hl, Wl = c.shape
        nby, nbx = Hl // 8, Wl // 8
        v0 = IN.inherit_vectors(vec, 3, nby, nbx, rate, dev)
        pen = rate < 4
        k = IN.fullpel_search(c, r, v0, pen)
        p, pms = _plain(lambda: IN.fullpel_search_plain(c, r, v0, pen))
        same(f"fullpel_search level {lvl} at {Wl}x{Hl}", [k], [p])
        nbytes, ops, _, _, _ = _fullpel_work(c, r, v0)
        for key, val in (("ms", cuda_ms(lambda: IN.fullpel_search(
                c, r, v0, pen), reps=10)), ("plain_ms", pms),
                ("bytes", nbytes), ("ops", ops)):
            fp[key] += val
        vec = (k * rate).reshape(3, nby, nbx, 2)
    rows["fullpel_search"] = record(
        "fullpel_search", f"5 levels of a {Wp}x{Hp} pyramid", fp["ms"],
        fp["plain_ms"], *bound(fp["bytes"], fp["ops"]))
    c, r = cur[0], refs[0]
    fv = vec.reshape(3, -1, 2).contiguous()
    p, pms = _plain(lambda: IN.qpel_search_plain(c, r, fv))
    same("qpel_search", IN.qpel_search(c, r, fv), p)
    bms, by, jobs, _ = _qpel_bound(c, r, fv)
    rows["qpel_search"] = record(
        "qpel_search", f"{Wp}x{Hp}, {jobs} jobs",
        cuda_ms(lambda: IN.qpel_search(c, r, fv), reps=10), pms, bms, by)
    sseg = prepare_segments(EncoderConfig(**SSIM_CFG), f.y, False, False)
    q = (int(sseg.y_dc_q[1]), int(sseg.y_ac_q[1]))
    y_mb = IR._plane_mb(y, 16).contiguous()
    ftop, fleft = IR._frozen_luma_neighbors(y_rec, mbw, mbh)
    p, pms = _plain(lambda: IR.trial_luma_plain(y_mb, ftop, fleft, *q))
    same("trial_luma", IR.trial_luma(y_mb, ftop, fleft, *q), p)
    rows["trial_luma"] = record(
        "trial_luma", f"{mbc} MBs, the HQ quantizers of the SSIM target",
        cuda_ms(lambda: IR.trial_luma(y_mb, ftop, fleft, *q), reps=10), pms,
        *bound(mbc * (256 + 21 + 16 + 256 * 2 + 16 + 256),
               mbc * 16 * OPS_LUMA_BLOCK))
    del frames, ys, cur, refs

    # the filter and luma at 7680x1088, the filter also as 2 bands
    f = pad_frame(synth_moving(4, seed=3, w=WIDE_W, h=WIDE_STRIP_H)[3])
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    Hp, Wp = f.y.shape
    mbw, mbh = Wp // 16, Hp // 16
    seg = prepare_segments(EncoderConfig(qi_min=QI_PAIRS[0],
                                         qi_max=QI_PAIRS[0]), f.y, True, True)
    y_rec = I.luma_wavefront(y, int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))[0]
    uv_rec = I.chroma_wavefront(uv, int(seg.uv_dc_q[0]),
                                int(seg.uv_ac_q[0]))[0]
    planes, sid, inner, lf, on = _filter_inputs(f, y_rec, uv_rec, 6, dev)
    size = f"{Wp}x{Hp}"
    for name, fn, pfn, _, _ in _row_specs(y, uv, seg, planes, sid, inner, lf,
                                          on):
        if name == "chroma_wavefront":
            continue
        p, pms = _plain(pfn)
        same(f"{name} at {size}", fn(), p)
        if name == "loop_filter":
            whole = p
        rows[name][f"at_{size}"] = {"kernel": global_kernel(name, Wp),
                                    "max_abs_err": 0, "plain_ms": pms}
        log(f"  {name} at {size}: bit-exact (plain {pms:.1f} ms)")
    halo, bands, spans = None, [], band_rows(mbh, 2)
    for t, (r0, n) in enumerate(spans):
        cut = [q[r0 * s:(r0 + n) * s].contiguous()
               for q, s in zip(planes, (16, 8, 8))]
        mbs = slice(r0 * mbw, (r0 + n) * mbw)
        args = (*cut, halo, sid[mbs].contiguous(), inner[mbs].contiguous(),
                *lf)
        out, wb = LF.filter_band(*args)
        if t == len(spans) - 1:          # the lower band, with its halo
            p, pms = _plain(lambda: LF.filter_band_plain(*args))
            same(f"loop_filter band of {n} MB rows at {Wp}", list(out)
                 + list(wb), list(p[0]) + list(p[1]))
            rows["loop_filter"][f"band_{Wp}"] = {
                "kernel": global_kernel("loop_filter", Wp),
                "shape": f"{Wp}x{n * 16} band with 4 halo lines",
                "max_abs_err": 0, "plain_ms": pms}
        if wb is not None:
            for k in range(3):
                bands[-1][k][-3:] = wb[k]
        bands.append([o.clone() for o in out])
        halo = [o[-4:].contiguous() for o in out]
    err = max_abs_err([torch.cat([b[k] for b in bands]) for k in range(3)],
                      whole)
    if err:
        raise AssertionError(f"the bands {spans} at {Wp} differ from the "
                             f"whole-plane filter by {err}")
    log(f"  loop_filter as bands of {[n for _, n in spans]} MB rows at {Wp} "
        f"handed down: the lower band's launch bit-exact, the bands equal "
        f"to the whole plane")

    # the filter and luma timed at 8K
    f = pad_frame(synth_moving(4, seed=3, w=WIDE_W, h=WIDE_H)[3])
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    Hp, Wp = f.y.shape
    seg = prepare_segments(EncoderConfig(qi_min=QI_PAIRS[0],
                                         qi_max=QI_PAIRS[0]), f.y, True, True)
    y_rec = I.luma_wavefront(y, int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))[0]
    uv_rec = I.chroma_wavefront(uv, int(seg.uv_dc_q[0]),
                                int(seg.uv_ac_q[0]))[0]
    for name, fn, _, nbytes, ops in _row_specs(
            y, uv, seg, *_filter_inputs(f, y_rec, uv_rec, 7, dev)):
        if name == "chroma_wavefront":
            continue
        ms = cuda_ms(fn, reps=10)
        bms, by = bound(nbytes, ops)
        log(f"  {name} at {Wp}x{Hp} ({Hp // 16} MB rows): kernel {ms:.4f} "
            f"ms, bound {bms:.5f} ms ({by}), share {bms / ms:.4f}")
        rows[name]["8k"] = {"kernel": global_kernel(name, Wp),
                            "shape": f"{Wp}x{Hp}", "ms": ms,
                            "bound_ms": bms, "bound_by": by,
                            "share": bms / ms, "smem": smem[name]}
    return rows


def phase_wide_streams(dev):
    """8K's width through the entry points at 4 partitions and 6 threads:
    2 frames of 7680x1088 on the card byte-identical to the plain CPU
    encode; then 4 frames of 7680x4320 (the panned canvas, GOPs of 3:
    keys at 0 and 3) through Encoder.encode_frames on the card, every
    kernel of the path launched, the keyframe byte-identical to the
    plain CPU encode, fps and frame intervals, each frame's first
    partition against the tag's 19-bit field, the device chains and the
    sequential host split.  Returns (the `wide` record, launches
    on the 8K stream)."""
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.entropy.header import (FIRST_PARTITION_LIMIT,
                                                     tag_first_partition_size)
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder, _own_padded
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments

    strip = synth_moving(N_WIDE_CPU_FRAMES, seed=1, w=WIDE_W, h=WIDE_STRIP_H)
    enc = Encoder(EncoderConfig(**UHD_CFG), WIDE_W, WIDE_STRIP_H, device=dev)
    sout = list(enc.encode_frames(strip))
    enc.close()
    if [p[0] & 1 for p in sout] != [0, 1]:
        raise AssertionError("7680x1088: not a keyframe and an inter frame")
    _same_as_cpu(f"{WIDE_W}x{WIDE_STRIP_H}", UHD_CFG, strip, sout, w=WIDE_W,
                 h=WIDE_STRIP_H)

    size = f"{WIDE_W}x{WIDE_H}"
    frames = synth_moving(N_WIDE_FRAMES, seed=1, w=WIDE_W, h=WIDE_H)
    cfg = EncoderConfig(**UHD_CFG)
    warm = Encoder(cfg, WIDE_W, WIDE_H, device=dev)
    list(warm.encode_frames(frames[:2]))          # first-use costs
    warm.close()
    torch.cuda.synchronize()
    enc = Encoder(cfg, WIDE_W, WIDE_H, device=dev)
    fps_bytes = []
    out, launches, dt, gaps, _ = _timed_stream(enc, frames, fps_bytes)
    enc.close()
    tags = [p[0] & 1 for p in out]
    if tags != [0, 1, 1, 0]:
        raise AssertionError(f"8K default GOP: frame tags {tags}")
    # the keyframe on the CPU: its cost follows the width's chain of steps
    # (~50 s), an inter frame's would double it
    _same_as_cpu(f"{WIDE_W}x{WIDE_H} keyframe", UHD_CFG, frames[:1], out,
                 w=WIDE_W, h=WIDE_H)
    for name in ("luma_wavefront", "chroma_wavefront", "loop_filter",
                 "fullpel_search", "qpel_search", "inter_pass"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the 8K "
                                 f"default-GOP path")
    first = [{"frame": i, "key": not t, "bytes": n,
              "tag_field": tag_first_partition_size(p),
              "below_2^19": n < FIRST_PARTITION_LIMIT}
             for i, (p, t, n) in enumerate(zip(out, tags, fps_bytes))]
    for r in first:
        if r["tag_field"] != r["bytes"] % FIRST_PARTITION_LIMIT:
            raise AssertionError(f"frame {r['frame']}: the tag states "
                                 f"{r['tag_field']}, not the first "
                                 f"partition's {r['bytes']} bytes modulo "
                                 f"2^19")
    gop = {"frames": N_WIDE_FRAMES, "inter": sum(tags),
           "fps": N_WIDE_FRAMES / dt, "intervals_ms": gaps,
           "bytes": [len(p) for p in out], "first_partition": first}
    log(f"  default GOP: {N_WIDE_FRAMES} frames {size} ({sum(tags)} inter) "
        f"in {dt:.3f} s: {gop['fps']:.3f} fps end to end, frame intervals "
        f"{[round(g, 3) for g in gaps]} ms, bytes {gop['bytes']}; launches "
        f"{json.dumps(launches)}")
    mbc = WIDE_W * WIDE_H // 256
    for r in first:
        log(f"  frame {r['frame']} ({'key' if r['key'] else 'inter'}): first "
            f"partition {r['bytes']} bytes ({r['bytes'] / mbc:.3f} a MB), "
            f"{'below' if r['below_2^19'] else 'NOT below'} 2^19; the tag's "
            f"19-bit field states {r['tag_field']}")

    # device chains, frames pre-uploaded: a keyframe, then an inter frame
    probe = Encoder(cfg, WIDE_W, WIDE_H, device=dev)
    p = _own_padded(frames[0])
    seg = prepare_segments(probe.cfg, p.y, True, True)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    key_ms = [span_ms(lambda: probe.backend.encode_intra_frame(
        p.y, p.u, p.v, seg, yuv_dev=yuv)) for _ in range(3)]
    fd, seg = probe._frame_pixels(_own_padded(frames[0]))
    probe.backend.finalize_framedata(fd, seg)
    p = _own_padded(frames[1])
    seg = prepare_segments(probe.cfg, p.y, False, False)
    yuv = probe.backend.upload_frame(p.y, p.u, p.v)
    inter_ms = [span_ms(lambda: probe.backend.encode_inter_frame(
        probe, p.y, p.u, p.v, seg, False, False, yuv_dev=yuv))
        for _ in range(3)]
    probe.close()
    gop["key_chain_ms"] = statistics.median(key_ms)
    gop["inter_chain_ms"] = statistics.median(inter_ms)
    log(f"  device chain, median of 3: keyframe (intra, filter, D2H) "
        f"{gop['key_chain_ms']:.3f} ms; inter frame (search, body, filter, "
        f"next LAST pyramid, D2H) {gop['inter_chain_ms']:.3f} ms")

    # the host's share, frame by frame without overlap
    split = {"key": {}, "inter": {}}
    seq = Encoder(cfg, WIDE_W, WIDE_H, device=dev)
    for i, f in enumerate(frames):
        ta = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error" if tags[i] else "default")
        fd, seg = seq._frame_pixels(_own_padded(f))
        torch.cuda.set_sync_debug_mode("default")
        tb = time.perf_counter()
        seq.backend.finalize_framedata(fd, seg)
        tc = time.perf_counter()
        seq._finish_frame(fd, seg)
        td = time.perf_counter()
        part = split["key" if fd.is_key else "inter"]
        for k, v in zip(("pad_upload_dispatch", "wait_device_d2h",
                         "entropy_and_headers"), (tb - ta, tc - tb, td - tc)):
            part.setdefault(k, []).append(v * 1e3)
    seq.close()
    gop["host_split_ms"] = {
        kind: {k: statistics.median(v) for k, v in part.items()}
        for kind, part in split.items()}
    log("  sequential host split, medians per keyframe (of 2) and inter "
        "frame (of 2), ms: " + json.dumps(gop["host_split_ms"]))
    return ({"size": size, "config": UHD_CFG, "default_gop": gop,
             "cpu_frames_equal": 1,
             "strip": {"size": f"{WIDE_W}x{WIDE_STRIP_H}",
                       "cpu_frames_equal": N_WIDE_CPU_FRAMES}}, launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vp8oclenc_tpu_torch.native import packer
    from vp8oclenc_tpu_torch.ops import cuda_build

    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    logs = cuda_build.build_all()
    log(f"[build] {len(logs)} CUDA sources in {time.monotonic() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if not packer.available():
        raise AssertionError("the native host packer did not build")
    log("[device] integer instruction rate")
    phase_int_rate(dev)

    log("[kernels] CUDA kernel vs plain version at 1920x1088")
    rows = phase_kernels(dev)
    log("[kernels] row pipelines at the edges of their shapes")
    phase_row_shapes(dev)
    log("[kernels] search kernels vs plain versions, 1920x1088 pyramids")
    rows.update(phase_search(dev))
    log("[kernels] luma trial kernel vs plain version, 8160 MBs")
    rows.update(phase_trial(dev))
    log("[kernels] integer SSIM kernel vs plain version, 8160 MBs")
    rows["mb_ssim"], ssim_uhd, ssim_wide = phase_ssim(dev)
    log("[kernels] transform pass and chroma trial kernels vs plain "
        "versions, 8160, 32400 and 8192 MBs")
    tp_rows, tp_uhd, tp_wide = phase_transform(dev)
    rows.update(tp_rows)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[end-to-end] Encoder.encode_frames, gop_size=1")
    g1_launches = phase_end_to_end(dev)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[end-to-end] Encoder.encode_frames, default GOP")
    launches = phase_default_gop(dev)
    log(f"  all-keyframe path launches: {json.dumps(g1_launches)}")
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[end-to-end] Encoder.encode_frames, SSIM target")
    ssim_launches = phase_ssim_target(dev)
    for name in ("trial_luma", "trial_chroma_merge", "mb_ssim"):
        launches[name] = ssim_launches[name]
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[end-to-end] redo-as-key with frames in flight")
    phase_redo(dev)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[kernels] search kernels on row-shard strips vs plain versions")
    modes = phase_shard_search(dev)
    log("[kernels] loop filter in band mode vs plain and whole-plane")
    modes.update(phase_band_filter(dev))
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[end-to-end] multi-rank encodes (parallel/), ranks sharing the card")
    multi = phase_multirank(dev)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log("[quality] the 1080p row of bench_quality.json, decoded by the "
        "port's decoder; the spec backend against the card")
    quality = phase_quality(dev)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log(f"[uhd] the six kernels at {UHD_W}x{UHD_H} vs plain versions")
    uhd_rows = phase_uhd_kernels(dev)
    uhd_rows["mb_ssim"] = ssim_uhd
    uhd_rows.update(tp_uhd)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log(f"[uhd] Encoder.encode_frames at {UHD_W}x{UHD_H}, 4 partitions, 6 "
        f"threads: default GOP, SSIM target; 4 ranks over 2 x 2 row tiles")
    uhd, uhd_launches = phase_uhd_streams(dev)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log(f"[wide] the six kernels at {WIDEST_W}x{WIDEST_H}, the filter and "
        f"luma at {WIDE_W}x{WIDE_STRIP_H} and timed at {WIDE_W}x{WIDE_H}")
    wide_rows = phase_wide_kernels(dev)
    wide_rows["mb_ssim"] = ssim_wide
    wide_rows.update(tp_wide)
    log(f"[time] {time.monotonic() - t0:.0f} s")
    log(f"[wide] Encoder.encode_frames at {WIDE_W}x{WIDE_STRIP_H} against "
        f"the CPU, and {N_WIDE_FRAMES} frames of {WIDE_W}x{WIDE_H}, 4 "
        f"partitions, 6 threads")
    wide, wide_launches = phase_wide_streams(dev)
    log(f"[time] {time.monotonic() - t0:.0f} s")

    src = {"luma_wavefront": "vp8oclenc_tpu_torch/csrc/intra.cu",
           "chroma_wavefront": "vp8oclenc_tpu_torch/csrc/intra.cu",
           "loop_filter": "vp8oclenc_tpu_torch/csrc/loopfilter.cu",
           "fullpel_search": "vp8oclenc_tpu_torch/csrc/search.cu",
           "qpel_search": "vp8oclenc_tpu_torch/csrc/search.cu",
           "trial_luma": "vp8oclenc_tpu_torch/csrc/intra.cu",
           "mb_ssim": "vp8oclenc_tpu_torch/csrc/ssim.cu",
           "inter_pass": "vp8oclenc_tpu_torch/csrc/transform.cu",
           "trial_chroma_merge": "vp8oclenc_tpu_torch/csrc/transform.cu"}
    replaces = {"luma_wavefront": "vp8oclenc_tpu/ops/pallas_intra.py:309",
                "chroma_wavefront": "vp8oclenc_tpu/ops/pallas_intra.py:580",
                "loop_filter": "vp8oclenc_tpu/ops/loopfilter.py:96",
                "fullpel_search": "vp8oclenc_tpu/ops/pallas_kernels.py:265",
                "qpel_search": "vp8oclenc_tpu/ops/pallas_kernels.py:396",
                "trial_luma": "vp8oclenc_tpu/ops/pallas_intra.py:457",
                "mb_ssim": "vp8oclenc_tpu/ssim_fx.py (XLA ops, no Pallas "
                           "kernel)",
                "inter_pass": "vp8oclenc_tpu/ops/inter.py:922 (seg_pass, "
                              "XLA ops)",
                "trial_chroma_merge": "vp8oclenc_tpu/ops/intra_replace.py:"
                                      "226-243 (the trial loop's body after "
                                      "the luma trial, XLA ops)"}
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "kernel": global_kernel(name, W),
            "route": "cuda", "source": src[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": statistics.median(r["ms"]),
            "plain_ms": statistics.median(r["plain_ms"]),
            "bound_ms": max(r["bound_ms"]), "bound_by": r["bound_by"],
            "library_ms": None, "bit_exact": r["max_abs_err"] == 0})
        if "chain_ms" in r:
            kernels[-1]["chain_ms"] = statistics.median(r["chain_ms"])
        if "planes_ms" in r:          # mb_ssim: timed in the trials' form
            kernels[-1].update(form=r["form"], planes_ms=r["planes_ms"])
        if name in ("mb_ssim", "inter_pass"):   # SSIM-on: 0 and 4 a frame
            kernels[-1]["launches_ssim_target"] = ssim_launches[name]
        if name == "mb_ssim":         # held and timed here, on no path
            kernels[-1]["on_encoder_path"] = False
        kernels[-1]["multirank_launches"] = multi[name]
        if name in modes:       # the kernel's row-shard or band mode
            mode = dict(modes[name], launches=multi[
                "loop_filter_band" if name == "loop_filter"
                else name + "_shard"])
            kernels[-1]["band_mode" if name == "loop_filter"
                        else "shard_mode"] = mode
        kernels[-1]["uhd"] = dict(uhd_rows[name], kernel=global_kernel(
            name, UHD_W), launches={stream: n[name] for stream, n in
                                    uhd_launches.items()})
        kernels[-1]["wide"] = dict(wide_rows[name], kernel=global_kernel(
            name, WIDEST_W), launches_8k=wide_launches[name])
        if "8k" in wide_rows[name]:   # the kernels this slice changed
            by = kernels[-1]["wide"]["ms_by_kernel"] = {}
            for width, size, ms in (
                    (W, "1920x1088", statistics.median(r["ms"])),
                    (UHD_W, f"{UHD_W}x{UHD_H}", uhd_rows[name]["ms"]),
                    (WIDE_W, f"{WIDE_W}x{WIDE_H}",
                     wide_rows[name]["8k"]["ms"])):
                by.setdefault(global_kernel(name, width), {})[size] = ms
    print(json.dumps({"quality": quality}), flush=True)
    print(json.dumps({"uhd": uhd}), flush=True)
    print(json.dumps({"wide": wide}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
