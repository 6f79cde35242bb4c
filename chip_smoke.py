"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every kernel of csrc/ with nvcc (one process per source, in
     parallel), and the host entropy packer with g++;
  3. kernels: each intra and loop-filter kernel against its plain PyTorch
     version on the same card at 1920x1088, on synthetic planes made from a
     seed at two quantizer pairs; then the full-pel and quarter-pel search
     kernels against theirs on the real pyramid levels 4..0 of two
     contents (a panned canvas searched level by level, and noise searched
     from random vectors that reach past the frame edges); outputs must be
     bit-identical; both are timed with CUDA events;
  4. all-keyframe path: 10 synthetic 1920x1080 frames through
     Encoder.encode_frames with gop_size=1 on cuda, with each kernel's
     launch counter set to 0 before and read after; then the first 2
     frames again with the plain versions on the CPU, whose bytes must be
     identical;
  5. default-GOP path: 10 frames of a panned canvas with gop_size=150,
     altref_range=5 (1 keyframe, then inter frames over LAST, GOLDEN and
     ALTREF), counters as in 4; at least 8 inter frames, every kernel
     launched, some vectors nonzero and GOLDEN or ALTREF chosen somewhere;
     the inter device-chain time and the sequential host split; the first 3
     frames again on the CPU, whose bytes must be identical;
  6. a `kernels` JSON line, the nvidia-smi line, and as the last line
     {"ok": true, "device": {...}}.
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
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor-core peak (fp32 figure)
W, H = 1920, 1080
QI_PAIRS = (10, 40)           # keyframe quantizer indices held to the plain
N_FRAMES, N_CPU_FRAMES = 10, 2
N_CPU_GOP_FRAMES = 3          # 1 keyframe and 2 inter frames

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
# candidate outside the frame is only bounds-checked (~12).  A qpel block
# shares its 5 horizontal six-tap passes (5 x 14 x 8 outputs at ~15: six
# multiply-adds, round, clamp, store) among its candidates; each qpel
# candidate adds its vertical pass (64 x 15) to the cost; the zero vector
# adds a 64-pixel copy.
OPS_COST8 = 64 + 4 * 128 + 4 * 34 + 12
OPS_INVALID = 12
OPS_QPEL_HPASS = 5 * 14 * 8 * 15
OPS_QPEL_VPASS = 64 * 15


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


def synth_moving(n, seed=0):
    """A smooth, textured canvas panned by 3-4 pixels across and 2 down per
    frame, with a little fresh noise: a real inter stream.  (Independent
    noise per frame, as `synth_frames` makes, trips the chroma
    scene-change detector and turns every frame into a keyframe.)"""
    from vp8oclenc_tpu_torch.io.y4m import Frame
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H + 64, 0:W + 64]
    smooth = 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0) \
        + 40 * np.sin((xx + 2 * yy) / 91.0)
    luma = 120 + smooth + rng.integers(0, 48, smooth.shape)
    cu = 128 + 0.5 * smooth[::2, ::2]
    cv = 128 - 0.4 * smooth[1::2, 1::2]
    out = []
    for t in range(n):
        oy, ox = 2 * t, 3 * t + (t % 2)
        cut = lambda a, y0, x0, h, w, e: (
            a[y0:y0 + h, x0:x0 + w] + rng.integers(-e, e + 1, (h, w))) \
            .clip(0, 255).astype(np.uint8)
        out.append(Frame(cut(luma, oy, ox, H, W, 2),
                         cut(cu, oy // 2, ox // 2, H // 2, W // 2, 1),
                         cut(cv, oy // 2, ox // 2, H // 2, W // 2, 1)))
    return out


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"shape/dtype {x.shape} {x.dtype} vs "
                                 f"{y.shape} {y.dtype}")
        err = max(err, int((x.to(torch.int32) - y.to(torch.int32))
                           .abs().max()))
    return err


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
            ms = cuda_ms(kfn, reps=10)
            pms = cuda_ms(pfn, reps=1, warm=0)
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
    return rows


def _fullpel_counts(v0, Hl, Wl):
    """(valid, invalid) candidate counts of one full-pel launch: the
    work its data needs (invalid candidates are only bounds-checked)."""
    from vp8oclenc_tpu_torch.ops.inter import _block_origins
    cy, cx = _block_origins(Hl // 8, Wl // 8, v0.device)
    d = torch.arange(-2, 3, device=v0.device)
    valid = 0
    for wx, wy in ((v0[..., 0], v0[..., 1]), (0 * v0[..., 0], 0 * v0[..., 1])):
        okx = ((cx + wx)[..., None] + d >= 0) & ((cx + wx)[..., None] + d
                                                  <= Wl - 8)
        oky = ((cy + wy)[..., None] + d >= 0) & ((cy + wy)[..., None] + d
                                                  <= Hl - 8)
        valid += int((okx.sum(-1) * oky.sum(-1)).sum())
    return valid, v0.shape[0] * v0.shape[1] * 50 - valid


def _qpel_valid(fv, Hl, Wl):
    """Number of in-frame qpel candidates (of 25 per job) of one launch."""
    from vp8oclenc_tpu_torch.ops.inter import _block_origins
    cy, cx = _block_origins(Hl // 8, Wl // 8, fv.device)
    d = torch.arange(-2, 3, device=fv.device)
    px = ((cx + fv[..., 0]) * 4)[..., None] + d
    py = ((cy + fv[..., 1]) * 4)[..., None] + d
    okx = ((px >= 0) & (px <= Wl * 4 - 32)).sum(-1)
    oky = ((py >= 0) & (py <= Hl * 4 - 32)).sum(-1)
    return int((okx * oky).sum())


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

    contents = {"moving": synth_moving(4, seed=3),
                "edges": synth_frames(4, seed=5)}
    rows = {}
    for ci, (label, frames) in enumerate(contents.items()):
        planes = [torch.from_numpy(pad_frame(f).y).to(dev) for f in frames]
        cur = IN.build_pyramid(planes[3])
        refs = [torch.stack(lv).contiguous() for lv in
                zip(*(IN.build_pyramid(p) for p in planes[:3]))]
        rng = np.random.default_rng(ci)
        fp = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0,
              "bytes": 0, "ops": 0}
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
            pms = cuda_ms(lambda: IN.fullpel_search_plain(c, r, v0, pen),
                          reps=1, warm=0)
            valid, invalid = _fullpel_counts(v0, Hl, Wl)
            nbytes = c.numel() + r.numel() + 2 * v0.numel() * 4
            ops = valid * OPS_COST8 + invalid * OPS_INVALID
            bms, by = bound(nbytes, ops)
            log(f"  fullpel_search {label} level {lvl} ({Wl}x{Hl}, "
                f"{v0.shape[1]} blocks x 3 refs, {valid} of "
                f"{valid + invalid} candidates in frame): bit-exact, kernel "
                f"{ms:.4f} ms, plain {pms:.1f} ms, bound {bms:.5f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                             ("bytes", nbytes), ("ops", ops)):
                fp[key] += val
            vec = (k * rate).reshape(3, nby, nbx, 2)
        c, r = cur[0], refs[0]
        Hl, Wl = c.shape
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
        pms = cuda_ms(lambda: IN.qpel_search_plain(c, r, fv), reps=1, warm=0)
        jobs = fv.shape[0] * fv.shape[1]
        valid = _qpel_valid(fv, Hl, Wl)
        nbytes = c.numel() + r.numel() + fv.numel() * 4 + jobs * (8 + 4 + 64)
        ops = jobs * (OPS_QPEL_HPASS + OPS_COST8 + 64) \
            + valid * (OPS_QPEL_VPASS + OPS_COST8) \
            + (jobs * 25 - valid) * OPS_INVALID
        bms, by = bound(nbytes, ops)
        moved = float((k[0] != 0).any(-1).float().mean())
        log(f"  qpel_search {label} ({jobs} jobs, {valid} of {jobs * 25} "
            f"qpel candidates in frame, {moved:.1%} nonzero vectors): "
            f"bit-exact, kernel {ms:.4f} ms, plain {pms:.1f} ms, bound "
            f"{bms:.5f} ms ({by})")
        fbms, fby = bound(fp["bytes"], fp["ops"])
        log(f"  fullpel_search {label}, 5 levels: kernel {fp['ms']:.4f} ms, "
            f"plain {fp['plain_ms']:.1f} ms, bound {fbms:.5f} ms ({fby})")
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
    key_ms = [cuda_ms(lambda: probe.backend.encode_intra_frame(
        p.y, p.u, p.v, seg, yuv_dev=yuv), reps=1, warm=0) for _ in range(5)]
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

    t1 = time.monotonic()
    cpu = Encoder(EncoderConfig(**cfg), W, H, device="cpu")
    ref = list(cpu.encode_frames(frames[:N_CPU_FRAMES]))
    cpu.close()
    log(f"  plain CPU encode of {N_CPU_FRAMES} frames: "
        f"{time.monotonic() - t1:.1f} s")
    for i, (a, b) in enumerate(zip(out, ref)):
        if a != b:
            raise AssertionError(f"frame {i}: card bytes differ from the "
                                 f"plain CPU bytes")
    log(f"  first {N_CPU_FRAMES} frames byte-identical to the plain CPU "
        f"stream")
    return launches


def phase_default_gop(dev):
    """The default encode: gop_size=150, altref_range=5, SSIM control off,
    10 frames of the panned canvas (1 keyframe, then inter frames)."""
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
                "qpel_search": IN.qpel_search}
    enc = Encoder(EncoderConfig(**cfg), W, H, device=dev)
    for c in counters.values():
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
    inter_ms = [cuda_ms(lambda: probe.backend.encode_inter_frame(
        probe, p.y, p.u, p.v, seg, False, False, yuv_dev=yuv), reps=1,
        warm=0) for _ in range(5)]
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

    t1 = time.monotonic()
    cpu = Encoder(EncoderConfig(**cfg), W, H, device="cpu")
    ref = list(cpu.encode_frames(frames[:N_CPU_GOP_FRAMES]))
    cpu.close()
    log(f"  plain CPU encode of {N_CPU_GOP_FRAMES} frames: "
        f"{time.monotonic() - t1:.1f} s")
    for i, (a, b) in enumerate(zip(out, ref)):
        if a != b:
            raise AssertionError(f"default-GOP frame {i}: card bytes differ "
                                 f"from the plain CPU bytes")
    log(f"  first {N_CPU_GOP_FRAMES} frames (1 key, 2 inter) byte-identical "
        f"to the plain CPU stream")
    return launches


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

    log("[kernels] CUDA kernel vs plain version at 1920x1088")
    rows = phase_kernels(dev)
    log("[kernels] search kernels vs plain versions, 1920x1088 pyramids")
    rows.update(phase_search(dev))
    log("[end-to-end] Encoder.encode_frames, gop_size=1")
    g1_launches = phase_end_to_end(dev)
    log("[end-to-end] Encoder.encode_frames, default GOP")
    launches = phase_default_gop(dev)
    log(f"  all-keyframe path launches: {json.dumps(g1_launches)}")

    src = {"luma_wavefront": "vp8oclenc_tpu_torch/csrc/intra.cu",
           "chroma_wavefront": "vp8oclenc_tpu_torch/csrc/intra.cu",
           "loop_filter": "vp8oclenc_tpu_torch/csrc/loopfilter.cu",
           "fullpel_search": "vp8oclenc_tpu_torch/csrc/search.cu",
           "qpel_search": "vp8oclenc_tpu_torch/csrc/search.cu"}
    replaces = {"luma_wavefront": "vp8oclenc_tpu/ops/pallas_intra.py:309",
                "chroma_wavefront": "vp8oclenc_tpu/ops/pallas_intra.py:580",
                "loop_filter": "vp8oclenc_tpu/ops/loopfilter.py:96",
                "fullpel_search": "vp8oclenc_tpu/ops/pallas_kernels.py:265",
                "qpel_search": "vp8oclenc_tpu/ops/pallas_kernels.py:396"}
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": statistics.median(r["ms"]),
            "plain_ms": statistics.median(r["plain_ms"]),
            "bound_ms": max(r["bound_ms"]), "bound_by": r["bound_by"],
            "library_ms": None, "bit_exact": r["max_abs_err"] == 0})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
