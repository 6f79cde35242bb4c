"""Times of the port's six CUDA kernels at 1920x1088 on one NVIDIA GPU,
by the card's clock, for comparing two trees on the same card in one
command.

    python3 tools/time_kernels_cuda.py [--root DIR] [--uhd] [--only A,B]

`--root` names the checkout whose `vp8oclenc_tpu_torch` is timed
(default: the one this file is in), so an older tree unpacked beside
this one can be run in turns with it.  Inputs are chip_smoke.py's, made
from seeds: the padded synthetic frame at qi 10 for the intra kernels
and the filter; the panned canvas's pyramid with the vectors of a real
hierarchical search for the searches, the full-pel search at each of its
five levels 4..0; the luma trial on that frame's MBs with neighbours
from its reconstruction, at the AQ, HQ and UQ quantizers of -qmin 50
-qmax 112.  Every kernel is held against its plain version first
(bit-exact or the run fails), then timed by chip_smoke.cuda_ms (20
launches queued behind a sleep of the card, so the CUDA events time the
card, not the host's issue), three times; the line printed is one JSON
object with the least and the median of the three for each kernel, and
the card's name and power limit.  `--uhd` adds the three row kernels
(luma, chroma, loop filter) at 3840x2160 on chip_smoke.py's [uhd] inputs:
`*_uhd` on the whole frame, timed only (the plain versions take 10-20 s
there), and `*_uhd_strip` on its top 4 MB rows, held and timed as the
others.  The cases `*_row1920` time the three row kernels on one MB row
of the 1080p frame (1920x16), which no row above holds up: their time
over the row's steps is a step's latency (chip_smoke.py's chain figure).
The cases `seg_pass_first` and `seg_pass_masked` time one segment pass
of the inter frame as `inter_body` runs it, with its MBs' SSIM and the
cur_ssim merge, on chip_smoke.py's pass inputs at the first segment's
quantizers of -qmin 50 -qmax 112: the first pass (every MB; the SSIM-off
frame's only pass) and a later one over the MBs whose score is at or
below the median (about half; the pass recodes them at the same
quantizers, so the mask holds from launch to launch).  For a tree whose
`inter_pass` takes `cur_ssim` as an argument (before the pass scored its
MBs) that is `inter_pass`, `ssim_fx.mb_ssim_fx` and, in the later pass,
a `torch.where`.  `mb_ssim_trial` times the integer SSIM on the SSIM
controller's trial operands (u8 source patches, u8 luma and int32 chroma
recon patches) with chip_smoke.py's edge MBs.  `--uhd` adds the three at
3840x2160 (`*_uhd`).  `intra_replace_some` and `intra_replace_none` time
the SSIM controller as a whole (`ops/intra_replace.intra_replace_device`:
three luma and three chroma trials with their scores and merges, and the
suppression) on chip_smoke.py's pass inputs after the first pass, at
-qmin 50 -qmax 112's segment quantizers: with the pass's median score as
the target (half the MBs active; a few of them win: the trials rarely
beat the pass on these inputs) and with a target below every score (no
MB active, none wins), 5 calls behind each sleep of the card; `--uhd`
adds both at 3840x2160.  `trial_chroma_merge_half` times the chroma
trial's kernel with its score and merge alone, the first trial as
chip_smoke.py times it (the pass's median score as the target: half the
MBs active, none of them winning on these inputs),
`trial_chroma_merge_none` with every MB active at the highest score
there is (none wins) and `trial_chroma_merge_all` with every MB active
far below any score (every MB wins and stores its trial), each held
against its plain version (a tree without the kernel has none of
them); `--uhd` adds the three at 3840x2160.  Every
case also gets `issue_ms`, the host's time to issue one
call with the card idle (median of 20, no synchronization inside).  Each
case's name goes to stderr as it starts.
`--only` keeps the cases whose names start with one of the given
prefixes (`--only luma_wavefront,loop_filter`).
"""
from __future__ import annotations

import argparse
import copy
import inspect
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--uhd", action="store_true")
    ap.add_argument("--only", default="")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    if not torch.cuda.is_available():
        print("time_kernels_cuda: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from chip_smoke import (cuda_ms, max_abs_err, nvidia_smi_line,
                            synth_frames, synth_moving)
    sys.path.insert(0, root)          # the tree under test goes first
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.ops import loopfilter as LF
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    import vp8oclenc_tpu_torch
    if not os.path.abspath(vp8oclenc_tpu_torch.__file__).startswith(root):
        raise AssertionError("the package did not come from --root")
    # every library built first: a build inside a timed call's warm-up
    # would size cuda_ms's sleep of the card from the build's minutes
    from vp8oclenc_tpu_torch.ops import cuda_build
    cuda_build.build_all()

    dev = torch.device("cuda", 0)
    f = pad_frame(synth_frames(1, seed=7)[0])
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    mbc = (y.shape[0] // 16) * (y.shape[1] // 16)
    seg = prepare_segments(EncoderConfig(qi_min=10, qi_max=10), f.y, True,
                           True)
    yq = (int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))
    cq = (int(seg.uv_dc_q[0]), int(seg.uv_ac_q[0]))
    lf = [torch.as_tensor(np.asarray(a, np.int32), device=dev) for a in
          (seg.loop_filter_level, seg.mbedge_limit, seg.sub_bedge_limit,
           seg.interior_limit, seg.hev_threshold)]
    sid = torch.zeros(mbc, dtype=torch.int32, device=dev)
    inner = torch.ones(mbc, dtype=torch.uint8, device=dev)
    rec_y = I.luma_wavefront(y, *yq)[0]
    rec_uv = I.chroma_wavefront(uv, *cq)[0]
    planes = (rec_y, rec_uv[0].contiguous(), rec_uv[1].contiguous())

    mv = [torch.from_numpy(pad_frame(g).y).to(dev)
          for g in synth_moving(4, seed=3)]
    cur = IN.build_pyramid(mv[3])
    refs = [torch.stack(lv).contiguous()
            for lv in zip(*(IN.build_pyramid(p) for p in mv[:3]))]
    levels = {}                       # level: (cur, refs, v0, penalty)
    vec = None
    for lvl, rate in ((4, 16), (3, 8), (2, 4), (1, 2), (0, 1)):
        h, w = cur[lvl].shape
        v0 = IN.inherit_vectors(vec, 3, h // 8, w // 8, rate, dev)
        levels[lvl] = (cur[lvl], refs[lvl], v0, rate < 4)
        vec = (IN.fullpel_search(*levels[lvl]) * rate).reshape(
            3, h // 8, w // 8, 2)
    fv = vec.reshape(3, -1, 2).contiguous()
    ftop, fleft = IR._frozen_luma_neighbors(rec_y, y.shape[1] // 16,
                                            y.shape[0] // 16)
    y_mb = IR._plane_mb(y, 16).contiguous()
    sseg = prepare_segments(EncoderConfig(qi_min=50, qi_max=112,
                                          ssim_target=0.98), f.y, False,
                            False)

    tup = lambda r: r if isinstance(r, (tuple, list)) else (r,)
    cases = {
        "qpel_search": (lambda: IN.qpel_search(cur[0], refs[0], fv),
                        lambda: IN.qpel_search_plain(cur[0], refs[0], fv)),
        "chroma_wavefront": (lambda: I.chroma_wavefront(uv, *cq),
                             lambda: I.chroma_wavefront_plain(uv, *cq)),
        "luma_wavefront": (lambda: I.luma_wavefront(y, *yq),
                           lambda: I.luma_wavefront_plain(y, *yq)),
        "loop_filter": (
            lambda: LF.filter_planes(*planes, sid, inner, *lf),
            lambda: LF.filter_planes_plain(*planes, sid, inner, *lf)),
    }
    y1, uv1 = y[:16].contiguous(), uv[:, :8].contiguous()
    row = [p_[:n].contiguous() for p_, n in zip(planes, (16, 8, 8))]
    mbw = y.shape[1] // 16
    cases.update({
        "luma_wavefront_row1920": (lambda: I.luma_wavefront(y1, *yq),
                                   lambda: I.luma_wavefront_plain(y1, *yq)),
        "chroma_wavefront_row1920": (
            lambda: I.chroma_wavefront(uv1, *cq),
            lambda: I.chroma_wavefront_plain(uv1, *cq)),
        "loop_filter_row1920": (
            lambda: LF.filter_planes(*row, sid[:mbw], inner[:mbw], *lf),
            lambda: LF.filter_planes_plain(*row, sid[:mbw], inner[:mbw],
                                           *lf))})
    for lvl, args in levels.items():
        cases[f"fullpel_search_level{lvl}"] = (
            lambda a=args: IN.fullpel_search(*a),
            lambda a=args: IN.fullpel_search_plain(*a))
    for name, s_ in (("aq", 2), ("hq", 1), ("uq", 0)):
        q = (int(sseg.y_dc_q[s_]), int(sseg.y_ac_q[s_]))
        cases[f"trial_luma_{name}"] = (
            lambda q=q: IR.trial_luma(y_mb, ftop, fleft, *q),
            lambda q=q: IR.trial_luma_plain(y_mb, ftop, fleft, *q))
    cases.update(_ssim_cases(dev, y.shape[1] // 16, y.shape[0] // 16, ""))
    cases.update(_replace_cases(dev, y.shape[1] // 16, y.shape[0] // 16, ""))
    if opts.uhd:
        cases.update(_uhd_cases(dev))
        from chip_smoke import UHD_H, UHD_W
        cases.update(_ssim_cases(dev, UHD_W // 16, UHD_H // 16, "_uhd"))
        cases.update(_replace_cases(dev, UHD_W // 16, UHD_H // 16, "_uhd"))
    if opts.only:
        keep = tuple(opts.only.split(","))
        cases = {k: v for k, v in cases.items() if k.startswith(keep)}
    out = {"root": root, "card": nvidia_smi_line(), "ms": {}}
    for name, (kfn, pfn) in cases.items():
        print(f"time_kernels_cuda: {name}", file=sys.stderr, flush=True)
        err = 0 if pfn is None else max_abs_err(tup(kfn()), tup(pfn()))
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")
        # a call of the controller issues tens to a hundred launches: 20
        # of them queued behind the card's sleep overflow its launch queue
        reps = 5 if name.startswith("intra_replace") else 20
        ms = [cuda_ms(kfn, reps=reps) for _ in range(3)]
        out["ms"][name] = {"min": min(ms), "median": statistics.median(ms),
                           "issue_ms": _issue_ms(kfn)}
    if all(f"fullpel_search_level{lvl}" in out["ms"] for lvl in levels):
        out["ms"]["fullpel_search_5_levels"] = {
            k: sum(out["ms"][f"fullpel_search_level{lvl}"][k]
                   for lvl in levels) for k in ("min", "median")}
    print(json.dumps(out), flush=True)
    return 0


def _ssim_cases(dev, mbw, mbh, suffix):
    """{name: (kernel, plain)} for one segment pass with its SSIM, first
    and masked (see the module's docstring), and the SSIM on the trials'
    operands, at mbw x mbh MBs.  A masked call updates its state in
    place: the kernel and the plain version each get their own copy."""
    from chip_smoke import SSIM_CFG, _pass_inputs, _ssim_forms, _ssim_inputs
    from vp8oclenc_tpu_torch import ssim_fx as S
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    src, pred, parts, _ = _pass_inputs(mbw, mbh, mbw + mbh, dev)
    seg = prepare_segments(EncoderConfig(**SSIM_CFG), src[0].cpu().numpy(),
                           False, False)
    q = [int(a[3]) for a in (seg.y_dc_q, seg.y_ac_q, seg.y2_dc_q,
                             seg.y2_ac_q, seg.uv_dc_q, seg.uv_ac_q)]
    y, u, v = src
    fused = "cur_ssim" not in inspect.signature(IN.inter_pass).parameters

    def first(pass_, ssim):
        state = pass_(*src, *pred, parts, 3, q)
        return state if fused else (*state, ssim(y, state[2], u, state[3],
                                                 v, state[4]))

    def masked(pass_, ssim, state, target):
        if fused:
            return pass_(*src, *pred, parts, 2, q, target, state)
        cur = state[-1]
        st = pass_(*src, *pred, parts, 2, q, target, cur, state[:-1])
        return (*st, torch.where(st[5], ssim(y, st[2], u, st[3], v, st[4]),
                                 cur))

    start = first(IN.inter_pass, S.mb_ssim_fx)
    target = int(start[-1].float().median())
    k_state, p_state = start, copy.deepcopy(start)
    sf, sr = _ssim_inputs(mbw, mbh, mbw + mbh, dev)
    trial = {label: a for label, _, _, a in _ssim_forms(sf, sr)}["patches"]
    return {
        "seg_pass_first" + suffix: (
            lambda: first(IN.inter_pass, S.mb_ssim_fx),
            lambda: first(IN.inter_pass_plain, S.mb_ssim_fx_plain)),
        "seg_pass_masked" + suffix: (
            lambda: masked(IN.inter_pass, S.mb_ssim_fx, k_state, target),
            lambda: masked(IN.inter_pass_plain, S.mb_ssim_fx_plain, p_state,
                           target)),
        "mb_ssim_trial" + suffix: (
            lambda: S.mb_ssim_fx_16x16(*trial),
            lambda: S.mb_ssim_fx_16x16_plain(*trial))}


def _issue_ms(fn, reps=20):
    """The host's time (ms) to issue one call of fn with the card idle:
    the median of reps calls, each after a synchronization."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _replace_cases(dev, mbw, mbh, suffix):
    """{name: (call, plain or None)}: `intra_replace_device` on the state
    of a first segment pass at mbw x mbh MBs, with the pass's median score
    as the target (some MBs win) and with one below every score (none is
    active); both trees keep its signature, and it has no plain version of
    its own (its kernels are held against theirs elsewhere).  For a tree
    with it, the chroma trial's kernel with its score and merge alone (the
    first trial's quantizers) against its plain version: the median as
    the target, and every MB active at the highest score."""
    from chip_smoke import SSIM_CFG, _pass_inputs
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra_replace as IR
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    src, pred, parts, _ = _pass_inputs(mbw, mbh, mbw + mbh, dev)
    seg = prepare_segments(EncoderConfig(**SSIM_CFG), src[0].cpu().numpy(),
                           False, False)
    quant = [[int(x) for x in a] for a in (seg.y_dc_q, seg.y_ac_q,
                                            seg.y2_dc_q, seg.y2_ac_q,
                                            seg.uv_dc_q, seg.uv_ac_q)]
    state = IN.inter_pass(*src, *pred, parts, 3, [q[3] for q in quant])
    ry, ru, rv, cur = *state[2:5], state[6]
    y_dc, y_ac, _, _, uv_dc, uv_ac = quant

    def run(target):
        return IR.intra_replace_device(*src, ry, ru, rv, cur, y_dc, y_ac,
                                       uv_dc, uv_ac, target, mbw, mbh)

    some, none = int(cur.float().median()), int(cur.min()) - 1
    cases = {"intra_replace_some" + suffix: (lambda: run(some), None),
             "intra_replace_none" + suffix: (lambda: run(none), None)}
    if not hasattr(IR, "trial_chroma_merge"):
        return cases
    from chip_smoke import LOW_SCORE, MAX_SCORE, _merge_inputs
    y_mb, ftop, fleft, planes = _merge_inputs(src, pred)
    luma = IR.trial_luma(y_mb, ftop, fleft, y_dc[2], y_ac[2])
    top = torch.full_like(cur, MAX_SCORE)
    low = torch.full_like(cur, LOW_SCORE)

    def merge(fn, c, target):
        st = IR.merge_state(mbw * mbh, dev)
        return lambda: fn(y_mb, luma, *planes, (None, None), c, st, 2,
                          uv_dc[2], uv_ac[2], target) or list(st.values())

    for name, c, target in (("half", cur, some), ("none", top, MAX_SCORE),
                            ("all", low, MAX_SCORE)):
        cases[f"trial_chroma_merge_{name}{suffix}"] = (
            merge(IR.trial_chroma_merge, c, target),
            merge(IR.trial_chroma_merge_plain, c, target))
    return cases


def _uhd_cases(dev):
    """{name: (kernel, plain or None)} for the three row kernels at
    3840x2160 on chip_smoke.py's [uhd] inputs (frame 3 of the panned
    canvas at its first keyframe quantizer; the filter on the kernels'
    recon with four segments and a mixed inner-edge mask): `*_uhd` on the
    whole frame with no plain version, `*_uhd_strip` on the top 4 MB
    rows with theirs."""
    from chip_smoke import (QI_PAIRS, UHD_H, UHD_W, _filter_inputs,
                            _row_specs, synth_moving)
    from vp8oclenc_tpu_torch.config import EncoderConfig
    from vp8oclenc_tpu_torch.io.y4m import pad_frame
    from vp8oclenc_tpu_torch.ops import intra as I
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    f = pad_frame(synth_moving(4, seed=3, w=UHD_W, h=UHD_H)[3])
    y = torch.from_numpy(f.y).to(dev)
    uv = torch.from_numpy(np.stack([f.u, f.v])).to(dev)
    seg = prepare_segments(EncoderConfig(qi_min=QI_PAIRS[0],
                                         qi_max=QI_PAIRS[0]), f.y, True, True)
    rec_y = I.luma_wavefront(y, int(seg.y_dc_q[0]), int(seg.y_ac_q[0]))[0]
    rec_uv = I.chroma_wavefront(uv, int(seg.uv_dc_q[0]),
                                int(seg.uv_ac_q[0]))[0]
    planes, sid, inner, lf, on = _filter_inputs(f, rec_y, rec_uv, 5, dev)
    n = 4 * (y.shape[1] // 16)
    top = lambda t, rows: t[..., :rows, :].contiguous()
    cases = {f"{name}_uhd": (fn, None) for name, fn, _, _, _ in _row_specs(
        y, uv, seg, planes, sid, inner, lf, on)}
    for name, fn, pfn, _, _ in _row_specs(
            top(y, 64), top(uv, 32), seg,
            [top(p, r) for p, r in zip(planes, (64, 32, 32))], sid[:n],
            inner[:n], lf, on[:n]):
        cases[f"{name}_uhd_strip"] = (fn, pfn)
    return cases


if __name__ == "__main__":
    sys.exit(main())
