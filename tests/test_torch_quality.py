"""The quality curve of bench_quality.json reproduced by the port: the two
352x288 rows that tests/test_quality_curve.py pins, through
tools/quality_cuda.run_config on the CPU (every frame decoded by the port's
decoder and equal to the recon), must equal the recorded rows exactly at
their rounding."""
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import quality_cuda  # noqa: E402


@pytest.fixture(scope="module")
def recorded():
    with open(os.path.join(ROOT, "bench_quality.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("config", ["intra_qi56", "full_q24-63"])
def test_quality_row_matches_record(recorded, config):
    row = next(r for r in recorded["rows"] if r["config"] == config)
    w, h = (int(t) for t in recorded["size"].split("x"))
    frames = quality_cuda.synth_sequence(w, h, recorded["frames"], seed=0)
    cfg = {k: row[k] for k in ("qi_min", "qi_max", "gop_size",
                               "altref_range", "ssim_target") if k in row}
    spent = {}
    got = quality_cuda.run_config(config, cfg, frames, w, h, device="cpu",
                                  timings=spent)
    assert spent["decoded"] == recorded["frames"]
    assert got == row


def test_synth_sequence_is_bench_quality_sequence():
    """The port's copy makes the frames bench_quality.py makes."""
    sys.path.insert(0, ROOT)
    from bench_quality import synth_sequence
    for a, b in zip(quality_cuda.synth_sequence(96, 80, 3, seed=0),
                    synth_sequence(96, 80, 3, seed=0)):
        for p, q in zip((a.y, a.u, a.v), (b.y, b.u, b.v)):
            assert np.array_equal(p, q)


def test_hd1080_row_names_the_recorded_row(recorded):
    name, w, h, n, cfg = quality_cuda.HD1080
    row = next(r for r in recorded["hd_rows"] if r["config"] == name)
    assert (f"{w}x{h}", n) == (row["size"], row["frames"])
    assert cfg == {k: row[k] for k in cfg}


def test_metrics_match_jax_metrics():
    from vp8oclenc_tpu.utils import metrics as J
    from vp8oclenc_tpu_torch.utils import metrics as M
    rng = np.random.default_rng(1)
    src = [rng.integers(0, 256, s, dtype=np.uint8)
           for s in ((40, 56), (20, 28), (20, 28))]
    rec = [np.clip(p.astype(int) + rng.integers(-9, 10, p.shape), 0, 255)
           .astype(np.uint8) for p in src]
    assert M.frame_psnr(src, rec) == J.frame_psnr(src, rec)
    assert M.psnr(src[0], src[0]) == float("inf")
    for a, b in zip(src, rec):
        assert M.psnr(a, b) == J.psnr(a, b)
        assert M.ssim_plane(a, b) == J.ssim_plane(a, b)
        assert M.ssim_plane(a, a) == 1.0
