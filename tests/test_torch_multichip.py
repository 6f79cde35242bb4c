"""The port's multi-rank encode (parallel/encoder.py, over gloo on the
CPU) and its multi-host simulation (parallel/multihost.py) against the
sequential port encoder and the JAX package's spec encoder: the same
bytes, frame by frame."""
import io

import numpy as np
import pytest

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.decoder.vp8dec import VP8Decoder
from vp8oclenc_tpu.io.y4m import Y4MReader as JaxReader
from vp8oclenc_tpu.parallel.encoder import plan_gops as jax_plan_gops
from vp8oclenc_tpu.pipeline.encoder import Encoder as JaxEncoder
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.ivf import IVFWriter
from vp8oclenc_tpu_torch.io.y4m import Frame, Y4MReader
from vp8oclenc_tpu_torch.parallel.encoder import (encode_frames_spawned,
                                                  plan_gops)
from vp8oclenc_tpu_torch.parallel.multihost import (encode_multihost_sim,
                                                    read_frame_range,
                                                    y4m_frame_offsets)
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.test_multichip_encode import _sequence
from tests.test_multihost import _write_y4m


def _port(frames):
    return [Frame(f.y, f.u, f.v) for f in frames]


def _sequential(cfg, frames, w, h):
    """(port bytes, JAX spec bytes, replaced MBs, redone frames)."""
    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    port, replaced = [], 0
    for f in _port(frames):
        port.append(enc.encode_frame(f))
        replaced += enc.last_frame_stats["replaced"]
    enc.close()
    spec = JaxEncoder(JaxConfig(**cfg), w, h, backend="spec")
    jax_bytes = [spec.encode_frame(f) for f in frames]
    st = enc.stats
    return port, jax_bytes, replaced, \
        st.scene_changes_by_ssim + st.scene_changes_by_replaced


def redo_lane(w, h, n, at, seed):
    """Static noise with a quarter of the MBs given a fresh gradient every
    frame (the SSIM controller replaces some), constant chroma, and new
    noise from frame `at` on, which the controller turns into a key."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 255, (h, w)).astype(np.uint8) for _ in range(2)]
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    mbw = w // 16
    mbs = rng.choice(mbw * (h // 16), mbw * (h // 16) // 4, replace=False)
    yy, xx = np.mgrid[0:16, 0:16]
    out = []
    for t in range(n):
        y = bases[t >= at].copy()
        for m in mbs:
            a, b = rng.uniform(-6, 6, 2)
            oy, ox = (m // mbw) * 16, (m % mbw) * 16
            y[oy:oy + 16, ox:ox + 16] = (128 + a * (xx - 8) + b * (yy - 8)
                                         ).clip(0, 255).astype(np.uint8)
        out.append(Frame(y, u.copy(), v.copy()))
    return out


def noise(w, h, n):
    rng = np.random.default_rng(0)
    return [Frame(*(rng.integers(0, 256, s).astype(np.uint8)
                    for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))))
            for _ in range(n)]


CASES = {
    # 2 GOPs on 2 lanes of 2 tiles, LAST/GOLDEN/ALTREF in each
    "ssim-off": (128, 96, dict(qi_min=10, qi_max=36, gop_size=4,
                               altref_range=3),
                 lambda: _sequence(128, 96, 7), 2, 2),
    # replacement in both lanes; frame 6 (the second lane's) redone as a
    # key, which resets that lane's altref schedule
    "ssim-redo": (64, 64, dict(qi_min=70, qi_max=120, gop_size=5,
                               altref_range=3, ssim_target=0.99),
                  lambda: redo_lane(64, 64, 10, 7, seed=1), 2, 2),
    # noise at the finest quantizers: more escapes in an MB than the
    # wire's slots, so the bands' dense levels travel instead
    "escape-overflow": (64, 64, dict(qi_min=0, qi_max=4, gop_size=2),
                        lambda: noise(64, 64, 4), 2, 2),
    # non-square, 4 partitions, GOLDEN/ALTREF promotion, 3 tiles
    "192x96-tile3": (192, 96, dict(qi_min=8, qi_max=40, gop_size=7,
                                   altref_range=2, num_partitions=4),
                     lambda: _sequence(192, 96, 7, seed=33), 1, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multirank_stream_equals_sequential_and_jax(case):
    w, h, cfg, make, gop, tile = CASES[case]
    frames = make()
    port, jax_bytes, replaced, redone = _sequential(cfg, frames, w, h)
    assert port == jax_bytes
    if "ssim" in case and "off" not in case:
        assert replaced > 0 and redone == 1
    if case == "escape-overflow":
        from vp8oclenc_tpu_torch.ops.wire import ESC_SLOTS
        esc = (np.abs(_levels(cfg, frames[0], w, h)) > 127) \
            .reshape(-1, 400).sum(1)
        assert (esc[:8] > ESC_SLOTS).any() and (esc[8:] > ESC_SLOTS).any()
    got, launches, _s = encode_frames_spawned(
        EncoderConfig(**cfg), _port(frames), w, h, gop * tile, "gloo",
        "cpu", gop=gop, tile=tile)
    assert len(got) == len(frames)
    for i, (a, b) in enumerate(zip(port, got)):
        assert a == b, f"frame {i}: {len(a)}B vs {len(b)}B"
    assert not any(launches.values())          # the CPU runs no kernel
    dec = VP8Decoder()
    for p in got:
        dec.decode_frame(p)


def _levels(cfg, f, w, h):
    """A keyframe's levels, as the sequential encoder codes them."""
    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    fd, seg = enc._frame_pixels(f)
    enc._finalize_fd(fd, seg)
    enc.close()
    return fd.levels


def test_plan_gops_equals_jax(tmp_path):
    """The pre-pass over a hard cut (a scene-change key) and periodic keys
    gives the JAX package's plan."""
    path = str(tmp_path / "cut.y4m")
    _write_y4m(path, 96, 80, 13)
    with open(path, "rb") as fh:
        frames = list(JaxReader(fh))
    for gop_size, n_gops in ((4, 4), (100, 2)):
        jp = jax_plan_gops(JaxConfig(gop_size=gop_size), frames, 96, 80)
        pp = plan_gops(EncoderConfig(gop_size=gop_size), _port(frames), 96,
                       80)
        assert [len(g) for g in pp] == [len(g) for g in jp]
        assert len(pp) == n_gops           # 100: the cut starts a GOP
        for a, b in zip(pp, jp):
            for fa, fb in zip(a, b):
                assert np.array_equal(fa.y, fb.y)


@pytest.mark.parametrize("hosts,ranks,size", [(2, 1, (96, 80)),
                                              (2, 2, (96, 64))])
def test_multihost_sim_byte_identical(tmp_path, hosts, ranks, size):
    """Hosts (one process each, on the CPU; a gloo pair of ranks each in
    the last case) ingest only their GOPs' frame ranges; the merged
    stream equals the sequential encoder's, as an IVF file too."""
    w, h = size
    path = str(tmp_path / "in.y4m")
    _write_y4m(path, w, h, 9)
    cfg = dict(qi_min=10, qi_max=36, gop_size=4, altref_range=2)
    with open(path, "rb") as fh:
        frames = list(Y4MReader(fh))
    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    want = [enc.encode_frame(f) for f in frames]
    enc.close()
    got = encode_multihost_sim(EncoderConfig(**cfg), path, hosts,
                               device="cpu", ranks_per_host=ranks)
    assert got == want

    def ivf(payloads):
        buf = io.BytesIO()
        wr = IVFWriter(buf, w, h, framerate=30, timescale=1)
        for p in payloads:
            wr.write_frame(p)
        wr.finalize()
        return buf.getvalue()

    assert ivf(got) == ivf(want)


def test_range_ingest_reads_only_its_range(tmp_path, monkeypatch):
    """A range is one seek and its own records: the bytes read are the
    header's and the range's frame records, nothing else."""
    w, h = 64, 48
    path = str(tmp_path / "r.y4m")
    _write_y4m(path, w, h, 7, seed=8)
    hdr, rec, n, ww, hh = y4m_frame_offsets(path)
    assert (n, ww, hh) == (7, w, h)
    with open(path, "rb") as fh:
        all_frames = list(Y4MReader(fh))
    read = []
    real_open = open

    class Counting:
        def __init__(self, fh):
            self.fh = fh

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self.fh.close()

        def __getattr__(self, k):
            return getattr(self.fh, k)

        def seek(self, pos):
            read.append(("seek", pos))
            return self.fh.seek(pos)

        def read(self, k=-1):
            b = self.fh.read(k)
            read.append(("read", len(b)))
            return b

    monkeypatch.setattr("builtins.open",
                        lambda p, m="r", *a, **k: Counting(real_open(p, m))
                        if p == path and "b" in m else real_open(p, m, *a,
                                                                 **k))
    part, _, _ = read_frame_range(path, 3, 2)
    monkeypatch.undo()
    assert np.array_equal(part[0].y, all_frames[3].y)
    assert np.array_equal(part[1].v, all_frames[4].v)
    assert ("seek", hdr + 3 * rec) in read
    assert sum(k for op, k in read if op == "read") == 2 * (w * h * 3 // 2)


def _blank(w, h, n):
    return [Frame(np.zeros((h, w), np.uint8), np.zeros((h // 2, w // 2),
                                                       np.uint8),
                  np.zeros((h // 2, w // 2), np.uint8)) for _ in range(n)]


def test_spawned_encode_needs_a_backend():
    """The transport is the caller's choice: no default backend."""
    from vp8oclenc_tpu_torch.parallel.launch import run
    with pytest.raises(TypeError):
        encode_frames_spawned(EncoderConfig(), _blank(64, 48, 2), 64, 48, 2)
    with pytest.raises(TypeError):
        run(lambda layout: None, 2)


def test_spawned_encode_without_device_needs_cuda(monkeypatch):
    """With no device the ranks run on the card: without one the encode
    refuses before any rank is spawned, and runs on the CPU only when the
    caller asks for it."""
    import torch
    from vp8oclenc_tpu_torch.parallel import launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch.multiprocessing, "get_context", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_frames_spawned(EncoderConfig(), _blank(64, 48, 2), 64, 48, 2,
                              "gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_frames_spawned(EncoderConfig(), _blank(64, 48, 2), 64, 48, 2,
                              "gloo", ["cpu", None])
