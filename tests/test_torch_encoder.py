"""Streams from the port on the CPU against the JAX package: all-keyframe
(gop_size=1) and default-GOP (inter frames over LAST, GOLDEN and ALTREF)
streams byte-identical to its spec and tpu backends, decoding bit-exact
with its decoder, through the CLI, and across checkpoints taken by the JAX
encoder at a GOP boundary and inside a GOP."""
import os
import subprocess
import sys

import numpy as np
import pytest

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.decoder.vp8dec import VP8Decoder
from vp8oclenc_tpu.io.ivf import read_ivf
from vp8oclenc_tpu.io.y4m import Y4MWriter
from vp8oclenc_tpu.pipeline.encoder import Encoder as JaxEncoder
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.test_inter_roundtrip import moving_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(qi_min=10, qi_max=36, gop_size=1)


def _port_frames(frames):
    return [Frame(f.y, f.u, f.v) for f in frames]


@pytest.mark.parametrize("size", [(96, 80), (70, 50)])
def test_gop1_stream_matches_jax_and_decodes(size):
    w, h = size
    frames = moving_sequence(w, h, 3, seed=5)
    spec = JaxEncoder(JaxConfig(**CFG), w, h, backend="spec")
    want = [spec.encode_frame(f) for f in frames]
    tpu = JaxEncoder(JaxConfig(**CFG), w, h, backend="tpu")
    assert list(tpu.encode_frames(frames)) == want

    enc = Encoder(EncoderConfig(**CFG), w, h, device="cpu")
    piped = list(enc.encode_frames(_port_frames(frames)))
    enc.close()
    assert piped == want

    enc = Encoder(EncoderConfig(**CFG), w, h, device="cpu")
    dec = VP8Decoder()
    for f, ref in zip(_port_frames(frames), want):
        payload = enc.encode_frame(f)
        assert payload == ref
        out = dec.decode_frame(payload)
        assert out.is_key
        for got, rec in zip((out.y, out.u, out.v), enc.recon):
            assert np.array_equal(got, rec)
    enc.close()


def test_cli_matches_jax_cli(tmp_path):
    w, h = 64, 48
    src = tmp_path / "in.y4m"
    with open(src, "wb") as fh:
        wr = Y4MWriter(fh, w, h, 30, 1)
        for f in moving_sequence(w, h, 3, seed=9):
            wr.write_frame(f)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], cwd=ROOT,
                                    env=env, check=True, capture_output=True,
                                    timeout=300)
    run("vp8oclenc_tpu", "-i", str(src), "-o", str(tmp_path / "jax.ivf"),
        "-backend", "spec", "-g", "1", "-qmin", "12", "-qmax", "30")
    run("vp8oclenc_tpu_torch", "-i", str(src), "-o",
        str(tmp_path / "port.ivf"), "-device", "cpu", "-g", "1", "-qmin",
        "12", "-qmax", "30")
    a = (tmp_path / "jax.ivf").read_bytes()
    b = (tmp_path / "port.ivf").read_bytes()
    assert a == b
    assert len(read_ivf(b)[1]) == 3


INTER_CFG = dict(qi_min=8, qi_max=30, gop_size=100, altref_range=3)


@pytest.mark.parametrize("size,partitions", [((96, 80), 1), ((96, 80), 2),
                                             ((70, 50), 1)])
def test_default_gop_stream_matches_jax_and_decodes(size, partitions):
    """The stream of tests/test_tpu_backend.py's default-config test: one
    keyframe, then inter frames that use GOLDEN and ALTREF too."""
    w, h = size
    cfg = dict(INTER_CFG, num_partitions=partitions)
    frames = moving_sequence(w, h, 5, seed=4)
    spec = JaxEncoder(JaxConfig(**cfg), w, h, backend="spec")
    want = [spec.encode_frame(f) for f in frames]
    tpu = JaxEncoder(JaxConfig(**cfg), w, h, backend="tpu")
    assert list(tpu.encode_frames(frames)) == want

    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    piped = list(enc.encode_frames(_port_frames(frames)))
    enc.close()
    assert piped == want

    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    dec = VP8Decoder()
    n_inter = 0
    for f, ref in zip(_port_frames(frames), want):
        payload = enc.encode_frame(f)
        assert payload == ref
        out = dec.decode_frame(payload)
        n_inter += not out.is_key
        for got, rec in zip((out.y, out.u, out.v), enc.recon):
            assert np.array_equal(got, rec)
        if not out.is_key:
            assert enc.last_frame_stats["ssim_min_fx"] is not None
    enc.close()
    assert n_inter == 4


def test_cli_default_gop_matches_jax_cli(tmp_path):
    """No -g: the default GOP of 150, so every frame after the first is an
    inter frame."""
    w, h = 64, 48
    src = tmp_path / "in.y4m"
    with open(src, "wb") as fh:
        wr = Y4MWriter(fh, w, h, 30, 1)
        for f in moving_sequence(w, h, 4, seed=9):
            wr.write_frame(f)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], cwd=ROOT,
                                    env=env, check=True, capture_output=True,
                                    timeout=300)
    run("vp8oclenc_tpu", "-i", str(src), "-o", str(tmp_path / "jax.ivf"),
        "-backend", "spec", "-qmin", "12", "-qmax", "30")
    run("vp8oclenc_tpu_torch", "-i", str(src), "-o",
        str(tmp_path / "port.ivf"), "-device", "cpu", "-qmin", "12", "-qmax",
        "30")
    a = (tmp_path / "jax.ivf").read_bytes()
    b = (tmp_path / "port.ivf").read_bytes()
    assert a == b
    assert len(read_ivf(b)[1]) == 4


def test_cli_refuses_ssim_target(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "vp8oclenc_tpu_torch", "-i", "x.y4m", "-o",
         str(tmp_path / "o.ivf"), "-device", "cpu", "-SSIM-target", "90"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "ROADMAP.md" in proc.stderr
    with pytest.raises(ValueError, match="ROADMAP.md"):
        Encoder(EncoderConfig(ssim_target=0.9), 64, 48, device="cpu")


def test_restore_jax_checkpoint_continues_stream():
    w, h = 96, 80
    frames = moving_sequence(w, h, 4, seed=13)
    ref = JaxEncoder(JaxConfig(**CFG), w, h, backend="spec")
    want = [ref.encode_frame(f) for f in frames]

    jax_enc = JaxEncoder(JaxConfig(**CFG), w, h, backend="spec")
    for f in frames[:2]:
        jax_enc.encode_frame(f)
    st = jax_enc.checkpoint()
    assert "last" not in st               # every frame is a GOP boundary

    enc = Encoder(EncoderConfig(**CFG), w, h, device="cpu")
    enc.restore(st)
    got = list(enc.encode_frames(_port_frames(frames[2:])))
    enc.close()
    assert got == want[2:]
    back = enc.checkpoint()
    assert back.keys() == st.keys()
    assert back["frame_number"] == 4


def test_restore_mid_gop_jax_checkpoint_continues_stream():
    """A checkpoint taken by the JAX encoder inside a GOP carries LAST,
    GOLDEN and ALTREF planes; the port builds their search states and
    continues the stream byte-identically."""
    w, h = 96, 80
    frames = moving_sequence(w, h, 7, seed=21)
    cfg = dict(qi_min=10, qi_max=36, gop_size=100, altref_range=3)
    ref = JaxEncoder(JaxConfig(**cfg), w, h, backend="spec")
    want = [ref.encode_frame(f) for f in frames]

    jax_enc = JaxEncoder(JaxConfig(**cfg), w, h, backend="spec")
    for f in frames[:4]:
        jax_enc.encode_frame(f)
    st = jax_enc.checkpoint()
    assert st.get("last") is not None and st.get("altref") is not None

    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    enc.restore(st)
    got = list(enc.encode_frames(_port_frames(frames[4:])))
    enc.close()
    assert got == want[4:]
    back = enc.checkpoint()
    assert back.keys() == st.keys()
    for name in ("last", "golden", "altref"):
        assert len(back[name]) == 3
