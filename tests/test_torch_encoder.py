"""Streams from the port on the CPU against the JAX package: all-keyframe
(gop_size=1), default-GOP (inter frames over LAST, GOLDEN and ALTREF) and
SSIM-target streams (segment loop, intra replacement, redo-as-key)
byte-identical to its spec and tpu backends, decoding bit-exact with its
decoder, through the CLI, and across checkpoints taken by the JAX encoder
at a GOP boundary and inside a GOP."""
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
from tests.torch_streams import INTER_CFG, REDO_CFG, SSIM_CFG, redo_frames

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


@pytest.fixture(scope="module")
def ssim_stream():
    """The replacement sequence of tests/test_tpu_backend.py under an SSIM
    target, coded by the JAX package's spec backend and, once, by its tpu
    backend (pipelined)."""
    from tests.test_tpu_backend import replacement_sequence
    w, h = 96, 80
    frames = replacement_sequence(w, h, 5, seed=7)
    spec = JaxEncoder(JaxConfig(**SSIM_CFG), w, h, backend="spec")
    want = [spec.encode_frame(f) for f in frames]
    tpu = JaxEncoder(JaxConfig(**SSIM_CFG), w, h, backend="tpu")
    assert list(tpu.encode_frames(frames)) == want
    return w, h, _port_frames(frames), want


def test_ssim_stream_matches_jax_and_decodes(ssim_stream):
    """Segment loop and intra replacement through encode_frame: bytes equal
    the spec's and the tpu backend's, the stream decodes bit-exact, and
    the replacement fired."""
    w, h, frames, want = ssim_stream
    enc = Encoder(EncoderConfig(**SSIM_CFG), w, h, device="cpu")
    dec = VP8Decoder()
    replaced = 0
    for f, ref in zip(frames, want):
        payload = enc.encode_frame(f)
        assert payload == ref
        out = dec.decode_frame(payload)
        for got, rec in zip((out.y, out.u, out.v), enc.recon):
            assert np.array_equal(got, rec)
        replaced += enc.last_frame_stats["replaced"]
    enc.close()
    assert replaced > 0
    assert enc.stats.scene_changes_by_ssim == 0
    assert enc.stats.scene_changes_by_replaced == 0


@pytest.mark.parametrize("depth", [1, 3])
def test_ssim_stream_pipelined_matches_jax(ssim_stream, depth):
    w, h, frames, want = ssim_stream
    enc = Encoder(EncoderConfig(**SSIM_CFG), w, h, device="cpu")
    replaced = 0
    for payload, ref in zip(enc.encode_frames(frames, depth=depth), want):
        assert payload == ref
        replaced += enc.last_frame_stats["replaced"]
    enc.close()
    assert replaced > 0


@pytest.fixture(scope="module")
def redo_stream():
    """Luma replaced wholesale from frame to frame while chroma stays
    constant (no scene-change escape): the SSIM controller rejects those
    inter frames and they are done again as keyframes.  Frame 3 repeats
    frame 2, four flat columns, and stays an inter frame between redos."""
    w, h = 64, 48
    frames = _port_frames(redo_frames(w, h))
    spec = JaxEncoder(JaxConfig(**REDO_CFG), w, h, backend="spec")
    want = [spec.encode_frame(f) for f in frames]
    redone = (spec.stats.scene_changes_by_ssim,
              spec.stats.scene_changes_by_replaced)
    assert sum(redone) >= 2
    assert [p[0] & 1 for p in want] == [0, 0, 0, 1, 0]   # frame tag: 1 = inter
    return w, h, frames, want, redone


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_redo_as_key_matches_spec(redo_stream, depth):
    """Speculative redo-as-key: sequential (depth 0: encode_frame) and
    pipelined with successors in flight when the verdict arrives; bytes
    and counters equal the spec's, and the stream decodes."""
    w, h, frames, want, redone = redo_stream
    enc = Encoder(EncoderConfig(**REDO_CFG), w, h, device="cpu")
    if depth == 0:
        got = [enc.encode_frame(f) for f in frames]
    else:
        got = list(enc.encode_frames(frames, depth=depth))
    enc.close()
    assert got == want
    assert (enc.stats.scene_changes_by_ssim,
            enc.stats.scene_changes_by_replaced) == redone
    assert enc.stats.scene_changes_by_color == 0
    assert enc.frame_number == len(frames)
    dec = VP8Decoder()
    for payload in got:
        dec.decode_frame(payload)


def test_cli_ssim_target_matches_jax_cli(tmp_path):
    """-SSIM-target 98 through both CLIs: the same file, and the same
    per-frame SSIM lines under -print-info."""
    from tests.test_tpu_backend import replacement_sequence
    w, h = 96, 80
    src = tmp_path / "in.y4m"
    with open(src, "wb") as fh:
        wr = Y4MWriter(fh, w, h, 30, 1)
        for f in replacement_sequence(w, h, 4, seed=7):
            wr.write_frame(f)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], cwd=ROOT,
                                    env=env, check=True, capture_output=True,
                                    text=True, timeout=300).stdout
    common = ["-qmin", "50", "-qmax", "112", "-SSIM-target", "98",
              "-print-info"]
    jax_out = run("vp8oclenc_tpu", "-i", str(src), "-o",
                  str(tmp_path / "jax.ivf"), "-backend", "spec", *common)
    port_out = run("vp8oclenc_tpu_torch", "-i", str(src), "-o",
                   str(tmp_path / "port.ivf"), "-device", "cpu", *common)
    a = (tmp_path / "jax.ivf").read_bytes()
    b = (tmp_path / "port.ivf").read_bytes()
    assert a == b
    assert len(read_ivf(b)[1]) == 4
    ssim_lines = lambda out: [ln for ln in out.splitlines()
                              if "blocks_replaced=" in ln]
    assert len(ssim_lines(port_out)) == 3
    # the spec backend knows the scores of an inter frame only as floats of
    # the same integers: the lines are equal text
    assert ssim_lines(port_out) == ssim_lines(jax_out)
    assert [ln for ln in port_out.splitlines() if "scene changes" in ln] \
        == [ln for ln in jax_out.splitlines() if "scene changes" in ln]


def test_cuda_encode_needs_the_native_packer(monkeypatch):
    """Beside a card the host entropy stage never falls back to the Python
    tokenizer: a packer that did not build raises.  On the CPU the
    fallback stays and gives the same bytes."""
    import torch
    from vp8oclenc_tpu_torch.native import packer
    w, h = 64, 48
    frame = _port_frames(moving_sequence(w, h, 1, seed=2))[0]
    enc = Encoder(EncoderConfig(**CFG), w, h, device="cpu")
    want = enc.encode_frame(frame)
    monkeypatch.setattr(packer, "available", lambda: False)
    enc = Encoder(EncoderConfig(**CFG), w, h, device="cpu")
    assert enc.encode_frame(frame) == want
    enc = Encoder(EncoderConfig(**CFG), w, h, device="cpu")
    fd, seg = enc._frame_pixels(frame)
    enc._finalize_fd(fd, seg)
    monkeypatch.setattr(enc.backend, "device", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="native entropy packer"):
        enc._finish_frame(fd, seg)


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
