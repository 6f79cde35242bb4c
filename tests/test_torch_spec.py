"""The port's spec backend (`Encoder(backend="spec")`, CLI `-backend
spec`): the sequential numpy oracle gives the bytes and the scene-change
counters of the JAX package's spec backend on the streams of
tests/torch_streams.py, sequentially and through the speculative frame
loop, and the port's two backends give the same stream."""
import os
import subprocess
import sys

import pytest

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.io.y4m import Y4MWriter
from vp8oclenc_tpu.pipeline.encoder import Encoder as JaxEncoder
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.ivf import read_ivf
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.test_inter_roundtrip import moving_sequence
from tests.test_tpu_backend import replacement_sequence
from tests.torch_streams import NAMES, stream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REFS = {}


def _jax_spec(name):
    """The JAX spec backend's bytes and counters for a stream (cached)."""
    if name not in _REFS:
        w, h, cfg, frames = stream(name)
        enc = JaxEncoder(JaxConfig(**cfg), w, h, backend="spec")
        want = [enc.encode_frame(f) for f in frames]
        st = enc.stats
        _REFS[name] = want, (st.scene_changes_by_color,
                             st.scene_changes_by_ssim,
                             st.scene_changes_by_replaced)
    return _REFS[name]


def _counters(enc):
    st = enc.stats
    return (st.scene_changes_by_color, st.scene_changes_by_ssim,
            st.scene_changes_by_replaced)


CASES = [(n, d) for n in NAMES if n != "redo" for d in (0, 3)] + \
    [("redo", d) for d in (0, 1, 3)]


@pytest.mark.parametrize("name,depth", CASES)
def test_spec_backend_matches_jax_spec(name, depth):
    """depth 0 is encode_frame; otherwise encode_frames with `depth`
    frames in flight, so a redo-as-key rolls back frames already coded."""
    w, h, cfg, frames = stream(name)
    want, counters = _jax_spec(name)
    frames = [Frame(f.y, f.u, f.v) for f in frames]
    enc = Encoder(EncoderConfig(**cfg), w, h, backend="spec")
    if depth == 0:
        got = [enc.encode_frame(f) for f in frames]
    else:
        got = list(enc.encode_frames(frames, depth=depth))
    enc.close()
    assert got == want
    assert _counters(enc) == counters
    assert enc.frame_number == len(frames)
    if name == "redo":
        assert counters[1] + counters[2] >= 2


def test_spec_and_torch_backends_agree_on_recon_and_stats():
    """The port's two backends frame by frame: bytes, reconstruction and
    the per-frame SSIM statistics."""
    import numpy as np
    w, h, cfg, frames = stream("ssim")
    spec = Encoder(EncoderConfig(**cfg), w, h, backend="spec")
    torch_ = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    for f in frames:
        f = Frame(f.y, f.u, f.v)
        assert spec.encode_frame(f) == torch_.encode_frame(f)
        assert spec.last_frame_stats == torch_.last_frame_stats
        for a, b in zip(spec.recon, torch_.recon):
            assert np.array_equal(a, b)
    spec.close()
    torch_.close()


def test_backend_arguments():
    cfg = EncoderConfig(gop_size=1)
    with pytest.raises(ValueError, match="device"):
        Encoder(cfg, 64, 48, device="cuda", backend="spec")
    with pytest.raises(ValueError, match="unknown backend"):
        Encoder(cfg, 64, 48, device="cpu", backend="tpu")
    enc = Encoder(cfg, 64, 48, device="cpu", backend="spec")
    assert enc.backend.device.type == "cpu"


@pytest.mark.parametrize("content", ["default_gop", "ssim_target"])
def test_cli_backend_spec_matches_jax_cli(tmp_path, content):
    """`-backend spec` through both CLIs gives the same file; with an SSIM
    target also the same -print-info lines."""
    w, h = (64, 48) if content == "default_gop" else (96, 80)
    frames = moving_sequence(w, h, 4, seed=9) if content == "default_gop" \
        else replacement_sequence(w, h, 4, seed=7)
    src = tmp_path / "in.y4m"
    with open(src, "wb") as fh:
        wr = Y4MWriter(fh, w, h, 30, 1)
        for f in frames:
            wr.write_frame(f)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run([sys.executable, "-m", *a], cwd=ROOT,
                                    env=env, check=True, capture_output=True,
                                    text=True, timeout=300).stdout
    common = ["-qmin", "12", "-qmax", "30", "-backend", "spec"]
    if content == "ssim_target":
        common = ["-qmin", "50", "-qmax", "112", "-SSIM-target", "98",
                  "-print-info", "-backend", "spec"]
    jax_out = run("vp8oclenc_tpu", "-i", str(src), "-o",
                  str(tmp_path / "jax.ivf"), *common)
    port_out = run("vp8oclenc_tpu_torch", "-i", str(src), "-o",
                   str(tmp_path / "port.ivf"), *common)
    a = (tmp_path / "jax.ivf").read_bytes()
    b = (tmp_path / "port.ivf").read_bytes()
    assert a == b
    assert len(read_ivf(b)[1]) == 4
    lines = lambda out: [ln for ln in out.splitlines()
                         if "blocks_replaced=" in ln or "scene changes" in ln]
    assert lines(port_out) == lines(jax_out)
    if content == "ssim_target":
        assert len([ln for ln in lines(port_out)
                    if "blocks_replaced=" in ln]) == 3
