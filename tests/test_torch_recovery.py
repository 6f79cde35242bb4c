"""Recovery paths of the port held against the JAX package: checkpoints
taken at every frame boundary and restored into either backend of either
package, the colour scene change and its holdover, and -dump-recon
through the port's CLI against the port's decoder."""
import os
import subprocess
import sys

import numpy as np
import pytest

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.pipeline.encoder import Encoder as JaxEncoder
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.decoder.vp8dec import VP8Decoder
from vp8oclenc_tpu_torch.io.ivf import read_ivf
from vp8oclenc_tpu_torch.io.y4m import Frame, Y4MReader, Y4MWriter
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.test_inter_roundtrip import moving_sequence
from tests.test_tpu_backend import replacement_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CKPT = 7
# gop_size=4: keyframes at 0 and 4, so frame 3's end is a GOP boundary
# (no planes in the checkpoint) and the others lie inside a GOP
CKPT_CFG = {
    False: dict(qi_min=10, qi_max=36, gop_size=4, altref_range=3),
    True: dict(qi_min=50, qi_max=112, gop_size=4, altref_range=3,
               ssim_target=0.98)}


def _ckpt_frames(ssim):
    if ssim:
        return replacement_sequence(96, 80, N_CKPT, seed=7)
    return moving_sequence(96, 80, N_CKPT, seed=21)


def _port(cfg, w, h, backend):
    if backend == "spec":
        return Encoder(EncoderConfig(**cfg), w, h, backend="spec")
    return Encoder(EncoderConfig(**cfg), w, h, device="cpu")


def _same_state(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, (tuple, list)) or isinstance(y, (tuple, list)):
            if (x is None) != (y is None) or len(x) != len(y) or not all(
                    np.array_equal(p, q) for p, q in zip(x, y)):
                return False
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


_CKPTS = {}


def _checkpoints(ssim):
    """The JAX spec stream, and the port's checkpoints after every frame
    (torch backend on the CPU), each equal to the JAX spec encoder's and
    to the port spec backend's at the same boundary."""
    if ssim not in _CKPTS:
        cfg, frames = CKPT_CFG[ssim], _ckpt_frames(ssim)
        ref = JaxEncoder(JaxConfig(**cfg), 96, 80, backend="spec")
        port = _port(cfg, 96, 80, "torch")
        spec = _port(cfg, 96, 80, "spec")
        want, states = [], []
        for f in frames:
            want.append(ref.encode_frame(f))
            pf = Frame(f.y, f.u, f.v)
            assert port.encode_frame(pf) == want[-1]
            assert spec.encode_frame(pf) == want[-1]
            st = port.checkpoint()
            assert _same_state(st, ref.checkpoint())
            assert _same_state(st, spec.checkpoint())
            states.append(st)
        port.close()
        spec.close()
        at_boundary = ["last" not in st for st in states]
        assert at_boundary == [False, False, False, True, False, False,
                               False]
        _CKPTS[ssim] = frames, want, states
    return _CKPTS[ssim]


@pytest.mark.parametrize("target", ["torch", "spec", "jax-spec", "jax-tpu"])
@pytest.mark.parametrize("ssim", [False, True], ids=["ssim-off", "ssim-on"])
def test_checkpoint_round_trip(ssim, target):
    """The port's checkpoint after frame k, restored into a fresh encoder,
    continues the stream byte-identically, for every k."""
    frames, want, states = _checkpoints(ssim)
    cfg = CKPT_CFG[ssim]
    for k in range(1, N_CKPT):
        if target.startswith("jax-"):
            enc = JaxEncoder(JaxConfig(**cfg), 96, 80, backend=target[4:])
            rest = frames[k:]
        else:
            enc = _port(cfg, 96, 80, target)
            rest = [Frame(f.y, f.u, f.v) for f in frames[k:]]
        enc.restore(states[k - 1])
        got = [enc.encode_frame(f) for f in rest]
        assert got == want[k:], f"resumed after frame {k - 1}"


def _flat(w, h, y=128, u=120, v=130):
    return Frame(np.full((h, w), y, np.uint8),
                 np.full((h // 2, w // 2), u, np.uint8),
                 np.full((h // 2, w // 2), v, np.uint8))


# tests/test_recovery_paths.py's scene-change streams: six flat frames and
# a chroma cut after the holdover window; a cut at frame 1, inside it
SCENES = {"cut": [_flat(64, 48)] * 6 + [_flat(64, 48, u=200, v=40)],
          "holdover": [_flat(64, 48), _flat(64, 48, u=200, v=40)]}
SCENE_CFG = dict(qi_min=10, qi_max=30, gop_size=100)


@pytest.mark.parametrize("scene", ["cut", "holdover"])
@pytest.mark.parametrize("mode", ["torch", "spec", "torch-depth3"])
def test_colour_scene_change(scene, mode):
    frames = SCENES[scene]
    ref = JaxEncoder(JaxConfig(**SCENE_CFG), 64, 48, backend="spec")
    want = [ref.encode_frame(f) for f in frames]
    enc = _port(SCENE_CFG, 64, 48, mode.split("-")[0])
    keys = []
    if mode.endswith("depth3"):
        got = []
        for payload in enc.encode_frames(frames, depth=3):
            got.append(payload)
            keys.append(enc.last_frame_stats["is_key"])
    else:
        got = []
        for f in frames:
            got.append(enc.encode_frame(f))
            keys.append(enc.last_frame_stats["is_key"])
    enc.close()
    assert got == want
    assert vars(enc.stats) == vars(ref.stats)
    if scene == "cut":
        assert enc.stats.scene_changes_by_color == 1
        assert keys == [True] + [False] * 5 + [True]
    else:
        assert enc.stats.scene_changes_by_color == 0
        assert keys == [True, False]
        assert enc._scene_holdover and enc.last_key_detect == 1


def test_dump_recon_cli_matches_port_decoder(tmp_path):
    """-dump-recon through the port's CLI equals the port's decoder frame
    for frame (tests/test_recovery_paths.py's stream)."""
    w, h = 64, 48
    rng = np.random.default_rng(5)
    src = tmp_path / "in.y4m"
    with open(src, "wb") as fh:
        yw = Y4MWriter(fh, w, h, 30, 1)
        base = rng.integers(0, 256, (h * 2, w * 2), dtype=np.uint8)
        for t in range(4):
            yw.write_frame(Frame(
                np.ascontiguousarray(base[t:t + h, t:t + w]),
                np.ascontiguousarray(base[t:t + h // 2, t:t + w // 2]),
                np.ascontiguousarray(
                    base[t + 1:t + 1 + h // 2, t:t + w // 2])))
    out, dump = tmp_path / "out.ivf", tmp_path / "dump.y4m"
    r = subprocess.run(
        [sys.executable, "-m", "vp8oclenc_tpu_torch", "-i", str(src), "-o",
         str(out), "-qmin", "10", "-qmax", "40", "-g", "2", "-device", "cpu",
         "-dump-recon", str(dump)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    _info, payloads = read_ivf(out.read_bytes())
    assert len(payloads) == 4
    dec = VP8Decoder()
    recon = iter(Y4MReader(dump.read_bytes()))
    for i, payload in enumerate(payloads):
        got = dec.decode_frame(payload)
        ref = next(recon)
        assert got.is_key == (i % 2 == 0)
        assert np.array_equal(got.y[:h, :w], ref.y), f"frame {i}"
        assert np.array_equal(got.u[:h // 2, :w // 2], ref.u), f"frame {i}"
        assert np.array_equal(got.v[:h // 2, :w // 2], ref.v), f"frame {i}"
    assert next(recon, None) is None
