"""The small streams that the port's oracle tests share, each as
(width, height, config kwargs, frames of the JAX package's Frame type):
all-keyframe, default GOP with one and with two token partitions, the SSIM
target with replaced MBs, and redo-as-key.  Their content comes from the
JAX package's tests, as in tests/test_torch_encoder.py."""
import numpy as np

from vp8oclenc_tpu.io.y4m import Frame
from tests.test_inter_roundtrip import moving_sequence
from tests.test_tpu_backend import replacement_sequence


def redo_frames(w=64, h=48, n=5):
    """Luma replaced wholesale from frame to frame while chroma stays
    constant, so the SSIM controller rejects those inter frames; frame 3
    repeats frame 2 and stays an inter frame (tests/test_torch_encoder.py's
    redo_stream)."""
    rng = np.random.default_rng(3)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    frames = [Frame(rng.integers(0, 255, (h, w)).astype(np.uint8),
                    u.copy(), v.copy()) for _ in range(n)]
    yy, xx = np.mgrid[0:h, 0:w]
    cols = (64 + (xx // 16) * 32).astype(np.uint8)
    frames[2] = Frame(cols, u.copy(), v.copy())
    frames[3] = Frame(cols.copy(), u.copy(), v.copy())
    return frames


INTER_CFG = dict(qi_min=8, qi_max=30, gop_size=100, altref_range=3)
SSIM_CFG = dict(qi_min=50, qi_max=112, gop_size=100, ssim_target=0.98,
                altref_range=100)
REDO_CFG = dict(qi_min=95, qi_max=127, gop_size=100, ssim_target=0.99)


def stream(name):
    if name == "gop1":
        return 96, 80, dict(qi_min=10, qi_max=36, gop_size=1), \
            moving_sequence(96, 80, 3, seed=5)
    if name == "default":
        return 96, 80, INTER_CFG, moving_sequence(96, 80, 5, seed=4)
    if name == "default_2parts":
        return 96, 80, dict(INTER_CFG, num_partitions=2), \
            moving_sequence(96, 80, 5, seed=4)
    if name == "ssim":
        return 96, 80, SSIM_CFG, replacement_sequence(96, 80, 5, seed=7)
    if name == "redo":
        return 64, 48, REDO_CFG, redo_frames()
    raise KeyError(name)


NAMES = ("gop1", "default", "default_2parts", "ssim", "redo")
