"""The port at UHD width (3840 pixels, 240 MB columns) on the CPU against
the JAX package, at the reference's launch configuration (4 token
partitions, 6 packer threads), and UHD itself under the `slow` marker.

Tier-1 holds a 3840x32 strip: every module meets the UHD width (the row
kernels' plain versions over 240 MB columns, pyramid levels down to 240x2,
the search, the wire and the packer over 480 MBs), at a cost the suite
can carry.  The slow test is the port's counterpart of
tests/test_multichip_encode.py's 4K test: two 3840x2160 frames over 2 gop
lanes x 2 row tiles (135 MB rows as 68 + 67), decoded by the port's
decoder."""
import time

import numpy as np
import pytest

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.pipeline.encoder import Encoder as JaxEncoder
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.test_multichip_encode import _sequence
from tests.test_torch_tile import gradient_mbs

W = 3840
# the UHD cell's settings: default-GOP content at -qmin 10 -qmax 40,
# -partitions 4 -threads 6 (bench.py's base launch configuration)
GOP_CFG = dict(qi_min=10, qi_max=40, gop_size=3, altref_range=3,
               num_partitions=4, threads=6)
SSIM_CFG = dict(qi_min=50, qi_max=112, gop_size=150, ssim_target=0.98,
                num_partitions=4, threads=6)


def _port(frames):
    return [Frame(f.y, f.u, f.v) for f in frames]


def _port_stream(cfg, frames, w, h):
    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    out = list(enc.encode_frames(_port(frames)))
    enc.close()
    return out, enc.stats


def test_uhd_width_strip_equals_jax_spec_and_tpu():
    """A panned canvas 3840x32, a keyframe and two inter frames."""
    h = 32
    frames = _sequence(W, h, 3, seed=21)
    spec = JaxEncoder(JaxConfig(**GOP_CFG), W, h, backend="spec")
    want = [spec.encode_frame(f) for f in frames]
    tpu = JaxEncoder(JaxConfig(**GOP_CFG), W, h, backend="tpu")
    assert list(tpu.encode_frames(frames)) == want
    got, _ = _port_stream(GOP_CFG, frames, W, h)
    assert [p[0] & 1 for p in got] == [0, 1, 1]     # frame tag: 1 = inter
    assert got == want


def test_uhd_width_ssim_target_equals_jax_spec():
    """The SSIM controller over 240 MB columns: a tenth of the MBs given
    a fresh gradient every frame, a keyframe and two inter frames, some
    MBs replaced."""
    h = 32
    frames = gradient_mbs(W, h, 3, seed=23, share=0.1)
    spec = JaxEncoder(JaxConfig(**SSIM_CFG), W, h, backend="spec")
    want, replaced = [], 0
    for f in frames:
        want.append(spec.encode_frame(f))
        replaced += spec.last_frame_stats["replaced"]
    assert replaced > 0
    got, stats = _port_stream(SSIM_CFG, frames, W, h)
    assert got == want
    assert stats.scene_changes_by_ssim + stats.scene_changes_by_replaced == 0


@pytest.mark.slow
def test_uhd_two_lanes_two_tiles_decode():
    """A 3840x2160 keyframe and inter frame (one GOP, so the first lane
    codes both, its 2 tiles with halos on the 68/67 split) over 2 gop
    lanes x 2 row tiles, byte-identical to the single-rank port encode,
    which the port's decoder reads equal to its recon."""
    from vp8oclenc_tpu_torch.decoder.vp8dec import VP8Decoder
    from vp8oclenc_tpu_torch.parallel.encoder import encode_frames_spawned

    h = 2160
    frames = _port(_sequence(W, h, 2, seed=0))
    cfg = dict(GOP_CFG, gop_size=2)
    t0 = time.monotonic()
    enc = Encoder(EncoderConfig(**cfg), W, h, device="cpu")
    dec = VP8Decoder()
    want = []
    for f in frames:
        want.append(enc.encode_frame(f))
        out = dec.decode_frame(want[-1])
        for got, rec in zip((out.y, out.u, out.v), enc.recon):
            assert np.array_equal(got, rec[:got.shape[0], :got.shape[1]])
    enc.close()
    got, _, _ = encode_frames_spawned(EncoderConfig(**cfg), frames, W, h, 4,
                                      "gloo", "cpu", gop=2, tile=2)
    assert got == want
    print(f"UHD 2 frames, single rank + decode + 4 ranks: "
          f"{time.monotonic() - t0:.1f} s, {[len(p) for p in got]} bytes")

