"""The port at VP8's widest plane (16383 pixels, 1024 MB columns) on the
CPU against the JAX package, at the reference's launch configuration (4
token partitions, 6 packer threads), and the loop filter at the widths
where the card takes its ring kernel.

The row kernels (csrc/loopfilter.cu above 7248 pixels, csrc/intra.cu
luma) stage a ring of columns instead of the whole width, so no VP8 width
is refused on the card; the card holds them at widths up to 16384
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.ops.loopfilter import filter_planes as jax_filter_planes
from vp8oclenc_tpu.pipeline.encoder import Encoder as JaxEncoder
from vp8oclenc_tpu.pipeline.segments import derive_filter_limits
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.entropy.header import (FIRST_PARTITION_LIMIT,
                                                 tag_first_partition_size)
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.ops import loopfilter as LF
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.test_multichip_encode import _sequence
from tests.test_torch_loopfilter import _blocky

# the 8K cell's settings (chip_smoke.py's [wide] phase)
GOP_CFG = dict(qi_min=10, qi_max=40, gop_size=3, altref_range=3,
               num_partitions=4, threads=6)


def test_widest_plane_stream_equals_jax_spec_and_decodes():
    """A 16383x16 keyframe and inter frame (the width cropped from
    16384, chroma 8192 wide): the port's CPU bytes equal the JAX
    package's spec backend, the port's decoder reads them equal to the
    recon, and each frame's tag states its first partition's size."""
    from vp8oclenc_tpu_torch.decoder.vp8dec import VP8Decoder
    w, h = 16383, 16
    frames = [type(f)(np.ascontiguousarray(f.y[:, :w]), f.u, f.v)
              for f in _sequence(w + 1, h, 2, seed=31)]
    spec = JaxEncoder(JaxConfig(**GOP_CFG), w, h, backend="spec")
    want = [spec.encode_frame(f) for f in frames]
    enc = Encoder(EncoderConfig(**GOP_CFG), w, h, device="cpu")
    dec = VP8Decoder()
    got = []
    for f in frames:
        got.append(enc.encode_frame(Frame(f.y, f.u, f.v)))
        size = enc.last_frame_stats["first_partition_bytes"]
        assert 0 < size < FIRST_PARTITION_LIMIT
        assert tag_first_partition_size(got[-1]) == size
        out = dec.decode_frame(got[-1])
        assert (dec.width, dec.height, out.y.shape) == (w, h, (h, w + 1))
        for plane, rec in zip((out.y, out.u, out.v), enc.recon):
            assert np.array_equal(plane,
                                  rec[:plane.shape[0], :plane.shape[1]])
    enc.close()
    assert [p[0] & 1 for p in got] == [0, 1]      # frame tag: 1 = inter
    assert got == want


@pytest.mark.parametrize("size,key", [
    (74653, True), (FIRST_PARTITION_LIMIT - 1, False), (1_190_000, True)])
def test_tag_states_the_first_partition_modulo_its_field(size, key):
    """The 3-byte tag holds the size in 19 bits: a first partition of
    FIRST_PARTITION_LIMIT bytes or more reads back modulo that limit (the
    size an 8K keyframe can reach; chip_smoke.py prints both)."""
    tag = (0 if key else 1) | 0x10 | (size << 5)
    frame = bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
    assert tag_first_partition_size(frame) == size % FIRST_PARTITION_LIMIT


@pytest.mark.parametrize("w,h", [(7264, 32), (16384, 16)])
def test_filter_at_ring_widths_matches_jax(w, h):
    """The loop filter at the widths where the card takes its ring kernel
    (from 7264 pixels; up to 16384): the port's wrapper, on CPU planes its
    plain version, equal to the JAX package's XLA filter, with four
    segments and a mixed inner-edge mask (tolerance 0)."""
    rng = np.random.default_rng(w + h)
    mbw, mbh = w // 16, h // 16
    y, u, v = (_blocky(rng, h, w), _blocky(rng, h // 2, w // 2),
               rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
    level = rng.integers(5, 63, 4).astype(np.int32)
    intr, mbe, sbe, hev = derive_filter_limits(level, 3, False)
    sid = rng.integers(0, 4, mbw * mbh).astype(np.int32)
    inner = rng.random(mbw * mbh) < 0.6
    args = (sid, inner, level, mbe, sbe, intr, hev)
    got = LF.filter_planes(*(torch.from_numpy(np.asarray(a))
                             for a in (y, u, v, *args)))
    want = jax_filter_planes(*(jnp.asarray(a) for a in (y, u, v, *args)),
                             mbw, mbh)
    assert not np.array_equal(got[0].numpy(), y)     # the filter did work
    for g, j in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(j))
