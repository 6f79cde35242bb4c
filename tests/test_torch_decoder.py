"""The port's VP8 decoder (vp8oclenc_tpu_torch/decoder) against the JAX
package's and against the encoder's reconstruction, frame by frame, on the
streams of tests/torch_streams.py coded by the port on the CPU."""
import numpy as np
import pytest

from vp8oclenc_tpu.decoder.vp8dec import VP8Decoder as JaxDecoder
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.decoder.vp8dec import VP8Decoder
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

from tests.torch_streams import NAMES, stream


@pytest.mark.parametrize("name", NAMES)
def test_decoder_matches_jax_decoder_and_recon(name):
    w, h, cfg, frames = stream(name)
    enc = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    dec, ref = VP8Decoder(), JaxDecoder()
    keys, replaced = [], 0
    for f in frames:
        payload = enc.encode_frame(Frame(f.y, f.u, f.v))
        out, want = dec.decode_frame(payload), ref.decode_frame(payload)
        assert out.is_key == want.is_key == enc.last_frame_stats["is_key"]
        for got, jax_plane, rec in zip((out.y, out.u, out.v),
                                       (want.y, want.u, want.v), enc.recon):
            assert np.array_equal(got, jax_plane)
            assert np.array_equal(got, rec)
        keys.append(out.is_key)
        replaced += enc.last_frame_stats["replaced"]
    enc.close()
    st = enc.stats
    if name == "gop1":
        assert all(keys)
    elif name == "redo":
        assert st.scene_changes_by_ssim + st.scene_changes_by_replaced >= 2
        assert keys == [True, True, True, False, True]
    else:
        assert keys == [True] + [False] * (len(frames) - 1)
    if name == "ssim":
        assert replaced > 0


@pytest.mark.parametrize("backend", ["torch", "spec"])
def test_decoder_references_match_encoder(backend):
    """After a default-GOP stream the decoder's LAST, GOLDEN and ALTREF
    equal the encoder backend's references."""
    w, h, cfg, frames = stream("default")
    enc = Encoder(EncoderConfig(**cfg), w, h,
                  device="cpu" if backend == "torch" else None,
                  backend=backend)
    dec = VP8Decoder()
    for f in frames:
        dec.decode_frame(enc.encode_frame(Frame(f.y, f.u, f.v)))
    enc.close()
    for got, want in zip((dec.last, dec.golden, dec.altref),
                         enc.backend.host_refs()):
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
