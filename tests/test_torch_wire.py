"""The port's wire pack against the JAX package's: the same head and body
bytes on the same inputs (escapes, more escapes in one MB than there are
slots, the overflow flag), and round trips through the unpackers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp8oclenc_tpu.ops import wire as JW
from vp8oclenc_tpu_torch.ops import wire as W


def _inputs(mbc, seed, esc_per_mb):
    rng = np.random.default_rng(seed)
    levels = (rng.integers(-60, 60, (mbc, 25, 16))
              * (rng.random((mbc, 25, 16)) > 0.8)).astype(np.int16)
    for mbn in range(0, mbc, 3):
        k = esc_per_mb
        pos = rng.choice(400, k, replace=False)
        levels.reshape(mbc, 400)[mbn, pos] = rng.integers(
            128, 2048, k) * rng.choice([-1, 1], k)
    levels[1] = 0                                 # an MB with no level
    meta = np.concatenate(
        [rng.integers(0, 4, (mbc, 1)), rng.integers(0, 3, (mbc, 1)),
         rng.integers(0, 3, (mbc, 1)), rng.integers(-2000, 2000, (mbc, 8))],
        axis=1).astype(np.int32)
    ssim = rng.integers(-140000, 98304, mbc).astype(np.int32)
    return levels, meta, ssim


@pytest.mark.parametrize("mbc,esc_per_mb", [(60, 1), (60, 2), (37, 3),
                                            (4, 0)])
def test_pack_wire_bytes_equal_jax(mbc, esc_per_mb):
    levels, meta, ssim = _inputs(mbc, mbc + esc_per_mb, esc_per_mb)
    jh, jb, js = JW.pack_wire(jnp.asarray(levels), jnp.asarray(meta),
                              jnp.asarray(ssim), 7)
    th, tb, ts = W.pack_wire(torch.from_numpy(levels),
                             torch.from_numpy(meta), torch.from_numpy(ssim),
                             7)
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert th.numel() == W.head_size(mbc)
    assert tb.numel() == W.body_capacity(mbc)

    info = W.unpack_head(th.numpy(), mbc)
    assert info["replaced"] == 7
    assert info["ssim_min_fx"] == ssim.min()
    assert info["ssim_sum_fx"] == int(np.maximum(ssim, -98304)
                                      .astype(np.int64).sum())
    assert info["esc_overflow"] == (esc_per_mb > W.ESC_SLOTS)
    assert int(info["ovf"].sum()) == (len(range(0, mbc, 3))
                                      if esc_per_mb > W.ESC_SLOTS else 0)
    assert np.array_equal(info["mvs"].reshape(mbc, 8),
                          meta[:, 3:].astype(np.int16))
    if esc_per_mb <= W.ESC_SLOTS:
        lv = W.unpack_levels(info, tb.numpy()[: info["n_active"] * 16], mbc)
        assert np.array_equal(lv, levels)


def test_modes4_round_trip():
    rng = np.random.default_rng(5)
    modes = rng.integers(0, 10, (23, 16)).astype(np.int8)
    m4 = W.pack_modes4(torch.from_numpy(modes)).numpy()
    assert m4.shape == (23 * 8,)
    assert np.array_equal(W.unpack_modes4(m4, 23), modes)
    assert np.array_equal(JW.unpack_modes4(m4, 23), modes)
