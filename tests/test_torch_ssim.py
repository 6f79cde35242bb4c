"""The port's SSIM-controller modules (ssim_fx.mb_ssim_fx_16x16 and
ops/intra_replace.py) against the JAX package's ssim_fx.py and
ops/intra_replace.py on the same seeded inputs, bit for bit (tolerance 0).
The JAX luma trial is `_trial_luma`, the XLA reference its Pallas kernel is
held to; the port's is `trial_luma_plain`, the plain version its CUDA
kernel is held to on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vp8oclenc_tpu.ops import intra_replace as JR
from vp8oclenc_tpu.ssim_fx import mb_ssim_fx as np_mb_ssim_fx
from vp8oclenc_tpu.ssim_fx import mb_ssim_fx_16x16 as np_mb_ssim_fx_16x16
from vp8oclenc_tpu.ssim_fx import target_fx
from vp8oclenc_tpu_torch import ssim_fx as TS
from vp8oclenc_tpu_torch.ops import intra_replace as TR
from vp8oclenc_tpu_torch.ops import transforms as TT
from vp8oclenc_tpu_torch.ops.predict import bpred_all_modes

SIZES = [(96, 80), (80, 64)]      # 80x64 is 70x50 padded to whole MBs
QUANTS = [(7, 9), (120, 157)]


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
        f"{what}: {np.sum(got != want)} values differ"


def _planes(size, seed):
    """u8 (y, u, v) with every pixel distinct enough that a wrong row or
    column of a neighbour shows: a ramp plus noise."""
    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 3 + yy * 5) % 200 + rng.integers(0, 56, (h, w)))
    c = lambda: rng.integers(0, 256, (h // 2, w // 2))
    return [a.astype(np.uint8) for a in (y, c(), c())]


def test_target_and_uncoded_constants_match():
    from vp8oclenc_tpu import ssim_fx as JS
    assert TS.UNCODED_FX == JS.UNCODED_FX
    for t in (0.5, 0.9, 0.95, 0.97, 0.98, 0.99):
        assert TS.target_fx(t) == JS.target_fx(t)
        assert TS.fx_to_float(TS.target_fx(t)) == JS.fx_to_float(
            JS.target_fx(t))


def test_mb_ssim_16x16_matches():
    """Patches, with all-255 against all-0 and all-255 against all-255
    blocks, whose n*q1 and s1*s1 pass int32."""
    rng = np.random.default_rng(23)
    n = 40
    mk = lambda s: rng.integers(0, 256, (n, s, s)).astype(np.int32)
    sy, ry, su, ru, sv, rv = mk(16), mk(16), mk(8), mk(8), mk(8), mk(8)
    ry[:20] = np.clip(sy[:20] + rng.integers(-9, 10, (20, 16, 16)), 0, 255)
    sy[0], ry[0] = 255, 0
    sy[1], ry[1] = 255, 255
    sy[2], ry[2] = 0, 0
    su[3], ru[3] = 255, 0
    got = TS.mb_ssim_fx_16x16(*(torch.from_numpy(a.astype(np.uint8))
                                for a in (sy, ry, su, ru, sv, rv)))
    assert got.dtype == torch.int32
    _eq(got, np_mb_ssim_fx_16x16(sy, ry, su, ru, sv, rv), "numpy")
    _eq(got, np_mb_ssim_fx_16x16(*(jnp.asarray(a) for a in
                                   (sy, ry, su, ru, sv, rv)), xp=jnp), "jax")


@pytest.mark.parametrize("size", SIZES)
def test_frozen_neighbors_match(size):
    """Every MB of the frame, so each corner and each edge is covered; the
    expected values of the four corner MBs are also written out."""
    w, h = size
    mbw, mbh = w // 16, h // 16
    y, u, v = _planes(size, seed=w)
    ftop, fleft = TR._frozen_luma_neighbors(torch.from_numpy(y), mbw, mbh)
    jtop, jleft = JR._frozen_luma_neighbors(jnp.asarray(y), mbw, mbh)
    assert ftop.dtype == torch.uint8 and ftop.is_contiguous()
    _eq(ftop, jtop, "ftop")
    _eq(fleft, jleft, "fleft")
    ft, fl = ftop.numpy().astype(int), fleft.numpy().astype(int)
    assert (ft[:mbw] == 127).all() and (fl[::mbw] == 129).all()
    last = mbw * mbh - 1                       # bottom-right MB
    row = y[h - 17].astype(int)
    assert ft[last].tolist() == row[w - 17:].tolist() + [row[-1]] * 4
    assert fl[last].tolist() == y[h - 16:, w - 17].astype(int).tolist()
    assert ft[last - mbw + 1][0] == 129        # bottom-left MB's corner
    for plane in (u, v):
        got = TR._frozen_chroma_neighbors(torch.from_numpy(plane), mbw, mbh)
        want = JR._frozen_chroma_neighbors(jnp.asarray(plane), mbw, mbh)
        for g, j, what in zip(got, want, ("ctop", "cleft", "ctl")):
            _eq(g, j, what)
        ctl = got[2].numpy().astype(int)
        assert (ctl[:mbw] == 127).all() and (ctl[mbw::mbw] == 129).all()
        assert ctl[last] == plane[h // 2 - 9, w // 2 - 9]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("q", QUANTS)
def test_trial_chroma_matches(size, q):
    w, h = size
    mbw, mbh = w // 16, h // 16
    _, u, v = _planes(size, seed=w + q[0])
    _, ru, _ = _planes(size, seed=w + q[0] + 1)
    src = TR._plane_mb(torch.from_numpy(u), 8)
    nb = TR._frozen_chroma_neighbors(torch.from_numpy(ru), mbw, mbh)
    got = TR._trial_chroma(src, *nb, *q)
    jnb = JR._frozen_chroma_neighbors(jnp.asarray(ru), mbw, mbh)
    want = JR._trial_chroma(JR._plane_mb(jnp.asarray(u), 8), *jnb, *q)
    _eq(got[0], want[0], "levels")
    _eq(got[1], want[1], "rec")


def _trial_inputs(size, seed):
    """Source patches and frozen neighbours from two different planes,
    with all-0 and all-255 MBs and one MB built to tie: source and every
    neighbour 100, so all ten predictors are equal and cost the same."""
    w, h = size
    mbw, mbh = w // 16, h // 16
    y, _, _ = _planes(size, seed)
    rec, _, _ = _planes(size, seed + 1)
    y[:16, :16] = 0
    y[:16, 16:32] = 255
    y[16:32, 16:32] = 100
    rec[15, 15:37] = 100                # P and A0..A19 of MB (1, 1)
    rec[16:32, 15] = 100                # its left column
    y_mb = TR._plane_mb(torch.from_numpy(y), 16).contiguous()
    ftop, fleft = TR._frozen_luma_neighbors(torch.from_numpy(rec), mbw, mbh)
    return y_mb, ftop, fleft, mbw + 1


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("q", QUANTS)
def test_trial_luma_plain_matches(size, q):
    y_mb, ftop, fleft, tie_mb = _trial_inputs(size, seed=size[0] + q[1])
    got = TR.trial_luma_plain(y_mb, ftop, fleft, *q)
    assert [t.dtype for t in got] == [torch.int16, torch.int8, torch.uint8]
    want = JR._trial_luma(*(jnp.asarray(t.numpy().astype(np.int32))
                            for t in (y_mb, ftop, fleft)), *q)
    for g, j, what in zip(got, want, ("levels", "modes", "rec")):
        _eq(g, j, what)
    # the tie is real: the first block's ten costs are equal, mode 0 won
    i32 = lambda t: t[tie_mb].to(torch.int32)
    preds = bpred_all_modes(i32(ftop)[1:9], i32(fleft)[:4], i32(ftop)[0])
    costs = TT.dct_weight(i32(y_mb)[:4, :4] - preds)
    assert costs.min() == costs.max()
    assert (got[1][tie_mb] == 0).all()
    # and modes vary elsewhere
    assert len(np.unique(got[1].numpy())) > 3
    # the wrapper takes the plain version for CPU tensors
    again = TR.trial_luma(y_mb, ftop, fleft, *q)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_trial_luma_refuses_other_devices():
    meta = lambda *s: torch.zeros(s, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        TR.trial_luma(meta(4, 16, 16), meta(4, 21), meta(4, 16), 8, 8)


@pytest.mark.parametrize("size", SIZES)
def test_intra_replace_device_matches_with_adjacent_winners(size):
    """A smooth source against a reconstruction that is wrong everywhere:
    nearly every MB's trial wins, so winners are adjacent and the
    suppression (left, above-left, above, above-right of the win map)
    decides which are applied."""
    w, h = size
    mbw, mbh = w // 16, h // 16
    rng = np.random.default_rng(w)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 0.8 * (xx - w / 2) + 0.5 * (yy - h / 2)).clip(0, 255) \
        .astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    ry = rng.integers(0, 256, (h, w)).astype(np.uint8)
    ry[:16] = y[:16]                      # one MB row that needs no trial
    ru, rv = u.copy(), v.copy()
    cur = np_mb_ssim_fx(y, ry, u, ru, v, rv).astype(np.int32)
    seg = [np.array(a, np.int32) for a in
           ((20, 40, 80, 120), (25, 50, 100, 157), (18, 36, 70, 110),
            (22, 44, 90, 132))]
    tfx = target_fx(0.98)
    got = TR.intra_replace_device(
        *(torch.from_numpy(a) for a in (y, u, v, ry, ru, rv, cur)),
        *([int(x) for x in s] for s in seg), tfx, mbw, mbh)
    want = JR.intra_replace_device(
        *(jnp.asarray(a) for a in (y, u, v, ry, ru, rv, cur)),
        *(jnp.asarray(s) for s in seg), jnp.int32(tfx), mbw, mbh)
    applied = got[0].numpy()
    _eq(applied, want[0], "applied")
    names = ("sid", "modes", "lv_y", "lv_u", "lv_v", "rec_y", "rec_u",
             "rec_v")
    for g, j, what in zip(got[1:9], want[1:9], names):
        # entries of MBs that never won are zero on both sides
        _eq(g, j, what)
    _eq(got[9], want[9], "new_cur")
    a2 = applied.reshape(mbh, mbw)
    assert not a2[0].any() and a2[1:].any()
    assert not (a2[:, 1:] & a2[:, :-1]).any()       # never side by side
    assert not (a2[1:] & a2[:-1]).any()             # nor one above another
    assert a2.sum() < (mbh - 1) * mbw               # suppression decided
    assert (got[9].numpy()[applied] > cur[applied]).all()
