"""The port's SSIM-controller modules (ssim_fx.py and
ops/intra_replace.py) against the JAX package's ssim_fx.py and
ops/intra_replace.py on the same seeded inputs, bit for bit (tolerance 0).
The JAX luma trial is `_trial_luma`, the XLA reference its Pallas kernel is
held to; the port's is `trial_luma_plain`, the plain version its CUDA
kernel is held to on the card (tests/test_torch_cuda.py).  Likewise the
integer SSIM's wrappers run their plain versions here, which csrc/ssim.cu
is held to on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vp8oclenc_tpu.ops import intra_replace as JR
from vp8oclenc_tpu.ssim_fx import mb_ssim_fx as np_mb_ssim_fx
from vp8oclenc_tpu.ssim_fx import mb_ssim_fx_16x16 as np_mb_ssim_fx_16x16
from vp8oclenc_tpu.ssim_fx import target_fx
from vp8oclenc_tpu_torch import ssim_fx as TS
from vp8oclenc_tpu_torch.ops import inter as TI
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


def test_divq15_saturates_at_one():
    """The contract csrc/ssim.cu copies: floor(a * 32768 / d) for a < d,
    and 32767 (not 32768) for a == d, up to the largest d2 of a 16x16
    block (all 0 beside all 255 in both blocks)."""
    rng = np.random.default_rng(3)
    d = np.concatenate([[1, 2, 5, 100, 26634, 1067287269, (1 << 30) - 1],
                        rng.integers(1, 1 << 30, 2000)]).astype(np.int64)
    a = (rng.random(d.size) * d).astype(np.int64)       # 0 <= a < d
    a[:4] = 0
    a[4:7] = d[4:7] - 1
    ti = lambda x: torch.from_numpy(x.astype(np.int32))
    _eq(TS._divq15(ti(d), ti(d)), np.full(d.size, 32767), "a == d")
    _eq(TS._divq15(ti(a), ti(d)), (a * 32768) // d, "a < d")


def _ssim_edge_planes(mbw, mbh, seed):
    """int32 numpy planes (y, ry, u, ru, v, rv) of mbw x mbh MBs: noise, a
    recon near the source, and as the first MBs the edge blocks: identical
    source and recon, flat against flat, all 0 against all 255, all 255
    against all 255 and against all 0."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(0, 256, (mbh * n, mbw * n)) for n in (16, 8, 8)]
    rec = [(p + rng.integers(-9, 10, p.shape)).clip(0, 255) for p in src]
    for k, pair in enumerate([None, (100, 100), (0, 255), (255, 255),
                              (255, 0)][:mbw * mbh]):
        for p, r, n in zip(src, rec, (16, 8, 8)):
            cut = np.s_[k // mbw * n:(k // mbw + 1) * n,
                        k % mbw * n:(k % mbw + 1) * n]
            if pair is None:
                r[cut] = p[cut]
            else:
                p[cut], r[cut] = pair
    return [a.astype(np.int32) for pair in zip(src, rec) for a in pair]


def _torch_operands(planes, rec_dtype):
    """u8 source planes, recon planes in rec_dtype."""
    return [torch.from_numpy(a).to(torch.uint8 if i % 2 == 0 else rec_dtype)
            for i, a in enumerate(planes)]


@pytest.mark.parametrize("shape", [(1, 1), (7, 1), (61, 1), (5, 3)])
@pytest.mark.parametrize("rec_dtype", [torch.uint8, torch.int32])
def test_mb_ssim_planes_match(shape, rec_dtype):
    """Whole planes, the inter path's form, through the wrapper's CPU path
    against JAX (xp=jnp) and numpy; the edge MBs score as they must."""
    planes = _ssim_edge_planes(*shape, seed=shape[0] * 10 + shape[1])
    got = TS.mb_ssim_fx(*_torch_operands(planes, rec_dtype))
    assert got.dtype == torch.int32
    _eq(got, np_mb_ssim_fx(*planes), "numpy")
    _eq(got, np_mb_ssim_fx(*(jnp.asarray(a) for a in planes), xp=jnp), "jax")
    _eq(got, TS.mb_ssim_fx_plain(*_torch_operands(planes, rec_dtype)),
        "plain")
    if shape[0] * shape[1] >= 5:
        # identical blocks: L and CS both saturate, 32767*32767 >> 15 a
        # plane; flat against flat likewise; 0 against 255 pays the penalty
        assert got[0] == got[1] == got[3] == 3 * 32766
        assert got[2] < 0 and got[4] < 0


@pytest.mark.parametrize("mbc", [1, 7, 61])
@pytest.mark.parametrize("rec_dtype", [torch.uint8, torch.int32])
def test_mb_ssim_patches_match(mbc, rec_dtype):
    """Per-MB patches, the trial path's form: (mbc, n, n) cut by
    `_plane_mb` from one MB row (a non-contiguous view there) and as a
    contiguous copy, and (1, mbc, n, n) views of the planes, through the
    wrapper's CPU path against JAX (xp=jnp) and numpy."""
    planes = _ssim_edge_planes(mbc, 1, seed=mbc)
    ts = _torch_operands(planes, rec_dtype)
    sizes = (16, 16, 8, 8, 8, 8)
    views = [TR._plane_mb(t, n) for t, n in zip(ts, sizes)]
    if mbc > 1:
        assert not views[0].is_contiguous()
    patches = [np.asarray(v.to(torch.int32)) for v in views]
    want = np_mb_ssim_fx(*planes)
    _eq(np_mb_ssim_fx_16x16(*patches), want, "numpy patches")
    _eq(np_mb_ssim_fx_16x16(*(jnp.asarray(a) for a in patches), xp=jnp),
        want, "jax patches")
    for form in (views, [v.contiguous() for v in views],
                 [t.reshape(1, n, mbc, n).transpose(1, 2)
                  for t, n in zip(ts, sizes)]):
        got = TS.mb_ssim_fx_16x16(*form)
        assert got.dtype == torch.int32
        _eq(got.reshape(-1), want, "torch patches")


# quantizers far above VP8's: every level is 0, so a pass's recon is its
# prediction, whatever the residual
NO_RESIDUAL = (5000, 5000, 100000, 100000, 5000, 5000)


@pytest.mark.parametrize("case", ["0_vs_255", "dc_penalty", "inactive"])
def test_pass_scores_edge_mbs(case):
    """The segment pass's own score (inter_pass, which csrc/transform.cu
    holds to its plain version on the card) of edge MBs against the JAX
    package's mb_ssim_fx on the recon the pass wrote: MB 0 an all-0
    source against an all-255 recon (n*q1 - s1^2 leaves int32 in the JAX
    package's arithmetic, not in the port's), or a flat 200 against a
    flat 100 (|s1 - s2| > 4n: the DC penalty); or, in a second pass, MB 0
    inactive, its cur_ssim left as given."""
    rng = np.random.default_rng(len(case))
    src = [rng.integers(0, 256, (n, n)).astype(np.uint8) for n in (32, 16, 16)]
    pred = [np.clip(a.astype(np.int32) + rng.integers(-20, 21, a.shape), 0,
                    255).astype(np.uint8) for a in src]
    pair = {"0_vs_255": (0, 255), "dc_penalty": (200, 100)}.get(case)
    for a, b, n in zip(src, pred, (16, 8, 8)):
        if pair:
            a[:n, :n], b[:n, :n] = pair
    t = [torch.from_numpy(a) for a in src + pred]
    parts = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    state = TI.inter_pass(*t, parts, 3, NO_RESIDUAL)
    if case == "inactive":
        state[6].copy_(torch.tensor([7, -1, 0, 5], dtype=torch.int32))
        TI.inter_pass(*t, parts, 2, (7, 9, 12, 14, 6, 8), 0, state)
        assert state[5].tolist() == [False, True, True, False]
        assert state[6][0] == 7 and state[6][3] == 5
    recon = [a.numpy() for a in state[2:5]]
    planes = [a for pair_ in zip(src, recon) for a in pair_]
    want = np_mb_ssim_fx(*planes)
    active = state[5].numpy()
    _eq(state[6][active], want[active], "pass score")
    _eq(state[6][active], np.asarray(np_mb_ssim_fx(
        *(jnp.asarray(a) for a in planes), xp=jnp))[active], "jax")
    if pair:
        assert all((r[:n, :n] == pair[1]).all()
                   for r, n in zip(recon, (16, 8, 8)))
        assert state[6][0] < 0 < state[6][1]      # the penalty weighs in


def test_mb_ssim_refuses_mixed_devices_and_types():
    y = torch.zeros((16, 16), dtype=torch.uint8)
    c = torch.zeros((8, 8), dtype=torch.uint8)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError):
        TS.mb_ssim_fx(y, meta(y), c, c, c, c)
    with pytest.raises(ValueError):
        TS.mb_ssim_fx_16x16(*(meta(t) for t in (y, y, c, c, c, c)))
    with pytest.raises(ValueError):
        TS.mb_ssim_fx(y, y.to(torch.int16), c, c, c, c)


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
