"""The SSIM controller's chroma trial with its score and merge
(ops/intra_replace.py:trial_chroma_merge_plain, the plain version of
csrc/transform.cu's trial_chroma_merge_kernel) against the JAX package's
loop body, over the three trials AQ -> HQ -> UQ, bit for bit (tolerance 0:
every value is an integer and both sides compute in int32).

The JAX side is composed as `intra_replace_device` composes one iteration
(vp8oclenc_tpu/ops/intra_replace.py:222-243): `_frozen_chroma_neighbors`
(with the complete ghost row of a shard below the frame top, :183-191),
`_trial_chroma` per plane, `ssim_fx.mb_ssim_fx_16x16` (xp=jnp) and the
`jnp.where` merge under `active = cur <= target`; its luma trial is
`_trial_luma` (XLA on the CPU, no Pallas kernel).  The port's side takes
`trial_luma_plain` and the wrapper `trial_chroma_merge`, which runs the
plain version on CPU tensors.  Cases: no MB wins (inactive MBs, and
active ones at the highest score there is, 3 x 32767), every MB wins,
adjacent winners of a smooth source against a wrong recon, and a ghost row
above the planes."""
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vp8oclenc_tpu.ops import intra_replace as JR
from vp8oclenc_tpu.ssim_fx import (Q3, UNCODED_FX, mb_ssim_fx,
                                   mb_ssim_fx_16x16, target_fx)
from vp8oclenc_tpu_torch.ops import intra_replace as TR

SIZES = [(96, 80), (112, 32)]
# per segment: y_dc, y_ac, uv_dc, uv_ac; the trials take 2, 1, 0
SEG = ((20, 40, 80, 120), (25, 50, 100, 157), (18, 36, 70, 110),
       (22, 44, 90, 132))
TARGET = target_fx(0.98)
CEILING = 3 * 32767               # a == d in every plane: no score is higher
FIELDS = ("sid", "modes", "lv_y", "lv_u", "lv_v", "rec_y", "rec_u", "rec_v")


def _eq(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
        f"{what}: {np.sum(got.astype(np.int64) != want)} values differ"


@lru_cache(maxsize=None)
def _luma(size):
    """A smooth luma source, a noisy frozen recon, and each side's luma
    trial at the three segments' quantizers: (y, port trials, JAX
    trials), a trial being (levels, modes, rec)."""
    w, h = size
    mbw, mbh = w // 16, h // 16
    rng = np.random.default_rng(w + h)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 0.8 * (xx - w / 2) + 0.5 * (yy - h / 2)).clip(0, 255) \
        .astype(np.uint8)
    ry = rng.integers(0, 256, (h, w)).astype(np.uint8)
    y_mb = TR._plane_mb(torch.from_numpy(y), 16).contiguous()
    ftop, fleft = TR._frozen_luma_neighbors(torch.from_numpy(ry), mbw, mbh)
    jy = JR._plane_mb(jnp.asarray(y, jnp.int32), 16)
    jtop, jleft = JR._frozen_luma_neighbors(jnp.asarray(ry), mbw, mbh)
    port, jax_ = {}, {}
    for sid in (2, 1, 0):
        q = SEG[0][sid], SEG[1][sid]
        port[sid] = TR.trial_luma_plain(y_mb, ftop, fleft, *q)
        jax_[sid] = JR._trial_luma(jy, jtop, jleft, *q)
    return y, y_mb, port, jax_


def _case(size, case):
    """Chroma source and frozen recon planes, ghost rows (or None), the
    score before the trials and the target for one case."""
    w, h = size
    w2, h2 = w // 2, h // 2
    rng = np.random.default_rng(w * 7 + len(case))
    yy, xx = np.mgrid[0:h2, 0:w2]
    u = (100 + 2 * xx - yy).clip(0, 255).astype(np.uint8)
    v = (160 - xx + 2 * yy).clip(0, 255).astype(np.uint8)
    u[:8, :8], v[:8, 8:16] = 0, 255
    ru = rng.integers(0, 256, (h2, w2)).astype(np.uint8)
    rv = rng.integers(0, 256, (h2, w2)).astype(np.uint8)
    ghosts = None
    if case == "ghost":
        ghosts = [rng.integers(0, 256, w2).astype(np.uint8)
                  for _ in range(2)]
    y, _, _, _ = _luma(size)
    mbc = (w // 16) * (h // 16)
    if case == "every MB wins":
        return u, v, ru, rv, ghosts, np.full(mbc, UNCODED_FX, np.int32), \
            TARGET
    if case == "no MB wins":                  # inactive, or unbeatable
        return u, v, ru, rv, ghosts, np.where(
            np.arange(mbc) % 2, Q3, CEILING).astype(np.int32), CEILING
    ry = np.random.default_rng(w + h).integers(0, 256, (h, w)) \
        .astype(np.uint8)                     # the frozen recon's scores
    return u, v, ru, rv, ghosts, \
        mb_ssim_fx(y, ry, u, ru, v, rv).astype(np.int32), TARGET


def _jax_trials(size, u, v, ru, rv, ghosts, cur, target):
    """The JAX loop body after the luma trial, three times: the state
    (cur, win, best_*) after each trial."""
    w, h = size
    mbw, mbh = w // 16, h // 16
    _, _, _, jluma = _luma(size)
    above = [None, None] if ghosts is None else [
        jnp.concatenate([jnp.array([129], jnp.int32),
                         jnp.asarray(g, jnp.int32)]) for g in ghosts]
    un = JR._frozen_chroma_neighbors(jnp.asarray(ru), mbw, mbh, above[0])
    vn = JR._frozen_chroma_neighbors(jnp.asarray(rv), mbw, mbh, above[1])
    y_mb = JR._plane_mb(jnp.asarray(_luma(size)[0]), 16)
    u_mb, v_mb = (JR._plane_mb(jnp.asarray(a), 8) for a in (u, v))
    mbc = mbw * mbh
    cur = jnp.asarray(cur)
    win = jnp.zeros((mbc,), bool)
    best = {"sid": jnp.zeros((mbc,), jnp.int32),
            "modes": jnp.zeros((mbc, 16), jnp.int32),
            "lv_y": jnp.zeros((mbc, 16, 16), jnp.int32),
            "lv_u": jnp.zeros((mbc, 4, 16), jnp.int32),
            "lv_v": jnp.zeros((mbc, 4, 16), jnp.int32),
            "rec_y": jnp.zeros((mbc, 16, 16), jnp.int32),
            "rec_u": jnp.zeros((mbc, 8, 8), jnp.int32),
            "rec_v": jnp.zeros((mbc, 8, 8), jnp.int32)}
    states = []
    for sid in (2, 1, 0):
        lv_y, md, ry_t = jluma[sid]
        active = cur <= target
        q = SEG[2][sid], SEG[3][sid]
        lv_u, ru_t = JR._trial_chroma(u_mb, *un, *q)
        lv_v, rv_t = JR._trial_chroma(v_mb, *vn, *q)
        test = mb_ssim_fx_16x16(y_mb, ry_t, u_mb, ru_t, v_mb, rv_t, xp=jnp)
        better = active & (test > cur)
        cur = jnp.where(better, test, cur)
        win = win | better
        for name, t in zip(FIELDS, (sid, md, lv_y, lv_u, lv_v, ry_t, ru_t,
                                    rv_t)):
            mask = better.reshape(-1, *([1] * (best[name].ndim - 1)))
            best[name] = jnp.where(mask, t, best[name])
        states.append(dict(best, cur=cur, win=win))
    return states


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", ["no MB wins", "every MB wins",
                                  "adjacent winners", "ghost"])
def test_trial_chroma_merge_matches_jax(size, case):
    w, h = size
    u, v, ru, rv, ghosts, cur, target = _case(size, case)
    want = _jax_trials(size, u, v, ru, rv, ghosts, cur, target)
    _, y_mb, luma, _ = _luma(size)
    t = lambda a: torch.from_numpy(a)
    tg = (None, None) if ghosts is None else tuple(map(t, ghosts))
    st = TR.merge_state(y_mb.shape[0], "cpu")
    cur_in = t(cur)
    for k, sid in enumerate((2, 1, 0)):
        TR.trial_chroma_merge(y_mb, luma[sid], t(u), t(v), t(ru), t(rv), tg,
                              cur_in, st, sid, SEG[2][sid], SEG[3][sid],
                              target)
        cur_in = st["cur"]
        for name, j in want[k].items():
            _eq(st[name], j, f"trial {k}: {name}")
    assert [st[n].dtype for n in FIELDS] == [
        torch.int32, torch.int8, torch.int16, torch.int16, torch.int16,
        torch.uint8, torch.uint8, torch.uint8]
    win = st["win"].numpy()
    if case == "no MB wins":
        assert not win.any()
        _eq(st["cur"], cur, "cur unchanged")
    elif case == "every MB wins":
        assert win.all()
        assert len(np.unique(st["sid"].numpy())) > 1   # later trials won
    else:
        w2 = win.reshape(h // 16, w // 16)
        assert (w2[:, 1:] & w2[:, :-1]).any()           # side by side
    assert TR.trial_chroma_merge.launches == 0          # the CPU's plain


def test_trial_chroma_merge_reads_the_ghost_row():
    """The ghost rows decide the top MB row's prediction: the same planes
    under another ghost row give other levels there and the same below."""
    size = SIZES[0]
    u, v, ru, rv, ghosts, cur, _ = _case(size, "ghost")
    _, y_mb, luma, _ = _luma(size)
    t = lambda a: torch.from_numpy(a)
    cur = np.full_like(cur, UNCODED_FX)                 # every MB wins
    out = []
    for g in (ghosts, [255 - a for a in ghosts], None):
        st = TR.merge_state(y_mb.shape[0], "cpu")
        tg = (None, None) if g is None else tuple(map(t, g))
        TR.trial_chroma_merge(y_mb, luma[2], t(u), t(v), t(ru), t(rv), tg,
                              t(cur), st, 2, SEG[2][2], SEG[3][2], TARGET)
        out.append(torch.cat([st["lv_u"], st["lv_v"]], 1))
    mbw = size[0] // 16
    for other in out[1:]:
        assert not torch.equal(out[0][:mbw], other[:mbw])
        assert torch.equal(out[0][mbw:], other[mbw:])
