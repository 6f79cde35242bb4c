"""The inter frame's segment passes with their integer SSIM
(ops/inter.py:inter_pass_plain, the plain version of csrc/transform.cu's
inter_pass_kernel) and the SSIM
controller's two-plane chroma trial (ops/intra_replace.py:
trial_chroma_plain, a piece of trial_chroma_merge_plain, the plain version
of trial_chroma_merge_kernel) against the JAX package on the
same seeded inputs, with exact equality (tolerance 0: every value is an
integer and both sides compute in int32).

The JAX side is composed as its `seg_pass` composes it
(vp8oclenc_tpu/ops/inter.py:922-959): `transform_mb_luma`,
`transform_mb_chroma`, the clamped recon and `jnp.where` merges under the
pass's mask, the MB scores of `ssim_fx.mb_ssim_fx` (xp=jnp) merged into
cur_ssim, the first pass with every MB at UNCODED_FX.  JAX runs its XLA
path on the CPU (no Pallas kernel is involved).  On CPU tensors the
wrapper `inter_pass` takes its plain version."""
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vp8oclenc_tpu.ops import inter as JI
from vp8oclenc_tpu.ops import intra_replace as JR
from vp8oclenc_tpu.ssim_fx import UNCODED_FX, mb_ssim_fx
from vp8oclenc_tpu_torch.ops import inter as TI
from vp8oclenc_tpu_torch.ops import intra_replace as TR

# (y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac): the extremes, chroma at the
# luma pair as tests/test_torch_inter.py:test_transform_mb_matches takes it
LOW = (4, 4, 8, 8, 4, 4)
HIGH = (157, 284, 314, 440, 157, 284)
SIZES = [(96, 80), (16, 16), (112, 16)]     # the last: one MB row
TARGET = 0


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
        f"{what}: {np.sum(got != want)} values differ"


def _pass_inputs(w, h, seed):
    """Source and prediction planes with +-255 residuals: in MB 0 the top
    block row at +255 and the next at -255, chroma block 0 at +255 and
    block 3 at -255; MB 1, where there is one, at +255 throughout.  Mixed
    partitionings; per pass a cur_ssim around TARGET, so some MBs are
    active and some are not."""
    rng = np.random.default_rng(seed)
    mbw, mbh = w // 16, h // 16
    src = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    pred = [(s.astype(np.int32) + rng.integers(-30, 31, s.shape))
            .clip(0, 255) for s in src]
    src[0][:4, :16], pred[0][:4, :16] = 255, 0
    src[0][4:8, :16], pred[0][4:8, :16] = 0, 255
    for c in (1, 2):
        src[c][:4, :4], pred[c][:4, :4] = 255, 0
        src[c][4:8, 4:8], pred[c][4:8, 4:8] = 0, 255
    if mbw > 1:
        src[0][:16, 16:32], pred[0][:16, 16:32] = 255, 0
    parts = rng.integers(0, 2, mbw * mbh).astype(np.int32)
    return src, pred, parts, rng


_jax_mb_ssim = jax.jit(partial(mb_ssim_fx, xp=jnp))


@lru_cache(maxsize=None)
def _jax_transforms(q):
    """JAX's transform_mb_luma and transform_mb_chroma at the quantizers
    q, each compiled once."""
    return (jax.jit(lambda r, pt: JI.transform_mb_luma(r, pt, *q[:4])),
            jax.jit(lambda r: JI.transform_mb_chroma(r, *q[4:])))


def _jax_passes(src, pred, parts, quants, curs):
    """The JAX package's passes, pass i starting from cur_ssim curs[i]:
    state after each, as the port lays it out (levels_pack i16, seg_ids,
    recon planes u8, active, cur_ssim)."""
    h, w = src[0].shape
    mbw, mbh = w // 16, h // 16
    mbc = mbw * mbh
    s = [jnp.asarray(a, jnp.int32) for a in src]
    p = [jnp.asarray(a, jnp.int32) for a in pred]
    res_y = JI._mb_blocks_luma(s[0] - p[0], mbw, mbh)
    res_u = JI._mb_blocks_chroma(s[1] - p[1], mbw, mbh)
    res_v = JI._mb_blocks_chroma(s[2] - p[2], mbw, mbh)
    pb = (JI._mb_blocks_luma(p[0], mbw, mbh),
          JI._mb_blocks_chroma(p[1], mbw, mbh),
          JI._mb_blocks_chroma(p[2], mbw, mbh))
    jparts = jnp.asarray(parts)
    ly = jnp.zeros((mbc, 16, 16), jnp.int32)
    ly2 = jnp.zeros((mbc, 16), jnp.int32)
    lu = jnp.zeros((mbc, 4, 16), jnp.int32)
    lv = jnp.zeros((mbc, 4, 16), jnp.int32)
    seg = jnp.full((mbc,), 3, jnp.int32)
    rec = [jnp.zeros(b.shape, jnp.int32) for b in pb]
    out = []
    for i, (q, cur) in enumerate(zip(quants, curs)):
        sid = 3 - i
        cur = jnp.asarray(cur)
        active = cur <= TARGET
        luma, chroma = _jax_transforms(q)
        lz, y2z, rr = luma(res_y, jparts)
        uz, ur = chroma(res_u)
        vz, vr = chroma(res_v)
        am, amb = active[:, None, None], active[:, None, None, None]
        seg = jnp.where(active, sid, seg)
        ly = jnp.where(am, lz, ly)
        ly2 = jnp.where(active[:, None], y2z, ly2)
        lu = jnp.where(am, uz, lu)
        lv = jnp.where(am, vz, lv)
        rec = [jnp.where(amb, jnp.clip(b + r, 0, 255), old)
               for b, r, old in zip(pb, (rr, ur, vr), rec)]
        pack = jnp.concatenate([ly, lu, lv, ly2[:, None]], axis=1) \
            .astype(jnp.int16)
        planes = (JI._luma_from_mb_blocks(rec[0], mbw, mbh),
                  JI._chroma_from_mb_blocks(rec[1], mbw, mbh),
                  JI._chroma_from_mb_blocks(rec[2], mbw, mbh))
        cur = jnp.where(active, _jax_mb_ssim(*(t for pair in zip(s, planes)
                                               for t in pair)), cur)
        out.append((pack, seg, *(a.astype(jnp.uint8) for a in planes),
                    active, cur))
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("first_q", [LOW, HIGH])
@pytest.mark.parametrize("npass", [1, 4])
def test_inter_pass_matches_jax(size, first_q, npass):
    """1 or 4 passes (LQ -> UQ), the quantizers alternating between the
    two extremes, against the JAX package's seg_pass composed from its
    functions; every pass's state equal, cur_ssim included.  Before each
    later pass both sides take the same injected cur_ssim, so that the
    masks mix whatever the scores."""
    w, h = size
    src, pred, parts, rng = _pass_inputs(w, h, w + h + first_q[0] + npass)
    mbc = parts.size
    other = HIGH if first_q == LOW else LOW
    quants = [first_q, other, first_q, other][:npass]
    curs = [np.full(mbc, UNCODED_FX, np.int32)] + [
        rng.integers(TARGET - 3, TARGET + 3, mbc).astype(np.int32)
        for _ in range(npass - 1)]
    want = _jax_passes(src, pred, parts, quants, curs)
    y, u, v = (torch.from_numpy(a) for a in src)
    # the inter path's operand types: u8 luma prediction, int32 chroma
    py = torch.from_numpy(pred[0].astype(np.uint8))
    pu, pv = (torch.from_numpy(a.astype(np.int32)) for a in pred[1:])
    tparts = torch.from_numpy(parts)
    state = None
    for i, q in enumerate(quants):
        if i:
            state[6].copy_(torch.from_numpy(curs[i]))
        state = TI.inter_pass(y, u, v, py, pu, pv, tparts, 3 - i, q, TARGET,
                              state)
        assert len(state) == len(want[i]) == len(TI._STATE)
        for g, j, what in zip(state, want[i], TI._STATE):
            _eq(g, j, f"pass {i} {what}")
    assert [t.dtype for t in state] == [torch.int16, torch.int32,
                                        torch.uint8, torch.uint8,
                                        torch.uint8, torch.bool,
                                        torch.int32]
    if npass > 1 and mbc > 1:
        seg = state[1].numpy()
        assert len(np.unique(seg)) > 1            # masks mixed the segments
    lp = state[0].numpy()
    y2 = parts == 0                               # ARE16X16
    assert (lp[~y2, 24] == 0).all() and (lp[y2, :16, 0] == 0).all()


def test_inter_pass_in_place():
    """A later pass writes into the state it is given and leaves its
    inactive MBs as earlier passes wrote them, their cur_ssim included."""
    src, pred, parts, _ = _pass_inputs(96, 80, 5)
    args = [torch.from_numpy(a) for a in src] + [
        torch.from_numpy(a.astype(np.int32)) for a in pred] + [
        torch.from_numpy(parts)]
    state = TI.inter_pass(*args, 3, LOW)
    scores = state[6].clone()
    cur = torch.arange(parts.size, dtype=torch.int32) % 2   # odd: inactive
    state[6].copy_(cur)
    before = [t.clone() for t in state]
    out = TI.inter_pass(*args, 2, HIGH, 0, state)
    assert all(a is b for a, b in zip(out, state))
    active = cur == 0
    assert torch.equal(state[5], active)
    assert torch.equal(state[0][~active], before[0][~active])
    assert not torch.equal(state[0][active], before[0][active])
    assert (state[1][~active] == 3).all() and (state[1][active] == 2).all()
    assert torch.equal(state[6][~active], cur[~active])
    assert (state[6][active] > 0).all() and (scores > 0).all()


def _chroma_inputs(w, h, seed):
    """u and v source planes with an all-0 and an all-255 MB, and the
    frozen neighbours of two other planes."""
    rng = np.random.default_rng(seed)
    c = [rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
         for _ in range(4)]
    c[0][:8, :8] = 0
    c[1][:8, -8:] = 255
    return c


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("q", [LOW[4:], HIGH[4:]])
def test_trial_chroma_matches_jax(size, q):
    """Both planes in one call against JAX's `_trial_chroma` per plane."""
    w, h = size
    mbw, mbh = w // 16, h // 16
    u, v, ru, rv = _chroma_inputs(w, h, w + q[0])
    u_mb, v_mb = (TR._plane_mb(torch.from_numpy(a), 8) for a in (u, v))
    un, vn = (TR._frozen_chroma_neighbors(torch.from_numpy(a), mbw, mbh)
              for a in (ru, rv))
    got = TR.trial_chroma_plain(u_mb, v_mb, un, vn, *q)
    for k, (src, rec) in enumerate(((u, ru), (v, rv))):
        jnb = JR._frozen_chroma_neighbors(jnp.asarray(rec), mbw, mbh)
        want = JR._trial_chroma(JR._plane_mb(jnp.asarray(src), 8), *jnb, *q)
        _eq(got[2 * k], want[0], f"plane {k} levels")
        _eq(got[2 * k + 1], want[1], f"plane {k} rec")
        assert got[2 * k].dtype == got[2 * k + 1].dtype == torch.int32
