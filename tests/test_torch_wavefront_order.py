"""The order in which the CUDA kernels of the loop filter and of the luma
and chroma wavefronts take their units, held against the plain versions on
the CPU.

The kernels give each MB row to one CTA and let row r take unit bx once row
r-1 is past bx+1 (for luma the same rule between the 4x4-block rows,
inside an MB row and across MB rows); rows otherwise run at any speed.
The chroma kernel's rule is weaker: TM_PRED reads nothing above-right, so
row r takes MB bx once row r-1 is past bx itself (a lag of 1).
Here the units run one at a time through the plain versions' step
functions (`filter_step`, `luma_step`, `chroma_step`) in seeded random
orders drawn from exactly what that rule allows, luma and chroma from a
reconstruction poisoned with a sentinel wherever nothing is coded yet.
Every such order must give the plain versions' outputs, and the JAX
package's, bit for bit (tolerance 0); with a lag of 1 instead of 2 (chroma:
0 instead of 1) the outputs must differ, which shows that the test can
fail.  The luma trial's in-MB order is tested the same way, at the end.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vp8oclenc_tpu.ops import intra_replace as JR
from vp8oclenc_tpu.ops.intra import build_intra_kernel
from vp8oclenc_tpu.ops.loopfilter import filter_planes as jax_filter_planes
from vp8oclenc_tpu.pipeline.segments import derive_filter_limits
from vp8oclenc_tpu_torch.ops import intra as TI
from vp8oclenc_tpu_torch.ops import intra_replace as TR
from vp8oclenc_tpu_torch.ops import loopfilter as TLF

SIZES = [(96, 80), (48, 96), (16, 64)]          # (w, h)
SENTINEL = 1 << 20


def allowed_order(rng, n_rows, n_cols, lag=2):
    """A random order of the units (row, col) in which every row runs left
    to right and row r takes column c only when row r-1 has done
    min(c + lag, n_cols) units."""
    done = [0] * n_rows
    order = []
    while len(order) < n_rows * n_cols:
        ready = [r for r in range(n_rows) if done[r] < n_cols and (
            r == 0 or done[r - 1] >= min(done[r] + lag, n_cols))]
        r = ready[rng.integers(len(ready))]
        order.append((r, done[r]))
        done[r] += 1
    return order


def test_allowed_orders_differ_from_the_diagonal_order():
    rng = np.random.default_rng(0)
    a, b = allowed_order(rng, 5, 6), allowed_order(rng, 5, 6)
    assert a != b and sorted(a) == sorted(b)
    diag = sorted(a, key=lambda u: (u[1] + 2 * u[0], u[0]))
    assert a != diag
    # a row can run far ahead of the row below it
    assert max(c - sum(1 for u in a[:i] if u[0] == r + 1)
               for i, (r, c) in enumerate(a) if r < 4) > 2


def _filter_inputs(w, h, seed):
    rng = np.random.default_rng(seed)
    mbc = (w // 16) * (h // 16)
    # 4-pixel steps under noise: edges that the filter changes, unevenly
    ramp = np.add.outer(np.arange(h) // 4 * 7, np.arange(w) // 4 * 5) % 60
    y = (ramp + 100 + rng.integers(0, 10, (h, w))).astype(np.uint8)
    u = (ramp[::2, ::2] + 90 + rng.integers(0, 4, (h // 2, w // 2))) \
        .astype(np.uint8)
    v = rng.integers(90, 140, (h // 2, w // 2)).astype(np.uint8)
    level = np.array([40, 0, 25, 63], np.int32)   # segment 1 unfiltered
    intr, mbe, sbe, hev = derive_filter_limits(level, 2, False)
    sid = rng.integers(0, 4, mbc).astype(np.int32)
    inner = rng.random(mbc) < 0.6
    return y, u, v, sid, inner, level, mbe, sbe, intr, hev


def _filter_in_order(args, order):
    st = TLF.filter_state(*args)
    for by, bx in order:
        TLF.filter_step(st, torch.tensor([by]), torch.tensor([bx]))
    return TLF.filter_result(st)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_in_any_allowed_order(size, seed):
    w, h = size
    raw = _filter_inputs(w, h, seed)
    args = [torch.from_numpy(np.asarray(a)) for a in raw]
    order = allowed_order(np.random.default_rng(seed + 10), h // 16, w // 16)
    got = _filter_in_order(args, order)
    want = TLF.filter_planes_plain(*args)
    assert not torch.equal(want[0], args[0])     # the filter did work
    for g, p in zip(got, want):
        assert g.dtype == torch.uint8 and torch.equal(g, p)
    jx = jax_filter_planes(*(jnp.asarray(a) for a in raw), w // 16, h // 16)
    for g, j in zip(got, jx):
        assert np.array_equal(g.numpy(), np.asarray(j))


def _luma_plane(w, h, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w)).astype(np.uint8)


def _luma_in_order(y, q, order):
    st = TI.luma_state(y)
    st["rec"].fill_(SENTINEL)
    for by, bx in order:
        TI.luma_step(st, torch.tensor([by]), torch.tensor([bx]), *q)
    return TI.luma_result(st)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("seed,q", [(0, (8, 10)), (1, (60, 75))])
def test_luma_in_any_allowed_order(size, seed, q):
    w, h = size
    y = torch.from_numpy(_luma_plane(w, h, seed))
    order = allowed_order(np.random.default_rng(seed + 20), h // 4, w // 4)
    got = _luma_in_order(y, q, order)
    want = TI.luma_wavefront_plain(y, *q)
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and torch.equal(g, p)
    assert len(torch.unique(got[2])) > 3         # several modes in use


def test_luma_in_allowed_order_matches_jax():
    w, h = 48, 96
    q = (8, 10)
    yn = _luma_plane(w, h, 2)
    order = allowed_order(np.random.default_rng(5), h // 4, w // 4)
    got = _luma_in_order(torch.from_numpy(yn), q, order)
    c = np.full((h // 2, w // 2), 128, np.uint8)
    want = build_intra_kernel(w, h)(
        jnp.asarray(yn), jnp.asarray(c), jnp.asarray(c),
        *(jnp.int32(x) for x in (*q, *q)))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[3])[:, :16])
    assert np.array_equal(got[2].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("which", ["filter", "luma"])
def test_a_lag_of_one_is_not_enough(which):
    """Row r taking unit bx as soon as row r-1 has done bx itself reads
    pixels that row r-1's unit bx+1 has yet to write (its left MB edge;
    the above-right block): some allowed-by-lag-1 order must differ."""
    w, h = 96, 80
    rng = np.random.default_rng(3)
    if which == "filter":
        args = [torch.from_numpy(np.asarray(a))
                for a in _filter_inputs(w, h, 0)]
        want = TLF.filter_planes_plain(*args)
        got = _filter_in_order(args, allowed_order(rng, h // 16, w // 16, 1))
    else:
        y = torch.from_numpy(_luma_plane(w, h, 0))
        want = TI.luma_wavefront_plain(y, 8, 10)
        got = _luma_in_order(y, (8, 10),
                             allowed_order(rng, h // 4, w // 4, 1))
    assert not torch.equal(got[0], want[0])


def _chroma_planes(w, h, seed):
    """U and V of a w x h frame: noise, and a ramp under a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h // 2, 0:w // 2]
    u = rng.integers(0, 256, (h // 2, w // 2))
    v = ((xx * 5 + yy * 3 + 60) % 210 + rng.integers(0, 20, (h // 2, w // 2)))
    return np.stack([u, v.clip(0, 255)]).astype(np.uint8)


def _chroma_in_order(uv, q, order):
    st = TI.chroma_state(uv)
    st["rec"].fill_(SENTINEL)
    for by, bx in order:
        TI.chroma_step(st, torch.tensor([by]), torch.tensor([bx]), *q)
    return TI.chroma_result(st)


def test_chroma_orders_let_a_row_follow_one_mb_behind():
    order = allowed_order(np.random.default_rng(1), 5, 6, lag=1)
    at = {u: i for i, u in enumerate(order)}
    assert all(at[(r - 1, c)] < at[(r, c)] for r, c in order if r)
    # somewhere row r codes MB c before row r-1 has coded MB c+1
    assert any(at[(r, c)] < at[(r - 1, c + 1)] for r, c in order
               if r and c + 1 < 6)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("seed,q", [(0, (8, 10)), (1, (60, 75))])
def test_chroma_in_any_allowed_order(size, seed, q):
    w, h = size
    uv = torch.from_numpy(_chroma_planes(w, h, seed))
    order = allowed_order(np.random.default_rng(seed + 30), h // 16, w // 16,
                          lag=1)
    got = _chroma_in_order(uv, q, order)
    want = TI.chroma_wavefront_plain(uv, *q)
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and torch.equal(g, p)
    assert int(got[1].abs().max()) > 0           # something was coded


@pytest.mark.parametrize("size", [(48, 96), (96, 80)])
def test_chroma_in_allowed_order_matches_jax(size):
    """Against the chroma outputs of the JAX package's intra_body on its
    XLA path (the CPU's)."""
    w, h = size
    q = (8, 10)
    uvn = _chroma_planes(w, h, 2)
    order = allowed_order(np.random.default_rng(6), h // 16, w // 16, lag=1)
    got = _chroma_in_order(torch.from_numpy(uvn), q, order)
    yn = _luma_plane(w, h, 3)
    want = build_intra_kernel(w, h)(
        jnp.asarray(yn), jnp.asarray(uvn[0]), jnp.asarray(uvn[1]),
        *(jnp.int32(x) for x in (*q, *q)))
    assert np.array_equal(got[0][0].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[0][1].numpy(), np.asarray(want[2]))
    assert np.array_equal(got[1][0].numpy(), np.asarray(want[3])[:, 16:20])
    assert np.array_equal(got[1][1].numpy(), np.asarray(want[3])[:, 20:24])


@pytest.mark.parametrize("seed", [0, 1])
def test_chroma_without_the_lag_differs(seed):
    """Row r taking MB bx when row r-1 has only done bx MBs reads the
    bottom line of an MB that is not coded yet."""
    w, h = 96, 80
    uv = torch.from_numpy(_chroma_planes(w, h, seed))
    want = TI.chroma_wavefront_plain(uv, 8, 10)
    order = allowed_order(np.random.default_rng(seed + 3), h // 16, w // 16,
                          lag=0)
    got = _chroma_in_order(uv, (8, 10), order)
    assert not torch.equal(got[0], want[0])


# The luma trial (csrc/intra.cu, trial_luma_kernel) may code block (bx, by)
# of an MB once its left, above, above-left and (bx < 3) above-right
# neighbours are coded; the kernel takes them in raster order, one MB a
# half-warp (an earlier version took the wavefront d = bx + 2*by, two
# blocks a step).  Here an MB's blocks run through `trial_step` in random
# orders of steps of one or two blocks that rule allows, each MB its own
# order, from a poisoned reconstruction; the blocks of one step read before
# either writes.

def _trial_deps(b):
    bx, by = b % 4, b // 4
    deps = []
    if bx:
        deps.append(b - 1)
    if by:
        deps += [b - 4] + ([b - 5] if bx else []) + ([b - 3] if bx < 3 else [])
    return deps


def trial_steps(rng):
    """A random order of an MB's 16 blocks in steps of one or two blocks,
    each block after its neighbours, the two of a step independent."""
    done, steps = set(), []
    while len(done) < 16:
        ready = [b for b in range(16) if b not in done
                 and all(d in done for d in _trial_deps(b))]
        k = 2 if len(ready) > 1 and rng.random() < 0.7 else 1
        step = [int(b) for b in rng.choice(ready, k, replace=False)]
        steps.append(step)
        done.update(step)
    return steps


RASTER = [[b] for b in range(16)]
WAVEFRONT = [[0], [1], [2, 4], [3, 5], [6, 8], [7, 9], [10, 12], [11, 13],
             [14], [15]]


def _trial_inputs(mbc, seed):
    """Sources and frozen neighbours: noise, a ramp, all 0, all 255."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (mbc, 16, 16))
    y[1::4] = np.add.outer(np.arange(16), np.arange(16)) * 5 + 30
    y[2::4], y[3::4] = 0, 255
    t = lambda *s: torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
    return torch.from_numpy(y.astype(np.uint8)), t(mbc, 21), t(mbc, 16)


def _trial_in_order(inputs, q, orders):
    """Each MB's steps (orders[mb]) through `trial_step`; step t of every
    MB in one call."""
    st = TR.trial_state(*inputs)
    st["edge"][:, 1:, 1:17] = SENTINEL
    for t in range(max(len(o) for o in orders)):
        pairs = [(mb, b) for mb, o in enumerate(orders) if t < len(o)
                 for b in o[t]]
        mb, blk = (torch.tensor(v) for v in zip(*pairs))
        TR.trial_step(st, mb, blk, *q)
    return TR.trial_result(st)


def test_trial_steps_follow_the_rule():
    for d, blocks in enumerate(WAVEFRONT):
        assert all(b % 4 + 2 * (b // 4) == d for b in blocks)
        assert all(e % 4 + 2 * (e // 4) < d
                   for b in blocks for e in _trial_deps(b))
    assert all(e < b for b in range(16) for e in _trial_deps(b))   # raster
    rng = np.random.default_rng(0)
    orders = [trial_steps(rng) for _ in range(20)]
    assert len({str(o) for o in orders}) == 20
    assert any(len(s) == 2 for o in orders for s in o)
    # pairs that the wavefront never makes
    assert any(len(s) == 2 and sorted(s) not in WAVEFRONT
               for o in orders for s in o)


@pytest.mark.parametrize("q", [(4, 4), (60, 75), (157, 284)])
def test_trial_in_any_allowed_order(q):
    mbc = 24
    inputs = _trial_inputs(mbc, q[0])
    rng = np.random.default_rng(q[1])
    orders = [RASTER, WAVEFRONT] + [trial_steps(rng) for _ in range(mbc - 2)]
    got = _trial_in_order(inputs, q, orders)
    want = TR.trial_luma_plain(*inputs, *q)
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and torch.equal(g, p)
    assert len(torch.unique(got[1])) > 3         # several modes in use
    jx = JR._trial_luma(*(jnp.asarray(t.numpy().astype(np.int32))
                          for t in inputs), *q)
    for g, j in zip(got, jx):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(j))


@pytest.mark.parametrize("steps", [
    [[0], [4], [1]],                 # (0, 1) before its above-right (1, 0)
    [[0], [1, 4]]])                  # the two in one step
def test_trial_before_the_above_right_differs(steps):
    """Block (0, 1) coded before (1, 0), or beside it, reads an above-right
    neighbour that is not coded yet."""
    mbc = 8
    inputs = _trial_inputs(mbc, 5)
    q = (60, 75)
    rest = [[b] for b in range(16) if all(b not in s for s in steps)]
    got = _trial_in_order(inputs, q, [steps + rest] * mbc)
    want = TR.trial_luma_plain(*inputs, *q)
    assert not torch.equal(got[2], want[2])
