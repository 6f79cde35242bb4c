"""The port's inter-frame modules (ops/inter.py, ssim_fx.py, the inter
half of ops/transforms.py and filter_from_meta) against the JAX package's
ops/inter.py, ops/transforms.py, ssim_fx.py and ops/loopfilter.py on the
same seeded inputs, bit for bit (tolerance 0).  On the CPU the JAX side
runs its XLA path (pallas_kernels.mode() is "off"), and the port runs the
plain versions of its search kernels."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vp8oclenc_tpu.config import EncoderConfig as JaxConfig
from vp8oclenc_tpu.io.y4m import pad_frame
from vp8oclenc_tpu.ops import inter as JI
from vp8oclenc_tpu.ops import transforms as JT
from vp8oclenc_tpu.ops.loopfilter import build_filter_from_meta_kernel
from vp8oclenc_tpu.pipeline.segments import prepare_segments
from vp8oclenc_tpu.ssim_fx import WEAKEN_FX, mb_ssim_fx as np_mb_ssim_fx
from vp8oclenc_tpu_torch import ssim_fx as TS
from vp8oclenc_tpu_torch.ops import inter as TI
from vp8oclenc_tpu_torch.ops import transforms as TT
from vp8oclenc_tpu_torch.ops.backend import filter_from_meta

from tests.test_inter_roundtrip import moving_sequence

SIZES = [(96, 80), (70, 50)]


def _frames(size, n=4, seed=3):
    """Padded (MB-aligned) planes of a panned textured sequence."""
    w, h = size
    return [pad_frame(f) for f in moving_sequence(w, h, n, seed=seed)]


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), \
        f"{what}: {np.sum(got != want)} values differ"


def _jit(fn, *static):
    """fn(*arrays, *static) compiled once (op-by-op JAX on the CPU is
    several times slower than compiling these small graphs)."""
    return jax.jit(lambda *a: fn(*a, *static))


def _setup(size, seed=3):
    """(cur pyramid, stacked ref pyramid) of the port and of JAX."""
    f = _frames(size, seed=seed)
    refs = np.stack([g.y for g in f[:3]])
    H, W = refs.shape[1:]
    cur_t = TI.build_pyramid(torch.from_numpy(f[3].y))
    refs_t = [torch.stack(lv) for lv in
              zip(*(TI.build_pyramid(torch.from_numpy(r)) for r in refs))]
    cur_j = [jnp.asarray(f[3].y)]
    for _ in range(4):
        cur_j.append(JI.downsample2(cur_j[-1]))
    return cur_t, refs_t, cur_j, JI.build_ref_pyramid(jnp.asarray(refs), H, W)


def _jax_hierarchical(cur_j, ref_pyr):
    extra = [(pads, dims) for _, pads, dims in ref_pyr]
    run = jax.jit(lambda c, planes: JI.hierarchical_search(
        c, [(p, *e) for p, e in zip(planes, extra)]))
    return run(cur_j, [p for p, _, _ in ref_pyr])


@pytest.mark.parametrize("size", SIZES)
def test_pyramid_matches(size):
    cur_t, refs_t, cur_j, ref_pyr = _setup(size)
    for lvl in range(5):
        _eq(cur_t[lvl], cur_j[lvl], f"cur level {lvl}")
        plane, (py, px), (h, w) = ref_pyr[lvl]
        _eq(refs_t[lvl], np.asarray(plane)[:, py:py + h, px:px + w],
            f"ref level {lvl}")


# (level, pixel rate, penalty, parent vector)
LEVEL_CASES = [(3, 8, False, False), (2, 4, False, True), (1, 2, True, True),
               (0, 1, True, False)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("lvl,rate,penalty,parent", LEVEL_CASES)
def test_search_level_matches(size, lvl, rate, penalty, parent):
    cur_t, refs_t, cur_j, ref_pyr = _setup(size)
    h, w = cur_t[lvl].shape
    src = None
    if parent:
        rng = np.random.default_rng(lvl + w)
        hc, wc = cur_t[lvl + 1].shape
        src = rng.integers(-6 * rate, 6 * rate + 1,
                           (3, max(hc // 8, 1), max(wc // 8, 1), 2))
        src = src.astype(np.int32)
    got = TI.search_level(cur_t[lvl], refs_t[lvl],
                          None if src is None else torch.from_numpy(src),
                          rate, penalty)
    plane, pads, _ = ref_pyr[lvl]
    run = _jit(lambda c, p, *s: JI.search_level(c, p, pads, *(s or [None]),
                                                rate, penalty))
    want = run(cur_j[lvl], plane, *([] if src is None else
                                    [jnp.asarray(src)]))
    _eq(got, want, "vectors")
    assert got.abs().max() > 0


@pytest.mark.parametrize("size", SIZES)
def test_search_qpel_matches(size):
    cur_t, refs_t, cur_j, ref_pyr = _setup(size)
    H, W = cur_t[0].shape
    rng = np.random.default_rng(W)
    fv = rng.integers(-6, 7, (3, H // 8, W // 8, 2)).astype(np.int32)
    fv[:, 0, 0], fv[:, -1, -1] = -6, 6            # candidates off both edges
    vec, diff, pred = TI.search_qpel(cur_t[0], refs_t[0], torch.from_numpy(fv))
    plane, pads, _ = ref_pyr[0]
    jv, jd, jp = _jit(lambda c, p, v: JI.search_qpel(c, p, pads, v))(
        cur_j[0], plane, jnp.asarray(fv))
    _eq(vec, jv, "vectors")
    _eq(diff, jd, "Bdiff")
    _eq(pred, jp, "best_pred")


def test_sixtap_phases_of_the_qpel_kernel():
    """What the quarter-pel CUDA kernel's filter arithmetic rests on: a
    step of +-2 quarter pels only reaches phases 0, 2, 4, 6 of the six-tap
    table; phase 0 is the identity, under the table's own rounding and
    under the kernel's 64 x with (s + 32) >> 6; every tap of phases 2, 4, 6
    fits a signed byte (a dp4a operand)."""
    from vp8oclenc_tpu_torch.tables import SIXTAP_FILTERS
    taps = np.asarray(SIXTAP_FILTERS, np.int64)
    assert sorted({(d & 3) * 2 for d in range(-2, 3)}) == [0, 2, 4, 6]
    x = np.arange(256)
    assert taps[0].tolist() == [0, 0, 128, 0, 0, 0]
    assert np.array_equal(np.clip((128 * x + 64) >> 7, 0, 255), x)
    assert np.array_equal((64 * x + 32) >> 6, x)
    for ph in (2, 4, 6):
        assert taps[ph].min() >= -128 and taps[ph].max() <= 127
        assert taps[ph].sum() == 128


def _dp4a(px, taps, acc):
    """Four unsigned bytes times four signed bytes, plus acc (int64)."""
    return acc + (px.astype(np.int64) * np.asarray(taps, np.int64)).sum(-1)


def _qpel_kernel_model(cur, refs, fv):
    """The pass order of csrc/search.cu's qpel_kernel in numpy, for every
    (reference, block) job at once: clamped 14-row window; five horizontal
    passes (phase 0 a copy) stored transposed in 16-byte columns whose two
    spare bytes hold junk; the zero-vector block as a sixth slot at bytes
    2..9; one vertical pass for all 26 candidates in two groups of four
    taps with the rounding constant as the accumulator (phase 0: 64 x,
    (s + 32) >> 6); the port's own dct_cost_8x8; one minimum over
    (cost << 5 | candidate)."""
    from vp8oclenc_tpu_torch.tables import SIXTAP_FILTERS
    JUNK = 0xAB
    taps = np.asarray(SIXTAP_FILTERS, np.int64)
    R, H, W = refs.shape
    nbx, n = W // 8, (H // 8) * (W // 8)
    b = np.arange(n)
    cy, cx = (b // nbx) * 8, (b % nbx) * 8
    fx, fy = fv[..., 0].astype(np.int64), fv[..., 1].astype(np.int64)
    ys = np.clip((cy + fy)[..., None] - 3 + np.arange(14), 0, H - 1)
    xs = np.clip((cx + fx)[..., None] - 3 + np.arange(16), 0, W - 1)
    ridx = np.arange(R)[:, None, None, None]
    win = refs[ridx, ys[..., :, None], xs[..., None, :]]      # (R, n, 14, 16)
    slots = np.full((6, R, n, 8, 16), JUNK, np.int64)         # [.., col, row]
    for di in range(5):
        dx = di - 2
        xo, ph = (0 if dx < 0 else 1), (dx & 3) * 2
        for j in range(8):
            six = win[..., xo + j:xo + j + 8].astype(np.int64)
            if ph == 0:
                out = six[..., 2]
            else:
                s_ = _dp4a(six[..., :4], taps[ph][:4], 64)
                s_ = _dp4a(six[..., 4:8], [*taps[ph][4:], 0, 0], s_)
                out = np.clip(s_ >> 7, 0, 255)
            slots[di, :, :, j, :14] = out
    zero = refs[ridx, (cy[:, None] + np.arange(8))[None, :, :, None],
                (cx[:, None] + np.arange(8))[None, :, None, :]]
    slots[5, :, :, :, 2:10] = zero.transpose(0, 1, 3, 2)
    preds = np.empty((R, n, 26, 8, 8), np.int64)
    key = np.empty((R, n, 26), np.int64)
    for c in range(26):
        dx, dy = (c % 5 - 2, c // 5 - 2) if c < 25 else (0, 0)
        slot = c % 5 if c < 25 else 5
        yo = 1 if (c < 25 and dy >= 0) else 0
        ph = (dy & 3) * 2
        t = taps[ph] if ph else np.array([0, 0, 64, 0, 0, 0])
        rnd, shr = (64, 7) if ph else (32, 6)
        col = np.concatenate([slots[slot][..., yo:],
                              np.zeros((R, n, 8, yo), np.int64)], -1)
        for i in range(8):
            s_ = _dp4a(col[..., i:i + 4], t[:4], rnd)
            s_ = _dp4a(col[..., i + 4:i + 8], [*t[4:], 0, 0], s_)
            preds[:, :, c, i, :] = np.clip(s_ >> shr, 0, 255)
    cur_b = cur[(cy[:, None] + np.arange(8))[:, :, None],
                (cx[:, None] + np.arange(8))[:, None, :]].astype(np.int64)
    cost = TT.dct_cost_8x8(torch.from_numpy(preds - cur_b[None, :, None])
                           .to(torch.int32)).numpy().astype(np.int64)
    pen = np.zeros(26, np.int64)
    for c in range(26):
        dx, dy = (c % 5 - 2, c // 5 - 2) if c < 25 else (0, 0)
        pen[c] = (abs(dx) + abs(dy)) * TI.PEN
        px, py = (cx + fx) * 4 + dx, (cy + fy) * 4 + dy
        valid = (px >= 0) & (px <= 4 * W - 32) & (py >= 0) \
            & (py <= 4 * H - 32) if c < 25 else np.ones((R, n), bool)
        key[..., c] = np.where(valid, (cost[..., c] + pen[c]) << 5,
                               0x7fffffe0) | c
    assert cost.max() + pen.max() < 1 << 18      # the key cannot overflow
    best = key.min(-1)
    idx, total = best & 31, best >> 5
    vx = np.where(idx < 25, fx * 4 + idx % 5 - 2, 0)
    vy = np.where(idx < 25, fy * 4 + idx // 5 - 2, 0)
    out_cost = np.where((vx != 0) | (vy != 0), total - pen[idx], total)
    pred = np.take_along_axis(
        preds.reshape(R, n, 26, 64), idx[..., None, None], 2)[:, :, 0]
    return np.stack([vx, vy], -1), out_cost, pred


@pytest.mark.parametrize("size", SIZES)
def test_qpel_kernel_model_matches(size):
    """The CUDA kernel's pass order (its numpy model) gives what
    `qpel_search_plain` and the JAX package's `search_qpel` give, with
    full-pel vectors that point candidates past every frame edge."""
    cur_t, refs_t, cur_j, ref_pyr = _setup(size)
    H, W = cur_t[0].shape
    rng = np.random.default_rng(H)
    fv = rng.integers(-6, 7, (3, H // 8, W // 8, 2)).astype(np.int32)
    fv[:, 0, 0], fv[:, -1, -1], fv[:, 0, -1] = -6, 6, (6, -6)
    fv[:, 1] = 0                          # zero-vector ties with candidate 12
    flat = fv.reshape(3, -1, 2)
    mv, mc, mp = _qpel_kernel_model(cur_t[0].numpy(), refs_t[0].numpy(), flat)
    pv, pc, pp = TI.qpel_search_plain(cur_t[0], refs_t[0],
                                      torch.from_numpy(flat))
    _eq(pv, mv, "vectors vs plain")
    _eq(pc, mc, "cost vs plain")
    _eq(pp, mp, "prediction vs plain")
    assert (mv != 0).any() and (mv == 0).all(-1).any()
    plane, pads, _ = ref_pyr[0]
    jv, jd, jp = _jit(lambda c, p, v: JI.search_qpel(c, p, pads, v))(
        cur_j[0], plane, jnp.asarray(fv))
    _eq(mv.reshape(fv.shape), jv, "vectors vs jax")
    _eq(mc.reshape(fv.shape[:3]), jd, "Bdiff vs jax")
    _eq(mp.reshape(3, -1, 8, 8), jp, "best_pred vs jax")


def _c4_stage(x0, x1, x2, x3):
    """The rows of C4 without their factors 8, 2, 8, 2 (csrc/search.cu
    c4_stage), stacked on a new last axis as (a, e, b, f)."""
    s03, d03, s12, d12 = x0 + x3, x0 - x3, x1 + x2, x1 - x2
    return np.stack([s03 + s12, 5 * d03 + 2 * d12, s03 - s12,
                     2 * d03 - 5 * d12], -1)


def _fits(a, bits, signed=True):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed else \
        (0, 1 << bits)
    assert a.min() >= lo and a.max() < hi, (a.min(), a.max(), bits)
    return a


def _fullpel_kernel_model(cur, refs, v0, penalty, per_warp):
    """The arithmetic of csrc/search.cu's fullpel_kernel in numpy, for every
    warp (a block and `per_warp` references: 3, or 1 on a level of fewer
    than 1024 blocks) at once: clamped 12x12 windows (2k
    around reference k's v0, 2k + 1 around zero); the column stage of
    every window position (rows r..r+3 for r = 0..8, columns 0..11) and of
    the current block; the current quadrants' row stage g; per candidate
    and quadrant the row stage of four window columns less g, |.| summed
    by class (factors 64, 16, 4) and (16 s64 + 4 s16 + s4 - 12 |dc|) >> 5;
    keys (cost field << 6 | index in the reference) with the saturation
    and the out-of-plane field of the kernel; each lane's minimum per
    reference over its rounds (c = lane + 32 k), then the minimum over the
    lanes.  Every intermediate is asserted to fit the kernel's
    int32 (the keys its uint32)."""
    R, H, W = refs.shape
    nbx, n = W // 8, (H // 8) * (W // 8)
    b = np.arange(n)
    cy, cx = (b // nbx) * 8, (b % nbx) * 8
    P = per_warp
    groups = -(-R // P)
    ref = np.minimum(np.arange(groups)[:, None] * P + np.arange(P), R - 1)
    v = v0.astype(np.int64)[ref]                          # (G, 3, n, 2)
    vx, vy = v[..., 0], v[..., 1]
    # windows (G, 3, 2, n, 12, 12): w = 0 at v0, w = 1 at zero
    wx = np.stack([vx, 0 * vx], 2)
    wy = np.stack([vy, 0 * vy], 2)
    ys = np.clip((cy + wy)[..., None] - 2 + np.arange(12), 0, H - 1)
    xs = np.clip((cx + wx)[..., None] - 2 + np.arange(12), 0, W - 1)
    win = refs[ref[:, :, None, None, None, None], ys[..., :, None],
               xs[..., None, :]].astype(np.int64)
    col = _fits(_c4_stage(*(win[..., r:r + 9, :] for r in range(4))), 32)
    # col (G, 3, 2, n, 9 row starts, 12 columns, 4)
    cb = cur[(cy[:, None] + np.arange(8))[:, :, None],
             (cx[:, None] + np.arange(8))[:, None, :]].astype(np.int64)
    ccol = np.stack([_c4_stage(*(cb[:, 4 * qr + k] for k in range(4)))
                     for qr in range(2)], 1)                # (n, 2, 8, 4)
    g = np.stack([_c4_stage(*(ccol[:, q >> 1, 4 * (q & 1) + j]
                              for j in range(4)))
                  for q in range(4)], 1)                    # (n, 4, i, 4)
    c = np.arange(50 * P)
    rk, w, d = c // 50, (c % 50) // 25, c % 25
    dx, dy = d % 5 - 2, d // 5 - 2
    cost = np.zeros((groups, n, 50 * P), np.int64)
    col = col.transpose(0, 3, 1, 2, 4, 5, 6)          # (G, n, 3, 2, 9, 12, 4)
    for q in range(4):
        qr, qc = q >> 1, q & 1
        t = col[:, :, rk[:, None], w[:, None], (dy + 2 + 4 * qr)[:, None],
                (dx + 2 + 4 * qc)[:, None] + np.arange(4)]
        t = t.swapaxes(-1, -2)                        # (G, n, 150, i, j)
        u = _c4_stage(*(t[..., j] for j in range(4)))       # (G,n,150,i,4)
        u = _fits(u - g[:, q][None, :, None], 32)
        a = np.abs(u)
        s64 = a[..., 0::2, 0::2].sum((-2, -1))
        s16 = a[..., 0::2, 1::2].sum((-2, -1)) + \
            a[..., 1::2, 0::2].sum((-2, -1))
        s4 = a[..., 1::2, 1::2].sum((-2, -1))
        cost += _fits(16 * s64 + 4 * s16 + s4 - 12 * a[..., 0, 0], 32) >> 5
    vxc, vyc = np.moveaxis(vx[:, rk], 1, 2), np.moveaxis(vy[:, rk], 1, 2)
    wxc, wyc = np.where(w == 0, vxc, 0), np.where(w == 0, vyc, 0)
    px, py = cx[:, None] + wxc + dx, cy[:, None] + wyc + dy
    valid = (px >= 0) & (px <= W - 8) & (py >= 0) & (py <= H - 8)
    pen = (np.abs(wxc + dx - vxc) + np.abs(wyc + dy - vyc)) * TI.PEN \
        if penalty else 0 * px
    field = np.where(valid, np.minimum(_fits(cost + pen, 32),
                                       (1 << 26) - 2), (1 << 26) - 1)
    key = _fits(field << 6 | c % 50, 32, signed=False)
    rounds = -(-50 * P // 32)
    lanes = np.full((groups, n, rounds, 32), 0xFFFFFFFF, np.int64)
    lanes.reshape(groups, n, 32 * rounds)[..., :50 * P] = key
    best = np.full((groups, n, 32, P), 0xFFFFFFFF, np.int64)
    for k in range(rounds):
        ck = np.arange(32) + 32 * k
        for r in range(P):
            mine = (ck // 50 == r) & (ck < 50 * P)
            best[..., r] = np.where(mine, np.minimum(best[..., r],
                                                     lanes[..., k, :]),
                                    best[..., r])
    m = best.min(2)                                         # (G, n, P)
    idx = m & 63
    out = np.zeros((R, n, 2), np.int64)
    for gi in range(groups):
        for r in range(P):
            if P * gi + r >= R:
                continue
            i = idx[gi, :, r]
            at_v = i // 25 == 0
            d = i % 25
            out[P * gi + r, :, 0] = np.where(at_v, vx[gi, r], 0) + d % 5 - 2
            out[P * gi + r, :, 1] = np.where(at_v, vy[gi, r], 0) + d // 5 - 2
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("extreme", [False, True])
def test_fullpel_kernel_model_matches(size, extreme):
    """The CUDA kernel's formulation (its numpy model) gives what
    `fullpel_search_plain` and the JAX package's `search_level` give, with
    penalty on and off, start vectors 12 pels past every edge (and rate 2:
    the inherited vectors halved), and with an all-0 block searched in
    all-255 windows (the largest column- and row-stage values)."""
    cur_t, refs_t, cur_j, ref_pyr = _setup(size)
    if extreme:                 # rebuild the pyramids from altered planes
        f = _frames(size)
        f[3].y[:16, :16] = 0
        for g in f[:3]:
            g.y[:32, :32] = 255
        refs = np.stack([g.y for g in f[:3]])
        H, W = refs.shape[1:]
        cur_t = TI.build_pyramid(torch.from_numpy(f[3].y))
        refs_t = [torch.stack(lv) for lv in zip(
            *(TI.build_pyramid(torch.from_numpy(r)) for r in refs))]
        cur_j = [jnp.asarray(f[3].y)]
        for _ in range(4):
            cur_j.append(JI.downsample2(cur_j[-1]))
        ref_pyr = JI.build_ref_pyramid(jnp.asarray(refs), H, W)
    for lvl, rate, penalty in ((0, 1, True), (0, 1, False), (1, 2, True)):
        h, w = cur_t[lvl].shape
        hc, wc = cur_t[lvl + 1].shape
        rng = np.random.default_rng(h + lvl)
        src = rng.integers(-12 * rate, 12 * rate + 1,
                           (3, hc // 8, wc // 8, 2)).astype(np.int32)
        src[:, 0, 0], src[:, -1, -1] = -12 * rate, 12 * rate
        src[:, 0, -1] = (12 * rate, -12 * rate)
        src[:, -1, 0] = (-12 * rate, 12 * rate)
        v0 = TI.inherit_vectors(torch.from_numpy(src), 3, h // 8, w // 8,
                                rate, "cpu")
        assert (v0.abs() == 12).any()
        plain = TI.fullpel_search_plain(cur_t[lvl], refs_t[lvl], v0, penalty)
        for per_warp in (1, 3):
            got = _fullpel_kernel_model(cur_t[lvl].numpy(),
                                        refs_t[lvl].numpy(), v0.numpy(),
                                        penalty, per_warp)
            _eq(plain, got, f"plain, level {lvl}, penalty {penalty}, "
                f"{per_warp} references a warp")
        plane, pads, _ = ref_pyr[lvl]
        want = _jit(lambda c, p, s_: JI.search_level(c, p, pads, s_, rate,
                                                     penalty))(
            cur_j[lvl], plane, jnp.asarray(src))
        _eq(got.reshape(3, h // 8, w // 8, 2) * rate, want,
            f"jax, level {lvl}, penalty {penalty}")


@pytest.mark.parametrize("size", SIZES)
def test_hierarchical_search_matches(size):
    cur_t, refs_t, cur_j, ref_pyr = _setup(size, seed=9)
    got = TI.hierarchical_search(cur_t, refs_t)
    want = _jax_hierarchical(cur_j, ref_pyr)
    for g, j, what in zip(got, want, ("vectors", "Bdiff", "best_pred")):
        _eq(g, j, what)
    assert got[0].abs().max() > 0


@pytest.mark.parametrize("size", SIZES)
def test_mc_predict_selected_uv_matches(size):
    f = _frames(size)
    ru = np.stack([g.u for g in f[:3]])
    rv = np.stack([g.v for g in f[:3]])
    H2, W2 = ru.shape[1:]
    mbw, mbh = W2 // 8, H2 // 8
    rng = np.random.default_rng(W2)
    mvs = rng.integers(-40, 41, (mbw * mbh, 4, 2)).astype(np.int32)
    sel = rng.integers(0, 3, mbw * mbh).astype(np.int32)
    got = TI.mc_predict_selected_uv(torch.from_numpy(ru), torch.from_numpy(rv),
                                    torch.from_numpy(mvs),
                                    torch.from_numpy(sel))
    bx = np.tile(np.arange(W2 // 4), H2 // 4)
    by = np.repeat(np.arange(H2 // 4), W2 // 4)
    pad = JI.PAD_C_FULL
    run = _jit(lambda u, v, m, s, mb, qi: JI.mc_predict_selected_uv(
        JI._pad_tiles(u, pad, pad), JI._pad_tiles(v, pad, pad), (pad, pad),
        m, s, mb, qi, 8, H2, W2))
    want = run(jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(mvs),
               jnp.asarray(sel), jnp.asarray((by // 2) * mbw + bx // 2),
               jnp.asarray((by % 2) * 2 + bx % 2))
    for g, j, what in zip(got, want, "uv"):
        _eq(g, j, what)


def test_wht_matches():
    rng = np.random.default_rng(5)
    dcs = rng.integers(-2048, 2048, (64, 4, 4)).astype(np.int32)
    dcs[0] = 2047
    dcs[1] = -2048
    _eq(TT.fwht4x4(torch.from_numpy(dcs)), JT.fwht4x4(jnp.asarray(dcs)), "fwht")
    dq = rng.integers(-30000, 30000, (64, 4, 4)).astype(np.int32)
    _eq(TT.iwht4x4(torch.from_numpy(dq)), JT.iwht4x4(jnp.asarray(dq)), "iwht")


@pytest.mark.parametrize("q", [(4, 4, 8, 8), (33, 41, 66, 51), (157, 284, 314, 440)])
def test_transform_mb_matches(q):
    rng = np.random.default_rng(q[0])
    mbc = 30
    res = rng.integers(-255, 256, (mbc, 16, 4, 4)).astype(np.int32)
    res[:6] = rng.integers(-20, 21, (6, 16, 4, 4))      # small residuals
    parts = rng.integers(0, 2, mbc).astype(np.int32)
    got = TI.transform_mb_luma(torch.from_numpy(res), torch.from_numpy(parts),
                               *q)
    want = _jit(JI.transform_mb_luma, *q)(jnp.asarray(res),
                                          jnp.asarray(parts))
    for g, j, what in zip(got, want, ("levels", "y2", "rec_res")):
        _eq(g, j, what)
    cres = res[:, :4]
    got = TI.transform_mb_chroma(torch.from_numpy(cres), q[0], q[1])
    want = _jit(JI.transform_mb_chroma, q[0], q[1])(jnp.asarray(cres))
    for g, j, what in zip(got, want, ("levels", "rec_res")):
        _eq(g, j, what)


def test_mb_ssim_matches_with_int32_overflow():
    """Blocks of all 255 against all 0 (and all 255 against all 255) push
    n*q1 and s1*s1 past int32; the port computes them in int64."""
    rng = np.random.default_rng(17)
    H, W = 48, 64
    planes = [rng.integers(0, 256, (h, w)).astype(np.int32)
              for h, w in ((H, W), (H, W), (H // 2, W // 2), (H // 2, W // 2),
                           (H // 2, W // 2), (H // 2, W // 2))]
    y, ry, u, ru, v, rv = planes
    y[:16, :16], ry[:16, :16] = 255, 0
    y[:16, 16:32], ry[:16, 16:32] = 255, 255
    y[16:32, :16], ry[16:32, :16] = 0, 0
    u[:8, :8], ru[:8, :8] = 255, 0
    v[:8, 8:16], rv[:8, 8:16] = 255, 255
    got = TS.mb_ssim_fx(*(torch.from_numpy(p) for p in planes))
    assert got.dtype == torch.int32
    _eq(got, np_mb_ssim_fx(*planes), "numpy mb_ssim_fx")
    _eq(got, _jit(JI.mb_ssim)(*(jnp.asarray(p) for p in planes)),
        "jax mb_ssim")


SSIM_CFG = dict(qi_min=50, qi_max=112, ssim_target=0.98)


def _inter_inputs(size, ssim):
    """(current frame, stacked reference planes, segments, weak segments).
    With SSIM on: the replacement sequence of tests/test_tpu_backend.py
    (static noise, regions with a fresh gradient every frame), whose inter
    prediction fails in places, with +-12 of noise on the reference luma
    standing in for coding noise, so that all four segments and the intra
    replacement are used."""
    w, h = size
    if ssim:
        from tests.test_tpu_backend import replacement_sequence
        f = [pad_frame(g) for g in replacement_sequence(w, h, 5, seed=3)]
        cfg = JaxConfig(**SSIM_CFG)
    else:
        f = _frames(size, n=5, seed=11)
        cfg = JaxConfig(qi_min=8, qi_max=30)
    seg = prepare_segments(cfg, f[4].y, False, False)
    weak = prepare_segments(cfg, f[4].y, False, False, weaken_filter=True,
                            strength=seg.raw_strength)
    refs = [np.stack([getattr(g, p) for g in f[:3]]) for p in "yuv"]
    if ssim:
        rng = np.random.default_rng(3)
        refs[0] = (refs[0].astype(int) + rng.integers(-12, 13, refs[0].shape)
                   ).clip(0, 255).astype(np.uint8)
    return f[4], refs, seg, weak


@pytest.fixture(scope="module", params=[
    ((96, 80), (True, True, False), False),
    ((70, 50), (True, False, True), False),
    ((96, 80), (True, True, True), True)],
    ids=["96x80", "70x50", "96x80-ssim"])
def inter_case(request):
    """One inter frame through the JAX package's fused inter kernel and
    through the port's inter_body, on the same inputs, with SSIM control
    off and on."""
    size, ref_valid, ssim = request.param
    cur, refs, seg, weak = _inter_inputs(size, ssim)
    H, W = cur.y.shape
    segq = (seg.y_dc_q, seg.y_ac_q, seg.y2_dc_q, seg.y2_ac_q, seg.uv_dc_q,
            seg.uv_ac_q)
    tfx = TS.target_fx(SSIM_CFG["ssim_target"]) if ssim else -1
    kern = JI.build_inter_kernel(W, H, ssim_enabled=ssim)
    want = kern(jnp.asarray(cur.y), jnp.asarray(cur.u), jnp.asarray(cur.v),
                *(jnp.asarray(r) for r in refs), jnp.asarray(ref_valid),
                *(jnp.asarray(np.asarray(a, np.int32)) for a in segq),
                jnp.int32(tfx))
    states = [TI.ref_state(*(torch.from_numpy(r[i]) for r in refs))
              for i in range(3)]
    quant = tuple([int(x) for x in np.asarray(a)] for a in segq)
    got = TI.inter_body(torch.from_numpy(cur.y), torch.from_numpy(cur.u),
                        torch.from_numpy(cur.v), states, ref_valid, quant,
                        tfx)
    lf = np.stack([np.stack([s.loop_filter_level, s.mbedge_limit,
                             s.sub_bedge_limit, s.interior_limit,
                             s.hev_threshold]) for s in (seg, weak)]) \
        .astype(np.int32)
    return got, want, lf, (W // 16, H // 16), ssim


def test_inter_body_matches(inter_case):
    got, want, _, (mbw, mbh), ssim = inter_case
    for g, j, what in zip(got, want, ("levels_pack", "meta", "cur_ssim",
                                      "recon_y", "recon_u", "recon_v")):
        _eq(g, j, what)
    assert got[0].dtype == torch.int16 and got[1].dtype == torch.int32
    meta = got[1].numpy()
    if not ssim:
        assert got[6] is None and got[7] is None
        assert (meta[:, 0] == 3).all()              # one LQ pass
        assert (meta[:, 3:] != 0).any()             # some MBs moved
        assert (meta[:, 1] == 0).any() and (meta[:, 1] == 1).any()
        return
    from vp8oclenc_tpu.ops.wire import unpack_modes4
    _eq(got[6], unpack_modes4(np.asarray(want[6]), mbw * mbh), "modes")
    assert got[6].dtype == torch.int8
    assert int(got[7]) == int(want[7]) > 0          # some MBs were replaced
    assert len(np.unique(meta[:, 0])) == 4          # every segment used
    replaced = meta[:, 1] == 2                      # ARE4X4
    assert replaced.sum() == int(got[7])
    assert (got[6].numpy()[~replaced] == 0).all()
    assert (got[0].numpy()[replaced, 24] == 0).all()    # no Y2 there


@pytest.mark.parametrize("weaken", [False, True])
def test_filter_from_meta_matches(inter_case, weaken):
    """Filtered planes and the next LAST's pyramid (the interiors of the
    JAX package's padded levels), with the normal and the weakened
    limits."""
    got, _, lf, (mbw, mbh), _ = inter_case
    levels_pack, meta, cur_ssim, ry, ru, rv = got[:6]
    if weaken:
        cur_ssim = torch.full_like(cur_ssim, WEAKEN_FX + 1)
    elif int(cur_ssim.min()) > WEAKEN_FX:
        cur_ssim = cur_ssim.clone()
        cur_ssim[0] = WEAKEN_FX
    planes = filter_from_meta(ry, ru, rv, levels_pack, meta, cur_ssim,
                              torch.from_numpy(lf))
    pyr, fu, fv = TI.ref_state(*planes)
    (jy, ju, jv), (jpyr, _, _, _) = build_filter_from_meta_kernel(mbw, mbh)(
        *(jnp.asarray(t.numpy()) for t in (ry, ru, rv, levels_pack, meta,
                                           cur_ssim)), jnp.asarray(lf))
    for g, j, what in zip(planes, (jy, ju, jv), "yuv"):
        _eq(g, j, f"filtered {what}")
    assert fu is planes[1] and fv is planes[2]
    H, W = ry.shape
    for lvl in range(5):
        pad = JI.PAD_Y_FULL >> lvl
        _eq(pyr[lvl], np.asarray(jpyr[lvl])[pad:pad + (H >> lvl),
                                            pad:pad + (W >> lvl)],
            f"pyramid level {lvl}")
