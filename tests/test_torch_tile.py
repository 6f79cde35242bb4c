"""Row-tile sharding in the port (parallel/tile.py and the shard modes of
the search and filter kernels' plain versions) against the single-rank
port and the JAX package, bit for bit.

Two spawned gloo worlds on the CPU: 128x128 over 4 tiles (2 MB rows a
rank, so the 80-row level-0 halo spans 3 ranks) with the SSIM controller
on, content whose replaced regions straddle the bands' edges; and 192x96
over 3 tiles with it off.  Each rank returns its halo strips, reference
strips, an inter frame step and a keyframe step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp8oclenc_tpu.ops import inter as JI
from vp8oclenc_tpu.ops.loopfilter import filter_planes as jax_filter_planes
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.ops import inter as IN
from vp8oclenc_tpu_torch.ops import loopfilter as LF
from vp8oclenc_tpu_torch.ops.backend import filter_from_meta, lf_rows
from vp8oclenc_tpu_torch.ops.intra import intra_body
from vp8oclenc_tpu_torch.ops.wire import (pack_modes4, unpack_head,
                                          unpack_levels)
from vp8oclenc_tpu_torch.parallel.launch import run
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
from vp8oclenc_tpu_torch.ssim_fx import target_fx
from vp8oclenc_tpu_torch.tables import INTRA_SEGMENT

from tests.torch_ranks import tile_case


def _panned(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    base = (110 + 70 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
            + rng.integers(0, 40, xx.shape)).clip(0, 255).astype(np.uint8)
    c = lambda o: np.ascontiguousarray(base[o:o + h // 2, o:o + w // 2]
                                       // 2 + 64)
    return ([base[:h, :w].copy(), c(0), c(1)],
            [base[5:5 + h, 3:3 + w].copy(), c(2), c(3)])


def gradient_mbs(w, h, n, seed, share):
    """Static noise, constant chroma, and a `share` of the MBs, chosen
    once, given a fresh gradient every frame: inter mispredicts them and
    the SSIM controller's intra trial wins some, at the bands' edges too."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    mbw = w // 16
    mbs = rng.choice(mbw * (h // 16), int(share * mbw * (h // 16)),
                     replace=False)
    yy, xx = np.mgrid[0:16, 0:16]
    out = []
    for _ in range(n):
        y = base.copy()
        for m in mbs:
            a, b = rng.uniform(-6, 6, 2)
            oy, ox = (m // mbw) * 16, (m % mbw) * 16
            y[oy:oy + 16, ox:ox + 16] = (128 + a * (xx - 8) + b * (yy - 8)
                                         ).clip(0, 255).astype(np.uint8)
        out.append(Frame(y, u.copy(), v.copy()))
    return out


WORLDS = {"128x128/T4/ssim": (128, 128, 4, True),
          "192x96/T3": (192, 96, 3, False)}


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    w, h, T, ssim = WORLDS[request.param]
    if ssim:
        # LAST is the coded keyframe, as in the encoder: against the
        # source itself the background needs nothing replaced
        fr = gradient_mbs(w, h, 2, seed=3, share=0.3)
        cfg = EncoderConfig(qi_min=50, qi_max=112, ssim_target=0.98)
        enc = Encoder(cfg, w, h, device="cpu")
        enc.encode_frame(Frame(fr[0].y, fr[0].u, fr[0].v))
        ref = [np.array(p) for p in enc.recon]
        enc.close()
        cur = [fr[1].y, fr[1].u, fr[1].v]
        tfx = target_fx(0.98)
    else:
        ref, cur = _panned(w, h, seed=31)
        cfg = EncoderConfig(qi_min=8, qi_max=40)
        tfx = -1
    seg = prepare_segments(cfg, cur[0], False, False)
    weak = prepare_segments(cfg, cur[0], False, False, weaken_filter=True,
                            strength=seg.raw_strength)
    quant = tuple([int(x) for x in q] for q in (
        seg.y_dc_q, seg.y_ac_q, seg.y2_dc_q, seg.y2_ac_q, seg.uv_dc_q,
        seg.uv_ac_q))
    lf = np.stack([lf_rows(s) for s in (seg, weak)])
    kseg = prepare_segments(cfg, cur[0], True, True)
    s = INTRA_SEGMENT
    key_qs = (int(kseg.y_dc_q[s]), int(kseg.y_ac_q[s]),
              int(kseg.uv_dc_q[s]), int(kseg.uv_ac_q[s]))
    key_lf = lf_rows(kseg)
    ranks = run(tile_case, T, "gloo", "cpu",
                args=(ref, cur, quant, lf, tfx, key_qs, key_lf),
                gop=1, tile=T)
    return dict(w=w, h=h, T=T, ref=ref, cur=cur, quant=quant, lf=lf,
                tfx=tfx, key_qs=key_qs, key_lf=key_lf, ranks=ranks)


def _rows(plane, lo, hi):
    """Rows lo..hi-1 of a plane, clamped into it (the strips' edges)."""
    idx = np.clip(np.arange(lo, hi), 0, plane.shape[0] - 1)
    return plane[idx]


def test_halo_strips(world):
    T, y = world["T"], world["ref"][0]
    rows = y.shape[0] // T
    for t, rk in enumerate(world["ranks"]):
        for pad, strip in rk["halo"].items():
            want = _rows(y, t * rows - pad, (t + 1) * rows + pad)
            assert np.array_equal(strip, want), (t, pad)


def test_ref_strips_equal_single_card_pyramid(world):
    T = world["T"]
    pyr, ru, rv = IN.ref_state(*(torch.from_numpy(p) for p in world["ref"]))
    for t, rk in enumerate(world["ranks"]):
        levels, su, sv = rk["state"]
        for lvl, pad in ((0, IN.PAD_Y_FULL), (1, IN.PAD_Y_FULL // 2)):
            full = pyr[lvl].numpy()
            rows = full.shape[0] // T
            assert np.array_equal(levels[lvl], _rows(
                full, t * rows - pad, (t + 1) * rows + pad)), (t, lvl)
        for lvl in (2, 3, 4):
            assert np.array_equal(levels[lvl], pyr[lvl].numpy())
        for got, full in ((su, ru.numpy()), (sv, rv.numpy())):
            rows = full.shape[0] // T
            assert np.array_equal(got, _rows(
                full, t * rows - IN.PAD_C_FULL,
                (t + 1) * rows + IN.PAD_C_FULL))


def test_sharded_frame_step_equals_single_card(world):
    T = world["T"]
    cur = [torch.from_numpy(p) for p in world["cur"]]
    rs = IN.ref_state(*(torch.from_numpy(p) for p in world["ref"]))
    lp, meta, cur_ssim, ry, ru, rv, modes, replaced = IN.inter_body(
        *cur, (rs,) * 3, (True, False, False), world["quant"], world["tfx"])
    planes = [p.numpy() for p in filter_from_meta(
        ry, ru, rv, lp, meta, cur_ssim, torch.from_numpy(world["lf"]))]
    if world["tfx"] >= 0:
        assert int(replaced) > 0, "the controller never fired"
    mbc_loc = lp.shape[0] // T
    got_replaced = 0
    for t, rk in enumerate(world["ranks"]):
        head, body, modes4, lv, band = rk["frame"]
        sl = slice(t * mbc_loc, (t + 1) * mbc_loc)
        assert np.array_equal(lv, lp[sl].numpy())
        info = unpack_head(head, mbc_loc)
        assert np.array_equal(unpack_levels(
            info, body[:info["n_active"] * 16], mbc_loc), lp[sl].numpy())
        m = meta[sl].numpy()
        assert np.array_equal(info["seg"], m[:, 0])
        assert np.array_equal(info["part"], m[:, 1])
        assert np.array_equal(info["ref"], m[:, 2])
        assert np.array_equal(info["mvs"].reshape(-1, 8),
                              m[:, 3:].astype(np.int16))
        assert info["ssim_min_fx"] == int(cur_ssim[sl].min())
        if modes is None:
            assert modes4 is None
        else:
            assert np.array_equal(modes4, pack_modes4(modes[sl]).numpy())
            got_replaced += info["replaced"]
        for p, b in zip(planes, band):
            rows = p.shape[0] // T
            assert np.array_equal(b, p[t * rows:(t + 1) * rows])
    assert got_replaced == (0 if replaced is None else int(replaced))


def test_sharded_key_step_equals_single_card(world):
    T = world["T"]
    cur = [torch.from_numpy(p) for p in world["cur"]]
    ry, ru, rv, lp, modes = intra_body(*cur, *world["key_qs"])
    mbc = lp.shape[0]
    planes = [p.numpy() for p in LF.filter_planes_plain(
        ry, ru, rv, torch.full((mbc,), INTRA_SEGMENT), torch.ones(mbc),
        *torch.from_numpy(world["key_lf"]))]
    pyr = IN.build_pyramid(torch.from_numpy(planes[0]))
    n = mbc // T
    for t, rk in enumerate(world["ranks"]):
        head, body, kmodes, lv, band, levels = rk["key"]
        sl = slice(t * n, (t + 1) * n)
        assert np.array_equal(lv, lp[sl].numpy())
        assert np.array_equal(kmodes, modes[sl].numpy())
        info = unpack_head(head, n)
        assert np.array_equal(unpack_levels(
            info, body[:info["n_active"] * 16], n), lp[sl].numpy())
        for p, b in zip(planes, band):
            rows = p.shape[0] // T
            assert np.array_equal(b, p[t * rows:(t + 1) * rows])
        assert np.array_equal(levels[2], pyr[2].numpy())


@pytest.mark.parametrize("T,t", [(4, 0), (4, 1), (4, 3), (2, 1)])
def test_shard_searches_equal_whole_plane_and_jax(T, t):
    """Level 0 and level 1 full pel and the quarter pel of a row shard,
    searched against its reference strip with row0/full_h, equal the
    whole-plane search on the shard's blocks and the JAX package's
    search_level / search_qpel in shard mode."""
    w, h = 64, 128
    ref, cur = _panned(w, h, seed=T * 10 + t)
    rng = np.random.default_rng(T + t)
    refs = np.stack([ref[0], np.roll(ref[0], 3, 1), cur[0][::-1].copy()])
    for lvl, rate, pen in ((1, 2, True), (0, 1, True), (0, 1, False)):
        s = 1 << lvl
        hl, wl = h // s, w // s
        c_full = cur[0][::s, ::s].copy()
        r_full = refs[:, ::s, ::s].copy()
        rows, pad = hl // T, IN.PAD_Y_FULL >> lvl
        row0 = t * rows
        strip = np.stack([_rows(r, row0 - pad, row0 + rows + pad)
                          for r in r_full])
        c = c_full[row0:row0 + rows]
        src = rng.integers(-40, 41, (3, hl // 16, wl // 16, 2)) \
            .astype(np.int32)
        got = IN.search_level(torch.from_numpy(c), torch.from_numpy(strip),
                              torch.from_numpy(src), rate, pen, pad, row0,
                              hl, row0)
        whole = IN.search_level(torch.from_numpy(c_full),
                                torch.from_numpy(r_full),
                                torch.from_numpy(src), rate, pen)
        nb = rows // 8
        assert torch.equal(got, whole[:, t * nb:(t + 1) * nb]), (lvl, pen)
        jax_v = JI.search_level(
            jnp.asarray(c), JI._pad_tiles(jnp.asarray(strip), 0, pad),
            (pad, pad), jnp.asarray(src), rate, pen, row0=row0, full_h=hl,
            src_off=row0)
        assert np.array_equal(got.numpy(), np.asarray(jax_v)), (lvl, pen)
        if lvl == 0:
            fv = (got // rate).to(torch.int32)
            q = IN.search_qpel(torch.from_numpy(c), torch.from_numpy(strip),
                               fv, pad, row0, hl)
            qw = IN.search_qpel(torch.from_numpy(c_full),
                                torch.from_numpy(r_full),
                                (whole // rate).to(torch.int32))
            jq = JI.search_qpel(jnp.asarray(c),
                                JI._pad_tiles(jnp.asarray(strip), 0, pad),
                                (pad, pad), jnp.asarray(fv.numpy()),
                                row0=row0, full_h=hl)
            n = nb * (w // 8)
            assert torch.equal(q[0], qw[0][:, t * nb:(t + 1) * nb])
            assert torch.equal(q[1], qw[1][:, t * nb:(t + 1) * nb])
            assert torch.equal(q[2], qw[2][:, t * n:(t + 1) * n])
            for a, b in zip(q, jq):
                assert np.array_equal(a.numpy().astype(np.int32),
                                      np.asarray(b).astype(np.int32))


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_band_filter_handoff_equals_whole_plane(T):
    """Bands filtered one after the other with the 4-line halo in and the
    3 lines back (the order of parallel/tile.filter_band_handoff) equal
    the whole-plane plain filter and the JAX package's filter_planes; the
    first band (no halo) is a frame of its own."""
    w, h = 96, 128
    rng = np.random.default_rng(T)
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    mbc = (w // 16) * (h // 16)
    seg = rng.integers(0, 4, mbc).astype(np.int32)
    inner = rng.random(mbc) < 0.5
    lims = [np.array(a, np.int32) for a in (
        [30, 0, 20, 63], [70, 60, 50, 90], [60, 50, 40, 80], [5, 3, 2, 8],
        [1, 0, 2, 1])]
    tp = [torch.from_numpy(p) for p in planes]
    targs = (torch.from_numpy(seg), torch.from_numpy(inner),
             *(torch.from_numpy(a) for a in lims))
    whole = LF.filter_planes_plain(*tp, *targs)
    jax_out = jax_filter_planes(*(jnp.asarray(p) for p in planes),
                                jnp.asarray(seg), jnp.asarray(inner),
                                *(jnp.asarray(a) for a in lims),
                                w // 16, h // 16)
    n = mbc // T
    bands, halo = [], None
    for t in range(T):
        cut = [p[t * (p.shape[0] // T):(t + 1) * (p.shape[0] // T)]
               for p in tp]
        out, wb = LF.filter_band_plain(
            *cut, halo, targs[0][t * n:(t + 1) * n],
            targs[1][t * n:(t + 1) * n], *targs[2:])
        assert (wb is None) == (t == 0)
        if wb is not None:
            for k in range(3):
                bands[-1][k][-3:] = wb[k]
        bands.append([o.clone() for o in out])
        halo = [o[-4:] for o in out]
    got = [torch.cat([b[k] for b in bands]) for k in range(3)]
    for g, a, j in zip(got, whole, jax_out):
        assert torch.equal(g, a)
        assert np.array_equal(g.numpy(), np.asarray(j))
