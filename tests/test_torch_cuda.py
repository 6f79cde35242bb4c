"""The CUDA kernels against their plain PyTorch versions on the card, at
small sizes, bit for bit (tolerance 0).  They need an NVIDIA GPU with nvcc
and skip without one; on the card run them with

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

(--noconftest: the suite's conftest imports JAX, which the port does not
need).  The 1920x1088 comparison is part of chip_smoke.py; the UHD cases
here (3840x2160) hold each kernel once at that size and a 2-frame stream
against the CPU's; the wide cases hold the filter (its ring kernel from
7264 pixels) and luma (its source ring) up to 16384 pixels, the filter
in band mode at 7680, and a 2-frame 7680x1088 stream against the
CPU's."""
import numpy as np
import pytest
import torch

from vp8oclenc_tpu_torch import ssim_fx as S
from vp8oclenc_tpu_torch.config import EncoderConfig
from vp8oclenc_tpu_torch.io.y4m import Frame
from vp8oclenc_tpu_torch.ops import inter as IN
from vp8oclenc_tpu_torch.ops import intra as I
from vp8oclenc_tpu_torch.ops import intra_replace as IR
from vp8oclenc_tpu_torch.ops import loopfilter as LF
from vp8oclenc_tpu_torch.pipeline.encoder import Encoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda", 0)


def _planes(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx * 5 + yy * 3) % 220 + rng.integers(0, 35, (h, w))).clip(0, 255)
    c = lambda: rng.integers(0, 256, (h // 2, w // 2))
    return [a.astype(np.uint8) for a in (y, c(), c())]


@pytest.mark.parametrize("size", [(96, 80), (80, 64), (48, 96), (16, 16),
                                  (16, 96), (96, 16)])
@pytest.mark.parametrize("q", [(7, 9), (120, 157)])
def test_kernels_match_plain(dev, size, q):
    w, h = size
    y, u, v = (torch.from_numpy(p).to(dev) for p in _planes(w, h, w + q[0]))
    uv = torch.stack([u, v])
    k, p = I.luma_wavefront(y, *q), I.luma_wavefront_plain(y, *q)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    k, p = I.chroma_wavefront(uv, *q), I.chroma_wavefront_plain(uv, *q)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    mbc = (w // 16) * (h // 16)
    rng = np.random.default_rng(q[0])
    sid = torch.as_tensor(rng.integers(0, 4, mbc), dtype=torch.int32,
                          device=dev)
    inner = torch.as_tensor(rng.random(mbc) < 0.5, device=dev)
    lim = [torch.as_tensor(rng.integers(lo, hi, 4), dtype=torch.int32,
                           device=dev)
           for lo, hi in ((0, 63), (20, 140), (10, 130), (1, 10), (0, 3))]
    planes = (y, uv[0].contiguous(), uv[1].contiguous())
    k = LF.filter_planes(*planes, sid, inner, *lim)
    p = LF.filter_planes_plain(*planes, sid, inner, *lim)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    torch.cuda.synchronize()


def _filter_args(w, h, seed, dev):
    """Blocky planes that the filter changes, a mixed inner mask, and two
    segments in use of which one has level 0."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(h) // 4 * 7, np.arange(w) // 4 * 5) % 60
    y = ramp + 100 + rng.integers(0, 10, (h, w))
    u = ramp[::2, ::2] + 90 + rng.integers(0, 4, (h // 2, w // 2))
    v = rng.integers(90, 140, (h // 2, w // 2))
    mbc = (w // 16) * (h // 16)
    sid = rng.integers(0, 2, mbc)
    inner = rng.random(mbc) < 0.5
    lim = ([0, 40, 0, 0], [0, 90, 0, 0], [0, 80, 0, 0], [0, 6, 0, 0],
           [0, 1, 0, 0])
    planes = [torch.from_numpy(a.astype(np.uint8)).to(dev) for a in (y, u, v)]
    return planes + [torch.as_tensor(sid, dtype=torch.int32, device=dev),
                     torch.as_tensor(inner, device=dev)] \
        + [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in lim]


def test_more_mb_rows_than_sms(dev):
    """A 64x2176 plane has 136 MB rows, more than the card has SMs: the
    row CTAs cannot all be resident, and a row still only waits for a row
    that is running."""
    w, h = 64, 2176
    y, u, v = (torch.from_numpy(a).to(dev) for a in _planes(w, h, 5))
    k, p = I.luma_wavefront(y, 12, 15), I.luma_wavefront_plain(y, 12, 15)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    # chroma of a 64x4352 frame: 272 chroma MB rows of 4 MBs
    uv = torch.stack([y[:, :32].contiguous(), y[:, 32:].contiguous()])
    k, p = I.chroma_wavefront(uv, 12, 15), I.chroma_wavefront_plain(uv, 12, 15)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    uv = torch.stack([u, v])
    k, p = I.chroma_wavefront(uv, 12, 15), I.chroma_wavefront_plain(uv, 12, 15)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    args = _filter_args(w, h, 6, dev)
    k, p = LF.filter_planes(*args), LF.filter_planes_plain(*args)
    assert not torch.equal(p[0], args[0])
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    torch.cuda.synchronize()


def test_repeated_launches_agree(dev):
    """Rows of one frame run on different SMs at different speeds (level-0
    and inner-less MBs are cheap): a wrong wait rule or a stale read shows
    as a launch that differs."""
    w, h = 640, 368
    y, u, v = (torch.from_numpy(a).to(dev) for a in _planes(w, h, 8))
    uv = torch.stack([u, v])
    args = _filter_args(w, h, 9, dev)
    pl, pf = I.luma_wavefront_plain(y, 20, 26), LF.filter_planes_plain(*args)
    pc = I.chroma_wavefront_plain(uv, 20, 26)
    for _ in range(5):
        assert all(torch.equal(a, b)
                   for a, b in zip(I.luma_wavefront(y, 20, 26), pl))
        assert all(torch.equal(a, b)
                   for a, b in zip(I.chroma_wavefront(uv, 20, 26), pc))
        assert all(torch.equal(a, b)
                   for a, b in zip(LF.filter_planes(*args), pf))
    torch.cuda.synchronize()


def test_filter_takes_unaligned_planes(dev):
    """Planes cut from a packed buffer at an odd offset are copied to a
    16-byte boundary by the wrapper, not refused (the quarter-pel kernel
    falls back to byte loads)."""
    w, h = 48, 32
    args = _filter_args(w, h, 3, dev)
    want = LF.filter_planes_plain(*args)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.uint8, device=dev)
    buf[1:] = args[0].reshape(-1)
    args[0] = buf[1:].view(h, w)
    assert args[0].data_ptr() % 16
    got = LF.filter_planes(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y = args[0]
    assert all(torch.equal(a, b) for a, b in zip(
        I.luma_wavefront(y, 9, 11), I.luma_wavefront_plain(y, 9, 11)))
    buf = torch.empty(2 * 16 * 24 + 1, dtype=torch.uint8, device=dev)
    buf[1:] = args[0].reshape(-1)[:2 * 16 * 24]
    uv = buf[1:].view(2, 16, 24)
    assert all(torch.equal(a, b) for a, b in zip(
        I.chroma_wavefront(uv, 9, 11), I.chroma_wavefront_plain(uv, 9, 11)))
    fv = torch.zeros((1, (h // 8) * (w // 8), 2), dtype=torch.int32,
                     device=dev)
    fv[0, ::2] = 1
    refs = args[0].flip(1).contiguous()[None]
    assert refs.data_ptr() % 4 == 0 and y.data_ptr() % 4
    assert all(torch.equal(a, b) for a, b in zip(
        IN.qpel_search(y, refs, fv), IN.qpel_search_plain(y, refs, fv)))


def test_gop1_stream_card_equals_cpu(dev):
    w, h = 70, 50
    frames = [Frame(*_planes(w, h, s)) for s in range(3)]
    cfg = dict(qi_min=10, qi_max=36, gop_size=1)
    before = I.luma_wavefront.launches
    gpu = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    a = list(gpu.encode_frames(frames))
    gpu.close()
    assert I.luma_wavefront.launches == before + 3
    cpu = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    b = list(cpu.encode_frames(frames))
    cpu.close()
    assert a == b


def _moving(w, h, n, seed):
    """A textured canvas panned a few pixels per frame plus a little noise:
    coherent enough that every frame after the first is an inter frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:2 * h, 0:2 * w]
    base = ((xx * 7 + yy * 3) % 256) // 2 + rng.integers(0, 100, yy.shape)
    base = base.clip(0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        oy, ox = 2 * t, 3 * t + (t % 2)
        c = base[oy // 2:oy // 2 + h // 2, ox // 2:ox // 2 + w // 2]
        frames.append(Frame(base[oy:oy + h, ox:ox + w].copy(),
                            c // 2 + 60, c[::-1].copy() // 2 + 60))
    return frames


@pytest.mark.parametrize("size", [(96, 80), (80, 64), (48, 96), (16, 16),
                                  (8, 40), (56, 8), (22, 18), (176, 144),
                                  (64, 2176)])
def test_search_kernels_match_plain(dev, size):
    """Both search kernels on every pyramid level that holds a block, with
    vectors large enough that windows and candidates cross the frame edge,
    with and without the penalty.  The small sizes are one block, one block
    column and one block row (levels whose width is no multiple of 4 among
    them, 11x9 and 22x18 of a 176-wide frame: the kernels then load bytes,
    not words)."""
    w, h = size
    rng = np.random.default_rng(w * h)
    f = _moving(w, h, 4, seed=w)
    cur = IN.build_pyramid(torch.from_numpy(f[3].y).to(dev))
    refs = [IN.build_pyramid(torch.from_numpy(g.y).to(dev)) for g in f[:3]]
    for lvl in range(5):
        c = cur[lvl]
        H, W = c.shape
        n = (H // 8) * (W // 8)
        if n == 0:
            continue
        r = torch.stack([p[lvl] for p in refs]).contiguous()
        v0 = rng.integers(-12, 13, (3, n, 2))
        v0[:, 0], v0[:, -1] = -12, 12      # windows beyond both corners
        v0 = torch.as_tensor(v0, dtype=torch.int32, device=dev)
        for penalty in (False, True):
            k = IN.fullpel_search(c, r, v0, penalty)
            p = IN.fullpel_search_plain(c, r, v0, penalty)
            assert torch.equal(k, p), (lvl, penalty)
        before = IN.qpel_search.launches
        k = IN.qpel_search(c, r, v0)
        p = IN.qpel_search_plain(c, r, v0)
        assert IN.qpel_search.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(k, p)), lvl
    torch.cuda.synchronize()


def test_default_gop_stream_card_equals_cpu(dev):
    w, h = 96, 80
    frames = _moving(w, h, 5, seed=4)
    cfg = dict(qi_min=8, qi_max=30, gop_size=100, altref_range=3)
    counters = (I.luma_wavefront, IN.fullpel_search, IN.qpel_search,
                LF.filter_planes, IN.inter_pass, S.mb_ssim_cuda)
    before = [c.launches for c in counters]
    gpu = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    a = list(gpu.encode_frames(frames))
    gpu.close()
    after = [c.launches for c in counters]
    # 1 keyframe, 4 inter frames: levels 3..0 hold blocks at 96x80; one
    # segment pass an inter frame, which scores its MBs itself
    assert [y - x for x, y in zip(before, after)] == [1, 16, 4, 5, 4, 0]
    cpu = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    b = list(cpu.encode_frames(frames))
    cpu.close()
    assert a == b


def test_mid_gop_checkpoint_round_trip_on_the_card(dev):
    """A checkpoint taken on the card inside a GOP (LAST, GOLDEN and
    ALTREF copied to the host) restored into a fresh card encoder and into
    the spec backend: both continue the card's stream byte-identically."""
    w, h = 96, 80
    frames = _moving(w, h, 7, seed=21)
    cfg = dict(qi_min=10, qi_max=36, gop_size=100, altref_range=3)
    ref = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    want = [ref.encode_frame(f) for f in frames]
    ref.close()
    enc = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    for f in frames[:4]:
        enc.encode_frame(f)
    st = enc.checkpoint()
    enc.close()
    assert st["last"] is not None and st["altref"] is not None
    for resumed in (Encoder(EncoderConfig(**cfg), w, h, device=dev),
                    Encoder(EncoderConfig(**cfg), w, h, backend="spec")):
        resumed.restore(st)
        assert list(resumed.encode_frames(frames[4:])) == want[4:]
        resumed.close()


def test_inter_dispatch_never_waits_for_the_card(dev):
    """Dispatching an inter frame's chain makes no call that synchronizes
    the stream (a per-call copy from pageable host memory would), so the
    host codes one frame while the card runs the next."""
    from vp8oclenc_tpu_torch.pipeline.encoder import _own_padded
    frames = _moving(96, 80, 3, seed=6)
    enc = Encoder(EncoderConfig(qi_min=8, qi_max=30), 96, 80, device=dev)
    list(enc.encode_frames(frames[:2]))          # key, then warm constants
    torch.cuda.set_sync_debug_mode("error")
    try:
        fd, seg = enc._frame_pixels(_own_padded(frames[2]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not fd.is_key
    enc.backend.finalize_framedata(fd, seg)
    enc.close()


@pytest.mark.parametrize("size", [(96, 80), (80, 64), (48, 96)])
@pytest.mark.parametrize("q", [(7, 9), (120, 157)])
def test_trial_luma_matches_plain(dev, size, q):
    """Frozen neighbours cut from one plane, sources from another, with
    all-0 and all-255 MBs."""
    w, h = size
    y = _planes(w, h, w + q[0])[0]
    rec = _planes(w, h, w + q[0] + 1)[0]
    y[:16, :16], y[:16, 16:32] = 0, 255
    y_mb = IR._plane_mb(torch.from_numpy(y).to(dev), 16).contiguous()
    ftop, fleft = IR._frozen_luma_neighbors(torch.from_numpy(rec).to(dev),
                                            w // 16, h // 16)
    before = IR.trial_luma.launches
    k = IR.trial_luma(y_mb, ftop, fleft, *q)
    assert IR.trial_luma.launches == before + 1
    p = IR.trial_luma_plain(y_mb, ftop, fleft, *q)
    torch.cuda.synchronize()
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(k, p))
    assert len(torch.unique(k[1])) > 3


@pytest.mark.parametrize("mbc", [1, 7, 8161])
def test_trial_luma_edges_match_plain(dev, mbc):
    """One MB, a CTA of 8 MBs that is not full, one past a 1080p frame's
    8160; a third of the MBs all 0 and a third all 255, at the AQ, HQ and
    UQ quantizers of -qmin 50 -qmax 112 -SSIM-target 98."""
    from vp8oclenc_tpu_torch.pipeline.segments import prepare_segments
    rng = np.random.default_rng(mbc)
    rnd = lambda *s: torch.from_numpy(
        rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
    y_mb, ftop, fleft = rnd(mbc, 16, 16), rnd(mbc, 21), rnd(mbc, 16)
    y_mb[:mbc // 3], y_mb[mbc // 3:2 * mbc // 3] = 0, 255
    seg = prepare_segments(EncoderConfig(**SSIM_CFG),
                           _planes(96, 80, 1)[0], False, False)
    for sid in (2, 1, 0):
        q = (int(seg.y_dc_q[sid]), int(seg.y_ac_q[sid]))
        k = IR.trial_luma(y_mb, ftop, fleft, *q)
        p = IR.trial_luma_plain(y_mb, ftop, fleft, *q)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(k, p)), q


def _ssim_operands(mbw, mbh, seed, dev):
    """Every operand form the SSIM's callers pass, as (wrapper, plain,
    args): u8 source planes against an int32 and a u8 recon, per-MB
    patches (the trials: u8 luma, chroma source cut by `_plane_mb`, int32
    chroma recon) and non-contiguous (mbh, mbw, n, n) views of the planes,
    all on the kernel's vector path; and on its strided path the planes
    one column into wider buffers (misaligned), and int32 sources with the
    recon pairs swapped (the form read at run time).  The first MBs are
    edge blocks: identical source and recon, flat against flat, all 0
    against all 255, all 255 against all 255 and against all 0."""
    rng = np.random.default_rng(seed)
    sizes = (16, 8, 8)
    src = [rng.integers(0, 256, (mbh * n, mbw * n)).astype(np.uint8)
           for n in sizes]
    rec = [(s.astype(np.int32) + rng.integers(-9, 10, s.shape)).clip(0, 255)
           for s in src]
    for k, pair in enumerate([None, (100, 100), (0, 255), (255, 255),
                              (255, 0)][:mbw * mbh]):
        for s, r, n in zip(src, rec, sizes):
            cut = np.s_[k // mbw * n:(k // mbw + 1) * n,
                        k % mbw * n:(k % mbw + 1) * n]
            if pair is None:
                r[cut] = s[cut]
            else:
                s[cut], r[cut] = pair
    planes = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for pair in zip(src, rec) for a in pair]
    planes[1::2] = [t.to(torch.int32) for t in planes[1::2]]
    u8 = [t.to(torch.uint8) for t in planes]
    patches = [IR._plane_mb(t, 16).contiguous() for t in u8[:2]] + [
        IR._plane_mb(t, 8) if i % 2 == 0 else IR._plane_mb(t, 8).contiguous()
        for i, t in enumerate(planes[2:])]
    views = [t.reshape(t.shape[0] // n, n, t.shape[1] // n, n).transpose(1, 2)
             for t, n in zip(planes, (16, 16, 8, 8, 8, 8))]
    assert mbw == 1 or not views[0].is_contiguous()
    misaligned = []
    for t in planes:
        wide = torch.zeros((t.shape[0], t.shape[1] + 1), dtype=t.dtype,
                           device=dev)
        wide[:, 1:] = t
        misaligned.append(wide[:, 1:])
    mixed = [planes[1].contiguous(), u8[0], planes[2].to(torch.int32),
             planes[3], u8[5], planes[4]]
    return [(S.mb_ssim_fx, S.mb_ssim_fx_plain, planes),
            (S.mb_ssim_fx, S.mb_ssim_fx_plain, u8),
            (S.mb_ssim_fx_16x16, S.mb_ssim_fx_16x16_plain, patches),
            (S.mb_ssim_fx_16x16, S.mb_ssim_fx_16x16_plain, views),
            (S.mb_ssim_fx, S.mb_ssim_fx_plain, misaligned),
            (S.mb_ssim_fx, S.mb_ssim_fx_plain, mixed)]


@pytest.mark.parametrize("mbw,mbh", [(120, 68), (240, 135), (1, 1),
                                     (7, 1), (8161, 1)])
def test_mb_ssim_matches_plain(dev, mbw, mbh):
    """The SSIM kernel bit-exact against its plain version at 1080p (8160
    MBs), UHD (32400), and 1, 7 and 8161 MBs, in every operand form and
    on both its paths, one launch a call."""
    for fn, plain, args in _ssim_operands(mbw, mbh, mbw * mbh, dev):
        before = S.mb_ssim_cuda.launches
        k = fn(*args)
        assert S.mb_ssim_cuda.launches == before + 1
        p = plain(*args)
        torch.cuda.synchronize()
        assert k.dtype == p.dtype == torch.int32 and k.shape == p.shape
        assert torch.equal(k, p)


def test_mb_ssim_refuses_mixed_devices(dev):
    y = torch.zeros((16, 16), dtype=torch.uint8)
    c = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        S.mb_ssim_fx(y, y.to(dev), c, c, c, c)
    with pytest.raises(ValueError):
        S.mb_ssim_fx_16x16(*(t.to(dev) for t in (y, y, c, c, c)),
                           c.to(torch.int16).to(dev))


PASS_QUANTS = [(4, 4, 8, 8, 4, 4), (157, 284, 314, 440, 132, 284),
               (33, 41, 66, 51, 20, 30), (7, 9, 12, 14, 6, 8)]


def _pass_operands(mbw, mbh, seed, dev, chroma=np.int32):
    """The transform pass's operands as the inter path passes them: u8
    source planes, a u8 luma and an int32 (or u8) chroma prediction with
    +255 and -255 residuals in MB 0, mixed partitionings, and for each
    later pass a cur_ssim around 0 (about half the MBs active)."""
    rng = np.random.default_rng(seed)
    sizes = ((16 * mbh, 16 * mbw), (8 * mbh, 8 * mbw), (8 * mbh, 8 * mbw))
    src = [rng.integers(0, 256, s).astype(np.uint8) for s in sizes]
    pred = [(s.astype(np.int32) + rng.integers(-20, 21, s.shape))
            .clip(0, 255) for s in src]
    for s, p, n in zip(src, pred, (16, 8, 8)):
        s[:n // 2, :n], p[:n // 2, :n] = 255, 0
        s[n // 2:n, :n], p[n // 2:n, :n] = 0, 255
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    return ([t(a, np.uint8) for a in src],
            [t(pred[0], np.uint8)] + [t(a, chroma) for a in pred[1:]],
            t(rng.integers(0, 2, mbw * mbh), np.int32),
            [t(rng.integers(-3, 3, mbw * mbh), np.int32) for _ in range(4)])


@pytest.mark.parametrize("mbw,mbh", [(1, 1), (7, 1), (8161, 1), (6, 5),
                                     (1024, 8)])
@pytest.mark.parametrize("chroma", [np.int32, np.uint8])
def test_inter_pass_matches_plain(dev, mbw, mbh, chroma):
    """The transform pass kernel with its SSIM bit-exact against its plain
    version at 1, 7 and 8161 MBs in a row, 96x80 and 16384x128, with an
    int32 and a u8 chroma prediction: four passes, the first over every
    MB, the others over the MBs at or below the target (cur_ssim injected
    into both states, so that the masks mix), one launch each; every
    state tensor equal after every pass, cur_ssim included."""
    src, pred, parts, curs = _pass_operands(mbw, mbh, mbw + mbh, dev, chroma)
    ks = ps = None
    for i, q in enumerate(PASS_QUANTS):
        if i:
            ks[6].copy_(curs[i])
            ps[6].copy_(curs[i])
        before = IN.inter_pass.launches
        ks = IN.inter_pass(*src, *pred, parts, 3 - i, q, 0, ks)
        assert IN.inter_pass.launches == before + 1
        ps = IN.inter_pass_plain(*src, *pred, parts, 3 - i, q, 0, ps)
        torch.cuda.synchronize()
        assert len(ks) == len(ps) == 7
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(ks, ps)), i
    if mbw * mbh > 1:
        assert len(torch.unique(ks[1])) > 1         # the masks mixed them


@pytest.mark.parametrize("chroma", [np.int32, np.uint8])
def test_inter_pass_strided_path_matches_plain(dev, chroma):
    """The transform pass's strided path, which the launcher takes when a
    plane's rows are not aligned for vector loads: the source and
    prediction planes one column into wider buffers (96x80), a masked
    pass after a first one."""
    src, pred, parts, curs = _pass_operands(6, 5, 11, dev, chroma)

    def shifted(t):
        wide = torch.zeros((t.shape[0], t.shape[1] + 1), dtype=t.dtype,
                           device=dev)
        wide[:, 1:] = t
        return wide[:, 1:]

    src, pred = [shifted(t) for t in src], [shifted(t) for t in pred]
    ks = IN.inter_pass(*src, *pred, parts, 3, PASS_QUANTS[0])
    ps = IN.inter_pass_plain(*src, *pred, parts, 3, PASS_QUANTS[0])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ks, ps))
    for state in (ks, ps):
        state[6].copy_(curs[1])
    ks = IN.inter_pass(*src, *pred, parts, 2, PASS_QUANTS[1], 0, ks)
    ps = IN.inter_pass_plain(*src, *pred, parts, 2, PASS_QUANTS[1], 0, ps)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ks, ps))
    assert 0 < int(ks[5].sum()) < 30                # the mask mixed them


# (y_dc, y_ac, uv_dc, uv_ac) of the trials AQ, HQ, UQ: the chroma pairs
# at the extremes and between
TRIAL_QUANTS = ((60, 90, 132, 284), (20, 40, 17, 25), (7, 9, 4, 4))
CEILING = 3 * 32767           # the highest three-plane score there is


def _merge_same(mbw, mbh, seed, dev, ghost, mode, shift=0):
    """Three chained trials (luma kernel, then the chroma trial with its
    score and merge) on random planes, the kernel's merge state against
    the plain version's after each, bit-exact; one launch a trial.  mode:
    "all" (every MB active and winning), "none" (inactive MBs and active
    ones at the ceiling) or "some" (every third MB inactive, the others'
    scores random below the target).  shift: the chroma planes one column
    into wider buffers (rows not aligned: the strided path).  Returns the
    MBs that won."""
    rng = np.random.default_rng(seed)

    def plane(h, w, k=0):
        a = torch.from_numpy(rng.integers(0, 256, (h, w + k),
                                          dtype=np.uint8)).to(dev)
        return a[:, k:]

    mbc = mbw * mbh
    y_mb = IR._plane_mb(plane(16 * mbh, 16 * mbw), 16).contiguous()
    ftop, fleft = IR._frozen_luma_neighbors(plane(16 * mbh, 16 * mbw), mbw,
                                            mbh)
    u, v, ru, rv = (plane(8 * mbh, 8 * mbw, shift) for _ in range(4))
    ghosts = (plane(1, 8 * mbw)[0].contiguous(),
              plane(1, 8 * mbw)[0].contiguous()) if ghost else (None, None)
    q3, target = 3 * 32768, 96337
    if mode == "all":
        cur = np.full(mbc, -2 * q3)
    elif mode == "none":
        cur, target = np.where(np.arange(mbc) % 2, q3, CEILING), CEILING
    else:
        cur = np.where(np.arange(mbc) % 3 == 1, q3,
                       rng.integers(-q3, target, mbc))
    cur = torch.as_tensor(cur, dtype=torch.int32, device=dev)
    ks, ps = IR.merge_state(mbc, dev), IR.merge_state(mbc, dev)
    kc = pc = cur
    for sid, q in zip((2, 1, 0), TRIAL_QUANTS):
        luma = IR.trial_luma(y_mb, ftop, fleft, *q[:2])
        before = IR.trial_chroma_merge.launches
        IR.trial_chroma_merge(y_mb, luma, u, v, ru, rv, ghosts, kc, ks, sid,
                              *q[2:], target)
        assert IR.trial_chroma_merge.launches == before + 1
        IR.trial_chroma_merge_plain(y_mb, luma, u, v, ru, rv, ghosts, pc, ps,
                                    sid, *q[2:], target)
        kc, pc = ks["cur"], ps["cur"]
        torch.cuda.synchronize()
        for name in ks:
            assert ks[name].dtype == ps[name].dtype
            assert torch.equal(ks[name], ps[name]), (mode, sid, name)
    win = int(ks["win"].sum())
    if mode == "all":
        assert win == mbc
    elif mode == "none":
        assert win == 0
    return win


@pytest.mark.parametrize("mbw,mbh", [(1, 1), (7, 1), (8161, 1), (6, 5),
                                     (1024, 8)])
@pytest.mark.parametrize("ghost", [False, True])
def test_trial_chroma_matches_plain(dev, mbw, mbh, ghost):
    """The chroma trial with its score and merge in one launch a trial,
    bit-exact against the plain version at 1, 7 and 8161 MBs in a row,
    96x80 and 16384x128, with and without a ghost row, with all, none and
    some MBs winning over three chained trials."""
    for mode in ("all", "none", "some"):
        won = _merge_same(mbw, mbh, mbw + 3 * mbh, dev, ghost, mode)
        if mode == "some" and mbw * mbh >= 7:
            assert 0 < won < mbw * mbh


@pytest.mark.parametrize("ghost", [False, True])
def test_trial_chroma_merge_strided_path_matches_plain(dev, ghost):
    """The chroma planes one column into wider buffers (96x80 and 7 MBs in
    a row): rows not aligned for vector loads, the strided path."""
    for mbw, mbh in ((6, 5), (7, 1)):
        for mode in ("all", "none", "some"):
            _merge_same(mbw, mbh, mbw + mbh, dev, ghost, mode, shift=1)


def test_transform_kernels_refuse_mixed_devices(dev):
    src, pred, parts, _ = _pass_operands(2, 1, 3, dev)
    with pytest.raises(ValueError):
        IN.inter_pass(*src, *pred, parts.cpu(), 3, PASS_QUANTS[0])
    with pytest.raises(ValueError):
        IN.inter_pass(src[0][:8], *src[1:], *pred, parts, 3, PASS_QUANTS[0])
    state = IN.inter_pass(*src, *pred, parts, 3, PASS_QUANTS[0])
    with pytest.raises(ValueError):                 # cur_ssim is missing
        IN.inter_pass(*src, *pred, parts, 2, PASS_QUANTS[1], 0, state[:6])
    with pytest.raises(ValueError):                 # chroma types differ
        IN.inter_pass(*src, pred[0], pred[1], pred[2].to(torch.uint8),
                      parts, 3, PASS_QUANTS[0])
    z = lambda *s_, dt=torch.uint8: torch.zeros(s_, dtype=dt, device=dev)
    y_mb = z(2, 16, 16)
    luma = IR.trial_luma(y_mb, z(2, 21), z(2, 16), 4, 4)
    c, cur, st = z(8, 16), z(2, dt=torch.int32), IR.merge_state(2, dev)
    for args in ((c, c.cpu(), c, c, (None, None), cur, st),
                 (c, c.to(torch.int32), c, c, (None, None), cur, st),
                 (c, c, c, c, (c[0], None), cur, st),
                 (c, c, c, c, (None, None), cur.cpu(), st),
                 (c, c, c, c, (None, None), cur, IR.merge_state(2, "cpu")),
                 (c, c, c[:, :8], c[:, :8], (None, None), cur, st)):
        with pytest.raises(ValueError):
            IR.trial_chroma_merge(y_mb, luma, *args, 2, 4, 4, 0)


def test_inter_chain_launches_transform_kernels_without_sync(dev):
    """An inter frame's dispatch, with SSIM control off and on, goes
    through the transform pass kernel (1 and 4 launches) and the chroma
    trial kernel with its score and merge (3 launches with SSIM on, none
    with it off), and never through the SSIM kernel (the passes and the
    trials score their MBs), with stream synchronization an error."""
    from vp8oclenc_tpu_torch.pipeline.encoder import _own_padded
    for cfg, frames, passes, trials in (
            (dict(qi_min=8, qi_max=30), _moving(96, 80, 3, seed=6), 1, 0),
            (SSIM_CFG, _replacement(96, 80, 3, seed=7), 4, 3)):
        counters = (IN.inter_pass, IR.trial_chroma_merge, S.mb_ssim_cuda)
        enc = Encoder(EncoderConfig(**cfg), 96, 80, device=dev)
        list(enc.encode_frames(frames[:2]))      # key, then warm constants
        before = [c.launches for c in counters]
        torch.cuda.set_sync_debug_mode("error")
        try:
            fd, seg = enc._frame_pixels(_own_padded(frames[2]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not fd.is_key
        assert [c.launches - b for c, b in zip(counters, before)] == [
            passes, trials, 0]
        enc.close()


def _replacement(w, h, n, seed):
    """Static noise, constant chroma, and three 32x32 regions that get a
    fresh smooth gradient every frame: inter prediction fails there and
    the intra replacement wins."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h, w)).astype(np.uint8)
    u = np.full((h // 2, w // 2), 120, np.uint8)
    v = np.full((h // 2, w // 2), 130, np.uint8)
    yy, xx = np.mgrid[0:32, 0:32]
    frames = []
    for _ in range(n):
        y = base.copy()
        for oy, ox in ((16, 32), (48, 0), (32, 64)):
            a, b = rng.uniform(-6, 6, 2)
            y[oy:oy + 32, ox:ox + 32] = (128 + a * (xx - 16) + b * (yy - 16)
                                         ).clip(0, 255).astype(np.uint8)
        frames.append(Frame(y, u.copy(), v.copy()))
    return frames


SSIM_CFG = dict(qi_min=50, qi_max=112, gop_size=100, ssim_target=0.98,
                altref_range=100)


def test_ssim_stream_card_equals_cpu(dev):
    w, h = 96, 80
    frames = _replacement(w, h, 5, seed=7)
    before = (IR.trial_luma.launches, S.mb_ssim_cuda.launches,
              IR.trial_chroma_merge.launches)
    gpu = Encoder(EncoderConfig(**SSIM_CFG), w, h, device=dev)
    a, replaced = [], 0
    for payload in gpu.encode_frames(frames):
        a.append(payload)
        replaced += gpu.last_frame_stats["replaced"]
    gpu.close()
    # 1 keyframe, 4 inter frames, three trials each, no redo; the SSIM
    # kernel never runs (the passes and the trials score their own MBs)
    assert IR.trial_luma.launches == before[0] + 12
    assert IR.trial_chroma_merge.launches == before[2] + 12
    assert S.mb_ssim_cuda.launches == before[1]
    assert replaced > 0
    cpu = Encoder(EncoderConfig(**SSIM_CFG), w, h, device="cpu")
    b = list(cpu.encode_frames(frames))
    cpu.close()
    assert a == b


def test_ssim_inter_dispatch_never_waits_for_the_card(dev):
    """The four segment passes, the three trials and the merge run under
    masks: dispatching an SSIM-on inter frame synchronizes nothing."""
    from vp8oclenc_tpu_torch.pipeline.encoder import _own_padded
    frames = _replacement(96, 80, 3, seed=7)
    enc = Encoder(EncoderConfig(**SSIM_CFG), 96, 80, device=dev)
    list(enc.encode_frames(frames[:2]))          # key, then warm constants
    torch.cuda.set_sync_debug_mode("error")
    try:
        fd, seg = enc._frame_pixels(_own_padded(frames[2]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not fd.is_key
    assert enc._finalize_fd(fd, seg) is None
    enc.close()


def _strip(plane, row0, rows, pad):
    idx = torch.arange(row0 - pad, row0 + rows + pad,
                       device=plane.device).clamp(0, plane.shape[-2] - 1)
    return plane[..., idx, :].contiguous()


@pytest.mark.parametrize("T", [2, 4])
def test_shard_search_kernels_match_plain(dev, T):
    """Both searches on reference strips (row-shard mode: ref_off, row0,
    full_h) at levels 1 and 0 of a 96x192 frame, every shard, vectors to
    the halo's edge and past the frame: the kernels equal their plain
    versions; the whole-plane mode (ref_off = row0 = 0, full_h = H) stays
    as it was."""
    w, h = 96, 192
    rng = np.random.default_rng(T)
    cur = IN.build_pyramid(torch.from_numpy(_planes(w, h, 1)[0]).to(dev))
    refs = [torch.stack(lv).contiguous() for lv in zip(*(
        IN.build_pyramid(torch.from_numpy(_planes(w, h, s)[0]).to(dev))
        for s in (2, 3, 4)))]
    for lvl in (1, 0):
        hl, wl = cur[lvl].shape
        rows, pad = hl // T, IN.PAD_Y_FULL >> lvl
        for t in range(T):
            row0 = t * rows
            strip = _strip(refs[lvl], row0, rows, pad)
            c = cur[lvl][row0:row0 + rows].contiguous()
            reach = 62 >> lvl
            v = rng.integers(-reach, reach + 1, (3, (rows // 8) * (wl // 8),
                                                 2))
            v[:, 0], v[:, -1] = -reach, reach
            v0 = torch.as_tensor(v, dtype=torch.int32, device=dev)
            args = (pad, row0, hl)
            for pen in (False, True):
                assert torch.equal(
                    IN.fullpel_search(c, strip, v0, pen, *args),
                    IN.fullpel_search_plain(c, strip, v0, pen, *args))
            if lvl == 0:
                fv = torch.as_tensor(v.clip(-60, 60), dtype=torch.int32,
                                     device=dev)
                k = IN.qpel_search(c, strip, fv, *args)
                p = IN.qpel_search_plain(c, strip, fv, *args)
                assert all(torch.equal(a, b) for a, b in zip(k, p))
        v0 = torch.as_tensor(rng.integers(-9, 10, (3, (hl // 8) * (wl // 8),
                                                   2)),
                             dtype=torch.int32, device=dev)
        assert torch.equal(IN.fullpel_search(cur[lvl], refs[lvl], v0, True),
                           IN.fullpel_search_plain(cur[lvl], refs[lvl], v0,
                                                   True))
    torch.cuda.synchronize()


@pytest.mark.parametrize("T", [1, 2, 4])
def test_band_filter_kernel_matches_plain(dev, T):
    """The filter kernel on bands with the 4 lines above handed in: each
    band's planes and write-back lines equal the plain band filter, and
    the bands handed down equal the whole-plane kernel."""
    w, h = 96, 128
    args = _filter_args(w, h, 11, dev)
    planes, sid, inner, lim = args[:3], args[3], args[4], args[5:]
    whole = LF.filter_planes(*args)
    n = sid.numel() // T
    bands, halo = [], None
    for t in range(T):
        cut = [p[t * (p.shape[0] // T):(t + 1) * (p.shape[0] // T)]
               .contiguous() for p in planes]
        a = (*cut, halo, sid[t * n:(t + 1) * n].contiguous(),
             inner[t * n:(t + 1) * n].contiguous(), *lim)
        out, wb = LF.filter_band(*a)
        pout, pwb = LF.filter_band_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(out, pout))
        assert (wb is None) == (pwb is None) == (t == 0)
        if wb is not None:
            assert all(torch.equal(x, y) for x, y in zip(wb, pwb))
            for k in range(3):
                bands[-1][k][-3:] = wb[k]
        bands.append([o.clone() for o in out])
        halo = [o[-4:].contiguous() for o in out]
    got = [torch.cat([b[k] for b in bands]) for k in range(3)]
    assert all(torch.equal(x, y) for x, y in zip(got, whole))
    torch.cuda.synchronize()


@pytest.mark.parametrize("size,gop,tile", [((176, 144), 2, 1),
                                           ((176, 128), 1, 2),
                                           ((176, 112), 1, 2)])
def test_two_rank_encode_equals_single_rank(dev, size, gop, tile):
    """Two ranks sharing the card over gloo (two GOP lanes, or one lane of
    two row tiles, 7 MB rows as 4 + 3 in the last case) give the
    single-rank stream, through the kernels."""
    from vp8oclenc_tpu_torch.parallel.encoder import encode_frames_spawned
    w, h = size
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:h + 32, 0:w + 32]
    base = (120 + 60 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
            + rng.integers(0, 30, xx.shape)).clip(0, 255).astype(np.uint8)
    frames = [Frame(base[2 * t:2 * t + h, 3 * t:3 * t + w].copy(),
                    base[t:t + h // 2, t:t + w // 2] // 2 + 60,
                    base[t + 4:t + 4 + h // 2, t:t + w // 2] // 2 + 50)
              for t in range(6)]
    cfg = dict(qi_min=10, qi_max=40, gop_size=3, altref_range=2)
    enc = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    want = list(enc.encode_frames(frames))
    enc.close()
    got, launches, _s = encode_frames_spawned(
        EncoderConfig(**cfg), frames, w, h, 2, "gloo", [dev] * 2, gop=gop,
        tile=tile)
    assert got == want
    for name in ("luma_wavefront", "chroma_wavefront", "loop_filter_band",
                 "fullpel_search_shard", "qpel_search_shard"):
        assert launches[name] > 0, name


UHD_W, UHD_H = 3840, 2160


@pytest.fixture(scope="module")
def uhd_frames():
    """4 frames of the panned canvas at 3840x2160, made once (~7 s);
    module-scoped fixtures come before `dev`, so it skips on its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return _moving(UHD_W, UHD_H, 4, seed=9)


@pytest.mark.parametrize("kernel", ["intra", "loop_filter", "search",
                                    "trial_luma"])
def test_uhd_kernels_match_plain(dev, uhd_frames, kernel):
    """Each kernel once at 3840x2160 (240 x 135 MBs: more MB rows than
    SMs), bit for bit: the luma and chroma wavefronts; the loop filter on
    four segments, whole plane and as bands of 68 and 67 MB rows handed
    down; both searches on the five levels of a UHD pyramid (levels 4..2
    with rows below their last block row, level 3 past the full-pel
    kernel's few-blocks threshold); the luma trial at 32400 MBs."""
    from vp8oclenc_tpu_torch.parallel.mesh import band_rows
    rng = np.random.default_rng(9)
    f = uhd_frames
    y = torch.from_numpy(f[3].y).to(dev)
    mbw, mbh = UHD_W // 16, UHD_H // 16
    mbc = mbw * mbh
    if kernel == "intra":
        uv = torch.from_numpy(np.stack([f[3].u, f[3].v])).to(dev)
        assert all(torch.equal(a, b) for a, b in zip(
            I.luma_wavefront(y, 12, 15), I.luma_wavefront_plain(y, 12, 15)))
        assert all(torch.equal(a, b) for a, b in zip(
            I.chroma_wavefront(uv, 12, 15),
            I.chroma_wavefront_plain(uv, 12, 15)))
    elif kernel == "loop_filter":
        planes = [y] + [torch.from_numpy(p).to(dev) for p in (f[3].u,
                                                               f[3].v)]
        sid = torch.as_tensor(rng.integers(0, 4, mbc), dtype=torch.int32,
                              device=dev)
        inner = torch.as_tensor(rng.random(mbc) < 0.5, device=dev)
        lim = [torch.as_tensor(a, dtype=torch.int32, device=dev) for a in
               ([20, 40, 0, 63], [60, 90, 40, 130], [50, 80, 30, 120],
                [3, 6, 1, 9], [0, 1, 0, 2])]
        whole = LF.filter_planes(*planes, sid, inner, *lim)
        p = LF.filter_planes_plain(*planes, sid, inner, *lim)
        assert all(torch.equal(a, b) for a, b in zip(whole, p))
        halo, bands = None, []
        for r0, n in band_rows(mbh, 2):
            mbs = slice(r0 * mbw, (r0 + n) * mbw)
            out, wb = LF.filter_band(
                *(q[r0 * s:(r0 + n) * s].contiguous()
                  for q, s in zip(planes, (16, 8, 8))), halo,
                sid[mbs].contiguous(), inner[mbs].contiguous(), *lim)
            if wb is not None:
                for k in range(3):
                    bands[-1][k][-3:] = wb[k]
            bands.append([o.clone() for o in out])
            halo = [o[-4:].contiguous() for o in out]
        got = [torch.cat([b[k] for b in bands]) for k in range(3)]
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    elif kernel == "search":
        cur = IN.build_pyramid(y)
        refs = [torch.stack(lv).contiguous() for lv in zip(*(
            IN.build_pyramid(torch.from_numpy(g.y).to(dev)) for g in f[:3]))]
        vec = None
        for lvl, rate in ((4, 16), (3, 8), (2, 4), (1, 2), (0, 1)):
            h, w = cur[lvl].shape
            v0 = IN.inherit_vectors(vec, 3, h // 8, w // 8, rate, dev)
            k = IN.fullpel_search(cur[lvl], refs[lvl], v0, rate < 4)
            assert torch.equal(k, IN.fullpel_search_plain(
                cur[lvl], refs[lvl], v0, rate < 4)), lvl
            vec = (k * rate).reshape(3, h // 8, w // 8, 2)
        fv = vec.reshape(3, -1, 2).contiguous()
        assert all(torch.equal(a, b) for a, b in zip(
            IN.qpel_search(cur[0], refs[0], fv),
            IN.qpel_search_plain(cur[0], refs[0], fv)))
    else:
        recon = I.luma_wavefront(torch.from_numpy(f[2].y).to(dev), 40, 50)[0]
        y_mb = IR._plane_mb(y, 16).contiguous()
        ftop, fleft = IR._frozen_luma_neighbors(recon, mbw, mbh)
        assert y_mb.shape[0] == mbc
        assert all(torch.equal(a, b) for a, b in zip(
            IR.trial_luma(y_mb, ftop, fleft, 30, 40),
            IR.trial_luma_plain(y_mb, ftop, fleft, 30, 40)))
    torch.cuda.synchronize()


def test_row_kernels_take_the_widest_vp8_plane(dev):
    """The row kernels' shared memory (the libraries' own counts) fits a
    CTA of this card at 16384 pixels, VP8's widest plane padded to MBs:
    luma's source ring does not grow with the width, and the filter takes
    its ring kernel where the full row no longer fits (from 7264)."""
    from vp8oclenc_tpu_torch.ops import cuda_build
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    intra = cuda_build.library("intra")
    lib = cuda_build.library("loopfilter")
    filt = lib.vp8_filter_smem
    assert max(intra.vp8_luma_smem(16384), intra.vp8_chroma_smem(8192),
               filt(16384)) <= limit
    assert filt(7264) == filt(16384) < filt(7248) <= limit
    assert [lib.vp8_filter_ring(w) for w in (1920, 3840, 7248, 7264, 7680,
                                             16384)] == [0, 0, 0, 1, 1, 1]


def _same_as_plain_on_cpu(kernel_out, plain_out):
    """The plain versions run on the CPU here: the same function on the
    same inputs, without the card's per-step launches."""
    return all(torch.equal(a.cpu(), b) for a, b in zip(kernel_out, plain_out))


@pytest.mark.parametrize("w,h", [(7264, 32), (7680, 48), (11072, 32),
                                 (16384, 64)])
def test_wide_row_kernels_match_plain(dev, w, h):
    """Widths where staging the whole row does not fit a CTA (the filter
    from 7264, where its ring kernel takes over; luma from 11072, which
    its source ring lifts) up to 16384: the filter, luma and chroma
    bit-exact against their plain versions."""
    planes = [torch.from_numpy(p) for p in _planes(w, h, w)]
    args = _filter_args(w, h, w + 1, dev)
    want = LF.filter_planes_plain(*[a.cpu() for a in args])
    assert _same_as_plain_on_cpu(LF.filter_planes(*args), want)
    y = planes[0].to(dev)
    assert _same_as_plain_on_cpu(I.luma_wavefront(y, 30, 40),
                                 I.luma_wavefront_plain(planes[0], 30, 40))
    uv = torch.stack(planes[1:])
    assert _same_as_plain_on_cpu(I.chroma_wavefront(uv.to(dev), 30, 40),
                                 I.chroma_wavefront_plain(uv, 30, 40))
    torch.cuda.synchronize()


def _bands_match_plain(args, T):
    """The filter in band mode over T bands of the planes in `args`
    (`_filter_args`), each band's halo from the band above: each launch
    equal to its plain version."""
    from vp8oclenc_tpu_torch.parallel.mesh import band_rows
    planes, sid, inner, lim = args[:3], args[3], args[4], args[5:]
    mbw = planes[0].shape[1] // 16
    halo = None
    for r0, n in band_rows(planes[0].shape[0] // 16, T):
        cut = [q[r0 * s:(r0 + n) * s].contiguous()
               for q, s in zip(planes, (16, 8, 8))]
        mbs = slice(r0 * mbw, (r0 + n) * mbw)
        band = (*cut, halo, sid[mbs].contiguous(), inner[mbs].contiguous(),
                *lim)
        out, wb = LF.filter_band(*band)
        want, wwb = LF.filter_band_plain(*[
            None if a is None else [h.cpu() for h in a] if isinstance(a, list)
            else a.cpu() for a in band])
        assert _same_as_plain_on_cpu(out, want)
        assert (wb is None) == (wwb is None)
        if wb is not None:
            assert _same_as_plain_on_cpu(wb, wwb)
        halo = [o[-4:].contiguous() for o in out]


def test_wide_band_filter_matches_plain(dev):
    """Band mode at 7680 pixels: 5 MB rows as bands of 3 and 2 handed
    down, halos in and write-back lines out equal to the plain version."""
    _bands_match_plain(_filter_args(7680, 80, 11, dev), 2)


def test_wide_stream_card_equals_cpu(dev):
    """Two frames of a panned canvas 7680x1088 (8K's width) at 4
    partitions and 6 packer threads: the card's bytes equal the plain CPU
    encode's."""
    w, h = 7680, 1088
    frames = _moving(w, h, 2, 41)
    cfg = dict(qi_min=10, qi_max=40, gop_size=3, altref_range=3,
               num_partitions=4, threads=6)
    gpu = Encoder(EncoderConfig(**cfg), w, h, device=dev)
    a = list(gpu.encode_frames(frames))
    gpu.close()
    assert [p[0] & 1 for p in a] == [0, 1]
    cpu = Encoder(EncoderConfig(**cfg), w, h, device="cpu")
    b = list(cpu.encode_frames(frames))
    cpu.close()
    assert a == b


def test_uhd_stream_card_equals_cpu(dev, uhd_frames):
    """A 3840x2160 keyframe and inter frame at 4 partitions and 6 packer
    threads: the card's bytes equal the plain CPU encode's."""
    frames = uhd_frames[:2]
    cfg = dict(qi_min=10, qi_max=40, gop_size=3, altref_range=3,
               num_partitions=4, threads=6)
    before = IN.qpel_search.launches
    gpu = Encoder(EncoderConfig(**cfg), UHD_W, UHD_H, device=dev)
    a = list(gpu.encode_frames(frames))
    gpu.close()
    assert IN.qpel_search.launches == before + 1
    assert [p[0] & 1 for p in a] == [0, 1]
    cpu = Encoder(EncoderConfig(**cfg), UHD_W, UHD_H, device="cpu")
    b = list(cpu.encode_frames(frames))
    cpu.close()
    assert a == b
