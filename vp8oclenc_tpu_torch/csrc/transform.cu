// The inter frame's transform passes and the SSIM controller's chroma
// trials for Hopper (sm_90a).
//
// Replaces XLA code of the JAX package (no Pallas kernel there), bit for
// bit against this package's plain versions:
//   * inter_pass_kernel: one segment pass of the inter frame over every MB,
//     the body of `seg_pass` (vp8oclenc_tpu/ops/inter.py:922) with
//     `transform_mb_luma` (:787), `transform_mb_chroma` (:812), the MB's
//     new SSIM (`mb_ssim`, :945) and the merge into cur_ssim (:946), which
//     XLA fuses into the frame's program.  Contract:
//     ops/inter.py:inter_pass_plain.  In plain PyTorch one pass is ~600
//     launches and its SSIM ~780 more; here it is one.
//   * trial_chroma_merge_kernel: the second half of one trial of the SSIM
//     controller's loop (vp8oclenc_tpu/ops/intra_replace.py:226-243): the
//     frozen chroma neighbours (`_frozen_chroma_neighbors`, :84-101, with
//     the shard's ghost row, :183-191), the TM_PRED trial of both chroma
//     planes (`_trial_chroma`, :147), the MB's three-plane score against
//     the luma trial's recon (`mb_ssim_fx_16x16`) and the merge of a
//     strictly better score into cur, win and the best-trial buffers.
//     Contract: ops/intra_replace.py:trial_chroma_merge_plain.  In plain
//     PyTorch a trial is ~20 launches besides the neighbour builds; here
//     it is one.
//
// What bounds them: bytes.  A 1080p pass reads the u8 source and the
// prediction planes once, cur_ssim and the partitionings, and writes the
// int16 levels (800 bytes an MB), the u8 recon, cur_ssim, the segment ids
// and `active`: ~19 MB, ~5.7 us at 3.35 TB/s.  The arithmetic, ~500
// integer operations a 4x4 block and ~150 an MB for the score, is about
// half of that at the card's integer rate.  A trial reads ~680 bytes an
// active MB (luma source and trial recon 512, chroma source 128, the
// neighbours 34, cur) and a winner moves ~1.7 KB more (the luma trial's
// levels, modes and recon copied, its own levels and recon written): 5.6
// to 19.4 MB at 1080p, 1.7 to 5.8 us.
//
// Design:
//   * inter_pass_kernel: one warp an MB, kPassWarps MBs of consecutive
//     index a CTA; a warp whose MB is past the end, or inactive in this
//     pass, returns as a whole.  Rows, then blocks, then rows again:
//       - lane l < 16 holds luma row l, lanes 16-23 U rows 0-7 and 24-31
//         V rows 0-7 (csrc/ssim_fx.cuh's mapping): it loads its source
//         and prediction row as vectors (16 or 8 u8 in one load, 8 int32
//         in two) where the planes are aligned, else pixel by pixel, and
//         writes the residual row to the warp's shared memory (int32,
//         rows padded so that neither the rows' nor the blocks' 16-byte
//         accesses meet in a bank);
//       - lanes 0-15 transform the luma blocks (in-MB raster order), 16-19
//         the U and 20-23 the V blocks, each its own 4x4 from shared
//         memory: fdct, quantization (levels stored as 32 bytes of zigzag
//         int16), dequantization; a 16x16 MB's DCs meet in shared memory
//         and lanes 0-15 run its Y2 chain once, one coefficient a lane
//         (each computes the 4x4 WHT and keeps its own element); then the
//         idct, whose residual goes back to the block's cells;
//       - each row lane adds its prediction row, clamps, stores the recon
//         row as one vector, and takes the row's five SSIM sums from the
//         source and recon in its registers (`dp4a`), so the score comes
//         from the values just computed, never a re-read of the recon it
//         wrote in place; `ssimfx::warp_mb_score` reduces and scores, and
//         lane 0 writes cur_ssim, the segment id and `active`.
//     Template parameters: the element size of the chroma prediction
//     (the luma prediction is u8), and the vector path, chosen by the
//     launcher; 64 registers on the vector path (4 CTAs, half the SM's
//     threads), 80 on the strided one.
//   * trial_chroma_merge_kernel: the same warp and row lanes for the
//     chroma half; an MB whose cur is above the target returns after
//     passing cur on.  The chroma row lanes build their TM_PRED row from
//     the frozen recon planes (the row above is one 8-byte load every row
//     lane of a plane makes, the ghost row's at a shard's top, 127 above
//     the frame; the left pixel and the corner single bytes, 129 left of
//     the frame); lanes 0-15 take their luma row's sums from the source
//     and the luma trial's recon.  Then all 32 lanes transform the 8
//     blocks, lane 4b + i taking row i and then column i of block b: each
//     transform's first pass on its rows or columns, the second after a
//     transpose through shared memory, the zigzag levels kept there (4
//     lanes a block, where a lane a block would leave 24 lanes idle).
//     The score is `warp_mb_score` of the recon in registers;
//     nothing is stored before it is known, and only a winner's lanes
//     store (the luma trial's levels, modes and recon rows, the chroma
//     levels and recon rows).  The vector path is the launcher's choice,
//     as for the pass.
//   * int32 throughout with the plain version's semantics: arithmetic
//     right shifts, q >> 1 rounding, division of non-negative values only
//     (by multipliers fixed for the launch, `div_of`); products that could
//     leave int32 wrap as torch's do (`mulw`).
//   * Planes are addressed with 32-bit offsets: the launchers refuse a
//     plane whose last pixel lies 2^31 elements or more from its first,
//     and more than 2^31 level or patch elements.
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "ssim_fx.cuh"

namespace {

constexpr int kPassWarps = 8;        // MBs a CTA of both kernels
constexpr int kAre16x16 = 0;         // tables.ARE16X16
constexpr int kSin = 35468;          // tables.SINPI8SQRT2
constexpr int kCos = 20091;          // tables.COSPI8SQRT2MINUS1

// A warp's shared memory in int32 words: the residual rows of luma (16 of
// kLumaStride words), U and V (8 of kChromaStride), then Y2's scratch.
// In 16-byte units a luma row is 5 apart and a chroma row 3, and V starts
// 2 units past a multiple of 8: every 8 lanes' 16-byte row or block
// accesses fall in distinct bank groups.
constexpr int kLumaStride = 20, kChromaStride = 12;
constexpr int kU0 = 16 * kLumaStride;                 // 320
constexpr int kV0 = kU0 + 8 * kChromaStride + 8;      // 424
constexpr int kY2 = kV0 + 8 * kChromaStride;          // 520: DCs, levels,
constexpr int kWarpWords = kY2 + 48;                  // dequantized

// tables.ZIGZAG[i]; folded to a constant under an unrolled loop
__device__ __forceinline__ constexpr int zig(int i) {
  return i == 0 ? 0 : i == 1 ? 1 : i == 2 ? 4 : i == 3 ? 8 : i == 4 ? 5
       : i == 5 ? 2 : i == 6 ? 3 : i == 7 ? 6 : i == 8 ? 9 : i == 9 ? 12
       : i == 10 ? 13 : i == 11 ? 10 : i == 12 ? 7 : i == 13 ? 11
       : i == 14 ? 14 : 15;
}

// int32 product that wraps as torch's int32 arithmetic does
__device__ __forceinline__ int mulw(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// ops/transforms.py:fdct4x4's first pass, of one row p into t, and its
// second, of one column t (rows 0-3) into x (rows 0-3)
__device__ __forceinline__ void fdct_row(const int* p, int* t) {
  const int a1 = (p[0] + p[3]) * 8, b1 = (p[1] + p[2]) * 8;
  const int c1 = (p[1] - p[2]) * 8, d1 = (p[0] - p[3]) * 8;
  t[0] = a1 + b1;
  t[1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12;
  t[2] = a1 - b1;
  t[3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12;
}

__device__ __forceinline__ void fdct_col(const int* t, int* x) {
  const int a1 = t[0] + t[3], b1 = t[1] + t[2];
  const int c1 = t[1] - t[2], d1 = t[0] - t[3];
  x[0] = (a1 + b1 + 7) >> 4;
  x[1] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0 ? 1 : 0);
  x[2] = (a1 - b1 + 7) >> 4;
  x[3] = (d1 * 2217 - c1 * 5352 + 51000) >> 16;
}

// ops/transforms.py:fdct4x4 of x (raster 4x4), in place
__device__ __forceinline__ void fdct4x4(int* x) {
  int t[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) fdct_row(x + 4 * r, t + 4 * r);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col[4] = {t[c], t[4 + c], t[8 + c], t[12 + c]};
    int o[4];
    fdct_col(col, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[4 * j + c] = o[j];
  }
}

// the odd half of the idct's butterfly: (c1, d1) of inputs i1, i3
__device__ __forceinline__ void idct_odd(int i1, int i3, int& c1, int& d1) {
  c1 = (mulw(i1, kSin) >> 16) - (i3 + (mulw(i3, kCos) >> 16));
  d1 = (i1 + (mulw(i1, kCos) >> 16)) + (mulw(i3, kSin) >> 16);
}

// ops/transforms.py:idct4x4's first pass, of one column x (rows 0-3) into
// t (rows 0-3), and its second, of one row t into x
__device__ __forceinline__ void idct_col(const int* x, int* t) {
  const int a1 = x[0] + x[2], b1 = x[0] - x[2];
  int c1, d1;
  idct_odd(x[1], x[3], c1, d1);
  t[0] = a1 + d1;
  t[1] = b1 + c1;
  t[2] = b1 - c1;
  t[3] = a1 - d1;
}

__device__ __forceinline__ void idct_row(const int* t, int* x) {
  const int a1 = t[0] + t[2], b1 = t[0] - t[2];
  int c1, d1;
  idct_odd(t[1], t[3], c1, d1);
  x[0] = (a1 + d1 + 4) >> 3;
  x[1] = (b1 + c1 + 4) >> 3;
  x[2] = (b1 - c1 + 4) >> 3;
  x[3] = (a1 - d1 + 4) >> 3;
}

// ops/transforms.py:idct4x4 of x (raster 4x4), in place
__device__ __forceinline__ void idct4x4(int* x) {
  int t[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int col[4] = {x[c], x[4 + c], x[8 + c], x[12 + c]};
    int o[4];
    idct_col(col, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) t[4 * j + c] = o[j];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) idct_row(t + 4 * r, x + 4 * r);
}

// ops/transforms.py:fwht4x4 of x (raster 4x4), in place
__device__ __forceinline__ void fwht4x4(int* x) {
  int t[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a = x[c] + x[12 + c], b = x[4 + c] + x[8 + c];
    const int cc = x[4 + c] - x[8 + c], d = x[c] - x[12 + c];
    t[c] = a + b;
    t[4 + c] = cc + d;
    t[8 + c] = a - b;
    t[12 + c] = d - cc;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int* p = t + 4 * r;
    const int a = p[0] + p[3], b = p[1] + p[2];
    const int cc = p[1] - p[2], d = p[0] - p[3];
    const int o[4] = {a + b, cc + d, a - b, d - cc};
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * r + k] = (o[k] + (o[k] > 0 ? 1 : 0)) >> 1;
  }
}

// ops/transforms.py:iwht4x4 of x (raster 4x4), in place
__device__ __forceinline__ void iwht4x4(int* x) {
  int t[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int* p = x + 4 * r;
    const int a = p[0] + p[3], b = p[1] + p[2];
    const int cc = p[1] - p[2], d = p[0] - p[3];
    t[4 * r + 0] = a + b;
    t[4 * r + 1] = cc + d;
    t[4 * r + 2] = a - b;
    t[4 * r + 3] = d - cc;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a = t[c] + t[12 + c], b = t[4 + c] + t[8 + c];
    const int cc = t[4 + c] - t[8 + c], d = t[c] - t[12 + c];
    x[c] = (a + b + 3) >> 3;
    x[4 + c] = (cc + d + 3) >> 3;
    x[8 + c] = (a - b + 3) >> 3;
    x[12 + c] = (d - cc + 3) >> 3;
  }
}

// Division of an unsigned 32-bit n by a quantizer fixed for the launch,
// exact for every n: Granlund and Montgomery's round-up method (1994,
// fig. 4.1) with multiplier m and shifts sh1 = min(l, 1), sh2 = max(l - 1,
// 0), l = ceil(log2 q).  A multiply-high, two adds and two shifts instead
// of the ~20 instructions of a division by a run-time divisor.
struct Div {
  unsigned m;
  int sh1, sh2;
};

inline Div div_of(int q) {                    // on the host, q >= 1
  int l = 0;
  while ((1LL << l) < q) ++l;
  const unsigned long long p = (1ULL << 32) * ((1ULL << l) - (unsigned)q);
  return {(unsigned)(p / (unsigned)q + 1), l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ unsigned divu(unsigned n, Div d) {
  const unsigned t = __umulhi(d.m, n);
  return (t + ((n - t) >> d.sh1)) >> d.sh2;
}

// ops/transforms.py:quant4x4 of one coefficient at quantizer q: q/2
// rounding away from zero, then truncation; only non-negative values are
// divided, by q's Div
__device__ __forceinline__ int quant_div(int c, int q, Div d) {
  const int h = q >> 1;
  const int a = c + (c < 0 ? -h : h);
  return a < 0 ? -(int)divu(0u - (unsigned)a, d) : (int)divu((unsigned)a, d);
}

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : v;
}

struct PassArgs {
  const uint8_t* src[3];      // y, u, v (u8)
  const void* pred[3];        // prediction planes, u8 or int32
  uint8_t* rec[3];            // recon planes (u8), written in place
  int src_rs[3], pred_rs[3], rec_rs[3];   // row strides, elements
  const int* parts;           // (mbc,)
  int* cur_ssim;              // (mbc,): read before the pass, then written
  int16_t* levels;            // (mbc, 25, 16): Y 0-15, U 16-19, V 20-23, Y2
  int* seg_ids;               // (mbc,)
  uint8_t* active;            // (mbc,)
  int mbc, mbw, sid, first, ssim_target;
  int q[6];                   // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac
  Div div[6];                 // their divisions
};

// 16 int16 values to 32 aligned bytes
__device__ __forceinline__ void store16(int16_t* dst, const unsigned* w) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// x[k] for a lane's own k, by selects (no local memory)
__device__ __forceinline__ int pick(const int* x, int k) {
  int v = x[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) v = k == i ? x[i] : v;
  return v;
}

// 16 words of shared memory to registers
__device__ __forceinline__ void load16(const int* s, int* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 t = reinterpret_cast<const int4*>(s)[i];
    x[4 * i] = t.x; x[4 * i + 1] = t.y; x[4 * i + 2] = t.z; x[4 * i + 3] = t.w;
  }
}

// tables.ZIGZAG[i] for an i known only at run time: nibble i of
// 0xfeb7adc963258410 (zig(i) above, one hex digit each, last first)
__device__ __forceinline__ int zig_rt(int i) {
  return (int)((0xfeb7adc963258410ull >> (4 * i)) & 15);
}

// The zigzag position of raster index n: nibble n of 0xfea9db83c7426510,
// the inverse of zig_rt
__device__ __forceinline__ int unzig_rt(int n) {
  return (int)((0xfea9db83c7426510ull >> (4 * n)) & 15);
}

using ssimfx::px;

// kN u8 pixels from p as packed words: one vector load, or bytes where
// the row is not aligned for it
template <int kN, bool kVec>
__device__ __forceinline__ void load_u8(const uint8_t* p, unsigned* w) {
  if constexpr (kVec && kN == 16) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (kVec) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x; w[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      w[i] = (unsigned)p[4 * i] | (unsigned)p[4 * i + 1] << 8 |
             (unsigned)p[4 * i + 2] << 16 | (unsigned)p[4 * i + 3] << 24;
  }
}

// A row lane's first half: its source row (sw, packed) and prediction row
// (pr, packed bytes or int32 values) of kN pixels from global memory, and
// the residual row to shared memory (srow).
template <int kE, int kN, bool kVec>
__device__ __forceinline__ void row_in(const uint8_t* src, const void* pred,
                                       int* srow, unsigned* sw, int* pr) {
  load_u8<kN, kVec>(src, sw);
  if constexpr (kE == 1) {
    load_u8<kN, kVec>((const uint8_t*)pred, (unsigned*)pr);
  } else {
    const int* p = (const int*)pred;
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      if constexpr (kVec) {
        const int4 t = reinterpret_cast<const int4*>(p)[i];
        pr[4 * i] = t.x; pr[4 * i + 1] = t.y;
        pr[4 * i + 2] = t.z; pr[4 * i + 3] = t.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) pr[4 * i + c] = p[4 * i + c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    int r[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      r[c] = (int)((sw[i] >> (8 * c)) & 255u) - px<kE>(pr, 4 * i + c);
    reinterpret_cast<int4*>(srow)[i] = make_int4(r[0], r[1], r[2], r[3]);
  }
}

// A row lane's second half: the reconstructed residual row from shared
// memory plus the prediction, clamped, as packed bytes (rw), and the row's
// five SSIM sums against the source added to s.
template <int kE, int kN>
__device__ __forceinline__ void row_recon(const int* srow, const unsigned* sw,
                                          const int* pr, unsigned* rw,
                                          int* s) {
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    const int4 t = reinterpret_cast<const int4*>(srow)[i];
    const int r[4] = {t.x, t.y, t.z, t.w};
    unsigned w = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w |= (unsigned)clamp255(px<kE>(pr, 4 * i + c) + r[c]) << (8 * c);
    rw[i] = w;
    ssimfx::add_sums4(sw[i], w, s);
  }
}

// kN u8 pixels packed in w to p: one vector store, or bytes where the row
// is not aligned for it
template <int kN, bool kVec>
__device__ __forceinline__ void store_u8(uint8_t* p, const unsigned* w) {
  if constexpr (kVec && kN == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (kVec) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      p[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
  }
}

// row_recon, then the recon row stored to rec
template <int kE, int kN, bool kVec>
__device__ __forceinline__ void row_out(const int* srow, const unsigned* sw,
                                        const int* pr, uint8_t* rec, int* s) {
  unsigned rw[4];
  row_recon<kE, kN>(srow, sw, pr, rw, s);
  store_u8<kN, kVec>(rec, rw);
}

template <class T>
__device__ __forceinline__ T sel3(bool luma, bool u, T y, T cu, T cv) {
  return luma ? y : u ? cu : cv;
}

// kPC: element size of the chroma prediction (1 or 4; luma's is 1);
// kVec: every plane's rows aligned for vector access
template <int kPC, bool kVec>
__global__ void __launch_bounds__(kPassWarps * 32, kVec ? 4 : 3)
    inter_pass_kernel(const PassArgs a) {
  __shared__ __align__(16) int s_all[kPassWarps][kWarpWords];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int m = blockIdx.x * kPassWarps + wid;
  if (m >= a.mbc) return;                               // the whole warp
  if (!a.first && a.cur_ssim[m] > a.ssim_target) {      // inactive MB
    if (lane == 0) a.active[m] = 0;
    return;
  }
  int* sm = s_all[wid];
  const int my = m / a.mbw, mx = m - my * a.mbw;
  const bool y2 = a.parts[m] == kAre16x16;

  // rows: this lane's row of its plane, in and residual out
  const bool luma = lane < 16, u = lane < 24;
  const int r = luma ? lane : lane & 7;
  const int row = luma ? 16 * my + r : 8 * my + r;
  const int col = luma ? 16 * mx : 8 * mx;
  const uint8_t* src = sel3(luma, u, a.src[0], a.src[1], a.src[2]) +
                       row * sel3(luma, u, a.src_rs[0], a.src_rs[1],
                                  a.src_rs[2]) + col;
  const int po = row * sel3(luma, u, a.pred_rs[0], a.pred_rs[1],
                            a.pred_rs[2]) + col;
  const void* pred = sel3(luma, u, a.pred[0], a.pred[1], a.pred[2]);
  uint8_t* rec = sel3(luma, u, a.rec[0], a.rec[1], a.rec[2]) +
                 row * sel3(luma, u, a.rec_rs[0], a.rec_rs[1], a.rec_rs[2]) +
                 col;
  int* srow = sm + (luma ? r * kLumaStride
                         : (u ? kU0 : kV0) + r * kChromaStride);
  unsigned sw[4];            // source row, packed bytes
  int pr[16];                // prediction row, packed bytes or int32
  if (luma)
    row_in<1, 16, kVec>(src, (const char*)pred + po, srow, sw, pr);
  else
    row_in<kPC, 8, kVec>(src, (const char*)pred + po * kPC, srow, sw, pr);
  __syncwarp();

  // blocks: lane b < 24 transforms block b of the MB
  int bb = 0, bs = 0;        // the block's first word and row stride
  if (luma) {
    bb = (lane >> 2) * 4 * kLumaStride + (lane & 3) * 4;
    bs = kLumaStride;
  } else if (u) {
    const int k = (lane - 16) & 3;
    bb = (lane < 20 ? kU0 : kV0) + (k >> 1) * 4 * kChromaStride + (k & 1) * 4;
    bs = kChromaStride;
  }
  int* y2s = sm + kY2;       // DCs [0, 16), levels [16, 32), dequantized
  int c[16];
  if (u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 t = reinterpret_cast<const int4*>(sm + bb + i * bs)[0];
      c[4 * i] = t.x; c[4 * i + 1] = t.y;
      c[4 * i + 2] = t.z; c[4 * i + 3] = t.w;
    }
    fdct4x4(c);
    if (luma) y2s[lane] = c[0];
    const int dc_q = luma ? (y2 ? 1 : a.q[0]) : a.q[4];
    const int ac_q = luma ? a.q[1] : a.q[5];
    const Div dc_d = luma ? (y2 ? Div{1, 0, 0} : a.div[0]) : a.div[4];
    const Div ac_d = luma ? a.div[1] : a.div[5];
    int lev[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int q = i == 0 ? dc_q : ac_q;
      lev[i] = quant_div(c[i], q, i == 0 ? dc_d : ac_d);
      c[i] = lev[i] * q;
    }
    unsigned z[8];           // zigzag levels, two int16 a word
#pragma unroll
    for (int j = 0; j < 8; ++j)
      z[j] = (unsigned)(uint16_t)lev[zig(2 * j)] |
             ((unsigned)(uint16_t)lev[zig(2 * j + 1)] << 16);
    if (luma && y2) z[0] &= 0xffff0000u;
    store16(a.levels + (m * 25 + lane) * 16, z);
  }
  __syncwarp();
  int y2_level = 0;          // Y2's zigzag level `lane` (lanes 0-15)
  if (y2) {                  // the same for the whole warp
    if (luma) {              // coefficient `lane` of the WHT
      int d[16];
      load16(y2s, d);
      fwht4x4(d);
      const int q = lane == 0 ? a.q[2] : a.q[3];
      const int l = quant_div(pick(d, lane), q, lane == 0 ? a.div[2]
                                                          : a.div[3]);
      y2s[16 + lane] = l;
      y2s[32 + lane] = l * q;
    }
    __syncwarp();
    if (luma) {              // DC `lane` of the inverse WHT
      int d[16];
      load16(y2s + 32, d);
      iwht4x4(d);
      c[0] = pick(d, lane);
      y2_level = y2s[16 + zig_rt(lane)];
    }
  }
  if (u) {
    idct4x4(c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<int4*>(sm + bb + i * bs)[0] =
          make_int4(c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]);
  }
  if (luma) a.levels[(m * 25 + 24) * 16 + lane] = (int16_t)y2_level;
  __syncwarp();

  // rows again: recon, its store, the SSIM sums; the MB's score
  int s[5] = {0, 0, 0, 0, 0};
  if (luma)
    row_out<1, 16, kVec>(srow, sw, pr, rec, s);
  else
    row_out<kPC, 8, kVec>(srow, sw, pr, rec, s);
  const int score = ssimfx::warp_mb_score(s, lane);
  if (lane == 0) {
    a.cur_ssim[m] = score;
    a.seg_ids[m] = a.sid;
    a.active[m] = 1;
  }
}

template <int kPC>
cudaError_t launch_pass(const PassArgs& a, bool vec, cudaStream_t st) {
  const unsigned grid = (unsigned)((a.mbc + kPassWarps - 1) / kPassWarps);
  if (vec)
    inter_pass_kernel<kPC, true><<<grid, kPassWarps * 32, 0, st>>>(a);
  else
    inter_pass_kernel<kPC, false><<<grid, kPassWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

struct MergeArgs {
  const uint8_t* y_src;       // (mbc, 16, 16) luma source patches
  const uint8_t* y_rec;       // (mbc, 16, 16) the luma trial's recon
  const int16_t* y_lev;       // (mbc, 16, 16) its zigzag levels
  const int8_t* y_modes;      // (mbc, 16) its modes
  const uint8_t* src[2];      // u, v source planes
  const uint8_t* rec[2];      // the frozen u, v recon planes
  const uint8_t* ghost[2];    // the row above each, null at the frame top
  int src_rs[2], rec_rs[2];   // row strides, elements
  const int* cur_in;          // (mbc,): read first
  int* cur_out;               // (mbc,): written; may be cur_in
  uint8_t* win;               // the merge state, (mbc, ...) each
  int* best_sid;
  int8_t* best_modes;
  int16_t* best_lev_y;
  int16_t* best_lev_c[2];
  uint8_t* best_rec_y;
  uint8_t* best_rec_c[2];
  int mbc, mbw, sid, ssim_target, dc_q, ac_q;
  Div dc_d, ac_d;
};

// The shared memory of a warp of trial_chroma_merge_kernel: the chroma
// residual rows at inter_pass_kernel's relative offsets (U, then V 8
// words past U's end), so that the same accesses meet in no bank; a
// transpose buffer of the 8 blocks, kTStride words apart, so that the 32
// lanes' column reads (lane 4b + i: words 20b + 4j + i) meet in no bank;
// the 8 blocks' zigzag levels (int16).
constexpr int kMergeV0 = kV0 - kU0;                    // 104
constexpr int kMergeT = kMergeV0 + 8 * kChromaStride;  // 200
constexpr int kTStride = 20;
constexpr int kMergeL = kMergeT + 8 * kTStride;        // 360
constexpr int kMergeWords = kMergeL + 64;

// kVec: the chroma planes' rows (and the ghost rows) aligned for 8-byte
// vector access
template <bool kVec>
__global__ void __launch_bounds__(kPassWarps * 32)
    trial_chroma_merge_kernel(const MergeArgs a) {
  __shared__ __align__(16) int s_all[kPassWarps][kMergeWords];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int m = blockIdx.x * kPassWarps + wid;
  if (m >= a.mbc) return;                               // the whole warp
  const int cur = a.cur_in[m];
  if (cur > a.ssim_target) {                            // inactive MB
    if (lane == 0) a.cur_out[m] = cur;
    return;
  }
  int* sm = s_all[wid];
  const int my = m / a.mbw, mx = m - my * a.mbw;
  const bool luma = lane < 16;
  const int p = (lane >> 3) & 1, r = lane & 7;          // chroma lanes
  int s[5] = {0, 0, 0, 0, 0};
  unsigned sw[4], rw[4];     // source row; recon row (both packed)
  int pr[2];                 // chroma prediction row, packed bytes
  int* srow = sm + (p ? kMergeV0 : 0) + r * kChromaStride;
  if (luma) {                // the luma trial's row against the source
    load_u8<16, true>(a.y_src + m * 256 + lane * 16, sw);
    load_u8<16, true>(a.y_rec + m * 256 + lane * 16, rw);
#pragma unroll
    for (int i = 0; i < 4; ++i) ssimfx::add_sums4(sw[i], rw[i], s);
  } else {                   // TM_PRED row r of plane p, its residual
    const uint8_t* rec = a.rec[p];
    const int rs = a.rec_rs[p], col = 8 * mx, row = 8 * my + r;
    load_u8<8, kVec>(a.src[p] + row * a.src_rs[p] + col, sw);
    // the row above the MB: the plane's, the ghost row's, or 127
    const uint8_t* above = my ? rec + (row - r - 1) * rs : a.ghost[p];
    unsigned at[2] = {0x7f7f7f7fu, 0x7f7f7f7fu};
    if (above) load_u8<8, kVec>(above + col, at);
    const int L = mx ? rec[row * rs + col - 1] : 129;
    const int P = !mx ? (my || above ? 129 : 127)
                      : above ? above[col - 1] : 127;
    int res[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      unsigned w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = clamp255((int)((at[i] >> (8 * j)) & 255u) + L - P);
        w |= (unsigned)v << (8 * j);
        res[4 * i + j] = (int)((sw[i] >> (8 * j)) & 255u) - v;
      }
      pr[i] = (int)w;
    }
    reinterpret_cast<int4*>(srow)[0] = make_int4(res[0], res[1], res[2],
                                                 res[3]);
    reinterpret_cast<int4*>(srow)[1] = make_int4(res[4], res[5], res[6],
                                                 res[7]);
  }
  __syncwarp();

  // blocks: lane 4b + i takes row i, then column i, of chroma block b
  // (U 0-3, V 4-7): each transform's first pass on rows or columns, the
  // second after a transpose through shared memory; the zigzag levels
  // wait in shared memory for the score
  {
    const int b = lane >> 2, i = lane & 3, k = b & 3;
    int* res = sm + (b < 4 ? 0 : kMergeV0) +
               ((k >> 1) * 4 + i) * kChromaStride + (k & 1) * 4;
    int* tb = sm + kMergeT + b * kTStride;
    int16_t* lv = reinterpret_cast<int16_t*>(sm + kMergeL) + 16 * b;
    int x[4], t[4];
    const int4 r = reinterpret_cast<const int4*>(res)[0];
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
    fdct_row(x, t);
    reinterpret_cast<int4*>(tb)[i] = make_int4(t[0], t[1], t[2], t[3]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = tb[4 * j + i];
    fdct_col(t, x);                // coefficients 4j + i
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool dc = j == 0 && i == 0;
      const int q = dc ? a.dc_q : a.ac_q;
      const int l = quant_div(x[j], q, dc ? a.dc_d : a.ac_d);
      lv[unzig_rt(4 * j + i)] = (int16_t)l;
      x[j] = l * q;
    }
    idct_col(x, t);
    __syncwarp();                  // every column read before the rewrite
#pragma unroll
    for (int j = 0; j < 4; ++j) tb[4 * j + i] = t[j];
    __syncwarp();
    const int4 u = reinterpret_cast<const int4*>(tb)[i];
    t[0] = u.x; t[1] = u.y; t[2] = u.z; t[3] = u.w;
    idct_row(t, x);
    reinterpret_cast<int4*>(res)[0] = make_int4(x[0], x[1], x[2], x[3]);
  }
  __syncwarp();

  // chroma rows again: the recon row and its sums; the MB's score
  if (!luma) row_recon<1, 8>(srow, sw, pr, rw, s);
  const int test = __shfl_sync(0xffffffffu, ssimfx::warp_mb_score(s, lane),
                               0);
  const bool better = test > cur;       // strictly: an earlier winner stays
  if (lane == 0) a.cur_out[m] = better ? test : cur;
  if (!better) return;                  // the whole warp

  // the winner's trial into the best buffers
  const int4* lev = reinterpret_cast<const int4*>(a.y_lev + m * 256);
  reinterpret_cast<int4*>(a.best_lev_y + m * 256)[lane] = lev[lane];
  if (luma) {
    store_u8<16, true>(a.best_rec_y + m * 256 + lane * 16, rw);
    reinterpret_cast<int4*>(a.best_lev_c[lane >> 3] + m * 64)[lane & 7] =
        reinterpret_cast<const int4*>(sm + kMergeL)[lane];
  } else {
    store_u8<8, true>(a.best_rec_c[p] + m * 64 + r * 8, rw);
  }
  if (lane == 0) {
    reinterpret_cast<int4*>(a.best_modes)[m] =
        reinterpret_cast<const int4*>(a.y_modes)[m];
    a.best_sid[m] = a.sid;
    a.win[m] = 1;
  }
}

}  // namespace

// planes: 9 operands (source y, u, v; prediction y, u, v; recon y, u, v)
// of 3 int64 each: pointer, element size (1, or 4 for a chroma prediction
// of int32; the two chroma predictions of one size), row stride in
// elements (unit column stride).  parts: (mbc,) int32; cur_ssim: (mbc,)
// int32, read (unless `first`) and written in place; levels (mbc, 25, 16)
// int16, seg_ids (mbc,) int32, active (mbc,) uint8.  The MBs of this pass
// (every MB when `first`, else those with cur_ssim <= ssim_target) get
// their levels, recon, segment id and three-plane Q15 score; active is
// written for every MB.
extern "C" int vp8_inter_pass(const long long* planes, void* parts,
                              void* cur_ssim, void* levels, void* seg_ids,
                              void* active, int mbc, int mbw, int sid,
                              int first, int ssim_target, int y_dc, int y_ac,
                              int y2_dc, int y2_ac, int uv_dc, int uv_ac,
                              void* stream) {
  if (mbc <= 0 || mbw <= 0 || mbc % mbw || cur_ssim == nullptr ||
      25LL * 16 * mbc >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long mbh = mbc / mbw;
  PassArgs a;
  bool vec = true;
  int pesz[3];
  for (int i = 0; i < 3; ++i) {
    const long long n = i == 0 ? 16 : 8;       // an MB's pixels a row
    for (int k = 0; k < 3; ++k) {              // source, prediction, recon
      const long long* d = planes + 3 * (3 * k + i);
      const long long esz = d[1], rs = d[2];
      if ((esz != 1 && !(k == 1 && i > 0 && esz == 4)) || rs < 0 ||
          (mbh * n - 1) * rs + mbw * n - 1 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
      const long long width = esz == 1 ? n : 16;   // bytes a vector load
      vec = vec && d[0] % width == 0 && (rs * esz) % width == 0;
    }
    a.src[i] = (const uint8_t*)(uintptr_t)planes[3 * i];
    a.src_rs[i] = (int)planes[3 * i + 2];
    a.pred[i] = (const void*)(uintptr_t)planes[3 * (3 + i)];
    pesz[i] = (int)planes[3 * (3 + i) + 1];
    a.pred_rs[i] = (int)planes[3 * (3 + i) + 2];
    a.rec[i] = (uint8_t*)(uintptr_t)planes[3 * (6 + i)];
    a.rec_rs[i] = (int)planes[3 * (6 + i) + 2];
  }
  if (pesz[1] != pesz[2]) return (int)cudaErrorInvalidValue;
  a.parts = (const int*)parts;
  a.cur_ssim = (int*)cur_ssim;
  a.levels = (int16_t*)levels;
  a.seg_ids = (int*)seg_ids;
  a.active = (uint8_t*)active;
  a.mbc = mbc;
  a.mbw = mbw;
  a.sid = sid;
  a.first = first;
  a.ssim_target = ssim_target;
  const int q[6] = {y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac};
  for (int i = 0; i < 6; ++i) {
    if (q[i] <= 0) return (int)cudaErrorInvalidValue;
    a.q[i] = q[i];
    a.div[i] = div_of(q[i]);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(pesz[1] == 1 ? launch_pass<1>(a, vec, st)
                            : launch_pass<4>(a, vec, st));
}

// ops: 25 int64: the luma source patches, the luma trial's recon, levels
// and modes (contiguous, 16-byte aligned: (mbc, 16, 16) u8, u8, int16,
// (mbc, 16) int8); the u and v source planes, each a pointer and its row
// stride; the frozen u and v recon planes, likewise (u8, unit column
// stride, (8 mbh, 8 mbw)); the ghost rows above u and v ((8 mbw,) u8, both
// null at the frame top); cur_in and cur_out ((mbc,) int32, may be one);
// the merge state, contiguous and 16-byte aligned: win (mbc,) u8, sid
// (mbc,) int32, modes (mbc, 16) int8, luma levels (mbc, 16, 16) int16, u
// and v levels (mbc, 4, 16) int16, luma recon (mbc, 16, 16) u8, u and v
// recon (mbc, 8, 8) u8.  One trial at segment `sid`'s chroma quantizers:
// every MB with cur_in <= ssim_target whose score beats it strictly gets
// cur_out = score, win = 1 and its trial in the best buffers; every other
// MB cur_out = cur_in and nothing else written.
extern "C" int vp8_trial_chroma_merge(const long long* ops, int mbc, int mbw,
                                      int sid, int ssim_target, int dc_q,
                                      int ac_q, void* stream) {
  if (mbc <= 0 || mbw <= 0 || mbc % mbw || dc_q <= 0 || ac_q <= 0 ||
      256LL * mbc >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long mbh = mbc / mbw;
  const auto ptr = [&](int i) { return (void*)(uintptr_t)ops[i]; };
  MergeArgs a;
  a.y_src = (const uint8_t*)ptr(0);
  a.y_rec = (const uint8_t*)ptr(1);
  a.y_lev = (const int16_t*)ptr(2);
  a.y_modes = (const int8_t*)ptr(3);
  bool vec = true;
  for (int i = 0; i < 2; ++i) {
    const long long s_rs = ops[5 + 2 * i], r_rs = ops[9 + 2 * i];
    for (const long long rs : {s_rs, r_rs})
      if (rs < 8 * mbw || (8 * mbh - 1) * rs + 8 * mbw - 1 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    a.src[i] = (const uint8_t*)ptr(4 + 2 * i);
    a.rec[i] = (const uint8_t*)ptr(8 + 2 * i);
    a.ghost[i] = (const uint8_t*)ptr(12 + i);
    a.src_rs[i] = (int)s_rs;
    a.rec_rs[i] = (int)r_rs;
    vec = vec && ops[4 + 2 * i] % 8 == 0 && s_rs % 8 == 0 &&
          ops[8 + 2 * i] % 8 == 0 && r_rs % 8 == 0 && ops[12 + i] % 8 == 0;
  }
  if ((a.ghost[0] == nullptr) != (a.ghost[1] == nullptr))
    return (int)cudaErrorInvalidValue;
  a.cur_in = (const int*)ptr(14);
  a.cur_out = (int*)ptr(15);
  a.win = (uint8_t*)ptr(16);
  a.best_sid = (int*)ptr(17);
  a.best_modes = (int8_t*)ptr(18);
  a.best_lev_y = (int16_t*)ptr(19);
  a.best_lev_c[0] = (int16_t*)ptr(20);
  a.best_lev_c[1] = (int16_t*)ptr(21);
  a.best_rec_y = (uint8_t*)ptr(22);
  a.best_rec_c[0] = (uint8_t*)ptr(23);
  a.best_rec_c[1] = (uint8_t*)ptr(24);
  for (const int i : {0, 1, 2, 3, 18, 19, 20, 21, 22, 23, 24})
    if (ops[i] % 16) return (int)cudaErrorInvalidValue;
  a.mbc = mbc;
  a.mbw = mbw;
  a.sid = sid;
  a.ssim_target = ssim_target;
  a.dc_q = dc_q;
  a.ac_q = ac_q;
  a.dc_d = div_of(dc_q);
  a.ac_d = div_of(ac_q);
  const unsigned grid = (unsigned)((mbc + kPassWarps - 1) / kPassWarps);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    trial_chroma_merge_kernel<true><<<grid, kPassWarps * 32, 0, st>>>(a);
  else
    trial_chroma_merge_kernel<false><<<grid, kPassWarps * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}
