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
//   * trial_chroma_kernel: the TM_PRED chroma trial of both chroma planes,
//     `_trial_chroma` (vp8oclenc_tpu/ops/intra_replace.py:147).  Contract:
//     ops/intra_replace.py:trial_chroma_plain.  ~220 launches become one.
//
// What bounds them: bytes.  A 1080p pass reads the u8 source and the
// prediction planes once, cur_ssim and the partitionings, and writes the
// int16 levels (800 bytes an MB), the u8 recon, cur_ssim, the segment ids
// and `active`: ~19 MB, ~5.7 us at 3.35 TB/s.  The arithmetic, ~500
// integer operations a 4x4 block and ~150 an MB for the score, is about
// half of that at the card's integer rate.
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
//   * trial_chroma_kernel: one thread a 4x4 block, 8 a MB (U then V), no
//     communication.
//   * int32 throughout with the plain version's semantics: arithmetic
//     right shifts, q >> 1 rounding, division of non-negative values only;
//     products that could leave int32 wrap as torch's do (`mulw`).
//   * The pass addresses planes with 32-bit offsets (the launcher refuses
//     a plane whose last pixel lies 2^31 elements or more from its first,
//     and more than 2^31 level elements); the trial reads its patches
//     through per-MB, row and column strides.
#include <cstdint>
#include <cuda_runtime.h>

#include "ssim_fx.cuh"

namespace {

constexpr int kPassWarps = 8;        // MBs a CTA of inter_pass_kernel
constexpr int kTrialThreads = 128;   // threads a CTA of trial_chroma_kernel
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

// ops/transforms.py:fdct4x4 of x (raster 4x4), in place
__device__ __forceinline__ void fdct4x4(int* x) {
  int t[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int* p = x + 4 * r;
    const int a1 = (p[0] + p[3]) * 8, b1 = (p[1] + p[2]) * 8;
    const int c1 = (p[1] - p[2]) * 8, d1 = (p[0] - p[3]) * 8;
    t[4 * r + 0] = a1 + b1;
    t[4 * r + 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12;
    t[4 * r + 2] = a1 - b1;
    t[4 * r + 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a1 = t[c] + t[12 + c], b1 = t[4 + c] + t[8 + c];
    const int c1 = t[4 + c] - t[8 + c], d1 = t[c] - t[12 + c];
    x[c] = (a1 + b1 + 7) >> 4;
    x[4 + c] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0 ? 1 : 0);
    x[8 + c] = (a1 - b1 + 7) >> 4;
    x[12 + c] = (d1 * 2217 - c1 * 5352 + 51000) >> 16;
  }
}

// the odd half of the idct's butterfly: (c1, d1) of inputs i1, i3
__device__ __forceinline__ void idct_odd(int i1, int i3, int& c1, int& d1) {
  c1 = (mulw(i1, kSin) >> 16) - (i3 + (mulw(i3, kCos) >> 16));
  d1 = (i1 + (mulw(i1, kCos) >> 16)) + (mulw(i3, kSin) >> 16);
}

// ops/transforms.py:idct4x4 of x (raster 4x4), in place
__device__ __forceinline__ void idct4x4(int* x) {
  int t[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a1 = x[c] + x[8 + c], b1 = x[c] - x[8 + c];
    int c1, d1;
    idct_odd(x[4 + c], x[12 + c], c1, d1);
    t[c] = a1 + d1;
    t[4 + c] = b1 + c1;
    t[8 + c] = b1 - c1;
    t[12 + c] = a1 - d1;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int* p = t + 4 * r;
    const int a1 = p[0] + p[2], b1 = p[0] - p[2];
    int c1, d1;
    idct_odd(p[1], p[3], c1, d1);
    x[4 * r + 0] = (a1 + d1 + 4) >> 3;
    x[4 * r + 1] = (b1 + c1 + 4) >> 3;
    x[4 * r + 2] = (b1 - c1 + 4) >> 3;
    x[4 * r + 3] = (a1 - d1 + 4) >> 3;
  }
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

// ops/transforms.py:quant4x4 of one coefficient: q/2 rounding away from
// zero, then truncation; only non-negative values are divided
__device__ __forceinline__ int quant(int c, int q) {
  const int h = q >> 1;
  const int a = c + (c < 0 ? -h : h);
  return a < 0 ? -((-a) / q) : a / q;
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

// quant(c, q) with q's Div
__device__ __forceinline__ int quant_div(int c, int q, Div d) {
  const int h = q >> 1;
  const int a = c + (c < 0 ? -h : h);
  return a < 0 ? -(int)divu(0u - (unsigned)a, d) : (int)divu((unsigned)a, d);
}

// levels and dequantized coefficients (both raster) of coefficients c at
// (dc_q, ac_q); dq may be c itself
__device__ __forceinline__ void quant_block(const int* c, int dc_q, int ac_q,
                                            int* lev, int* dq) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q = i == 0 ? dc_q : ac_q;
    lev[i] = quant(c[i], q);
    dq[i] = lev[i] * q;
  }
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
// memory plus the prediction, clamped, stored as the recon row, and the
// row's five SSIM sums against the source added to s.
template <int kE, int kN, bool kVec>
__device__ __forceinline__ void row_out(const int* srow, const unsigned* sw,
                                        const int* pr, uint8_t* rec, int* s) {
  unsigned rw[4];
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
  if constexpr (kVec && kN == 16) {
    *reinterpret_cast<uint4*>(rec) = make_uint4(rw[0], rw[1], rw[2], rw[3]);
  } else if constexpr (kVec) {
    *reinterpret_cast<uint2*>(rec) = make_uint2(rw[0], rw[1]);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      rec[j] = (uint8_t)(rw[j >> 2] >> (8 * (j & 3)));
  }
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

struct TrialArgs {
  const uint8_t* src[2];      // (mbc, 8, 8) patches of U and V
  const uint8_t* top[2];      // (mbc, 8)
  const uint8_t* left[2];     // (mbc, 8)
  const uint8_t* tl[2];       // (mbc,)
  long long src_s[2][3], top_s[2][2], left_s[2][2], tl_s[2];
  int* levels;                // (2, mbc, 4, 16) zigzag
  int* rec;                   // (2, mbc, 8, 8)
  int mbc, dc_q, ac_q;
};

__global__ void __launch_bounds__(kTrialThreads)
    trial_chroma_kernel(const TrialArgs a) {
  const long long t = (long long)blockIdx.x * kTrialThreads + threadIdx.x;
  if (t >= 8LL * a.mbc) return;
  const int m = (int)(t >> 3), k = (int)(t & 7);
  const int p = k >> 2, b = k & 3, br = b >> 1, bc = b & 1;
  const int tl = a.tl[p][m * a.tl_s[p]];
  int pred[16], c[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int L = a.left[p][m * a.left_s[p][0] + (br * 4 + r) * a.left_s[p][1]];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int A = a.top[p][m * a.top_s[p][0] + (bc * 4 + j) * a.top_s[p][1]];
      const int pr = clamp255(A + L - tl);
      const int s = a.src[p][m * a.src_s[p][0] + (br * 4 + r) * a.src_s[p][1] +
                             (bc * 4 + j) * a.src_s[p][2]];
      pred[4 * r + j] = pr;
      c[4 * r + j] = s - pr;
    }
  }
  fdct4x4(c);
  int lev[16], dq[16];
  quant_block(c, a.dc_q, a.ac_q, lev, dq);
  idct4x4(dq);
  int* lz = a.levels + (((long long)p * a.mbc + m) * 4 + b) * 16;
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<int4*>(lz + i) = make_int4(
        lev[zig(i)], lev[zig(i + 1)], lev[zig(i + 2)], lev[zig(i + 3)]);
  int* rc = a.rec + ((long long)p * a.mbc + m) * 64 + br * 32 + bc * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<int4*>(rc + r * 8) = make_int4(
        clamp255(pred[4 * r] + dq[4 * r]),
        clamp255(pred[4 * r + 1] + dq[4 * r + 1]),
        clamp255(pred[4 * r + 2] + dq[4 * r + 2]),
        clamp255(pred[4 * r + 3] + dq[4 * r + 3]));
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

// ops: for U then V, 4 operands of 4 int64 each: the source patches
// (pointer, s_mb, s_row, s_col), top (pointer, s_mb, s_col, 0), left
// (pointer, s_mb, s_row, 0) and top-left (pointer, s_mb, 0, 0), all u8.
// levels: (2, mbc, 4, 16) int32, rec: (2, mbc, 8, 8) int32, contiguous.
extern "C" int vp8_trial_chroma(const long long* ops, void* levels, void* rec,
                                int mbc, int dc_q, int ac_q, void* stream) {
  if (mbc <= 0 || dc_q <= 0 || ac_q <= 0) return (int)cudaErrorInvalidValue;
  TrialArgs a;
  for (int p = 0; p < 2; ++p) {
    const long long* d = ops + 16 * p;
    a.src[p] = (const uint8_t*)(uintptr_t)d[0];
    for (int k = 0; k < 3; ++k) a.src_s[p][k] = d[1 + k];
    a.top[p] = (const uint8_t*)(uintptr_t)d[4];
    a.top_s[p][0] = d[5];
    a.top_s[p][1] = d[6];
    a.left[p] = (const uint8_t*)(uintptr_t)d[8];
    a.left_s[p][0] = d[9];
    a.left_s[p][1] = d[10];
    a.tl[p] = (const uint8_t*)(uintptr_t)d[12];
    a.tl_s[p] = d[13];
  }
  a.levels = (int*)levels;
  a.rec = (int*)rec;
  a.mbc = mbc;
  a.dc_q = dc_q;
  a.ac_q = ac_q;
  const long long threads = 8LL * mbc;
  trial_chroma_kernel<<<(unsigned)((threads + kTrialThreads - 1) /
                                    kTrialThreads),
                        kTrialThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
