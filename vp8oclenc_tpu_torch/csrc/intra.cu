// Intra kernels for Hopper (sm_90a).  Keyframe wavefronts: luma 4x4 B_PRED
// and chroma TM_PRED, each one kernel launch per frame.  The SSIM
// controller's frozen-neighbour luma trial (`trial_luma_kernel`, further
// down, with its own note) shares their device functions.
//
// Replaces the JAX package's Pallas kernels `luma_wavefront`
// (ops/pallas_intra.py, _build_luma_call) and `chroma_wavefront`
// (ops/pallas_intra.py, _build_chroma_call); the contract is that of
// ops/intra.py:luma_wavefront_plain / chroma_wavefront_plain in this
// package, bit for bit.
//
// What bounds it: the dependency chain, not bytes or operations.  A luma
// block needs its left, above and above-right neighbours reconstructed, so
// the frame is D = (w4-1) + 2*(h4-1) + 1 sequential stages (1022 at
// 1920x1088) with at most h4 independent blocks per stage; chroma has
// D = mbw + mbh - 1 stages (187).  The whole frame moves ~6 MB and needs
// ~10^9 integer operations: microseconds of bandwidth or ALU time, against
// a stage chain whose each step costs a barrier plus a few dependent
// memory round trips.
//
// Design: one CTA walks all stages with __syncthreads() between them, so
// the reconstruction written in one stage is visible to the next without a
// second launch (global writes are visible inside the CTA after the
// barrier, not to other CTAs).  Luma: one thread per band of 4 pixel rows
// (h4 = 272 at 1080p; up to 512 threads, taller frames loop over bands),
// launched with a 128-register budget; each thread scores
// the 10 predictors with the exact separable integer cost, keeps the first
// minimum, and writes recon, zigzag levels and the mode straight into the
// output layout.  Chroma: one thread per (plane, MB row, 4x4 quadrant): the
// TM predictor of an MB reads only pixels outside the MB, so the 4
// quadrants are independent.  Recon lives in the output plane in device
// memory (L1-cached reads).  Everything is int32; no float anywhere.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Zigzag position of each raster coefficient (tables.INV_ZIGZAG): stores
// go to lz[kInvZigzag[i]] so the register array is indexed statically.
__constant__ int kInvZigzag[16] = {0, 1, 5, 6, 2, 4, 7, 12, 3, 8, 11, 13, 9,
                                   10, 14, 15};

__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}
__device__ __forceinline__ int avg2(int a, int b) { return (a + b + 1) >> 1; }
__device__ __forceinline__ int avg3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}

// One B_PRED predictor (RFC 6386 §12.3), mode order DC TM VE HE LD RD VR VL
// HD HU.  A[8] above incl. above-right, L[4] left, P above-left.
__device__ __forceinline__ void bpred(int m, const int* A, const int* L, int P,
                                      int* o) {
  switch (m) {
    case 0: {
      int dc = (A[0] + A[1] + A[2] + A[3] + L[0] + L[1] + L[2] + L[3] + 4) >> 3;
      for (int i = 0; i < 16; ++i) o[i] = dc;
      break;
    }
    case 1:
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[r * 4 + c] = clamp255(A[c] + L[r] - P);
      break;
    case 2: {
      int v0 = avg3(P, A[0], A[1]), v1 = avg3(A[0], A[1], A[2]);
      int v2 = avg3(A[1], A[2], A[3]), v3 = avg3(A[2], A[3], A[4]);
      for (int r = 0; r < 4; ++r) {
        o[r * 4 + 0] = v0; o[r * 4 + 1] = v1;
        o[r * 4 + 2] = v2; o[r * 4 + 3] = v3;
      }
      break;
    }
    case 3: {
      int h[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]),
                  avg3(L[1], L[2], L[3]), avg3(L[2], L[3], L[3])};
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[r * 4 + c] = h[r];
      break;
    }
    case 4: {  // LD: f(r + c)
      int f[7] = {avg3(A[0], A[1], A[2]), avg3(A[1], A[2], A[3]),
                  avg3(A[2], A[3], A[4]), avg3(A[3], A[4], A[5]),
                  avg3(A[4], A[5], A[6]), avg3(A[5], A[6], A[7]),
                  avg3(A[6], A[7], A[7])};
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[r * 4 + c] = f[r + c];
      break;
    }
    case 5: {  // RD: e(r - c), index r - c + 3
      int e[7] = {avg3(A[1], A[2], A[3]), avg3(A[0], A[1], A[2]),
                  avg3(P, A[0], A[1]),    avg3(L[0], P, A[0]),
                  avg3(L[1], L[0], P),    avg3(L[2], L[1], L[0]),
                  avg3(L[3], L[2], L[1])};
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) o[r * 4 + c] = e[r - c + 3];
      break;
    }
    case 6: {  // VR
      int c_ = avg3(L[2], L[1], L[0]), b_ = avg3(L[1], L[0], P);
      int a_ = avg3(L[0], P, A[0]);
      int v0 = avg2(P, A[0]), v1 = avg3(P, A[0], A[1]), v2 = avg2(A[0], A[1]);
      int v3 = avg3(A[0], A[1], A[2]), v4 = avg2(A[1], A[2]);
      int v5 = avg3(A[1], A[2], A[3]), v6 = avg2(A[2], A[3]);
      int t[16] = {v0, v2, v4, v6, a_, v1, v3, v5,
                   b_, v0, v2, v4, c_, a_, v1, v3};
      for (int i = 0; i < 16; ++i) o[i] = t[i];
      break;
    }
    case 7: {  // VL
      int v0 = avg2(A[0], A[1]), v1 = avg3(A[0], A[1], A[2]);
      int v2 = avg2(A[1], A[2]), v3 = avg3(A[1], A[2], A[3]);
      int v4 = avg2(A[2], A[3]), v5 = avg3(A[2], A[3], A[4]);
      int v6 = avg2(A[3], A[4]), v7 = avg3(A[3], A[4], A[5]);
      int v8 = avg3(A[4], A[5], A[6]), v9 = avg3(A[5], A[6], A[7]);
      int t[16] = {v0, v2, v4, v6, v1, v3, v5, v7,
                   v2, v4, v6, v8, v3, v5, v7, v9};
      for (int i = 0; i < 16; ++i) o[i] = t[i];
      break;
    }
    case 8: {  // HD
      int h0 = avg2(L[0], P), h1 = avg3(L[0], P, A[0]);
      int h2 = avg3(P, A[0], A[1]), h3 = avg3(A[0], A[1], A[2]);
      int h4 = avg2(L[1], L[0]), h5 = avg3(L[1], L[0], P);
      int h6 = avg2(L[2], L[1]), h7 = avg3(L[2], L[1], L[0]);
      int h8 = avg2(L[3], L[2]), h9 = avg3(L[3], L[2], L[1]);
      int t[16] = {h0, h1, h2, h3, h4, h5, h0, h1,
                   h6, h7, h4, h5, h8, h9, h6, h7};
      for (int i = 0; i < 16; ++i) o[i] = t[i];
      break;
    }
    default: {  // HU
      int u0 = avg2(L[0], L[1]), u1 = avg3(L[0], L[1], L[2]);
      int u2 = avg2(L[1], L[2]), u3 = avg3(L[1], L[2], L[3]);
      int u4 = avg2(L[2], L[3]), u5 = avg3(L[2], L[3], L[3]);
      int l3 = L[3];
      int t[16] = {u0, u1, u2, u3, u2, u3, u4, u5,
                   u4, u5, l3, l3, l3, l3, l3, l3};
      for (int i = 0; i < 16; ++i) o[i] = t[i];
      break;
    }
  }
}

// Rows of tables.COST_C applied to (x0, x1, x2, x3).
__device__ __forceinline__ void cost_c4(int x0, int x1, int x2, int x3,
                                        int* o) {
  int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
  o[0] = 8 * (s03 + s12);
  o[1] = 10 * d03 + 4 * d12;
  o[2] = 8 * (s03 - s12);
  o[3] = 4 * d03 - 10 * d12;
}

// Mode cost (ops/transforms.dct_weight): c = C4 . X . C4^T,
// (|c00| + 4 * sum|c_ac|) >> 9, exact in int32.
__device__ __forceinline__ int dct_weight(const int* x) {
  int t[16];
  for (int l = 0; l < 4; ++l) {
    int col[4];
    cost_c4(x[l], x[4 + l], x[8 + l], x[12 + l], col);
    for (int i = 0; i < 4; ++i) t[i * 4 + l] = col[i];
  }
  int s = 0, dc = 0;
  for (int i = 0; i < 4; ++i) {
    int row[4];
    cost_c4(t[i * 4], t[i * 4 + 1], t[i * 4 + 2], t[i * 4 + 3], row);
    for (int j = 0; j < 4; ++j) {
      int a = abs(row[j]);
      if (i == 0 && j == 0) dc = a;
      s += a;
    }
  }
  return (4 * s - 3 * dc) >> 9;
}

__device__ __forceinline__ void fdct4x4(const int* x, int* o) {
  int t[16];
  for (int r = 0; r < 4; ++r) {
    const int* p = x + r * 4;
    int a1 = (p[0] + p[3]) * 8, b1 = (p[1] + p[2]) * 8;
    int c1 = (p[1] - p[2]) * 8, d1 = (p[0] - p[3]) * 8;
    t[r * 4 + 0] = a1 + b1;
    t[r * 4 + 1] = (c1 * 2217 + d1 * 5352 + 14500) >> 12;
    t[r * 4 + 2] = a1 - b1;
    t[r * 4 + 3] = (d1 * 2217 - c1 * 5352 + 7500) >> 12;
  }
  for (int c = 0; c < 4; ++c) {
    int a1 = t[c] + t[12 + c], b1 = t[4 + c] + t[8 + c];
    int c1 = t[4 + c] - t[8 + c], d1 = t[c] - t[12 + c];
    o[c] = (a1 + b1 + 7) >> 4;
    o[4 + c] = ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0);
    o[8 + c] = (a1 - b1 + 7) >> 4;
    o[12 + c] = (d1 * 2217 - c1 * 5352 + 51000) >> 16;
  }
}

// Quantize (q/2 rounding toward zero; only non-negative values are
// divided) and dequantize in place: lev gets the levels, x the dequantized
// coefficients.
__device__ __forceinline__ void quant_dequant(int* x, int* lev, int dc_q,
                                              int ac_q) {
  for (int i = 0; i < 16; ++i) {
    int q = i == 0 ? dc_q : ac_q;
    int c = x[i];
    int a = c + (c < 0 ? -(q / 2) : q / 2);
    int l = a < 0 ? -((-a) / q) : a / q;
    lev[i] = l;
    x[i] = l * q;
  }
}

__device__ __forceinline__ void idct4x4(const int* ip, int* o) {
  const int s = 35468, cm1 = 20091;
  int t[16];
  for (int c = 0; c < 4; ++c) {
    int a1 = ip[c] + ip[8 + c], b1 = ip[c] - ip[8 + c];
    int c1 = ((ip[4 + c] * s) >> 16) - (ip[12 + c] + ((ip[12 + c] * cm1) >> 16));
    int d1 = (ip[4 + c] + ((ip[4 + c] * cm1) >> 16)) + ((ip[12 + c] * s) >> 16);
    t[c] = a1 + d1;
    t[4 + c] = b1 + c1;
    t[8 + c] = b1 - c1;
    t[12 + c] = a1 - d1;
  }
  for (int r = 0; r < 4; ++r) {
    const int* p = t + r * 4;
    int a1 = p[0] + p[2], b1 = p[0] - p[2];
    int c1 = ((p[1] * s) >> 16) - (p[3] + ((p[3] * cm1) >> 16));
    int d1 = (p[1] + ((p[1] * cm1) >> 16)) + ((p[3] * s) >> 16);
    o[r * 4 + 0] = (a1 + d1 + 4) >> 3;
    o[r * 4 + 1] = (b1 + c1 + 4) >> 3;
    o[r * 4 + 2] = (b1 - c1 + 4) >> 3;
    o[r * 4 + 3] = (a1 - d1 + 4) >> 3;
  }
}

// Residual -> levels (raster) and reconstructed pixels.
__device__ __forceinline__ void code_block(const int* res, const int* pred,
                                           int dc_q, int ac_q, int* lev,
                                           int* rec) {
  int co[16], rr[16];
  fdct4x4(res, co);
  quant_dequant(co, lev, dc_q, ac_q);
  idct4x4(co, rr);
  for (int i = 0; i < 16; ++i) rec[i] = clamp255(rr[i] + pred[i]);
}

// One B_PRED block from its source pixels and neighbours: the earliest of
// the 10 modes with the least cost, then the winner coded.  The mode loop
// stays rolled: unrolled, the ten predictors need 255 registers.  Returns
// the mode; lev gets the raster levels, out the reconstructed pixels.
__device__ __forceinline__ int search_and_code(const int* src, const int* A,
                                               const int* L, int P, int dc_q,
                                               int ac_q, int* lev, int* out) {
  int best = 0, best_cost = 0;
#pragma unroll 1
  for (int m = 0; m < 10; ++m) {
    int cand[16], res[16];
    bpred(m, A, L, P, cand);
    for (int i = 0; i < 16; ++i) res[i] = src[i] - cand[i];
    int cost = dct_weight(res);
    if (m == 0 || cost < best_cost) {  // first minimum
      best_cost = cost;
      best = m;
    }
  }
  int pred[16], res[16];
  bpred(best, A, L, P, pred);
  for (int i = 0; i < 16; ++i) res[i] = src[i] - pred[i];
  code_block(res, pred, dc_q, ac_q, lev, out);
  return best;
}

__device__ void luma_block(const uint8_t* __restrict__ y, uint8_t* rec,
                           int16_t* levels, int8_t* modes, int w4, int bx,
                           int by, int dc_q, int ac_q) {
  const int W = w4 * 4, x = bx * 4, yy = by * 4;
  int A[8], L[4], P;
  if (by == 0) {
    for (int j = 0; j < 8; ++j) A[j] = 127;
    P = 127;
  } else {
    const uint8_t* above = rec + (yy - 1) * W;
    for (int j = 0; j < 4; ++j) A[j] = above[x + j];
    if (bx % 4 < 3) {
      for (int j = 0; j < 4; ++j) A[4 + j] = above[x + 4 + j];
    } else {
      int mb_top = (by / 4) * 16;
      if (mb_top == 0) {
        for (int j = 0; j < 4; ++j) A[4 + j] = 127;
      } else if (bx == w4 - 1) {
        int e = rec[(mb_top - 1) * W + x + 3];
        for (int j = 0; j < 4; ++j) A[4 + j] = e;
      } else {
        for (int j = 0; j < 4; ++j) A[4 + j] = rec[(mb_top - 1) * W + x + 4 + j];
      }
    }
    P = bx == 0 ? 129 : above[x - 1];
  }
  for (int r = 0; r < 4; ++r) L[r] = bx == 0 ? 129 : rec[(yy + r) * W + x - 1];

  int src[16];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) src[r * 4 + c] = y[(yy + r) * W + x + c];

  int lev[16], out[16];
  const int best = search_and_code(src, A, L, P, dc_q, ac_q, lev, out);
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c)
      rec[(yy + r) * W + x + c] = (uint8_t)out[r * 4 + c];

  const int mb = (by / 4) * (w4 / 4) + bx / 4;
  const int sub = (by % 4) * 4 + bx % 4;
  int16_t* lz = levels + (mb * 16 + sub) * 16;
  for (int i = 0; i < 16; ++i) lz[kInvZigzag[i]] = (int16_t)lev[i];
  modes[mb * 16 + sub] = (int8_t)best;
}

constexpr int kLumaThreads = 512;   // register budget: 128 per thread

__global__ void __launch_bounds__(kLumaThreads)
    luma_wavefront_kernel(const uint8_t* __restrict__ y, uint8_t* rec,
                          int16_t* levels, int8_t* modes, int w4, int h4,
                          int dc_q, int ac_q) {
  const int D = (w4 - 1) + 2 * (h4 - 1) + 1;
  for (int d = 0; d < D; ++d) {
    for (int by = threadIdx.x; by < h4; by += blockDim.x) {
      int bx = d - 2 * by;
      if (bx >= 0 && bx < w4)
        luma_block(y, rec, levels, modes, w4, bx, by, dc_q, ac_q);
    }
    __syncthreads();
  }
}

// Thread = (plane, MB row, quadrant).  uv/rec: (2, mbh*8, mbw*8);
// levels: (2, mbc, 4, 16).
__global__ void __launch_bounds__(1024)
    chroma_wavefront_kernel(const uint8_t* __restrict__ uv, uint8_t* rec,
                            int16_t* levels, int mbw, int mbh, int dc_q,
                            int ac_q) {
  const int W2 = mbw * 8, plane_px = W2 * mbh * 8, mbc = mbw * mbh;
  const int D = mbw + mbh - 1;
  const int n = 2 * mbh * 4;
  for (int d = 0; d < D; ++d) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int q = t % 4, by = (t / 4) % mbh, p = t / (4 * mbh);
      const int bx = d - by;
      if (bx < 0 || bx >= mbw) continue;
      const uint8_t* s = uv + p * plane_px;
      uint8_t* r = rec + p * plane_px;
      const int x0 = bx * 8 + (q % 2) * 4, y0 = by * 8 + (q / 2) * 4;
      // TM_PRED of the whole MB restricted to this quadrant
      int top[4], left[4], tl;
      for (int j = 0; j < 4; ++j) {
        top[j] = by == 0 ? 127 : r[(by * 8 - 1) * W2 + x0 + j];
        left[j] = bx == 0 ? 129 : r[(y0 + j) * W2 + bx * 8 - 1];
      }
      tl = by == 0 ? 127
                   : (bx == 0 ? 129 : r[(by * 8 - 1) * W2 + bx * 8 - 1]);
      int pred[16], res[16], lev[16], out[16];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
          pred[i * 4 + j] = clamp255(top[j] + left[i] - tl);
          res[i * 4 + j] = s[(y0 + i) * W2 + x0 + j] - pred[i * 4 + j];
        }
      code_block(res, pred, dc_q, ac_q, lev, out);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
          r[(y0 + i) * W2 + x0 + j] = (uint8_t)out[i * 4 + j];
      int16_t* lz = levels + ((p * mbc + by * mbw + bx) * 4 + q) * 16;
      for (int i = 0; i < 16; ++i) lz[kInvZigzag[i]] = (int16_t)lev[i];
    }
    __syncthreads();
  }
}

// Frozen-neighbour luma trial of the SSIM controller: every MB re-coded as
// B_PRED at one quantizer pair, independent of every other MB.
//
// Replaces the JAX package's Pallas kernel `trial_luma`
// (ops/pallas_intra.py, _build_trial_luma_call); the contract is that of
// ops/intra_replace.py:trial_luma_plain in this package, bit for bit.
//
// What bounds it: operations (16 blocks x 10 predictors per MB, ~38k integer
// operations against ~1 KB moved per MB), and inside an MB the 16 blocks
// form a dependent chain.  Design: one thread per MB, 32 MBs per CTA, so
// 1080p is 255 CTAs spread over the SMs.  A block's neighbours outside the
// MB come from the frozen row `ftop` = [P, A0..A19] and column `fleft`,
// never from another MB's result; neighbours inside the MB come from the
// MB's own trial reconstruction, kept in shared memory with the 32 MBs'
// bytes of one pixel adjacent (no bank conflicts).  The border values are
// made by the caller.  Levels, modes and reconstruction go straight into
// their final layouts.
constexpr int kTrialThreads = 32;

__global__ void __launch_bounds__(kTrialThreads)
    trial_luma_kernel(const uint8_t* __restrict__ y_mb,
                      const uint8_t* __restrict__ ftop,
                      const uint8_t* __restrict__ fleft,
                      int16_t* __restrict__ levels, int8_t* __restrict__ modes,
                      uint8_t* __restrict__ rec, int mbc, int dc_q, int ac_q) {
  __shared__ uint8_t trial[256 * kTrialThreads];
  const int mb = blockIdx.x * kTrialThreads + threadIdx.x;
  if (mb >= mbc) return;
  uint8_t* mine = trial + threadIdx.x;        // pixel (r, c) at (r*16+c)*32
  const uint8_t* src_mb = y_mb + (size_t)mb * 256;
  const uint8_t* top = ftop + (size_t)mb * 21;
  const uint8_t* left = fleft + (size_t)mb * 16;
#pragma unroll 1
  for (int b = 0; b < 16; ++b) {
    const int r0 = (b >> 2) * 4, c0 = (b & 3) * 4;
    int A[8], L[4], P;
    if (r0 == 0) {
      for (int j = 0; j < 8; ++j) A[j] = top[1 + c0 + j];
      P = top[c0];
    } else {
      const uint8_t* above = mine + ((r0 - 1) * 16) * kTrialThreads;
      for (int j = 0; j < 4; ++j) A[j] = above[(c0 + j) * kTrialThreads];
      if (c0 < 12) {
        for (int j = 0; j < 4; ++j)
          A[4 + j] = above[(c0 + 4 + j) * kTrialThreads];
      } else {  // the row above the MB, as on a keyframe
        for (int j = 0; j < 4; ++j) A[4 + j] = top[17 + j];
      }
      P = c0 == 0 ? left[r0 - 1] : above[(c0 - 1) * kTrialThreads];
    }
    for (int r = 0; r < 4; ++r)
      L[r] = c0 == 0 ? left[r0 + r]
                     : mine[((r0 + r) * 16 + c0 - 1) * kTrialThreads];

    int src[16];
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) src[r * 4 + c] = src_mb[(r0 + r) * 16 + c0 + c];

    int lev[16], out[16];
    const int best = search_and_code(src, A, L, P, dc_q, ac_q, lev, out);
    uint8_t* rec_mb = rec + (size_t)mb * 256;
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) {
        mine[((r0 + r) * 16 + c0 + c) * kTrialThreads] = (uint8_t)out[r * 4 + c];
        rec_mb[(r0 + r) * 16 + c0 + c] = (uint8_t)out[r * 4 + c];
      }
    int16_t* lz = levels + ((size_t)mb * 16 + b) * 16;
    for (int i = 0; i < 16; ++i) lz[kInvZigzag[i]] = (int16_t)lev[i];
    modes[(size_t)mb * 16 + b] = (int8_t)best;
  }
}

int threads_for(int n, int most) {
  int t = (n + 31) / 32 * 32;
  return t > most ? most : t;
}

}  // namespace

extern "C" int vp8_luma_wavefront(const void* y, void* recon, void* levels,
                                  void* modes, int w4, int h4, int dc_q,
                                  int ac_q, void* stream) {
  luma_wavefront_kernel<<<1, threads_for(h4, kLumaThreads), 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)y, (uint8_t*)recon, (int16_t*)levels, (int8_t*)modes,
      w4, h4, dc_q, ac_q);
  return (int)cudaGetLastError();
}

extern "C" int vp8_chroma_wavefront(const void* uv, void* recon, void* levels,
                                    int mbw, int mbh, int dc_q, int ac_q,
                                    void* stream) {
  chroma_wavefront_kernel<<<1, threads_for(2 * mbh * 4, 1024), 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)uv, (uint8_t*)recon, (int16_t*)levels, mbw, mbh, dc_q,
      ac_q);
  return (int)cudaGetLastError();
}

extern "C" int vp8_trial_luma(const void* y_mb, const void* ftop,
                              const void* fleft, void* levels, void* modes,
                              void* rec, int mbc, int dc_q, int ac_q,
                              void* stream) {
  if (mbc <= 0) return (int)cudaErrorInvalidValue;
  trial_luma_kernel<<<(mbc + kTrialThreads - 1) / kTrialThreads,
                      kTrialThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y_mb, (const uint8_t*)ftop, (const uint8_t*)fleft,
      (int16_t*)levels, (int8_t*)modes, (uint8_t*)rec, mbc, dc_q, ac_q);
  return (int)cudaGetLastError();
}
