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
// the frame is a chain of (w4-1) + 2*(h4-1) + 1 block steps (1022 at
// 1920x1088); a chroma MB needs its left and above neighbours, a chain of
// mbw + mbh - 1 MB steps (187).  The whole frame
// moves ~6 MB and needs ~10^9 integer operations: microseconds of
// bandwidth or ALU time.  What can be had is the chain at on-chip latency:
// steps x (one block's dependent work from shared memory and registers).
//
// Luma (`luma_rows_kernel`): one CTA per MB row, rows pipelined.
//   * Inside a CTA one warp per 4x4-block row; block (bx, by) runs once
//     (bx+1, by-1) is done (at the right edge: the row's last block), which
//     the warps tell each other through counters in shared memory.  A
//     block's source pixels and the pixel lines it predicts from are in
//     shared memory; its left neighbours are the warp's previous result, in
//     registers.
//   * The source is a ring of kLumaRing block columns (the row's 16 lines
//     of them), not the whole width: warp 3 trails warp 0 by 6 blocks, so
//     only a window of columns is ever live.  Warp 7 stages an MB's 16
//     source lines (16-byte loads) into the ring as soon as warp 3 has
//     released the columns they replace, up to the ring ahead of warp 0.
//     The pixel lines (the line above the MB row and each block row's
//     bottom line, 5 lines of w4+1 words) stay whole: 82 KB at 16384
//     pixels, within a CTA's shared memory at every VP8 width.
//   * A block is spread over the warp (`search_and_code_warp`): the
//     predictor values one a lane, the ten mode costs one a lane, the
//     earliest minimum by one warp reduction, the winner coded by every
//     lane alike.  Quantizing multiplies by a reciprocal (`Quant`): the
//     card has no integer divide.
//   * Across rows only the bottom pixel line of an MB row goes through
//     device memory.  Warp 5 writes it to the output plane as block row 3
//     produces it and publishes the count of finished blocks in the row's
//     counter (st.release, device scope); warp 4 of the row below polls
//     that counter (ld.acquire) and brings the line into shared memory
//     with __ldcg (L2, never a stale L1 line).  So the coding warps wait
//     on shared memory only, and the trips to L2 overlap their work.
//     Reconstruction, levels (zigzag, two 16-byte stores) and modes are
//     stored straight into the output layout behind the block's release.
//   * Forward progress: a CTA takes its MB row from an atomic ticket, not
//     from blockIdx, so row r only ever waits for row r-1, whose ticket
//     was drawn earlier by a CTA that is running already (or done); row 0
//     waits for nothing.  No co-residency is needed: 3840x2160 has 135 MB
//     rows on 132 SMs.  The counters and the ticket are scratch that the
//     caller hands in zeroed.  No barrier spans the frame.
//   * Dynamic shared memory is (16*kLumaRing + 5*(w4+1)) words, 13.7 KB at
//     1920 wide and 86 KB at 16384.  Staging the row's 16 source lines
//     across the whole width ((16*w4 + 5*(w4+1)) words) would not fit a
//     CTA above 11056 pixels.  PERF.md has the measurements on an NVIDIA
//     H100 80GB HBM3.
//
// Chroma (`chroma_rows_kernel`): the same row pipeline, one CTA per chroma
// MB row, rows drawn from an atomic ticket, both planes in one CTA.
//   * The wait rule.  TM_PRED of MB (bx, by) reads the bottom pixel line of
//     MB (bx, by-1) with the last pixel of (bx-1, by-1) as its corner, and
//     the right column of (bx-1, by).  Nothing above-right is read, so row
//     by may code MB bx as soon as row by-1 has finished MB bx itself: a lag
//     of one MB (luma needs two blocks).
//   * Per plane three warps.  The coding warp walks the row left to right;
//     the MB's four 4x4 quadrants, which depend only on pixels outside the
//     MB, are coded by four lanes at once (`code_block`, one quadrant a
//     lane).  Its pixels are in shared memory: the row's 8 source lines,
//     staged with 16-byte loads before the walk and overwritten in place
//     by the reconstruction, and the line above the row; the left column
//     is the previous step's result, passed between lanes by one shuffle.
//     The loading warp polls the row above's counter (ld.acquire) and
//     brings its bottom line in with __ldcg; the storing warp writes the
//     finished MBs' 8 lines out and publishes the count (st.release).  So
//     the coding warp waits on shared memory only.  Levels (zigzag, two
//     16-byte stores a quadrant) go straight to the output.
//   * One launch of 1920x1088 (960x544 chroma) is 68 CTAs; 3840x2160 has
//     135 rows on 132 SMs, which the ticket makes safe.
//   * ptxas (sm_90a, CUDA 12.8): 56 registers, no spills, 32 bytes of static
//     shared memory; dynamic 2 * (16*mbw + 2*mbw) words, 17 KB at 1920 wide.
//     On an NVIDIA H100 80GB HBM3 (700 W) a 1920x1088 frame takes 0.30 ms
//     (the one-CTA kernel it replaces: 1.49 ms), of which 0.14 ms is the
//     chain of 187 MB steps at 0.75 us; PERF.md has the measurements.
// Everything is int32; no float anywhere.
#include <cstdint>
#include <cuda_runtime.h>

#include "rowsync.cuh"

namespace {

using rowsync::post;
using rowsync::wait_above;

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

// A quantizer with the multiplier that divides by it: for 0 <= a < 2^32 / q,
// a / q == __umulhi(a, m) with m = floor(2^32 / q) + 1 (m * q exceeds 2^32
// by e <= q, and the error a * e / (q * 2^32) stays below 1 / q).  A level
// is at most 2^16 and q at most 2^8.  The hardware has no integer divide:
// `a / q` is ~25 dependent instructions, 16 times per block.
struct Quant {
  int q, half;
  unsigned m;
};

__device__ __forceinline__ Quant make_quant(int q) {
  Quant d;
  d.q = q;
  d.half = q / 2;
  d.m = q > 1 ? (unsigned)(0x100000000ULL / (unsigned)q) + 1u : 0u;
  return d;
}

__device__ __forceinline__ int div_quant(int a, const Quant& d) {
  return d.q > 1 ? (int)__umulhi((unsigned)a, d.m) : a;
}

// Quantize (q/2 rounding toward zero; only non-negative values are
// divided) and dequantize in place: lev gets the levels, x the dequantized
// coefficients.
__device__ __forceinline__ void quant_dequant(int* x, int* lev,
                                              const Quant& dc,
                                              const Quant& ac) {
  for (int i = 0; i < 16; ++i) {
    const Quant& d = i == 0 ? dc : ac;
    int c = x[i];
    int a = (c < 0 ? -c : c) + d.half;
    int l = div_quant(a, d);
    l = c < 0 ? -l : l;
    lev[i] = l;
    x[i] = l * d.q;
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
                                           const Quant& dc_q,
                                           const Quant& ac_q, int* lev,
                                           int* rec) {
  int co[16], rr[16];
  fdct4x4(res, co);
  quant_dequant(co, lev, dc_q, ac_q);
  idct4x4(co, rr);
  for (int i = 0; i < 16; ++i) rec[i] = clamp255(rr[i] + pred[i]);
}

// The ten B_PRED predictors, table-driven (`search_and_code_warp`,
// `trial_luma_kernel`).  With
// the edge E[0..12] = L3 L2 L1 L0 P A0..A7 (E[-1] = E[0], E[13] = E[12]),
// every predicted pixel of every mode is one of 43 values: F[i] =
// avg3(E[i-1], E[i], E[i+1]) at 0..12, G[i] = avg2(E[i], E[i+1]) at 13..24,
// L3 at 25, the DC value at 26 and the 16 TM pixels at 27..42.  Row m holds
// mode m's 16 indices into that array, one byte each, pixel 0 lowest; the
// plain versions' `bpred_all_modes` computes the same predictors.
constexpr int kPredVals = 43;
__constant__ uint32_t kPredTab[10][4] = {
    {0x1a1a1a1au, 0x1a1a1a1au, 0x1a1a1a1au, 0x1a1a1a1au},   // DC
    {0x1e1d1c1bu, 0x2221201fu, 0x26252423u, 0x2a292827u},   // TM
    {0x08070605u, 0x08070605u, 0x08070605u, 0x08070605u},   // VE
    {0x03030303u, 0x02020202u, 0x01010101u, 0x00000000u},   // HE
    {0x09080706u, 0x0a090807u, 0x0b0a0908u, 0x0c0b0a09u},   // LD
    {0x07060504u, 0x06050403u, 0x05040302u, 0x04030201u},   // RD
    {0x14131211u, 0x07060504u, 0x13121103u, 0x06050402u},   // VR
    {0x15141312u, 0x09080706u, 0x0a151413u, 0x0b090807u},   // VL
    {0x06050410u, 0x0410030fu, 0x030f020eu, 0x020e010du},   // HD
    {0x010e020fu, 0x000d010eu, 0x1919000du, 0x19191919u}};  // HU

// Byte k (0..15) of the 16 bytes w0 w1 w2 w3.
__device__ __forceinline__ int byte_of(uint32_t w0, uint32_t w1, uint32_t w2,
                                       uint32_t w3, int k) {
  return __byte_perm(k < 8 ? w0 : w2, k < 8 ? w1 : w3, k & 7) & 255;
}

// The 43 predictor values of one block into `vals` by 16 lanes, l = 0..15:
// F[l] (l < 13), G[l] (l < 12), TM pixel l, and L3 and the DC value (l =
// 13).  wl = L3 L2 L1 L0, a03 = A0..A3, a47 = A4..A7 as bytes, lowest
// first.
__device__ __forceinline__ void pred_values(int l, uint32_t wl, uint32_t a03,
                                            uint32_t a47, int P, int* vals) {
  const uint32_t w1 = (uint32_t)P | a03 << 8, w2 = a03 >> 24 | a47 << 8,
                 w3 = a47 >> 24;
  const int i = l < 12 ? l : 12;
  const int em = byte_of(wl, w1, w2, w3, i > 0 ? i - 1 : 0);
  const int e0 = byte_of(wl, w1, w2, w3, i);
  const int ep = byte_of(wl, w1, w2, w3, i < 12 ? i + 1 : 12);
  if (l < 13) vals[l] = avg3(em, e0, ep);
  if (l < 12) vals[13 + l] = avg2(e0, ep);
  vals[27 + l] = clamp255(byte_of(wl, w1, w2, w3, 5 + (l & 3)) +
                          byte_of(wl, w1, w2, w3, 3 - (l >> 2)) - P);
  if (l == 13) {
    vals[25] = wl & 255u;
    vals[26] = (__vsadu4(a03, 0u) + __vsadu4(wl, 0u) + 4) >> 3;
  }
}

// One B_PRED block by a whole warp.  Lanes 0..15 build the 43 predictor
// values in `vals` (shared memory); lanes 0..9 then gather one predictor
// each through `tab` (their row of kPredTab) and score it; the earliest
// minimum is one __reduce_min_sync over (cost << 4 | mode) (a cost is below
// 2^27); every lane then codes the winner, so that each holds the whole
// result and nothing has to be handed round.  The caller synchronises the
// warp before the next call (`vals` is reused).
__device__ __forceinline__ int search_and_code_warp(
    const int* src, uint32_t wl, uint32_t a03, uint32_t a47, int P,
    const Quant& dc_q, const Quant& ac_q, int lane, const uint32_t* tab,
    int* vals, int* lev, int* out) {
  if (lane < 16) pred_values(lane, wl, a03, a47, P, vals);
  __syncwarp();
  int pred[16], res[16];
  for (int i = 0; i < 16; ++i) {
    pred[i] = vals[(tab[i >> 2] >> (8 * (i & 3))) & 255u];
    res[i] = src[i] - pred[i];
  }
  const int cost = dct_weight(res);
  const int key = __reduce_min_sync(
      0xffffffffu, lane < 10 ? (cost << 4) | lane : 0x7fffffff);
  const int best = key & 15;
  uint32_t bt[4];
  for (int k = 0; k < 4; ++k) bt[k] = __shfl_sync(0xffffffffu, tab[k], best);
  for (int i = 0; i < 16; ++i) {
    pred[i] = vals[(bt[i >> 2] >> (8 * (i & 3))) & 255u];
    res[i] = src[i] - pred[i];
  }
  code_block(res, pred, dc_q, ac_q, lev, out);
  return best;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)a | (uint32_t)b << 8 | (uint32_t)c << 16 | (uint32_t)d << 24;
}

__device__ __forceinline__ void unpack4(uint32_t w, int* p) {
  p[0] = w & 255u; p[1] = (w >> 8) & 255u;
  p[2] = (w >> 16) & 255u; p[3] = w >> 24;
}

// Warps 0..3 code the four 4x4-block rows of an MB row; warp 4 fetches the
// pixel line above the MB row from the row above's output; warp 5 writes
// the row's own bottom pixel line out and publishes it to the row below;
// warp 7 stages the source, on the SM sub-partition (warp index modulo 4)
// of coding warp 3 rather than of warp 2, and backs off between polls;
// warp 6 has no work.
constexpr int kRowThreads = 256;
// Block columns of source in the ring: a power of two, at least 16 (warp
// 0 may need column bx+1 staged while warp 3, 6 blocks behind, holds
// column bx-6, and the ring takes whole MBs).
constexpr int kLumaRing = 64;
static_assert(kLumaRing >= 16 && (kLumaRing & (kLumaRing - 1)) == 0,
              "the luma source ring");
constexpr unsigned kStageBackoffNs = 256;

// Dynamic shared memory of a luma_rows_kernel CTA: the source ring, then
// 5 pixel lines of w4+1 words.
__host__ __device__ constexpr int luma_smem(int w4) {
  return (16 * kLumaRing + 5 * (w4 + 1)) * 4;
}

// One CTA per MB row; warp w < 4 walks block row by = 4*row + w left to
// right.  Shared memory: the source ring, 16 lines of KB words (block
// column bx's word of line l at l*KB + bx % KB), then 5 lines of w4+1
// words: line 0 is the pixel line above the MB row (127s in the top row;
// its last word replicates the frame's last pixel, the VP8 rule for the
// above-right of the last block column), line k+1 the bottom pixel line
// of block row k; then each warp's predictor values.  s_prog[k] counts
// the words of line k that are final; s_prog[4] also frees the ring's
// columns.  s_staged counts the block columns in the ring.  sync: mbh
// progress counters and the row ticket, all 0 at launch.  KB: kLumaRing.
__global__ void __launch_bounds__(kRowThreads)
    luma_rows_kernel(const uint8_t* __restrict__ y, uint8_t* rec,
                     int16_t* levels, int8_t* modes, int* sync, int w4,
                     int mbh, int dc, int ac) {
  const Quant dc_q = make_quant(dc), ac_q = make_quant(ac);
  extern __shared__ uint4 smem[];
  __shared__ int s_row;
  __shared__ int s_prog[5];
  __shared__ int s_staged;
  __shared__ int s_vals[4][kPredVals];
  if (threadIdx.x == 0) s_row = atomicAdd(sync + mbh, 1);
  __syncthreads();
  const int r = s_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int KB = kLumaRing, mask = KB - 1;
  const int W = w4 * 4, lp = w4 + 1;
  uint32_t* src = reinterpret_cast<uint32_t*>(smem);          // 16 x KB
  uint32_t* ln = src + 16 * KB;                               // 5 x lp
  if (r == 0)
    for (int i = threadIdx.x; i < lp; i += kRowThreads) ln[i] = 0x7f7f7f7fu;
  if (threadIdx.x < 5)
    s_prog[threadIdx.x] = threadIdx.x == 0 && r == 0 ? w4 : 0;
  if (threadIdx.x == 5) s_staged = 0;
  __syncthreads();

  if (warp == 6) return;
  if (warp == 7) {
    // The source, 2 MBs (8 block columns, a load per lane) at a time: MB
    // m's columns go into the ring once warp 3 has released the columns
    // KB before them.
    const uint4* g = reinterpret_cast<const uint4*>(y + (size_t)r * 16 * W);
    int have = 0;                             // block columns staged
    while (have < w4) {
      int freed = 0;
      if (lane == 0)
        while ((freed = *(const volatile int*)(s_prog + 4)) <= have + 3 - KB)
          __nanosleep(kStageBackoffNs);
      freed = __shfl_sync(0xffffffffu, freed, 0);
      __syncwarp();
      const int room = min(min(w4, (freed + KB) & ~3), have + 8);
      const int n = (room - have) / 4;        // MBs
      if (lane < 16 * n) {
        const int l = lane / n, c = have + 4 * (lane % n);
        reinterpret_cast<uint4*>(src + l * KB + (c & mask))[0] =
            __ldg(g + (size_t)l * (W / 16) + c / 4);
      }
      post<false>(&s_staged, room, lane);
      have = room;
    }
    return;
  }

  if (warp == 4) {
    // The row above's bottom line into line 0, as far as that row has
    // come: off the coding warps' chain, which only ever wait on shared
    // memory.  Read from L2 (__ldcg) behind the acquire, never from L1.
    if (r == 0) return;
    const uint32_t* g_above =
        reinterpret_cast<const uint32_t*>(rec + (size_t)(16 * r - 1) * W);
    int have = 0;
    while (have < w4) {
      const int seen = wait_above<true>(sync + r - 1, have, lane);
      for (int i = have + lane; i < seen; i += 32) ln[i] = __ldcg(g_above + i);
      __syncwarp();
      if (seen == w4 && lane == 0) ln[w4] = (ln[w4 - 1] >> 24) * 0x01010101u;
      post<false>(s_prog, seen, lane);
      have = seen;
    }
    return;
  }
  if (warp == 5) {
    // The bottom pixel line, as far as block row 3 has come, to the output
    // plane, and then the count of its final words to the row below
    // (st.release at device scope; the other lanes' stores are ordered
    // before it by __syncwarp).  The store's way to L2 is this warp's wait,
    // not a coding warp's.
    uint32_t* g_bot =
        reinterpret_cast<uint32_t*>(rec + (size_t)(16 * r + 15) * W);
    const uint32_t* bot = ln + 4 * lp;
    int have = 0;
    while (have < w4) {
      const int seen = wait_above<false>(s_prog + 4, have, lane);
      for (int i = have + lane; i < seen; i += 32) g_bot[i] = bot[i];
      if (r + 1 < mbh) post<true>(sync + r, seen, lane);
      have = seen;
    }
    return;
  }

  const int by = 4 * r + warp;
  const uint32_t* up = ln + warp * lp;        // the line above my block row
  uint32_t* mine = ln + (warp + 1) * lp;      // my block row's bottom line
  uint32_t* g_rec = reinterpret_cast<uint32_t*>(rec + (size_t)by * 4 * W);
  const uint32_t* tab = kPredTab[lane < 10 ? lane : 0];
  const uint32_t tb[4] = {tab[0], tab[1], tab[2], tab[3]};
  int seen = 0;                               // s_prog[warp], as last read
  int staged = 0;                             // s_staged, as last read
  uint32_t wl = 0x81818181u;                  // left of the frame: 129
  for (int bx = 0; bx < w4; ++bx) {
    // block (bx, by) needs (bx+1, by-1): the above-right neighbour
    const int need = bx + 2 < w4 ? bx + 2 : w4;
    if (seen < need) seen = wait_above<false>(s_prog + warp, need - 1, lane);
    if (staged <= bx) staged = wait_above<false>(&s_staged, bx, lane);
    const uint32_t a03 = up[bx];
    const uint32_t a47 = (bx & 3) < 3 || warp == 0 ? up[bx + 1] : ln[bx + 1];
    const int P = by == 0 ? 127 : (bx == 0 ? 129 : (int)(up[bx - 1] >> 24));
    int s[16];
    for (int k = 0; k < 4; ++k)
      unpack4(src[(4 * warp + k) * KB + (bx & mask)], s + 4 * k);

    int lev[16], out[16];
    const int best = search_and_code_warp(s, wl, a03, a47, P, dc_q, ac_q, lane,
                                          tb, s_vals[warp], lev, out);
    wl = pack4(out[15], out[11], out[7], out[3]);
    // release the block: its bottom line to the warp below or, from the
    // last block row, to warp 5, through shared memory
    const uint32_t w0 = pack4(out[0], out[1], out[2], out[3]),
                   w1 = pack4(out[4], out[5], out[6], out[7]),
                   w2 = pack4(out[8], out[9], out[10], out[11]),
                   w3 = pack4(out[12], out[13], out[14], out[15]);
    if (lane == 0) mine[bx] = w3;
    if (lane < 4 && (lane > 0 || warp < 3))   // warp 5 stores the MB's last
      g_rec[(lane == 0 ? 3 : lane - 1) * w4 + bx] =
          lane == 0 ? w3 : (lane == 1 ? w0 : (lane == 2 ? w1 : w2));
    post<false>(s_prog + warp + 1, bx + 1, lane);
    // behind the release: levels (zigzag) and the mode
    const int sub = warp * 4 + (bx & 3);
    const size_t blk = ((size_t)r * (w4 / 4) + bx / 4) * 16 + sub;
    if (lane < 2) {
      constexpr int zz[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                              14, 15};        // raster index of zigzag pos
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h[i] = (uint32_t)(uint16_t)(int16_t)lev[zz[2 * i]] |
               (uint32_t)(uint16_t)(int16_t)lev[zz[2 * i + 1]] << 16;
      uint4 v = lane == 0 ? make_uint4(h[0], h[1], h[2], h[3])
                          : make_uint4(h[4], h[5], h[6], h[7]);
      reinterpret_cast<uint4*>(levels + blk * 16)[lane] = v;
    }
    if (lane == 2) modes[blk] = (int8_t)best;
  }
}

// Per plane: warp p codes, warp 2 + p fetches the line above the MB row,
// warp 4 + p writes the row out and publishes it to the row below.
constexpr int kChromaThreads = 192;

// Words of shared memory a plane takes: 8 lines of 2*mbw words, then the
// line above, padded so that the next plane starts on 16 bytes.
__host__ __device__ constexpr int chroma_plane_words(int mbw) {
  return 16 * mbw + (2 * mbw + 3) / 4 * 4;
}

// One CTA per chroma MB row.  uv/rec: (2, mbh*8, mbw*8); levels: (2, mbc, 4,
// 16) zigzag.  s_prog[p][0] counts the MBs of the line above that are in
// shared memory, s_prog[p][1] the MBs of this row that are coded.  sync:
// 2*mbh progress counters (plane-major) and the row ticket, all 0 at launch.
__global__ void __launch_bounds__(kChromaThreads)
    chroma_rows_kernel(const uint8_t* __restrict__ uv, uint8_t* rec,
                       int16_t* levels, int* sync, int mbw, int mbh, int dc,
                       int ac) {
  const Quant dc_q = make_quant(dc), ac_q = make_quant(ac);
  extern __shared__ uint4 smem[];
  __shared__ int s_row;
  __shared__ int s_prog[2][2];
  if (threadIdx.x == 0) s_row = atomicAdd(sync + 2 * mbh, 1);
  __syncthreads();
  const int r = s_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w2 = 2 * mbw;                         // words in a pixel line
  const size_t plane_px = (size_t)mbw * 8 * mbh * 8;
  const int pw = chroma_plane_words(mbw);
  for (int p = 0; p < 2; ++p) {
    const uint4* g = reinterpret_cast<const uint4*>(
        uv + p * plane_px + (size_t)r * 8 * mbw * 8);
    uint4* dst = smem + p * (pw / 4);
    for (int i = threadIdx.x; i < 4 * mbw; i += kChromaThreads)
      dst[i] = __ldg(g + i);
    if (r == 0) {
      uint32_t* above = reinterpret_cast<uint32_t*>(dst) + 8 * w2;
      for (int i = threadIdx.x; i < w2; i += kChromaThreads)
        above[i] = 0x7f7f7f7fu;
    }
  }
  if (threadIdx.x < 4)
    s_prog[threadIdx.x >> 1][threadIdx.x & 1] =
        (threadIdx.x & 1) == 0 && r == 0 ? mbw : 0;
  __syncthreads();

  const int p = warp < 2 ? warp : (warp < 4 ? warp - 2 : warp - 4);
  uint32_t* px = reinterpret_cast<uint32_t*>(smem) + p * pw;   // 8 x w2
  uint32_t* above = px + 8 * w2;
  int* counter = sync + p * mbh;                  // this plane's rows

  if (warp >= 2 && warp < 4) {
    // The row above's bottom line, as far as that row has come.  Read from
    // L2 (__ldcg) behind the acquire, never from L1.
    if (r == 0) return;
    const uint32_t* g_above = reinterpret_cast<const uint32_t*>(
        rec + p * plane_px + (size_t)(8 * r - 1) * mbw * 8);
    int have = 0;
    while (have < mbw) {
      const int seen = wait_above<true>(counter + r - 1, have, lane);
      for (int i = 2 * have + lane; i < 2 * seen; i += 32)
        above[i] = __ldcg(g_above + i);
      post<false>(&s_prog[p][0], seen, lane);
      have = seen;
    }
    return;
  }
  if (warp >= 4) {
    // The finished MBs' 8 lines to the output plane, 8 bytes a lane, then
    // their count to the row below (st.release at device scope; the other
    // lanes' stores are ordered before it by __syncwarp).
    uint2* g_row = reinterpret_cast<uint2*>(
        rec + p * plane_px + (size_t)r * 8 * mbw * 8);
    const uint2* rows = reinterpret_cast<const uint2*>(px);
    int have = 0;
    while (have < mbw) {
      const int seen = wait_above<false>(&s_prog[p][1], have, lane);
      for (int i = lane; i < 8 * (seen - have); i += 32) {
        const int at = (i & 7) * mbw + have + (i >> 3);
        g_row[at] = rows[at];
      }
      if (r + 1 < mbh) post<true>(counter + r, seen, lane);
      have = seen;
    }
    return;
  }

  // Lane q < 4 codes quadrant q of each MB; the lanes above repeat them
  // and store nothing.
  const int q = lane & 3, qy = q >> 1, qx = q & 1;
  const size_t mb0 = (size_t)p * mbw * mbh + (size_t)r * mbw;
  int seen = r == 0 ? mbw : 0;                    // s_prog[p][0], as last read
  uint32_t wl = 0x81818181u;                      // left of the frame: 129
  for (int bx = 0; bx < mbw; ++bx) {
    if (seen <= bx) seen = wait_above<false>(&s_prog[p][0], bx, lane);
    int top[4], left[4];
    unpack4(above[2 * bx + qx], top);
    unpack4(wl, left);
    const int tl =
        r == 0 ? 127 : (bx == 0 ? 129 : (int)(above[2 * bx - 1] >> 24));
    uint32_t* mine = px + 4 * qy * w2 + 2 * bx + qx;
    int pred[16], res[16], lev[16], out[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int s[4];
      unpack4(mine[i * w2], s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pred[i * 4 + j] = clamp255(top[j] + left[i] - tl);
        res[i * 4 + j] = s[j] - pred[i * 4 + j];
      }
    }
    code_block(res, pred, dc_q, ac_q, lev, out);
    // the next MB's left column: the right column of the quadrant beside
    // or under this lane's, rows as this lane's
    wl = __shfl_sync(0xffffffffu, pack4(out[3], out[7], out[11], out[15]),
                     lane | 1);
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[i * w2] = pack4(out[4 * i], out[4 * i + 1], out[4 * i + 2],
                             out[4 * i + 3]);
    }
    post<false>(&s_prog[p][1], bx + 1, lane);
    // behind the release: the levels, zigzag
    if (lane < 4) {
      constexpr int zz[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                              14, 15};            // raster index of zigzag pos
      uint32_t h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h[i] = (uint32_t)(uint16_t)(int16_t)lev[zz[2 * i]] |
               (uint32_t)(uint16_t)(int16_t)lev[zz[2 * i + 1]] << 16;
      uint4* lz = reinterpret_cast<uint4*>(levels + ((mb0 + bx) * 4 + q) * 16);
      lz[0] = make_uint4(h[0], h[1], h[2], h[3]);
      lz[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
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
// form a dependent chain.  Design: a block is spread over the 16 lanes of a
// half-warp, and each half-warp walks its own MB's 16 blocks in raster
// order: two MBs a warp, 8 warps a CTA (4080 warps at 1080p).
//   * Why not the in-MB wavefront.  Block (bx, by) needs its left, above,
//     above-left and, for bx < 3, above-right neighbours, so an MB could run
//     as the 10 steps d = bx + 2*by with the two blocks of steps 2..7 on the
//     two half-warps.  That design ran first: its steps 0, 1, 8 and 9 hold
//     one block, so one half of the warp idles through 4 of 10 steps, and
//     the kernel is bound by issue slots, not by its chains.  A warp of two
//     MBs issues 16 steps where two wavefront warps issue 20: 0.040 ms a
//     launch where the wavefront took 0.053 at 1080p (PERF.md).
//   * A half-warp builds the 43 predictor values (`pred_values`); its lanes
//     0..9 score one mode each through kPredTab; two full-warp
//     __reduce_min_sync over (cost << 4 | mode) give each half its earliest
//     minimum; then lane l codes pixel (l >> 2, l & 3): the forward and
//     inverse transforms run one coefficient a lane, a pass reading its row
//     or column through four shuffles inside the half, and the quantizer
//     divides by `Quant`.
//   * Shared memory holds each MB: its 256 source bytes (16-byte loads) and
//     an edge array in which every pixel a block predicts from sits at
//     E[r * 32 + c]: the frozen row above (r = -1: P, A0..A19), the frozen
//     column left (c = -1), the trial reconstruction (0..15), and
//     ftop[17:21] at columns 16..19 of rows 3, 7, 11 (a row's columns 16..19
//     are the next row's unused bytes), so every block reads its A0..A7 as
//     two words and L and P as bytes, with no case for the MB's border.
//     Levels go out a coefficient a lane in zigzag order (one 32-byte
//     sector a block), the reconstruction as 16 16-byte stores.
// The launcher needs y_mb and rec 16-byte aligned.
constexpr int kTrialWarps = 8;              // warps (2 MBs each) per CTA
constexpr int kEdgeBytes = 18 * 32;         // rows -1..15 and the spill row

__global__ void __launch_bounds__(kTrialWarps * 32)
    trial_luma_kernel(const uint8_t* __restrict__ y_mb,
                      const uint8_t* __restrict__ ftop,
                      const uint8_t* __restrict__ fleft,
                      int16_t* __restrict__ levels, int8_t* __restrict__ modes,
                      uint8_t* __restrict__ rec, int mbc, int dc, int ac) {
  __shared__ uint32_t s_tab[10][4];
  __shared__ __align__(16) uint8_t s_edge[kTrialWarps][2][kEdgeBytes];
  __shared__ __align__(16) uint8_t s_src[kTrialWarps][2][256];
  __shared__ int s_vals[kTrialWarps][2][48];
  if (threadIdx.x < 40)
    s_tab[threadIdx.x >> 2][threadIdx.x & 3] =
        kPredTab[threadIdx.x >> 2][threadIdx.x & 3];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = lane >> 4, l = lane & 15, pr = l >> 2, pc = l & 3;
  const int mb0 = 2 * (blockIdx.x * kTrialWarps + warp);
  if (mb0 >= mbc) return;                // whole warps: no barrier follows
  const int mb = min(mb0 + h, mbc - 1);  // past the end: the last MB again
  const int base = lane & 16;            // first lane of my half
  uint8_t* E = s_edge[warp][h] + 48;     // pixel (r, c) at E[r * 32 + c]
  const uint8_t* src = s_src[warp][h];
  int* vals = s_vals[warp][h];
  {
    const uint8_t* t = ftop + (size_t)mb * 21;
    E[-33 + l] = t[l];                               // row -1: P, A0..A19
    if (l < 5) E[-33 + 16 + l] = t[16 + l];
    if (l < 12) E[(3 + 4 * (l >> 2)) * 32 + 16 + (l & 3)] =
        t[17 + (l & 3)];                             // rows 3, 7, 11
    E[l * 32 - 1] = fleft[(size_t)mb * 16 + l];
    reinterpret_cast<uint4*>(s_src[warp][h])[l] =
        __ldg(reinterpret_cast<const uint4*>(y_mb + (size_t)mb * 256) + l);
  }
  __syncwarp();
  const int m = l < 10 ? l : 9;          // the mode this lane scores
  const uint32_t tab[4] = {s_tab[m][0], s_tab[m][1], s_tab[m][2],
                           s_tab[m][3]};
  const int zz = kInvZigzag[l];
  const Quant q = l == 0 ? make_quant(dc) : make_quant(ac);
  constexpr int s35 = 35468, cm1 = 20091;
#pragma unroll 1
  for (int blk = 0; blk < 16; ++blk) {
    const int r0 = (blk >> 2) * 4, c0 = (blk & 3) * 4;
    const uint8_t* e = E + (r0 - 1) * 32 + c0;        // A0 of the block
    const uint32_t a03 = *reinterpret_cast<const uint32_t*>(e);
    const uint32_t a47 = *reinterpret_cast<const uint32_t*>(e + 4);
    const int P = e[-1];
    const uint32_t wl = (uint32_t)e[32 * 4 - 1] |          // L3 L2 L1 L0
                        (uint32_t)e[32 * 3 - 1] << 8 |
                        (uint32_t)e[32 * 2 - 1] << 16 | (uint32_t)e[31] << 24;
    pred_values(l, wl, a03, a47, P, vals);
    __syncwarp();

    // lanes 0..9 of each half: the cost of mode l
    int key;
    {
      int res[16];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(src + (r0 + r) * 16 + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          res[r * 4 + c] = (int)((w >> (8 * c)) & 255u) -
                           vals[(tab[r] >> (8 * c)) & 255u];
      }
      const int cost = dct_weight(res);
      key = l < 10 ? (cost << 4) | l : 0x7fffffff;
    }
    const int k0 = __reduce_min_sync(0xffffffffu, h ? 0x7fffffff : key);
    const int k1 = __reduce_min_sync(0xffffffffu, h ? key : 0x7fffffff);
    const int best = (h ? k1 : k0) & 15;

    // lane l codes pixel (pr, pc) of the winner
    const int pp = vals[(s_tab[best][pr] >> (8 * pc)) & 255u];
    const int x = (int)src[(r0 + pr) * 16 + c0 + pc] - pp;
    int v[4];
    // fdct4x4, rows
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __shfl_sync(0xffffffffu, x, base + 4 * pr + k);
    int t;
    {
      const int a1 = (v[0] + v[3]) * 8, b1 = (v[1] + v[2]) * 8;
      const int c1 = (v[1] - v[2]) * 8, d1 = (v[0] - v[3]) * 8;
      t = pc == 0 ? a1 + b1
        : pc == 2 ? a1 - b1
        : pc == 1 ? (c1 * 2217 + d1 * 5352 + 14500) >> 12
                  : (d1 * 2217 - c1 * 5352 + 7500) >> 12;
    }
    // fdct4x4, columns
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __shfl_sync(0xffffffffu, t, base + 4 * k + pc);
    int co;
    {
      const int a1 = v[0] + v[3], b1 = v[1] + v[2];
      const int c1 = v[1] - v[2], d1 = v[0] - v[3];
      co = pr == 0 ? (a1 + b1 + 7) >> 4
         : pr == 2 ? (a1 - b1 + 7) >> 4
         : pr == 1 ? ((c1 * 2217 + d1 * 5352 + 12000) >> 16) + (d1 != 0)
                   : (d1 * 2217 - c1 * 5352 + 51000) >> 16;
    }
    // quantize (q/2 rounding toward zero) and dequantize coefficient l
    int lv = div_quant((co < 0 ? -co : co) + q.half, q);
    lv = co < 0 ? -lv : lv;
    const int dq = lv * q.q;
    // idct4x4, columns
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __shfl_sync(0xffffffffu, dq, base + 4 * k + pc);
    {
      const int a1 = v[0] + v[2], b1 = v[0] - v[2];
      const int c1 = ((v[1] * s35) >> 16) - (v[3] + ((v[3] * cm1) >> 16));
      const int d1 = (v[1] + ((v[1] * cm1) >> 16)) + ((v[3] * s35) >> 16);
      t = pr == 0 ? a1 + d1 : pr == 1 ? b1 + c1 : pr == 2 ? b1 - c1 : a1 - d1;
    }
    // idct4x4, rows
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __shfl_sync(0xffffffffu, t, base + 4 * pr + k);
    int o;
    {
      const int a1 = v[0] + v[2], b1 = v[0] - v[2];
      const int c1 = ((v[1] * s35) >> 16) - (v[3] + ((v[3] * cm1) >> 16));
      const int d1 = (v[1] + ((v[1] * cm1) >> 16)) + ((v[3] * s35) >> 16);
      o = pc == 0 ? a1 + d1 : pc == 1 ? b1 + c1 : pc == 2 ? b1 - c1 : a1 - d1;
      o = (o + 4) >> 3;
    }
    E[(r0 + pr) * 32 + c0 + pc] = (uint8_t)clamp255(o + pp);
    levels[((size_t)mb * 16 + blk) * 16 + zz] = (int16_t)lv;
    if (l == 0) modes[(size_t)mb * 16 + blk] = (int8_t)best;
    __syncwarp();
  }
  reinterpret_cast<uint4*>(rec + (size_t)mb * 256)[l] =
      *reinterpret_cast<const uint4*>(E + l * 32);
}

}  // namespace

// Dynamic shared memory of one luma_rows_kernel CTA for a luma plane
// `width` pixels wide: the source ring and 5 lines of one word more than
// the width.
extern "C" int vp8_luma_smem(int width) {
  return luma_smem(width / 4);
}

// Dynamic shared memory of one chroma_rows_kernel CTA for chroma planes
// `width` pixels wide.
extern "C" int vp8_chroma_smem(int width) {
  return 2 * chroma_plane_words(width / 8) * 4;
}

extern "C" int vp8_luma_wavefront(const void* y, void* recon, void* levels,
                                  void* modes, void* sync, int w4, int h4,
                                  int dc_q, int ac_q, void* stream) {
  if (w4 <= 0 || w4 % 4 || h4 <= 0 || h4 % 4)
    return (int)cudaErrorInvalidValue;
  const int smem = luma_smem(w4);
  cudaError_t e = cudaFuncSetAttribute(
      luma_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();      // the next launch reports only its own error
    return (int)e;
  }
  luma_rows_kernel<<<h4 / 4, kRowThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (uint8_t*)recon, (int16_t*)levels, (int8_t*)modes,
      (int*)sync, w4, h4 / 4, dc_q, ac_q);
  return (int)cudaGetLastError();
}

extern "C" int vp8_chroma_wavefront(const void* uv, void* recon, void* levels,
                                    void* sync, int mbw, int mbh, int dc_q,
                                    int ac_q, void* stream) {
  const int smem = vp8_chroma_smem(8 * mbw);
  cudaError_t e = cudaFuncSetAttribute(
      chroma_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  chroma_rows_kernel<<<mbh, kChromaThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)uv, (uint8_t*)recon, (int16_t*)levels, (int*)sync, mbw,
      mbh, dc_q, ac_q);
  return (int)cudaGetLastError();
}

extern "C" int vp8_trial_luma(const void* y_mb, const void* ftop,
                              const void* fleft, void* levels, void* modes,
                              void* rec, int mbc, int dc_q, int ac_q,
                              void* stream) {
  if (mbc <= 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)y_mb % 16 || (uintptr_t)rec % 16)
    return (int)cudaErrorMisalignedAddress;
  trial_luma_kernel<<<(mbc + 2 * kTrialWarps - 1) / (2 * kTrialWarps),
                      kTrialWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y_mb, (const uint8_t*)ftop, (const uint8_t*)fleft,
      (int16_t*)levels, (int8_t*)modes, (uint8_t*)rec, mbc, dc_q, ac_q);
  return (int)cudaGetLastError();
}
