// The inter frame's transform passes and the SSIM controller's chroma
// trials for Hopper (sm_90a).
//
// Replaces XLA code of the JAX package (no Pallas kernel there), bit for
// bit against this package's plain versions:
//   * inter_pass_kernel: one segment pass of the inter frame over every MB,
//     the body of `seg_pass` (vp8oclenc_tpu/ops/inter.py:922) with
//     `transform_mb_luma` (:787) and `transform_mb_chroma` (:812), which
//     XLA fuses into the frame's program.  Contract:
//     ops/inter.py:inter_pass_plain.  In plain PyTorch one pass is ~600
//     launches; here it is one.
//   * trial_chroma_kernel: the TM_PRED chroma trial of both chroma planes,
//     `_trial_chroma` (vp8oclenc_tpu/ops/intra_replace.py:147).  Contract:
//     ops/intra_replace.py:trial_chroma_plain.  ~220 launches become one.
//
// What bounds them: bytes.  A 1080p pass reads the u8 source and the
// prediction planes once and writes the int16 levels (800 bytes an MB)
// and the u8 recon: ~20 MB, ~6 us at 3.35 TB/s.  The arithmetic, ~500
// integer operations a 4x4 block, is about half of that at the card's
// integer rate.
//
// Design (simple and right first):
//   * inter_pass_kernel: one warp an MB, kWarps MBs a CTA; a warp whose MB
//     is past the end, or inactive in this pass, returns as a whole.
//     Lanes 0-15 take the luma blocks (in-MB raster order), lanes 16-19
//     the U blocks and 20-23 the V blocks, all running the same code with
//     their own plane and quantizers; lanes 24-31 compute on zeros and
//     store nothing.  A 16x16 MB's 16 luma DCs meet in shared memory;
//     every lane runs the Y2 chain (fwht, quantize, dequantize, iwht) on
//     them, and luma lane b takes DC b back and Y2's zigzag level b.
//   * trial_chroma_kernel: one thread a 4x4 block, 8 a MB (U then V), no
//     communication.
//   * int32 throughout with the plain version's semantics: arithmetic
//     right shifts, q >> 1 rounding, division of non-negative values only;
//     products that could leave int32 wrap as torch's do (`mulw`).
//   * Operands are read through their strides (row strides for planes;
//     per-MB, row and column strides for patches), so views are read
//     where they lie.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // MBs a CTA of inter_pass_kernel
constexpr int kTrialThreads = 128;   // threads a CTA of trial_chroma_kernel
constexpr int kAre16x16 = 0;         // tables.ARE16X16
constexpr int kSin = 35468;          // tables.SINPI8SQRT2
constexpr int kCos = 20091;          // tables.COSPI8SQRT2MINUS1

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
  const uint8_t* pred[3];     // prediction planes, u8 or int32
  uint8_t* rec[3];            // recon planes (u8), written in place
  long long src_rs[3], pred_rs[3], rec_rs[3];   // row strides, elements
  int pred_esz[3];            // 1: uint8, 4: int32
  const int* parts;           // (mbc,)
  const int* cur_ssim;        // (mbc,), unread on the first pass
  int16_t* levels;            // (mbc, 25, 16): Y 0-15, U 16-19, V 20-23, Y2
  int* seg_ids;               // (mbc,)
  uint8_t* active;            // (mbc,)
  int mbc, mbw, sid, first, ssim_target;
  int q[6];                   // y_dc, y_ac, y2_dc, y2_ac, uv_dc, uv_ac
};

__device__ __forceinline__ int load_pred(const PassArgs& a, int p,
                                         long long off) {
  return a.pred_esz[p] == 1 ? (int)a.pred[p][off]
                            : ((const int*)a.pred[p])[off];
}

// 16 int16 values to 32 aligned bytes
__device__ __forceinline__ void store16(int16_t* dst, const int* v) {
  unsigned w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j] = (unsigned)(uint16_t)v[2 * j] |
           ((unsigned)(uint16_t)v[2 * j + 1] << 16);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(kWarps * 32)
    inter_pass_kernel(const PassArgs a) {
  __shared__ int s_dc[kWarps][16];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int m = blockIdx.x * kWarps + wid;
  if (m >= a.mbc) return;                               // the whole warp
  if (!a.first && a.cur_ssim[m] > a.ssim_target) {      // inactive MB
    if (lane == 0) a.active[m] = 0;
    return;
  }
  const int my = m / a.mbw, mx = m - my * a.mbw;
  const bool y2 = a.parts[m] == kAre16x16;
  const bool on = lane < 24;
  // this lane's block: plane, top-left pixel, quantizers, row of levels
  int p, row0, col0, dc_q, ac_q;
  if (lane < 16) {
    p = 0;
    row0 = my * 16 + (lane >> 2) * 4;
    col0 = mx * 16 + (lane & 3) * 4;
    dc_q = y2 ? 1 : a.q[0];
    ac_q = a.q[1];
  } else {
    const int k = (lane - 16) & 7;
    p = 1 + (k >> 2);
    row0 = my * 8 + ((k & 3) >> 1) * 4;
    col0 = mx * 8 + (k & 1) * 4;
    dc_q = a.q[4];
    ac_q = a.q[5];
  }
  int pred[16], c[16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int s = 0, pr = 0;
      if (on) {
        s = a.src[p][(row0 + r) * a.src_rs[p] + col0 + j];
        pr = load_pred(a, p, (row0 + r) * a.pred_rs[p] + col0 + j);
      }
      pred[4 * r + j] = pr;
      c[4 * r + j] = s - pr;
    }
  }
  fdct4x4(c);
  if (lane < 16) s_dc[wid][lane] = c[0];
  int lev[16], dq[16];
  quant_block(c, dc_q, ac_q, lev, dq);
  __syncwarp();
  int y2_level = 0;              // Y2's zigzag level `lane` (lanes 0-15)
  if (y2) {                      // the same for the whole warp
    int d[16], l2[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = s_dc[wid][i];
    fwht4x4(d);
    quant_block(d, a.q[2], a.q[3], l2, d);
    iwht4x4(d);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (lane == k) {
        dq[0] = d[k];
        y2_level = l2[zig(k)];
      }
    }
  }
  idct4x4(dq);
  if (on) {
    uint8_t* out = a.rec[p] + row0 * a.rec_rs[p] + col0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[r * a.rec_rs[p] + j] =
            (uint8_t)clamp255(pred[4 * r + j] + dq[4 * r + j]);
    int z[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) z[i] = lev[zig(i)];
    if (lane < 16 && y2) z[0] = 0;
    store16(a.levels + ((long long)m * 25 + lane) * 16, z);
  }
  if (lane < 16) a.levels[((long long)m * 25 + 24) * 16 + lane] =
      (int16_t)y2_level;
  if (lane == 0) {
    a.seg_ids[m] = a.sid;
    a.active[m] = 1;
  }
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
// of 3 int64 each: pointer, element size (1, or 4 for a prediction plane
// of int32), row stride in elements.  parts, cur_ssim: (mbc,) int32;
// levels (mbc, 25, 16) int16, seg_ids (mbc,) int32, active (mbc,) uint8,
// written for the MBs of this pass (every MB when `first`, else those
// with cur_ssim <= ssim_target); active is written for every MB.
extern "C" int vp8_inter_pass(const long long* planes, void* parts,
                              void* cur_ssim, void* levels, void* seg_ids,
                              void* active, int mbc, int mbw, int sid,
                              int first, int ssim_target, int y_dc, int y_ac,
                              int y2_dc, int y2_ac, int uv_dc, int uv_ac,
                              void* stream) {
  if (mbc <= 0 || mbw <= 0 || (!first && cur_ssim == nullptr))
    return (int)cudaErrorInvalidValue;
  PassArgs a;
  for (int i = 0; i < 3; ++i) {
    const long long* s = planes + 3 * i;
    const long long* pr = planes + 3 * (3 + i);
    const long long* rc = planes + 3 * (6 + i);
    if (s[1] != 1 || rc[1] != 1 || (pr[1] != 1 && pr[1] != 4))
      return (int)cudaErrorInvalidValue;
    a.src[i] = (const uint8_t*)(uintptr_t)s[0];
    a.src_rs[i] = s[2];
    a.pred[i] = (const uint8_t*)(uintptr_t)pr[0];
    a.pred_esz[i] = (int)pr[1];
    a.pred_rs[i] = pr[2];
    a.rec[i] = (uint8_t*)(uintptr_t)rc[0];
    a.rec_rs[i] = rc[2];
  }
  a.parts = (const int*)parts;
  a.cur_ssim = (const int*)cur_ssim;
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
  }
  inter_pass_kernel<<<(mbc + kWarps - 1) / kWarps, kWarps * 32, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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
