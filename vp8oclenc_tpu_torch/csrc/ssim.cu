// Integer (Q15) per-MB SSIM for Hopper (sm_90a): the three-plane score of
// every MB in one launch.
//
// Replaces the JAX package's ssim_fx.py (`mb_ssim_fx`, `mb_ssim_fx_16x16`),
// which XLA compiles from elementwise ops (no Pallas kernel); the contract
// is that of ssim_fx.py:mb_ssim_fx_plain / mb_ssim_fx_16x16_plain in this
// package, bit for bit.  In plain PyTorch one call is ~780 elementwise
// launches (two 15-step restoring divisions over three planes); here it is
// one.
//
// What bounds it: bytes.  A 1080p call reads the u8 source and the int32
// recon planes once, ~15.7 MB, and writes 4 bytes an MB: ~4.7 us at
// 3.35 TB/s.  The operations, five multiply-adds a pixel pair and ~200 an
// MB for the scores, are a tenth of that at the card's integer rate.
//
// Design:
//   * One warp per MB, kWarps MBs a CTA; a warp past the last MB returns
//     as a whole, so the shuffles never wait on an absent lane.
//   * Luma is 256 pixel pairs, 8 a lane (lane r = lane/2 of the MB's rows,
//     8 columns); each chroma plane 64, 2 a lane.  The five sums
//     s1, s2, q1, q2, q12 of a plane fit int32 (256 * 255^2 < 2^31) and
//     are reduced with __shfl_xor_sync, so every lane holds all fifteen.
//   * Lane p < 3 scores plane p: va, vb, cv exactly in 64 bits and cast to
//     int32, the L and CS terms with C1' and C2', the sign of b1 and
//     min(|b1|, d2), the two 15-step restoring divisions (integer
//     arithmetic, as in the plain version, so a == d gives 32767), (l*cs)
//     >> 15, the DC penalty where |s1-s2| > 4n.  Lane 0 writes the sum of
//     the three.
//   * Strides, not copies.  Each operand is addressed as
//     my*s_my + mx*s_mx + R*s_r4 + r*s_r + C*s_c4 + c (pixel row 4R+r,
//     column 4C+c of MB (my, mx)), in u8 or int32, so whole planes and
//     per-MB patches of any strides are read where they lie.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // MBs a CTA
constexpr int kStrides = 6;     // s_my, s_mx, s_r4, s_r, s_c4, s_c

struct Operand {
  const void* p;
  long long s[kStrides];
  int esz;                      // 1: uint8, 4: int32
};

struct SsimArgs {
  Operand src[3], rec[3];       // Y, U, V
  int* out;
  int mbc, mbw;
  int c1[2], c2[2];             // luma, chroma: C1' (already >> 2p), C2'
};

__device__ __forceinline__ int load_px(const Operand& o, long long off) {
  return o.esz == 1 ? (int)((const uint8_t*)o.p)[off]
                    : ((const int*)o.p)[off];
}

// The five sums of this lane's share of an N x N block pair.
template <int N>
__device__ __forceinline__ void lane_sums(const Operand& a, const Operand& b,
                                          int my, int mx, int lane,
                                          int* sum) {
  constexpr int kPer = N * N / 32;          // pixels a lane: 8 or 2
  const int r = lane / (N / kPer);
  const int c0 = (lane % (N / kPer)) * kPer;
  const long long ba = my * a.s[0] + mx * a.s[1] + (r >> 2) * a.s[2] +
                       (r & 3) * a.s[3];
  const long long bb = my * b.s[0] + mx * b.s[1] + (r >> 2) * b.s[2] +
                       (r & 3) * b.s[3];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = c0 + j;
    const int x = load_px(a, ba + (c >> 2) * a.s[4] + (c & 3) * a.s[5]);
    const int y = load_px(b, bb + (c >> 2) * b.s[4] + (c & 3) * b.s[5]);
    sum[0] += x;
    sum[1] += y;
    sum[2] += x * x;
    sum[3] += y * y;
    sum[4] += x * y;
  }
}

// The plain version's 15-step restoring division, for 0 <= a <= d < 2^30:
// floor(a * 32768 / d) for a < d, 32767 for a == d.
__device__ __forceinline__ int divq15(int a, int d) {
  unsigned rem = (unsigned)a, q = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    rem <<= 1;
    const unsigned ge = rem >= (unsigned)d;
    rem -= ge ? (unsigned)d : 0u;
    q = (q << 1) | ge;
  }
  return (int)q;
}

// One plane's Q15 score from its five sums; n = 256 (luma) or 64.
__device__ __forceinline__ int plane_score(const int* s, int n, int c1,
                                           int c2) {
  const int s1 = s[0], s2 = s[1];
  const int va = (int)((long long)n * s[2] - (long long)s1 * s1);
  const int vb = (int)((long long)n * s[3] - (long long)s2 * s2);
  const int cv = (int)((long long)n * s[4] - (long long)s1 * s2);
  const int p = n == 256 ? 2 : 0;
  const int t1 = s1 >> p, t2 = s2 >> p;
  const int a1 = 2 * t1 * t2 + c1;
  const int d1 = t1 * t1 + t2 * t2 + c1;
  const int b1 = 2 * (cv >> 1) + (c2 >> 1);   // cv >> 1 floors, as torch's
  const int d2 = (va >> 1) + (vb >> 1) + (c2 >> 1);
  const int l_fx = divq15(a1, d1);
  const bool neg = b1 < 0;
  const int cs_fx = divq15(min(neg ? -b1 : b1, d2), d2);
  int fx = (l_fx * cs_fx) >> 15;
  fx = neg ? -fx : fx;
  const int ds = abs(s1 - s2);
  const int pen = (ds * 655) >> (n == 256 ? 8 : 6);
  return fx - (ds > 4 * n ? pen : 0);
}

__global__ void __launch_bounds__(kWarps * 32)
    mb_ssim_kernel(const SsimArgs args) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= args.mbc) return;                  // the whole warp
  const int my = m / args.mbw, mx = m - my * args.mbw;
  int sum[15] = {};
  lane_sums<16>(args.src[0], args.rec[0], my, mx, lane, sum);
  lane_sums<8>(args.src[1], args.rec[1], my, mx, lane, sum + 5);
  lane_sums<8>(args.src[2], args.rec[2], my, mx, lane, sum + 10);
#pragma unroll
  for (int k = 0; k < 15; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], o);
  }
  // lane p < 3 scores plane p; the other lanes' scores go unused
  const int p = lane < 3 ? lane : 0;
  int own[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    own[k] = p == 0 ? sum[k] : p == 1 ? sum[5 + k] : sum[10 + k];
  const int score = plane_score(own, p == 0 ? 256 : 64,
                                args.c1[p == 0 ? 0 : 1],
                                args.c2[p == 0 ? 0 : 1]);
  const int total = __shfl_sync(0xffffffffu, score, 0) +
                    __shfl_sync(0xffffffffu, score, 1) +
                    __shfl_sync(0xffffffffu, score, 2);
  if (lane == 0) args.out[m] = total;
}

}  // namespace

// ops: 6 operands (source Y, recon Y, source U, recon U, source V, recon V)
// of 8 int64 each: pointer, element size (1 or 4), then the strides in
// elements s_my, s_mx, s_r4, s_r, s_c4, s_c.  out: mbc int32, MB m at
// (m / mbw, m % mbw).  c1, c2: C1' and C2' of luma and of chroma.
extern "C" int vp8_mb_ssim(const long long* ops, void* out, int mbc, int mbw,
                           int c1_y, int c2_y, int c1_c, int c2_c,
                           void* stream) {
  if (mbc <= 0 || mbw <= 0) return (int)cudaErrorInvalidValue;
  SsimArgs a;
  for (int i = 0; i < 6; ++i) {
    const long long* d = ops + 8 * i;
    Operand& o = (i % 2 == 0 ? a.src : a.rec)[i / 2];
    o.p = (const void*)(uintptr_t)d[0];
    o.esz = (int)d[1];
    if (o.esz != 1 && o.esz != 4) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < kStrides; ++k) o.s[k] = d[2 + k];
  }
  a.out = (int*)out;
  a.mbc = mbc;
  a.mbw = mbw;
  a.c1[0] = c1_y;
  a.c2[0] = c2_y;
  a.c1[1] = c1_c;
  a.c2[1] = c2_c;
  mb_ssim_kernel<<<(mbc + kWarps - 1) / kWarps, kWarps * 32, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
