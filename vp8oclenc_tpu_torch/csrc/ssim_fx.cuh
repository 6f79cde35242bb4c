// The integer (Q15) per-MB SSIM's arithmetic, shared by csrc/ssim.cu
// (mb_ssim_kernel) and csrc/transform.cu (inter_pass_kernel, which scores
// the MBs it codes), so that the two cannot drift apart.  The contract is
// ssim_fx.py's (ssim_fx_blocks): bit for bit, including the restoring
// division's a == d (32767) and va, vb, cv taken exactly in 64 bits and
// cast to int32.
//
// Both kernels map one warp to one MB by rows: lanes 0-15 hold luma rows
// 0-15, lanes 16-23 U rows 0-7 and lanes 24-31 V rows 0-7.  Each lane
// brings the five sums of its row (s1, s2, q1, q2, q12: source, recon,
// their squares and their product) to `warp_mb_score`.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace ssimfx {

// C1' (round(6.5025 n^2) >> 2p) and C2' (round(58.5225 n^2)) of
// ssim_fx.py for luma (n = 256, p = 2) and chroma (n = 64, p = 0)
constexpr int kC1Y = 26634, kC2Y = 3835331;
constexpr int kC1C = 26634, kC2C = 239708;

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

// Pixel j of a row held as packed bytes (kE 1: pixel j in byte j & 3 of
// v[j >> 2]) or as int32 values (kE 4), as both kernels hold their rows.
template <int kE>
__device__ __forceinline__ int px(const int* v, int j) {
  if constexpr (kE == 1)
    return (int)(((unsigned)v[j >> 2] >> (8 * (j & 3))) & 255u);
  else
    return v[j];
}

// The five sums of 4 pixel pairs packed as bytes, added to s.
__device__ __forceinline__ void add_sums4(unsigned x, unsigned y, int* s) {
  s[0] = (int)__dp4a(x, 0x01010101u, (unsigned)s[0]);
  s[1] = (int)__dp4a(y, 0x01010101u, (unsigned)s[1]);
  s[2] = (int)__dp4a(x, x, (unsigned)s[2]);
  s[3] = (int)__dp4a(y, y, (unsigned)s[3]);
  s[4] = (int)__dp4a(x, y, (unsigned)s[4]);
}

// The MB's three-plane score from every lane's row sums s (the mapping
// above).  Every lane of the warp calls it; lane 0 returns the score.
// The sums are reduced within each plane's group of lanes (16, 8, 8; no
// sum leaves int32: 256 * 255^2 < 2^31).  Each lane pair of a group then
// shares the plane's two divisions, L on the even lane and CS on the odd.
__device__ __forceinline__ int warp_mb_score(int* s, int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    const int hi = __shfl_xor_sync(0xffffffffu, s[k], 8);
    if (lane < 16) s[k] += hi;
  }
  const bool luma = lane < 16;
  const int n = luma ? 256 : 64;
  const int c1 = luma ? kC1Y : kC1C, c2 = luma ? kC2Y : kC2C;
  const int s1 = s[0], s2 = s[1];
  const int va = (int)((long long)n * s[2] - (long long)s1 * s1);
  const int vb = (int)((long long)n * s[3] - (long long)s2 * s2);
  const int cv = (int)((long long)n * s[4] - (long long)s1 * s2);
  const int p = luma ? 2 : 0;
  const int t1 = s1 >> p, t2 = s2 >> p;
  const int a1 = 2 * t1 * t2 + c1;
  const int d1 = t1 * t1 + t2 * t2 + c1;
  const int b1 = 2 * (cv >> 1) + (c2 >> 1);   // cv >> 1 floors, as torch's
  const int d2 = (va >> 1) + (vb >> 1) + (c2 >> 1);
  const bool neg = b1 < 0;
  const int b1a = min(neg ? -b1 : b1, d2);
  const int mine = divq15((lane & 1) ? b1a : a1, (lane & 1) ? d2 : d1);
  const int other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const int l_fx = (lane & 1) ? other : mine;
  const int cs_fx = (lane & 1) ? mine : other;
  int fx = (l_fx * cs_fx) >> 15;
  fx = neg ? -fx : fx;
  const int ds = abs(s1 - s2);
  const int pen = (ds * 655) >> (luma ? 8 : 6);
  const int score = fx - (ds > 4 * n ? pen : 0);
  return score + __shfl_sync(0xffffffffu, score, 16) +
         __shfl_sync(0xffffffffu, score, 24);
}

}  // namespace ssimfx
