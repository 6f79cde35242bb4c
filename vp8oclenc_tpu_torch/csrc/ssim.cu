// Integer (Q15) per-MB SSIM for Hopper (sm_90a): the three-plane score of
// every MB in one launch.
//
// Replaces the JAX package's ssim_fx.py (`mb_ssim_fx`, `mb_ssim_fx_16x16`),
// which XLA compiles from elementwise ops (no Pallas kernel); the contract
// is that of ssim_fx.py:mb_ssim_fx_plain / mb_ssim_fx_16x16_plain in this
// package, bit for bit.  In plain PyTorch one call is ~780 elementwise
// launches (two 15-step restoring divisions over three planes); here it is
// one.  The inter frame's segment passes score their own MBs
// (csrc/transform.cu); this kernel serves the SSIM controller's trials
// and every other caller.
//
// What bounds it: bytes.  The trials hand it u8 source patches, the u8
// luma trial's recon and the int32 chroma trial's: 1152 bytes an MB, 9.4
// MB at 1080p, ~2.8 us at 3.35 TB/s; whole planes with an int32 recon are
// 15.7 MB.  The operations, five multiply-adds a pixel pair and ~150 an MB
// for the scores, are a few tenths of that at the card's integer rate.
//
// Design:
//   * One warp an MB, kWarps MBs a CTA; a warp past the last MB returns as
//     a whole.  Lanes map to rows as csrc/ssim_fx.cuh says (0-15 luma,
//     16-23 U, 24-31 V); each lane loads its source and recon row and
//     takes their five sums, `ssimfx::warp_mb_score` reduces and scores.
//   * Element sizes at compile time: the launcher instantiates the kernel
//     for the operand forms its callers pass (the trials' u8 luma pair and
//     u8/int32 chroma pairs, u8 planes, u8 planes against int32 recon
//     planes) and a form whose sizes are read once a row for any other
//     mix.  As the score is symmetric in its two blocks, each plane's pair
//     is ordered smaller element first.  No branch per pixel.
//   * Vector path: where every operand's columns are unit stride (s_c ==
//     1, s_c4 == 4) and its pointer and row strides are aligned to the
//     load, a row is one 16-byte load (luma u8), one 8-byte load (chroma
//     u8) or 16-byte loads of 4 int32.  Strided path, for any other view:
//     a load a pixel through the six strides.  The launcher picks.
//   * Strides, not copies: pixel row 4R+r, column 4C+c of MB (my, mx)
//     lies at my*s_my + mx*s_mx + R*s_r4 + r*s_r + C*s_c4 + c*s_c, in
//     32-bit offsets (the launcher refuses an operand whose last pixel
//     lies 2^31 elements or more from its first).
#include <cstdint>
#include <cuda_runtime.h>

#include "ssim_fx.cuh"

namespace {

constexpr int kWarps = 8;       // MBs a CTA
constexpr int kStrides = 6;     // s_my, s_mx, s_r4, s_r, s_c4, s_c

struct Operand {
  const void* p;
  int s[kStrides];
  int esz;                      // 1: uint8, 4: int32
};

struct SsimArgs {
  Operand src[3], rec[3];       // Y, U, V; each pair smaller element first
  int* out;
  int mbc, mbw;
};

// One lane's row of one operand: its first pixel and its column strides.
struct Row {
  const void* p;
  int off, s_c4, s_c, esz;
};

__device__ __forceinline__ Row row_of(const Operand& o, int my, int mx,
                                      int r) {
  return {o.p, my * o.s[0] + mx * o.s[1] + (r >> 2) * o.s[2] +
                   (r & 3) * o.s[3],
          o.s[4], o.s[5], o.esz};
}

// kN pixels of a row: kE 1, packed bytes (pixel j in byte j & 3 of
// v[j >> 2]); kE 4, int32 values.
template <int kE, int kN, bool kVec>
__device__ __forceinline__ void load_row(const Row& w, int (&v)[16]) {
  if constexpr (kE == 1) {
    const uint8_t* p = (const uint8_t*)w.p + w.off;
    if constexpr (kVec && kN == 16) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      v[0] = (int)t.x; v[1] = (int)t.y; v[2] = (int)t.z; v[3] = (int)t.w;
    } else if constexpr (kVec) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      v[0] = (int)t.x; v[1] = (int)t.y;
    } else {
#pragma unroll
      for (int i = 0; i < kN / 4; ++i) {
        const uint8_t* q = p + i * w.s_c4;
        v[i] = (int)((unsigned)q[0] | (unsigned)q[w.s_c] << 8 |
                     (unsigned)q[2 * w.s_c] << 16 |
                     (unsigned)q[3 * w.s_c] << 24);
      }
    }
  } else {
    const int* p = (const int*)w.p + w.off;
#pragma unroll
    for (int i = 0; i < kN / 4; ++i) {
      if constexpr (kVec) {
        const int4 t = *reinterpret_cast<const int4*>(p + 4 * i);
        v[4 * i] = t.x; v[4 * i + 1] = t.y;
        v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[4 * i + c] = p[i * w.s_c4 + c * w.s_c];
      }
    }
  }
}

using ssimfx::px;

// kN int32 values of a row whose element size is read here, once a row
template <int kN, bool kVec>
__device__ __forceinline__ void load_values(const Row& w, int (&v)[16]) {
  if (w.esz == 1) {
    int b[16];
    load_row<1, kN, kVec>(w, b);
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = px<1>(b, j);
  } else {
    load_row<4, kN, kVec>(w, v);
  }
}

// The five sums of a row pair of element sizes kA, kB (0: read at run
// time), added to s.
template <int kA, int kB, int kN, bool kVec>
__device__ __forceinline__ void row_sums(const Row& ra, const Row& rb,
                                         int* s) {
  int a[16], b[16];
  if constexpr (kA == 0) {
    load_values<kN, kVec>(ra, a);
    load_values<kN, kVec>(rb, b);
  } else {
    load_row<kA, kN, kVec>(ra, a);
    load_row<kB, kN, kVec>(rb, b);
  }
  if constexpr (kA == 1 && kB == 1) {
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      ssimfx::add_sums4((unsigned)a[i], (unsigned)b[i], s);
  } else {
    constexpr int kEa = kA == 0 ? 4 : kA, kEb = kB == 0 ? 4 : kB;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int x = px<kEa>(a, j), y = px<kEb>(b, j);
      s[0] += x;
      s[1] += y;
      s[2] += x * x;
      s[3] += y * y;
      s[4] += x * y;
    }
  }
}

// kSY, kRY: element sizes of the luma pair; kSC, kRC: of both chroma
// pairs (0 for all four: read at run time)
template <int kSY, int kRY, int kSC, int kRC, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    mb_ssim_kernel(const SsimArgs a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= a.mbc) return;                     // the whole warp
  const int my = m / a.mbw, mx = m - my * a.mbw;
  int s[5] = {0, 0, 0, 0, 0};
  if (lane < 16) {
    row_sums<kSY, kRY, 16, kVec>(row_of(a.src[0], my, mx, lane),
                                 row_of(a.rec[0], my, mx, lane), s);
  } else {
    const int r = lane & 7;
    const bool u = lane < 24;
    const Row rs = u ? row_of(a.src[1], my, mx, r)
                     : row_of(a.src[2], my, mx, r);
    const Row rr = u ? row_of(a.rec[1], my, mx, r)
                     : row_of(a.rec[2], my, mx, r);
    row_sums<kSC, kRC, 8, kVec>(rs, rr, s);
  }
  const int score = ssimfx::warp_mb_score(s, lane);
  if (lane == 0) a.out[m] = score;
}

template <int kSY, int kRY, int kSC, int kRC>
cudaError_t launch(const SsimArgs& a, bool vec, cudaStream_t st) {
  const unsigned grid = (unsigned)((a.mbc + kWarps - 1) / kWarps);
  if (vec)
    mb_ssim_kernel<kSY, kRY, kSC, kRC, true><<<grid, kWarps * 32, 0, st>>>(a);
  else
    mb_ssim_kernel<kSY, kRY, kSC, kRC, false><<<grid, kWarps * 32, 0, st>>>(
        a);
  return cudaGetLastError();
}

}  // namespace

// ops: 6 operands (source Y, recon Y, source U, recon U, source V, recon V)
// of 8 int64 each: pointer, element size (1 or 4), then the strides in
// elements s_my, s_mx, s_r4, s_r, s_c4, s_c, none negative.  out: mbc
// int32, MB m at (m / mbw, m % mbw).
extern "C" int vp8_mb_ssim(const long long* ops, void* out, int mbc, int mbw,
                           void* stream) {
  if (mbc <= 0 || mbw <= 0) return (int)cudaErrorInvalidValue;
  const long long mbh = (mbc + mbw - 1) / mbw;
  SsimArgs a;
  bool vec = true;
  for (int i = 0; i < 6; ++i) {
    const long long* d = ops + 8 * i;
    const int esz = (int)d[1], n = i < 2 ? 16 : 8;
    if (esz != 1 && esz != 4) return (int)cudaErrorInvalidValue;
    long long s[kStrides], last = 0;
    for (int k = 0; k < kStrides; ++k) {
      s[k] = d[2 + k];
      if (s[k] < 0) return (int)cudaErrorInvalidValue;
    }
    if (mbh == 1) s[0] = 0;                   // dimensions of one MB
    if (mbw == 1) s[1] = 0;
    last = (mbh - 1) * s[0] + (mbw - 1) * s[1] +
           (n / 4 - 1) * (s[2] + s[4]) + 3 * (s[3] + s[5]);
    if (last >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    // a row as vectors: unit columns, pointer and row strides aligned
    const long long width = esz == 1 ? n : 16;
    bool ok = s[5] == 1 && s[4] == 4 && d[0] % width == 0;
    for (int k = 0; k < 4; ++k) ok = ok && (s[k] * esz) % width == 0;
    vec = vec && ok;
    Operand& o = (i % 2 == 0 ? a.src : a.rec)[i / 2];
    o.p = (const void*)(uintptr_t)d[0];
    o.esz = esz;
    for (int k = 0; k < kStrides; ++k) o.s[k] = (int)s[k];
  }
  int pair[3];                  // 10 * source size + recon size, ordered
  for (int p = 0; p < 3; ++p) {
    if (a.src[p].esz > a.rec[p].esz) {
      const Operand t = a.src[p];
      a.src[p] = a.rec[p];
      a.rec[p] = t;
    }
    pair[p] = 10 * a.src[p].esz + a.rec[p].esz;
  }
  a.out = (int*)out;
  a.mbc = mbc;
  a.mbw = mbw;
  const cudaStream_t st = (cudaStream_t)stream;
  const int form = pair[1] == pair[2] ? 100 * pair[0] + pair[1] : 0;
  return (int)(form == 1114   ? launch<1, 1, 1, 4>(a, vec, st)   // trials
               : form == 1111 ? launch<1, 1, 1, 1>(a, vec, st)   // u8
               : form == 1414 ? launch<1, 4, 1, 4>(a, vec, st)   // planes
                              : launch<0, 0, 0, 0>(a, vec, st));
}
