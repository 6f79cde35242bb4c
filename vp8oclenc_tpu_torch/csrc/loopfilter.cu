// VP8 normal loop filter for Hopper (sm_90a), Y, U and V in one launch, out
// of place: reads the unfiltered planes, writes the filtered ones.
//
// Replaces the JAX package's XLA wavefront `filter_planes`
// (ops/loopfilter.py; that package has no Pallas filter).  The contract is
// that of ops/loopfilter.py:filter_planes_plain in this package, bit for
// bit: inside an MB the decoder's edge order (left MB edge, inner vertical
// edges, top MB edge, inner horizontal edges), and between MBs any order
// that keeps the decoder's dependencies (below).
//
// What bounds it: the dependency chain.  An MB's filter reads pixels that
// its left and top neighbours' filters wrote, so a frame is a chain of
// (mbw-1) + 2*(mbh-1) + 1 MB steps (254 at 1920x1088).  The bytes (~3 MB
// read and written) and the operations are microseconds of the card's
// time; what can be had is the chain at on-chip latency.
//
// Design: one CTA per MB row and, in it, three warps per plane (Y, U, V are
// independent chains and share nothing but the per-MB parameters).  The
// filtering warp walks its row left to right and touches shared memory
// only; the two other warps keep device memory off its chain.
//   * Working pixels live in shared memory: the row's band of N lines
//     (N = 16 luma, 8 chroma) plus the 4 lines above it, staged from the
//     unfiltered plane with 16-byte (chroma 8-byte) loads before the walk.
//     A lane owns one line for the vertical edges and one column for the
//     horizontal ones, with all N+4 taps of its line in registers across
//     the edges of the MB, so an MB's pixels are read once and written
//     once per direction.  Lines are N*mbw + 4 bytes apart, an odd number
//     of words, so the lanes' line reads fall into distinct banks.
//   * What crosses rows goes through the output plane in device memory:
//     row r-1 writes its bottom 4 lines as it leaves them; row r's loading
//     warp takes them over (__ldcg: from L2, never a stale L1 line), the
//     filtering warp applies its top MB edge to 3 of them, and the storing
//     warp writes them out again with the row's own lines, 16 bytes a lane.
//   * The wait rule: the left MB edge of MB bx+1 writes 3 columns into MB
//     bx, so row r-1's MB bx is final once row r-1 has filtered MB bx+1.
//     The storing warp writes MB bx out after MB bx+1 is filtered (the last
//     MB at the row's end) and then publishes "MBs 0..bx are out" in its
//     plane's counter of the row: st.release at device scope, the other
//     lanes' stores ordered before it by __syncwarp().  Row r takes MB bx
//     once row r-1's counter is >= bx+1: one lane of the loading warp polls
//     with ld.acquire.  Inside the CTA the three warps hand MBs on through
//     two counters in shared memory.  No barrier spans the frame;
//     __syncthreads() is used twice before the walk (row index, staging).
//   * MBs whose segment level is 0 are copied, and still publish.
//
// Forward progress: a CTA takes its row from an atomic ticket, not from
// blockIdx, so the CTA of row r only ever waits for row r-1, whose ticket
// was drawn earlier by a CTA that is running already (or done).  By
// induction row 0 never waits and every row finishes, however few CTAs are
// resident: 3840x2160 (135 rows on 132 SMs) needs no co-residency.
//
// The counters (3 per row) and the ticket are scratch that the caller
// hands in zeroed.
//
// Band mode (a row shard of a taller frame, ops/loopfilter.filter_band):
// the planes are the band's MB rows, and per plane the caller hands in the
// 4 final lines above the band (from the shard above) and room for 3
// lines.  Row 0 then takes those 4 lines as its lines above (no counter to
// wait on: they are final), filters its top MB edge into them, and its
// storing warp writes the 3 lines the edge changed to the write-back room
// instead of above the plane.  Null halo pointers: a frame, as before.
//
// ptxas (sm_90a, CUDA 12.8): 72 registers, no spills, 112 bytes of static
// shared memory; dynamic shared memory is 20*(16*mbw+4) + 24*(8*mbw+4)
// bytes, 61.6 KB at 1920 wide and 123 KB at 3840, so the launcher raises
// the kernel's dynamic limit.  On an NVIDIA H100 80GB HBM3 (700 W) a
// 1920x1088 frame takes 0.59 ms (the one-CTA kernel it replaces: 6.8 ms);
// PERF.md has the measurements.
#include <cstdint>
#include <cuda_runtime.h>

#include "rowsync.cuh"

namespace {

using rowsync::post;
using rowsync::wait_above;

__device__ __forceinline__ int c128(int v) {
  return v < -128 ? -128 : (v > 127 ? 127 : v);
}

// Filter the 8 taps p3..q3 = t[0..7], values in -128..127, in place.
// MB: macroblock-edge filter, else subblock-edge filter.
template <bool MB>
__device__ __forceinline__ void filter8(int* t, int edge_lim, int int_lim,
                                        int hev_thr) {
  int p3 = t[0], p2 = t[1], p1 = t[2], p0 = t[3];
  int q0 = t[4], q1 = t[5], q2 = t[6], q3 = t[7];
  bool mask = abs(p3 - p2) <= int_lim && abs(p2 - p1) <= int_lim &&
              abs(p1 - p0) <= int_lim && abs(q1 - q0) <= int_lim &&
              abs(q2 - q1) <= int_lim && abs(q3 - q2) <= int_lim &&
              abs(p0 - q0) * 2 + abs(p1 - q1) / 2 <= edge_lim;
  bool hev = abs(p1 - p0) > hev_thr || abs(q1 - q0) > hev_thr;
  if (MB) {
    int w = mask ? c128(c128(p1 - q1) + 3 * (q0 - p0)) : 0;
    int a = hev ? w : 0;
    int b = c128(a + 3) >> 3;
    a = c128(a + 4) >> 3;
    q0 -= a;
    p0 += b;
    w = hev ? 0 : w;
    a = c128((27 * w + 63) >> 7);
    q0 -= a;
    p0 += a;
    a = c128((18 * w + 63) >> 7);
    q1 -= a;
    p1 += a;
    a = c128((9 * w + 63) >> 7);
    q2 -= a;
    p2 += a;
    t[1] = c128(p2);
    t[6] = c128(q2);
  } else {
    int a = hev ? c128(p1 - q1) : 0;
    a = c128(a + 3 * (q0 - p0));
    a = mask ? a : 0;
    int b = c128(a + 3) >> 3;
    a = c128(a + 4) >> 3;
    q0 -= a;
    p0 += b;
    a = hev ? 0 : (a + 1) >> 1;
    q1 -= a;
    p1 += a;
  }
  t[2] = c128(p1);
  t[3] = c128(p0);
  t[4] = c128(q0);
  t[5] = c128(q1);
}

// The edges of one MB along one line or column: t[0..3] belong to the
// neighbour, t[4..N+3] to the MB.
template <int N>
__device__ __forceinline__ void filter_taps(int* t, bool mb_edge, bool inner,
                                            int mbe, int sbe, int il, int hv) {
  if (mb_edge) filter8<true>(t, mbe, il, hv);
  if (inner) {
#pragma unroll
    for (int off = 4; off < N; off += 4) filter8<false>(t + off, sbe, il, hv);
  }
}

template <int N> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };

// The work of one plane's MB row r is split over three warps, so that the
// filtering warp's loop touches shared memory only: ROLE_LOAD brings the 4
// lines above the row in as the row above publishes them, ROLE_FILTER
// filters, ROLE_STORE writes finished MBs out and publishes them.
// band: (N+4) lines of pitch N*mbw+4 bytes in shared memory; each line
// starts with one pad word (the columns left of the frame); band line l
// holds plane line r*N - 4 + l.  s_loaded: MBs whose lines above are in
// the band; s_done: MBs filtered.
enum { ROLE_FILTER = 0, ROLE_LOAD = 1, ROLE_STORE = 2 };

// Stage a row's own N lines (unfiltered) into its band, the plane's three
// warps together (t = 0..95).
template <int N>
__device__ void stage_band(const uint8_t* __restrict__ in, uint8_t* band,
                           int mbw, int r, int t) {
  using V = typename Vec<N>::T;
  constexpr int VW = N / 4;
  const int W = mbw * N, pw = W / 4 + 1;
  uint32_t* bw = reinterpret_cast<uint32_t*>(band);
  for (int i = t; i < N * mbw; i += 96) {
    const int l = i / mbw, k = i % mbw;
    V v = __ldg(reinterpret_cast<const V*>(
        in + ((size_t)(r * N + l) * W + k * N)));
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < VW; ++j) bw[(4 + l) * pw + 1 + k * VW + j] = w[j];
  }
}

template <int N>
__device__ void filter_row(int role, uint8_t* out, int* prog, uint8_t* band,
                           int* s_loaded, int* s_done,
                           const int* __restrict__ seg,
                           const uint8_t* __restrict__ inner, const int* lf,
                           const uint8_t* __restrict__ halo, uint8_t* wb,
                           int mbw, int mbh, int r, int lane) {
  using V = typename Vec<N>::T;
  constexpr int VW = N / 4;                   // words per MB line
  const int W = mbw * N, pitch = W + 4, pw = pitch / 4;
  uint32_t* bw = reinterpret_cast<uint32_t*>(band);
  const bool above = r > 0 || halo != nullptr;   // lines above row r

  if (role == ROLE_LOAD) {
    // Row r-1's bottom 4 lines, MB by MB as its counter allows: from L2
    // (__ldcg) behind the acquire, never from a stale L1 line.  A band's
    // row 0 takes the halo's, final already.
    if (r == 0) {
      if (halo == nullptr) return;
      for (int i = lane; i < 4 * mbw; i += 32) {
        const int l = i & 3, k = i >> 2;
        V v = __ldg(reinterpret_cast<const V*>(halo + ((size_t)l * W + k * N)));
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < VW; ++j) bw[l * pw + 1 + k * VW + j] = w[j];
      }
      post<false>(s_loaded, mbw, lane);
      return;
    }
    int have = 0;
    while (have < mbw) {
      const int seen = wait_above<true>(prog + r - 1, have, lane);
      for (int i = lane; i < 4 * (seen - have); i += 32) {
        const int l = i & 3, k = have + (i >> 2);
        V v = __ldcg(reinterpret_cast<const V*>(
            out + ((size_t)(r * N - 4 + l) * W + k * N)));
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < VW; ++j) bw[l * pw + 1 + k * VW + j] = w[j];
      }
      post<false>(s_loaded, seen, lane);
      have = seen;
    }
    return;
  }

  if (role == ROLE_STORE) {
    // MB k is final once MB k+1 is filtered (its left edge writes 3
    // columns into MB k) or the row is done.  Its lines go out: the 3
    // above the row that the top MB edge may have changed, and the row's
    // own; then the count of MBs that are out, for the row below
    // (st.release at device scope; the other lanes' stores are ordered
    // before it by __syncwarp).
    constexpr int LN = N + 3;
    int have = 0;
    while (have < mbw) {
      int seen =
          wait_above<false>(s_done, have < mbw - 1 ? have + 1 : have, lane);
      seen = seen == mbw ? mbw : seen - 1;
      for (int i = lane; i < LN * (seen - have); i += 32) {
        const int l = 1 + i % LN, k = have + i / LN;
        if (r > 0 || l >= 4 || wb != nullptr) {
          V v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < VW; ++j) w[j] = bw[l * pw + 1 + k * VW + j];
          uint8_t* dst = r > 0 || l >= 4
                             ? out + ((size_t)(r * N - 4 + l) * W + k * N)
                             : wb + ((size_t)(l - 1) * W + k * N);
          *reinterpret_cast<V*>(dst) = v;
        }
      }
      if (r + 1 < mbh) post<true>(prog + r, seen, lane);
      have = seen;
    }
    return;
  }

  int loaded = above ? 0 : mbw;
  int s = seg[r * mbw];
  bool inn = inner[r * mbw] != 0;
  for (int bx = 0; bx < mbw; ++bx) {
    const int cs = s;
    const bool cinn = inn;
    if (bx + 1 < mbw) {                       // the next MB's parameters
      s = seg[r * mbw + bx + 1];
      inn = inner[r * mbw + bx + 1] != 0;
    }
    if (loaded < bx + 1) loaded = wait_above<false>(s_loaded, bx, lane);
    if (lf[cs] > 0) {                         // warp-uniform
      const int mbe = lf[4 + cs], sbe = lf[8 + cs];
      const int il = lf[12 + cs], hv = lf[16 + cs];
      int t[N + 4];
      if (lane < N) {                         // vertical edges: my line
        uint32_t* p = bw + (4 + lane) * pw + bx * VW;
#pragma unroll
        for (int j = 0; j <= VW; ++j) {
          const uint32_t w = p[j];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            t[4 * j + b] = (int)((w >> (8 * b)) & 255u) - 128;
        }
        filter_taps<N>(t, bx > 0, cinn, mbe, sbe, il, hv);
#pragma unroll
        for (int j = 0; j <= VW; ++j) {
          uint32_t w = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w |= (uint32_t)(t[4 * j + b] + 128) << (8 * b);
          p[j] = w;
        }
      }
      __syncwarp();
      if (lane < N) {                         // horizontal edges: my column
        uint8_t* p = band + 4 + bx * N + lane;
#pragma unroll
        for (int l = 0; l < N + 4; ++l) t[l] = (int)p[l * pitch] - 128;
        filter_taps<N>(t, above, cinn, mbe, sbe, il, hv);
#pragma unroll
        for (int l = 0; l < N + 4; ++l) p[l * pitch] = (uint8_t)(t[l] + 128);
      }
    }
    post<false>(s_done, bx + 1, lane);
  }
}

constexpr int kThreads = 288;                 // 3 planes x 3 roles, a warp each

// lf: (5, 4) int32 rows level, MB-edge limit, subblock-edge limit,
// interior limit, HEV threshold; columns the 4 segments.  sync: 3*mbh
// progress counters (plane-major) and the row ticket, all 0 at launch.
// hy/hu/hv: null, or a band's 4 lines above each plane; wy/wu/wv: then
// room for the 3 of them that come back.
__global__ void __launch_bounds__(kThreads)
    loop_filter_rows_kernel(const uint8_t* __restrict__ y,
                            const uint8_t* __restrict__ u,
                            const uint8_t* __restrict__ v, uint8_t* oy,
                            uint8_t* ou, uint8_t* ov,
                            const int* __restrict__ seg,
                            const uint8_t* __restrict__ inner,
                            const int* __restrict__ lf,
                            const uint8_t* __restrict__ hy,
                            const uint8_t* __restrict__ hu,
                            const uint8_t* __restrict__ hv, uint8_t* wy,
                            uint8_t* wu, uint8_t* wv, int* sync, int mbw,
                            int mbh) {
  extern __shared__ uint4 smem[];
  __shared__ int s_row;
  __shared__ int s_lf[20];
  __shared__ int s_flags[6];
  if (threadIdx.x == 0) s_row = atomicAdd(sync + 3 * mbh, 1);
  if (threadIdx.x < 20) s_lf[threadIdx.x] = lf[threadIdx.x];
  if (threadIdx.x < 6) s_flags[threadIdx.x] = 0;
  __syncthreads();
  const int r = s_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = warp % 3, role = warp / 3;
  uint8_t* band_y = reinterpret_cast<uint8_t*>(smem);
  uint8_t* band_u = band_y + 20 * (16 * mbw + 4);
  uint8_t* band_v = band_u + 12 * (8 * mbw + 4);
  int* s_loaded = s_flags + plane;
  int* s_done = s_flags + 3 + plane;
  const int t = role * 32 + lane;
  if (plane == 0)
    stage_band<16>(y, band_y, mbw, r, t);
  else
    stage_band<8>(plane == 1 ? u : v, plane == 1 ? band_u : band_v, mbw, r, t);
  __syncthreads();
  if (plane == 0)
    filter_row<16>(role, oy, sync, band_y, s_loaded, s_done, seg, inner, s_lf,
                   hy, wy, mbw, mbh, r, lane);
  else if (plane == 1)
    filter_row<8>(role, ou, sync + mbh, band_u, s_loaded, s_done, seg, inner,
                  s_lf, hu, wu, mbw, mbh, r, lane);
  else
    filter_row<8>(role, ov, sync + 2 * mbh, band_v, s_loaded, s_done, seg,
                  inner, s_lf, hv, wv, mbw, mbh, r, lane);
}

}  // namespace

extern "C" int vp8_loop_filter(const void* y, const void* u, const void* v,
                               void* oy, void* ou, void* ov, const void* hy,
                               const void* hu, const void* hv, void* wy,
                               void* wu, void* wv, const void* seg,
                               const void* inner, const void* lf, void* sync,
                               int mbw, int mbh, void* stream) {
  const int smem = 20 * (16 * mbw + 4) + 24 * (8 * mbw + 4);
  cudaError_t e = cudaFuncSetAttribute(
      loop_filter_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  loop_filter_rows_kernel<<<mbh, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, (uint8_t*)oy,
      (uint8_t*)ou, (uint8_t*)ov, (const int*)seg, (const uint8_t*)inner,
      (const int*)lf, (const uint8_t*)hy, (const uint8_t*)hu,
      (const uint8_t*)hv, (uint8_t*)wy, (uint8_t*)wu, (uint8_t*)wv,
      (int*)sync, mbw, mbh);
  return (int)cudaGetLastError();
}
