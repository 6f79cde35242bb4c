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
// Design: one CTA per MB row and, in it, warps per plane (Y, U, V are
// independent chains and share nothing but the per-MB parameters).  The
// filtering warp walks its row left to right and touches shared memory
// only; the other warps keep device memory off its chain.  Two kernels
// share the edge filters and the rules between rows:
//   * loop_filter_rows_kernel (where the row fits a CTA: up to 7248
//     pixels on 227 KB): three warps per plane.  Working pixels live in
//     shared memory: the row's band of N lines (N = 16 luma, 8 chroma)
//     plus the 4 lines above it, staged from the unfiltered plane with
//     16-byte (chroma 8-byte) loads before the walk, 20*(16*mbw+4) +
//     24*(8*mbw+4) bytes (62 KB at 1920, 123 KB at 3840).
//   * loop_filter_ring_kernel (wider planes, up to VP8's 16383 pixels):
//     the pixels live in a ring of K MB columns
//     (K = kRing, a power of two; MB bx in slot bx % K), each slot the
//     MB's N lines and the 4 lines above them, 8.4 KB a CTA at any width.
//     A ring line is K*N + 4 bytes: one pad word (the columns left of the
//     frame), then the K slots; the 4 pixels left of slot 0 are those of
//     slot K-1.  A fourth warp per plane stages MB bx's own lines as soon
//     as its slot is free, up to K MBs ahead of the walk; the slot of MB
//     bx takes MB bx+K once MB bx is out, which needs K >= 2.  On an
//     NVIDIA H100 it is ~35-45% slower than the full-row kernel at 1080p
//     and UHD (PERF.md), for a cause in the rows' hand-off that the
//     measurements there narrow down but do not name; hence two kernels.
//   * A lane owns one line for the vertical edges and one column for the
//     horizontal ones, with all N+4 taps of its line in registers across
//     the edges of the MB, so an MB's pixels are read once and written
//     once per direction.  Lines are an odd number of words apart, so the
//     lanes' line reads fall into distinct banks.
//   * What crosses rows goes through the output plane in device memory:
//     row r-1 writes its bottom 4 lines as it leaves them; row r's loading
//     warp takes them over (__ldcg: from L2, never a stale L1 line), the
//     filtering warp applies its top MB edge to 3 of them, and the storing
//     warp writes them out again with the row's own lines, 16 bytes a lane.
//   * The wait rule: the left MB edge of MB bx+1 writes 3 columns into MB
//     bx, so MB bx is final once MB bx+1 is filtered.  The storing warp
//     writes MB bx out after MB bx+1 is filtered (the last MB at the row's
//     end) and then publishes "MBs 0..bx are out" in its plane's counter
//     of the row: st.release at device scope, the other lanes' stores
//     ordered before it by __syncwarp().  Row r takes MB bx once row r-1's
//     counter is >= bx+1: one lane of the loading warp polls with
//     ld.acquire.  Inside the CTA the warps hand MBs on through counters
//     in shared memory.  No barrier spans the frame.
//   * MBs whose segment level is 0 are copied, and still publish.
//
// Forward progress: a CTA takes its row from an atomic ticket, not from
// blockIdx, so the CTA of row r only ever waits for row r-1, whose ticket
// was drawn earlier by a CTA that is running already (or done).  By
// induction row 0 never waits and every row finishes, however few CTAs are
// resident: 7680x4320 (270 rows on 132 SMs) needs no co-residency.
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
// ptxas (sm_90a, CUDA 12.8): 72 registers each, no spills.  On an NVIDIA
// H100 80GB HBM3 (700 W) a 1920x1088 frame takes 0.60 ms (the one-CTA
// kernel it replaced: 6.8 ms); PERF.md has the measurements.
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

// A plane's warps: ROLE_FILTER filters, ROLE_LOAD brings the 4 lines
// above the row in, ROLE_STORE writes finished MBs out, ROLE_STAGE (the
// ring kernel's) brings the row's own lines in.
enum { ROLE_FILTER = 0, ROLE_LOAD = 1, ROLE_STORE = 2, ROLE_STAGE = 3 };

// The work of one plane's MB row r is split over three warps, so that the
// filtering warp's loop touches shared memory only: ROLE_LOAD brings the 4
// lines above the row in as the row above publishes them, ROLE_FILTER
// filters, ROLE_STORE writes finished MBs out and publishes them.
// band: (N+4) lines of pitch N*mbw+4 bytes in shared memory; each line
// starts with one pad word (the columns left of the frame); band line l
// holds plane line r*N - 4 + l.  s_loaded: MBs whose lines above are in
// the band; s_done: MBs filtered.

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
__device__ void filter_row_band(int role, uint8_t* out, int* prog,
                                uint8_t* band, int* s_loaded, int* s_done,
                                const int* __restrict__ seg,
                                const uint8_t* __restrict__ inner,
                                const int* lf,
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

constexpr int kBandThreads = 288;             // 3 planes x 3 roles, a warp each

// lf: (5, 4) int32 rows level, MB-edge limit, subblock-edge limit,
// interior limit, HEV threshold; columns the 4 segments.  sync: 3*mbh
// progress counters (plane-major) and the row ticket, all 0 at launch.
// hy/hu/hv: null, or a band's 4 lines above each plane; wy/wu/wv: then
// room for the 3 of them that come back.
__global__ void __launch_bounds__(kBandThreads)
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
    filter_row_band<16>(role, oy, sync, band_y, s_loaded, s_done, seg, inner,
                        s_lf, hy, wy, mbw, mbh, r, lane);
  else if (plane == 1)
    filter_row_band<8>(role, ou, sync + mbh, band_u, s_loaded, s_done, seg,
                       inner, s_lf, hu, wu, mbw, mbh, r, lane);
  else
    filter_row_band<8>(role, ov, sync + 2 * mbh, band_v, s_loaded, s_done,
                       seg, inner, s_lf, hv, wv, mbw, mbh, r, lane);
}

// Dynamic shared memory of a loop_filter_rows_kernel CTA: 20 luma and
// twice 12 chroma lines of the row's width and a pad word.
__host__ __device__ constexpr int band_smem(int mbw) {
  return 20 * (16 * mbw + 4) + 24 * (8 * mbw + 4);
}

constexpr int kRing = 16;                     // MB columns a CTA stages

// The work of one plane's MB row r is split over four warps, so that the
// filtering warp's loop touches shared memory only: ROLE_STAGE brings the
// row's own lines in as the ring has room, ROLE_LOAD the 4 lines above
// the row as the row above publishes them, ROLE_FILTER filters,
// ROLE_STORE writes finished MBs out, publishes them and frees their
// slots.  ring: (N+4) lines of pitch K*N+4 bytes; ring line l of MB bx's
// slot holds plane line r*N - 4 + l.  The counters, in shared memory:
// cnt[0] MBs staged, cnt[1] MBs whose lines above are in, cnt[2] MBs
// filtered, cnt[3] MBs out.
enum { C_STAGED = 0, C_LOADED = 1, C_DONE = 2, C_OUT = 3 };

// Wait until MB `want` may go into its slot (MB want-K is out) and, where
// `above` is not null, the row above has published MB `want`; returns the
// number of MBs both allow, at most mbw, to every lane.
__device__ __forceinline__ int wait_room(const int* above, const int* out,
                                         int K, int want, int mbw, int lane) {
  int room = 0;
  if (lane == 0) {
    do {
      room = min(*(const volatile int*)out + K, mbw);
      if (room > want && above != nullptr)
        room = min(room, rowsync::ld_acquire(above));
    } while (room <= want);
  }
  room = __shfl_sync(0xffffffffu, room, 0);
  __syncwarp();
  return room;
}

template <int N>
__device__ void filter_row_ring(int role, const uint8_t* __restrict__ in,
                           uint8_t* out, int* prog, uint8_t* ring, int* cnt,
                           const int* __restrict__ seg,
                           const uint8_t* __restrict__ inner, const int* lf,
                           const uint8_t* __restrict__ halo, uint8_t* wb,
                           int mbw, int mbh, int r, int lane) {
  using V = typename Vec<N>::T;
  constexpr int VW = N / 4;                   // words per MB line
  constexpr int K = kRing, mask = K - 1;
  constexpr int pitch = K * N + 4, pw = pitch / 4;
  const int W = mbw * N;
  uint32_t* rw = reinterpret_cast<uint32_t*>(ring);
  const bool above = r > 0 || halo != nullptr;   // lines above row r

  if (role == ROLE_STAGE) {
    // The row's own N lines (unfiltered), as many MBs as the ring has
    // room for, published a load per lane at a time (32/N MBs), so that
    // the walk never waits for more than one load's latency.
    constexpr int CHUNK = 32 / N;
    int have = 0;
    while (have < mbw) {
      const int room = min(
          wait_room(nullptr, cnt + C_OUT, K, have, mbw, lane),
          have + CHUNK);
      const int n = room - have;
      if (lane < N * n) {
        const int l = lane / n, k = have + lane % n;
        V v = __ldg(reinterpret_cast<const V*>(
            in + ((size_t)(r * N + l) * W + k * N)));
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          rw[(4 + l) * pw + 1 + (k & mask) * VW + j] = w[j];
      }
      post<false>(cnt + C_STAGED, room, lane);
      have = room;
    }
    return;
  }

  if (role == ROLE_LOAD) {
    // Row r-1's bottom 4 lines, MB by MB as its counter and the ring
    // allow: from L2 (__ldcg) behind the acquire, never from a stale L1
    // line.  A band's row 0 takes the halo's, final already.
    if (!above) return;
    int have = 0;
    while (have < mbw) {
      const int seen = wait_room(r > 0 ? prog + r - 1 : nullptr,
                                 cnt + C_OUT, K, have, mbw, lane);
      for (int i = lane; i < 4 * (seen - have); i += 32) {
        const int l = i & 3, k = have + (i >> 2);
        const V* g = reinterpret_cast<const V*>(
            r > 0 ? out + ((size_t)(r * N - 4 + l) * W + k * N)
                  : halo + ((size_t)l * W + k * N));
        V v = r > 0 ? __ldcg(g) : __ldg(g);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < VW; ++j)
          rw[l * pw + 1 + (k & mask) * VW + j] = w[j];
      }
      post<false>(cnt + C_LOADED, seen, lane);
      have = seen;
    }
    return;
  }

  if (role == ROLE_STORE) {
    // MB k is final once MB k+1 is filtered (its left edge writes 3
    // columns into MB k) or the row is done.  Its lines go out: the 3
    // above the row that the top MB edge may have changed, and the row's
    // own; then the count of MBs that are out, for the ring (behind a
    // block fence, so that this warp's reads of the slots are ordered
    // before the staging and loading warps overwrite them) and for the
    // row below (st.release at device scope; the other lanes' stores are
    // ordered before it by __syncwarp).
    constexpr int LN = N + 3;
    int have = 0;
    while (have < mbw) {
      int seen = wait_above<false>(cnt + C_DONE,
                                   have < mbw - 1 ? have + 1 : have, lane);
      seen = seen == mbw ? mbw : seen - 1;
      for (int i = lane; i < LN * (seen - have); i += 32) {
        const int l = 1 + i % LN, k = have + i / LN;
        if (r > 0 || l >= 4 || wb != nullptr) {
          V v;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < VW; ++j)
            w[j] = rw[l * pw + 1 + (k & mask) * VW + j];
          uint8_t* dst = r > 0 || l >= 4
                             ? out + ((size_t)(r * N - 4 + l) * W + k * N)
                             : wb + ((size_t)(l - 1) * W + k * N);
          *reinterpret_cast<V*>(dst) = v;
        }
      }
      post<false>(cnt + C_OUT, seen, lane);
      if (r + 1 < mbh) post<true>(prog + r, seen, lane);
      have = seen;
    }
    return;
  }

  int loaded = above ? 0 : mbw, staged = 0;
  int s = seg[r * mbw];
  bool inn = inner[r * mbw] != 0;
  for (int bx = 0; bx < mbw; ++bx) {
    const int cs = s;
    const bool cinn = inn;
    if (bx + 1 < mbw) {                       // the next MB's parameters
      s = seg[r * mbw + bx + 1];
      inn = inner[r * mbw + bx + 1] != 0;
    }
    if (staged < bx + 1) staged = wait_above<false>(cnt + C_STAGED, bx, lane);
    if (loaded < bx + 1) loaded = wait_above<false>(cnt + C_LOADED, bx, lane);
    const int slot = bx & mask;
    if (lf[cs] > 0) {                         // warp-uniform
      const int mbe = lf[4 + cs], sbe = lf[8 + cs];
      const int il = lf[12 + cs], hv = lf[16 + cs];
      int t[N + 4];
      if (lane < N) {                         // vertical edges: my line
        uint32_t* line = rw + (4 + lane) * pw;
        uint32_t* p = line + 1 + slot * VW;
        // the 4 pixels left of the MB: slot K-1's last word left of slot
        // 0 (the pad word left of the frame)
        uint32_t* pl = slot == 0 && bx > 0 ? line + K * VW : p - 1;
        {
          const uint32_t w = *pl;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            t[b] = (int)((w >> (8 * b)) & 255u) - 128;
        }
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          const uint32_t w = p[j];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            t[4 + 4 * j + b] = (int)((w >> (8 * b)) & 255u) - 128;
        }
        filter_taps<N>(t, bx > 0, cinn, mbe, sbe, il, hv);
        if (bx > 0) {                         // else the pad word: unchanged
          uint32_t w = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w |= (uint32_t)(t[b] + 128) << (8 * b);
          *pl = w;
        }
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          uint32_t w = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w |= (uint32_t)(t[4 + 4 * j + b] + 128) << (8 * b);
          p[j] = w;
        }
      }
      __syncwarp();
      if (lane < N) {                         // horizontal edges: my column
        uint8_t* p = ring + 4 + slot * N + lane;
#pragma unroll
        for (int l = 0; l < N + 4; ++l) t[l] = (int)p[l * pitch] - 128;
        filter_taps<N>(t, above, cinn, mbe, sbe, il, hv);
#pragma unroll
        for (int l = 0; l < N + 4; ++l) p[l * pitch] = (uint8_t)(t[l] + 128);
      }
    }
    post<false>(cnt + C_DONE, bx + 1, lane);
  }
}

constexpr int kThreads = 384;                 // 3 planes x 4 roles, a warp each

// Dynamic shared memory of a loop_filter_ring_kernel CTA: 20 luma and
// twice 12 chroma lines of kRing MBs and a pad word.
constexpr int kRingSmem = 20 * (16 * kRing + 4) + 24 * (8 * kRing + 4);

// lf: (5, 4) int32 rows level, MB-edge limit, subblock-edge limit,
// interior limit, HEV threshold; columns the 4 segments.  sync: 3*mbh
// progress counters (plane-major) and the row ticket, all 0 at launch.
// hy/hu/hv: null, or a band's 4 lines above each plane; wy/wu/wv: then
// room for the 3 of them that come back.
__global__ void __launch_bounds__(kThreads)
    loop_filter_ring_kernel(const uint8_t* __restrict__ y,
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
  __shared__ int s_cnt[3][4];
  if (threadIdx.x == 0) s_row = atomicAdd(sync + 3 * mbh, 1);
  if (threadIdx.x < 20) s_lf[threadIdx.x] = lf[threadIdx.x];
  if (threadIdx.x < 12) s_cnt[threadIdx.x >> 2][threadIdx.x & 3] = 0;
  __syncthreads();
  const int r = s_row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int plane = warp % 3, role = warp / 3;
  uint8_t* ring_y = reinterpret_cast<uint8_t*>(smem);
  uint8_t* ring_u = ring_y + 20 * (16 * kRing + 4);
  uint8_t* ring_v = ring_u + 12 * (8 * kRing + 4);
  if (plane == 0)
    filter_row_ring<16>(role, y, oy, sync, ring_y, s_cnt[0], seg, inner, s_lf,
                        hy, wy, mbw, mbh, r, lane);
  else if (plane == 1)
    filter_row_ring<8>(role, u, ou, sync + mbh, ring_u, s_cnt[1], seg, inner,
                       s_lf, hu, wu, mbw, mbh, r, lane);
  else
    filter_row_ring<8>(role, v, ov, sync + 2 * mbh, ring_v, s_cnt[2], seg,
                       inner, s_lf, hv, wv, mbw, mbh, r, lane);
}

}  // namespace

// The card's shared memory a CTA may opt into, 0 if it cannot be read.
static int shared_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return v;
}

// 1 where a luma plane `width` pixels wide takes loop_filter_ring_kernel
// (its row does not fit a loop_filter_rows_kernel CTA of this card: above
// 7248 pixels at 227 KB), else 0.
extern "C" int vp8_filter_ring(int width) {
  return band_smem(width / 16) > shared_optin();
}

// Dynamic shared memory of one CTA for a luma plane `width` pixels wide:
// the full-row kernel's where its row fits a CTA, else the ring kernel's,
// the same at every width.
extern "C" int vp8_filter_smem(int width) {
  return vp8_filter_ring(width) ? kRingSmem : band_smem(width / 16);
}

extern "C" int vp8_loop_filter(const void* y, const void* u, const void* v,
                               void* oy, void* ou, void* ov, const void* hy,
                               const void* hu, const void* hv, void* wy,
                               void* wu, void* wv, const void* seg,
                               const void* inner, const void* lf, void* sync,
                               int mbw, int mbh, void* stream) {
  if (mbw <= 0 || mbh <= 0) return (int)cudaErrorInvalidValue;
  const bool full = !vp8_filter_ring(16 * mbw);
  const int smem = full ? band_smem(mbw) : kRingSmem;
  const cudaFuncAttribute dyn = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e =
      full ? cudaFuncSetAttribute(loop_filter_rows_kernel, dyn, smem)
           : cudaFuncSetAttribute(loop_filter_ring_kernel, dyn, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();      // the next launch reports only its own error
    return (int)e;
  }
  const uint8_t *py = (const uint8_t*)y, *pu = (const uint8_t*)u,
                *pv = (const uint8_t*)v, *phy = (const uint8_t*)hy,
                *phu = (const uint8_t*)hu, *phv = (const uint8_t*)hv,
                *pin = (const uint8_t*)inner;
  if (full)
    loop_filter_rows_kernel<<<mbh, kBandThreads, smem, (cudaStream_t)stream>>>(
        py, pu, pv, (uint8_t*)oy, (uint8_t*)ou, (uint8_t*)ov,
        (const int*)seg, pin, (const int*)lf, phy, phu, phv, (uint8_t*)wy,
        (uint8_t*)wu, (uint8_t*)wv, (int*)sync, mbw, mbh);
  else
    loop_filter_ring_kernel<<<mbh, kThreads, smem, (cudaStream_t)stream>>>(
        py, pu, pv, (uint8_t*)oy, (uint8_t*)ou, (uint8_t*)ov,
        (const int*)seg, pin, (const int*)lf, phy, phu, phv, (uint8_t*)wy,
        (uint8_t*)wu, (uint8_t*)wv, (int*)sync, mbw, mbh);
  return (int)cudaGetLastError();
}
