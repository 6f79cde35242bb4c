// Motion search for Hopper (sm_90a): the dual-window full-pel search of one
// pyramid level and the quarter-pel refinement, each one launch.
//
// Replaces the JAX package's Pallas kernels `fullpel_search50`
// (ops/pallas_kernels.py, _build_fullpel_search_call) and `qpel_search25`
// (ops/pallas_kernels.py, _build_qpel_call, with the zero-vector candidate
// and the penalty take-back that its XLA caller adds); the contract is that
// of ops/inter.py:fullpel_search_plain / qpel_search_plain in this package,
// bit for bit.
//
// What bounds both: integer instructions.  An SM has two pipes that take
// them, 64 lanes each (multiply-adds and dp4a on one; adds, logic, shifts,
// min/max on the other), and starts at most four warp instructions a
// clock.  A candidate's cost is four separable 4x4 transforms of an 8x8
// residual, their abs and sums; its window is shared by every candidate of
// its block, and a qpel candidate adds its 8x8 vertical six-tap pass on top
// of the horizontal passes its block shares.  Bytes are a few hundred per
// block.
//
// Both kernels stage the windows in shared memory with every read clamped
// into the plane (equal to the JAX package's edge-replicated apron),
// compute costs in exact int32 (|C4.X.C4^T|), and take the minimum of
// (cost, index), so ties go to the earliest candidate as in the plain
// versions.
//
// Full pel (`fullpel_kernel`): one warp per 8x8 block and all three
// references (its 150 candidates), 2 warps per CTA; on a level of fewer
// than kFewBlocks blocks one warp per block and reference, whose chain is
// a third as long (those levels are one warp's chain and a launch).  The
// design is about instructions per job:
//   * the column stage is shared.  The cost is linear up to the abs, so
//     C4 (R - C) C4^T = C4 R C4^T - C4 C C4^T: the column transform of every
//     window position a quadrant can start on (9 row starts x 12 columns of
//     each 12x12 window, 108 where the candidates' quadrants need 400) is
//     taken once into shared memory as int4, a lane sliding down one window
//     column, and the current block's two stages once; a candidate's
//     quadrant is then four 16-byte loads, four row stages that subtract
//     the current block's inside their adds, abs and sums.  The factors 8
//     and 2 of C4's rows are taken out of both stages and put back as
//     weights (`quad_cost_t`).
//   * lanes.  Candidate c = lane + 32k: with three references 150 of 160
//     slots work (94%; one reference a warp is 50 of 64).  Each lane keeps
//     its earliest minimum per reference over its rounds; one
//     __reduce_min_sync a reference over (cost << 6 | index) ends the
//     search.
//   * window rows are read as three words cut from four with funnel shifts
//     wherever a row lies inside a word-aligned plane, bytes otherwise;
//     column-stage rows are 13 int4 apart, so the eight lanes of a 16-byte
//     load's phase mostly hit different bank groups.
//   Straight-line machine code but for the staging: ~3,500 instructions a
//   warp of three references, ~1,150 a (reference, block) job, where the
//   kernel it replaces ran ~2,190 (tools/sass_mix_cuda.py); PERF.md has the
//   counts and times.
//
// Quarter pel (`qpel_kernel`): what it is short of is instruction slots, so
// the design is about instructions per job (~1,650 where its predecessor,
// with a byte an instruction and every lane's prediction parked in shared
// memory 64 bytes apart, ran ~2,700 and replayed ~1,600 bank conflicts):
//   * four taps an instruction.  Only phases 0, 2, 4, 6 of the six-tap
//     table occur (a step is +-2 quarter pels); the taps of 2, 4, 6 fit a
//     signed byte, so a filtered pixel is two dp4a (unsigned pixels, signed
//     taps, the rounding constant as the accumulator) on words cut from
//     shared memory with funnel shifts.  Phase 0 is the identity: the
//     horizontal pass copies; the vertical pass, whose phase varies by
//     lane, uses taps (0,0,64,0,0,0) with (s + 32) >> 6, which is exactly x
//     for every byte, in the same instruction stream.
//   * the horizontal pass writes its output transposed (a column's 14 rows
//     in 16 adjacent bytes), so a lane's vertical pass reads a column with
//     one 16-byte load and slides over it in registers.
//   * one instruction stream for all 26 candidates.  The zero-vector block
//     is staged as a sixth "horizontal pass" slot, so lane 25 runs the same
//     vertical pass (phase 0: a copy) and the same cost code as lanes
//     0..24; no branch holds a second cost evaluation.
//   * predictions stay in registers, 16 packed words a lane; the residual
//     is taken from the packed words against the current block, which is
//     unpacked once to int32 in shared memory (every lane reads the same
//     address: a broadcast).  The winning lane stores its 64 bytes itself
//     as four 16-byte stores.
//   * the minimum is one __reduce_min_sync over (cost << 5 | lane): a valid
//     cost is below 2^18 (four quadrants of at most 32,640, plus 128 of
//     penalty) and the zero vector is always valid, so the key of a
//     candidate outside the frame never wins.
//   Lanes 26..31 idle through the two large sections (26 of 32 lanes work).
//   Shared memory is 1.4 KB a warp, laid out so that no access conflicts
//   (window rows 20 bytes apart, pass slots 36 words apart).  The machine
//   code is straight-line, 1,656 instructions a job, split evenly between
//   the card's two integer pipes (tools/sass_mix_cuda.py).  On an NVIDIA
//   H100 80GB HBM3 (700 W) the 97,920 jobs of a 1920x1088 frame take 0.20 ms
//   (the kernel it replaces: 0.98 ms); PERF.md has the measurements.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // (reference, block) jobs per CTA
constexpr int kBig = 1 << 28;      // cost of a candidate outside the frame
constexpr int kPen = 32;           // VECTOR_DIFF_WEIGHT / 2

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
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

// dct_weight of the 4x4 residual x (raster).
__device__ __forceinline__ int quad_cost_res(const int* x) {
  int t[16];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    int col[4];
    cost_c4(x[l], x[4 + l], x[8 + l], x[12 + l], col);
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i * 4 + l] = col[i];
  }
  int s = 0, dc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row[4];
    cost_c4(t[i * 4], t[i * 4 + 1], t[i * 4 + 2], t[i * 4 + 3], row);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int v = abs(row[j]);
      if (i == 0 && j == 0) dc = v;
      s += v;
    }
  }
  return (4 * s - 3 * dc) >> 9;
}

// Full pel: the cost of a candidate, C4 (R - C) C4^T per quadrant, is
// linear up to the abs, so C4 R C4^T - C4 C C4^T.  Every row of C4 is a
// multiple of (1 1 1 1), (5 2 -2 -5), (1 -1 -1 1) or (2 -5 5 -2) by 8, 2, 8
// or 2; the stages below drop those factors and `quad_cost_t` puts them
// back as weights 64, 16, 4 on the three classes of coefficient, and the
// >> 9 of dct_weight as >> 5 (everything it shifts is a multiple of 16).

// Four values through the four rows of C4 without their factors:
// (a, e, b, f) = ((1 1 1 1), (5 2 -2 -5), (1 -1 -1 1), (2 -5 5 -2)) . x.
__device__ __forceinline__ int4 c4_stage(int x0, int x1, int x2, int x3) {
  const int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
  return make_int4(s03 + s12, 5 * d03 + 2 * d12, s03 - s12,
                   2 * d03 - 5 * d12);
}

// Row i of a candidate's quadrant: component i of the column stage of its
// four window columns through the stage again, less g.
__device__ __forceinline__ int4 row_less(int u0, int u1, int u2, int u3,
                                         int4 g) {
  const int s03 = u0 + u3, d03 = u0 - u3, s12 = u1 + u2, d12 = u1 - u2;
  return make_int4(s03 + s12 - g.x, 5 * d03 + 2 * d12 - g.y,
                   s03 - s12 - g.z, 2 * d03 - 5 * d12 - g.w);
}

// dct_weight of one quadrant of a candidate: t[0..3] the column stage of
// its four window columns (components a, e, b, f), g[0..3] the current
// quadrant's two stages by row.  Coefficient (i, j) carries the factors of
// rows i and j of C4: 64 where both are even, 16 where one is, else 4.
__device__ __forceinline__ int quad_cost_t(const int4* t, const int4* g) {
  const int4 c0 = t[0], c1 = t[1], c2 = t[2], c3 = t[3];
  const int4 r0 = row_less(c0.x, c1.x, c2.x, c3.x, g[0]);
  const int4 r1 = row_less(c0.y, c1.y, c2.y, c3.y, g[1]);
  const int4 r2 = row_less(c0.z, c1.z, c2.z, c3.z, g[2]);
  const int4 r3 = row_less(c0.w, c1.w, c2.w, c3.w, g[3]);
  const int dc = abs(r0.x);
  const int s64 = dc + abs(r0.z) + abs(r2.x) + abs(r2.z);
  const int s16 = abs(r0.y) + abs(r0.w) + abs(r2.y) + abs(r2.w) +
                  abs(r1.x) + abs(r1.z) + abs(r3.x) + abs(r3.z);
  const int s4 = abs(r1.y) + abs(r1.w) + abs(r3.y) + abs(r3.w);
  return (16 * s64 + 4 * s16 + s4 - 12 * dc) >> 5;
}

constexpr int kFpWarps = 2;          // warps per CTA (25 KB of shared memory)
// Below this many blocks a level takes one reference a warp (three times
// the warps, each a third as long): levels of 120 and 510 blocks ran 43%
// and 28% faster so, levels of 2040 blocks and more 4-6% slower (NVIDIA
// H100, PERF.md).
constexpr int kFewBlocks = 1024;
constexpr int kColPitch = 13;        // int4 between column-stage rows
constexpr int kColWin = 9 * kColPitch;
constexpr unsigned kNoKey = 0xffffffffu;

// a[k] without indexing registers by a runtime value
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int k) {
  int v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = k == i ? a[i] : v;
  return v;
}

// cur (H, W) u8, refs (R, HR, W) u8, v0 (R, n, 2) i32 -> out (R, n, 2) i32
// offsets (x, y) of the winning candidate from the block.  A warp takes a
// block and REFS references (3, or 1 on a level of few blocks).  `words`:
// W is a multiple of 4 and the planes are word-aligned.  Row shards: cur's
// row 0 is row ref_off of the reference planes (a strip of HR rows, read
// clamped into the strip) and row row0 of a frame of full_h rows, which
// bounds the candidates; a whole plane is HR = full_h = H, ref_off = row0
// = 0.
template <int REFS>
__global__ void __launch_bounds__(kFpWarps * 32)
    fullpel_kernel(const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ refs,
                   const int* __restrict__ v0, int* __restrict__ out, int R,
                   int W, int H, int HR, int ref_off, int row0, int full_h,
                   int penalty, int words) {
  __shared__ uint32_t s_px[kFpWarps][2 * REFS * 12 * 3];  // 12 x 12 bytes
  __shared__ int4 s_col[kFpWarps][2 * REFS * kColWin];
  __shared__ int4 s_cur[kFpWarps][16];  // column stage (qr, x): qr * 8 + x
  __shared__ int4 s_g[kFpWarps][16];    // both stages (quadrant, i): q * 4 + i
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbx = W >> 3, n = nbx * (H >> 3);
  const int job = blockIdx.x * kFpWarps + warp;
  if (job >= n * ((R + REFS - 1) / REFS)) return;   // whole warps
  const int b = job % n, r0 = (job / n) * REFS;
  const int cx = (b % nbx) * 8, cy = (b / nbx) * 8;
  // the warp's references; one past R repeats the last and stores nothing
  int ref[REFS], vx[REFS], vy[REFS];
#pragma unroll
  for (int k = 0; k < REFS; ++k) {
    ref[k] = min(r0 + k, R - 1);
    vx[k] = v0[2 * (ref[k] * n + b)];
    vy[k] = v0[2 * (ref[k] * n + b) + 1];
  }

  // Stage: window 2k (around reference k's v0) and 2k + 1 (around zero),
  // 12 rows of 12 bytes from (-2, -2), every read clamped into the plane;
  // a row that lies inside the plane is three words cut from four.
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const int item = lane + 32 * it;
    if (item < 2 * REFS * 12) {
      const int win = item / 12, row = item % 12, k = win >> 1;
      const bool at_v = (win & 1) == 0;
      const int ox = cx - 2 + (at_v ? pick(vx, k) : 0);
      const int oy = clampi(
          cy - 2 + row + ref_off + (at_v ? pick(vy, k) : 0), 0, HR - 1);
      const uint8_t* p =
          refs + (size_t)pick(ref, k) * W * HR + (size_t)oy * W;
      uint32_t o[3];
      if (words && ox >= 0 && ox + 12 <= W) {
        const int x0 = ox & ~3, sh = 8 * (ox & 3);
        const uint32_t* q = reinterpret_cast<const uint32_t*>(p + x0);
        const uint32_t q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
        const uint32_t q3 = x0 + 12 < W ? __ldg(q + 3) : 0u;
        o[0] = __funnelshift_r(q0, q1, sh);
        o[1] = __funnelshift_r(q1, q2, sh);
        o[2] = __funnelshift_r(q2, q3, sh);
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          uint32_t w = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            w |= (uint32_t)p[clampi(ox + 4 * j + c, 0, W - 1)] << (8 * c);
          o[j] = w;
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) s_px[warp][item * 3 + j] = o[j];
    }
  }
  if (lane < 16) {           // the current block's column stage
    const uint8_t* p =
        cur + (size_t)(cy + 4 * (lane >> 3)) * W + cx + (lane & 7);
    s_cur[warp][lane] = c4_stage(p[0], p[W], p[2 * W], p[3 * W]);
  }
  __syncwarp();
  if (lane < 16) {           // ... and its row stage: quadrant q, row i
    const int q = lane >> 2, i = lane & 3;
    const int4* c = &s_cur[warp][(q >> 1) * 8 + (q & 1) * 4];
    int u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4 v = c[j];
      u[j] = i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
    }
    s_g[warp][lane] = c4_stage(u[0], u[1], u[2], u[3]);
  }
  // The windows' column stage: rows r..r+3 of column x for r = 0..8 (every
  // quadrant of every candidate starts on one of them), x = 0..11; a lane
  // takes one window column and slides down its 12 pixels.
#pragma unroll
  for (int it = 0; it < (2 * REFS * 12 + 31) / 32; ++it) {
    const int item = lane + 32 * it;
    if (item < 2 * REFS * 12) {
      const int win = item / 12, x = item % 12;
      const uint8_t* p =
          reinterpret_cast<const uint8_t*>(s_px[warp]) + win * 144 + x;
      int v[12];
#pragma unroll
      for (int r = 0; r < 12; ++r) v[r] = p[12 * r];
      int4* o = &s_col[warp][win * kColWin + x];
#pragma unroll
      for (int r = 0; r < 9; ++r)
        o[r * kColPitch] = c4_stage(v[r], v[r + 1], v[r + 2], v[r + 3]);
    }
  }
  __syncwarp();

  // Candidates: c = lane + 32k of the warp's 50 * REFS (reference c / 50,
  // window 1 at v0 and window 0 at zero, 25 each, dy-major).  Per candidate
  // the offset of its top-left column-stage entry and what its cost gets
  // added: the penalty, or -1 for a block that leaves the plane.
  constexpr int kRounds = (REFS * 50 + 31) / 32;
  int at[kRounds], add[kRounds], cost[kRounds];
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = min(lane + 32 * k, REFS * 50 - 1);
    const int rk = c / 50, w = (c % 50) / 25, d = c % 25;
    const int dx = d % 5 - 2, dy = d / 5 - 2;
    const int vxr = pick(vx, rk), vyr = pick(vy, rk);
    const int wx = w == 0 ? vxr : 0, wy = w == 0 ? vyr : 0;
    const int px = cx + wx + dx, py = cy + wy + dy;
    at[k] = (2 * rk + w) * kColWin + (dy + 2) * kColPitch + dx + 2;
    add[k] = (px >= 0 && px <= W - 8 && py + row0 >= 0 &&
              py + row0 <= full_h - 8)
                 ? (penalty ? (abs(wx + dx - vxr) + abs(wy + dy - vyr)) * kPen
                            : 0)
                 : -1;
    cost[k] = 0;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 g[4] = {s_g[warp][4 * q], s_g[warp][4 * q + 1],
                       s_g[warp][4 * q + 2], s_g[warp][4 * q + 3]};
    const int qo = (q >> 1) * 4 * kColPitch + (q & 1) * 4;
#pragma unroll
    for (int k = 0; k < kRounds; ++k)
      cost[k] += quad_cost_t(&s_col[warp][at[k] + qo], g);
  }

  // The earliest minimum per reference over keys (cost << 6 | index in the
  // reference), a block outside the plane as the largest cost field: exact
  // while cost + penalty stays below 2^26 - 2 (|v0| below 2^20 pels).
  unsigned best[REFS];
#pragma unroll
  for (int r = 0; r < REFS; ++r) best[r] = kNoKey;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = lane + 32 * k, rk = c / 50;
    const unsigned field =
        add[k] < 0 ? (1u << 26) - 1
                   : min((unsigned)(cost[k] + add[k]), (1u << 26) - 2);
    const unsigned key =
        c < REFS * 50 ? field << 6 | (unsigned)(c % 50) : kNoKey;
#pragma unroll
    for (int r = 0; r < REFS; ++r)
      if (rk == r) best[r] = min(best[r], key);
  }
#pragma unroll
  for (int r = 0; r < REFS; ++r) {
    const unsigned m = __reduce_min_sync(0xffffffffu, best[r]);
    if (lane == r && r0 + r < R) {
      const int idx = m & 63, w = idx / 25, d = idx % 25;
      const int o = 2 * (ref[r] * n + b);
      out[o] = (w == 0 ? vx[r] : 0) + d % 5 - 2;
      out[o + 1] = (w == 0 ? vy[r] : 0) + d / 5 - 2;
    }
  }
}

// Six-tap phases as dp4a operands: taps 0..3 and taps 4, 5 as signed bytes.
// Quarter-pel phase 1, 2, 3 is row 2, 4, 6 of tables.SIXTAP_FILTERS; phase 0
// is the copy, as 64 x with (s + 32) >> 6.
__host__ __device__ constexpr uint32_t taps4(int a, int b, int c, int d) {
  return (uint32_t)(a & 255) | (uint32_t)(b & 255) << 8 |
         (uint32_t)(c & 255) << 16 | (uint32_t)(d & 255) << 24;
}
__host__ __device__ constexpr uint32_t taps_lo(int ph) {
  return ph == 0 ? taps4(0, 0, 64, 0)
                 : (ph == 1 ? taps4(2, -11, 108, 36)
                            : (ph == 2 ? taps4(3, -16, 77, 77)
                                       : taps4(1, -8, 36, 108)));
}
__host__ __device__ constexpr uint32_t taps_hi(int ph) {
  return ph == 0 ? taps4(0, 0, 0, 0)
                 : (ph == 1 ? taps4(-8, 1, 0, 0)
                            : (ph == 2 ? taps4(-16, 3, 0, 0)
                                       : taps4(-11, 2, 0, 0)));
}

// sum of four unsigned bytes of px times four signed bytes of taps, plus acc
__device__ __forceinline__ int dp4a_us(uint32_t px, uint32_t taps, int acc) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;"
      : "=r"(d) : "r"(px), "r"(taps), "r"(acc));
  return d;
}

// Four bytes at p: one word where the plane's rows are word-aligned.
__device__ __forceinline__ uint32_t load4(const uint8_t* p, bool words) {
  if (words) return __ldg(reinterpret_cast<const uint32_t*>(p));
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
         (uint32_t)p[3] << 24;
}

constexpr int kWinPitch = 5;            // words between window rows (20 bytes)
constexpr int kWinWords = 16 * kWinPitch + 2;
constexpr int kSlot = 9;                // uint4 between pass slots (8 columns)

// One horizontal pass of the staged window (rows -3..+10 of the full-pel
// base, 16 columns from -3) into slot DI, transposed: column j's 14 rows in
// the 16 bytes of slot[j].  Lane = (column j, row group g): four rows, one
// word.  DX = DI - 2 quarter pels: whole-pel offset XO, phase DX & 3.
template <int DI>
__device__ __forceinline__ void hpass(const uint32_t* win, uint32_t* slots,
                                      int lane) {
  constexpr int DX = DI - 2, XO = DX < 0 ? 0 : 1, PH = DX & 3;
  const int j = lane >> 2, g = lane & 3;
  const int o = XO + j, sh = 8 * (o & 3);
  const uint32_t* rp = win + 4 * g * kWinPitch + (o >> 2);
  uint32_t word = 0;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const uint32_t a = rp[rr * kWinPitch], b = rp[rr * kWinPitch + 1],
                   c = rp[rr * kWinPitch + 2];
    const uint32_t lo = __funnelshift_r(a, b, sh);     // bytes o .. o+3
    int v;
    if (PH == 0) {
      v = (lo >> 16) & 255;                            // tap 2: the pixel
    } else {
      const uint32_t hi = __funnelshift_r(b, c, sh);   // bytes o+4 .. o+7
      v = dp4a_us(hi, taps_hi(PH), dp4a_us(lo, taps_lo(PH), 64)) >> 7;
      v = min(max(v, 0), 255);
    }
    word |= (uint32_t)v << (8 * rr);
  }
  slots[DI * kSlot * 4 + lane] = word;
}

// cur (H, W) u8, refs (R, HR, W) u8, fv (R, n, 2) i32 full-pel vectors ->
// vec (R, n, 2) i32 qpel, cost (R, n) i32, pred (R, n, 64) u8.  `words`:
// W is a multiple of 4 and the planes are word-aligned.  ref_off, row0,
// full_h: row shards as in fullpel_kernel, the bounds in quarter pels.
// Three CTAs an SM: 80 registers, no spills, 24 warps to hide the latency of the dependent
// filter and transform chains (unbounded it takes 86 and two CTAs fit, 10%
// slower; at four, 64 registers, it spills and is slower again).
__global__ void __launch_bounds__(kWarps * 32, 3)
    qpel_kernel(const uint8_t* __restrict__ cur,
                const uint8_t* __restrict__ refs, const int* __restrict__ fv,
                int* __restrict__ vec_out, int* __restrict__ cost_out,
                uint8_t* __restrict__ pred_out, int R, int W, int H,
                int HR, int ref_off, int row0, int full_h, int words) {
  __shared__ uint32_t s_win[kWarps][kWinWords];  // 16 rows x 20 bytes
  __shared__ uint4 s_h[kWarps][6 * kSlot];       // 5 H passes + zero vector
  __shared__ int4 s_cur[kWarps][16];             // current block, int32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbx = W >> 3, n = nbx * (H >> 3);
  const int job = blockIdx.x * kWarps + warp;
  if (job >= R * n) return;            // whole warps only: no CTA barrier
  const int b = job % n;
  const uint8_t* ref = refs + (size_t)(job / n) * W * HR;
  const int cx = (b % nbx) * 8, cy = (b / nbx) * 8;
  const int fx = fv[2 * job], fy = fv[2 * job + 1];

  // Stage: the 14x14 window (16 columns are read; every read clamped into
  // the plane), the current block as int32, and the zero-vector block as
  // slot 5 in the passes' layout (column j's rows 0..7 at bytes 2..9, where
  // phase 0 of the vertical pass finds them).
  {
    uint8_t* wb = reinterpret_cast<uint8_t*>(s_win[warp]);
    const int col = lane & 15, rsub = lane >> 4;
    const int xx = clampi(cx + fx - 3 + col, 0, W - 1);
#pragma unroll
    for (int it = 0; it < 7; ++it) {
      const int row = 2 * it + rsub;
      const int yy = clampi(cy + fy - 3 + row + ref_off, 0, HR - 1);
      wb[row * (4 * kWinPitch) + col] = ref[(size_t)yy * W + xx];
    }
    const int r = (lane & 15) >> 1, half = lane & 1;
    const size_t at = (size_t)(cy + r) * W + cx + 4 * half;
    if (lane < 16) {
      const uint32_t w = load4(cur + at, words);
      s_cur[warp][lane] = make_int4(w & 255, (w >> 8) & 255, (w >> 16) & 255,
                                    w >> 24);
    } else {
      const uint32_t w = load4(ref + at + (size_t)ref_off * W, words);
      uint8_t* zb = reinterpret_cast<uint8_t*>(s_h[warp] + 5 * kSlot);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        zb[(4 * half + k) * 16 + 2 + r] = (uint8_t)(w >> (8 * k));
    }
  }
  __syncwarp();
  {
    uint32_t* slots = reinterpret_cast<uint32_t*>(s_h[warp]);
    hpass<0>(s_win[warp], slots, lane);
    hpass<1>(s_win[warp], slots, lane);
    hpass<2>(s_win[warp], slots, lane);
    hpass<3>(s_win[warp], slots, lane);
    hpass<4>(s_win[warp], slots, lane);
  }
  __syncwarp();

  // Candidate c = lane: 0..24 the quarter-pel offsets (dy-major), 25 the
  // zero vector; lanes above repeat 25 and never win.
  const int c = lane < 25 ? lane : 25;
  const int dx = c < 25 ? c % 5 - 2 : 0, dy = c < 25 ? c / 5 - 2 : 0;
  const int slot = c < 25 ? c % 5 : 5;
  const int ph = dy & 3;
  const int ysh = (c < 25 && dy >= 0) ? 8 : 0;   // whole-pel row offset 1
  const uint32_t t_lo = taps_lo(ph), t_hi = taps_hi(ph);
  const int rnd = ph == 0 ? 32 : 64, shr = ph == 0 ? 6 : 7;

  // Vertical pass: prediction row i, columns 4h..4h+3 in P[i][h].
  uint32_t P[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 q = s_h[warp][slot * kSlot + j];
    uint32_t a[4] = {__funnelshift_r(q.x, q.y, ysh),
                     __funnelshift_r(q.y, q.z, ysh),
                     __funnelshift_r(q.z, q.w, ysh), q.w >> ysh};
    uint32_t w[12];                    // bytes k .. k+3 of the column
#pragma unroll
    for (int k = 0; k < 12; ++k)
      w[k] = (k & 3) == 0 ? a[k >> 2]
                          : __funnelshift_r(a[k >> 2], a[(k >> 2) + 1],
                                            8 * (k & 3));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int v = dp4a_us(w[i + 4], t_hi, dp4a_us(w[i], t_lo, rnd)) >> shr;
      v = min(max(v, 0), 255);
      if ((j & 3) == 0)
        P[i][j >> 2] = (uint32_t)v;
      else
        P[i][j >> 2] |= (uint32_t)v << (8 * (j & 3));
    }
  }

  // Cost against the current block, quadrant by quadrant.
  int cost = 0;
#pragma unroll
  for (int qd = 0; qd < 4; ++qd) {
    const int qr = qd >> 1, qc = qd & 1;
    int x[16];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int4 cw = s_cur[warp][(4 * qr + rr) * 2 + qc];
      const uint32_t pw = P[4 * qr + rr][qc];
      x[rr * 4 + 0] = (int)(pw & 255) - cw.x;
      x[rr * 4 + 1] = (int)((pw >> 8) & 255) - cw.y;
      x[rr * 4 + 2] = (int)((pw >> 16) & 255) - cw.z;
      x[rr * 4 + 3] = (int)(pw >> 24) - cw.w;
    }
    cost += quad_cost_res(x);
  }
  const int pen = (abs(dx) + abs(dy)) * kPen;    // 0 for the zero vector
  const int px = (cx + fx) * 4 + dx, py = (cy + fy) * 4 + dy;
  const int gy = py + 4 * row0;
  const bool valid = c == 25 || (px >= 0 && px <= W * 4 - 32 && gy >= 0 &&
                                 gy <= full_h * 4 - 32);
  unsigned key = valid ? ((unsigned)(cost + pen) << 5) : 0x7fffffe0u;
  key = lane < 26 ? (key | (unsigned)lane) : 0xffffffffu;
  const unsigned best = __reduce_min_sync(0xffffffffu, key);

  if (key == best) {                   // the winning lane stores its own
    int vx = 0, vy = 0;
    if (c < 25) {
      vx = fx * 4 + dx;
      vy = fy * 4 + dy;
    }
    vec_out[2 * job] = vx;
    vec_out[2 * job + 1] = vy;
    // the penalty comes back out for a nonzero winner
    cost_out[job] = (vx != 0 || vy != 0) ? cost : cost + pen;
    uint4* po = reinterpret_cast<uint4*>(pred_out + (size_t)job * 64);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      po[k] = make_uint4(P[2 * k][0], P[2 * k][1], P[2 * k + 1][0],
                         P[2 * k + 1][1]);
  }
}

int grid_for(int jobs) { return (jobs + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int vp8_fullpel_search(const void* cur, const void* refs,
                                  const void* v0, void* out, int R, int W,
                                  int H, int HR, int ref_off, int row0,
                                  int full_h, int penalty, void* stream) {
  const int n = (W / 8) * (H / 8);
  // word loads where every row of every plane starts on a word
  const int words = W % 4 == 0 && (uintptr_t)refs % 4 == 0;
  if (n < kFewBlocks)
    fullpel_kernel<1><<<(R * n + kFpWarps - 1) / kFpWarps, kFpWarps * 32, 0,
                        (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)refs, (const int*)v0,
        (int*)out, R, W, H, HR, ref_off, row0, full_h, penalty, words);
  else
    fullpel_kernel<3><<<((R + 2) / 3 * n + kFpWarps - 1) / kFpWarps,
                        kFpWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)cur, (const uint8_t*)refs, (const int*)v0,
        (int*)out, R, W, H, HR, ref_off, row0, full_h, penalty, words);
  return (int)cudaGetLastError();
}

extern "C" int vp8_qpel_search(const void* cur, const void* refs,
                               const void* fv, void* vec, void* cost,
                               void* pred, int R, int W, int H, int HR,
                               int ref_off, int row0, int full_h,
                               void* stream) {
  const int jobs = R * (W / 8) * (H / 8);
  // word loads where every row of every plane starts on a word
  const int words = W % 4 == 0 && (uintptr_t)cur % 4 == 0 &&
                    (uintptr_t)refs % 4 == 0;
  if ((uintptr_t)pred % 16) return (int)cudaErrorMisalignedAddress;
  qpel_kernel<<<grid_for(jobs), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)refs, (const int*)fv, (int*)vec,
      (int*)cost, (uint8_t*)pred, R, W, H, HR, ref_off, row0, full_h, words);
  return (int)cudaGetLastError();
}
