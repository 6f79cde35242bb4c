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
// clock.  A full-pel candidate costs ~724 integer
// operations (64 residuals, four separable 4x4 cost transforms, abs and
// sums) and reads a 12x12 window that every candidate of its block shares;
// a qpel candidate adds its 8x8 vertical six-tap pass on top of the
// horizontal passes its block shares.  Bytes are a few hundred per block.
//
// Both kernels: one warp per (reference, 8x8 block), 8 warps per CTA.  The
// warp stages the current block and its windows in shared memory with
// every read clamped into the plane (equal to the JAX package's
// edge-replicated apron), each lane takes candidates, computes their cost
// in exact int32 (|C4.X.C4^T|, separable, as csrc/intra.cu), and the warp
// takes the minimum of (cost, index), so ties go to the earliest candidate
// as in the plain versions.
//
// Full pel (`fullpel_kernel`): lanes take candidates lane and lane + 32 of
// the 50 and read residuals byte by byte from the shared windows.
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
#include <climits>
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

// dct_weight of the 4x4 residual a - b (row strides sa, sb).
__device__ __forceinline__ int quad_cost(const uint8_t* a, int sa,
                                         const uint8_t* b, int sb) {
  int x[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) x[i * 4 + l] = a[i * sa + l] - b[i * sb + l];
  return quad_cost_res(x);
}

// dct_cost_8x8: the four quadrants' costs, each shifted before the sum.
__device__ __forceinline__ int cost8x8(const uint8_t* a, int sa,
                                       const uint8_t* b, int sb) {
  return quad_cost(a, sa, b, sb) + quad_cost(a + 4, sa, b + 4, sb) +
         quad_cost(a + 4 * sa, sa, b + 4 * sb, sb) +
         quad_cost(a + 4 * sa + 4, sa, b + 4 * sb + 4, sb);
}

// Lexicographic (cost, index) minimum over the warp; every lane gets it.
__device__ __forceinline__ void warp_min(int& cost, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    int oc = __shfl_xor_sync(0xffffffffu, cost, off);
    int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (oc < cost || (oc == cost && oi < idx)) {
      cost = oc;
      idx = oi;
    }
  }
}

// cur (H, W) u8, refs (R, H, W) u8, v0 (R, n, 2) i32 -> out (R, n, 2) i32
// offsets (x, y) of the winning candidate from the block.
__global__ void __launch_bounds__(kWarps * 32)
    fullpel_kernel(const uint8_t* __restrict__ cur,
                   const uint8_t* __restrict__ refs,
                   const int* __restrict__ v0, int* __restrict__ out, int R,
                   int W, int H, int penalty) {
  __shared__ uint8_t s_cur[kWarps][64];
  __shared__ uint8_t s_win[kWarps][2][144];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbx = W >> 3, n = nbx * (H >> 3);
  const int job = blockIdx.x * kWarps + warp;
  if (job >= R * n) return;            // whole warps only: no CTA barrier
  const int b = job % n;
  const uint8_t* ref = refs + (size_t)(job / n) * W * H;
  const int cx = (b % nbx) * 8, cy = (b / nbx) * 8;
  const int vx = v0[2 * job], vy = v0[2 * job + 1];

  for (int i = lane; i < 64; i += 32)
    s_cur[warp][i] = cur[(cy + (i >> 3)) * W + cx + (i & 7)];
  for (int i = lane; i < 288; i += 32) {
    const int w = i / 144, k = i % 144;       // window 1 at v0, window 0 at 0
    const int yy = clampi(cy + (w == 0 ? vy : 0) - 2 + k / 12, 0, H - 1);
    const int xx = clampi(cx + (w == 0 ? vx : 0) - 2 + k % 12, 0, W - 1);
    s_win[warp][w][k] = ref[yy * W + xx];
  }
  __syncwarp();

  int best = INT_MAX, best_idx = 64;
  for (int c = lane; c < 50; c += 32) {       // increasing: strict < keeps
    const int w = c / 25, d = c % 25;         // the earliest of the lane's
    const int dx = d % 5 - 2, dy = d / 5 - 2;
    const int px = cx + (w == 0 ? vx : 0) + dx;
    const int py = cy + (w == 0 ? vy : 0) + dy;
    int cost = kBig;
    if (px >= 0 && px <= W - 8 && py >= 0 && py <= H - 8) {
      cost = cost8x8(&s_win[warp][w][(dy + 2) * 12 + dx + 2], 12,
                     s_cur[warp], 8);
      if (penalty) cost += (abs(px - cx - vx) + abs(py - cy - vy)) * kPen;
    }
    if (cost < best) {
      best = cost;
      best_idx = c;
    }
  }
  warp_min(best, best_idx);
  if (lane == 0) {
    const int w = best_idx / 25, d = best_idx % 25;
    out[2 * job] = (w == 0 ? vx : 0) + d % 5 - 2;
    out[2 * job + 1] = (w == 0 ? vy : 0) + d / 5 - 2;
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

// cur (H, W) u8, refs (R, H, W) u8, fv (R, n, 2) i32 full-pel vectors ->
// vec (R, n, 2) i32 qpel, cost (R, n) i32, pred (R, n, 64) u8.  `words`:
// W is a multiple of 4 and the planes are word-aligned.  Three CTAs an SM:
// 80 registers, no spills, 24 warps to hide the latency of the dependent
// filter and transform chains (unbounded it takes 86 and two CTAs fit, 10%
// slower; at four, 64 registers, it spills and is slower again).
__global__ void __launch_bounds__(kWarps * 32, 3)
    qpel_kernel(const uint8_t* __restrict__ cur,
                const uint8_t* __restrict__ refs, const int* __restrict__ fv,
                int* __restrict__ vec_out, int* __restrict__ cost_out,
                uint8_t* __restrict__ pred_out, int R, int W, int H,
                int words) {
  __shared__ uint32_t s_win[kWarps][kWinWords];  // 16 rows x 20 bytes
  __shared__ uint4 s_h[kWarps][6 * kSlot];       // 5 H passes + zero vector
  __shared__ int4 s_cur[kWarps][16];             // current block, int32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbx = W >> 3, n = nbx * (H >> 3);
  const int job = blockIdx.x * kWarps + warp;
  if (job >= R * n) return;            // whole warps only: no CTA barrier
  const int b = job % n;
  const uint8_t* ref = refs + (size_t)(job / n) * W * H;
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
      const int yy = clampi(cy + fy - 3 + row, 0, H - 1);
      wb[row * (4 * kWinPitch) + col] = ref[(size_t)yy * W + xx];
    }
    const int r = (lane & 15) >> 1, half = lane & 1;
    const size_t at = (size_t)(cy + r) * W + cx + 4 * half;
    if (lane < 16) {
      const uint32_t w = load4(cur + at, words);
      s_cur[warp][lane] = make_int4(w & 255, (w >> 8) & 255, (w >> 16) & 255,
                                    w >> 24);
    } else {
      const uint32_t w = load4(ref + at, words);
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
  const bool valid = c == 25 || (px >= 0 && px <= W * 4 - 32 && py >= 0 &&
                                 py <= H * 4 - 32);
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
                                  int H, int penalty, void* stream) {
  const int jobs = R * (W / 8) * (H / 8);
  fullpel_kernel<<<grid_for(jobs), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)refs, (const int*)v0, (int*)out, R,
      W, H, penalty);
  return (int)cudaGetLastError();
}

extern "C" int vp8_qpel_search(const void* cur, const void* refs,
                               const void* fv, void* vec, void* cost,
                               void* pred, int R, int W, int H, void* stream) {
  const int jobs = R * (W / 8) * (H / 8);
  // word loads where every row of every plane starts on a word
  const int words = W % 4 == 0 && (uintptr_t)cur % 4 == 0 &&
                    (uintptr_t)refs % 4 == 0;
  if ((uintptr_t)pred % 16) return (int)cudaErrorMisalignedAddress;
  qpel_kernel<<<grid_for(jobs), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)refs, (const int*)fv, (int*)vec,
      (int*)cost, (uint8_t*)pred, R, W, H, words);
  return (int)cudaGetLastError();
}
