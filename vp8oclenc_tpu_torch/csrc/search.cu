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
// What bounds it: integer operations.  A full-pel candidate costs ~724 int
// ops (64 residuals, four separable 4x4 cost transforms, abs and sums) and
// reads a 12x12 window that every candidate of its block shares; a qpel
// candidate ~3.6k (the 8x8 vertical six-tap pass on top of the shared
// horizontal passes, then the cost).  Bytes are a few hundred per block.
//
// Design: one warp per (reference, 8x8 block); 8 warps per CTA.  The warp
// stages the current block and its windows in shared memory with every
// read clamped into the plane (equal to the JAX package's edge-replicated
// apron), then each lane takes one candidate (full pel: lanes take
// candidates lane and lane + 32 of the 50; qpel: lanes 0..24 the qpel
// candidates, lane 25 the zero vector), computes its cost in exact int32
// (|C4.X.C4^T|, separable, as csrc/intra.cu), and the warp reduces
// (cost, index) lexicographically with shuffles, so ties go to the earliest
// candidate as in the plain versions.  The qpel kernel computes the 5
// horizontal six-tap passes once per block and shares them across the 5
// vertical phases; each lane's prediction stays in shared memory so the
// winner's 64 pixels are written out without recomputing them.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // (reference, block) jobs per CTA
constexpr int kBig = 1 << 28;      // cost of a candidate outside the frame
constexpr int kPen = 32;           // VECTOR_DIFF_WEIGHT / 2

__constant__ int kSixtap[8][6] = {
    {0, 0, 128, 0, 0, 0},    {0, -6, 123, 12, -1, 0},
    {2, -11, 108, 36, -8, 1}, {0, -9, 93, 50, -6, 0},
    {3, -16, 77, 77, -16, 3}, {0, -6, 50, 93, -9, 0},
    {1, -8, 36, 108, -11, 2}, {0, -1, 12, 123, -6, 0}};

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

// dct_weight of the 4x4 residual a - b (row strides sa, sb).
__device__ __forceinline__ int quad_cost(const uint8_t* a, int sa,
                                         const uint8_t* b, int sb) {
  int t[16];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    int col[4];
    cost_c4(a[l] - b[l], a[sa + l] - b[sb + l], a[2 * sa + l] - b[2 * sb + l],
            a[3 * sa + l] - b[3 * sb + l], col);
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

// cur (H, W) u8, refs (R, H, W) u8, fv (R, n, 2) i32 full-pel vectors ->
// vec (R, n, 2) i32 qpel, cost (R, n) i32, pred (R, n, 64) u8.
__global__ void __launch_bounds__(kWarps * 32)
    qpel_kernel(const uint8_t* __restrict__ cur,
                const uint8_t* __restrict__ refs, const int* __restrict__ fv,
                int* __restrict__ vec_out, int* __restrict__ cost_out,
                uint8_t* __restrict__ pred_out, int R, int W, int H) {
  __shared__ uint8_t s_cur[kWarps][64];
  __shared__ uint8_t s_win[kWarps][14 * 14];   // rows/cols -3..+10 of base
  __shared__ uint8_t s_h[kWarps][5][14 * 8];   // H pass per horizontal dx
  __shared__ uint8_t s_pred[kWarps][26][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nbx = W >> 3, n = nbx * (H >> 3);
  const int job = blockIdx.x * kWarps + warp;
  if (job >= R * n) return;
  const int b = job % n;
  const uint8_t* ref = refs + (size_t)(job / n) * W * H;
  const int cx = (b % nbx) * 8, cy = (b / nbx) * 8;
  const int fx = fv[2 * job], fy = fv[2 * job + 1];
  const int bx0 = cx + fx, by0 = cy + fy;

  for (int i = lane; i < 64; i += 32)
    s_cur[warp][i] = cur[(cy + (i >> 3)) * W + cx + (i & 7)];
  for (int i = lane; i < 196; i += 32) {
    const int yy = clampi(by0 - 3 + i / 14, 0, H - 1);
    const int xx = clampi(bx0 - 3 + i % 14, 0, W - 1);
    s_win[warp][i] = ref[yy * W + xx];
  }
  __syncwarp();
  for (int i = lane; i < 5 * 112; i += 32) {
    const int di = i / 112, k = i % 112, row = k >> 3, j = k & 7;
    const int dx = di - 2, xo = (dx >> 2) + 1;
    const int* t = kSixtap[(dx & 3) * 2];
    const uint8_t* p = &s_win[warp][row * 14 + xo + j];
    int s = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) s += t[m] * p[m];
    s_h[warp][di][k] = (uint8_t)clampi((s + 64) >> 7, 0, 255);
  }
  __syncwarp();

  int cost = INT_MAX;
  uint8_t* pr = s_pred[warp][lane < 26 ? lane : 0];
  if (lane < 25) {
    const int dx = lane % 5 - 2, dy = lane / 5 - 2, yo = (dy >> 2) + 1;
    const int* t = kSixtap[(dy & 3) * 2];
    const uint8_t* h = s_h[warp][dx + 2];
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int s = 0;
#pragma unroll
        for (int m = 0; m < 6; ++m) s += t[m] * h[(yo + i + m) * 8 + j];
        pr[i * 8 + j] = (uint8_t)clampi((s + 64) >> 7, 0, 255);
      }
    const int px = (cx + fx) * 4 + dx, py = (cy + fy) * 4 + dy;
    cost = (px < 0 || px > W * 4 - 32 || py < 0 || py > H * 4 - 32)
               ? kBig
               : cost8x8(pr, 8, s_cur[warp], 8) + (abs(dx) + abs(dy)) * kPen;
  } else if (lane == 25) {                     // the zero vector, no penalty
    for (int i = 0; i < 64; ++i)
      pr[i] = ref[(cy + (i >> 3)) * W + cx + (i & 7)];
    cost = cost8x8(pr, 8, s_cur[warp], 8);
  }
  int idx = lane;
  warp_min(cost, idx);
  __syncwarp();

  int vx = 0, vy = 0;
  if (idx < 25) {
    vx = fx * 4 + idx % 5 - 2;
    vy = fy * 4 + idx / 5 - 2;
  }
  if (lane == 0) {
    vec_out[2 * job] = vx;
    vec_out[2 * job + 1] = vy;
    cost_out[job] = cost - ((vx != 0 || vy != 0)
                                ? (abs(vx - fx * 4) + abs(vy - fy * 4)) * kPen
                                : 0);
  }
  const uint8_t* win = s_pred[warp][idx];
  for (int i = lane; i < 64; i += 32) pred_out[(size_t)job * 64 + i] = win[i];
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
  qpel_kernel<<<grid_for(jobs), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cur, (const uint8_t*)refs, (const int*)fv, (int*)vec,
      (int*)cost, (uint8_t*)pred, R, W, H);
  return (int)cudaGetLastError();
}
