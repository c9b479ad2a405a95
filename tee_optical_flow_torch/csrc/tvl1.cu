// TV-L1 primal-dual kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tee_optical_flow_torch/ops/cuda_lib.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  ops/tvl1_pallas.py::_fused_scale_kernel (entry tvl1_outer_loop_pallas)
//       one frame pair's whole per-warp outer loop, VMEM-resident, with the
//       5x5 median (med5) and the per-pair epsilon stop inside;
//   K2  ops/tvl1_pallas.py::_inner_block_kernel (entry tvl1_inner_block_pallas)
//       n_iters primal-dual steps on halo-tiled row slabs.
//
// K1 is outer_loop_kernel: ONE persistent cooperative launch per call
// (tvl1_outer_loop below) that runs the whole loop on the device,
// outer_iters x [median of u and v, then inner_iters fused steps], with
// a grid-wide barrier (cooperative_groups grid sync) after every phase.
//   * What bounds it: the bytes of the active pair-steps. The TPU kept a
//     pair's 11 planes (13.5 MB at 480x640) in VMEM; here a block has 227
//     KB of shared memory and the card 50 MB of L2, so every step streams
//     its pair's planes through HBM: 11 planes read, 6 written, 68 B per
//     pixel, plus a grid barrier per phase (two per step with the stop).
//   * What the design does about it: each step is ONE fused primal+dual
//     pass over 32x16 tiles. The primal runs over the tile plus its right
//     column and bottom row (the halo, recomputed with the same arithmetic,
//     so the same bits) into shared memory, and the dual reads its
//     neighbours from there; the two-launch step K2 keeps moves 92 B per
//     pixel. The five constant planes come through the read-only path.
//     The six state planes ping-pong between two buffers per pair
//     (neighbouring tiles read each other's old u, v, p as halo, so an
//     in-place update would race); each block tracks every pair's buffer
//     parity in shared memory, and the last phase copies the pairs whose
//     state ended in the second buffer back into the first (the caller's).
//   * Frozen pairs cost nothing: after each barrier every block rebuilds the
//     same ordered list of active pairs from the per-pair error and walks
//     the (active pair, tile) work items in a grid-stride loop; the kernel
//     returns once no pair is active, as the plain version's loop ends.
//   * The stop is deterministic: each tile writes its sum of
//     (un-uo)^2+(vn-vo)^2 (a shuffle tree per warp, then over the warps) to
//     a fixed slot; after the step's barrier one block per active pair adds
//     the pair's slots in a fixed order into derr (no float atomics), and
//     after a second barrier every block takes err from there for the pairs
//     that ran. (The last tile of a pair reducing its slots behind a
//     per-pair atomic counter saves that barrier, but each tile then waits
//     for a fence and an atomic before the next: slower on the path.)
//   * The grid is every block that fits at once (occupancy x SMs), as a
//     cooperative launch requires; a refused launch is an error.
//
// K2 stays a launch train (ops/tvl1_kernels.py: n_iters x (primal_kernel,
// dual_kernel), one thread per pixel, state in place): it runs only on
// levels above K1's size rule, inside the two-quiet-blocks stop, and its
// redesign is later work. Its arithmetic is the same primal_px / dual_px
// as K1's, so a K1 step and a K2 step cannot drift apart.
// median5x5_kernel is the standalone median that the K2 levels call
// between blocks; K1's median phase uses the same median5x5_px.
//
// Parity: compile with --fmad=false and without --use_fast_math. Each
// expression below is written in the order of the plain PyTorch version
// (ops/tvl1_kernels.py) and the JAX reference, so each step is bitwise
// equal to them; the dual update keeps its division form.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define BLOCK_X 32
#define BLOCK_Y 8
#define BLOCK_THREADS (BLOCK_X * BLOCK_Y)
// K1's tile: 32 columns x 16 rows, two rows per thread
#define TILE_W BLOCK_X
#define TILE_H 16
#define TILE_ROWS (TILE_H / BLOCK_Y)

namespace {

// -------------------------------------------------------------------------
// 5x5 median, edge-replicated: sort each of the 5 window columns with the
// sort-5 network, then select rank 12 of the 25 with the column-median
// network (ops/warp.py SORT5_NETWORK / COLUMN_MEDIAN_25_NETWORK, the same
// networks as the TPU kernel's med5). Min/max only: bit-exact.
// -------------------------------------------------------------------------

#define CE(w, i, j)                       \
  {                                       \
    float lo_ = fminf(w[i], w[j]);        \
    float hi_ = fmaxf(w[i], w[j]);        \
    w[i] = lo_;                           \
    w[j] = hi_;                           \
  }

// SORT5_NETWORK
#define SORT5(w) \
  CE(w, 0, 1) CE(w, 3, 4) CE(w, 2, 4) CE(w, 2, 3) CE(w, 0, 3) \
  CE(w, 0, 2) CE(w, 1, 4) CE(w, 1, 3) CE(w, 1, 2)

// COLUMN_MEDIAN_25_NETWORK, answer on wire 14
#define COLUMN_MEDIAN_25(w) \
  CE(w, 0, 5) CE(w, 4, 9) CE(w, 4, 5) CE(w, 2, 7) CE(w, 2, 4) CE(w, 7, 5) \
  CE(w, 1, 6) CE(w, 3, 8) CE(w, 3, 6) CE(w, 1, 2) CE(w, 3, 4) CE(w, 6, 7) \
  CE(w, 8, 5) CE(w, 10, 15) CE(w, 14, 19) CE(w, 14, 15) CE(w, 12, 17) \
  CE(w, 12, 14) CE(w, 17, 15) CE(w, 11, 16) CE(w, 13, 18) CE(w, 13, 16) \
  CE(w, 11, 12) CE(w, 13, 14) CE(w, 16, 17) CE(w, 18, 15) CE(w, 0, 10) \
  CE(w, 5, 15) CE(w, 5, 10) CE(w, 4, 14) CE(w, 4, 5) CE(w, 14, 10) \
  CE(w, 2, 12) CE(w, 7, 17) CE(w, 7, 12) CE(w, 7, 5) CE(w, 12, 14) \
  CE(w, 1, 11) CE(w, 9, 19) CE(w, 9, 11) CE(w, 6, 16) CE(w, 6, 9) \
  CE(w, 16, 11) CE(w, 3, 13) CE(w, 8, 18) CE(w, 8, 13) CE(w, 8, 9) \
  CE(w, 13, 16) CE(w, 8, 5) CE(w, 9, 12) CE(w, 13, 14) CE(w, 10, 20) \
  CE(w, 5, 10) CE(w, 14, 24) CE(w, 14, 10) CE(w, 15, 22) CE(w, 12, 15) \
  CE(w, 12, 14) CE(w, 11, 21) CE(w, 9, 11) CE(w, 16, 11) CE(w, 19, 23) \
  CE(w, 13, 19) CE(w, 8, 13) CE(w, 13, 16) CE(w, 13, 14)

// The median of plane f (H x W) at (x, y).
__device__ __forceinline__ float median5x5_px(const float* f, int x, int y,
                                              int H, int W) {
  int rows[5];
#pragma unroll
  for (int p = 0; p < 5; ++p) rows[p] = min(max(y + p - 2, 0), H - 1) * W;
  float w[25];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int xc = min(max(x + c - 2, 0), W - 1);
    float col[5];
#pragma unroll
    for (int p = 0; p < 5; ++p) col[p] = f[rows[p] + xc];
    SORT5(col)
#pragma unroll
    for (int p = 0; p < 5; ++p) w[c * 5 + p] = col[p];
  }
  COLUMN_MEDIAN_25(w)
  return w[14];
}

// -------------------------------------------------------------------------
// One primal-dual step, written once for K1 and K2.
// Primal: soft-thresholded data term, then u <- (u + d) + theta*div(p),
// with div(p) the backward differences of warp.divergence (p itself on the
// first row/column, -p[last-1] on the last). Dual: forward differences of
// the new u, v (zero past the last row/column), then
// p <- (p + taut*grad) / (1 + taut*|grad|).
// -------------------------------------------------------------------------

struct Primal {
  float uo, vo, un, vn;  // flow before and after the primal step
};

// The primal step at pixel i = (x, y) of H x W planes (the plane pointers
// point at the pair's planes, or i includes the pair's offset), given the
// pixel's constants: rho_c, I1w_x, I1w_y, th = l_t*|grad I1w|^2 and the
// guarded 1/|grad I1w|^2 (loaded by the caller).
__device__ __forceinline__ Primal primal_px(
    float rc, float ix, float iy, float t, float ig, const float* u,
    const float* v, const float* p11, const float* p12, const float* p21,
    const float* p22, size_t i, int x, int y, int H, int W, float l_t,
    float theta) {
  Primal q;
  q.uo = u[i];
  q.vo = v[i];
  const float rho = (rc + ix * q.uo) + iy * q.vo;
  const bool neg = rho < -t;
  const bool pos = rho > t;
  const float rg = rho * ig;
  const float ltx = l_t * ix;
  const float lty = l_t * iy;
  const float d1 = neg ? ltx : (pos ? -ltx : -rg * ix);
  const float d2 = neg ? lty : (pos ? -lty : -rg * iy);
  const float a11 = p11[i], a21 = p21[i];
  const float a12 = p12[i], a22 = p22[i];
  float dx1, dx2, dy1, dy2;
  if (x == 0) {
    dx1 = a11;
    dx2 = a21;
  } else if (x == W - 1) {
    dx1 = -p11[i - 1];
    dx2 = -p21[i - 1];
  } else {
    dx1 = a11 - p11[i - 1];
    dx2 = a21 - p21[i - 1];
  }
  if (y == 0) {
    dy1 = a12;
    dy2 = a22;
  } else if (y == H - 1) {
    dy1 = -p12[i - W];
    dy2 = -p22[i - W];
  } else {
    dy1 = a12 - p12[i - W];
    dy2 = a22 - p22[i - W];
  }
  q.un = (q.uo + d1) + theta * (dx1 + dy1);
  q.vn = (q.vo + d2) + theta * (dx2 + dy2);
  return q;
}

// The dual step of one pixel from the forward differences of the new flow;
// updates p11..p22 in the caller's registers.
__device__ __forceinline__ void dual_px(float ux, float uy, float vx,
                                        float vy, float taut, float& p11,
                                        float& p12, float& p21, float& p22) {
  const float ng1 = 1.0f + taut * sqrtf(ux * ux + uy * uy);
  const float ng2 = 1.0f + taut * sqrtf(vx * vx + vy * vy);
  p11 = (p11 + taut * ux) / ng1;
  p12 = (p12 + taut * uy) / ng1;
  p21 = (p21 + taut * vx) / ng2;
  p22 = (p22 + taut * vy) / ng2;
}

// -------------------------------------------------------------------------
// K2 and the standalone median: one thread per pixel, state in place.
// -------------------------------------------------------------------------

__global__ void median5x5_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int H, int W) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = (size_t)H * W;
  out[(size_t)b * plane + (size_t)y * W + x] =
      median5x5_px(in + (size_t)b * plane, x, y, H, W);
}

// u and v are updated in place: each thread reads only its own u, v, and
// p is read-only here.
__global__ void primal_kernel(const float* __restrict__ rho_c,
                              const float* __restrict__ i1wx,
                              const float* __restrict__ i1wy,
                              const float* __restrict__ th,
                              const float* __restrict__ inv_grad,
                              float* __restrict__ u, float* __restrict__ v,
                              const float* __restrict__ p11,
                              const float* __restrict__ p12,
                              const float* __restrict__ p21,
                              const float* __restrict__ p22, int H, int W,
                              float l_t, float theta) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)b * H * W + (size_t)y * W + x;
  const Primal q = primal_px(rho_c[i], i1wx[i], i1wy[i], th[i], inv_grad[i],
                             u, v, p11, p12, p21, p22, i, x, y, H, W, l_t,
                             theta);
  u[i] = q.un;
  v[i] = q.vn;
}

__global__ void dual_kernel(const float* __restrict__ u,
                            const float* __restrict__ v,
                            float* __restrict__ p11, float* __restrict__ p12,
                            float* __restrict__ p21, float* __restrict__ p22,
                            int H, int W, float taut) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t i = (size_t)b * H * W + (size_t)y * W + x;
  const float uc = u[i];
  const float vc = v[i];
  const float ux = (x < W - 1) ? u[i + 1] - uc : 0.0f;
  const float uy = (y < H - 1) ? u[i + W] - uc : 0.0f;
  const float vx = (x < W - 1) ? v[i + 1] - vc : 0.0f;
  const float vy = (y < H - 1) ? v[i + W] - vc : 0.0f;
  float a11 = p11[i], a12 = p12[i], a21 = p21[i], a22 = p22[i];
  dual_px(ux, uy, vx, vy, taut, a11, a12, a21, a22);
  p11[i] = a11;
  p12[i] = a12;
  p21[i] = a21;
  p22[i] = a22;
}

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y, B);
}

// -------------------------------------------------------------------------
// K1: the persistent outer loop.
// -------------------------------------------------------------------------

enum { kU = 0, kV, kP11, kP12, kP21, kP22, kNState };

struct OuterLoop {
  const float* rho_c;
  const float* i1wx;
  const float* i1wy;
  const float* th;
  const float* inv_grad;
  // buf[0] is the caller's state (the input on entry, the result on exit),
  // buf[1] the scratch half of each pair's ping-pong
  float* buf[2][kNState];
  float* partials;  // B x tiles: one error slot per tile
  float* derr;      // B: each pair's error after its last step
  int B, H, W, tiles_x, tiles;
  int outer_iters, inner_iters, use_median, use_stop;
  float l_t, theta, taut, thresh;
};

// The 5x5 median of u and v on one tile of pair b: from buffer c to 1-c.
__device__ __forceinline__ void median_tile(const OuterLoop& a, int b,
                                            int tile, int c) {
  const size_t off = (size_t)b * a.H * a.W;
  const int x = (tile % a.tiles_x) * TILE_W + threadIdx.x;
  const int y0 = (tile / a.tiles_x) * TILE_H + threadIdx.y;
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    const int y = y0 + r * BLOCK_Y;
    if (x < a.W && y < a.H) {
      const size_t i = off + (size_t)y * a.W + x;
      a.buf[1 - c][kU][i] = median5x5_px(a.buf[c][kU] + off, x, y, a.H, a.W);
      a.buf[1 - c][kV][i] = median5x5_px(a.buf[c][kV] + off, x, y, a.H, a.W);
    }
  }
}

// Block sum of each thread's v in a fixed order, returned in thread 0: a
// shuffle tree over each warp's 32 lanes (lane l adds lane l+16, then
// l+8, ...), then the same tree over the warps' sums in warp 0.
__device__ __forceinline__ float block_sum(float v, float* s_warp, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) s_warp[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < BLOCK_THREADS / 32 ? s_warp[tid] : 0.0f;
#pragma unroll
    for (int off = BLOCK_THREADS / 64; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// One fused primal-dual step on one tile of pair b: flow from buffer cuv,
// dual field from buffer cp, results to the other buffers. With the stop,
// the tile's error goes to its slot.
__device__ __forceinline__ void step_tile(const OuterLoop& a, int b,
                                          int tile, int cuv, int cp,
                                          float* s_warp, int tid) {
  __shared__ float s_un[TILE_H + 1][TILE_W + 1];
  __shared__ float s_vn[TILE_H + 1][TILE_W + 1];
  const int H = a.H, W = a.W;
  const size_t off = (size_t)b * H * W;
  const float* rho_c = a.rho_c + off;
  const float* i1wx = a.i1wx + off;
  const float* i1wy = a.i1wy + off;
  const float* th = a.th + off;
  const float* inv_grad = a.inv_grad + off;
  const float* u = a.buf[cuv][kU] + off;
  const float* v = a.buf[cuv][kV] + off;
  const float* p11 = a.buf[cp][kP11] + off;
  const float* p12 = a.buf[cp][kP12] + off;
  const float* p21 = a.buf[cp][kP21] + off;
  const float* p22 = a.buf[cp][kP22] + off;
  const int x0 = (tile % a.tiles_x) * TILE_W;
  const int y0 = (tile / a.tiles_x) * TILE_H;
  const int x = x0 + threadIdx.x;
  // the constants are never written in the kernel: read-only path
  auto primal_at = [&](int px, int py) {
    const size_t j = (size_t)py * W + px;
    return primal_px(__ldg(rho_c + j), __ldg(i1wx + j), __ldg(i1wy + j),
                     __ldg(th + j), __ldg(inv_grad + j), u, v, p11, p12, p21,
                     p22, j, px, py, H, W, a.l_t, a.theta);
  };

  // primal over the tile ...
  float du2 = 0.0f;
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    const int ly = threadIdx.y + r * BLOCK_Y;
    const int y = y0 + ly;
    if (x < W && y < H) {
      const Primal q = primal_at(x, y);
      s_un[ly][threadIdx.x] = q.un;
      s_vn[ly][threadIdx.x] = q.vn;
      const float eu = q.un - q.uo;
      const float ev = q.vn - q.vo;
      du2 += eu * eu + ev * ev;
    }
  }
  // ... and over its halo: the bottom row (threads 0-31) and the right
  // column (the next TILE_H threads), where they lie in the image
  if (tid < TILE_W + TILE_H) {
    const bool row = tid < TILE_W;
    const int hx = row ? x0 + tid : x0 + TILE_W;
    const int hy = row ? y0 + TILE_H : y0 + tid - TILE_W;
    if (hx < W && hy < H) {
      const Primal h = primal_at(hx, hy);
      s_un[hy - y0][hx - x0] = h.un;
      s_vn[hy - y0][hx - x0] = h.vn;
    }
  }
  __syncthreads();

  // dual over the tile, from the new flow in shared memory and the old
  // dual field read again (from cache: the primal just read it)
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    const int ly = threadIdx.y + r * BLOCK_Y;
    const int lx = threadIdx.x;
    const int y = y0 + ly;
    if (x < W && y < H) {
      const float uc = s_un[ly][lx];
      const float vc = s_vn[ly][lx];
      const float ux = (x < W - 1) ? s_un[ly][lx + 1] - uc : 0.0f;
      const float uy = (y < H - 1) ? s_un[ly + 1][lx] - uc : 0.0f;
      const float vx = (x < W - 1) ? s_vn[ly][lx + 1] - vc : 0.0f;
      const float vy = (y < H - 1) ? s_vn[ly + 1][lx] - vc : 0.0f;
      const size_t j = (size_t)y * W + x;
      float a11 = p11[j], a12 = p12[j], a21 = p21[j], a22 = p22[j];
      dual_px(ux, uy, vx, vy, a.taut, a11, a12, a21, a22);
      const size_t i = off + j;
      a.buf[1 - cuv][kU][i] = uc;
      a.buf[1 - cuv][kV][i] = vc;
      a.buf[1 - cp][kP11][i] = a11;
      a.buf[1 - cp][kP12][i] = a12;
      a.buf[1 - cp][kP21][i] = a21;
      a.buf[1 - cp][kP22][i] = a22;
    }
  }

  if (a.use_stop) {
    // the tile's error, in a fixed order, to its slot
    const float sum = block_sum(du2, s_warp, tid);
    if (tid == 0) a.partials[(size_t)b * a.tiles + tile] = sum;
  }
  // the next tile reuses the shared arrays
  __syncthreads();
}

// Dynamic shared memory: per pair its error, its place in the active list
// and the buffer parity of its flow and of its dual field.
size_t outer_loop_smem(int B) {
  return (size_t)B * (sizeof(float) + sizeof(int) + 2);
}

// 4 blocks per SM (64 registers a thread, a few spilled): the step streams
// memory, and more warps in flight beat the spills (2 blocks at the
// compiler's own 128 registers stream slower)
__global__ void __launch_bounds__(BLOCK_THREADS, 4)
    outer_loop_kernel(const OuterLoop a) {
  extern __shared__ unsigned char smem[];
  float* s_err = reinterpret_cast<float*>(smem);
  int* s_list = reinterpret_cast<int*>(s_err + a.B);
  unsigned char* s_puv = reinterpret_cast<unsigned char*>(s_list + a.B);
  unsigned char* s_pp = s_puv + a.B;
  __shared__ int s_nact;
  __shared__ float s_warp[BLOCK_THREADS / 32];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;

  for (int b = tid; b < a.B; b += BLOCK_THREADS) {
    s_err[b] = INFINITY;
    s_puv[b] = 0;
    s_pp[b] = 0;
  }
  __syncthreads();

  // Every block runs the same control flow from the same s_err, so all
  // meet at every grid barrier and all return together.
  bool done = false;
  for (int o = 0; o < a.outer_iters && !done; ++o) {
    for (int k = a.use_median ? -1 : 0; k < a.inner_iters; ++k) {
      // phase k: -1 the median, 0.. the steps
      if (tid == 0) {
        int n = 0;
        for (int b = 0; b < a.B; ++b)
          if (!a.use_stop || s_err[b] > a.thresh) s_list[n++] = b;
        s_nact = n;
      }
      __syncthreads();
      const int nact = s_nact;
      if (nact == 0) {
        done = true;
        break;
      }
      const int items = nact * a.tiles;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int b = s_list[it / a.tiles];
        const int tile = it % a.tiles;
        if (k < 0)
          median_tile(a, b, tile, s_puv[b]);
        else
          step_tile(a, b, tile, s_puv[b], s_pp[b], s_warp, tid);
      }
      grid.sync();
      if (k >= 0 && a.use_stop) {
        // each active pair's error: one block adds the pair's slots in a
        // fixed order (thread t takes slots t, t + BLOCK_THREADS, ...)
        for (int j = blockIdx.x; j < nact; j += gridDim.x) {
          const int b = s_list[j];
          const float* slots = a.partials + (size_t)b * a.tiles;
          float acc = 0.0f;
          for (int t = tid; t < a.tiles; t += BLOCK_THREADS)
            acc += __ldcg(slots + t);
          const float total = block_sum(acc, s_warp, tid);
          if (tid == 0) a.derr[b] = total;
          __syncthreads();  // s_warp is reused
        }
        grid.sync();
      }
      // the pairs that ran: their state now lies in the other buffers,
      // and after a step their error is the step's
      for (int j = tid; j < nact; j += BLOCK_THREADS) {
        const int b = s_list[j];
        s_puv[b] ^= 1;
        if (k >= 0) {
          s_pp[b] ^= 1;
          if (a.use_stop) s_err[b] = __ldcg(a.derr + b);
        }
      }
      __syncthreads();
    }
  }

  // the pairs whose flow or dual field ended in buffer 1: copy it to 0
  const size_t plane = (size_t)a.H * a.W;
  const size_t stride = (size_t)gridDim.x * BLOCK_THREADS;
  for (int b = 0; b < a.B; ++b) {
    const int cuv = s_puv[b], cp = s_pp[b];
    if (!cuv && !cp) continue;
    const size_t off = (size_t)b * plane;
    for (size_t e = (size_t)blockIdx.x * BLOCK_THREADS + tid; e < plane;
         e += stride) {
      const size_t i = off + e;
      if (cuv) {
        a.buf[0][kU][i] = a.buf[1][kU][i];
        a.buf[0][kV][i] = a.buf[1][kV][i];
      }
      if (cp) {
        a.buf[0][kP11][i] = a.buf[1][kP11][i];
        a.buf[0][kP12][i] = a.buf[1][kP12][i];
        a.buf[0][kP21][i] = a.buf[1][kP21][i];
        a.buf[0][kP22][i] = a.buf[1][kP22][i];
      }
    }
  }
}

}  // namespace

extern "C" {

// K1's error slots per pair: its tiles.
int tvl1_num_tiles(int H, int W) {
  return ((W + TILE_W - 1) / TILE_W) * ((H + TILE_H - 1) / TILE_H);
}

const char* tvl1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int tvl1_median5x5(const float* in, float* out, int B, int H, int W,
                   void* stream) {
  median5x5_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                     (cudaStream_t)stream>>>(in, out, H, W);
  return (int)cudaGetLastError();
}

int tvl1_primal(const float* rho_c, const float* i1wx, const float* i1wy,
                const float* th, const float* inv_grad, float* u, float* v,
                const float* p11, const float* p12, const float* p21,
                const float* p22, int B, int H, int W, float l_t, float theta,
                void* stream) {
  primal_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                  (cudaStream_t)stream>>>(rho_c, i1wx, i1wy, th, inv_grad, u,
                                          v, p11, p12, p21, p22, H, W, l_t,
                                          theta);
  return (int)cudaGetLastError();
}

int tvl1_dual(const float* u, const float* v, float* p11, float* p12,
              float* p21, float* p22, int B, int H, int W, float taut,
              void* stream) {
  dual_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                (cudaStream_t)stream>>>(u, v, p11, p12, p21, p22, H, W,
                                        taut);
  return (int)cudaGetLastError();
}

// K1: the whole outer loop in one cooperative launch. u..p22 hold the
// state on entry and the result on exit; scratch holds 6 x B x H x W
// floats, partials B x tvl1_num_tiles(H, W), derr B. Returns the launch's
// error (cudaErrorCooperativeLaunchTooLarge when the grid cannot be
// resident at once).
int tvl1_outer_loop(const float* rho_c, const float* i1wx, const float* i1wy,
                    const float* th, const float* inv_grad, float* u,
                    float* v, float* p11, float* p12, float* p21, float* p22,
                    float* scratch, float* partials, float* derr, int B, int H,
                    int W,
                    int outer_iters, int inner_iters, int use_median,
                    int use_stop, float l_t, float theta, float taut,
                    float thresh, void* stream) {
  OuterLoop a;
  a.rho_c = rho_c;
  a.i1wx = i1wx;
  a.i1wy = i1wy;
  a.th = th;
  a.inv_grad = inv_grad;
  float* state[kNState] = {u, v, p11, p12, p21, p22};
  const size_t n = (size_t)B * H * W;
  for (int s = 0; s < kNState; ++s) {
    a.buf[0][s] = state[s];
    a.buf[1][s] = scratch + s * n;
  }
  a.partials = partials;
  a.derr = derr;
  a.B = B;
  a.H = H;
  a.W = W;
  a.tiles_x = (W + TILE_W - 1) / TILE_W;
  a.tiles = tvl1_num_tiles(H, W);
  a.outer_iters = outer_iters;
  a.inner_iters = inner_iters;
  a.use_median = use_median;
  a.use_stop = use_stop;
  a.l_t = l_t;
  a.theta = theta;
  a.taut = taut;
  a.thresh = thresh;

  int dev, sms, coop, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = outer_loop_smem(B);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(outer_loop_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, outer_loop_kernel, BLOCK_THREADS, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) {
    // every block resident at once; no more blocks than one phase's items
    const long long items = (long long)B * a.tiles;
    const int grid = (int)(items < (long long)per_sm * sms
                               ? items : (long long)per_sm * sms);
    void* args[] = {&a};
    e = cudaLaunchCooperativeKernel((const void*)outer_loop_kernel,
                                    dim3(grid), dim3(BLOCK_X, BLOCK_Y), args,
                                    smem, (cudaStream_t)stream);
  }
  cudaGetLastError();  // clear the error so later launches are not blamed
  return (int)e;
}

}  // extern "C"
