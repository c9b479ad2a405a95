// TV-L1 primal-dual kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tee_optical_flow_torch/ops/cuda_lib.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  ops/tvl1_pallas.py::_fused_scale_kernel (entry tvl1_outer_loop_pallas)
//       one frame pair's whole per-warp outer loop, VMEM-resident, with the
//       5x5 median (med5) and the per-pair epsilon stop inside;
//   K2  ops/tvl1_pallas.py::_inner_block_kernel (entry tvl1_inner_block_pallas)
//       n_iters primal-dual steps on halo-tiled row slabs, which the JAX
//       package runs between medians inside _tvl1_outer_eps_block
//       (ops/tvl1.py:175-233) at the levels above the fused size bound.
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
//     neighbours from there; a primal launch and a dual launch per step
//     would move 92 B per pixel. The five constant planes come through the
//     read-only path.
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
// The block loop (block_sweep_kernel, block_end_kernel) is K2's redesign:
// one C call (tvl1_block_loop) runs one warp's whole loop at a level above
// K1's size rule, outer_iters x [5x5 median of u and v, inner_iters
// steps], with the JAX package's two-quiet-blocks stop, every launch
// issued from C on the caller's stream; K2 alone (tvl1_inner_block) is
// the same call with one block, no median and no stop.
//   * What bounded it: the bytes. 39 pairs at 608x800 hold ~760 MB of
//     state and constants against a 50 MB L2, and a primal launch and a
//     dual launch per step (92 B per pixel-step) streamed at ~90% of the
//     HBM rate, so the gain had to come from moving fewer bytes. The TPU
//     kernel got there by temporal blocking (a row slab with a halo of
//     n_iters rows in VMEM); a block's shared memory holds a few steps'.
//   * What the design does about it: each sweep launch loads an extended
//     tile of K2_EW x K2_EH pixels (the tile and a halo of K2_S) of the six
//     state planes and the four constants into dynamic shared memory (th
//     and the guarded 1/grad computed from grad on load, as
//     derived_constants does: the same bits), runs up to K2_S fused steps
//     there and writes only the tile: ~18 B per pixel-step at S = 5 on
//     64x40. Steps update in place with a barrier after each half (see
//     block_sweep_kernel); between launches the state ping-pongs between
//     the caller's buffers and a scratch copy (a tile is its neighbours'
//     halo), an even number of launches per block so every block starts
//     and ends in the caller's.
//   * What bounds it now: the steps in shared memory, not the bytes (the
//     own traffic runs at ~1.2 TB/s): four IEEE divisions and two square
//     roots per pixel-step, and the halo's recomputed steps. Two 512-thread
//     blocks per SM (112,640 B each) overlap one block's loads with the
//     other's steps; each warp steps 32-pixel row segments, two at a time;
//     the state is held as float2 pairs so a step loads a pixel's flow and
//     its neighbours' dual pairs in one instruction each, and tiles off the
//     image's border skip the border checks. S and the tile are
//     compile-time constants chosen by measurement (chip_smoke.k2_tuning).
//   * The median is fused into each block's first launch: it stages u, v
//     over the extended tile and two more pixels (clamped to the image) in
//     the planes the dual field and constants fill next, and with the stop
//     writes the post-median flow once for the block delta.
//   * The stop is on the device and deterministic: the block's last launch
//     writes each tile's delta sum((nu-um)^2 + (nv-vm)^2) (in a fixed
//     order, block_sum) to a slot, and block_end_kernel, one block per
//     pair, adds the slots in a fixed order and counts the strikes. Frozen
//     pairs cost no step: their launches return at once.
//   * A launch train, not a persistent cooperative kernel like K1: a tile
//     is its neighbours' halo, so a persistent kernel would need a grid
//     barrier where each launch ends (4.30 us each for K1 on an H100), with
//     the grid limited to the blocks resident at once; separate launches
//     cost about as much, take any grid, and have no residency rule. A
//     30-step block is tvl1_block_sweeps(30) = 6 launches of 5 steps, then
//     one block_end_kernel: 70 device launches per call at 10 blocks.
// median5x5_kernel is the standalone median; no path calls it (K1 and the
// block loop run their own), tests and the smoke hold it to the plain one.

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

// The block loop's sweep launches: at most K2_S steps each on a K2_EW x
// K2_EH extended tile (the tile and a halo of K2_S pixels) in shared
// memory, K2_THREADS threads. chip_smoke.k2_tuning rebuilds this file with
// -D overrides to time other shapes.
#ifndef K2_S
#define K2_S 5
#endif
#ifndef K2_EW
#define K2_EW 64
#endif
#ifndef K2_EH
#define K2_EH 40
#endif
#ifndef K2_THREADS
#define K2_THREADS 512
#endif

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

// The median of a 5x5 window; at(p, c) reads row p, column c of it.
template <typename At>
__device__ __forceinline__ float median25(At at) {
  float w[25];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    float col[5];
#pragma unroll
    for (int p = 0; p < 5; ++p) col[p] = at(p, c);
    SORT5(col)
#pragma unroll
    for (int p = 0; p < 5; ++p) w[c * 5 + p] = col[p];
  }
  COLUMN_MEDIAN_25(w)
  return w[14];
}

// The median of plane f (H x W) at (x, y).
__device__ __forceinline__ float median5x5_px(const float* f, int x, int y,
                                              int H, int W) {
  int rows[5], cols[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    rows[k] = min(max(y + k - 2, 0), H - 1) * W;
    cols[k] = min(max(x + k - 2, 0), W - 1);
  }
  return median25([&](int p, int c) { return f[rows[p] + cols[c]]; });
}

// -------------------------------------------------------------------------
// One primal-dual step, written once for K1 and the block loop.
// Primal: soft-thresholded data term, then u <- (u + d) + theta*div(p),
// with div(p) the backward differences of warp.divergence (p itself on the
// first row/column, -p[last-1] on the last). Dual: forward differences of
// the new u, v (zero past the last row/column), then
// p <- (p + taut*grad) / (1 + taut*|grad|).
// -------------------------------------------------------------------------

struct Primal {
  float uo, vo, un, vn;  // flow before and after the primal step
};

// One backward difference of div(p): a is p at the pixel, prev at the
// previous column or row (not read on the first).
__device__ __forceinline__ float back_diff(float a, float prev, bool first,
                                           bool last) {
  return first ? a : (last ? -prev : a - prev);
}

// The primal step of one pixel from its constants (rho_c, I1w_x, I1w_y,
// th = l_t*|grad I1w|^2 and the guarded 1/|grad I1w|^2), its flow and the
// backward differences of its dual field.
__device__ __forceinline__ Primal primal_core(float rc, float ix, float iy,
                                              float t, float ig, float uo,
                                              float vo, float dx1, float dx2,
                                              float dy1, float dy2, float l_t,
                                              float theta) {
  Primal q;
  q.uo = uo;
  q.vo = vo;
  const float rho = (rc + ix * uo) + iy * vo;
  const bool neg = rho < -t;
  const bool pos = rho > t;
  const float rg = rho * ig;
  const float ltx = l_t * ix;
  const float lty = l_t * iy;
  const float d1 = neg ? ltx : (pos ? -ltx : -rg * ix);
  const float d2 = neg ? lty : (pos ? -lty : -rg * iy);
  q.un = (uo + d1) + theta * (dx1 + dy1);
  q.vn = (vo + d2) + theta * (dx2 + dy2);
  return q;
}

// The primal step at pixel i = (x, y) of H x W planes (the plane pointers
// point at the pair's planes, or i includes the pair's offset), given the
// pixel's constants (loaded by the caller).
__device__ __forceinline__ Primal primal_px(
    float rc, float ix, float iy, float t, float ig, const float* u,
    const float* v, const float* p11, const float* p12, const float* p21,
    const float* p22, size_t i, int x, int y, int H, int W, float l_t,
    float theta) {
  const bool fx = x == 0, lx = x == W - 1, fy = y == 0, ly = y == H - 1;
  return primal_core(
      rc, ix, iy, t, ig, u[i], v[i],
      back_diff(p11[i], fx ? 0.0f : p11[i - 1], fx, lx),
      back_diff(p21[i], fx ? 0.0f : p21[i - 1], fx, lx),
      back_diff(p12[i], fy ? 0.0f : p12[i - W], fy, ly),
      back_diff(p22[i], fy ? 0.0f : p22[i - W], fy, ly), l_t, theta);
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
// The standalone median: one thread per pixel.
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

// Block sum of each thread's v in a fixed order, returned in thread 0 of
// a block of NT threads: a shuffle tree over each warp's 32 lanes (lane l
// adds lane l+16, then l+8, ...), then the same tree over the warps' sums
// in warp 0.
template <int NT = BLOCK_THREADS>
__device__ __forceinline__ float block_sum(float v, float* s_warp, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) s_warp[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < NT / 32 ? s_warp[tid] : 0.0f;
#pragma unroll
    for (int off = NT / 64; off > 0; off >>= 1)
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


// -------------------------------------------------------------------------
// The block loop: K2's steps in sweep launches on shared-memory tiles, the
// median fused into each block's first launch, the stop on the device.
// -------------------------------------------------------------------------

// An extended tile in shared memory: the state as three float2 planes,
// (u, v), (p11, p21) and (p12, p22), so that a step reads a pixel's pair,
// its left neighbour's x pair and its upper neighbour's y pair in one load
// each, then the constants rho_c, I1w_x, I1w_y, th and the guarded 1/grad
// (the last two computed from grad on load) as float planes: 11 floats a
// pixel.
constexpr int kNTile = 11;
constexpr int kS = K2_S, kEW = K2_EW, kEH = K2_EH, kNP = K2_EW * K2_EH;
// the tile written by each launch, and the median's window (the extended
// tile and two more pixels), staged in the dual field's and constants'
// planes before they are loaded
constexpr int kTW = kEW - 2 * kS, kTH = kEH - 2 * kS;
constexpr int kSW = kEW + 4, kSH = kEH + 4;
static_assert(kS >= 1 && kTW >= 1 && kTH >= 1,
              "the extended tile leaves no tile inside its halo");
static_assert(2 * kSW * kSH <= (kNTile - 2) * kNP,
              "the median's window does not fit past the flow's plane");
static_assert(K2_THREADS % 32 == 0 && K2_THREADS <= 1024, "K2_THREADS");
constexpr size_t kTileSmem = (size_t)kNTile * kNP * sizeof(float);

struct BlockSweep {
  const float* rho_c;
  const float* i1wx;
  const float* i1wy;
  const float* grad;
  const float* in[kNState];
  float* out[kNState];
  float* um;  // the flow at the block's start, after its median
  float* vm;
  float* slots;         // B x tiles: each tile's block delta
  const int* strikes;   // B, or nullptr (no stop): a pair with 2 is frozen
  int H, W, tiles_x, tiles;
  int n_steps;          // steps of this launch, at most K2_S
  int median;           // first launch of a block: the median of the flow
  int save_um;          // first launch of a block with the stop
  int delta;            // last launch of a block with the stop
  float l_t, theta, taut;
};

// float2 planes, then the float plane of rho_c
constexpr int fUV = 0, fPX = 1, fPY = 2, cBase = 6;

// The steps of one sweep launch on the extended tile in shared memory.
// Each warp takes rows of 32-pixel segments (row, segment) in turn, so its
// lanes read consecutive words, two segments at a time. Without kInterior
// every pixel is checked against the image's bounds (outside: not
// stepped; on the border: the plain version's border rules); with it no
// stepped pixel is on or past the border.
template <bool kInterior>
__device__ __forceinline__ void tile_steps(float* sm, const BlockSweep& a,
                                           int x0, int y0) {
  constexpr int NW = K2_THREADS / 32, SEGS = (kEW + 31) / 32;
  const int H = a.H, W = a.W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2* const uv = reinterpret_cast<float2*>(sm) + fUV * kNP;
  float2* const px = reinterpret_cast<float2*>(sm) + fPX * kNP;
  float2* const py = reinterpret_cast<float2*>(sm) + fPY * kNP;
  const float* const rc = sm + (cBase + 0) * kNP;
  const float* const ixp = sm + (cBase + 1) * kNP;
  const float* const iyp = sm + (cBase + 2) * kNP;
  const float* const thp = sm + (cBase + 3) * kNP;
  const float* const igp = sm + (cBase + 4) * kNP;
  for (int j = 1; j <= a.n_steps; ++j) {
#pragma unroll 2
    for (int item = warp; item < (kEH - 2 * j + 1) * SEGS; item += NW) {
      const int ly = j + item / SEGS;
      const int lx = (item % SEGS) * 32 + lane;
      if (lx < j || lx > kEW - j) continue;
      const int gy = y0 + ly, gx = x0 + lx;
      if (!kInterior && (gy < 0 || gy >= H || gx < 0 || gx >= W)) continue;
      const int i = ly * kEW + lx;
      const bool fx = !kInterior && gx == 0;
      const bool lx_ = !kInterior && gx == W - 1;
      const bool fy = !kInterior && gy == 0;
      const bool ly_ = !kInterior && gy == H - 1;
      const float2 f = uv[i];
      const float2 pc = px[i], pl = px[i - 1];
      const float2 qc = py[i], qu = py[i - kEW];
      const Primal q = primal_core(
          rc[i], ixp[i], iyp[i], thp[i], igp[i], f.x, f.y,
          back_diff(pc.x, fx ? 0.0f : pl.x, fx, lx_),
          back_diff(pc.y, fx ? 0.0f : pl.y, fx, lx_),
          back_diff(qc.x, fy ? 0.0f : qu.x, fy, ly_),
          back_diff(qc.y, fy ? 0.0f : qu.y, fy, ly_), a.l_t, a.theta);
      uv[i] = make_float2(q.un, q.vn);
    }
    __syncthreads();
#pragma unroll 2
    for (int item = warp; item < (kEH - 2 * j) * SEGS; item += NW) {
      const int ly = j + item / SEGS;
      const int lx = (item % SEGS) * 32 + lane;
      if (lx < j || lx >= kEW - j) continue;
      const int gy = y0 + ly, gx = x0 + lx;
      if (!kInterior && (gy < 0 || gy >= H || gx < 0 || gx >= W)) continue;
      const int i = ly * kEW + lx;
      const bool hx = kInterior || gx < W - 1;
      const bool hy = kInterior || gy < H - 1;
      const float2 c = uv[i];
      const float2 r = hx ? uv[i + 1] : c;
      const float2 d = hy ? uv[i + kEW] : c;
      const float ux = hx ? r.x - c.x : 0.0f;
      const float uy = hy ? d.x - c.x : 0.0f;
      const float vx = hx ? r.y - c.y : 0.0f;
      const float vy = hy ? d.y - c.y : 0.0f;
      const float2 pc = px[i], qc = py[i];
      float a11 = pc.x, a12 = qc.x, a21 = pc.y, a22 = qc.y;
      dual_px(ux, uy, vx, vy, a.taut, a11, a12, a21, a22);
      px[i] = make_float2(a11, a21);
      py[i] = make_float2(a12, a22);
    }
    __syncthreads();
  }
}

// n_steps fused primal-dual steps of one pair (blockIdx.y) on one extended
// tile (blockIdx.x) from a.in to a.out. After step j the flow is exact on
// the rows and columns j .. E-j of the extended tile and the dual field on
// j .. E-j-1 (the primal reads p to the left and above, the dual the new
// flow to the right and below), so the tile, K2_S inside, is exact after
// K2_S steps; only the tile is written. Both halves of a step update in
// place, with a barrier after each: the primal reads only its own pixel's
// flow, the dual writes only its own pixel's dual field.
__global__ void __launch_bounds__(K2_THREADS)
    block_sweep_kernel(const BlockSweep a) {
  extern __shared__ float sm[];
  __shared__ float s_warp[K2_THREADS / 32];
  constexpr int NT = K2_THREADS;
  const int b = blockIdx.y;
  if (a.strikes != nullptr && a.strikes[b] >= 2) return;  // frozen
  const int H = a.H, W = a.W, tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int x0 = (tile % a.tiles_x) * kTW - kS;
  const int y0 = (tile / a.tiles_x) * kTH - kS;
  const size_t base = (size_t)b * H * W;
  float2* const uv = reinterpret_cast<float2*>(sm) + fUV * kNP;
  float2* const px = reinterpret_cast<float2*>(sm) + fPX * kNP;
  float2* const py = reinterpret_cast<float2*>(sm) + fPY * kNP;

  if (a.median) {
    // the input flow over the window, edge-replicated (a clamped position
    // holds the value of the pixel it is clamped to), in the planes past
    // the flow's, which are loaded after the median
    float* const raw_u = sm + 2 * kNP;
    float* const raw_v = raw_u + kSW * kSH;
    for (int idx = tid; idx < kSW * kSH; idx += NT) {
      const int ly = idx / kSW, lx = idx - ly * kSW;
      const int gy = min(max(y0 - 2 + ly, 0), H - 1);
      const int gx = min(max(x0 - 2 + lx, 0), W - 1);
      const size_t g = base + (size_t)gy * W + gx;
      raw_u[idx] = a.in[kU][g];
      raw_v[idx] = a.in[kV][g];
    }
    __syncthreads();
    for (int idx = tid; idx < kNP; idx += NT) {
      const int ly = idx / kEW, lx = idx - ly * kEW;
      const int gy = y0 + ly, gx = x0 + lx;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      const float* fu = raw_u + ly * kSW + lx;
      const float* fv = raw_v + ly * kSW + lx;
      uv[idx] = make_float2(
          median25([&](int p, int c) { return fu[p * kSW + c]; }),
          median25([&](int p, int c) { return fv[p * kSW + c]; }));
    }
    __syncthreads();
  }
  for (int idx = tid; idx < kNP; idx += NT) {
    const int ly = idx / kEW, lx = idx - ly * kEW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    const size_t g = base + (size_t)gy * W + gx;
    if (!a.median) uv[idx] = make_float2(a.in[kU][g], a.in[kV][g]);
    px[idx] = make_float2(a.in[kP11][g], a.in[kP21][g]);
    py[idx] = make_float2(a.in[kP12][g], a.in[kP22][g]);
    sm[(cBase + 0) * kNP + idx] = __ldg(a.rho_c + g);
    sm[(cBase + 1) * kNP + idx] = __ldg(a.i1wx + g);
    sm[(cBase + 2) * kNP + idx] = __ldg(a.i1wy + g);
    // derived_constants (ops/tvl1_kernels.py): th = l_t * grad and the
    // guarded 1/grad
    const float gr = __ldg(a.grad + g);
    sm[(cBase + 3) * kNP + idx] = a.l_t * gr;
    sm[(cBase + 4) * kNP + idx] =
        gr > 1e-10f ? 1.0f / fmaxf(gr, 1e-10f) : 0.0f;
    if (a.save_um && ly >= kS && ly < kEH - kS && lx >= kS &&
        lx < kEW - kS) {
      const float2 f = uv[idx];
      a.um[g] = f.x;
      a.vm[g] = f.y;
    }
  }
  __syncthreads();

  if (x0 >= 0 && y0 >= 0 && x0 + kEW < W && y0 + kEH < H)
    tile_steps<true>(sm, a, x0, y0);
  else
    tile_steps<false>(sm, a, x0, y0);

  // the tile to a.out; with the stop, the tile's block delta (each thread
  // over its pixels in order, then block_sum) to its slot
  float acc = 0.0f;
  for (int idx = tid; idx < kNP; idx += NT) {
    const int ly = idx / kEW, lx = idx - ly * kEW;
    if (ly < kS || ly >= kEH - kS || lx < kS || lx >= kEW - kS) continue;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const size_t g = base + (size_t)gy * W + gx;
    const float2 f = uv[idx], pc = px[idx], qc = py[idx];
    a.out[kU][g] = f.x;
    a.out[kV][g] = f.y;
    a.out[kP11][g] = pc.x;
    a.out[kP21][g] = pc.y;
    a.out[kP12][g] = qc.x;
    a.out[kP22][g] = qc.y;
    if (a.delta) {
      const float eu = f.x - a.um[g];
      const float ev = f.y - a.vm[g];
      acc += eu * eu + ev * ev;
    }
  }
  if (a.delta) {
    const float sum = block_sum<NT>(acc, s_warp, tid);
    if (tid == 0) a.slots[(size_t)b * a.tiles + tile] = sum;
  }
}

// The end of a block, one block of threads per pair: the pair's block
// delta from its tiles' slots in a fixed order (thread t takes slots t, t +
// BLOCK_THREADS, ..., then block_sum), then its strikes. Frozen pairs are
// left alone.
__global__ void __launch_bounds__(BLOCK_THREADS)
    block_end_kernel(const float* __restrict__ slots, int tiles,
                     int* __restrict__ strikes, float thresh) {
  __shared__ float s_warp[BLOCK_THREADS / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int st = strikes[b];
  if (st >= 2) return;
  float acc = 0.0f;
  for (int t = tid; t < tiles; t += BLOCK_THREADS)
    acc += slots[(size_t)b * tiles + t];
  const float derr = block_sum(acc, s_warp, tid);
  if (tid == 0) strikes[b] = derr < thresh ? st + 1 : 0;
}

int block_tiles_x(int W) { return (W + kTW - 1) / kTW; }

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

// The block loop's sweep launches per block of n_iters steps: at least
// ceil(n_iters / K2_S), an even number (the state ping-pongs between the
// caller's buffers and the scratch ones and must end in the caller's), and
// at least 2. Its steps are spread over them as evenly as they go.
int tvl1_block_sweeps(int n_iters) {
  int n = (n_iters + kS - 1) / kS;
  n += n & 1;
  return n < 2 ? 2 : n;
}

// The block loop's tiles per pair (its block-delta slots).
int tvl1_block_tiles(int H, int W) {
  return block_tiles_x(W) * ((H + kTH - 1) / kTH);
}

// The block loop: outer_iters blocks of [the 5x5 median of u and v (with
// use_median), inner_iters steps], one warp's whole loop at a level that
// takes K2, every launch issued here on the caller's stream. With use_stop
// the two-quiet-blocks stop: after each block a pair's strikes count up
// when its block delta is below thresh and fall to 0 otherwise, and a pair
// with 2 is frozen (its launches do no work). u..p22 hold the state on
// entry and the result on exit; scratch holds 6 x B x H x W floats; with
// use_stop, um holds 2 x B x H x W, slots B x tvl1_block_tiles(H, W) and
// strikes B ints (all three may be nullptr without it). outer_iters = 1
// without median and stop is K2 alone. Returns the first CUDA error, with
// the last-error state cleared; nothing is launched after it.
int tvl1_block_loop(const float* rho_c, const float* i1wx, const float* i1wy,
                    const float* grad, float* u, float* v, float* p11,
                    float* p12, float* p21, float* p22, float* scratch,
                    float* um, float* slots, int* strikes, int B, int H,
                    int W, int outer_iters, int inner_iters, int use_median,
                    int use_stop, float l_t, float theta, float taut,
                    float thresh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)B * H * W;
  if (n == 0 || outer_iters <= 0) return 0;
  if (use_stop && (um == nullptr || slots == nullptr || strikes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      block_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileSmem);
  if (e == cudaSuccess && use_stop)
    e = cudaMemsetAsync(strikes, 0, B * sizeof(int), st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  float* state[kNState] = {u, v, p11, p12, p21, p22};
  BlockSweep a;
  a.rho_c = rho_c;
  a.i1wx = i1wx;
  a.i1wy = i1wy;
  a.grad = grad;
  a.um = um;
  a.vm = um == nullptr ? nullptr : um + n;
  a.slots = slots;
  a.strikes = use_stop ? strikes : nullptr;
  a.H = H;
  a.W = W;
  a.tiles_x = block_tiles_x(W);
  a.tiles = tvl1_block_tiles(H, W);
  a.l_t = l_t;
  a.theta = theta;
  a.taut = taut;
  const int sweeps = tvl1_block_sweeps(inner_iters);
  const dim3 grid(a.tiles, B);
  for (int o = 0; o < outer_iters; ++o) {
    for (int k = 0; k < sweeps; ++k) {
      // even launches read the caller's buffers, odd ones the scratch
      for (int q = 0; q < kNState; ++q) {
        float* scr = scratch + q * n;
        a.in[q] = (k & 1) ? scr : state[q];
        a.out[q] = (k & 1) ? state[q] : scr;
      }
      a.n_steps = inner_iters / sweeps + (k < inner_iters % sweeps ? 1 : 0);
      a.median = use_median && k == 0;
      a.save_um = use_stop && k == 0;
      a.delta = use_stop && k == sweeps - 1;
      block_sweep_kernel<<<grid, K2_THREADS, kTileSmem, st>>>(a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (use_stop) {
      block_end_kernel<<<B, BLOCK_THREADS, 0, st>>>(slots, a.tiles, strikes,
                                                    thresh);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return 0;
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
