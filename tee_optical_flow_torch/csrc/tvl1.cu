// TV-L1 primal-dual kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (tee_optical_flow_torch/ops/cuda_lib.py).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  ops/tvl1_pallas.py::_fused_scale_kernel (entry tvl1_outer_loop_pallas)
//       one frame pair's whole per-warp outer loop, VMEM-resident;
//   K2  ops/tvl1_pallas.py::_inner_block_kernel (entry tvl1_inner_block_pallas)
//       n_iters primal-dual steps on halo-tiled row slabs.
// Both become launches of the four kernels below, driven from Python
// (ops/tvl1_kernels.py: K1 = outer_iters x [median + inner_iters x
// (primal, err_reduce, dual)], K2 = n_iters x (primal, dual)).
//
// What bounds them on this card: memory traffic. The TPU kernels keep a
// pair's 11 planes resident in VMEM for the whole loop; one pair at
// 480x640 is 13.5 MB of planes against 227 KB of shared memory per block,
// so here every step streams its planes through HBM/L2: the primal step
// reads 11 floats and writes 2 per pixel, the dual step reads 6 and writes
// 4, ~90 B per pixel and iteration against ~50 flops. The design answers
// correctness first: one thread per pixel, coalesced row-major access,
// state updated in place, no shared-memory tiling. Temporal blocking in
// shared memory, a cluster per pair or a persistent kernel is later work.
//
// Parity: compile with --fmad=false and without --use_fast_math. Each
// expression below is written in the order of the plain PyTorch version
// (ops/tvl1_kernels.py) and the JAX reference, so each step is bitwise
// equal to them; the dual update keeps its division form.
//
// Epsilon stop (K1 with epsilon > 0): each pair carries err (sum of squared
// flow updates of its last inner iteration, starting at +inf) on the
// device. A pair is active while err > thresh = eps^2*H*W. The primal
// kernel writes per-block partial sums of the update; err_reduce adds them
// in a fixed order (no float atomics, so the stop decision is
// reproducible), records the iteration's active flag and replaces err.
// Every launch returns early for a frozen pair. The host never waits
// inside the loop.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_X 32
#define BLOCK_Y 8
#define BLOCK_THREADS (BLOCK_X * BLOCK_Y)
#define REDUCE_THREADS 256

namespace {

__device__ __forceinline__ bool pair_active(const float* err, float thresh,
                                            int b) {
  return err == nullptr || err[b] > thresh;
}

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

__global__ void median5x5_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int H, int W,
                                 const float* __restrict__ err, float thresh) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = (size_t)H * W;
  const float* f = in + (size_t)b * plane;
  const size_t i = (size_t)b * plane + (size_t)y * W + x;
  if (!pair_active(err, thresh, b)) {  // frozen pair: unchanged
    out[i] = in[i];
    return;
  }
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
  out[i] = w[14];
}

// -------------------------------------------------------------------------
// Primal step: soft-thresholded data term, then u <- (u + d) + theta*div(p).
// u and v are updated in place (each thread reads only its own u, v; p is
// read-only here). With partials != nullptr the block's sum of
// (du^2 + dv^2) goes to partials[b * nblocks + block].
// -------------------------------------------------------------------------

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
                              float l_t, float theta,
                              const float* __restrict__ err, float thresh,
                              float* __restrict__ partials) {
  const int b = blockIdx.z;
  if (!pair_active(err, thresh, b)) return;  // uniform over the block
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  float du2 = 0.0f;
  if (x < W && y < H) {
    const size_t i = (size_t)b * H * W + (size_t)y * W + x;
    const float uo = u[i];
    const float vo = v[i];
    const float ix = i1wx[i];
    const float iy = i1wy[i];
    const float t = th[i];
    const float rho = (rho_c[i] + ix * uo) + iy * vo;
    const bool neg = rho < -t;
    const bool pos = rho > t;
    const float rg = rho * inv_grad[i];
    const float ltx = l_t * ix;
    const float lty = l_t * iy;
    const float d1 = neg ? ltx : (pos ? -ltx : -rg * ix);
    const float d2 = neg ? lty : (pos ? -lty : -rg * iy);
    // divergence (warp.divergence): backward differences, with p itself
    // on the first row/column and -p[last-1] on the last
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
    const float un = (uo + d1) + theta * (dx1 + dy1);
    const float vn = (vo + d2) + theta * (dx2 + dy2);
    u[i] = un;
    v[i] = vn;
    const float eu = un - uo;
    const float ev = vn - vo;
    du2 = eu * eu + ev * ev;
  }
  if (partials == nullptr) return;
  // fixed-order tree over the block: reproducible from run to run
  __shared__ float s[BLOCK_THREADS];
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  s[tid] = du2;
  __syncthreads();
#pragma unroll
  for (int half = BLOCK_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) s[tid] += s[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    const int nblocks = gridDim.x * gridDim.y;
    partials[(size_t)b * nblocks + blockIdx.y * gridDim.x + blockIdx.x] = s[0];
  }
}

// -------------------------------------------------------------------------
// Per-pair error: one block per pair sums the primal step's block partials
// in a fixed order, records whether this iteration ran (active), and
// replaces err for the pairs that ran.
// -------------------------------------------------------------------------

__global__ void err_reduce_kernel(const float* __restrict__ partials,
                                  int nblocks, float* __restrict__ err,
                                  int* __restrict__ active, float thresh) {
  const int b = blockIdx.x;
  const bool act = err[b] > thresh;  // read by all before thread 0 writes
  __shared__ float s[REDUCE_THREADS];
  float acc = 0.0f;
  if (act) {
    const float* p = partials + (size_t)b * nblocks;
    for (int k = threadIdx.x; k < nblocks; k += REDUCE_THREADS) acc += p[k];
  }
  s[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int half = REDUCE_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    active[b] = act ? 1 : 0;
    if (act) err[b] = s[0];
  }
}

// -------------------------------------------------------------------------
// Dual step: forward differences of the new u, v (zero past the last
// row/column), then p <- (p + taut*grad) / (1 + taut*|grad|), in place.
// -------------------------------------------------------------------------

__global__ void dual_kernel(const float* __restrict__ u,
                            const float* __restrict__ v,
                            float* __restrict__ p11, float* __restrict__ p12,
                            float* __restrict__ p21, float* __restrict__ p22,
                            int H, int W, float taut,
                            const int* __restrict__ active) {
  const int b = blockIdx.z;
  if (active != nullptr && !active[b]) return;
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
  const float ng1 = 1.0f + taut * sqrtf(ux * ux + uy * uy);
  const float ng2 = 1.0f + taut * sqrtf(vx * vx + vy * vy);
  p11[i] = (p11[i] + taut * ux) / ng1;
  p12[i] = (p12[i] + taut * uy) / ng1;
  p21[i] = (p21[i] + taut * vx) / ng2;
  p22[i] = (p22[i] + taut * vy) / ng2;
}

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y, B);
}

}  // namespace

extern "C" {

// Block count per pair of the pixel kernels: the length of each pair's
// row in the primal step's partials buffer.
int tvl1_num_blocks(int H, int W) {
  return ((W + BLOCK_X - 1) / BLOCK_X) * ((H + BLOCK_Y - 1) / BLOCK_Y);
}

const char* tvl1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int tvl1_median5x5(const float* in, float* out, int B, int H, int W,
                   const float* err, float thresh, void* stream) {
  median5x5_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                     (cudaStream_t)stream>>>(in, out, H, W, err, thresh);
  return (int)cudaGetLastError();
}

int tvl1_primal(const float* rho_c, const float* i1wx, const float* i1wy,
                const float* th, const float* inv_grad, float* u, float* v,
                const float* p11, const float* p12, const float* p21,
                const float* p22, int B, int H, int W, float l_t, float theta,
                const float* err, float thresh, float* partials,
                void* stream) {
  primal_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                  (cudaStream_t)stream>>>(rho_c, i1wx, i1wy, th, inv_grad, u,
                                          v, p11, p12, p21, p22, H, W, l_t,
                                          theta, err, thresh, partials);
  return (int)cudaGetLastError();
}

int tvl1_err_reduce(const float* partials, int nblocks, float* err,
                    int* active, float thresh, int B, void* stream) {
  err_reduce_kernel<<<B, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      partials, nblocks, err, active, thresh);
  return (int)cudaGetLastError();
}

int tvl1_dual(const float* u, const float* v, float* p11, float* p12,
              float* p21, float* p22, int B, int H, int W, float taut,
              const int* active, void* stream) {
  dual_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                (cudaStream_t)stream>>>(u, v, p11, p12, p21, p22, H, W, taut,
                                        active);
  return (int)cudaGetLastError();
}

}  // extern "C"
