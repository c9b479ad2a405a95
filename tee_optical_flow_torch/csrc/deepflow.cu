// K3: the DeepFlow fixed-point solve for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (tee_optical_flow_torch/ops/cuda_lib.py).
// Linked into one library with tvl1.cu, whose tvl1_error_string decodes
// the error codes these launches return.
//
// Replaces the Pallas TPU kernel of the JAX package
//   ops/deepflow_pallas.py::_sor_kernel (entry sor_sweeps_pallas)
// which keeps one pair's 15 planes resident in VMEM for psi_iters x
// [robust weights, coefficients, sor_iters red-black SOR sweeps]. Here the
// solve is launches of the three kernels below, driven from Python
// (ops/deepflow_kernels.sor_sweeps): per psi round one `weights` launch,
// one `coefs` launch, then sor_iters x (red half sweep, black half sweep).
//
// What bounds it on this card: memory traffic. One pair at 480x640 is
// ~20 MB of planes against 227 KB of shared memory per block, so the
// state lives in HBM/L2 and every launch streams it: a half sweep reads
// the smoothness weight w, six coefficient planes and du/dv (neighbours
// from cache) and writes du/dv, ~44 B per pixel against ~40 flops. The
// design answers correctness first: one thread per pixel over a (B, H, W)
// grid, coalesced rows, du/dv updated in place. The four edge
// diffusivities are recomputed from w in the sweeps rather than stored
// (four planes less per sweep). Temporal blocking in shared memory or a
// persistent kernel per pair is later work.
//
// Why in place is race-free: a red pixel's four neighbours are black and
// the reverse, so a half sweep reads only pixels it does not write, apart
// from the clamped border neighbour, which is the pixel itself and is read
// by its own thread before that thread writes it. The plain version
// computes the update from the pre-half-sweep du everywhere and selects by
// colour: the same values. Colour = (y + x) % 2 in the coordinates of the
// image as given (red = even, swept first).
//
// Neighbours are edge-replicated against the true image bounds (the JAX
// package's clamped_shifts, ops/pallas_common.py:36-63).
//
// Parity: compile with --fmad=false and without --use_fast_math. Each
// expression below is written in the order of the plain PyTorch version
// (ops/deepflow_kernels.sor_sweeps_plain) and the JAX reference, so the
// solve is bitwise equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK_X 32
#define BLOCK_Y 8

namespace {

// Charbonnier derivative psi'(s^2) = 1 / (2 sqrt(s^2 + 1e-6))
__device__ __forceinline__ float robust(float x2) {
  return 1.0f / (2.0f * sqrtf(x2 + 1e-6f));
}

// flat indices of a pixel's clamped (N, S, W, E) neighbours
struct Nbrs {
  size_t c, n, s, w, e;
};

__device__ __forceinline__ bool pixel(int H, int W, Nbrs& p) {
  const int b = blockIdx.z;
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= W || y >= H) return false;
  const size_t base = (size_t)b * H * W;
  p.c = base + (size_t)y * W + x;
  p.n = base + (size_t)max(y - 1, 0) * W + x;
  p.s = base + (size_t)min(y + 1, H - 1) * W + x;
  p.w = base + (size_t)y * W + max(x - 1, 0);
  p.e = base + (size_t)y * W + min(x + 1, W - 1);
  return true;
}

// -------------------------------------------------------------------------
// Smoothness weight: w = alpha * psi'(|grad(u0+du)|^2 + |grad(v0+dv)|^2),
// centred differences with replicated borders (warp.centered_gradient).
// -------------------------------------------------------------------------

__global__ void weights_kernel(const float* __restrict__ u0,
                               const float* __restrict__ v0,
                               const float* __restrict__ du,
                               const float* __restrict__ dv,
                               float* __restrict__ wgt, int H, int W,
                               float alpha) {
  Nbrs p;
  if (!pixel(H, W, p)) return;
  const float ux = 0.5f * ((u0[p.e] + du[p.e]) - (u0[p.w] + du[p.w]));
  const float uy = 0.5f * ((u0[p.s] + du[p.s]) - (u0[p.n] + du[p.n]));
  const float vx = 0.5f * ((v0[p.e] + dv[p.e]) - (v0[p.w] + dv[p.w]));
  const float vy = 0.5f * ((v0[p.s] + dv[p.s]) - (v0[p.n] + dv[p.n]));
  wgt[p.c] = robust(ux * ux + uy * uy + vx * vx + vy * vy) * alpha;
}

// -------------------------------------------------------------------------
// Per-psi coefficients of the 2x2 system at each pixel: lagged data and
// gradient-constancy weights, the optional matching term (um == nullptr:
// none), edge-averaged diffusivities, the base flow's smoothness flux.
// Writes rhs1c, rhs2c, p11 = a11 + wsum, p22 = a22 + wsum, a12 and the
// guarded 1/det.
// -------------------------------------------------------------------------

__global__ void coefs_kernel(
    const float* __restrict__ i1wx, const float* __restrict__ i1wy,
    const float* __restrict__ i1wxx, const float* __restrict__ i1wxy,
    const float* __restrict__ i1wyy, const float* __restrict__ it,
    const float* __restrict__ itx, const float* __restrict__ ity,
    const float* __restrict__ u0, const float* __restrict__ v0,
    const float* __restrict__ um, const float* __restrict__ vm,
    const float* __restrict__ conf, const float* __restrict__ du,
    const float* __restrict__ dv, const float* __restrict__ wgt,
    float* __restrict__ rhs1c, float* __restrict__ rhs2c,
    float* __restrict__ p11, float* __restrict__ p22,
    float* __restrict__ a12o, float* __restrict__ inv_denom, int H, int W,
    float delta, float gamma, float beta) {
  Nbrs p;
  if (!pixel(H, W, p)) return;
  const size_t i = p.c;
  const float ix = i1wx[i], iy = i1wy[i];
  const float ixx = i1wxx[i], ixy = i1wxy[i], iyy = i1wyy[i];
  const float t = it[i], tx = itx[i], ty = ity[i];
  const float d_u = du[i], d_v = dv[i];
  const float uc = u0[i], vc = v0[i];

  const float r_int = t + ix * d_u + iy * d_v;
  const float r_gx = tx + ixx * d_u + ixy * d_v;
  const float r_gy = ty + ixy * d_u + iyy * d_v;
  const float psi_d = robust(r_int * r_int) * delta;
  const float psi_g = robust(r_gx * r_gx + r_gy * r_gy) * gamma;

  float a11 = psi_d * ix * ix + psi_g * (ixx * ixx + ixy * ixy);
  const float a12 = psi_d * ix * iy + psi_g * (ixx * ixy + ixy * iyy);
  float a22 = psi_d * iy * iy + psi_g * (ixy * ixy + iyy * iyy);
  float b1 = -(psi_d * ix * t + psi_g * (ixx * tx + ixy * ty));
  float b2 = -(psi_d * iy * t + psi_g * (ixy * tx + iyy * ty));

  if (um != nullptr) {
    const float mu = um[i], mv = vm[i];
    const float ru = uc + d_u - mu;
    const float rv = vc + d_v - mv;
    const float a_m = beta * conf[i] * robust(ru * ru + rv * rv);
    a11 = a11 + a_m;
    a22 = a22 + a_m;
    b1 = b1 + a_m * (mu - uc);
    b2 = b2 + a_m * (mv - vc);
  }

  const float wc = wgt[i];
  const float wn = 0.5f * (wc + wgt[p.n]);
  const float ws = 0.5f * (wc + wgt[p.s]);
  const float ww = 0.5f * (wc + wgt[p.w]);
  const float we = 0.5f * (wc + wgt[p.e]);
  const float wsum = wn + ws + ww + we;
  const float su0 =
      wn * u0[p.n] + ws * u0[p.s] + ww * u0[p.w] + we * u0[p.e] - wsum * uc;
  const float sv0 =
      wn * v0[p.n] + ws * v0[p.s] + ww * v0[p.w] + we * v0[p.e] - wsum * vc;

  const float q11 = a11 + wsum;
  const float q22 = a22 + wsum;
  float denom = q11 * q22 - a12 * a12;
  denom = fabsf(denom) > 1e-6f ? denom : 1e-6f;
  inv_denom[i] = 1.0f / denom;
  rhs1c[i] = b1 + su0;
  rhs2c[i] = b2 + sv0;
  p11[i] = q11;
  p22[i] = q22;
  a12o[i] = a12;
}

// -------------------------------------------------------------------------
// One red (color 0) or black (color 1) half sweep, du/dv in place.
// -------------------------------------------------------------------------

__global__ void sor_half_kernel(
    const float* __restrict__ wgt, const float* __restrict__ rhs1c,
    const float* __restrict__ rhs2c, const float* __restrict__ p11,
    const float* __restrict__ p22, const float* __restrict__ a12,
    const float* __restrict__ inv_denom, float* du, float* dv, int H, int W,
    int color, float omega, float one_minus_omega) {
  Nbrs p;
  if (!pixel(H, W, p)) return;
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (((x + y) & 1) != color) return;
  const size_t i = p.c;
  const float wc = wgt[i];
  const float wn = 0.5f * (wc + wgt[p.n]);
  const float ws = 0.5f * (wc + wgt[p.s]);
  const float ww = 0.5f * (wc + wgt[p.w]);
  const float we = 0.5f * (wc + wgt[p.e]);
  const float duc = du[i], dvc = dv[i];
  const float dun = wn * du[p.n] + ws * du[p.s] + ww * du[p.w] + we * du[p.e];
  const float dvn = wn * dv[p.n] + ws * dv[p.s] + ww * dv[p.w] + we * dv[p.e];
  const float rhs1 = rhs1c[i] + dun;
  const float rhs2 = rhs2c[i] + dvn;
  const float a = a12[i];
  const float inv = inv_denom[i];
  const float du_star = (p22[i] * rhs1 - a * rhs2) * inv;
  const float dv_star = (p11[i] * rhs2 - a * rhs1) * inv;
  du[i] = one_minus_omega * duc + omega * du_star;
  dv[i] = one_minus_omega * dvc + omega * dv_star;
}

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y, B);
}

}  // namespace

extern "C" {

int deepflow_weights(const float* u0, const float* v0, const float* du,
                     const float* dv, float* wgt, int B, int H, int W,
                     float alpha, void* stream) {
  weights_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                   (cudaStream_t)stream>>>(u0, v0, du, dv, wgt, H, W, alpha);
  return (int)cudaGetLastError();
}

int deepflow_coefs(const float* i1wx, const float* i1wy, const float* i1wxx,
                   const float* i1wxy, const float* i1wyy, const float* it,
                   const float* itx, const float* ity, const float* u0,
                   const float* v0, const float* um, const float* vm,
                   const float* conf, const float* du, const float* dv,
                   const float* wgt, float* rhs1c, float* rhs2c, float* p11,
                   float* p22, float* a12, float* inv_denom, int B, int H,
                   int W, float delta, float gamma, float beta,
                   void* stream) {
  coefs_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                 (cudaStream_t)stream>>>(
      i1wx, i1wy, i1wxx, i1wxy, i1wyy, it, itx, ity, u0, v0, um, vm, conf, du,
      dv, wgt, rhs1c, rhs2c, p11, p22, a12, inv_denom, H, W, delta, gamma,
      beta);
  return (int)cudaGetLastError();
}

int deepflow_sor_half(const float* wgt, const float* rhs1c,
                      const float* rhs2c, const float* p11, const float* p22,
                      const float* a12, const float* inv_denom, float* du,
                      float* dv, int B, int H, int W, int color, float omega,
                      float one_minus_omega, void* stream) {
  sor_half_kernel<<<pixel_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                    (cudaStream_t)stream>>>(wgt, rhs1c, rhs2c, p11, p22, a12,
                                            inv_denom, du, dv, H, W, color,
                                            omega, one_minus_omega);
  return (int)cudaGetLastError();
}

}  // extern "C"
