// K3: the DeepFlow fixed-point solve for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (tee_optical_flow_torch/ops/cuda_lib.py).
// Linked into one library with tvl1.cu, whose tvl1_error_string decodes
// the error codes deepflow_solve returns.
//
// Replaces the Pallas TPU kernel of the JAX package
//   ops/deepflow_pallas.py::_sor_kernel (entry sor_sweeps_pallas)
// which keeps one pair's 10-13 input planes, du/dv and the per-psi
// coefficients resident in VMEM for psi_iters x [robust weights,
// coefficients, sor_iters red-black SOR sweeps]. One call of
// deepflow_solve (ops/deepflow_kernels.sor_sweeps) issues every launch of
// the solve from C, on the caller's stream.
//
// What bounds it on this card: memory traffic. A pair at 480x640 is ~11
// MB of state against 227 KB of shared memory per block, and 39 pairs are
// ~430 MB against a 50 MB L2, so whatever leaves the block goes to HBM. A
// half sweep that is its own launch reads nine planes to update half the
// pixels (a launch per half sweep: 78 launches and 3,456 B per pixel per
// call).
// What the design does about it:
//
//   * coefs_kernel, one launch per psi round: the smoothness weight w over
//     a 32x8 tile plus a one-pixel ring in shared memory (u0+du, v0+dv out
//     to two pixels), then the six coefficient planes of the 2x2 system
//     (rhs1c, rhs2c, p11, p22, a12, inv_denom), written with w.
//   * sweep_kernel, ceil(sor_iters / S) launches per psi round, S SOR
//     iterations (2S half sweeps) each: a block loads an extended tile
//     (EW x EH, the tile plus a halo of R = 2S pixels) of du, dv, w and the
//     six coefficients into shared memory, runs its half sweeps there with
//     a block barrier between them, and writes back only the tile. Half
//     sweep j updates only the pixels at least j inside the extended tile:
//     after k half sweeps a pixel depends only on state within k pixels, so
//     those are exact and the tile is exact after 2S. The halo pixels are
//     recomputed by every block that holds them, with the same arithmetic.
//     S = 4 and a 96x64 extended tile (80x48 tile, 1024 threads, one block
//     per SM) were chosen by measurement; both are compile-time constants
//     (K3_S, K3_EW, K3_EH below).
//   * du/dv ping-pong between two buffers from launch to launch (read A,
//     write B): one block's tile is its neighbours' halo, so an in-place
//     write would race. The first buffer is picked so that the last launch
//     writes the caller's; the first psi round reads no du/dv (zeros).
//   * shared memory is split by colour: plane p, colour c, row r, slot k =
//     x / 2. A pixel's four neighbours have the other colour, and threads
//     on consecutive slots read consecutive words: no bank conflicts, and a
//     half sweep touches only its own colour's coefficients. The colour
//     planes are padded by 16 words so that the loads' stores do not collide.
//   * resident_kernel, ONE launch per call, where one pair's nine planes fit
//     in a block's shared memory (72 x H x ceil(W/2) B plus padding, at most
//     the card's opt-in limit of 232,448 B: H x ceil(W/2) <= 3,212, so 60x80
//     and 30x40 on a 480x640 clip): one block of 1024 threads per pair runs
//     every psi round (inputs read from HBM once per round) and every sweep
//     with block barriers between phases, the TPU kernel's own shape. The
//     choice between the variants is a rule about sizes only: both give
//     the same bits. On an H100 the tiled route ties it at 39x60x80 and
//     takes twice its time at 39x30x40, in 12 launches instead of one
//     (PERF.md section 6, one-off measurements).
//
// Red-black in shared memory: a red pixel's four neighbours are black and
// the reverse, so a half sweep reads only pixels it does not write, apart
// from the clamped border neighbour, which is the pixel itself and is read
// by its own thread before it writes. Colour = (y + x) & 1 in the
// coordinates of the image (red = even, swept first); an extended tile's
// origin is always at even y + x. Neighbours are edge-replicated against the
// true image bounds (the JAX package's clamped_shifts,
// ops/pallas_common.py:36-63): at the image edge the neighbour is the pixel.
//
// Parity: compile with --fmad=false and without --use_fast_math. Each
// expression below is written in the order of the plain PyTorch version
// (ops/deepflow_kernels.sor_sweeps_plain) and the JAX reference, so the
// solve is bitwise equal to it.

#include <cuda_runtime.h>
#include <stdint.h>

// The library's launch count, defined in tvl1.cu (each C entry adds one
// per kernel launch it issued successfully; tee_device_launches reads it).
extern "C" unsigned long long tee_launch_count;

// coefs_kernel's tile
#define CT_W 32
#define CT_H 8

// The tiled route's shape, chosen by measurement: K3_S SOR iterations (2S
// half sweeps) per sweep launch on a K3_EW x K3_EH extended tile (the tile
// plus a halo of 2S), swept by K3_THREADS threads, timed against other
// shapes in builds with -D overrides (PERF.md section 6, one-off
// measurements); K3_RESIDENT=0 sends every size through the tiled route.
#ifndef K3_S
#define K3_S 4
#endif
#ifndef K3_EW
#define K3_EW 96
#endif
#ifndef K3_EH
#define K3_EH 64
#endif
#ifndef K3_THREADS
#define K3_THREADS 1024
#endif
#ifndef K3_RESIDENT
#define K3_RESIDENT 1
#endif

namespace {

// the nine planes of the solve in shared memory
enum { kDu, kDv, kW, kRhs1, kRhs2, kP11, kP22, kA12, kInv, kNPlanes };
constexpr int kColourPad = 16;

constexpr int kS = K3_S, kR = 2 * K3_S, kEW = K3_EW, kEH = K3_EH;
// even sides keep every extended tile's origin at even y + x
static_assert(kS >= 1 && kEW % 2 == 0 && kEH % 2 == 0 && kEW - 2 * kR >= 2 &&
                  kEH - 2 * kR >= 2,
              "the extended tile leaves no tile inside its halo");
constexpr size_t kSweepSmem =
    (size_t)kNPlanes * 2 * (kEH * (kEW / 2) + kColourPad) * sizeof(float);

// Charbonnier derivative psi'(s^2) = 1 / (2 sqrt(s^2 + 1e-6))
__device__ __forceinline__ float robust(float x2) {
  return 1.0f / (2.0f * sqrtf(x2 + 1e-6f));
}

// Smoothness weight w = alpha * psi'(|grad(u0+du)|^2 + |grad(v0+dv)|^2)
// from u = u0+du and v = v0+dv at the (clamped) E, W, S, N neighbours:
// centred differences, as warp.centered_gradient.
__device__ __forceinline__ float weight_px(float ue, float uw, float us,
                                           float un, float ve, float vw,
                                           float vs, float vn, float alpha) {
  const float ux = 0.5f * (ue - uw);
  const float uy = 0.5f * (us - un);
  const float vx = 0.5f * (ve - vw);
  const float vy = 0.5f * (vs - vn);
  return robust(ux * ux + uy * uy + vx * vx + vy * vy) * alpha;
}

struct Inputs {
  const float *i1wx, *i1wy, *i1wxx, *i1wxy, *i1wyy, *it, *itx, *ity, *u0,
      *v0, *um, *vm, *conf;  // um == nullptr: no matching term
};

struct Coefs {
  float rhs1c, rhs2c, p11, p22, a12, inv;
};

// Per-psi coefficients of the 2x2 system at the pixel of flat index i
// (clamped neighbours n, s, w, e): lagged data and gradient-constancy
// weights, the optional matching term, edge-averaged diffusivities from w
// at the pixel and its neighbours, the base flow's smoothness flux, the
// guarded 1/det.
__device__ __forceinline__ Coefs coefs_px(const Inputs& in, size_t i,
                                          size_t n, size_t s, size_t w,
                                          size_t e, float d_u, float d_v,
                                          float wc, float w_n, float w_s,
                                          float w_w, float w_e, float delta,
                                          float gamma, float beta) {
  const float ix = in.i1wx[i], iy = in.i1wy[i];
  const float ixx = in.i1wxx[i], ixy = in.i1wxy[i], iyy = in.i1wyy[i];
  const float t = in.it[i], tx = in.itx[i], ty = in.ity[i];
  const float uc = in.u0[i], vc = in.v0[i];

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

  if (in.um != nullptr) {
    const float mu = in.um[i], mv = in.vm[i];
    const float ru = uc + d_u - mu;
    const float rv = vc + d_v - mv;
    const float a_m = beta * in.conf[i] * robust(ru * ru + rv * rv);
    a11 = a11 + a_m;
    a22 = a22 + a_m;
    b1 = b1 + a_m * (mu - uc);
    b2 = b2 + a_m * (mv - vc);
  }

  const float wn = 0.5f * (wc + w_n);
  const float ws = 0.5f * (wc + w_s);
  const float ww = 0.5f * (wc + w_w);
  const float we = 0.5f * (wc + w_e);
  const float wsum = wn + ws + ww + we;
  const float su0 = wn * in.u0[n] + ws * in.u0[s] + ww * in.u0[w] +
                    we * in.u0[e] - wsum * uc;
  const float sv0 = wn * in.v0[n] + ws * in.v0[s] + ww * in.v0[w] +
                    we * in.v0[e] - wsum * vc;

  Coefs c;
  c.p11 = a11 + wsum;
  c.p22 = a22 + wsum;
  float denom = c.p11 * c.p22 - a12 * a12;
  denom = fabsf(denom) > 1e-6f ? denom : 1e-6f;
  c.inv = 1.0f / denom;
  c.rhs1c = b1 + su0;
  c.rhs2c = b2 + sv0;
  c.a12 = a12;
  return c;
}

// Shared memory split by colour: plane p, colour c, row r, slot k = x / 2.
struct Split {
  float* sm;
  int cstride;  // rows x hw2 + kColourPad
  int hw2;
  __device__ __forceinline__ float& at(int p, int c, int r, int k) const {
    return sm[(p * 2 + c) * cstride + r * hw2 + k];
  }
  // the pixel at (r, x) of a region whose origin has even y + x
  __device__ __forceinline__ float& px(int p, int r, int x) const {
    return at(p, (r + x) & 1, r, x >> 1);
  }
};

// One SOR update, in place, of the colour-c pixel at row r, slot k (x = 2k
// + off). has_*: the neighbour lies inside the image (else it is the pixel).
__device__ __forceinline__ void sor_px(const Split& s, int c, int r, int k,
                                       int off, bool has_n, bool has_s,
                                       bool has_w, bool has_e, float omega,
                                       float one_minus_omega) {
  const int o = c ^ 1;
  const int kw = k - 1 + off, ke = k + off;
  const float wc = s.at(kW, c, r, k);
  const float wn = 0.5f * (wc + (has_n ? s.at(kW, o, r - 1, k) : wc));
  const float ws = 0.5f * (wc + (has_s ? s.at(kW, o, r + 1, k) : wc));
  const float ww = 0.5f * (wc + (has_w ? s.at(kW, o, r, kw) : wc));
  const float we = 0.5f * (wc + (has_e ? s.at(kW, o, r, ke) : wc));
  const float duc = s.at(kDu, c, r, k), dvc = s.at(kDv, c, r, k);
  const float dun = wn * (has_n ? s.at(kDu, o, r - 1, k) : duc) +
                    ws * (has_s ? s.at(kDu, o, r + 1, k) : duc) +
                    ww * (has_w ? s.at(kDu, o, r, kw) : duc) +
                    we * (has_e ? s.at(kDu, o, r, ke) : duc);
  const float dvn = wn * (has_n ? s.at(kDv, o, r - 1, k) : dvc) +
                    ws * (has_s ? s.at(kDv, o, r + 1, k) : dvc) +
                    ww * (has_w ? s.at(kDv, o, r, kw) : dvc) +
                    we * (has_e ? s.at(kDv, o, r, ke) : dvc);
  const float rhs1 = s.at(kRhs1, c, r, k) + dun;
  const float rhs2 = s.at(kRhs2, c, r, k) + dvn;
  const float a = s.at(kA12, c, r, k);
  const float inv = s.at(kInv, c, r, k);
  const float du_star = (s.at(kP22, c, r, k) * rhs1 - a * rhs2) * inv;
  const float dv_star = (s.at(kP11, c, r, k) * rhs2 - a * rhs1) * inv;
  s.at(kDu, c, r, k) = one_minus_omega * duc + omega * du_star;
  s.at(kDv, c, r, k) = one_minus_omega * dvc + omega * dv_star;
}

// -------------------------------------------------------------------------
// Tiled route, per psi round: coefs_kernel, then the sweep launches.
// -------------------------------------------------------------------------

struct CoefArgs {
  Inputs in;
  const float* du;  // nullptr: du = dv = 0 (the first psi round)
  const float* dv;
  float* out[7];  // w, rhs1c, rhs2c, p11, p22, a12, inv_denom
  int H, W;
  float alpha, delta, gamma, beta;
};

__global__ void __launch_bounds__(CT_W* CT_H) coefs_kernel(CoefArgs a) {
  __shared__ float uu[CT_H + 4][CT_W + 4];
  __shared__ float vv[CT_H + 4][CT_W + 4];
  __shared__ float wt[CT_H + 2][CT_W + 2];
  const int H = a.H, W = a.W;
  const int x0 = blockIdx.x * CT_W, y0 = blockIdx.y * CT_H;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.y * CT_W + threadIdx.x;
  // u0+du and v0+dv over the tile and two rings, edge-replicated: a
  // clamped position holds the value of the pixel it is clamped to
  for (int idx = tid; idx < (CT_H + 4) * (CT_W + 4); idx += CT_W * CT_H) {
    const int ly = idx / (CT_W + 4), lx = idx % (CT_W + 4);
    const int gy = min(max(y0 - 2 + ly, 0), H - 1);
    const int gx = min(max(x0 - 2 + lx, 0), W - 1);
    const size_t g = base + (size_t)gy * W + gx;
    uu[ly][lx] = a.in.u0[g] + (a.du ? a.du[g] : 0.0f);
    vv[ly][lx] = a.in.v0[g] + (a.dv ? a.dv[g] : 0.0f);
  }
  __syncthreads();
  // w over the tile and one ring, at the positions inside the image
  for (int idx = tid; idx < (CT_H + 2) * (CT_W + 2); idx += CT_W * CT_H) {
    const int ly = idx / (CT_W + 2), lx = idx % (CT_W + 2);
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    wt[ly][lx] = weight_px(uu[ly + 1][lx + 2], uu[ly + 1][lx],
                           uu[ly + 2][lx + 1], uu[ly][lx + 1],
                           vv[ly + 1][lx + 2], vv[ly + 1][lx],
                           vv[ly + 2][lx + 1], vv[ly][lx + 1], a.alpha);
  }
  __syncthreads();
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
  const size_t row = base + (size_t)y * W;
  const size_t i = row + x;
  const size_t n = base + (size_t)max(y - 1, 0) * W + x;
  const size_t s = base + (size_t)min(y + 1, H - 1) * W + x;
  const size_t w = row + max(x - 1, 0);
  const size_t e = row + min(x + 1, W - 1);
  const float wc = wt[ly][lx];
  const Coefs c = coefs_px(
      a.in, i, n, s, w, e, a.du ? a.du[i] : 0.0f, a.dv ? a.dv[i] : 0.0f, wc,
      y > 0 ? wt[ly - 1][lx] : wc, y < H - 1 ? wt[ly + 1][lx] : wc,
      x > 0 ? wt[ly][lx - 1] : wc, x < W - 1 ? wt[ly][lx + 1] : wc, a.delta,
      a.gamma, a.beta);
  a.out[0][i] = wc;
  a.out[1][i] = c.rhs1c;
  a.out[2][i] = c.rhs2c;
  a.out[3][i] = c.p11;
  a.out[4][i] = c.p22;
  a.out[5][i] = c.a12;
  a.out[6][i] = c.inv;
}

struct SweepArgs {
  const float* coef[7];  // w, rhs1c, rhs2c, p11, p22, a12, inv_denom
  const float* du_in;    // nullptr: du = dv = 0 (the first psi round)
  const float* dv_in;
  float* du_out;
  float* dv_out;
  int H, W, n_half, tiles_x;
  float omega, one_minus_omega;
};

// n_half (<= 2S) half sweeps, red first, on one extended tile of EW x EH
// pixels: the tile of (EW - 2R) x (EH - 2R) and a halo of R = 2S.
__global__ void __launch_bounds__(K3_THREADS) sweep_kernel(SweepArgs a) {
  extern __shared__ float smem[];
  constexpr int EW = kEW, EH = kEH, R = kR, NT = K3_THREADS, HW2 = EW / 2;
  const Split s{smem, EH * HW2 + kColourPad, HW2};
  const int H = a.H, W = a.W;
  const int tx = blockIdx.x % a.tiles_x, ty = blockIdx.x / a.tiles_x;
  // tile sides are even, so y0 + x0 is even: colour = (ly + lx) & 1
  const int x0 = tx * (EW - 2 * R) - R, y0 = ty * (EH - 2 * R) - R;
  const size_t base = (size_t)blockIdx.y * H * W;

  for (int idx = threadIdx.x; idx < EH * EW; idx += NT) {
    const int ly = idx / EW, lx = idx - ly * EW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    const size_t g = base + (size_t)gy * W + gx;
    s.px(kDu, ly, lx) = a.du_in ? a.du_in[g] : 0.0f;
    s.px(kDv, ly, lx) = a.dv_in ? a.dv_in[g] : 0.0f;
#pragma unroll
    for (int p = 0; p < 7; ++p) s.px(kW + p, ly, lx) = a.coef[p][g];
  }
  __syncthreads();

  for (int j = 1; j <= a.n_half; ++j) {
    const int c = (j - 1) & 1;
    const int items = (EH - 2 * j) * HW2;
    for (int idx = threadIdx.x; idx < items; idx += NT) {
      const int r = j + idx / HW2, k = idx % HW2;
      const int off = (r + c) & 1;
      const int lx = 2 * k + off;
      if (lx < j || lx >= EW - j) continue;
      const int gy = y0 + r, gx = x0 + lx;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      sor_px(s, c, r, k, off, gy > 0, gy < H - 1, gx > 0, gx < W - 1,
             a.omega, a.one_minus_omega);
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < EH * EW; idx += NT) {
    const int ly = idx / EW, lx = idx - ly * EW;
    if (ly < R || ly >= EH - R || lx < R || lx >= EW - R) continue;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const size_t g = base + (size_t)gy * W + gx;
    a.du_out[g] = s.px(kDu, ly, lx);
    a.dv_out[g] = s.px(kDv, ly, lx);
  }
}

// -------------------------------------------------------------------------
// Resident route: the whole solve of one pair in one block.
// -------------------------------------------------------------------------

#define RESIDENT_THREADS 1024

struct SolveArgs {
  Inputs in;
  float* du;
  float* dv;
  int H, W, psi_iters, sor_iters;
  float omega, one_minus_omega, alpha, delta, gamma, beta;
};

size_t resident_smem(int H, int W) {
  return (size_t)kNPlanes * 2 * ((size_t)H * ((W + 1) / 2) + kColourPad) *
         sizeof(float);
}

__global__ void __launch_bounds__(RESIDENT_THREADS)
    resident_kernel(SolveArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, n_px = H * W;
  const int hw2 = (W + 1) / 2;
  const Split s{smem, H * hw2 + kColourPad, hw2};
  const size_t base = (size_t)blockIdx.x * n_px;
  const Inputs& in = a.in;

  for (int idx = threadIdx.x; idx < n_px; idx += RESIDENT_THREADS) {
    const int y = idx / W, x = idx - y * W;
    s.px(kDu, y, x) = 0.0f;
    s.px(kDv, y, x) = 0.0f;
  }
  __syncthreads();

  for (int psi = 0; psi < a.psi_iters; ++psi) {
    // smoothness weight at the current increment
    for (int idx = threadIdx.x; idx < n_px; idx += RESIDENT_THREADS) {
      const int y = idx / W, x = idx - y * W;
      const int yn = max(y - 1, 0), ys = min(y + 1, H - 1);
      const int xw = max(x - 1, 0), xe = min(x + 1, W - 1);
      const size_t row = base + (size_t)y * W;
      const size_t n = base + (size_t)yn * W + x;
      const size_t so = base + (size_t)ys * W + x;
      s.px(kW, y, x) = weight_px(
          in.u0[row + xe] + s.px(kDu, y, xe), in.u0[row + xw] + s.px(kDu, y, xw),
          in.u0[so] + s.px(kDu, ys, x), in.u0[n] + s.px(kDu, yn, x),
          in.v0[row + xe] + s.px(kDv, y, xe), in.v0[row + xw] + s.px(kDv, y, xw),
          in.v0[so] + s.px(kDv, ys, x), in.v0[n] + s.px(kDv, yn, x), a.alpha);
    }
    __syncthreads();
    // the 2x2 system's coefficients
    for (int idx = threadIdx.x; idx < n_px; idx += RESIDENT_THREADS) {
      const int y = idx / W, x = idx - y * W;
      const int yn = max(y - 1, 0), ys = min(y + 1, H - 1);
      const int xw = max(x - 1, 0), xe = min(x + 1, W - 1);
      const size_t row = base + (size_t)y * W;
      const Coefs c = coefs_px(
          in, row + x, base + (size_t)yn * W + x, base + (size_t)ys * W + x,
          row + xw, row + xe, s.px(kDu, y, x), s.px(kDv, y, x),
          s.px(kW, y, x), s.px(kW, yn, x), s.px(kW, ys, x), s.px(kW, y, xw),
          s.px(kW, y, xe), a.delta, a.gamma, a.beta);
      s.px(kRhs1, y, x) = c.rhs1c;
      s.px(kRhs2, y, x) = c.rhs2c;
      s.px(kP11, y, x) = c.p11;
      s.px(kP22, y, x) = c.p22;
      s.px(kA12, y, x) = c.a12;
      s.px(kInv, y, x) = c.inv;
    }
    __syncthreads();
    for (int j = 0; j < 2 * a.sor_iters; ++j) {
      const int c = j & 1;
      for (int idx = threadIdx.x; idx < H * hw2; idx += RESIDENT_THREADS) {
        const int r = idx / hw2, k = idx - r * hw2;
        const int off = (r + c) & 1;
        const int x = 2 * k + off;
        if (x >= W) continue;
        sor_px(s, c, r, k, off, r > 0, r < H - 1, x > 0, x < W - 1, a.omega,
               a.one_minus_omega);
      }
      __syncthreads();
    }
  }

  for (int idx = threadIdx.x; idx < n_px; idx += RESIDENT_THREADS) {
    const int y = idx / W, x = idx - y * W;
    a.du[base + idx] = s.px(kDu, y, x);
    a.dv[base + idx] = s.px(kDv, y, x);
  }
}

// Whether one pair's solve fits in one block's shared memory on the current
// device: the resident route's size rule.
cudaError_t takes_resident(int H, int W, bool* resident) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  *resident =
      e == cudaSuccess && K3_RESIDENT && resident_smem(H, W) <= (size_t)optin;
  return e;
}

// e, after counting the launch it reports when it is cudaSuccess.
cudaError_t counted(cudaError_t e) {
  if (e == cudaSuccess)
    __atomic_fetch_add(&tee_launch_count, 1ULL, __ATOMIC_RELAXED);
  return e;
}

// An error's code, with the runtime's last-error state cleared: a later
// call of this library must not read a refused launch's error as its own.
int fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

}  // namespace

extern "C" {

// Sets *resident to 1 where deepflow_solve takes the resident route at
// H x W on the current device (and needs no work buffer), else to 0.
// Returns a CUDA error code.
int deepflow_resident(int H, int W, int* resident) {
  bool r;
  const cudaError_t e = takes_resident(H, W, &r);
  *resident = r;
  return e == cudaSuccess ? 0 : fail(e);
}

// K3: the whole solve of one call. i1wx .. v0 are the ten (B, H, W) input
// planes, um/vm/conf the matching triple (all nullptr: none); du/dv receive
// the result; work holds 9 x B x H x W floats on the tiled route (the
// ping-pong's second du/dv and the seven coefficient planes) and may be
// nullptr on the resident one. Returns the first CUDA error, with the
// last-error state cleared; nothing is launched after it.
int deepflow_solve(const float* i1wx, const float* i1wy, const float* i1wxx,
                   const float* i1wxy, const float* i1wyy, const float* it,
                   const float* itx, const float* ity, const float* u0,
                   const float* v0, const float* um, const float* vm,
                   const float* conf, float* du, float* dv, float* work,
                   int B, int H, int W, int psi_iters, int sor_iters,
                   float omega, float one_minus_omega, float alpha,
                   float delta, float gamma, float beta, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)B * H * W;
  if (n == 0) return 0;
  cudaError_t e = cudaSuccess;
  if (psi_iters <= 0 || sor_iters <= 0) {  // the increments stay zero
    e = cudaMemsetAsync(du, 0, n * sizeof(float), st);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, n * sizeof(float), st);
    return e == cudaSuccess ? 0 : fail(e);
  }
  const Inputs in = {i1wx, i1wy, i1wxx, i1wxy, i1wyy, it,  itx,
                     ity,  u0,   v0,    um,    vm,    conf};
  bool resident;
  if ((e = takes_resident(H, W, &resident)) != cudaSuccess) return fail(e);

  if (resident) {
    const size_t smem = resident_smem(H, W);
    SolveArgs a = {in,        du,        dv,    H,     W,
                   psi_iters, sor_iters, omega, one_minus_omega,
                   alpha,     delta,     gamma, beta};
    e = cudaFuncSetAttribute(resident_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return fail(e);
    resident_kernel<<<B, RESIDENT_THREADS, smem, st>>>(a);
    return (int)counted(cudaGetLastError());
  }

  if (work == nullptr) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(sweep_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSweepSmem);
  if (e != cudaSuccess) return fail(e);
  const int tiles_x = (W + kEW - 2 * kR - 1) / (kEW - 2 * kR);
  const int tiles_y = (H + kEH - 2 * kR - 1) / (kEH - 2 * kR);

  float* coef = work + 2 * n;
  float* dus[2] = {du, work};
  float* dvs[2] = {dv, work + n};
  // start in the buffer that makes the last sweep launch write du/dv
  const int launches = psi_iters * ((sor_iters + kS - 1) / kS);
  int cur = launches & 1;
  bool first = true;
  const dim3 cgrid((W + CT_W - 1) / CT_W, (H + CT_H - 1) / CT_H, B);
  const dim3 sgrid(tiles_x * tiles_y, B);
  for (int p = 0; p < psi_iters; ++p) {
    CoefArgs ca;
    ca.in = in;
    ca.du = first ? nullptr : dus[cur];
    ca.dv = first ? nullptr : dvs[cur];
    for (int q = 0; q < 7; ++q) ca.out[q] = coef + q * n;
    ca.H = H;
    ca.W = W;
    ca.alpha = alpha;
    ca.delta = delta;
    ca.gamma = gamma;
    ca.beta = beta;
    coefs_kernel<<<cgrid, dim3(CT_W, CT_H), 0, st>>>(ca);
    if ((e = counted(cudaGetLastError())) != cudaSuccess) return (int)e;
    for (int done = 0; done < sor_iters; done += kS) {
      SweepArgs sa;
      for (int q = 0; q < 7; ++q) sa.coef[q] = coef + q * n;
      sa.du_in = first ? nullptr : dus[cur];
      sa.dv_in = first ? nullptr : dvs[cur];
      sa.du_out = dus[cur ^ 1];
      sa.dv_out = dvs[cur ^ 1];
      sa.H = H;
      sa.W = W;
      sa.n_half = 2 * (sor_iters - done < kS ? sor_iters - done : kS);
      sa.tiles_x = tiles_x;
      sa.omega = omega;
      sa.one_minus_omega = one_minus_omega;
      sweep_kernel<<<sgrid, K3_THREADS, kSweepSmem, st>>>(sa);
      if ((e = counted(cudaGetLastError())) != cudaSuccess) return (int)e;
      cur ^= 1;
      first = false;
    }
  }
  return 0;
}

}  // extern "C"
