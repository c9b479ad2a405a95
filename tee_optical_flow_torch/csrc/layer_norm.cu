// ViT-Det's per-token residual pass, for Hopper (sm_90a): the residual add,
// the float32 layer norm and the bfloat16 cast of a block's tokens in one
// read and one write, reading and writing the windowed attention's layout
// by index. A plain C interface loaded through ctypes
// (tee_optical_flow_torch/ops/cuda_lib.py); linked into one library with
// tvl1.cu, whose tvl1_error_string decodes the error codes returned here
// and whose tee_launch_count counts the launches.
//
// Replaces no Pallas kernel: the JAX package leaves the norm to XLA
// (tee_optical_flow_tpu/models/common.py, layer_norm;
// models/image_encoder.py, Block). It replaces the plain PyTorch sequence
// of models/image_encoder.Block.forward around the attention, which stays
// the CPU, float32, training, adapter and depth-branch path, and whose
// plain version is models/image_encoder.residual_norm_plain:
//   LN1:       normed = bf16(layer_norm(x, norm1)), written in the
//              (B nh nw, ws, ws, C) window layout the qkv product reads
//              (window positions past the h x w grid written as 0, the bits
//              of window_partition's zero pad of the float32 map, cast), or
//              (B, H, W, C) in a global block (ws 0);
//   add + LN2: x = shortcut + float32(branch), branch the bfloat16 output
//              of attn.proj read from the window layout (cropped to the
//              grid) or (B, H, W, C); normed = bf16(layer_norm(x, norm2)),
//              (B, H, W, C); both x and normed written.
// layer_norm's arithmetic, in its order, all in float32 (built with
// --fmad=false: every multiply and add separately rounded):
//   mu = (sum x) / C, var = max((sum x*x) / C - mu*mu, 0),
//   y = (x - mu) * ((1 / sqrt(var + eps)) * weight) + bias,
// rounded to bfloat16 (nearest, ties to even) last. The residual add is one
// float32 add of the two values, bit-equal to `shortcut + branch`.
//
//   * Reduction order (the only departure from the plain version's sums):
//     a row of C = 256 J floats is one warp's; lane l holds the 8 J values
//     at columns 8 (l + 32 j) + k, j < J, k < 8, and sums them (and, apart,
//     their squares) in the order (j, k), from 0. The 32 lane sums then
//     meet in an xor butterfly (offsets 16, 8, 4, 2, 1): lane l adds lane
//     l ^ 16's sum, then l ^ 8's, ...; every lane ends with the same bits,
//     as float addition commutes. The mean and E[x^2] divide the sums by C
//     (the CPU's torch.mean; on a card torch multiplies by 1/C); the
//     reciprocal square root is 1 / sqrtf, both IEEE-exact without fast
//     math (torch.rsqrt is within an ulp of it).
//     tests/test_torch_norm_kernel.py emulates this order on the CPU and
//     holds the kernel to the emulation bit for bit on the card.
//   * What bounds it on this card: the bytes. vit_h's micro-batch of 4
//     frames is 16,384 tokens x 1280: LN1 reads the 83.9 MB float32 stream
//     and writes 50.2 MB of bfloat16 windows (19,600 window rows, the pad
//     included), 0.040 ms at 3.35 TB/s; add + LN2 reads the stream and the
//     branch (41.9 MB of bfloat16 windows read, the pad not) and writes the
//     stream and 41.9 MB of normed tokens, 0.075 ms. The plain sequence
//     moves about 33 such planes' worth of bytes around a windowed block
//     and 27 around a global one.
//   * What the design does about it: one warp a token row, held in
//     registers (40 floats a lane at 1280); every global access is 16
//     bytes a lane (two float4 of the stream, one 8-value bfloat16 vector
//     of the branch or the output), the 32 lanes of a warp on 1,024
//     contiguous bytes of the float32 row; both sums by shuffles, no shared
//     memory. 8 warps (rows) a block, a block per 8 rows: vit_h's 16,384
//     rows fill the card's 132 SMs at several blocks each. weight and bias
//     are read through the read-only cache at every row (2 C floats, the
//     same for every row: they stay in L1).
//     On an H100 (PERF.md section 6): vit_h's windowed block LN1 0.049 ms
//     and add + LN2 0.089 ms, 80-84% of that bound, against 1.29 ms for
//     the plain sequence on a contiguous stream.
//   * Shapes: C = 768, 1024 or 1280 (vit_b, vit_l, vit_h; J = 3, 4, 5), any
//     H, W and window; the tensors contiguous and 16-byte aligned.
//
// Every launch that returned cudaSuccess adds one to tee_launch_count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The library's launch count, defined in tvl1.cu.
extern "C" unsigned long long tee_launch_count;

namespace {

constexpr int kWarps = 8;  // token rows a block, one a warp

cudaError_t counted(cudaError_t e) {
  if (e == cudaSuccess)
    __atomic_fetch_add(&tee_launch_count, 1ULL, __ATOMIC_RELAXED);
  return e;
}

struct Params {
  const float* x;               // (B, H, W, C) float32 stream
  const __nv_bfloat16* branch;  // add + LN2: the attention's output
  const float* weight;          // (C,)
  const float* bias;            // (C,)
  float* x_out;                 // add + LN2: (B, H, W, C), x + branch
  __nv_bfloat16* normed;        // bfloat16 normed tokens
  long long rows;               // rows the launch walks (see below)
  int H, W, ws, nh, nw;         // grid, window, windows down and across
  float eps;
};

// Row `row` of a launch: a grid row (b, y, x) of x, except for LN1 in a
// windowed block, where it is a row of the window layout, (window, iy,
// ix), window = (b nh + wy) nw + wx, at grid (wy ws + iy, wx ws + ix).
template <int J, bool kAdd, bool kWindow>
__global__ void __launch_bounds__(kWarps * 32)
    residual_norm_kernel(const Params p) {
  constexpr int C = 256 * J;
  constexpr int V = 8 * J;  // values a lane
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;  // the whole warp: the shuffles see all lanes
  long long src = row;   // the row of x (and x_out)
  long long brow = row;  // the row of branch
  if (kWindow) {
    if (kAdd) {
      const long long hw = (long long)p.H * p.W;
      const long long b = row / hw;
      const int rem = (int)(row - b * hw);
      const int y = rem / p.W, x = rem - y * p.W;
      brow = (((b * p.nh + y / p.ws) * p.nw + x / p.ws) * p.ws + y % p.ws) *
                 p.ws +
             x % p.ws;
    } else {
      const int ws2 = p.ws * p.ws;
      const long long win = row / ws2;
      const int t = (int)(row - win * ws2);
      const int per = p.nh * p.nw;
      const long long b = win / per;
      const int wr = (int)(win - b * per);
      const int y = (wr / p.nw) * p.ws + t / p.ws;
      const int x = (wr % p.nw) * p.ws + t % p.ws;
      if (y >= p.H || x >= p.W) {  // window padding: zeros
        uint4* out = reinterpret_cast<uint4*>(p.normed + row * C);
#pragma unroll
        for (int j = 0; j < J; ++j)
          out[lane + 32 * j] = make_uint4(0, 0, 0, 0);
        return;
      }
      src = (b * p.H + y) * p.W + x;
    }
  }

  float v[V];
  const float4* xr = reinterpret_cast<const float4*>(p.x + src * C);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float4 a = __ldg(xr + 2 * (lane + 32 * j));
    const float4 b = __ldg(xr + 2 * (lane + 32 * j) + 1);
    v[8 * j + 0] = a.x;
    v[8 * j + 1] = a.y;
    v[8 * j + 2] = a.z;
    v[8 * j + 3] = a.w;
    v[8 * j + 4] = b.x;
    v[8 * j + 5] = b.y;
    v[8 * j + 6] = b.z;
    v[8 * j + 7] = b.w;
  }
  if (kAdd) {
    const uint4* br = reinterpret_cast<const uint4*>(p.branch + brow * C);
    float4* xo = reinterpret_cast<float4*>(p.x_out + src * C);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint4 raw = __ldg(br + lane + 32 * j);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h2[k]);
        v[8 * j + 2 * k] = v[8 * j + 2 * k] + f.x;
        v[8 * j + 2 * k + 1] = v[8 * j + 2 * k + 1] + f.y;
      }
      xo[2 * (lane + 32 * j)] =
          make_float4(v[8 * j], v[8 * j + 1], v[8 * j + 2], v[8 * j + 3]);
      xo[2 * (lane + 32 * j) + 1] = make_float4(v[8 * j + 4], v[8 * j + 5],
                                                v[8 * j + 6], v[8 * j + 7]);
    }
  }

  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s1 = s1 + v[i];
#pragma unroll
  for (int i = 0; i < V; ++i) s2 = s2 + v[i] * v[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 = s1 + __shfl_xor_sync(0xffffffffu, s1, off);
    s2 = s2 + __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mu = s1 / (float)C;
  float var = s2 / (float)C - mu * mu;
  var = var < 0.f ? 0.f : var;  // torch.clamp(min=0): a NaN stays NaN
  const float rstd = 1.f / sqrtf(var + p.eps);

  const float4* wv = reinterpret_cast<const float4*>(p.weight);
  const float4* bv = reinterpret_cast<const float4*>(p.bias);
  uint4* out = reinterpret_cast<uint4*>(p.normed + row * C);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = 2 * (lane + 32 * j);
    const float4 w0 = __ldg(wv + q), w1 = __ldg(wv + q + 1);
    const float4 b0 = __ldg(bv + q), b1 = __ldg(bv + q + 1);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 packed;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float y0 = (v[8 * j + 2 * k] - mu) * (rstd * w[2 * k]) + bb[2 * k];
      const float y1 =
          (v[8 * j + 2 * k + 1] - mu) * (rstd * w[2 * k + 1]) + bb[2 * k + 1];
      o[k] = __floats2bfloat162_rn(y0, y1);
    }
    out[lane + 32 * j] = packed;
  }
}

template <int J>
cudaError_t launch_width(const Params& p, bool add, cudaStream_t st) {
  const dim3 grid((unsigned)((p.rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const bool window = p.ws > 0;
  if (add && window)
    residual_norm_kernel<J, true, true><<<grid, block, 0, st>>>(p);
  else if (add)
    residual_norm_kernel<J, true, false><<<grid, block, 0, st>>>(p);
  else if (window)
    residual_norm_kernel<J, false, true><<<grid, block, 0, st>>>(p);
  else
    residual_norm_kernel<J, false, false><<<grid, block, 0, st>>>(p);
  return counted(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of the pass over the (B, H, W, C) float32 stream x, C 768,
// 1024 or 1280, window ws (0: a global block). branch NULL: LN1, normed
// the bfloat16 window layout (B nh nw, ws, ws, C), nh = ceil(H / ws), nw =
// ceil(W / ws), or (B, H, W, C) with ws 0; x_out unused. branch non-NULL:
// add + LN2, branch bfloat16 in that window layout (or (B, H, W, C)),
// x_out and normed (B, H, W, C). Every tensor contiguous, 16-byte aligned;
// x_out does not overlap x. Launches on the caller's stream; nothing waits.
// Returns the CUDA error (cudaErrorInvalidValue for a width or shape it
// does not take), with the runtime's last-error state cleared.
int residual_norm(const float* x, const void* branch, const float* weight,
                  const float* bias, float* x_out, void* normed, int B, int H,
                  int W, int C, int ws, float eps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || ws < 0 || (branch && !x_out))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.branch = static_cast<const __nv_bfloat16*>(branch);
  p.weight = weight;
  p.bias = bias;
  p.x_out = x_out;
  p.normed = static_cast<__nv_bfloat16*>(normed);
  p.H = H;
  p.W = W;
  p.ws = ws;
  p.nh = ws ? (H + ws - 1) / ws : 1;
  p.nw = ws ? (W + ws - 1) / ws : 1;
  p.eps = eps;
  const bool add = branch != nullptr;
  p.rows = (add || ws == 0) ? (long long)B * H * W
                            : (long long)B * p.nh * p.nw * ws * ws;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  if (C == 768)
    e = launch_width<3>(p, add, st);
  else if (C == 1024)
    e = launch_width<4>(p, add, st);
  else if (C == 1280)
    e = launch_width<5>(p, add, st);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // extern "C"
