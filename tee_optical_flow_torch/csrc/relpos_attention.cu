// ViT-Det's attention with the decomposed relative-position bias, for
// Hopper (sm_90a): scores, bias, softmax and weighted sum of one (image,
// head, query tile) in one block, on the tensor cores, with a plain C
// interface loaded through ctypes (tee_optical_flow_torch/ops/cuda_lib.py).
// Linked into one library with tvl1.cu, whose tvl1_error_string decodes the
// error codes returned here and whose tee_launch_count counts the launches.
//
// Replaces no Pallas kernel: the JAX package leaves the attention to XLA
// (tee_optical_flow_tpu/models/image_encoder.py). It replaces the plain
// PyTorch arithmetic of models/image_encoder.RelPosAttention._attend, which
// stays the CPU, float32 and autograd path:
//   s = (q k^T) * scale + (Qh[i, j / w] + Qw[i, j % w]),
//   out = bf16(softmax(s)) v,
// q, k, v bfloat16 (B, heads, N, hd), the products accumulated in float32,
// Qh = q . rel_h and Qw = q . rel_w the float32 bias projections (computed
// before the call by the module, read here by strides), N = h * w tokens on
// an h x w grid.
//
//   * What bounds it on this card: the operations. A vit_h global block on
//     4 frames (B 4, 16 heads, N 4,096, hd 80) is 4 B heads N^2 hd = 0.344
//     T operations of bfloat16 products accumulated in float32, 0.35 ms at
//     989.4 TFLOP/s, against 42 MB of q, k, v and output and 34 MB of the
//     two projections (0.023 ms at 3.35 TB/s). The plain version wrote the
//     (4, 16, 4096, 4096) float32 scores to device memory and read them
//     back in about eight elementwise passes (4.3 GB each) and ran both
//     products as float32 FFMA GEMMs (1.0% of the bound).
//   * What the design does about it (FlashAttention-2's schedule on
//     mma.sync m16n8k16): a block holds NW x MT x 16 query rows, each warp
//     MT tiles of 16 rows, and walks the keys in tiles of kBc = 64, K and V
//     double-buffered in shared memory by cp.async (rows past N are
//     zero-filled). QK^T and PV are bfloat16 tensor-core products with
//     float32 accumulators. The softmax is online, in float32: a running
//     maximum a row, the output rescaled when it grows. The scores and the
//     bias never reach device memory: the block copies its rows of the
//     projections into shared memory once and adds, for key j, Qh[i, j / w]
//     + Qw[i, j % w] to acc * scale, the plain version's order (built with
//     --fmad=false: the multiply and the adds stay separately rounded).
//     Where a key tile lies within one grid row (w a multiple of kBc: the
//     global blocks) Qh is one value a row and tile, read from device
//     memory, and a thread reads its two columns' Qw as one float2; else
//     (the windowed blocks' 14 x 14, the depth attention's 2 x 2) a table in
//     shared memory gives each key's two offsets into the row. The
//     exponential is expf (no approximate exp, no fast math).
//   * What the measurements on an H100 taught (a sweep of the geometries
//     and variant builds with a phase removed; PERF.md section 6): occupancy
//     and the products' scheduling decide, not the softmax's arithmetic
//     (without expf the global shape ran 15% faster, without the row sums'
//     adds no faster).
//     q's fragments come straight from device memory into registers, the
//     bias rows by cp.async with the first k and v tile, so a block holds
//     only k, v and the bias in shared memory; 8-warp blocks are capped at
//     128 registers, two to an SM. A full key tile (all but the last) runs
//     an instantiation without the partial tile's guards, which had split
//     the unrolled products into blocks whose shared-memory loads could not
//     overlap (-25%). Grids whose key tiles lie within a grid row (the
//     global blocks) take 4 warps of two row tiles (every k and v fragment
//     feeds two products; q's fragments are then read from shared memory
//     at each k-step, as registers do not hold both): 2-8% faster than 8
//     warps of one at 16x64 and vit_h's 64x64, within 4% at vit_b's. Other
//     grids (the windowed blocks) take 8 warps of one: 19-30% faster at
//     14x14, 40x40 and 48x48, within 8% either way between them
//     (ops/attention_kernels.attention_geometry). vit_h: 1.75 ms global
//     and 0.29 ms windowed, 20% and 24% of the kernel's own bound.
//   * Precision, as the configuration states it: bfloat16 operands,
//     float32 products, bias and softmax; P is rounded to bfloat16 for the
//     second product, as the plain version casts its softmax to the
//     module's type. Here P is unnormalised (exp(s - running max)), and the
//     row sums are P times a block of ones on the tensor cores, so the
//     weights that multiply v sum to one before the output's rounding; the
//     plain version rounds the normalised P. The output is bfloat16,
//     written in (B, N, heads, hd) order, so the projection's input is a
//     view.
//   * Shapes: any N (ragged query and key tiles masked; a partial key tile's
//     products stop at its last 16 valid keys), hd 64 or 80 (5 k-steps of
//     16 and an n-width of 80 for hd 80: no padding to 128).
//
// Every launch that returned cudaSuccess adds one to tee_launch_count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// The library's launch count, defined in tvl1.cu.
extern "C" unsigned long long tee_launch_count;

namespace {

constexpr int kBc = 64;   // keys a tile
constexpr int kPad = 8;   // bfloat16 padding of a shared q, k or v row

cudaError_t counted(cudaError_t e) {
  if (e == cudaSuccess)
    __atomic_fetch_add(&tee_launch_count, 1ULL, __ATOMIC_RELAXED);
  return e;
}

struct Params {
  const __nv_bfloat16* qkv;  // q of (image 0, token 0, head 0)
  const float* qh;           // (B, heads, h, w, h), by the strides below
  const float* qw;           // (B, heads, h, w, w), by the strides below
  __nv_bfloat16* out;        // (B, N, heads, hd), contiguous
  long long sb, sn, s3, sh;  // qkv's element strides: image, token, q/k/v,
                             // head (the head's hd values are contiguous)
  int N, heads, h, w;
  int tiles;                 // query tiles a (image, head)
  int key_tiles;             // ceil(N / kBc)
  long long qh_b, qh_y, qh_r, qh_c;  // qh's strides: image, head, grid
  long long qw_b, qw_y, qw_r, qw_c;  // row, grid column (k: 1)
  int sbias;                 // floats a row of the shared bias table
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4 bytes global -> shared, asynchronously; zero where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kGroups>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kGroups));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0,
                                              uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a b: a 16x16 bfloat16 (row), b 16x8 bfloat16 (col), d float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// k and v (two stages each) and, where a warp holds two row tiles, q's
// tile: q's fragments are then read from shared memory at each k-step
// rather than held in registers
template <int HD, int NW, int MT>
__host__ __device__ constexpr size_t operand_bytes() {
  return (size_t)(4 * kBc + (MT > 1 ? NW * MT * 16 : 0)) * (HD + kPad) * 2;
}

// One key tile for one warp: s = q k^T, the bias, the online softmax and
// o += P v, with the row sums of P in l. kFull: all kBc keys are valid,
// so no product is skipped and no score masked (every tile but the last);
// the guards of a partial tile would split the unrolled products into
// small blocks that cannot overlap their shared-memory loads.
template <int HD, int MT, bool kTileRow, bool kFull>
__device__ __forceinline__ void attend_tile(
    const Params& p, const __nv_bfloat16* Qs, const __nv_bfloat16* Ks,
    const __nv_bfloat16* Vs, const float* sBias, const int* sIdx, int wrow,
    int lane, int j0,
    int valid, int kw0, const float (&qh)[MT][2],
    const uint32_t (&qf)[MT][HD / 16][4], float (&o)[MT][HD / 8][4],
    float (&l)[MT][4], float (&m)[MT][2]) {
  constexpr int kLd = HD + kPad;
  constexpr int kKs = HD / 16;
  constexpr int kDn = HD / 8;
  const int g = lane >> 2, t4 = lane & 3;

  // s = q k^T over the tile's keys, 16 at a time
  float s[MT][kBc / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < kBc / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (MT > 1) {
        ldsm_x4(smem_u32(Qs + (wrow + mt * 16 + (lane & 15)) * kLd + kk * 16 +
                         (lane >> 4) * 8),
                a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt][kk][e];
      }
    }
#pragma unroll
    for (int np = 0; np < kBc / 16; ++np) {
      if (kFull || np * 16 < valid) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(smem_u32(Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                         kk * 16 + ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b0, b1);
          mma_bf16(s[mt][2 * np + 1], a[mt], b2, b3);
        }
      }
    }
  }

  // the scores with their bias, the online softmax, P in bfloat16
  uint32_t pf[MT][kBc / 8][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* br0 = sBias + (wrow + mt * 16 + g) * p.sbias;
    const float* br1 = br0 + 8 * p.sbias;
#pragma unroll
    for (int nb = 0; nb < kBc / 8; ++nb) {
      const int col = nb * 8 + t4 * 2;
      float b00, b01, b10, b11;   // bias (row g or g + 8, column c)
      if (kTileRow) {
        const float2 w0 = *reinterpret_cast<const float2*>(br0 + kw0 + col);
        const float2 w1 = *reinterpret_cast<const float2*>(br1 + kw0 + col);
        b00 = qh[mt][0] + w0.x;
        b01 = qh[mt][0] + w0.y;
        b10 = qh[mt][1] + w1.x;
        b11 = qh[mt][1] + w1.y;
      } else {
        const int i0 = sIdx[j0 + col], i1 = sIdx[j0 + col + 1];
        b00 = br0[i0 >> 16] + br0[i0 & 0xffff];
        b01 = br0[i1 >> 16] + br0[i1 & 0xffff];
        b10 = br1[i0 >> 16] + br1[i0 & 0xffff];
        b11 = br1[i1 >> 16] + br1[i1 & 0xffff];
      }
      s[mt][nb][0] = s[mt][nb][0] * p.scale + b00;
      s[mt][nb][1] = s[mt][nb][1] * p.scale + b01;
      s[mt][nb][2] = s[mt][nb][2] * p.scale + b10;
      s[mt][nb][3] = s[mt][nb][3] * p.scale + b11;
      if (!kFull) {   // keys past N weigh nothing
        if (col >= valid) s[mt][nb][0] = s[mt][nb][2] = -INFINITY;
        if (col + 1 >= valid) s[mt][nb][1] = s[mt][nb][3] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kBc / 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[mt][nb][0], s[mt][nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[mt][nb][2], s[mt][nb][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile has a valid key, so the new maxima are finite
    const float mn0 = fmaxf(m[mt][0], mx0), mn1 = fmaxf(m[mt][1], mx1);
    const float c0 = expf(m[mt][0] - mn0), c1 = expf(m[mt][1] - mn1);
    m[mt][0] = mn0;
    m[mt][1] = mn1;
#pragma unroll
    for (int nb = 0; nb < kBc / 8; ++nb) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(
          expf(s[mt][nb][0] - mn0), expf(s[mt][nb][1] - mn0));
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(
          expf(s[mt][nb][2] - mn1), expf(s[mt][nb][3] - mn1));
      pf[mt][nb][0] = *reinterpret_cast<const uint32_t*>(&p0);
      pf[mt][nb][1] = *reinterpret_cast<const uint32_t*>(&p1);
    }
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      o[mt][dn][0] *= c0;
      o[mt][dn][1] *= c0;
      o[mt][dn][2] *= c1;
      o[mt][dn][3] *= c1;
    }
    l[mt][0] *= c0;
    l[mt][1] *= c0;
    l[mt][2] *= c1;
    l[mt][3] *= c1;
  }

  // o += P v over the tile's keys, 16 at a time; l += P times ones
  const uint32_t kOnes = 0x3f803f80u;   // two bfloat16 ones
#pragma unroll
  for (int kj = 0; kj < kBc / 16; ++kj) {
    if (kFull || kj * 16 < valid) {
#pragma unroll
      for (int dp = 0; dp < kDn / 2; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(
            smem_u32(Vs + (kj * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                     dp * 16 + (lane >> 4) * 8),
            b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a[4] = {pf[mt][2 * kj][0], pf[mt][2 * kj][1],
                                 pf[mt][2 * kj + 1][0], pf[mt][2 * kj + 1][1]};
          mma_bf16(o[mt][2 * dp], a, b0, b1);
          mma_bf16(o[mt][2 * dp + 1], a, b2, b3);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t a[4] = {pf[mt][2 * kj][0], pf[mt][2 * kj][1],
                               pf[mt][2 * kj + 1][0], pf[mt][2 * kj + 1][1]};
        mma_bf16(l[mt], a, kOnes, kOnes);
      }
    }
  }
}

// One block: the query rows [tile * kBr, tile * kBr + kBr) of one (image,
// head), against every key. kTileRow: w is a multiple of kBc, so a key tile
// lies within one row of the grid.
template <int HD, int NW, int MT, bool kTileRow>
__global__ void __launch_bounds__(NW * 32, NW == 8 ? 2 : 1)
    relpos_attention_kernel(const Params p) {
  constexpr int kBr = NW * MT * 16;
  constexpr int kLd = HD + kPad;
  constexpr int kKs = HD / 16;      // k-steps of q k^T
  constexpr int kDn = HD / 8;       // n-blocks of P v
  constexpr int kChunks = HD / 8;   // 16-byte chunks a row
  constexpr int kThreads = NW * 32;
  static_assert(HD % 16 == 0, "hd: whole k-steps");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 stages
  __nv_bfloat16* sV = sK + 2 * kBc * kLd;                        // 2 stages
  __nv_bfloat16* sQ = sV + 2 * kBc * kLd;   // MT > 1 only
  float* sBias = reinterpret_cast<float*>(
      smem + operand_bytes<HD, NW, MT>());
  int* sIdx = reinterpret_cast<int*>(sBias + kBr * p.sbias);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x % p.tiles;
  const int bh = blockIdx.x / p.tiles;      // image * heads + head
  const int b = bh / p.heads, head = bh % p.heads;
  const int N = p.N, h = p.h, w = p.w;
  const int row0 = tile * kBr;
  const __nv_bfloat16* gq = p.qkv + b * p.sb + head * p.sh;
  const __nv_bfloat16* gk = gq + p.s3;
  const __nv_bfloat16* gv = gq + 2 * p.s3;

  auto load_kv = [&](int t, int stage) {
    const int j0 = t * kBc;
    for (int c = tid; c < kBc * kChunks; c += kThreads) {
      const int r = c / kChunks, ch = c % kChunks;
      const bool ok = j0 + r < N;
      const long long off = (long long)(ok ? j0 + r : 0) * p.sn + ch * 8;
      const int at = (stage * kBc + r) * kLd + ch * 8;
      cp_async16(smem_u32(sK + at), gk + off, ok);
      cp_async16(smem_u32(sV + at), gv + off, ok);
    }
  };
  if (MT > 1) {
    for (int c = tid; c < kBr * kChunks; c += kThreads) {
      const int r = c / kChunks, ch = c % kChunks;
      const bool ok = row0 + r < N;
      cp_async16(smem_u32(sQ + r * kLd + ch * 8),
                 gq + (long long)(ok ? row0 + r : 0) * p.sn + ch * 8, ok);
    }
  }
  load_kv(0, 0);

  // the block's rows of the bias projections, one table row a query row
  // (zeros past N): Qw, and after it Qh where a tile spans grid rows; in
  // the first group of copies
  const float* gqh = p.qh + b * p.qh_b + head * p.qh_y;
  const float* gqw = p.qw + b * p.qw_b + head * p.qw_y;
  const int cols = kTileRow ? w : w + h;
#pragma unroll
  for (int r = warp; r < kBr; r += NW) {
    const int n = min(row0 + r, N - 1), gr = n / w, gc = n - gr * w;
    const float* rh = gqh + gr * p.qh_r + gc * p.qh_c;
    const float* rw = gqw + gr * p.qw_r + gc * p.qw_c;
    for (int c = lane; c < cols; c += 32)
      cp_async4(smem_u32(sBias + r * p.sbias + c), c < w ? rw + c : rh + c - w,
                row0 + r < N);
  }
  cp_commit();
  if (!kTileRow) {
    // key j -> (its Qw offset j % w) | (its Qh offset w + j / w) << 16
    for (int j = tid; j < p.key_tiles * kBc; j += kThreads)
      sIdx[j] = j < N ? (j % w) | ((w + j / w) << 16) : 0;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * MT * 16;          // the warp's first row
  const bool active = row0 + wrow < N;      // uniform in the warp
  // the thread's rows of qh, as offsets from the head's (the within-a-row
  // path reads one value a tile)
  int qh_row[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = min(row0 + wrow + mt * 16 + g + 8 * e, N - 1);
      const int gr = n / w;
      qh_row[mt][e] = (int)(gr * p.qh_r + (n - gr * w) * p.qh_c);
    }
  // q's fragments (m16n8k16's A layout), straight from device memory, where
  // a warp holds one row tile
  uint32_t qf[MT][kKs][4];
#pragma unroll
  for (int mt = 0; mt < (MT > 1 ? 0 : MT); ++mt) {
    const int ra = row0 + wrow + mt * 16 + g, rb = ra + 8;
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        gq + (long long)(ra < N ? ra : 0) * p.sn + t4 * 2);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        gq + (long long)(rb < N ? rb : 0) * p.sn + t4 * 2);
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      qf[mt][kk][0] = active && ra < N ? __ldg(qa + kk * 8) : 0u;
      qf[mt][kk][1] = active && rb < N ? __ldg(qb + kk * 8) : 0u;
      qf[mt][kk][2] = active && ra < N ? __ldg(qa + kk * 8 + 4) : 0u;
      qf[mt][kk][3] = active && rb < N ? __ldg(qb + kk * 8 + 4) : 0u;
    }
  }
  // the weighted sum, and beside it the row sums of P: P times a block
  // of ones on the tensor cores, so the sums add exactly the rounded
  // values that multiply v (columns 0 and 1 of l hold row g, 2 and 3 row
  // g + 8)
  float o[MT][kDn][4], l[MT][4];
  float m[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dn][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) l[mt][e] = 0.0f;
    m[mt][0] = m[mt][1] = -INFINITY;
  }

  for (int t = 0; t < p.key_tiles; ++t) {
    if (t + 1 < p.key_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      const __nv_bfloat16* Ks = sK + (t & 1) * kBc * kLd;
      const __nv_bfloat16* Vs = sV + (t & 1) * kBc * kLd;
      const int j0 = t * kBc;
      const int valid = min(kBc, N - j0);   // keys of this tile
      // within a grid row: the tile's one Qh value a row
      float qh[MT][2];
      int kw0 = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) qh[mt][0] = qh[mt][1] = 0.0f;
      if (kTileRow) {
        const int th = j0 / w;
        kw0 = j0 - th * w;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          qh[mt][0] = __ldg(gqh + qh_row[mt][0] + th);
          qh[mt][1] = __ldg(gqh + qh_row[mt][1] + th);
        }
      }
      if (valid == kBc)
        attend_tile<HD, MT, kTileRow, true>(p, sQ, Ks, Vs, sBias, sIdx,
                                            wrow, lane, j0, valid, kw0, qh,
                                            qf, o, l, m);
      else
        attend_tile<HD, MT, kTileRow, false>(p, sQ, Ks, Vs, sBias, sIdx,
                                             wrow, lane, j0, valid, kw0, qh,
                                             qf, o, l, m);
    }
    __syncthreads();   // the stage read here is the next load's target
  }

  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l0 = l[mt][0], l1 = l[mt][2];
    const int n0 = row0 + wrow + mt * 16 + g, n1 = n0 + 8;
    __nv_bfloat16* out0 =
        p.out + (((long long)b * N + n0) * p.heads + head) * HD + t4 * 2;
    __nv_bfloat16* out1 = out0 + 8LL * p.heads * HD;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      if (n0 < N)
        *reinterpret_cast<__nv_bfloat162*>(out0 + dn * 8) =
            __floats2bfloat162_rn(o[mt][dn][0] / l0, o[mt][dn][1] / l0);
      if (n1 < N)
        *reinterpret_cast<__nv_bfloat162*>(out1 + dn * 8) =
            __floats2bfloat162_rn(o[mt][dn][2] / l1, o[mt][dn][3] / l1);
    }
  }
}

template <int HD, int NW, int MT, bool kTileRow>
cudaError_t launch(const Params& p, long long blocks, cudaStream_t st) {
  constexpr int kBr = NW * MT * 16;
  const size_t smem = operand_bytes<HD, NW, MT>() +
                      (size_t)kBr * p.sbias * sizeof(float) +
                      (kTileRow ? 0 : (size_t)p.key_tiles * kBc * sizeof(int));
  auto kernel = relpos_attention_kernel<HD, NW, MT, kTileRow>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, NW * 32, smem, st>>>(p);
  return counted(cudaGetLastError());
}

template <int HD, bool kTileRow>
cudaError_t launch_geometry(const Params& p, int B, int warps, int m_tiles,
                            cudaStream_t st) {
  const int rows = warps * m_tiles * 16;
  Params q = p;
  q.tiles = (p.N + rows - 1) / rows;
  const long long blocks = (long long)q.tiles * B * p.heads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  // the production pairs (ops/attention_kernels.attention_geometry):
  // 4 x 2 within a grid row, 8 x 1 across rows
  if (kTileRow && warps == 4 && m_tiles == 2)
    return launch<HD, 4, 2, kTileRow>(q, blocks, st);
  if (!kTileRow && warps == 8 && m_tiles == 1)
    return launch<HD, 8, 1, kTileRow>(q, blocks, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The attention of B images x heads heads over N = h * w tokens: q, k and
// v are read from qkv (q at element 0; image, token, q/k/v and head strides
// sb, sn, s3, sh; a head's hd values contiguous, 16-byte aligned), the
// float32 bias projections qh (B, heads, h, w, h) and qw (B, heads, h, w,
// w) by the image, head, grid row and grid column strides in
// bias_strides (qh's four, then qw's; a row's values contiguous), out is a
// contiguous bfloat16 (B, N, heads, hd). A block of `warps` warps holds
// warps x m_tiles x 16 query rows; tile_row != 0 takes the
// within-a-grid-row bias path (w a multiple of 64). The library takes 4 x
// 2 with tile_row and 8 x 1 without. Launches on the caller's stream;
// nothing waits. Returns the CUDA error
// (cudaErrorInvalidValue for an hd, geometry or shape it does not take),
// with the runtime's last-error state cleared.
int rel_pos_attention(const void* qkv, const float* qh, const float* qw,
                      const long long* bias_strides, void* out, int B, int N,
                      int heads, int hd, int h, int w, long long sb,
                      long long sn, long long s3, long long sh,
                      float scale, int warps, int m_tiles, int tile_row,
                      void* stream) {
  if (B <= 0 || N <= 0 || heads <= 0) return 0;
  if (h <= 0 || w <= 0 || (long long)h * w != N || w + h > 0xffff ||
      (tile_row && w % kBc))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.qh = qh;
  p.qw = qw;
  p.qh_b = bias_strides[0];
  p.qh_y = bias_strides[1];
  p.qh_r = bias_strides[2];
  p.qh_c = bias_strides[3];
  p.qw_b = bias_strides[4];
  p.qw_y = bias_strides[5];
  p.qw_r = bias_strides[6];
  p.qw_c = bias_strides[7];
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sb = sb;
  p.sn = sn;
  p.s3 = s3;
  p.sh = sh;
  p.N = N;
  p.heads = heads;
  p.h = h;
  p.w = w;
  p.tiles = 0;
  p.key_tiles = (N + kBc - 1) / kBc;
  // a table row (Qw, and Qh unless a key tile lies within a grid row)
  // padded to 8 mod 32 words: the float2 reads of a warp's 8 rows x 4
  // column pairs fall on distinct banks
  const int cols = tile_row ? w : w + h;
  p.sbias = (cols + 23) / 32 * 32 + 8;
  p.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  if (hd == 80)
    e = tile_row ? launch_geometry<80, true>(p, B, warps, m_tiles, st)
                 : launch_geometry<80, false>(p, B, warps, m_tiles, st);
  else if (hd == 64)
    e = tile_row ? launch_geometry<64, true>(p, B, warps, m_tiles, st)
                 : launch_geometry<64, false>(p, B, warps, m_tiles, st);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

}  // extern "C"
