// The masks' labelling for Hopper (sm_90a): connected components by
// neighbour-min propagation run until no id changes, many rounds per launch
// on shared-memory tiles, with a plain C interface loaded through ctypes
// (tee_optical_flow_torch/ops/cuda_lib.py). Linked into one library with
// tvl1.cu, whose tvl1_error_string decodes the error codes returned here
// and whose tee_launch_count counts the launches.
//
// Replaces no Pallas kernel: the JAX package labels with a lax.fori_loop
// stencil of a fixed 2*(H+W) rounds that XLA compiles
// (tee_optical_flow_tpu/ops/morphology.py:49-91). The plain PyTorch version
// of that loop (ops/morphology.connected_components_plain) ran each round
// as six elementwise kernels that moved about eight stacks of ids through
// device memory, at ~75% of the card's bandwidth; the work itself needs
// far less.
//
// A round, as the plain loop computes it on a (N, H, W) stack of int32 ids
// (big = H*W; pixels outside the image read as big, F.pad(value=big)):
//   ids = where(mask, min(ids, min over the neighbours), big)
// over the cross (connectivity 1) or the 3x3 square (connectivity 2), and
// the first ids are where(mask, linear index in the frame, big). A
// foreground pixel's id is always below big and a background pixel's is
// big, so after the first pass the ids alone carry the mask: a pixel with
// id big keeps big, every other takes the least id of its neighbourhood.
//
//   * What bounds it on this card: the rounds' integer work, not the bytes.
//     Each pixel-round is about 5 integer operations (four minimums and the
//     foreground select): 40 x 480 x 640 x 2,240 rounds is 138 G operations,
//     2.05 ms at 67 T/s, against 61 MB of mask read and ids written (0.02 ms
//     at 3.35 TB/s). Integer minimums run at half the float32 rate (64 a
//     clock an SM), and the exchange between neighbouring columns costs
//     three shared-memory accesses a pixel-round on top. On an H100 the
//     fixed-round kernel took 37.2 ms there (chip_smoke.labelling_tuning):
//     740 G useful pixel-rounds a second, 1.2 T computed with the halos'
//     1.6x.
//   * What the design does about it, following the block loop's schedule
//     (tvl1.cu's K2_S: S steps a launch on an extended tile with a halo of
//     S, ping-pong between launches): a pass is one launch of up to LB_R
//     rounds. A block loads an extended tile of LB_EW x LB_EH ids (its
//     output tile and a halo of LB_R pixels on every side; the first pass
//     builds them from the mask), runs the pass's rounds on it, and writes
//     only its output tile. Each thread holds one column of the extended
//     tile in registers, so the vertical neighbours cost nothing; a round
//     publishes every column to shared memory, and after a barrier each
//     thread reads its left and right neighbours' columns from there
//     (consecutive threads on consecutive words: no bank conflicts). A
//     second barrier ends the round before the next one's writes.
//   * The rounds are Jacobi rounds, as the plain loop's: every round reads
//     the previous round's values only. At the extended tile's edge a
//     missing neighbour reads as the pixel itself, so the values there are
//     wrong, and the wrong region grows inward by one pixel a round (the
//     cross's dependency cone lies inside the square's, so one halo serves
//     both connectivities). After LB_R rounds the output tile is exact.
//   * Convergence: pass p ping-pongs from buffer (p - 1) % 2 into p % 2 (a
//     tile is its neighbours' halo, so an in-place write would race) and
//     sets flags[p] when a block's output tile changed. A round only lowers
//     ids, and the output tile is exact in every round of a pass, so a
//     thread compares the sum of its output column's ids before and after
//     the pass (64-bit: equal sums of values that can only fall mean no
//     value fell). A pass whose predecessor left its flag at 0 returns at
//     once: the first quiet pass reached the fixed point, and it wrote the
//     same ids it read, so the buffer it wrote holds the labels whatever
//     passes follow. The host launches passes in groups and reads the
//     group's flags after each (ops/morphology._label_on_card); the
//     rounds are the plain loop's, pass for pass, and H*W rounds cap them.
//     Where 2*(H+W) rounds converge, the labels are the JAX package's bits.
//   * LB_R and the tile are compile-time constants chosen by measurement
//     (chip_smoke.labelling_tuning rebuilds this file with -D overrides):
//     R = 8 on 256x48, at most 85 registers a thread, three blocks an SM.
//     Taller tiles cut the halo's share but take registers: R = 16 on
//     256x64 at two blocks an SM ran 4-20% slower, on 256x96 at one block
//     (255 registers, spilling) 42-46% slower. Computing only the rows that
//     the output tile still needs (the valid region shrinks a row a round)
//     took uniform branches in the unrolled loop and ran 30-50% slower.
//
// Every launch that returned cudaSuccess adds one to tee_launch_count.

#include <cuda_runtime.h>
#include <stdint.h>

// rounds per pass (the halo), the extended tile's width (one thread a
// column) and height (registers a thread)
#ifndef LB_R
#define LB_R 8
#endif
#ifndef LB_EW
#define LB_EW 256
#endif
#ifndef LB_EH
#define LB_EH 48
#endif
// blocks an SM must hold at once (__launch_bounds__' second argument: at
// 3, at most 85 registers a thread)
#ifndef LB_MIN_BLOCKS
#define LB_MIN_BLOCKS 3
#endif

static_assert(LB_EW % 32 == 0 && LB_EW <= 1024, "LB_EW: whole warps");
static_assert(2 * LB_R < LB_EW && 2 * LB_R < LB_EH, "tile within its halo");

// The library's launch count, defined in tvl1.cu.
extern "C" unsigned long long tee_launch_count;

namespace {

constexpr int kTW = LB_EW - 2 * LB_R;  // the output tile
constexpr int kTH = LB_EH - 2 * LB_R;
constexpr size_t kSmem = (size_t)LB_EW * LB_EH * sizeof(int);
// a launch's frames: gridDim.y's limit; the blocks walk the rest
constexpr int kMaxGridY = 65535;

cudaError_t counted(cudaError_t e) {
  if (e == cudaSuccess)
    __atomic_fetch_add(&tee_launch_count, 1ULL, __ATOMIC_RELAXED);
  return e;
}

struct Pass {
  const uint8_t* mask;  // the first pass: the (N, H, W) mask
  const int* in;        // later passes: the previous pass's ids
  int* out;
  const int* prev_flag;  // the previous pass's flag (nullptr: the first)
  int* flag;             // set when an output tile changed
  int N, H, W, tiles_x, rounds;
};

// One pass of a.rounds (<= LB_R) rounds over one extended tile
// (blockIdx.x) of frames blockIdx.y, blockIdx.y + gridDim.y, ...
template <bool kConn8, bool kFromMask>
__global__ void __launch_bounds__(LB_EW, LB_MIN_BLOCKS)
    label_pass_kernel(const Pass a) {
  extern __shared__ int tile[];  // [LB_EH][LB_EW], one round's values
  // past the fixed point: nothing to do (the same for every block)
  if (a.prev_flag != nullptr && *a.prev_flag == 0) return;
  const int x = threadIdx.x;
  const int H = a.H, W = a.W, big = H * W;
  const int gx = (blockIdx.x % a.tiles_x) * kTW - LB_R + x;
  const int gy0 = (blockIdx.x / a.tiles_x) * kTH - LB_R;
  const bool col_in = gx >= 0 && gx < W;
  // the neighbours' columns; at the tile's edge the pixel itself
  const int xl = x > 0 ? x - 1 : x;
  const int xr = x < LB_EW - 1 ? x + 1 : x;
  const bool col_out = x >= LB_R && x < LB_EW - LB_R;
  bool changed = false;
  for (int f = blockIdx.y; f < a.N; f += gridDim.y) {
    const size_t frame = (size_t)f * H * W;
    int v[LB_EH];
#pragma unroll
    for (int r = 0; r < LB_EH; ++r) {
      const int gy = gy0 + r;
      int id = big;
      if (col_in && gy >= 0 && gy < H) {
        const size_t i = frame + (size_t)gy * W + gx;
        if (kFromMask)
          id = a.mask[i] ? gy * W + gx : big;
        else
          id = a.in[i];
      }
      v[r] = id;
    }
    // the output column's ids before the rounds, which can only lower them
    unsigned long long before = 0;
#pragma unroll
    for (int r = LB_R; r < LB_EH - LB_R; ++r) before += (unsigned)v[r];
    for (int k = 0; k < a.rounds; ++k) {
#pragma unroll
      for (int r = 0; r < LB_EH; ++r) tile[r * LB_EW + x] = v[r];
      __syncthreads();
      if (kConn8) {
        // the 3x3 minimum as the column minimum of the row minimums h,
        // each taken one row ahead
        int hcur = min(min(tile[xl], tile[xr]), v[0]);
        int hprev = hcur;
#pragma unroll
        for (int r = 0; r < LB_EH; ++r) {
          const int old = v[r];
          int hnext = hcur;
          if (r + 1 < LB_EH) {
            const int* row = tile + (r + 1) * LB_EW;
            hnext = min(min(row[xl], row[xr]), v[r + 1]);
          }
          v[r] = old < big ? min(min(hprev, hcur), hnext) : big;
          hprev = hcur;
          hcur = hnext;
        }
      } else {
        // the row's horizontal neighbours, taken one row ahead
        int lr = min(tile[xl], tile[xr]);
        int up = v[0];  // the old value of the row above
#pragma unroll
        for (int r = 0; r < LB_EH; ++r) {
          const int old = v[r];
          const int down = r + 1 < LB_EH ? v[r + 1] : old;
          int lr_next = lr;
          if (r + 1 < LB_EH) {
            const int* row = tile + (r + 1) * LB_EW;
            lr_next = min(row[xl], row[xr]);
          }
          v[r] = old < big ? min(min(old, lr), min(up, down)) : big;
          up = old;
          lr = lr_next;
        }
      }
      __syncthreads();
    }
    unsigned long long after = 0;
#pragma unroll
    for (int r = LB_R; r < LB_EH - LB_R; ++r) after += (unsigned)v[r];
    changed |= col_out && after != before;
    if (col_in && col_out) {
#pragma unroll
      for (int r = LB_R; r < LB_EH - LB_R; ++r) {
        const int gy = gy0 + r;
        if (gy < H) a.out[frame + (size_t)gy * W + gx] = v[r];
      }
    }
  }
  if (__syncthreads_or(changed) && x == 0) *a.flag = 1;
}

template <bool kConn8, bool kFromMask>
cudaError_t launch(const Pass& a, int tiles, cudaStream_t st) {
  auto kernel = label_pass_kernel<kConn8, kFromMask>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, a.N < kMaxGridY ? a.N : kMaxGridY);
  kernel<<<grid, LB_EW, kSmem, st>>>(a);
  return counted(cudaGetLastError());
}

}  // namespace

extern "C" {

// Runs the passes first .. first + count - 1 of one labelling of the
// (N, H, W) mask (bytes 0/1), the cross (connectivity 1) or the 3x3 square
// (2), at most H*W rounds in all: pass p runs LB_R rounds (the last, the
// remainder) from the mask (p = 0) or from buffer (p - 1) % 2 into buffer
// p % 2 (buf0, buf1: N x H x W ints each), and sets flags[p] (zeroed by the
// caller) when it changed an id; a pass after a quiet one returns at once.
// The labels are in the buffer of the first pass whose flag stays 0. Every
// launch goes on the caller's stream; nothing waits. Returns the first CUDA
// error, with the runtime's last-error state cleared; nothing is launched
// after it.
int labelling_group(const uint8_t* mask, int* buf0, int* buf1, int* flags,
                    int N, int H, int W, int connectivity, int first,
                    int count, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles = tiles_x * ((H + kTH - 1) / kTH);
  const bool conn8 = connectivity == 2;
  const long long cap = (long long)H * W;
  int* bufs[2] = {buf0, buf1};
  for (int p = first; p < first + count; ++p) {
    const long long left = cap - (long long)p * LB_R;
    if (left <= 0) break;
    Pass a;
    a.mask = mask;
    a.in = p > 0 ? bufs[(p - 1) & 1] : nullptr;
    a.out = bufs[p & 1];
    a.prev_flag = p > 0 ? flags + p - 1 : nullptr;
    a.flag = flags + p;
    a.N = N;
    a.H = H;
    a.W = W;
    a.tiles_x = tiles_x;
    a.rounds = left < LB_R ? (int)left : LB_R;
    cudaError_t e;
    if (p == 0)
      e = conn8 ? launch<true, true>(a, tiles, st)
                : launch<false, true>(a, tiles, st);
    else
      e = conn8 ? launch<true, false>(a, tiles, st)
                : launch<false, false>(a, tiles, st);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
  }
  return 0;
}

}  // extern "C"
