// Per-bucket normal equations of filter training for Hopper (sm_90a):
// Q[f] += sum (s p)(s p)^T and V[f] += sum y (s p) over the pixels whose
// filter index is f, in place, float32.
//
// Replaces no Pallas kernel: on the TPU the same sums are XLA's one-hot
// contraction in raisr_tpu/train/trainer.py (_accumulate_chunked, :119-147),
// which builds a [chunk, num_filters] one-hot matrix per chunk of pixels and
// multiplies its transpose with the chunk's [chunk, 121 * 121] outer
// products on the MXU, because a TPU has no scatter. That is num_filters
// (864 at 2x) times the arithmetic the sums need. A GPU gathers instead:
// the wrapper (ops/cuda/normal_eq.py) sorts the core pixels by filter index
// (a stable sort, so each index keeps raster order) and cuts each index's
// pixels into runs of at most RUN (1024); then
//   launch 1 (gram_partials_kernel): one block per run. It stages kStage
//     pixels at a time in shared memory as augmented rows of 128 floats:
//     taps 0..120 are the 11x11 patch read from the cheap plane times the
//     pixel's weight s (1 without a weight plane), tap 121 is the label y,
//     taps 122..127 are 0; a thread copies a patch row (11 contiguous
//     floats) at a time, through a table of the taps' positions. Each of 136 threads owns one 8x8 tile of the
//     upper triangle of the 128x128 augmented Gram (16 x 17 / 2 tiles) and
//     sums a stage's pixels in 64 registers (four 16-byte shared loads and
//     64 fused multiply-adds a pixel), then adds the stage's sums to the
//     run's in shared memory. The Gram's rows 0..120 hold Q, its column 121
//     holds V. The block writes the run's sums to its own slot of a
//     partials buffer;
//   launch 2 (gram_reduce_kernel): one block per filter index adds that
//     index's partials in run order, in double, and adds the sum into Q
//     (both (i, j) and (j, i), so Q stays exactly symmetric, as JAX's is)
//     and V.
// Summing by stage, then by run, then over runs keeps each float32 chain
// short: a stage's sums of 8-bit products are exact (64 * 255^2 < 2^24).
// No float atomics: the order of every sum is fixed by the sorted order and
// the run order, so the same inputs give the same Q and V bit for bit.
//
// What bounds it on an H100: a pixel needs 7,503 multiply-adds (the upper
// triangle of the 122 x 122 augmented Gram), ~15,000 float operations, and
// moves a few bytes (the planes once, the index, Q and V in and out), so the
// float32 rate bounds it: ~0.46 ms for the 2,037,744 core pixels of a 1080p
// frame at 67 TFLOP/s. The tiles cover 136 x 64 = 8,704 products a pixel
// (the diagonal tiles' lower halves and the padding are waste, 16%). The
// shared-memory layout puts the first four floats of every 8-tap block side
// by side, then the last four, so a quarter-warp's 16-byte loads of eight
// tiles' operands hit eight distinct 16-byte bank groups. Tensor cores are
// left out: TF32 would need a 3xTF32 split to keep JAX's
// Precision.HIGHEST float32 sums.

#include <cuda_runtime.h>

#include "raisr_common.cuh"

namespace {

// kPatch, kMargin, kLoopMargin and kTaps come from raisr_common.cuh; core
// pixels lie kLoopMargin (6) from every edge
constexpr int kAug = 128;           // staged row: 121 taps, the label, 6 zeros
constexpr int kLabel = kTaps;       // the label's column in the augmented Gram
constexpr int kBlk = 8;             // tile edge
constexpr int kNB = kAug / kBlk;    // 16 tile rows
constexpr int kTiles = kNB * (kNB + 1) / 2;  // 136 upper-triangle tiles
constexpr int kTileElems = kBlk * kBlk;      // 64
constexpr int kPartial = kTiles * kTileElems;  // 8,704 floats a run
constexpr int kThreads = 160;       // 5 warps: 136 tile owners, all stage
constexpr int kStage = 64;          // pixels staged at once (32 KB)
// dynamic shared memory of launch 1: the staged rows, then the run's sums
constexpr int kSmemBytes = (kStage * kAug + kPartial) * 4;

// The tile owned by thread t, row-major over the upper triangle.
__device__ __forceinline__ void tile_of(int t, int& ti, int& tj) {
  ti = 0;
  while (t >= kNB - ti) {
    t -= kNB - ti;
    ++ti;
  }
  tj = ti + t;
}

// Shared-memory position of tap `tap` of staged pixel `k`: the first four
// floats of each 8-tap block side by side, then the last four.
__device__ __forceinline__ int stage_pos(int k, int tap) {
  return k * kAug + ((tap & 7) >> 2) * (kAug / 2) + (tap >> 3) * 4 + (tap & 3);
}

__global__ void __launch_bounds__(kThreads, 3)
gram_partials_kernel(const float* __restrict__ cheap, const float* __restrict__ label,
                     const float* __restrict__ weight, const int* __restrict__ order,
                     const int* __restrict__ run_start, const int* __restrict__ run_len,
                     float* __restrict__ partials, int w, int core_w) {
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                    // [kStage][kAug], stage_pos layout
  float* total = smem + kStage * kAug;    // [kTileElems][kTiles], the run's sums
  __shared__ int pos_of[kAug];            // stage_pos(0, tap)
  __shared__ int center[kStage];
  __shared__ float scale[kStage];

  const int tid = threadIdx.x;
  const int run = blockIdx.x;
  const int start = run_start[run];
  const int len = run_len[run];
  for (int i = tid; i < kAug; i += kThreads) pos_of[i] = stage_pos(0, i);
  for (int i = tid; i < kPartial; i += kThreads) total[i] = 0.0f;
  int ti = 0, tj = 0;
  if (tid < kTiles) tile_of(tid, ti, tj);

  for (int base = 0; base < len; base += kStage) {
    const int n = min(kStage, len - base);
    __syncthreads();  // the previous stage is consumed; pos_of is written
    if (tid < n) {
      const int pos = order[start + base + tid];
      const int r = pos / core_w;
      const int c = pos - r * core_w;
      const int ctr = (r + kLoopMargin) * w + c + kLoopMargin;
      center[tid] = ctr;
      scale[tid] = weight != nullptr ? weight[ctr] : 1.0f;
    }
    __syncthreads();
    // one task a patch row of a pixel (11 contiguous taps, times s), and one
    // for its label and padding
    for (int task = tid; task < n * (kPatch + 1); task += kThreads) {
      const int k = task / (kPatch + 1);
      const int row = task - k * (kPatch + 1);
      float* dst = stage + k * kAug;
      if (row < kPatch) {
        const float* src = cheap + center[k] + (row - kMargin) * w - kMargin;
        const float sk = scale[k];
#pragma unroll
        for (int j = 0; j < kPatch; ++j) dst[pos_of[row * kPatch + j]] = __fmul_rn(src[j], sk);
      } else {
        dst[pos_of[kLabel]] = label[center[k]];
        for (int t = kLabel + 1; t < kAug; ++t) dst[pos_of[t]] = 0.0f;
      }
    }
    __syncthreads();
    if (tid < kTiles) {
      float acc[kBlk][kBlk];
#pragma unroll
      for (int a = 0; a < kBlk; ++a) {
#pragma unroll
        for (int b = 0; b < kBlk; ++b) acc[a][b] = 0.0f;
      }
      const float4* rows = reinterpret_cast<const float4*>(stage);
      for (int k = 0; k < n; ++k) {
        const float4* row = rows + k * (kAug / 4);
        const float4 x0 = row[ti], x1 = row[kNB + ti];
        const float4 y0 = row[tj], y1 = row[kNB + tj];
        const float x[kBlk] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float y[kBlk] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int a = 0; a < kBlk; ++a) {
#pragma unroll
          for (int b = 0; b < kBlk; ++b) acc[a][b] = __fmaf_rn(x[a], y[b], acc[a][b]);
        }
      }
      // element (a, b) of every tile side by side: conflict-free, and the
      // writes below coalesce
#pragma unroll
      for (int a = 0; a < kBlk; ++a) {
#pragma unroll
        for (int b = 0; b < kBlk; ++b) total[(a * kBlk + b) * kTiles + tid] += acc[a][b];
      }
    }
  }
  __syncthreads();
  float* out = partials + static_cast<size_t>(run) * kPartial;
  for (int i = tid; i < kPartial; i += kThreads) out[i] = total[i];
}

__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ partials, const int* __restrict__ first_run,
                   const int* __restrict__ runs_of, float* __restrict__ q,
                   float* __restrict__ v) {
  const int f = blockIdx.x;
  const int nr = runs_of[f];
  if (nr == 0) return;
  const float* src = partials + static_cast<size_t>(first_run[f]) * kPartial;
  float* qf = q + static_cast<size_t>(f) * kTaps * kTaps;
  float* vf = v + static_cast<size_t>(f) * kTaps;
  for (int x = threadIdx.x; x < kPartial; x += blockDim.x) {
    const int ab = x / kTiles;
    int ti, tj;
    tile_of(x - ab * kTiles, ti, tj);
    const int i = ti * kBlk + ab / kBlk;
    const int j = tj * kBlk + ab % kBlk;
    if (i > j || i >= kTaps || j > kLabel) continue;
    double sum = 0.0;
    for (int r = 0; r < nr; ++r) sum += src[static_cast<size_t>(r) * kPartial + x];
    const float add = static_cast<float>(sum);
    if (j == kLabel) {
      vf[i] += add;
    } else {
      qf[i * kTaps + j] += add;
      if (i != j) qf[j * kTaps + i] += add;
    }
  }
}

}  // namespace

// cheap, label and (optional, else nullptr) weight: [h, w] float32 planes;
// order: the core pixels' linear indices over the [h - 12, w - 12] core,
// sorted by filter index; run r covers order[run_start[r], + run_len[r]),
// all of one filter index, and the runs of filter f are first_run[f] ..
// first_run[f] + runs_of[f] - 1; partials: [n_runs, 8704] float32 scratch;
// q [n_filters, 121, 121] and v [n_filters, 121] float32, updated in place.
// Returns a cudaError_t value (0 on success).
extern "C" int raisr_normal_eq(const float* cheap, const float* label, const float* weight,
                               const int* order, const int* run_start, const int* run_len,
                               int n_runs, const int* first_run, const int* runs_of,
                               int n_filters, float* partials, float* q, float* v, int h,
                               int w, int device, void* stream) {
  if (h <= 2 * kLoopMargin || w <= 2 * kLoopMargin || n_runs <= 0 || n_filters <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(gram_partials_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_partials_kernel<<<n_runs, kThreads, kSmemBytes, s>>>(cheap, label, weight, order, run_start,
                                                   run_len, partials, w, w - 2 * kLoopMargin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<n_filters, 256, 0, s>>>(partials, first_run, runs_of, q, v);
  return static_cast<int>(cudaGetLastError());
}
