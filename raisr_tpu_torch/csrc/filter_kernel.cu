// Filter apply to precomputed hash buckets (float32) for Hopper (sm_90a):
// raw[r, c] = bank[row(r, c)] . patch(r, c), with no epilogue.
//
// Replaces two TPU kernels of raisr_tpu/ops/pallas/filter_kernel.py, entered
// through apply_filters_pallas:
//   _band_kernel   4 phases (ratio 2): row bucket * 4 + ((r-5)&1)*2 + ((c-5)&1),
//                  JAX's pt_idx;
//   _single_kernel 1 phase: row bucket.
// The phase count is a template parameter (kPhases) of one kernel, as in
// full_kernel.cu's gather_resident_kernel. A bucket outside [0, n_buckets) gives
// raw 0 and reads nothing, as the TPU kernels' select over 224 zero-padded
// bank rows does (_tree_select). Patch reads outside the plane are zero.
//
// The TPU kernels multiply every patch against all 216 buckets on the MXU and
// select one. Here one block per 32x8 output tile stages the cheap tile with
// its 5-pixel halo in shared memory; each thread loads its bucket (coalesced)
// and gathers its filter row through 16-byte read-only loads, in
// gather_dot (raisr_common.cuh): dot_rows, the very loop of launch A's gather
// (which reads its rows from shared memory instead), so the two sum the taps
// in the same order and agree bit for bit with the plain PyTorch version
// (ops/cuda/filter_kernel.py apply_filters_reference).
//
// What bounds it on an H100: the gather of 484 B of filter per pixel from
// L1/L2 (the 442 KB bank stays in L2), 31 16-byte loads a pixel that split
// into up to 32 sectors a warp; the plane and bucket traffic is 12 B per
// pixel. It is what launch A's gather was before the bank moved into shared
// memory; moving this kernel onto the resident bank is queued
// (ROADMAP "Next slices" 1).

#include <cuda_runtime.h>

#include "raisr_common.cuh"

namespace {

// cheap tile plus the patch halo
constexpr int kFImgH = kTileH + 2 * kMargin;  // 18
constexpr int kFImgW = kTileW + 2 * kMargin;  // 42

template <int kPhases>
__global__ void __launch_bounds__(kTileW * kTileH)
filter_apply_kernel(const float* __restrict__ cheap,
                    const int* __restrict__ buckets,
                    const float* __restrict__ filters, float* __restrict__ raw,
                    int h, int w, int n_buckets) {
  __shared__ float s_img[kFImgH][kFImgW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  // cheap rows y0-5 .. y0+12, cols x0-5 .. x0+36; zero outside the plane
  for (int k = tid; k < kFImgH * kFImgW; k += kTileW * kTileH) {
    const int i = k / kFImgW;
    const int j = k % kFImgW;
    const int gr = y0 - kMargin + i;
    const int gc = x0 - kMargin + j;
    s_img[i][j] = (gr >= 0 && gr < h && gc >= 0 && gc < w)
                      ? cheap[static_cast<size_t>(gr) * w + gc]
                      : 0.0f;
  }
  __syncthreads();

  const int r = y0 + ty;
  const int c = x0 + tx;
  if (r >= h || c >= w) return;
  const size_t o = static_cast<size_t>(r) * w + c;
  const int bucket = buckets[o];
  float acc = 0.0f;
  if (bucket >= 0 && bucket < n_buckets) {
    int row = bucket;
    if (kPhases == 4) {
      // pixel phase ((r-5) mod 2, (c-5) mod 2); & 1 is a floor modulo
      const int phase = (((r - kMargin) & 1) << 1) | ((c - kMargin) & 1);
      row = bucket * kPhases + phase;
    }
    acc = gather_dot<kFImgW>(filters + static_cast<size_t>(row) * kFilterStride,
                             &s_img[ty][tx]);
  }
  raw[o] = acc;
}

}  // namespace

// buckets is [h, w] int32; filters is [n_buckets * phases, 128] float32,
// 16-byte aligned; phases is 4 or 1. Returns a cudaError_t value (0 on
// success).
extern "C" int raisr_filter_apply(const float* cheap, const int* buckets,
                                  const float* filters, float* raw, int h,
                                  int w, int phases, int n_buckets, int device,
                                  void* stream) {
  if (h <= 0 || w <= 0 || (phases != 1 && phases != 4) || n_buckets <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phases == 4) {
    filter_apply_kernel<4><<<grid, block, 0, st>>>(cheap, buckets, filters, raw,
                                                   h, w, n_buckets);
  } else {
    filter_apply_kernel<1><<<grid, block, 0, st>>>(cheap, buckets, filters, raw,
                                                   h, w, n_buckets);
  }
  return static_cast<int>(cudaGetLastError());
}
