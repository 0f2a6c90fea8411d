// Integer matrix product int8 x int8 -> int32 for Hopper (sm_90a): c = a @ b
// with a [m, k] and b [k, n] row-major int8, c [m, n] int32.
//
// Replaces the TPU probe kernel of tools/probe_s16.py (_kernel, run through
// pl.pallas_call), which checks the one integer matmul mode the int8 tier's
// hi/lo pair rests on: s8 x s8 -> s32, at the probe's shape [864, 144] x
// [144, 512]. On the card the int8 tier needs no matmul (its gather-dot runs
// in int32, full_kernel.cu), so this kernel is the probe's port and nothing
// more: one 16 x 16 output tile per block of 256 threads, one output per
// thread. Each K chunk of 64 stages the tile's 16 rows of a and 16 columns of
// b (transposed) in shared memory, packed 4 values to a 32-bit word, and each
// thread sums them with __dp4a (4 int8 products and an int32 add per
// instruction). The sum is exact while |c| < 2^31 (k < 2^31 / 128^2 = 131072
// terms of at most 128 * 128).
//
// What bounds it on an H100: at the probe's shape 2 * 864 * 144 * 512 = 127 M
// integer operations against 1.97 MB moved (c is 1.77 MB of it); either is a
// few microseconds of the card, so a launch of it is bound by its own
// latency. Tensor-core tiles (mma.sync s8) are for a product large enough to
// need them.

#include <cuda_runtime.h>

#include <cstdint>

#include "raisr_common.cuh"

namespace {

constexpr int kMT = 16;             // output tile: kMT x kMT, one per thread
constexpr int kKT = 64;             // K chunk, in int8 values
constexpr int kKW = kKT / 4;        // the chunk in packed 32-bit words

__device__ __forceinline__ int pack4(int8_t v0, int8_t v1, int8_t v2, int8_t v3) {
  return static_cast<int>((static_cast<uint32_t>(static_cast<uint8_t>(v0))) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(v1)) << 8) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(v2)) << 16) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(v3)) << 24));
}

__global__ void __launch_bounds__(kMT * kMT)
s8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int32_t* __restrict__ c, int m, int n, int k) {
  __shared__ int s_a[kMT][kKW + 1];  // rows of a, K packed by 4
  __shared__ int s_b[kMT][kKW + 1];  // columns of b, K packed by 4
  const int tx = threadIdx.x;        // output column in the tile
  const int ty = threadIdx.y;        // output row in the tile
  const int tid = ty * kMT + tx;
  const int row0 = blockIdx.y * kMT;
  const int col0 = blockIdx.x * kMT;
  int acc = 0;
  for (int k0 = 0; k0 < k; k0 += kKT) {
    // kMT * kKW = 256 words of each operand: one word of each per thread;
    // values past k, m or n are 0
    {
      const int i = tid / kKW;  // tile row of a
      const int q = tid % kKW;  // word in the chunk
      const int r = row0 + i;
      int8_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + 4 * q + e;
        v[e] = (r < m && kk < k) ? a[static_cast<size_t>(r) * k + kk] : int8_t{0};
      }
      s_a[i][q] = pack4(v[0], v[1], v[2], v[3]);
    }
    {
      const int j = tid % kMT;  // tile column of b (neighbouring threads read
      const int q = tid / kMT;  // neighbouring columns)
      const int cc = col0 + j;
      int8_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k0 + 4 * q + e;
        v[e] = (cc < n && kk < k) ? b[static_cast<size_t>(kk) * n + cc] : int8_t{0};
      }
      s_b[j][q] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKW; ++q) acc = __dp4a(s_a[ty][q], s_b[tx][q], acc);
    __syncthreads();
  }
  const int r = row0 + ty;
  const int cc = col0 + tx;
  if (r < m && cc < n) c[static_cast<size_t>(r) * n + cc] = acc;
}

}  // namespace

// a [m, k], b [k, n] int8 and c [m, n] int32, contiguous row-major on
// `device`. Returns a cudaError_t value (0 on success).
extern "C" int raisr_s8_matmul(const int8_t* a, const int8_t* b, int32_t* c, int m,
                               int n, int k, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const dim3 block(kMT, kMT);
  const dim3 grid((n + kMT - 1) / kMT, (m + kMT - 1) / kMT);
  s8_matmul_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
