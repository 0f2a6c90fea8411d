// Integer matrix product int8 x int8 -> int32 for Hopper (sm_90a): c = a @ b
// with a [m, k] and b [k, n] row-major int8, c [m, n] int32.
//
// Replaces the TPU probe kernel of tools/probe_s16.py (_kernel, run through
// pl.pallas_call), which checks the one integer matmul mode the int8 tier's
// hi/lo pair rests on: s8 x s8 -> s32, at the probe's shape [864, 144] x
// [144, 512]. On the card the int8 tier needs no matmul (its gather-dot runs
// in int32, full_kernel.cu), so this kernel is the probe's port and nothing
// more.
//
// The tensor cores do the products: mma.sync.m16n8k32 s8 x s8 -> s32. One
// block of 4 warps computes a 64 x 64 tile of c, each warp 32 x 32 (2 x 4
// mma tiles, 32 int32 sums a thread). Each K chunk of 160 (the probe's 144
// in one chunk, zero-padded to 5 mma steps of 32) stages the tile's 64 rows
// of a and 64 columns of b, both K-major, so each operand's fragment
// register is one 32-bit word of 4 consecutive K values; values past m, n
// and k are zero. Rows are 176 bytes (44 words) apart, so the 8 rows x 4
// words of a fragment load fall in 32 different banks. Integer sums are
// exact while |c| < 2^31 (k < 2^31 / 128^2 = 131072 terms of at most
// 128 * 128), so the result is bit-identical to the int64 product and to
// torch._int_mm.
//
// What bounds it on an H100: at the probe's shape 2 * 864 * 144 * 512 = 127 M
// integer operations against 1.97 MB moved (c is 1.77 MB of it), 0.59 us at
// the memory rate and 0.06 us at the int8 tensor-core rate; 14 x 8 = 112
// blocks are one wave on 132 SMs. So the launch and one block's chain of
// latencies bound it: its loads, one barrier, 5 mma steps, its stores. The
// design keeps that chain short: the products run on the tensor cores
// (4096 a warp per mma, where the __dp4a form gave a thread one output and
// 4 products an instruction), a's rows arrive by 16-byte cp.async and b's by
// 16-byte loads where k and n are multiples of 16 (byte loads otherwise),
// one chunk holds the whole K, and c leaves in 8-byte pairs where n is even.

#include <cuda_runtime.h>

#include <cstdint>

#include "raisr_common.cuh"

namespace {

constexpr int kBM = 64;                 // output tile rows
constexpr int kBN = 64;                 // output tile columns
constexpr int kBK = 160;                // K chunk, in int8 values: 5 mma steps of 32
constexpr int kRowBytes = kBK + 16;     // a staged row: 176 bytes, 44 words
constexpr int kThreads = 128;           // 4 warps, 2 x 2 over the tile
constexpr int kWords = kBK / 4;         // the chunk in 32-bit words
constexpr int kVecs = kBK / 16;         // the chunk in 16-byte groups

using Staged = uint8_t[kBM][kRowBytes];

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t pack4(const int8_t (&v)[4]) {
  return static_cast<uint32_t>(static_cast<uint8_t>(v[0])) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v[1])) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v[2])) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(v[3])) << 24);
}

// K values k0 .. k0+159 of the tile's rows of a and columns of b, for k and
// n multiples of 16 and 16-byte aligned a and b
__device__ __forceinline__ void stage_vec(Staged& s_a, Staged& s_b, const int8_t* a,
                                          const int8_t* b, int m, int n, int k, int row0,
                                          int col0, int k0) {
  // a: 16 bytes of a row a copy, zero-filled past m and k
  for (int i = threadIdx.x; i < kBM * kVecs; i += kThreads) {
    const int rr = i / kVecs;
    const int q = i % kVecs;
    const bool valid = row0 + rr < m && k0 + 16 * q < k;
    cp_async16_zfill(&s_a[rr][16 * q],
                     valid ? a + static_cast<size_t>(row0 + rr) * k + k0 + 16 * q : a, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // b: 16 columns of a row a read, each byte to its column's row;
  // neighbouring threads take neighbouring K, so a warp's byte store fills
  // 32 consecutive bytes
  for (int i = threadIdx.x; i < kBK * (kBN / 16); i += kThreads) {
    const int kr = i % kBK;
    const int cg = i / kBK;
    const int kk = k0 + kr;
    const int cc = col0 + 16 * cg;
    const uint4 u = (kk < k && cc < n)
                        ? *reinterpret_cast<const uint4*>(b + static_cast<size_t>(kk) * n + cc)
                        : make_uint4(0, 0, 0, 0);
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      s_b[16 * cg + e][kr] = static_cast<uint8_t>(word[e / 4] >> (8 * (e % 4)));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the same for any shape: bytes packed 4 to a word
__device__ __forceinline__ void stage_bytes(Staged& s_a, Staged& s_b, const int8_t* a,
                                            const int8_t* b, int m, int n, int k, int row0,
                                            int col0, int k0) {
  // a: neighbouring threads read neighbouring words of a row
  for (int i = threadIdx.x; i < kBM * kWords; i += kThreads) {
    const int rr = i / kWords;
    const int q = i % kWords;
    const int r = row0 + rr;
    int8_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + 4 * q + e;
      v[e] = (r < m && kk < k) ? a[static_cast<size_t>(r) * k + kk] : int8_t{0};
    }
    *reinterpret_cast<uint32_t*>(&s_a[rr][4 * q]) = pack4(v);
  }
  // b: neighbouring threads read neighbouring columns
  for (int i = threadIdx.x; i < kBN * kWords; i += kThreads) {
    const int j = i % kBN;
    const int q = i / kBN;
    const int cc = col0 + j;
    int8_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + 4 * q + e;
      v[e] = (cc < n && kk < k) ? b[static_cast<size_t>(kk) * n + cc] : int8_t{0};
    }
    *reinterpret_cast<uint32_t*>(&s_b[j][4 * q]) = pack4(v);
  }
}

// d += a (16 x 32, row-major) x b (32 x 8, column-major), all int8 -> int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
s8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int32_t* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) Staged s_a;  // rows of a, K contiguous
  __shared__ __align__(16) Staged s_b;  // columns of b, K contiguous
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;  // the mma fragments' group and thread in it
  const int tg = threadIdx.x % 4;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int wm = (warp / 2) * 32;  // the warp's 32 x 32 in the tile
  const int wn = (warp % 2) * 32;
  const bool vec = k % 16 == 0 && n % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kBK) {
    if (vec) {
      stage_vec(s_a, s_b, a, b, m, n, k, row0, col0, k0);
    } else {
      stage_bytes(s_a, s_b, a, b, m, n, k, row0, col0, k0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      if (k0 + ks >= k) break;  // the rest of the chunk is zero padding
      // fragments (PTX ISA, mma.m16n8k32 .s8): a's register i holds row
      // g (+8 for i odd), K 4*tg.. (+16 for i >= 2); b's register i holds
      // column g, K 4*tg.. (+16 for i = 1)
      uint32_t fa[2][4];
      uint32_t fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fa[mi][i] = *reinterpret_cast<const uint32_t*>(
              &s_a[r + 8 * (i & 1)][ks + 16 * (i >> 1) + 4 * tg]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int j = wn + 8 * ni + g;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          fb[ni][i] = *reinterpret_cast<const uint32_t*>(&s_b[j][ks + 16 * i + 4 * tg]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], fa[mi], fb[ni]);
      }
    }
    __syncthreads();
  }

  // c fragments: sums 0, 1 at row g, columns 2*tg, 2*tg+1; sums 2, 3 at row
  // g+8; a pair is one 8-byte store where n is even
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + wm + 16 * mi + g + 8 * half;
        const int cc = col0 + wn + 8 * ni + 2 * tg;
        if (r >= m || cc >= n) continue;
        int32_t* dst = c + static_cast<size_t>(r) * n + cc;
        const int lo = acc[mi][ni][2 * half];
        const int hi = acc[mi][ni][2 * half + 1];
        if (n % 2 == 0) {
          *reinterpret_cast<int2*>(dst) = make_int2(lo, hi);
        } else {
          dst[0] = lo;
          if (cc + 1 < n) dst[1] = hi;
        }
      }
    }
  }
}

}  // namespace

// a [m, k], b [k, n] int8 and c [m, n] int32, contiguous row-major on
// `device`. Returns a cudaError_t value (0 on success).
extern "C" int raisr_s8_matmul(const int8_t* a, const int8_t* b, int32_t* c, int m,
                               int n, int k, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  s8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
