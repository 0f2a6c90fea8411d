// Shared pieces of the raisr_tpu_torch CUDA kernels (full_kernel.cu,
// filter_kernel.cu): constants, the per-pixel gather-dot and DeviceGuard.
//
// gather_dot is the one place where a pixel's 121-tap filter row meets its
// 11x11 patch. Launch A of the fused pass (hash_filter_kernel) and the
// filter-apply kernel (filter_apply_kernel) both call it, so they sum taps
// 0..120 in the same order, each product and sum rounded on its own (nvcc
// --fmad=false), as the plain PyTorch version (ops/filter_apply.py
// apply_filters_taps) does. An int16 row (the int8 tier) sums exactly in
// int32, so its order does not matter.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kPatch = 11;
constexpr int kMargin = kPatch / 2;       // patch margin, 5
constexpr int kLoopMargin = kMargin + 1;  // processed-zone margin, 6
constexpr int kTaps = kPatch * kPatch;    // 121
constexpr int kFilterStride = 128;        // taps per bank row, zero-padded

// output tile of one block: 32 x 8 threads, one pixel each
constexpr int kTileW = 32;
constexpr int kTileH = 8;

// Dot of a bank row with the patch whose top-left pixel is `patch`, a
// shared-memory plane with rows kStride values apart; taps 0..120 in order.
// TF is the bank's element type, TP the patch's:
//   float, float          a 512-byte row, 31 16-byte read-only loads of 4 taps;
//   __nv_bfloat16, float  a 256-byte row, 16 16-byte loads of 8 taps, each tap
//                         widened to float32 exactly (its bits are the high
//                         half);
//   int16_t, int          a 256-byte row of integer taps, 16 16-byte loads of
//                         8, each sign-extended and multiplied by the integer
//                         patch value in int32. The caller keeps the sum exact
//                         (|tap| <= 32768, 8-bit values: |sum| < 2^31); it
//                         is returned rounded to float32 (round to nearest
//                         even).
template <int kStride, typename TF, typename TP>
__device__ __forceinline__ float gather_dot(const TF* __restrict__ frow,
                                            const TP* patch) {
  if constexpr (std::is_same<TF, int16_t>::value) {
    static_assert(std::is_same<TP, int>::value, "an int16 row takes an int patch");
    const uint4* u4p = reinterpret_cast<const uint4*>(frow);
    int acc = 0;
#pragma unroll
    for (int q = 0; q < (kTaps + 7) / 8; ++q) {
      const uint4 u4 = __ldg(u4p + q);
      const unsigned int word[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = 8 * q + e;
        if (t < kTaps) {
          // little endian: tap 2k is the low half of word k, 2k+1 the high
          const int tap = static_cast<int16_t>(
              (e & 1) ? (word[e / 2] >> 16) : (word[e / 2] & 0xffffu));
          acc += patch[(t / kPatch) * kStride + t % kPatch] * tap;
        }
      }
    }
    return __int2float_rn(acc);
  } else if constexpr (std::is_same<TF, float>::value) {
    static_assert(std::is_same<TP, float>::value, "a float row takes a float patch");
    const float4* f4p = reinterpret_cast<const float4*>(frow);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < (kTaps + 3) / 4; ++q) {
      const float4 f4 = __ldg(f4p + q);
      const float fv[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * q + e;
        if (t < kTaps) {
          acc = acc + patch[(t / kPatch) * kStride + t % kPatch] * fv[e];
        }
      }
    }
    return acc;
  } else {
    static_assert(std::is_same<TF, __nv_bfloat16>::value && std::is_same<TP, float>::value,
                  "bank rows are float, __nv_bfloat16 (float patch) or int16_t (int patch)");
    const uint4* u4p = reinterpret_cast<const uint4*>(frow);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < (kTaps + 7) / 8; ++q) {
      const uint4 u4 = __ldg(u4p + q);
      const unsigned int word[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int t = 8 * q + e;
        if (t < kTaps) {
          // little endian: tap 2k is the low half of word k, 2k+1 the high
          const unsigned int bits =
              (e & 1) ? (word[e / 2] & 0xffff0000u) : (word[e / 2] << 16);
          acc = acc + patch[(t / kPatch) * kStride + t % kPatch] *
                          __uint_as_float(bits);
        }
      }
    }
    return acc;
  }
}

// Makes `device` current for one launch and restores the caller's device
// afterwards, so a launch never changes the calling thread's device.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace
