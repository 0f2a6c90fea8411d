// Shared pieces of the raisr_tpu_torch CUDA kernels (full_kernel.cu,
// probe_s16.cu, upscale.cu): constants, the per-pixel dot of a filter row
// with its patch, the store of four output values as float32 or packed
// integers (store4), and DeviceGuard.
//
// dot_rows is the one place where a pixel's 121-tap filter row meets its
// 11x11 patch. Every filter dot of the port runs through it, from a bank
// resident in shared memory (full_kernel.cu gather_resident_kernel: the
// fused pass and apply_filters_hash with the hash launch's buckets,
// apply_filters with the caller's), so they all sum taps 0..120 in the same
// order, each product and sum rounded on its own (nvcc --fmad=false), as
// the plain PyTorch version (ops/filter_apply.py apply_filters_taps) does.
// An int16 row (the int8 tier) sums exactly in int32, so its order does not
// matter.
//
// What bounds a dot on an H100 is how its row and patch arrive, not its
// arithmetic (121 multiplies and adds): 31 16-byte loads at float32 and 16
// at 16 bits, and the patch's scalar reads. From shared memory the row's
// loads are served a quarter-warp at a time, rows that coincide are
// broadcasts, and distinct rows in one bank group are served one after
// another; full_kernel.cu orders each warp's lanes so that a quarter's rows
// fall in different groups, and gives a thread four pixels (P) whose
// shared patch values it reads once.

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
constexpr int kFilterStride = 128;        // taps per bank row in global memory, zero-padded

// A bank row's 16-byte groups: kN taps each, tap e of a group as the dot
// reads it (float32; bfloat16 widened exactly, its bits the high half;
// int16 sign-extended), and Acc, the type of the dot's sum and of the patch
// values it reads. Little endian: 16-bit tap 2k is the low half of word k,
// 2k+1 the high.
template <typename TF> struct Taps;
template <> struct Taps<float> {
  static constexpr int kN = 4;
  using Acc = float;
  __device__ static float at(const uint4& u, int e) {
    const unsigned int word[4] = {u.x, u.y, u.z, u.w};
    return __uint_as_float(word[e]);
  }
};
template <> struct Taps<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Acc = float;
  __device__ static float at(const uint4& u, int e) {
    const unsigned int word[4] = {u.x, u.y, u.z, u.w};
    return __uint_as_float((e & 1) ? (word[e / 2] & 0xffff0000u) : (word[e / 2] << 16));
  }
};
template <> struct Taps<int16_t> {
  static constexpr int kN = 8;
  using Acc = int;
  __device__ static int at(const uint4& u, int e) {
    const unsigned int word[4] = {u.x, u.y, u.z, u.w};
    return static_cast<int16_t>((e & 1) ? (word[e / 2] >> 16) : (word[e / 2] & 0xffffu));
  }
};

// 16-byte groups of a row that hold taps 0..120: 31 at float32, 16 at 16 bits
template <typename TF>
constexpr int kRowGroups = (kTaps + Taps<TF>::kN - 1) / Taps<TF>::kN;

// Dots of P bank rows with P patches, taps 0..120 of each in order. Pixel
// p's patch row dy is row kRowStep * p + dy of the rows the P patches span,
// so a patch value that several pixels share is read once. `group(p, q)`
// returns pixel p's q-th 16-byte group, `patch(rho, dx)` the patch value at
// spanned row rho, column dx. TF is the bank's element type:
//   float          a float patch, each product and sum rounded on its own;
//   __nv_bfloat16  the same, each tap widened to float32 exactly;
//   int16_t        an int patch, integer products summed in int32. The
//                  caller keeps the sum exact (|tap| <= 32768, 8-bit values:
//                  |sum| < 2^31); it is returned rounded to float32 (round
//                  to nearest even).
template <typename TF, int P, int kRowStep, typename Group, typename Patch>
__device__ __forceinline__ void dot_rows(float (&out)[P], Group group, Patch patch) {
  using Acc = typename Taps<TF>::Acc;
  Acc acc[P];
  uint4 cur[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = Acc(0);
#pragma unroll
  for (int rho = 0; rho < kPatch + kRowStep * (P - 1); ++rho) {
#pragma unroll
    for (int dx = 0; dx < kPatch; ++dx) {
      const Acc v = patch(rho, dx);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int dy = rho - kRowStep * p;
        if (dy < 0 || dy >= kPatch) continue;
        const int t = dy * kPatch + dx;
        if (t % Taps<TF>::kN == 0) cur[p] = group(p, t / Taps<TF>::kN);
        acc[p] = acc[p] + v * Taps<TF>::at(cur[p], t % Taps<TF>::kN);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if constexpr (std::is_same<Acc, int>::value) {
      out[p] = __int2float_rn(acc[p]);
    } else {
      out[p] = acc[p];
    }
  }
}

// An integer-valued float32 output value as Out: itself, or packed as
// ops/cuda/upscale.py pack_planes packs it (through int32, wrapping to
// Out's width; exact for a value in [0, 2^bits - 1]).
template <typename Out>
__device__ __forceinline__ Out narrow(float v) {
  if constexpr (std::is_same<Out, float>::value) {
    return v;
  } else {
    return static_cast<Out>(static_cast<int>(v));
  }
}

template <typename Out>
struct alignas(4 * sizeof(Out)) Quad {
  Out v[4];
};

// Four output values at columns c .. c + 3 of one row: one store (16 bytes
// of float32, 8 of uint16, 4 of uint8) where the row pitch keeps the quad
// aligned, else one by one up to out_w.
template <typename Out>
__device__ __forceinline__ void store4(Out* __restrict__ row, int c, int out_w, bool vec,
                                       const float (&v)[4]) {
  if (vec && c + 3 < out_w) {
    Quad<Out> q;
#pragma unroll
    for (int k = 0; k < 4; ++k) q.v[k] = narrow<Out>(v[k]);
    *reinterpret_cast<Quad<Out>*>(row + c) = q;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c + k < out_w) row[c + k] = narrow<Out>(v[k]);
    }
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
