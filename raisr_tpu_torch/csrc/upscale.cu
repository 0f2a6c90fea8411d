// The serving step's glue for Hopper (sm_90a): unpack, guard band, cheap
// upscale and repack in one launch.
//
// Replaces no Pallas kernel: it is the counterpart of what XLA fuses inside
// raisr_tpu's one-jit serving step (raisr_tpu/engine.py
// process_batch_device) around the Pallas pass:
//   - the unpack astype(float32) of the packed uint8/uint16 frames;
//   - the guard-band jnp.pad and reshape of the frame stack
//     (raisr_tpu/ops/pipeline.py process_plane_y_batch);
//   - the cheap upscale (raisr_tpu/ops/resize.py:180 cheap_upscale: the 2x
//     slice-and-interleave form _upscale_axis0_2x, the exact-integer 1.5x
//     form _bilinear_exact_rounded, the float form; :198
//     cheap_upscale_stacked over a guard-banded stack);
//   - the chroma batch upscale (process_plane_uv_batch) and the repack
//     astype(dtype).
// Eager PyTorch runs these as one memory pass an op, ~23 launches a plane
// (raisr_tpu_torch/ops/cuda/upscale.py keeps that chain as the plain
// version).
//
// One template, cheap_upscale_kernel<In, Out, Form>:
//   In    uint8_t, uint16_t (the uint16 tensor's storage read as it is), or
//         float (an integer-valued float32 plane or stack);
//   Out   float (the stack a fused pass reads) or In (packed chroma);
//   Form  k1x   the input rows as float32: unpack and guard band only (mode
//               2's LR stack);
//         k2x   fixed quarter weights, columns first, then rows, as
//               _upscale_axis_2x (ops/resize.py) runs them, then
//               floor(x + 0.5) and the clamp to 2^bits - 1;
//         kVec  per-axis (idx0, idx1, w, den) vectors (_axis_vectors,
//               _stacked_row_vectors), rows first, then columns,
//               a * den + (b - a) * w, then floor((s + den/2) / den) and the
//               clamp, in _separable and _rounded's order. den is 4 or 6 an
//               axis in the exact-integer form, 1 in the float form.
// Geometry: the input is a virtual guard-banded stack. A plane
// (blockIdx.z) stacks `frames` frames of h x w with `pad` rows above and
// below each: stack row s reads frame s / P, row clamp(s % P - pad, 0,
// h - 1), P = h + 2 pad. The Y frames of a batch are one plane of N frames
// (the guard band is never written to memory); a chroma batch is N planes
// of one frame with pad 0 (each its own edge clamp); a float32 stack that
// already has its guard band (mode 2's pass-1 output) is one plane of one
// frame of all its rows.
//
// Exactness. At 2x and exact 1.5x every intermediate is an integer, or a
// multiple of 1/16, below 2^24 (raisr_tpu/ops/resize.py:58-70), so any
// order gives the plain version's bits. The float form keeps the plain
// order of operations, each rounded on its own (__fmul_rn and friends, and
// nvcc --fmad=false besides), and IEEE division.
//
// What bounds it on an H100: bytes. A 2x step of 4 frames of 1080p writes a
// 134-MB float32 stack from 8.3 MB of uint8 (~0.042 ms at 3.35 TB/s); it
// does a few operations a byte. So the design aims at the stores:
//   - a thread owns a strip of output columns and writes each output row of
//     it with one 16-byte store (four float32) where the row pitch allows,
//     so a warp writes 512 contiguous bytes an instruction;
//   - a thread walks down a run of input rows, keeping the column-upscaled
//     rows above, at and below in registers (2x: each input row is read
//     once a run and gives two output rows);
//   - the column neighbours of a thread's pair (2x) come from the
//     neighbour lanes by shuffle; only the warp's edge lanes load theirs.
// kVec gathers through its vectors from L1 (the input is a sixth of the
// output's bytes at 1.5x); the row vectors are warp-uniform loads.

#include "raisr_common.cuh"

namespace {

enum class Form : int { k1x = 0, k2x = 1, kVec = 2 };

constexpr int kThreads = 128;     // a block: four warps side by side
constexpr int kRunRows = 8;       // rows a thread walks down (at least)
constexpr unsigned kWarpMask = 0xffffffffu;

struct Geometry {
  int frames;    // frames a plane stacks
  int h, w;      // a frame's rows and columns
  int pad;       // guard rows above and below each frame
  int rows;      // the plane's (virtual) stack rows: frames * (h + 2 pad)
  int out_rows;  // output rows a plane
  int out_w;     // output columns
  int run;       // rows a thread walks down: input rows (k1x, k2x), output rows (kVec)
  float maxv;    // 2^bits - 1
};

struct Vectors {
  const int64_t* r0;  // [out_rows]: the input rows a output row blends
  const int64_t* r1;
  const float* rw;    // their weights
  const int64_t* c0;  // [out_w]: the columns a output column blends
  const int64_t* c1;
  const float* cw;
  float rden, cden;   // each axis's denominator
  float den, half;    // rden * cden and its half
};

// Row s (in [0, rows)) of plane z of the virtual stack.
template <typename In>
__device__ __forceinline__ const In* stack_row(const In* __restrict__ in, int z, int s,
                                               const Geometry& g) {
  const int period = g.h + 2 * g.pad;
  const int f = s / period;
  const int r = min(max(s - f * period - g.pad, 0), g.h - 1);
  return in + ((static_cast<size_t>(z) * g.frames + f) * g.h + r) * g.w;
}

template <typename T>
__device__ __forceinline__ float widen(T v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float round_clamp(float v, float maxv) {
  return fminf(fmaxf(floorf(__fadd_rn(v, 0.5f)), 0.0f), maxv);
}

// x + (y - x) * 0.25, each step rounded (exact on these values in any case)
__device__ __forceinline__ float quarter(float x, float y) {
  return __fadd_rn(x, __fmul_rn(__fsub_rn(y, x), 0.25f));
}

// The 2x column upscale of one input row at the thread's pair of columns
// 2j, 2j+1: output columns 4j .. 4j+3. Every column index is clamped to the
// row, so a lane past its end holds the last column, which is also what the
// row's last pair takes from it as its right neighbour; the pair's outer
// neighbours come from the neighbour lanes, the warp's edge lanes load
// theirs.
template <typename In>
__device__ __forceinline__ void cols_2x(const In* __restrict__ row, int j, int lane, int w,
                                        float (&t)[4]) {
  const float x0 = widen(row[min(2 * j, w - 1)]);
  const float x1 = widen(row[min(2 * j + 1, w - 1)]);
  float left = __shfl_up_sync(kWarpMask, x1, 1);
  float right = __shfl_down_sync(kWarpMask, x0, 1);
  if (lane == 0) left = widen(row[min(max(2 * j - 1, 0), w - 1)]);
  if (lane == 31) right = widen(row[min(2 * j + 2, w - 1)]);
  t[0] = quarter(x0, left);
  t[1] = quarter(x0, x1);
  t[2] = quarter(x1, x0);
  t[3] = quarter(x1, right);
}

// A thread's unit: k1x and kVec four output columns (4j .. 4j+3), k2x an
// input column pair (2j, 2j+1). blockIdx.y is a run of rows, blockIdx.z the
// plane. Every row loop is uniform across a warp (the run comes from
// blockIdx.y alone), so no lane leaves before a shuffle of its warp.
template <typename In, typename Out, Form kForm>
__global__ void __launch_bounds__(kThreads)
cheap_upscale_kernel(const In* __restrict__ in, Out* __restrict__ out, Geometry g, Vectors v,
                     bool vec) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  const int z = blockIdx.z;
  Out* const plane_out = out + static_cast<size_t>(z) * g.out_rows * g.out_w;
  const int first = blockIdx.y * g.run;

  if constexpr (kForm == Form::k1x) {
    const int last = min(first + g.run, g.rows);
    const int c = 4 * j;
    for (int s = first; s < last; ++s) {
      const In* row = stack_row(in, z, s, g);
      float x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = widen(row[min(c + k, g.w - 1)]);
      store4(plane_out + static_cast<size_t>(s) * g.out_w, c, g.out_w, vec, x);
    }
  } else if constexpr (kForm == Form::k2x) {
    const int last = min(first + g.run, g.rows);
    const int lane = threadIdx.x % 32;
    const int c = 4 * j;
    float above[4], at[4], below[4];
    cols_2x(stack_row(in, z, max(first - 1, 0), g), j, lane, g.w, above);
    cols_2x(stack_row(in, z, first, g), j, lane, g.w, at);
    for (int s = first; s < last; ++s) {
      cols_2x(stack_row(in, z, min(s + 1, g.rows - 1), g), j, lane, g.w, below);
      float even[4], odd[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        even[k] = round_clamp(quarter(at[k], above[k]), g.maxv);
        odd[k] = round_clamp(quarter(at[k], below[k]), g.maxv);
      }
      Out* row = plane_out + static_cast<size_t>(2 * s) * g.out_w;
      store4(row, c, g.out_w, vec, even);
      store4(row + g.out_w, c, g.out_w, vec, odd);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        above[k] = at[k];
        at[k] = below[k];
      }
    }
  } else {
    const int last = min(first + g.run, g.out_rows);
    const int c = 4 * j;
    int c0[4], c1[4];
    float cw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int oc = min(c + k, g.out_w - 1);
      c0[k] = static_cast<int>(v.c0[oc]);
      c1[k] = static_cast<int>(v.c1[oc]);
      cw[k] = v.cw[oc];
    }
    for (int o = first; o < last; ++o) {
      const In* ra = stack_row(in, z, static_cast<int>(v.r0[o]), g);
      const In* rb = stack_row(in, z, static_cast<int>(v.r1[o]), g);
      const float rw = v.rw[o];
      float y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // rows first, at the two columns output column c + k blends
        const float a0 = widen(ra[c0[k]]), b0 = widen(rb[c0[k]]);
        const float a1 = widen(ra[c1[k]]), b1 = widen(rb[c1[k]]);
        const float t0 = __fadd_rn(__fmul_rn(a0, v.rden), __fmul_rn(__fsub_rn(b0, a0), rw));
        const float t1 = __fadd_rn(__fmul_rn(a1, v.rden), __fmul_rn(__fsub_rn(b1, a1), rw));
        // then columns, then floor((s + den/2) / den) and the clamp
        const float sc = __fadd_rn(__fmul_rn(t0, v.cden), __fmul_rn(__fsub_rn(t1, t0), cw[k]));
        y[k] = fminf(fmaxf(floorf(__fdiv_rn(__fadd_rn(sc, v.half), v.den)), 0.0f), g.maxv);
      }
      store4(plane_out + static_cast<size_t>(o) * g.out_w, c, g.out_w, vec, y);
    }
  }
}

template <typename In, typename Out, Form kForm>
cudaError_t launch(const void* in, void* out, int planes, Geometry g, const Vectors& v,
                   cudaStream_t stream) {
  // k1x and kVec: four output columns a thread; k2x: a pair of input columns
  const int units = kForm == Form::k2x ? (g.w + 1) / 2 : (g.out_w + 3) / 4;
  const int rows = kForm == Form::kVec ? g.out_rows : g.rows;
  g.run = kRunRows;
  while ((rows + g.run - 1) / g.run > 65535) g.run *= 2;
  const dim3 grid((units + kThreads - 1) / kThreads, (rows + g.run - 1) / g.run, planes);
  // a quad of Out on its own alignment: the output's row pitch must keep it
  const bool vec = g.out_w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(Quad<Out>) == 0;
  cheap_upscale_kernel<In, Out, kForm><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(in), static_cast<Out*>(out), g, v, vec);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, void*, int, Geometry, const Vectors&, cudaStream_t);

template <Form kForm>
Launch pick(int in_type, int out_type) {
  // type codes: 0 uint8, 1 uint16, 2 float32; out is float32 or the input's type
  if (in_type == 0) {
    return out_type == 0 ? &launch<uint8_t, uint8_t, kForm> : &launch<uint8_t, float, kForm>;
  }
  if (in_type == 1) {
    return out_type == 1 ? &launch<uint16_t, uint16_t, kForm> : &launch<uint16_t, float, kForm>;
  }
  return &launch<float, float, kForm>;
}

}  // namespace

// The glue launch. `in` is `planes` planes, each `frames` frames of h x w
// (in_type 0 uint8, 1 uint16, 2 float32), read as a virtual stack with `pad`
// guard rows about each frame; `out` is `planes` planes of out_rows x out_w
// (out_type 2 float32, or the input's type). form 0 (k1x): out_rows the
// stack's rows, out_w w; 1 (k2x): twice each; 2 (kVec): the vectors r0, r1,
// rw [out_rows] over stack rows and c0, c1, cw [out_w] over columns (int64
// indices, float32 weights), with the axes' denominators. maxv is
// 2^bits - 1. Returns a cudaError_t value (0 on success).
extern "C" int raisr_cheap_upscale(const void* in, int in_type, void* out, int out_type,
                                   int form, int planes, int frames, int h, int w, int pad,
                                   int out_rows, int out_w, const int64_t* r0,
                                   const int64_t* r1, const float* rw, const int64_t* c0,
                                   const int64_t* c1, const float* cw, float rden, float cden,
                                   float maxv, int device, void* stream) {
  const int rows = frames * (h + 2 * pad);
  const bool shape_ok =
      (form == 0 && out_rows == rows && out_w == w) ||
      (form == 1 && out_rows == 2 * rows && out_w == 2 * w) ||
      (form == 2 && r0 && r1 && rw && c0 && c1 && cw && rden > 0.0f && cden > 0.0f);
  if (planes <= 0 || planes > 65535 || frames <= 0 || h <= 0 || w <= 0 || pad < 0 ||
      out_rows <= 0 || out_w <= 0 || in_type < 0 || in_type > 2 ||
      (out_type != in_type && out_type != 2) || !shape_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const Geometry g{frames, h, w, pad, rows, out_rows, out_w, kRunRows, maxv};
  const float den = rden * cden;
  const Vectors v{r0, r1, rw, c0, c1, cw, rden, cden, den, den / 2.0f};
  const Launch fn = form == 0   ? pick<Form::k1x>(in_type, out_type)
                    : form == 1 ? pick<Form::k2x>(in_type, out_type)
                                : pick<Form::kVec>(in_type, out_type);
  return static_cast<int>(fn(in, out, planes, g, v, static_cast<cudaStream_t>(stream)));
}
