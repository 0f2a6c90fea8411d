// Whole RAISR pass (ratio 2, float32 tier) for Hopper (sm_90a).
//
// Replaces the TPU kernel raisr_tpu/ops/pallas/full_kernel.py:_full_kernel
// (entered through raisr_pass_pallas_full). One pass takes the integer-valued
// cheap-upscaled plane and returns the integer-valued pass output:
//   gradients -> separable 11-tap Gaussian structure tensor * nf ->
//   2x2 eigen-analysis, polynomial atan2, angle/strength/coherence bucket ->
//   121-tap dot of the (bucket, phase) filter with the 11x11 patch ->
//   exclusive range reject -> processed-zone mask -> census blend
//   (CountOfBitsChanged or Randomness) -> floor(+0.5), clamp -> blend zone.
// Zones follow a guard-banded frame stack (frame_h/frame_pad) and row
// stripes (row0/zone_h), as in the TPU kernel.
//
// The TPU kernel multiplies every patch against all 216 buckets on the MXU and
// selects one, because a TPU has no per-lane gather. Here each thread gathers
// its own bucket's filter row and runs plain float32 multiply-adds on the
// natural [H, W] plane, in two launches:
//   A (hash_filter_kernel): one block per 32x8 output tile stages the cheap
//     tile with a 6-pixel halo in shared memory (zero outside the plane),
//     builds the gradient products and the vertical then horizontal tensor
//     sums there, hashes, and writes the raw filter output.
//   B (epilogue_kernel): reject, zones, census blend and rounding per pixel,
//     rebuilding each neighbour's HR value from its raw and cheap values.
//
// What bounds it on an H100: launch A gathers about 484 B of filter (121 taps)
// per pixel and does 121 multiplies and adds, over 8.3 M pixels per 4K plane.
// The 864 x 128 float32 bank (442 KB) stays resident in the 50 MB L2 and is
// read through the read-only path in 16-byte loads; the patch comes from
// shared memory. Staging a phase's bank in shared memory, fusing the two
// launches and wgmma are later work.
//
// Rounding: every sum and product is rounded on its own, in the order of the
// plain PyTorch version (raisr_tpu_torch/ops/cuda/full_kernel.py
// raisr_pass_full_reference), so the two agree bit for bit. That needs
// nvcc --fmad=false (no contraction to FMA) and IEEE division and sqrtf (the
// nvcc defaults; never --use_fast_math).

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kPatch = 11;
constexpr int kMargin = kPatch / 2;       // patch margin, 5
constexpr int kLoopMargin = kMargin + 1;  // processed-zone margin, 6
constexpr int kTaps = kPatch * kPatch;    // 121
constexpr int kFilterStride = 128;        // taps per bank row, zero-padded
constexpr int kPixelTypes = 4;            // ratio-2 phases
constexpr int kMaxEdges = 8;

constexpr int kTileW = 32;
constexpr int kTileH = 8;
// cheap tile: patch rows/cols plus one more for the gradient stencil
constexpr int kImgH = kTileH + 2 * kMargin + 2;  // 20
constexpr int kImgW = kTileW + 2 * kMargin + 2;  // 44
// gradient products: the tensor window around every tile pixel
constexpr int kGpH = kTileH + 2 * kMargin;  // 18
constexpr int kGpW = kTileW + 2 * kMargin;  // 42

constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kQuarterPi = static_cast<float>(3.141592653589793 / 4.0);
constexpr float kThreeQuarterPi = static_cast<float>(3.0 * 3.141592653589793 / 4.0);

struct HashParams {
  float k1d[kPatch];
  float nf;
  float qstr[kMaxEdges];
  float qcoh[kMaxEdges];
  int n_qstr;
  int n_qcoh;
  int qangle;
  int qstrength;
  int qcoherence;
  float angle_scale;  // float(qangle / pi)
};

struct EpilogueParams {
  float min_val;
  float max_val;
  int blending;  // 1 = Randomness, 2 = CountOfBitsChanged
  int col_end;
  int frame_h;
  int frame_pad;
  int row0;
  int eff_h;
};

__device__ __forceinline__ float atan2_approx(float y, float x) {
  const float abs_y = fabsf(y) + 1e-10f;
  const bool neg_x = x < 0.0f;
  const float r = neg_x ? (x + abs_y) / (abs_y - x) : (x - abs_y) / (x + abs_y);
  float angle = neg_x ? kThreeQuarterPi : kQuarterPi;
  angle = angle + (0.1963f * r * r - 0.9817f) * r;
  return y < 0.0f ? -angle : angle;
}

__device__ __forceinline__ int hash_bucket(float a, float b, float d,
                                           const HashParams& hp) {
  const float t = a + d;
  const float det = a * d - b * b;
  const float sqr = sqrtf(fmaxf(t * t * 0.25f - det, 0.0f));
  const float half_t = t * 0.5f;
  const float l1 = half_t + sqr;
  const float l2 = fmaxf(half_t - sqr, 0.0f);
  const float x = b != 0.0f ? l1 - d : 1.0f;
  float angle = atan2_approx(b, x);
  angle = angle + (angle < 0.0f ? kPi : 0.0f);
  const float sl1 = sqrtf(l1);
  const float sl2 = sqrtf(l2);
  const float coh = (sl1 - sl2) / (sl1 + sl2 + 1e-17f);
  int ai = static_cast<int>(floorf(angle * hp.angle_scale));
  ai = min(max(ai, 0), hp.qangle - 1);
  int si = 0;
  for (int e = 0; e < hp.n_qstr; ++e) si += hp.qstr[e] <= l1 ? 1 : 0;
  int ci = 0;
  for (int e = 0; e < hp.n_qcoh; ++e) ci += hp.qcoh[e] <= coh ? 1 : 0;
  return ai * (hp.qstrength * hp.qcoherence) + si * hp.qcoherence + ci;
}

__global__ void __launch_bounds__(kTileW * kTileH)
hash_filter_kernel(const float* __restrict__ cheap,
                   const float* __restrict__ filters, float* __restrict__ raw,
                   int h, int w, HashParams hp) {
  __shared__ float s_img[kImgH][kImgW];
  __shared__ float s_gp[3][kGpH][kGpW];
  __shared__ float s_v[3][kTileH][kGpW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;

  // cheap rows y0-6 .. y0+13, cols x0-6 .. x0+37; zero outside the plane
  for (int k = tid; k < kImgH * kImgW; k += kTileW * kTileH) {
    const int i = k / kImgW;
    const int j = k % kImgW;
    const int gr = y0 - kMargin - 1 + i;
    const int gc = x0 - kMargin - 1 + j;
    s_img[i][j] = (gr >= 0 && gr < h && gc >= 0 && gc < w)
                      ? cheap[static_cast<size_t>(gr) * w + gc]
                      : 0.0f;
  }
  __syncthreads();

  // gradient products at rows y0-5 .. y0+12, cols x0-5 .. x0+36. The
  // gradients are zero on the plane's border rows (gx) and columns (gy), and
  // the products are zero outside the plane.
  for (int k = tid; k < kGpH * kGpW; k += kTileW * kTileH) {
    const int i = k / kGpW;
    const int j = k % kGpW;
    const int gr = y0 - kMargin + i;
    const int gc = x0 - kMargin + j;
    float gx = 0.0f;
    float gy = 0.0f;
    if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
      if (gr >= 1 && gr <= h - 2) gx = s_img[i + 2][j + 1] - s_img[i][j + 1];
      if (gc >= 1 && gc <= w - 2) gy = s_img[i + 1][j + 2] - s_img[i + 1][j];
    }
    s_gp[0][i][j] = gx * gx;
    s_gp[1][i][j] = gx * gy;
    s_gp[2][i][j] = gy * gy;
  }
  __syncthreads();

  // vertical tensor sums for the tile's rows, taps in order 0..10
  for (int k = tid; k < kTileH * kGpW; k += kTileW * kTileH) {
    const int i = k / kGpW;
    const int j = k % kGpW;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float acc = s_gp[m][i][j] * hp.k1d[0];
#pragma unroll
      for (int q = 1; q < kPatch; ++q) acc = acc + s_gp[m][i + q][j] * hp.k1d[q];
      s_v[m][i][j] = acc;
    }
  }
  __syncthreads();

  const int r = y0 + ty;
  const int c = x0 + tx;
  if (r >= h || c >= w) return;

  // horizontal sums, then * nf
  float st[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    float acc = s_v[m][ty][tx] * hp.k1d[0];
#pragma unroll
    for (int q = 1; q < kPatch; ++q) acc = acc + s_v[m][ty][tx + q] * hp.k1d[q];
    st[m] = acc * hp.nf;
  }
  const int bucket = hash_bucket(st[0], st[1], st[2], hp);
  // pixel phase ((r-5) mod 2, (c-5) mod 2); & 1 is a floor modulo for r < 5
  const int phase = (((r - kMargin) & 1) << 1) | ((c - kMargin) & 1);

  const float4* frow = reinterpret_cast<const float4*>(
      filters + static_cast<size_t>(bucket * kPixelTypes + phase) * kFilterStride);
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < (kTaps + 3) / 4; ++q) {
    const float4 f4 = __ldg(frow + q);
    const float fv[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 4 * q + e;
      if (t < kTaps) {
        acc = acc + s_img[ty + 1 + t / kPatch][tx + 1 + t % kPatch] * fv[e];
      }
    }
  }
  raw[static_cast<size_t>(r) * w + c] = acc;
}

// Frame coordinate of a global row: identity for one frame; for a stack of
// frame_h-row frames with 2*frame_pad guard rows between them, guard rows map
// to [frame_h, period) and fail every zone test. Floor modulo.
__device__ __forceinline__ int frame_row(int g, const EpilogueParams& p) {
  if (p.frame_h <= 0) return g;
  const int period = p.frame_h + 2 * p.frame_pad;
  const int m = (g + period - p.frame_pad) % period;
  return m < 0 ? m + period : m;
}

// HR input of the census blend at an in-plane pixel: the raw filter output
// where it is in range and the pixel is in the processed zone, else cheap.
__device__ __forceinline__ float hr_value(const float* __restrict__ cheap,
                                          const float* __restrict__ raw,
                                          int r, int c, int w,
                                          const EpilogueParams& p) {
  const size_t o = static_cast<size_t>(r) * w + c;
  const float v = raw[o];
  const int fr = frame_row(r + p.row0, p);
  const bool keep = v > p.min_val && v < p.max_val;
  const bool proc = fr >= kLoopMargin && fr < p.eff_h - kLoopMargin &&
                    c >= kLoopMargin && c < p.col_end;
  return keep && proc ? v : cheap[o];
}

__global__ void __launch_bounds__(kTileW * kTileH)
epilogue_kernel(const float* __restrict__ cheap, const float* __restrict__ raw,
                float* __restrict__ out, int h, int w, EpilogueParams p) {
  const int c = blockIdx.x * kTileW + threadIdx.x;
  const int r = blockIdx.y * kTileH + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t o = static_cast<size_t>(r) * w + c;
  const float lr_c = cheap[o];
  const int fr = frame_row(r + p.row0, p);
  const bool cobc = p.blending == 2;
  const bool zone =
      cobc ? (fr >= 1 && fr < p.eff_h - 1 && c >= 1 && c < w - 1)
           : (fr >= kLoopMargin && fr < p.eff_h - kLoopMargin &&
              c >= kLoopMargin && c < p.col_end);
  if (!zone) {
    out[o] = lr_c;
    return;
  }
  const float hr_c = hr_value(cheap, raw, r, c, w, p);
  float count = 0.0f;
  for (int dr = -1; dr <= 1; ++dr) {
    for (int dc = -1; dc <= 1; ++dc) {
      if (dr == 0 && dc == 0) continue;
      const int rn = r + dr;
      const int cn = c + dc;
      const bool inside = rn >= 0 && rn < h && cn >= 0 && cn < w;
      // outside the plane both census inputs read zero
      const float ln = inside ? cheap[static_cast<size_t>(rn) * w + cn] : 0.0f;
      const float lbit = ln < lr_c ? 1.0f : 0.0f;
      if (cobc) {
        const float hn = inside ? hr_value(cheap, raw, rn, cn, w, p) : 0.0f;
        const float hbit = hn < hr_c ? 1.0f : 0.0f;
        count = count + (lbit != hbit ? 1.0f : 0.0f);
      } else {
        count = count + lbit;
      }
    }
  }
  const float weight = count / 8.0f;
  const float val = cobc ? weight * lr_c + (1.0f - weight) * hr_c
                         : weight * hr_c + (1.0f - weight) * lr_c;
  out[o] = fminf(fmaxf(floorf(val + 0.5f), p.min_val), p.max_val);
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

// Launch A. Host arrays k1d[11], qstr[n_qstr], qcoh[n_qcoh] are copied into
// the kernel's parameters. filters is [qangle*qstrength*qcoherence*4, 128],
// 16-byte aligned. Returns a cudaError_t value (0 on success).
extern "C" int raisr_full_hash_filter(
    const float* cheap, const float* filters, float* raw, int h, int w,
    const float* k1d, float nf, const float* qstr, int n_qstr,
    const float* qcoh, int n_qcoh, int qangle, int qstrength, int qcoherence,
    float angle_scale, int device, void* stream) {
  if (h <= 0 || w <= 0 || n_qstr < 0 || n_qstr > kMaxEdges || n_qcoh < 0 ||
      n_qcoh > kMaxEdges || qangle <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  HashParams hp;
  std::memset(&hp, 0, sizeof(hp));
  std::memcpy(hp.k1d, k1d, sizeof(hp.k1d));
  hp.nf = nf;
  std::memcpy(hp.qstr, qstr, sizeof(float) * n_qstr);
  std::memcpy(hp.qcoh, qcoh, sizeof(float) * n_qcoh);
  hp.n_qstr = n_qstr;
  hp.n_qcoh = n_qcoh;
  hp.qangle = qangle;
  hp.qstrength = qstrength;
  hp.qcoherence = qcoherence;
  hp.angle_scale = angle_scale;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  hash_filter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      cheap, filters, raw, h, w, hp);
  return static_cast<int>(cudaGetLastError());
}

// Launch B. Returns a cudaError_t value (0 on success).
extern "C" int raisr_full_epilogue(
    const float* cheap, const float* raw, float* out, int h, int w,
    float min_val, float max_val, int blending, int col_end, int frame_h,
    int frame_pad, int row0, int eff_h, int device, void* stream) {
  if (h <= 0 || w <= 0 || (blending != 1 && blending != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const EpilogueParams p{min_val, max_val, blending, col_end,
                         frame_h, frame_pad, row0, eff_h};
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  epilogue_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      cheap, raw, out, h, w, p);
  return static_cast<int>(cudaGetLastError());
}
