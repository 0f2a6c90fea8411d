// Whole RAISR pass for Hopper (sm_90a), every tier of the TPU kernel, for
// 4-phase (ratio 2) and single-phase (ratio 1.5) filter banks, and the
// filter apply to given buckets.
//
// Replaces two TPU kernels of raisr_tpu/ops/pallas/full_kernel.py:
//   _full_kernel        (entered through raisr_pass_pallas_full), 4 phases;
//   _full_kernel_single (entered through raisr_pass_pallas_full_single), 1;
// and three of raisr_tpu/ops/pallas/filter_kernel.py:
//   _band_kernel_fused  (apply_filters_hash_pallas): launches A1 and A2 below;
//   _band_kernel and _single_kernel (apply_filters_pallas, 4 and 1 phases):
//                       launch A2 alone over the caller's int32 buckets, where
//                       a bucket outside [0, n_buckets) gives raw 0, as the TPU
//                       kernels' select over zero-padded bank rows does.
// The 4- and 1-phase forms differ only in how a pixel picks its filter row: bank row
// bucket * 4 + phase for a 4-phase bank, bucket for a single-phase one. Here
// that is a template parameter (kPhases), not a second copy. The tier is the
// other (kTier), one case of the same kernel each; the host prepares each
// tier's bank once (ops/cuda/full_kernel.py):
//   kF32      float32 bank: the TPU's float32 grade (mxu_passes 2 and 3, so
//             8, 10 and 16 bits alike).
//   kBF16     bfloat16 bank rounded with error diffusion along the taps
//             (round_bf16_error_diffused, as _round_bf16_error_diffused):
//             the 8-bit bf16 tier (mxu_passes=1) and, at 10/16 bits, p_split.
//             A bf16 tap times an integer of up to 16 bits is exact in
//             float32, so the TPU's [F', F'] x [Phi, Plo] is F' x P: float32
//             arithmetic on a 256-byte row instead of a 512-byte one.
//   kPCenter  the 10-bit bf16 tier (pcenter=512): the same bf16 bank against
//             the patch bf16(P - 512) (round to nearest even), then one add of
//             the row's float32 bias 512 * sum(F') (pcenter_bias) after tap
//             120.
//   kInt8     the int8 tier (8-bit content): integer taps on the int16 grid
//             (int8_bank, as _round_int_error_diffused with the bank's
//             power-of-two scale), an exact int32 dot with the unshifted
//             integer patch, rounded to float32 and times the float32
//             1/scale. The TPU's -128 patch shift and its 128 * rowsum bias
//             cancel, so neither is needed here; the power-of-two multiply
//             after the int -> float rounding is JAX's (gt).astype(f32) * inv
//             exactly.
// One pass takes the integer-valued cheap-upscaled plane and returns the
// integer-valued pass output:
//   gradients -> separable 11-tap Gaussian structure tensor * nf ->
//   2x2 eigen-analysis, polynomial atan2, angle/strength/coherence bucket ->
//   121-tap dot of the (bucket[, phase]) filter with the 11x11 patch ->
//   exclusive range reject -> processed-zone mask -> census blend
//   (CountOfBitsChanged or Randomness) -> floor(+0.5), clamp -> blend zone.
// Zones follow a guard-banded frame stack (frame_h/frame_pad, any pad, odd
// ones included) and row stripes (row0/zone_h), as in the TPU kernels.
//
// The TPU kernels multiply every patch against all 216 buckets on the MXU and
// select one, because a TPU has no per-lane gather. Here each pixel reads its
// own bucket's filter row and runs plain multiply-adds (float32; int32 at the
// int8 tier) on the natural [H, W] plane. A pass is three CUDA launches on
// one stream, counted as one pass by the wrapper; launch A, the hash and the
// filter, is two of them:
//   A1 (hash_bucket_kernel): one block per 32x32 output tile stages the cheap
//     tile with a 6-pixel halo in shared memory (zero outside the plane),
//     builds the gradient products and the vertical then horizontal tensor
//     sums, hashes, and writes each pixel's bucket as one byte.
//   A2 (gather_resident_kernel<kPhases, kTier, Bucket>): persistent blocks,
//     each serving ONE pixel phase with that phase's bank rows resident in
//     shared memory, walk over tiles of same-phase pixels and write the raw
//     filter output (dot_rows of raisr_common.cuh). Bucket is uint8_t for
//     A1's plane and int for a caller's (apply_filters), which is range
//     checked.
//   B (epilogue_kernel<kCobc, kVec>): reject, zones, census blend and
//     rounding. Each pixel's HR value is formed once, on the way in; see the
//     note above the kernel.
//
// What bounds launch A on an H100, and what the design does about it. It
// moves few bytes (the plane in twice, a byte of bucket out and back, the
// raw plane out: ~116 MB a 4K plane, ~35 us at 3.35 TB/s) and does
// ~400 float operations a pixel, so neither bounds it. A2 waits on shared
// memory (one 128-byte wavefront per SM per clock); A1 on the issue of its
// instructions and the latency of the hash's IEEE divisions and square
// roots. Launch B moves 12 bytes a pixel (cheap and raw in, the pass out:
// ~100 MB a 4K plane, ~30 us) and is bound by them once its census reads
// come from registers:
//   - The filter row. A pixel reads 121 taps: 31 16-byte loads at float32,
//     16 at 16 bits. Gathered from global memory, the 32 lanes of a warp read
//     up to 32 different rows, so each warp-wide load splits into up to 32
//     sectors from L2 (the whole bank, 442 KB at float32, does not stay in
//     L1): ~89% of the pass when launch A was one kernel gathering so. A2
//     stages the rows of one phase (216 rows; a single-phase bank whole) ONCE
//     per persistent block with cp.async, re-strided on the way: 107 KB at
//     float32, 59 KB at 16 bits. A block then reads them from shared memory,
//     where a 16-byte load is served a quarter-warp (8 lanes) per wavefront
//     and lanes on one row are broadcasts. The row stride is 124 floats (31
//     groups) or 136 16-bit taps (17 groups), odd numbers of 16-byte groups,
//     so row b's group q sits in bank group (q - b) mod 8 (float32) or
//     (q + b) mod 8 (16 bits): 8 lanes on 8 different rows conflict only
//     where their rows agree mod 8.
//   - The patch: scalar shared-memory reads. A block serves one phase, so a
//     warp's lanes are same-phase pixels two columns apart; the staged tile
//     is stored split by column parity (two planes), so lane j of any tap
//     reads word j + const of one plane: conflict-free. A thread takes two
//     same-phase pixels one phase row apart, whose patches share 9 of their
//     11 rows, and reads each shared value once: 143 reads for the two
//     pixels, not 242.
//   - The hash is needed at every pixel, and its scratch (gradient products
//     and tensor sums, ~37 KB a 256-pixel tile) does not fit beside a float32
//     phase bank for more than two tiles in flight; a block serving one phase
//     would also build the gradient products of every pixel four times and
//     the vertical sums twice. So launch A is split: A1 hashes every pixel
//     once and hands A2 a byte a pixel (8.3 MB a 4K plane, written once and
//     read once). A1 runs its sums down a column and along a row with each
//     product feeding the live sums of its taps, so few values stay live and
//     four blocks fit on an SM to hide the hash's latency.
//   - A2's blocks: 4 groups of 256 threads (1024 threads), one tile of 16 x 32
//     same-phase pixels a group at a time; the groups sync on their own named
//     barriers, so one group waits while the others compute, and each group
//     copies its next tile into a second buffer with cp.async during the dot
//     of the current one. One block a SM, no more than the tiles need.
// The host keeps the bank as [rows, 128]; A2's staging copies make the
// phase-major, re-strided layout the card reads.
//
// Rounding: every sum and product is rounded on its own, in the order of the
// plain PyTorch version (raisr_tpu_torch/ops/cuda/full_kernel.py
// raisr_pass_full_reference), so the two agree bit for bit. That needs
// nvcc --fmad=false (no contraction to FMA) and IEEE division and sqrtf (the
// nvcc defaults; never --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "raisr_common.cuh"

namespace {

constexpr int kMaxEdges = 8;

// the tier codes of the C entry point (ops/cuda/full_kernel.py _TIER_CODE)
enum class Tier : int { kF32 = 0, kBF16 = 1, kPCenter = 2, kInt8 = 3 };

// the pcenter tier's patch centre (raisr_tpu's pass_statics: pcenter=512.0)
constexpr float kPCenterValue = 512.0f;

// a tier's bank element (the patch values its dot reads: Taps<Bank>::Acc)
template <Tier T> struct TierTypes;
template <> struct TierTypes<Tier::kF32> { using Bank = float; };
template <> struct TierTypes<Tier::kBF16> { using Bank = __nv_bfloat16; };
template <> struct TierTypes<Tier::kPCenter> { using Bank = __nv_bfloat16; };
template <> struct TierTypes<Tier::kInt8> { using Bank = int16_t; };

// -- A1: the hash ------------------------------------------------------------

// A1's tile: 32 x 32 output pixels a block of 256 threads
constexpr int kHashTile = 32;
constexpr int kHashThreads = 256;
// cheap tile: the tensor window plus one more for the gradient stencil
constexpr int kHImg = kHashTile + 2 * kMargin + 2;  // 44
// gradient products: the tensor window around every tile pixel
constexpr int kHGp = kHashTile + 2 * kMargin;  // 42
// vertical sums a thread computes down one column
constexpr int kSeg = 8;
// row stride of the vertical sums: odd, so 32 lanes on 32 rows read 32 banks
constexpr int kVStride = kHGp + 1;  // 43
// horizontal sums a thread computes along one row
constexpr int kRun = kHashTile / (kHashThreads / 32);  // 4

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

// Every pixel's bucket, one byte each (the wrapper holds the bucket count
// at 256 or below). The block stages the cheap tile with its 6-pixel halo;
// each of 168 threads walks 18 rows down one column of the tensor window,
// building the gradient products in registers, and writes 8 vertical sums;
// each thread then slides along 4 pixels of one row (lanes on 32 rows)
// for the horizontal sums and hashes them. Every sum keeps the plain
// version's order of taps; the buckets leave through shared memory, so the
// block writes them row by row.
__global__ void __launch_bounds__(kHashThreads, 4)
hash_bucket_kernel(const float* __restrict__ cheap, uint8_t* __restrict__ buckets,
                   int h, int w, HashParams hp) {
  __shared__ float s_img[kHImg][kHImg];
  __shared__ float s_v[3][kHashTile][kVStride];
  __shared__ uint8_t s_b[kHashTile][kHashTile];

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kHashTile;
  const int y0 = blockIdx.y * kHashTile;

  // cheap rows y0-6 .. y0+37, cols x0-6 .. x0+37; zero outside the plane
  for (int k = tid; k < kHImg * kHImg; k += kHashThreads) {
    const int i = k / kHImg;
    const int j = k % kHImg;
    const int gr = y0 - kMargin - 1 + i;
    const int gc = x0 - kMargin - 1 + j;
    s_img[i][j] = (gr >= 0 && gr < h && gc >= 0 && gc < w)
                      ? cheap[static_cast<size_t>(gr) * w + gc]
                      : 0.0f;
  }
  __syncthreads();

  // vertical tensor sums: column j of the window (plane column x0-5+j),
  // rows kSeg*s .. kSeg*s+7 of the tile, taps in order 0..10 over the
  // gradient products of window rows kSeg*s .. kSeg*s+17. The gradients are
  // zero on the plane's border rows (gx) and columns (gy), and the products
  // are zero outside the plane.
  // Each product row i feeds the sums of rows i-10 .. i as their tap
  // i - o, so every sum still adds its taps in order 0..10 while only the
  // 3 x 8 sums stay live.
  for (int task = tid; task < kHGp * (kHashTile / kSeg); task += kHashThreads) {
    const int j = task % kHGp;
    const int s = task / kHGp;
    const int gc = x0 - kMargin + j;
    float acc[3][kSeg];
#pragma unroll
    for (int i = 0; i < kSeg + kPatch - 1; ++i) {
      const int gi = kSeg * s + i;
      const int gr = y0 - kMargin + gi;
      float gx = 0.0f;
      float gy = 0.0f;
      if (gr >= 0 && gr < h && gc >= 0 && gc < w) {
        if (gr >= 1 && gr <= h - 2) gx = s_img[gi + 2][j + 1] - s_img[gi][j + 1];
        if (gc >= 1 && gc <= w - 2) gy = s_img[gi + 1][j + 2] - s_img[gi + 1][j];
      }
      const float p[3] = {gx * gx, gx * gy, gy * gy};
#pragma unroll
      for (int o = 0; o < kSeg; ++o) {
        if (o > i || i - o >= kPatch) continue;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          acc[m][o] = o == i ? p[m] * hp.k1d[0] : acc[m][o] + p[m] * hp.k1d[i - o];
        }
        if (i - o == kPatch - 1) {
#pragma unroll
          for (int m = 0; m < 3; ++m) s_v[m][kSeg * s + o][j] = acc[m][o];
        }
      }
    }
  }
  __syncthreads();

  // horizontal sums of tile row `row`, columns c0 .. c0+3, then * nf
  const int row = tid % 32;
  const int c0 = (tid / 32) * kRun;
  float st[kRun][3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int q = 0; q < kRun + kPatch - 1; ++q) {
      const float v = s_v[m][row][c0 + q];
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        if (e > q || q - e >= kPatch) continue;
        st[e][m] = e == q ? v * hp.k1d[0] : st[e][m] + v * hp.k1d[q - e];
      }
    }
#pragma unroll
    for (int e = 0; e < kRun; ++e) st[e][m] = st[e][m] * hp.nf;
  }
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    s_b[row][c0 + e] = static_cast<uint8_t>(hash_bucket(st[e][0], st[e][1], st[e][2], hp));
  }
  __syncthreads();
  for (int k = tid; k < kHashTile * kHashTile; k += kHashThreads) {
    const int r = y0 + k / kHashTile;
    const int c = x0 + k % kHashTile;
    if (r < h && c < w) {
      buckets[static_cast<size_t>(r) * w + c] = s_b[k / kHashTile][k % kHashTile];
    }
  }
}

// -- A2: the gather with the bank resident in shared memory ------------------

constexpr int kGroupThreads = 256;                        // 8 warps
constexpr int kGroups = 4;                                // tile groups a block
constexpr int kBlockThreads = kGroups * kGroupThreads;    // 1024
constexpr int kPix = 2;                                   // pixels a thread, one column
constexpr int kTileRows = kPix * kGroupThreads / 32;      // same-phase rows a tile: 16
constexpr int kTileCols = 32;                             // same-phase columns: a lane each

// A tile of 16 x 32 same-phase pixels, kStep (2 for 4 phases, 1 for 1)
// rows and columns apart, and its staged patch region: the rows and columns
// its patches cover, stored as kStep planes by column parity, so that
// region column x is word x / kStep of plane x % kStep.
template <int kStep>
struct TileShape {
  static constexpr int kRows = kStep * (kTileRows - 1) + kPatch;   // 41 or 26
  static constexpr int kCols = kStep * (kTileCols - 1) + kPatch;   // 73 or 42
  static constexpr int kPlaneW = (kCols + kStep - 1) / kStep;      // 37 or 42
  static constexpr int kRowStride = kStep * kPlaneW;               // 74 or 42
  static constexpr int kWords = kRows * kRowStride;
  static constexpr int kPerThread = (kRows * kCols + kGroupThreads - 1) / kGroupThreads;
};

// A phase's bank row in shared memory: taps 0..120 in an odd number of
// 16-byte groups (see the header)
template <typename TF>
constexpr int kSmemRowBytes = 16 * (kRowGroups<TF> | 1);  // 496 (float32) or 272

// A2's dynamic shared memory: the phase's rows, the pcenter bias, then two
// tile buffers a group
template <int kPhases, Tier kTier>
struct GatherSmem {
  using TF = typename TierTypes<kTier>::Bank;
  static constexpr int kStep = kPhases == 4 ? 2 : 1;
  __host__ __device__ static size_t tiles_offset(int n_buckets) {
    const size_t bias = kTier == Tier::kPCenter ? ((n_buckets * 4 + 15) / 16) * 16 : 0;
    return static_cast<size_t>(n_buckets) * kSmemRowBytes<TF> + bias;
  }
  __host__ __device__ static size_t bytes(int n_buckets) {
    return tiles_offset(n_buckets) +
           static_cast<size_t>(2 * kGroups) * TileShape<kStep>::kWords * 4;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// 4 bytes, or 4 zero bytes where !valid
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

// a barrier of one group's 256 threads (ids 1..kGroups; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kGroupThreads) : "memory");
}

// Persistent: block b serves phase b % kPhases. It stages that phase's rows
// (bucket * kPhases + phase) once, then each of its groups walks over the
// phase's tiles, kGroups * (gridDim.x / kPhases) tiles apart. pbias
// (kPCenter) is the bank's per-row bias, inv_scale (kInt8) its 1/scale; the
// other tiers ignore them. Bucket is the element of the bucket plane:
// uint8_t, A1's, every value a row of the bank; int, a caller's, where a
// value outside [0, n_buckets) gives raw 0 (its dot runs over row 0 and is
// dropped, so no address outside the staged rows is formed).
template <int kPhases, Tier kTier, typename Bucket>
__global__ void __launch_bounds__(kBlockThreads, 1)
gather_resident_kernel(const float* __restrict__ cheap,
                       const Bucket* __restrict__ buckets,
                       const typename TierTypes<kTier>::Bank* __restrict__ filters,
                       const float* __restrict__ pbias, float inv_scale,
                       float* __restrict__ raw, int h, int w, int n_buckets) {
  using TF = typename TierTypes<kTier>::Bank;
  using TP = typename Taps<TF>::Acc;
  constexpr int kStep = kPhases == 4 ? 2 : 1;
  using Shape = TileShape<kStep>;
  constexpr int kRowBytes = kSmemRowBytes<TF>;
  constexpr bool kChecked = !std::is_same<Bucket, uint8_t>::value;

  // the phase's pixels: rows r0 + kStep * i, columns c0 + kStep * j, where
  // a pixel's phase is ((r-5) mod 2, (c-5) mod 2)
  const int phase = blockIdx.x % kPhases;
  const int r0 = kPhases == 4 ? ((phase >> 1) + kMargin) & 1 : 0;
  const int c0 = kPhases == 4 ? ((phase & 1) + kMargin) & 1 : 0;
  const int n_r = h > r0 ? (h - r0 + kStep - 1) / kStep : 0;
  const int n_c = w > c0 ? (w - c0 + kStep - 1) / kStep : 0;
  const int tiles_c = (n_c + kTileCols - 1) / kTileCols;
  const int n_tiles = ((n_r + kTileRows - 1) / kTileRows) * tiles_c;
  const int group = threadIdx.x / kGroupThreads;
  const int first = (blockIdx.x / kPhases) * kGroups + group;
  const int stride = (gridDim.x / kPhases) * kGroups;
  if (blockIdx.x / kPhases * kGroups >= n_tiles) return;  // the whole block idles

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_bank = smem;
  float* s_bias = reinterpret_cast<float*>(smem + static_cast<size_t>(n_buckets) * kRowBytes);
  TP* s_tiles = reinterpret_cast<TP*>(
      smem + GatherSmem<kPhases, kTier>::tiles_offset(n_buckets)) + 2 * group * Shape::kWords;

  // stage the phase's rows: global row bucket * kPhases + phase (128 taps)
  // to shared row bucket (kRowBytes apart), 16 bytes a copy
  {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(filters);
    constexpr int kG = kRowGroups<TF>;
    for (int i = threadIdx.x; i < n_buckets * kG; i += kBlockThreads) {
      const int b = i / kG;
      const int q = i % kG;
      cp_async16(s_bank + static_cast<size_t>(b) * kRowBytes + 16 * q,
                 src + (static_cast<size_t>(b) * kPhases + phase) * kFilterStride * sizeof(TF) +
                     16 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if constexpr (kTier == Tier::kPCenter) {
      for (int b = threadIdx.x; b < n_buckets; b += kBlockThreads) {
        s_bias[b] = pbias[b * kPhases + phase];
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  const int gtid = threadIdx.x % kGroupThreads;
  const int warp = gtid / 32;
  const int lane = gtid % 32;

  // Tile t's patch region, from (tile row 0) - 5 and (tile column 0) - 5,
  // copied into buffer b (zero outside the plane) as one cp.async group;
  // element e of the region is this thread's for e = gtid (mod 256).
  auto slot = [&](int e) {
    const int y = e / Shape::kCols;
    const int x = e % Shape::kCols;
    return y * Shape::kRowStride + (x % kStep) * Shape::kPlaneW + x / kStep;
  };
  auto issue = [&](int t, int b) {
    float* dst = reinterpret_cast<float*>(s_tiles + b * Shape::kWords);
    const int top = r0 + kStep * kTileRows * (t / tiles_c) - kMargin;
    const int left = c0 + kStep * kTileCols * (t % tiles_c) - kMargin;
#pragma unroll
    for (int k = 0; k < Shape::kPerThread; ++k) {
      const int e = gtid + k * kGroupThreads;
      if (e < Shape::kRows * Shape::kCols) {
        const int gr = top + e / Shape::kCols;
        const int gc = left + e % Shape::kCols;
        const bool valid = gr >= 0 && gr < h && gc >= 0 && gc < w;
        cp_async4_zfill(dst + slot(e), valid ? cheap + static_cast<size_t>(gr) * w + gc : cheap,
                        valid);
      }
    }
  };

  if (first < n_tiles) issue(first, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  int buf = 0;
  for (int t = first; t < n_tiles; t += stride, buf ^= 1) {
    // the thread's pixels: same-phase rows kPix * warp .. +kPix-1 of the
    // tile, same-phase column lane
    const int r = r0 + kStep * (kTileRows * (t / tiles_c) + kPix * warp);
    const int c = c0 + kStep * (kTileCols * (t % tiles_c) + lane);
    bool inside[kPix];
    bool held[kPix];  // the pixel's bucket is a row of the bank
    int bucket[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      inside[p] = r + kStep * p < h && c < w;
      bucket[p] = inside[p] ? buckets[static_cast<size_t>(r + kStep * p) * w + c] : 0;
      held[p] = true;
      if constexpr (kChecked) {
        held[p] = bucket[p] >= 0 && bucket[p] < n_buckets;
        bucket[p] = held[p] ? bucket[p] : 0;
      }
    }

    group_sync(group);  // the group's dot of the previous tile is done with buffer buf ^ 1
    if (t + stride < n_tiles) issue(t + stride, buf ^ 1);  // in flight during this dot
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this thread's copies of tile t
    TP* s_tile = s_tiles + buf * Shape::kWords;
    if constexpr (kTier == Tier::kPCenter || kTier == Tier::kInt8) {
      // once every copy of tile t has landed, the value the dot reads, in
      // place, word by word: pcenter's bf16(plane - 512), int8's integers
      // (the plane is integer-valued: exact)
      group_sync(group);
      float* f = reinterpret_cast<float*>(s_tile);
      for (int i = gtid; i < Shape::kWords; i += kGroupThreads) {
        const float v = f[i];
        if constexpr (kTier == Tier::kPCenter) {
          f[i] = __bfloat162float(__float2bfloat16_rn(v - kPCenterValue));
        } else {
          s_tile[i] = static_cast<int>(v);
        }
      }
    }
    group_sync(group);

    const TP* base = s_tile + kStep * kPix * warp * Shape::kRowStride + lane;
    float v[kPix];
    dot_rows<TF, kPix, kStep>(
        v,
        [&](int p, int q) {
          return reinterpret_cast<const uint4*>(s_bank + bucket[p] * kRowBytes)[q];
        },
        [&](int rho, int dx) {
          return base[rho * Shape::kRowStride + (dx % kStep) * Shape::kPlaneW + dx / kStep];
        });
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (!inside[p]) continue;
      if constexpr (kTier == Tier::kPCenter) v[p] = v[p] + s_bias[bucket[p]];
      if constexpr (kTier == Tier::kInt8) v[p] = v[p] * inv_scale;
      raw[static_cast<size_t>(r + kStep * p) * w + c] = held[p] ? v[p] : 0.0f;
    }
  }
}

// -- B: the epilogue -----------------------------------------------------------

// What launch B computes per pixel, as ops/epilogue.py _finish_pass:
//   hr    = raw where it is in range (exclusive) and the pixel is in the
//           processed zone, else cheap;
//   count = CountOfBitsChanged: the 3x3 neighbours n with
//           (cheap[n] < cheap) != (hr[n] < hr); Randomness: those with
//           cheap[n] < cheap; a neighbour outside the plane reads 0 in both;
//   out   = clamp(floor(w * a + (1 - w) * b + 0.5)) with w = count / 8 and
//           (a, b) = (cheap, hr) or (hr, cheap), inside the blend zone, else
//           cheap.
// What bounds it on an H100: its 12 bytes a pixel, once nothing else is in
// the way. A thread that serves one pixel and rebuilds each neighbour's hr
// (nine range and zone tests, ten run-time modulos and eighteen scalar loads
// a pixel) is bound by the issue of its instructions, at 3.5x its bytes. So:
//   - a thread owns 4 pixels of a row, one 16-byte load of cheap and of raw
//     and one 16-byte store; where the row pitch or a pointer is not a
//     multiple of 16 bytes (kVec false) the same code moves them one by one;
//   - a warp (128 columns) walks down kEpiRows rows with the cheap and hr
//     values of three rows in registers, so every census read is a register
//     read; the columns beside a thread's four come from the neighbour lanes
//     by shuffle, and only the warp's two edge lanes load theirs;
//   - hr is formed once per pixel, as its row comes in; the row's frame
//     coordinate (one modulo a warp, then counted on) and the column tests
//     (once a thread) are never repeated per neighbour;
//   - Randomness (kCobc false) reads raw at the pixel alone: no raw halo.
// The count is an integer, so it is exact in any order; w, the blend and the
// rounding keep the plain version's order of float operations.

constexpr int kEpiVec = 4;                      // pixels a thread: one 16-byte access
constexpr int kEpiCols = 32 * kEpiVec;          // columns a warp covers
constexpr int kEpiRows = 16;                    // rows a warp walks down
constexpr int kEpiWarps = 8;                    // warps a block, one below the other
constexpr int kEpiWin = kEpiVec + 2;            // a row's window: the four and one each side
constexpr unsigned kFullWarp = 0xffffffffu;

// Frame coordinate of a global row: identity for one frame; for a stack of
// frame_h-row frames with 2*frame_pad guard rows between them, guard rows map
// to [frame_h, period) and fail every zone test. Floor modulo.
__device__ __forceinline__ int frame_row(int g, const EpilogueParams& p) {
  if (p.frame_h <= 0) return g;
  const int period = p.frame_h + 2 * p.frame_pad;
  const int m = (g + period - p.frame_pad) % period;
  return m < 0 ? m + period : m;
}

// hr of one pixel from its raw and cheap values; `proc`: in the processed zone
__device__ __forceinline__ float hr_value(float v, float l, bool proc,
                                          const EpilogueParams& p) {
  return (v > p.min_val && v < p.max_val && proc) ? v : l;
}

// Row r of the plane into a window: cheap L and hr H at columns c0-1 .. c0+4
// (index 0 .. 5), zero outside the plane. `rproc`: the row is in the
// processed zone; bit k of `proc_cols`: column c0 - 1 + k is. Randomness
// (kCobc false) needs hr at the thread's own four columns of the rows it
// writes: `with_raw` false (a halo row) leaves H alone, and H's two side
// columns are never filled.
template <bool kCobc, bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ cheap,
                                         const float* __restrict__ raw, int r, int c0,
                                         int lane, int h, int w, bool rproc,
                                         unsigned proc_cols, bool with_raw,
                                         const EpilogueParams& p, float (&L)[kEpiWin],
                                         float (&H)[kEpiWin]) {
  const bool row_in = r >= 0 && r < h;
  const size_t base = static_cast<size_t>(row_in ? r : 0) * w;
  float l[kEpiVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  float v[kEpiVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (kVec) {
    if (row_in && c0 < w) {
      const float4 t = *reinterpret_cast<const float4*>(cheap + base + c0);
      l[0] = t.x, l[1] = t.y, l[2] = t.z, l[3] = t.w;
      if (with_raw) {
        const float4 u = *reinterpret_cast<const float4*>(raw + base + c0);
        v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kEpiVec; ++k) {
      if (row_in && c0 + k < w) {
        l[k] = cheap[base + c0 + k];
        if (with_raw) v[k] = raw[base + c0 + k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kEpiVec; ++k) {
    L[k + 1] = l[k];
    if (with_raw) H[k + 1] = hr_value(v[k], l[k], rproc && ((proc_cols >> (k + 1)) & 1u), p);
  }
  // the columns beside the four: the neighbour lanes' outer values; the
  // warp's edge lanes load theirs
  L[0] = __shfl_up_sync(kFullWarp, l[kEpiVec - 1], 1);
  L[kEpiWin - 1] = __shfl_down_sync(kFullWarp, l[0], 1);
  if (kCobc) {
    H[0] = __shfl_up_sync(kFullWarp, H[kEpiVec], 1);
    H[kEpiWin - 1] = __shfl_down_sync(kFullWarp, H[1], 1);
  }
  if (lane == 0 || lane == 31) {
    const int k = lane == 0 ? 0 : kEpiWin - 1;
    const int c = c0 - 1 + k;
    const bool in = row_in && c >= 0 && c < w;
    const float le = in ? cheap[base + c] : 0.0f;
    float he = 0.0f;
    if (kCobc) he = hr_value(in ? raw[base + c] : 0.0f, le, rproc && ((proc_cols >> k) & 1u), p);
    if (lane == 0) {
      L[0] = le;
      if (kCobc) H[0] = he;
    } else {
      L[kEpiWin - 1] = le;
      if (kCobc) H[kEpiWin - 1] = he;
    }
  }
}

// One block: kEpiWarps warps, warp i on rows (blockIdx.y * kEpiWarps + i) *
// kEpiRows .. + kEpiRows - 1, columns blockIdx.x * kEpiCols .. + kEpiCols - 1.
// No thread leaves before its warp's last shuffle. Four blocks a SM (64
// registers a thread): more rows in flight hide the loads' latency, which
// is what a kernel this close to its bytes waits on. The one-by-one form
// needs more registers for its addresses and gets three blocks' worth.
template <bool kCobc, bool kVec>
__global__ void __launch_bounds__(32 * kEpiWarps, kVec ? 4 : 3)
epilogue_kernel(const float* __restrict__ cheap, const float* __restrict__ raw,
                float* __restrict__ out, int h, int w, EpilogueParams p) {
  const int lane = threadIdx.x % 32;
  const int c0 = (blockIdx.x * 32 + lane) * kEpiVec;
  const int r0 = (blockIdx.y * kEpiWarps + threadIdx.x / 32) * kEpiRows;
  if (r0 >= h) return;  // the whole warp

  // the column tests, once: bit k is column c0 - 1 + k
  unsigned proc_cols = 0, zone_cols = 0;
#pragma unroll
  for (int k = 0; k < kEpiWin; ++k) {
    const int c = c0 - 1 + k;
    const bool proc = c >= kLoopMargin && c < p.col_end;
    proc_cols |= (proc ? 1u : 0u) << k;
    zone_cols |= ((kCobc ? (c >= 1 && c < w - 1) : proc) ? 1u : 0u) << k;
  }

  const int period = p.frame_h + 2 * p.frame_pad;
  int fr = frame_row(r0 - 1 + p.row0, p);  // of the row coming in
  float L[3][kEpiWin], H[3][kEpiWin];
  bool rzone[3];
#pragma unroll
  for (int i = 0; i < kEpiRows + 2; ++i) {
    // row r0 - 1 + i comes into slot i % 3
    const bool rproc = fr >= kLoopMargin && fr < p.eff_h - kLoopMargin;
    rzone[i % 3] = kCobc ? (fr >= 1 && fr < p.eff_h - 1) : rproc;
    load_row<kCobc, kVec>(cheap, raw, r0 - 1 + i, c0, lane, h, w, rproc, proc_cols,
                          kCobc || (i >= 1 && i <= kEpiRows), p, L[i % 3], H[i % 3]);
    fr = fr + 1;
    if (p.frame_h > 0 && fr == period) fr = 0;
    if (i < 2) continue;

    // row r = r0 + i - 2 has its three rows: slots (i - 2, i - 1, i) % 3
    const int r = r0 + i - 2;
    if (r >= h) break;  // the whole warp
    const float(&La)[kEpiWin] = L[(i - 2) % 3];
    const float(&Lb)[kEpiWin] = L[(i - 1) % 3];
    const float(&Lc)[kEpiWin] = L[i % 3];
    const float(&Ha)[kEpiWin] = H[(i - 2) % 3];
    const float(&Hb)[kEpiWin] = H[(i - 1) % 3];
    const float(&Hc)[kEpiWin] = H[i % 3];
    float o[kEpiVec];
#pragma unroll
    for (int k = 0; k < kEpiVec; ++k) {
      const int j = k + 1;
      const float lc = Lb[j];
      const float hc = Hb[j];
      int count = 0;
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
        if (kCobc) {
          count += ((La[j + dj] < lc) != (Ha[j + dj] < hc)) ? 1 : 0;
          count += ((Lc[j + dj] < lc) != (Hc[j + dj] < hc)) ? 1 : 0;
          if (dj != 0) count += ((Lb[j + dj] < lc) != (Hb[j + dj] < hc)) ? 1 : 0;
        } else {
          count += La[j + dj] < lc ? 1 : 0;
          count += Lc[j + dj] < lc ? 1 : 0;
          if (dj != 0) count += Lb[j + dj] < lc ? 1 : 0;
        }
      }
      const float weight = static_cast<float>(count) / 8.0f;
      const float val = kCobc ? weight * lc + (1.0f - weight) * hc
                              : weight * hc + (1.0f - weight) * lc;
      const bool zone = rzone[(i - 1) % 3] && ((zone_cols >> j) & 1u);
      o[k] = zone ? fminf(fmaxf(floorf(val + 0.5f), p.min_val), p.max_val) : lc;
    }
    float* dst = out + static_cast<size_t>(r) * w + c0;
    if (kVec) {
      if (c0 < w) *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kEpiVec; ++k) {
        if (c0 + k < w) dst[k] = o[k];
      }
    }
  }
}

// -- launches ------------------------------------------------------------------

template <typename Bucket>
using GatherLaunch = cudaError_t (*)(const float*, const Bucket*, const void*, const float*,
                                     float, float*, int, int, int, int, cudaStream_t);

// Launch A2: one persistent block a SM (a block of 1024 threads at 59-64
// registers fills the register file), a whole multiple of kPhases, and no
// more than the tiles of a phase need. A block that cannot get its shared
// memory fails cudaFuncSetAttribute or the launch, and the error returns.
template <int kPhases, Tier kTier, typename Bucket>
cudaError_t launch_gather(const float* cheap, const Bucket* buckets, const void* filters,
                          const float* pbias, float inv_scale, float* raw, int h, int w,
                          int n_buckets, int device, cudaStream_t st) {
  constexpr int kStep = kPhases == 4 ? 2 : 1;
  const size_t smem = GatherSmem<kPhases, kTier>::bytes(n_buckets);
  cudaError_t err = cudaFuncSetAttribute(&gather_resident_kernel<kPhases, kTier, Bucket>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // tiles of the phase with the most pixels
  const long long n_r = (h + kStep - 1) / kStep;
  const long long n_c = (w + kStep - 1) / kStep;
  const long long tiles = ((n_r + kTileRows - 1) / kTileRows) * ((n_c + kTileCols - 1) / kTileCols);
  const long long per_phase =
      std::max(1LL, std::min<long long>(sms / kPhases, (tiles + kGroups - 1) / kGroups));
  gather_resident_kernel<kPhases, kTier, Bucket>
      <<<static_cast<int>(per_phase * kPhases), kBlockThreads, smem, st>>>(
          cheap, buckets, static_cast<const typename TierTypes<kTier>::Bank*>(filters), pbias,
          inv_scale, raw, h, w, n_buckets);
  return cudaGetLastError();
}

}  // namespace

// Launch A: A1 (the hash into `buckets`, [h, w] uint8 scratch) then A2 (the
// gather into `raw`). Host arrays k1d[11], qstr[n_qstr], qcoh[n_qcoh] are
// copied into A1's parameters. filters is [qangle*qstrength*qcoherence*phases,
// 128], 16-byte aligned: float32 (tier 0), bfloat16 (tiers 1 and 2) or int16
// (tier 3); phases is 4 or 1 for tiers 0 and 1, 4 for tiers 2 and 3; at most
// 256 buckets. pbias is the pcenter tier's float32 [rows] bias (tier 2, else
// unused), inv_scale the int8 tier's 1/scale (tier 3). Returns a cudaError_t
// value (0 on success).
extern "C" int raisr_full_hash_filter(
    const float* cheap, const void* filters, int tier, const float* pbias,
    float inv_scale, float* raw, uint8_t* buckets, int h, int w, int phases,
    const float* k1d, float nf, const float* qstr, int n_qstr, const float* qcoh,
    int n_qcoh, int qangle, int qstrength, int qcoherence, float angle_scale, int device,
    void* stream) {
  const bool four = phases == 4;
  const int n_buckets = qangle * qstrength * qcoherence;
  if (h <= 0 || w <= 0 || (phases != 1 && !four) || tier < 0 || tier > 3 ||
      (tier >= 2 && !four) || (tier == 2 && pbias == nullptr) || n_qstr < 0 ||
      n_qstr > kMaxEdges || n_qcoh < 0 || n_qcoh > kMaxEdges || qangle <= 0 ||
      qstrength <= 0 || qcoherence <= 0 || n_buckets > 256) {
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + kHashTile - 1) / kHashTile, (h + kHashTile - 1) / kHashTile);
  hash_bucket_kernel<<<grid, kHashThreads, 0, st>>>(cheap, buckets, h, w, hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  GatherLaunch<uint8_t> launch = nullptr;
  switch (static_cast<Tier>(tier)) {
    case Tier::kF32:
      launch = four ? &launch_gather<4, Tier::kF32, uint8_t> : &launch_gather<1, Tier::kF32, uint8_t>;
      break;
    case Tier::kBF16:
      launch = four ? &launch_gather<4, Tier::kBF16, uint8_t>
                    : &launch_gather<1, Tier::kBF16, uint8_t>;
      break;
    case Tier::kPCenter:
      launch = &launch_gather<4, Tier::kPCenter, uint8_t>;
      break;
    case Tier::kInt8:
      launch = &launch_gather<4, Tier::kInt8, uint8_t>;
      break;
  }
  return static_cast<int>(
      launch(cheap, buckets, filters, pbias, inv_scale, raw, h, w, n_buckets, device, st));
}

// Launch B: out = the pass epilogue of (cheap, raw), all [h, w] float32;
// blending 1 = Randomness, 2 = CountOfBitsChanged. Returns a cudaError_t
// value (0 on success).
extern "C" int raisr_full_epilogue(
    const float* cheap, const float* raw, float* out, int h, int w,
    float min_val, float max_val, int blending, int col_end, int frame_h,
    int frame_pad, int row0, int eff_h, int device, void* stream) {
  if (h <= 0 || w <= 0 || (blending != 1 && blending != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const EpilogueParams p{min_val, max_val, col_end, frame_h, frame_pad, row0, eff_h};
  const dim3 grid((w + kEpiCols - 1) / kEpiCols,
                  (h + kEpiWarps * kEpiRows - 1) / (kEpiWarps * kEpiRows));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte accesses need every row of every plane to start on 16 bytes
  const bool vec = w % kEpiVec == 0 &&
                   (reinterpret_cast<uintptr_t>(cheap) | reinterpret_cast<uintptr_t>(raw) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = blending == 2 ? (vec ? &epilogue_kernel<true, true> : &epilogue_kernel<true, false>)
                              : (vec ? &epilogue_kernel<false, true> : &epilogue_kernel<false, false>);
  kernel<<<grid, 32 * kEpiWarps, 0, st>>>(cheap, raw, out, h, w, p);
  return static_cast<int>(cudaGetLastError());
}

// The filter apply to given buckets: launch A2 over the caller's int32
// bucket plane [h, w]; a bucket outside [0, n_buckets) gives raw 0. filters
// is [n_buckets * phases, 128] float32, 16-byte aligned; phases is 4 or 1.
// The phase's n_buckets rows must fit in a block's shared memory beside the
// tile buffers (GatherSmem::bytes); if they do not, the launch fails and
// the error returns. Returns a cudaError_t value (0 on success).
extern "C" int raisr_filter_apply(const float* cheap, const int* buckets,
                                  const float* filters, float* raw, int h,
                                  int w, int phases, int n_buckets, int device,
                                  void* stream) {
  if (h <= 0 || w <= 0 || (phases != 1 && phases != 4) || n_buckets <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  GatherLaunch<int> launch =
      phases == 4 ? &launch_gather<4, Tier::kF32, int> : &launch_gather<1, Tier::kF32, int>;
  return static_cast<int>(launch(cheap, buckets, filters, nullptr, 1.0f, raw, h, w, n_buckets,
                                 device, static_cast<cudaStream_t>(stream)));
}
