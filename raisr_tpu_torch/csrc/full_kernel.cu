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
//   A1 (hash_bucket_kernel<kVec, kSym>): persistent blocks walk over 32x54
//     output tiles, each staged with a 6-pixel halo in shared memory (zero
//     outside the plane) while the block works on the one before; a block
//     builds the gradient products and the vertical then horizontal tensor
//     sums, hashes, and writes each pixel's bucket as one byte.
//   A2 (gather_resident_kernel<kPhases, kTier, Bucket>): persistent blocks,
//     each serving ONE pixel phase with that phase's bank rows resident in
//     shared memory, walk over tiles of same-phase pixels and write the raw
//     filter output (dot_rows of raisr_common.cuh), four pixels a thread,
//     each warp's lanes ordered by bucket. Bucket is uint8_t for A1's plane
//     and int for a caller's (apply_filters), which is range checked.
//   B (epilogue_kernel<kCobc, kVec, Out>): reject, zones, census blend and
//     rounding. Each pixel's HR value is formed once, on the way in; see the
//     note above the kernel. Out is float (the pass's float32 plane) or,
//     for the last pass of a batched step, uint8_t / uint16_t: the output
//     frames packed, guard rows left out.
//
// What bounds launch A on an H100, and what the design does about it. It
// moves few bytes (the plane in twice, a byte of bucket out and back, the
// raw plane out: ~116 MB a 4K plane, ~35 us at 3.35 TB/s) and does
// ~400 float operations a pixel, so neither bounds it. A2 waits on shared
// memory (one 128-byte wavefront per SM per clock); A1 on the issue of its
// instructions and the latency of the hash's IEEE divisions and square
// roots. Launch B moves 12 bytes a pixel (cheap and raw in, the pass out:
// ~100 MB a 4K plane, ~30 us; packed, 9 at 8 bits and 10 at 16, and no
// guard rows out) and is bound by them once its census reads come from
// registers:
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
//     so shared row s's group q sits in bank group (q - s) mod 8 (float32)
//     or (q + s) mod 8 (16 bits): a quarter's load takes as many wavefronts
//     as the most distinct rows it reads that agree mod 8. On the cells'
//     content the 8 lanes of a quarter in column order read ~6.4 distinct
//     rows, ~2.0 wavefronts a load (flk.gather_wavefronts counts it on a
//     bucket plane), whatever static layout of the rows (neighbouring
//     pixels' buckets co-occur nearly at random). So the rows are staged at
//     slots that put the buckets of one strength together, (strength *
//     qangle + angle) * qcoherence + coherence (bank_slot; a caller's int
//     buckets stay at their own index), and once a tile each warp sorts its
//     32 columns by the slot of one of its pixels (a bitonic sort over
//     shuffles) and lane L serves the L-th: a quarter then reads a run of
//     neighbouring slots, which fall in different bank groups. That pixel's
//     loads take ~1.64 wavefronts, the others' ~1.9, ~1.85 on average at 2x
//     (uniform random buckets: 2.52 -> 2.48). A row's relabelling changes no
//     value: each pixel still dots its own row, taps 0..120 in order.
//   - The patch: scalar shared-memory reads. A block serves one phase, so a
//     warp's lanes are same-phase pixels two columns apart; the staged tile
//     is stored split by column parity (two planes), so the lanes of any tap
//     read 32 consecutive words of one plane, in the sort's order:
//     conflict-free. A thread takes four same-phase pixels of one column,
//     one phase row apart, whose patches share rows, and reads each shared
//     value once: 187 reads for the four pixels at 2x (46.75 a pixel, 1.46
//     wavefronts), 154 at 1.5x, not 484.
//   - Together, ~8.8 wavefronts a 2x float32 pixel (7.2 for the row, 1.5
//     for the patch, ~0.2 for the staging) against ~10.2 with two pixels a
//     thread in column order; the dot's 242 operations issue in ~2.5
//     clocks a pixel an SM, so the wavefronts still bound A2.
//   - The hash is needed at every pixel, and its scratch (gradient products
//     and tensor sums, ~37 KB a 256-pixel tile) does not fit beside a float32
//     phase bank for more than two tiles in flight; a block serving one phase
//     would also build the gradient products of every pixel four times and
//     the vertical sums twice. So launch A is split: A1 hashes every pixel
//     once and hands A2 a byte a pixel (8.3 MB a 4K plane, written once and
//     read once).
//   - A1 is bound by the issue of its instructions, ~300 a pixel: ~120 for
//     the hash (three IEEE square roots and two divisions, each a range
//     check, a fast sequence and a branch around its slow path), ~100 for
//     the vertical sums (64 tensor-window columns for 54 output columns; a
//     segment builds 18 product rows for its 8 sums), ~63 for the
//     horizontal ones, a few for the copies. Integer, compare and select
//     instructions issue at half the rate of float ones on an H100, so the
//     hash counts for more than its length; a hash with its own range tests
//     in place of the branches, or two pixels a thread, measured slower.
//     The 32x54 tile and 256 threads keep every thread busy in each phase:
//     64 columns x 4 segments of 8 rows are the 256 vertical tasks, and 32
//     rows x 8 warps of 7 or 6 columns the horizontal ones; the hash takes
//     the tile's pixels in row-major order and writes each bucket to the
//     plane at once, coalesced. A tile whose window lies inside the plane
//     (96.5% of them on a 2x stack) runs with no bounds tests: no gradient
//     border rule and no zero padding can reach it; the others keep the
//     tests. The taps of the Gaussian are symmetric bit for bit, so a
//     product with tap t serves tap 10 - t as well (the same value, so
//     every sum still adds taps 0..10 in order); a non-symmetric k1d takes
//     the general form. The sums run down a column and along a row with
//     each product feeding the live sums of its taps, so few values stay
//     live: 48 registers, and with one staging buffer (37,632 bytes) five
//     blocks share an SM, where four (64 registers, two buffers) were
//     slower. A block copies its next tile's window with cp.async (16 bytes
//     a copy where every row of the plane starts on 16 bytes) once the
//     current window is read, during the rest of the tile.
//   - A2's blocks: 2 groups of 256 threads (512 threads, 86-125 registers),
//     one tile of 32 x 32 same-phase pixels a group at a time (a warp takes 4
//     rows); the groups sync on their own named barriers, so one group waits
//     while the other computes, and each group copies its next tile into a
//     second buffer with cp.async during the dot of the current one. One
//     block a SM, no more than the tiles need. The four buffers (86,432 bytes
//     at 2x) leave room for 294 float32 rows (411 single-phase).
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
#include <limits>

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

// -- cp.async ------------------------------------------------------------------

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

// -- A1: the hash ------------------------------------------------------------

// A1's tile: 32 x 54 output pixels, a block of 256 threads
constexpr int kHashRows = 32;
constexpr int kHashCols = 54;
constexpr int kHashThreads = 256;
// the staged cheap window reaches kHalo past the tile: the tensor window's 5
// and the gradient stencil's 1
constexpr int kHalo = kMargin + 1;              // 6
constexpr int kInRows = kHashRows + 2 * kHalo;  // 44
constexpr int kInCols = kHashCols + 2 * kHalo;  // 66
// a staged row: window column c at word off + c, where off (0..3) puts the
// plane's multiples of 4 columns on multiples of 4 words, so 16-byte copies
// land whole
constexpr int kInStride = 72;
constexpr int kInGroups = kInStride / 4;  // 18 groups of 16 bytes a row
constexpr int kInWords = kInRows * kInStride;
// the tensor window's columns around the tile: 64, one vertical task each
// for each segment of kSeg tile rows
constexpr int kVCols = kHashCols + 2 * kMargin;
constexpr int kSeg = 8;
// row stride of the vertical sums: odd, so 32 lanes on 32 rows read 32 banks
constexpr int kVStride = kVCols + 1;  // 65
// horizontal sums: warp g takes tile columns 7g .. 7g+6 (g < 6) or
// 42 + 6(g-6) .. +5 (g = 6, 7), all 32 rows a lane each
constexpr int kRunLong = 7;
constexpr int kLongWarps = 6;
constexpr int kRunShort = 6;
// the tensor (a, b, d) of every tile pixel, stored over the vertical sums
// once they are read: row stride odd, so the lanes on 32 rows write 32 banks
constexpr int kTStride = kHashCols + 1;  // 55
constexpr int kTWords = kHashRows * kTStride;
// dynamic shared memory: the staged window, then the vertical sums
constexpr int kHashSmemBytes = (kInWords + 3 * kHashRows * kVStride) * 4;  // 37,632
static_assert(kVCols * (kHashRows / kSeg) == kHashThreads, "one vertical task a thread");
static_assert(kLongWarps * kRunLong + (kHashThreads / 32 - kLongWarps) * kRunShort == kHashCols,
              "the warps' runs cover the tile's columns");
static_assert(kInStride % 4 == 0 && kInStride >= kInCols + 3, "room for the 16-byte shift");
static_assert(3 * kTWords <= 3 * kHashRows * kVStride, "the tensor fits over the vertical sums");

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
  // the operands of the branch taken, then one division
  const float num = neg_x ? x + abs_y : x - abs_y;
  const float den = neg_x ? abs_y - x : x + abs_y;
  const float r = num / den;
  float angle = neg_x ? kThreeQuarterPi : kQuarterPi;
  angle = angle + (0.1963f * r * r - 0.9817f) * r;
  return y < 0.0f ? -angle : angle;
}

// A pixel's bucket from its tensor (a, b, d). The edges are counted over
// kEdges of them: the host pads qstr and qcoh past n_qstr and n_qcoh with
// NaN, which no value reaches, so kEdges may be any count >= n; the launch
// takes 2, the usual 3 x 3 grid's, where it can, so that the counts are a
// few comparisons and no branch.
template <int kEdges>
__device__ __forceinline__ int hash_bucket(float a, float b, float d, const HashParams& hp) {
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
  int ci = 0;
#pragma unroll
  for (int e = 0; e < kEdges; ++e) {
    si += hp.qstr[e] <= l1 ? 1 : 0;
    ci += hp.qcoh[e] <= coh ? 1 : 0;
  }
  return ai * (hp.qstrength * hp.qcoherence) + si * hp.qcoherence + ci;
}

// A tile is interior when its staged window lies inside the plane: then
// every gradient it builds is off the border rows and columns (where gx or
// gy is zero) and inside the plane (where the products are not zero), and
// every output pixel is in the plane. ops/cuda/filter_kernel.py
// hash_tile_counts counts the same tiles.
__device__ __forceinline__ bool hash_interior(int y0, int x0, int h, int w) {
  return y0 >= kHalo && x0 >= kHalo && y0 + kHashRows + kHalo <= h &&
         x0 + kHashCols + kHalo <= w;
}

// Copies tile (y0, x0)'s window into `dst` with cp.async: window row i,
// column c (plane row y0 - 6 + i, column x0 - 6 + c) to word
// i * kInStride + off + c, zero outside the plane. An interior tile on a
// plane whose rows all start on 16 bytes (kVec) copies the 16-byte groups
// that hold its window, a superset of it; any other tile, word by word.
template <bool kVec>
__device__ __forceinline__ void hash_stage(const float* __restrict__ cheap, float* dst, int y0,
                                           int x0, int off, bool interior, int h, int w) {
  const int top = y0 - kHalo;
  if (kVec && interior) {
    const int groups = (off + kInCols + 3) / 4;  // 17 or 18
    const float* src = cheap + static_cast<size_t>(top) * w + (x0 - kHalo - off);
    for (unsigned k = threadIdx.x; k < kInRows * kInGroups; k += kHashThreads) {
      const int i = static_cast<int>(k / kInGroups);
      const int g = static_cast<int>(k % kInGroups);
      if (g < groups) {
        cp_async16(dst + i * kInStride + 4 * g, src + static_cast<size_t>(i) * w + 4 * g);
      }
    }
  } else {
    for (unsigned k = threadIdx.x; k < kInRows * kInCols; k += kHashThreads) {
      const int i = static_cast<int>(k / kInCols);
      const int c = static_cast<int>(k % kInCols);
      const int gr = top + i;
      const int gc = x0 - kHalo + c;
      const bool valid = interior || (gr >= 0 && gr < h && gc >= 0 && gc < w);
      cp_async4_zfill(dst + i * kInStride + off + c,
                      valid ? cheap + static_cast<size_t>(gr) * w + gc : cheap, valid);
    }
  }
}

// The vertical tensor sums of tensor-window column j (plane column
// x0 - 5 + j), tile rows kSeg*s .. kSeg*s + 7, into s_v. `img` is the
// tile's window from its word `off`. Product row i (plane row
// y0 - 5 + kSeg*s + i) feeds the sums of tile rows kSeg*s + i - 10 ..
// kSeg*s + i as their tap i - o, so every sum still adds its taps in order
// 0..10 while only the 3 x 8 sums stay live. kEdge: the gradients are zero
// on the plane's border rows (gx) and columns (gy), and the products zero
// outside the plane; an interior tile tests nothing. kSym (k1d[t] ==
// k1d[10-t] bit for bit): a product with tap t serves tap 10 - t too.
template <bool kEdge, bool kSym>
__device__ __forceinline__ void hash_vertical(const float* img, float* s_v, int j, int s,
                                              int y0, int x0, int h, int w,
                                              const HashParams& hp) {
  const float* p0 = img + (kSeg * s + 1) * kInStride + j + 1;
  const int gc = x0 - kMargin + j;
  const bool col_in = gc >= 0 && gc < w;
  const bool gy_in = gc >= 1 && gc <= w - 2;
  float acc[3][kSeg];
#pragma unroll
  for (int i = 0; i < kSeg + kPatch - 1; ++i) {
    const float* p = p0 + i * kInStride;
    float gx = p[kInStride] - p[-kInStride];
    float gy = p[1] - p[-1];
    if (kEdge) {
      const int gr = y0 - kMargin + kSeg * s + i;
      const bool in = col_in && gr >= 0 && gr < h;
      gx = in && gr >= 1 && gr <= h - 2 ? gx : 0.0f;
      gy = in && gy_in ? gy : 0.0f;
    }
    const float pm[3] = {gx * gx, gx * gy, gy * gy};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float q[kPatch];  // pm[m] * k1d[t]; the compiler keeps the ones used
#pragma unroll
      for (int t = 0; t < kPatch; ++t) {
        q[t] = kSym && t > kMargin ? q[kPatch - 1 - t] : pm[m] * hp.k1d[t];
      }
#pragma unroll
      for (int o = 0; o < kSeg; ++o) {
        const int t = i - o;
        if (t < 0 || t >= kPatch) continue;
        acc[m][o] = t == 0 ? q[0] : acc[m][o] + q[t];
        if (t == kPatch - 1) s_v[(m * kHashRows + kSeg * s + o) * kVStride + j] = acc[m][o];
      }
    }
  }
}

// Tile row `row`, columns c0 .. c0 + kR - 1: the horizontal sums over the
// vertical ones (vertical column c0 + q is tap q - e of column c0 + e), then
// * nf, into st[e][0..2].
template <int kR, bool kSym>
__device__ __forceinline__ void hash_sums(const float* s_v, int row, int c0,
                                          float (&st)[kRunLong][3], const HashParams& hp) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float* v = s_v + (m * kHashRows + row) * kVStride + c0;
#pragma unroll
    for (int qq = 0; qq < kR + kPatch - 1; ++qq) {
      const float x = v[qq];
      float q[kPatch];
#pragma unroll
      for (int t = 0; t < kPatch; ++t) {
        q[t] = kSym && t > kMargin ? q[kPatch - 1 - t] : x * hp.k1d[t];
      }
#pragma unroll
      for (int e = 0; e < kR; ++e) {
        const int t = qq - e;
        if (t < 0 || t >= kPatch) continue;
        st[e][m] = t == 0 ? q[0] : st[e][m] + q[t];
      }
    }
#pragma unroll
    for (int e = 0; e < kR; ++e) st[e][m] = st[e][m] * hp.nf;
  }
}

// Every pixel's bucket, one byte each (the wrapper holds the bucket count
// at 256 or below). Persistent: block b takes tiles b, b + gridDim.x, ...
// (row-major over the plane's 32 x 54 tiles); once a tile's vertical sums
// are built its window is free, and the block copies the next tile's window
// into it with cp.async during the rest of the tile (one buffer, so that
// five blocks fit on an SM). A tile is three phases, every thread busy in
// each: the 256 vertical tasks (64 columns x 4 segments of 8 rows); the
// horizontal sums (a lane a row, a warp 7 or 6 columns), whose tensor goes
// to shared memory; the hash, a pixel a thread at a time in row-major
// order, each bucket written to the plane at once (a warp writes 32
// consecutive bytes). Every sum keeps the plain version's order of taps. kVec: every row of the
// plane starts on 16 bytes (w % 4 == 0, an aligned plane), so interior
// tiles stage in 16-byte copies; kSym: the host found k1d symmetric bit for
// bit; kEdges: the edges hash_bucket counts.
template <bool kVec, bool kSym, int kEdges>
__global__ void __launch_bounds__(kHashThreads, 5)
hash_bucket_kernel(const float* __restrict__ cheap, uint8_t* __restrict__ buckets,
                   int h, int w, HashParams hp) {
  extern __shared__ __align__(16) float hash_smem[];
  float* s_v = hash_smem + kInWords;
  float* s_t = s_v;  // [3][kHashRows][kTStride], once s_v is read
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles_x = (w + kHashCols - 1) / kHashCols;
  const int n_tiles = tiles_x * ((h + kHashRows - 1) / kHashRows);

  auto stage = [&](int t) {
    const int y0 = t / tiles_x * kHashRows;
    const int x0 = t % tiles_x * kHashCols;
    hash_stage<kVec>(cheap, hash_smem, y0, x0, (x0 - kHalo) & 3, hash_interior(y0, x0, h, w),
                     h, w);
  };
  if (blockIdx.x < n_tiles) stage(blockIdx.x);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t is staged; the last tile's hash is done with s_t

    const int y0 = t / tiles_x * kHashRows;
    const int x0 = t % tiles_x * kHashCols;
    const bool interior = hash_interior(y0, x0, h, w);  // the same for the whole block
    const float* img = hash_smem + ((x0 - kHalo) & 3);
    if (interior) {
      hash_vertical<false, kSym>(img, s_v, tid % kVCols, tid / kVCols, y0, x0, h, w, hp);
    } else {
      hash_vertical<true, kSym>(img, s_v, tid % kVCols, tid / kVCols, y0, x0, h, w, hp);
    }
    __syncthreads();  // the vertical sums are built, and the window is read
    if (t + gridDim.x < n_tiles) stage(t + gridDim.x);  // in flight during the rest of tile t
    asm volatile("cp.async.commit_group;\n" ::);

    const int row = tid % 32;
    const bool long_run = warp < kLongWarps;
    const int c0 = long_run ? kRunLong * warp
                            : kRunLong * kLongWarps + kRunShort * (warp - kLongWarps);
    float st[kRunLong][3];
    if (long_run) {
      hash_sums<kRunLong, kSym>(s_v, row, c0, st, hp);
    } else {
      hash_sums<kRunShort, kSym>(s_v, row, c0, st, hp);
    }
    __syncthreads();  // every vertical sum is read
#pragma unroll
    for (int e = 0; e < kRunLong; ++e) {
      if (e >= kRunShort && !long_run) continue;
#pragma unroll
      for (int m = 0; m < 3; ++m) s_t[m * kTWords + row * kTStride + c0 + e] = st[e][m];
    }
    __syncthreads();  // the tile's tensor is stored

    // the tile's pixels in row-major order: consecutive lanes read
    // consecutive words and write consecutive bytes
    uint8_t* const out = buckets + static_cast<size_t>(y0) * w + x0;
#pragma unroll 1
    for (unsigned k = tid; k < kHashRows * kHashCols; k += kHashThreads) {
      const int r = static_cast<int>(k / kHashCols);
      const int c = static_cast<int>(k % kHashCols);
      const float* v = s_t + r * kTStride + c;
      const int bucket = hash_bucket<kEdges>(v[0], v[kTWords], v[2 * kTWords], hp);
      if (interior || (y0 + r < h && x0 + c < w)) out[r * w + c] = static_cast<uint8_t>(bucket);
    }
  }
}

// -- A2: the gather with the bank resident in shared memory ------------------

constexpr int kGroupThreads = 256;                        // 8 warps
constexpr int kGroups = 2;                                // tile groups a block
constexpr int kBlockThreads = kGroups * kGroupThreads;    // 512
constexpr int kPix = 4;                                   // pixels a thread, one column
constexpr int kTileRows = kPix * kGroupThreads / 32;      // same-phase rows a tile: 32
constexpr int kTileCols = 32;                             // same-phase columns: a lane each
constexpr int kSortPixel = 1;  // the pixel of a thread whose bank row orders the warp's lanes

// A tile of 32 x 32 same-phase pixels, kStep (2 for 4 phases, 1 for 1)
// rows and columns apart, and its staged patch region: the rows and columns
// its patches cover, stored as kStep planes by column parity, so that
// region column x is word x / kStep of plane x % kStep.
template <int kStep>
struct TileShape {
  static constexpr int kRows = kStep * (kTileRows - 1) + kPatch;   // 73 or 42
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

// A bucket's row in shared memory, its slot: the hash's buckets
// (angle * qstrength + strength) * qcoherence + coherence are laid out as
// (strength * qangle + angle) * qcoherence + coherence, so the buckets of
// one strength, whose angles and coherences neighbouring pixels share, lie
// together; see the header.
__device__ __forceinline__ int bank_slot(int bucket, int qangle, int qstrength, int qcoherence) {
  const int angle = bucket / (qstrength * qcoherence);
  const int strength = bucket / qcoherence % qstrength;
  return (strength * qangle + angle) * qcoherence + bucket % qcoherence;
}

// A2's dynamic shared memory: the phase's rows (by slot), the pcenter bias
// (by slot), the slot of each bucket (uint8_t buckets: the hash's grid,
// at most 256 buckets; a caller's int buckets are their own slots), then
// two tile buffers a group
template <int kPhases, Tier kTier, typename Bucket>
struct GatherSmem {
  using TF = typename TierTypes<kTier>::Bank;
  static constexpr int kStep = kPhases == 4 ? 2 : 1;
  static constexpr bool kSlots = std::is_same<Bucket, uint8_t>::value;
  __host__ __device__ static size_t bias_offset(int n_buckets) {
    return static_cast<size_t>(n_buckets) * kSmemRowBytes<TF>;
  }
  __host__ __device__ static size_t slots_offset(int n_buckets) {
    const size_t bias = kTier == Tier::kPCenter ? ((n_buckets * 4 + 15) / 16) * 16 : 0;
    return bias_offset(n_buckets) + bias;
  }
  __host__ __device__ static size_t tiles_offset(int n_buckets) {
    return slots_offset(n_buckets) + (kSlots ? 256 : 0);
  }
  __host__ __device__ static size_t bytes(int n_buckets) {
    return tiles_offset(n_buckets) +
           static_cast<size_t>(2 * kGroups) * TileShape<kStep>::kWords * 4;
  }
};

// a barrier of one group's 256 threads (ids 1..kGroups; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kGroupThreads) : "memory");
}

// The warp's 32 values in ascending order, lane i holding the i-th
// (a bitonic sort over shuffles: 15 compare-exchange steps)
__device__ __forceinline__ int warp_sort(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(0xffffffffu, v, j);
      v = ((lane & j) == 0) == ((lane & k) == 0) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// Persistent: block b serves phase b % kPhases. It stages that phase's rows
// (bucket * kPhases + phase) once, each at its bucket's slot, then each of
// its groups walks over the phase's tiles, kGroups * (gridDim.x / kPhases)
// tiles apart. A warp takes 4 same-phase rows of a tile; once a tile, it
// sorts its 32 columns by the slot of pixel kSortPixel's bucket, and lane L
// serves the L-th column of that order (its buckets, its patch, its raw
// stores). qangle, qstrength and qcoherence are the hash's grid (uint8_t
// buckets); pbias (kPCenter) is the bank's per-row bias, inv_scale (kInt8)
// its 1/scale; the other tiers ignore them. Bucket is the element of the
// bucket plane: uint8_t, A1's, every value a row of the bank; int, a
// caller's, its own slot, where a value outside [0, n_buckets) gives raw 0
// (its dot runs over row 0 and is dropped, so no address outside the staged
// rows is formed).
template <int kPhases, Tier kTier, typename Bucket>
__global__ void __launch_bounds__(kBlockThreads, 1)
gather_resident_kernel(const float* __restrict__ cheap,
                       const Bucket* __restrict__ buckets,
                       const typename TierTypes<kTier>::Bank* __restrict__ filters,
                       const float* __restrict__ pbias, float inv_scale,
                       float* __restrict__ raw, int h, int w, int n_buckets,
                       int qangle, int qstrength, int qcoherence) {
  using TF = typename TierTypes<kTier>::Bank;
  using TP = typename Taps<TF>::Acc;
  using Smem = GatherSmem<kPhases, kTier, Bucket>;
  constexpr int kStep = kPhases == 4 ? 2 : 1;
  using Shape = TileShape<kStep>;
  constexpr int kRowBytes = kSmemRowBytes<TF>;
  constexpr bool kChecked = !Smem::kSlots;

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
  float* s_bias = reinterpret_cast<float*>(smem + Smem::bias_offset(n_buckets));
  unsigned char* s_slot = smem + Smem::slots_offset(n_buckets);
  TP* s_tiles = reinterpret_cast<TP*>(smem + Smem::tiles_offset(n_buckets)) +
                2 * group * Shape::kWords;
  auto slot_of = [&](int b) {
    if constexpr (Smem::kSlots) {
      return bank_slot(b, qangle, qstrength, qcoherence);
    } else {
      return b;
    }
  };

  // stage the phase's rows: global row bucket * kPhases + phase (128 taps)
  // to shared row slot(bucket) (kRowBytes apart), 16 bytes a copy
  {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(filters);
    constexpr int kG = kRowGroups<TF>;
    for (int i = threadIdx.x; i < n_buckets * kG; i += kBlockThreads) {
      const int b = i / kG;
      const int q = i % kG;
      cp_async16(s_bank + static_cast<size_t>(slot_of(b)) * kRowBytes + 16 * q,
                 src + (static_cast<size_t>(b) * kPhases + phase) * kFilterStride * sizeof(TF) +
                     16 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int b = threadIdx.x; b < n_buckets; b += kBlockThreads) {
      if constexpr (kTier == Tier::kPCenter) s_bias[slot_of(b)] = pbias[b * kPhases + phase];
      if constexpr (Smem::kSlots) s_slot[b] = static_cast<unsigned char>(slot_of(b));
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
  auto region_word = [&](int e) {
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
        cp_async4_zfill(dst + region_word(e),
                        valid ? cheap + static_cast<size_t>(gr) * w + gc : cheap, valid);
      }
    }
  };

  if (first < n_tiles) issue(first, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  int buf = 0;
  for (int t = first; t < n_tiles; t += stride, buf ^= 1) {
    // the warp's pixels: same-phase rows kPix * warp .. +kPix-1 of the
    // tile; this lane's column until the sort, then the column it serves
    const int r = r0 + kStep * (kTileRows * (t / tiles_c) + kPix * warp);
    const int tile_c = c0 + kStep * kTileCols * (t % tiles_c);
    int slot[kPix];
    unsigned held = 0;  // bit p: pixel p's bucket is a row of the bank
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const bool inside = r + kStep * p < h && tile_c + kStep * lane < w;
      int b = inside ? buckets[static_cast<size_t>(r + kStep * p) * w + tile_c + kStep * lane] : 0;
      if constexpr (kChecked) {
        const bool in_bank = b >= 0 && b < n_buckets;
        held |= static_cast<unsigned>(in_bank) << p;
        b = in_bank ? b : 0;
      }
      slot[p] = b;
    }

    group_sync(group);  // the group's dot of the previous tile is done with buffer buf ^ 1
    if (t + stride < n_tiles) issue(t + stride, buf ^ 1);  // in flight during this dot
    asm volatile("cp.async.commit_group;\n" ::);

    // the lanes in order of pixel kSortPixel's slot, so that a quarter-warp
    // reads neighbouring slots, which lie in different bank groups
    if constexpr (Smem::kSlots) {
#pragma unroll
      for (int p = 0; p < kPix; ++p) slot[p] = s_slot[slot[p]];
    }
    const int src = warp_sort(slot[kSortPixel] * 32 + lane, lane) & 31;
#pragma unroll
    for (int p = 0; p < kPix; ++p) slot[p] = __shfl_sync(0xffffffffu, slot[p], src);
    if constexpr (kChecked) held = __shfl_sync(0xffffffffu, held, src);
    const int c = tile_c + kStep * src;

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

    const TP* base = s_tile + kStep * kPix * warp * Shape::kRowStride + src;
    float v[kPix];
    dot_rows<TF, kPix, kStep>(
        v,
        [&](int p, int q) {
          return reinterpret_cast<const uint4*>(s_bank + slot[p] * kRowBytes)[q];
        },
        [&](int rho, int dx) {
          return base[rho * Shape::kRowStride + (dx % kStep) * Shape::kPlaneW + dx / kStep];
        });
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (r + kStep * p >= h || c >= w) continue;
      if constexpr (kTier == Tier::kPCenter) v[p] = v[p] + s_bias[slot[p]];
      if constexpr (kTier == Tier::kInt8) v[p] = v[p] * inv_scale;
      if constexpr (kChecked) v[p] = (held >> p) & 1 ? v[p] : 0.0f;
      raw[static_cast<size_t>(r + kStep * p) * w + c] = v[p];
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
//     and one store; where the row pitch or a pointer is not a multiple of
//     the access (kVec false) the same code moves them one by one;
//   - the store is the only thing Out changes. float writes the whole plane
//     (16 bytes a thread), which the next pass reads with its guard rows.
//     uint8_t and uint16_t write the output frames packed, as pack_planes
//     packs them, 4 or 8 bytes a thread (a warp 128 or 256 contiguous
//     bytes): 9 bytes a pixel at 8 bits, 10 at 16, against 12. Rows that
//     frame_row maps into the guard band are not written, and frame k's rows
//     land at output rows k * frame_h ..: the stack's [N, frame_h, w]
//     frames (a whole stack, row0 0), which PyTorch no longer reads back
//     as float32 to pack;
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
template <bool kCobc, bool kVec, typename Out>
__global__ void __launch_bounds__(32 * kEpiWarps, kVec ? 4 : 3)
epilogue_kernel(const float* __restrict__ cheap, const float* __restrict__ raw,
                Out* __restrict__ out, int h, int w, EpilogueParams p) {
  constexpr bool kPacked = !std::is_same<Out, float>::value;
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
  // packed (row0 0): the frame row of the row written next, and the output
  // row of its frame's row 0 (negative above frame 0)
  [[maybe_unused]] int wfr = 0, wbase = 0;
  if constexpr (kPacked) {
    wfr = frame_row(r0, p);
    if (p.frame_h > 0) wbase = (r0 - p.frame_pad - wfr) / period * p.frame_h;
  }
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
    if constexpr (kPacked) {
      if (p.frame_h <= 0 || wfr < p.frame_h) {
        store4(out + static_cast<size_t>(wbase + wfr) * w, c0, w, kVec, o);
      }
      if (++wfr == period && p.frame_h > 0) {
        wfr = 0;
        wbase += p.frame_h;
      }
    } else {
      store4(out + static_cast<size_t>(r) * w, c0, w, kVec, o);
    }
  }
}

// -- launches ------------------------------------------------------------------

template <typename Bucket>
using GatherLaunch = cudaError_t (*)(const float*, const Bucket*, const void*, const float*,
                                     float, float*, int, int, int, int, int, int, int,
                                     cudaStream_t);

// Launch A2: one persistent block a SM (a block of 512 threads and its
// shared memory fill a SM), a whole multiple of kPhases, and no more than
// the tiles of a phase need. A block that cannot get its shared memory fails
// cudaFuncSetAttribute or the launch, and the error returns.
template <int kPhases, Tier kTier, typename Bucket>
cudaError_t launch_gather(const float* cheap, const Bucket* buckets, const void* filters,
                          const float* pbias, float inv_scale, float* raw, int h, int w,
                          int n_buckets, int qangle, int qstrength, int qcoherence, int device,
                          cudaStream_t st) {
  constexpr int kStep = kPhases == 4 ? 2 : 1;
  const size_t smem = GatherSmem<kPhases, kTier, Bucket>::bytes(n_buckets);
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
          inv_scale, raw, h, w, n_buckets, qangle, qstrength, qcoherence);
  return cudaGetLastError();
}

// The hash launch's parameters from the host arrays k1d[11], qstr[n_qstr],
// qcoh[n_qcoh]; false (and nothing filled) where the kernel cannot take
// them: more than kMaxEdges edges, an empty grid of buckets, more than 256
// buckets (a pixel's bucket leaves A1 as one byte).
bool hash_params(const float* k1d, float nf, const float* qstr, int n_qstr,
                 const float* qcoh, int n_qcoh, int qangle, int qstrength, int qcoherence,
                 float angle_scale, HashParams* hp) {
  if (n_qstr < 0 || n_qstr > kMaxEdges || n_qcoh < 0 || n_qcoh > kMaxEdges || qangle <= 0 ||
      qstrength <= 0 || qcoherence <= 0 || qangle * qstrength * qcoherence > 256) {
    return false;
  }
  std::memset(hp, 0, sizeof(*hp));
  std::memcpy(hp->k1d, k1d, sizeof(hp->k1d));
  hp->nf = nf;
  std::memcpy(hp->qstr, qstr, sizeof(float) * n_qstr);
  std::memcpy(hp->qcoh, qcoh, sizeof(float) * n_qcoh);
  hp->n_qstr = n_qstr;
  hp->n_qcoh = n_qcoh;
  hp->qangle = qangle;
  hp->qstrength = qstrength;
  hp->qcoherence = qcoherence;
  hp->angle_scale = angle_scale;
  // NaN, which no value reaches, for the edges hash_bucket counts past n
  std::fill(hp->qstr + n_qstr, hp->qstr + kMaxEdges, std::numeric_limits<float>::quiet_NaN());
  std::fill(hp->qcoh + n_qcoh, hp->qcoh + kMaxEdges, std::numeric_limits<float>::quiet_NaN());
  return true;
}

// Launch A1: one persistent block per place the card has for one (five a
// SM at 48 registers and 37,632 bytes), no more than the tiles. The form is
// chosen from the input: 16-byte staging where every row of the plane starts
// on 16 bytes, the shared products where the taps are symmetric bit for bit,
// two edge comparisons where the bank has at most two edges of each kind.
cudaError_t launch_hash(const float* cheap, uint8_t* buckets, int h, int w,
                        const HashParams& hp, int device, cudaStream_t st) {
  bool sym = true;
  for (int t = 0; t < kMargin; ++t) {
    sym = sym && std::memcmp(&hp.k1d[t], &hp.k1d[kPatch - 1 - t], sizeof(float)) == 0;
  }
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(cheap) % 16 == 0;
  const bool few = hp.n_qstr <= 2 && hp.n_qcoh <= 2;
  using Kernel = void (*)(const float*, uint8_t*, int, int, HashParams);
  // [vec][sym][few]
  static const Kernel kForms[2][2][2] = {
      {{&hash_bucket_kernel<false, false, kMaxEdges>, &hash_bucket_kernel<false, false, 2>},
       {&hash_bucket_kernel<false, true, kMaxEdges>, &hash_bucket_kernel<false, true, 2>}},
      {{&hash_bucket_kernel<true, false, kMaxEdges>, &hash_bucket_kernel<true, false, 2>},
       {&hash_bucket_kernel<true, true, kMaxEdges>, &hash_bucket_kernel<true, true, 2>}}};
  const Kernel kernel = kForms[vec][sym][few];
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kHashSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHashThreads,
                                                      kHashSmemBytes);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>((w + kHashCols - 1) / kHashCols) *
                          ((h + kHashRows - 1) / kHashRows);
  const long long blocks =
      std::max(1LL, std::min<long long>(tiles, static_cast<long long>(sms) * std::max(per_sm, 1)));
  kernel<<<static_cast<int>(blocks), kHashThreads, kHashSmemBytes, st>>>(cheap, buckets, h, w, hp);
  return cudaGetLastError();
}

// A2's form for a tier code (0 float32, 1 bfloat16, 2 pcenter, 3 int8) over
// the hash's uint8 buckets; the caller has checked the code and the phases
GatherLaunch<uint8_t> tier_gather(int tier, bool four) {
  switch (static_cast<Tier>(tier)) {
    case Tier::kBF16:
      return four ? &launch_gather<4, Tier::kBF16, uint8_t> : &launch_gather<1, Tier::kBF16, uint8_t>;
    case Tier::kPCenter:
      return &launch_gather<4, Tier::kPCenter, uint8_t>;
    case Tier::kInt8:
      return &launch_gather<4, Tier::kInt8, uint8_t>;
    default:
      return four ? &launch_gather<4, Tier::kF32, uint8_t> : &launch_gather<1, Tier::kF32, uint8_t>;
  }
}

// Launch B over one output form: the 4-pixel accesses where every row of
// every plane starts on one (16 bytes in; 4 * sizeof(Out) out).
template <typename Out>
cudaError_t launch_epilogue(const float* cheap, const float* raw, Out* out, int h, int w,
                            int blending, const EpilogueParams& p, cudaStream_t st) {
  const dim3 grid((w + kEpiCols - 1) / kEpiCols,
                  (h + kEpiWarps * kEpiRows - 1) / (kEpiWarps * kEpiRows));
  const uintptr_t in = reinterpret_cast<uintptr_t>(cheap) | reinterpret_cast<uintptr_t>(raw);
  const bool vec = w % kEpiVec == 0 && in % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(Quad<Out>) == 0;
  auto kernel = blending == 2 ? (vec ? &epilogue_kernel<true, true, Out>
                                     : &epilogue_kernel<true, false, Out>)
                              : (vec ? &epilogue_kernel<false, true, Out>
                                     : &epilogue_kernel<false, false, Out>);
  kernel<<<grid, 32 * kEpiWarps, 0, st>>>(cheap, raw, out, h, w, p);
  return cudaGetLastError();
}

}  // namespace

// Launch A1 alone: every pixel's bucket of the [h, w] float32 plane `cheap`
// into `buckets` ([h, w] uint8), as the fused pass computes it. Host arrays
// k1d[11], qstr[n_qstr], qcoh[n_qcoh]; at most 256 buckets. Returns a
// cudaError_t value (0 on success).
extern "C" int raisr_hash_buckets(const float* cheap, uint8_t* buckets, int h, int w,
                                  const float* k1d, float nf, const float* qstr, int n_qstr,
                                  const float* qcoh, int n_qcoh, int qangle, int qstrength,
                                  int qcoherence, float angle_scale, int device, void* stream) {
  HashParams hp;
  if (h <= 0 || w <= 0 ||
      !hash_params(k1d, nf, qstr, n_qstr, qcoh, n_qcoh, qangle, qstrength, qcoherence,
                   angle_scale, &hp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  return static_cast<int>(
      launch_hash(cheap, buckets, h, w, hp, device, static_cast<cudaStream_t>(stream)));
}

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
  HashParams hp;
  if (h <= 0 || w <= 0 || (phases != 1 && !four) || tier < 0 || tier > 3 ||
      (tier >= 2 && !four) || (tier == 2 && pbias == nullptr) ||
      !hash_params(k1d, nf, qstr, n_qstr, qcoh, n_qcoh, qangle, qstrength, qcoherence,
                   angle_scale, &hp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_hash(cheap, buckets, h, w, hp, device, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tier_gather(tier, four)(cheap, buckets, filters, pbias, inv_scale, raw,
                                                  h, w, n_buckets, qangle, qstrength,
                                                  qcoherence, device, st));
}

// Launch A2 alone over a uint8 bucket plane [h, w], as launch A hands it
// over from A1: every value must be a row of the bank (below
// qangle*qstrength*qcoherence, at most 256). filters, tier, pbias,
// inv_scale and phases as for raisr_full_hash_filter. Returns a cudaError_t
// value (0 on success).
extern "C" int raisr_gather_buckets(const float* cheap, const uint8_t* buckets,
                                    const void* filters, int tier, const float* pbias,
                                    float inv_scale, float* raw, int h, int w, int phases,
                                    int qangle, int qstrength, int qcoherence, int device,
                                    void* stream) {
  const bool four = phases == 4;
  if (h <= 0 || w <= 0 || (phases != 1 && !four) || tier < 0 || tier > 3 ||
      (tier >= 2 && !four) || (tier == 2 && pbias == nullptr) || qangle <= 0 ||
      qstrength <= 0 || qcoherence <= 0 || qangle * qstrength * qcoherence > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  return static_cast<int>(tier_gather(tier, four)(
      cheap, buckets, filters, pbias, inv_scale, raw, h, w, qangle * qstrength * qcoherence,
      qangle, qstrength, qcoherence, device, static_cast<cudaStream_t>(stream)));
}

// Launch B: out = the pass epilogue of (cheap, raw), both [h, w] float32;
// blending 1 = Randomness, 2 = CountOfBitsChanged. out_form 0 writes out as
// the [h, w] float32 plane; 1 (uint8) and 2 (uint16) write the output
// frames packed, the guard rows of a frame stack left out: [h / (frame_h +
// 2 * frame_pad) * frame_h, w], or [h, w] with frame_h 0; they take a whole
// stack and row0 0. Returns a cudaError_t value (0 on success).
extern "C" int raisr_full_epilogue(
    const float* cheap, const float* raw, void* out, int h, int w,
    float min_val, float max_val, int blending, int col_end, int frame_h,
    int frame_pad, int row0, int eff_h, int out_form, int device, void* stream) {
  const int period = frame_h + 2 * frame_pad;
  if (h <= 0 || w <= 0 || (blending != 1 && blending != 2) || out_form < 0 || out_form > 2 ||
      (out_form != 0 && (row0 != 0 || (frame_h > 0 && h % period != 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const EpilogueParams p{min_val, max_val, col_end, frame_h, frame_pad, row0, eff_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_form) {
    case 1:
      return static_cast<int>(
          launch_epilogue(cheap, raw, static_cast<uint8_t*>(out), h, w, blending, p, st));
    case 2:
      return static_cast<int>(
          launch_epilogue(cheap, raw, static_cast<uint16_t*>(out), h, w, blending, p, st));
    default:
      return static_cast<int>(
          launch_epilogue(cheap, raw, static_cast<float*>(out), h, w, blending, p, st));
  }
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
                                 n_buckets, 1, 1, device, static_cast<cudaStream_t>(stream)));
}
