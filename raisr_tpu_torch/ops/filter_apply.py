"""Per-pixel hashed-filter application (the RAISR core op).

Port of raisr_tpu/ops/filter_apply.py. For each output pixel, gather the learned 11x11 filter for (hash bucket, pixel phase) and dot
it with the centered 11x11 patch of the cheap-upscaled image (DotProdPatch_*,
reference: Raisr_AVX512.cpp:134-149, filter gather Raisr.cpp:1147-1160).

Two formulations, numerically identical up to fp reduction order:

  taps   accumulate over the 121 taps in order 0..120, the order the fused
         CUDA kernel (csrc/full_kernel.cu) uses; per tap a [num_filters]
         vector is gathered per pixel. Runs anywhere; the ground truth.

  conv   raisr_tpu's `xla` backend: patches against all 216 bucket filters
         of one pixel phase is a 216-channel 11x11 convolution (stride 2 per
         phase for ratio 2), followed by a select of each pixel's bucket
         channel: the data-dependent gather as a dense convolution at 216
         times the arithmetic. raisr_tpu computes it with lax.conv outside
         any Pallas kernel, so here it is torch.nn.functional.conv2d, in
         float32 with TF32 off around the call (raisr_tpu asks for
         Precision.HIGHEST). Row-chunked to bound the [216, rows, w]
         intermediate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def apply_filters_taps(
    cheap: torch.Tensor,
    filter_idx: torch.Tensor,
    filters: torch.Tensor,
    patch_size: int,
    pad_value: float = 0.0,
) -> torch.Tensor:
    """Reference formulation. cheap [H,W] f32 (or int64, with an int64 bank:
    then the sum is exact); filter_idx [H,W] int in [0, num_filters); filters
    [num_filters, aligned_taps]. Patch reads outside the plane give
    pad_value."""
    margin = patch_size // 2
    padded = F.pad(cheap, (margin, margin, margin, margin), value=pad_value)
    h, w = cheap.shape
    idx = filter_idx.to(torch.int64)
    acc = torch.zeros_like(cheap)
    for t in range(patch_size * patch_size):
        tap_map = filters[:, t][idx]
        i, j = divmod(t, patch_size)
        acc = acc + padded[i: i + h, j: j + w] * tap_map
    return acc


def _conv_all_buckets(padded_slice: torch.Tensor, kernels: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """Valid conv of [h, w] with kernels [216, p, p] -> [216, oh, ow]."""
    # TF32 keeps 10 bits of mantissa: on 8-bit pixels against 121 taps that
    # moves a large share of pixels by an LSB, so it is off for this call
    # only; the caller's setting is restored
    with torch.backends.cudnn.flags(allow_tf32=False):
        return F.conv2d(padded_slice[None, None], kernels[:, None], stride=stride)[0]


def _chunked_conv_select(
    padded: torch.Tensor,
    buckets: torch.Tensor,
    kernels: torch.Tensor,
    patch_size: int,
    stride: int,
    start: tuple[int, int],
    out_shape: tuple[int, int],
    chunk_rows: int,
) -> torch.Tensor:
    """Row-chunked (conv over all buckets) + select of each pixel's bucket.

    The [216, chunk, w] tensor of a chunk is consumed at once: a 128-row
    chunk of a 4K plane's stride-2 subgrid is ~212 MB, of a whole
    1620x2880 plane ~318 MB."""
    out_h, out_w = out_shape
    out = torch.empty((out_h, out_w), dtype=torch.float32, device=padded.device)
    slice_w = stride * (out_w - 1) + patch_size
    idx = buckets.to(torch.int64)
    for r in range(0, out_h, chunk_rows):
        rows = min(chunk_rows, out_h - r)
        top = start[0] + r * stride
        sl = padded[top: top + stride * (rows - 1) + patch_size,
                    start[1]: start[1] + slice_w]
        g = _conv_all_buckets(sl, kernels, stride)  # [216, rows, out_w]
        out[r: r + rows] = torch.gather(g, 0, idx[None, r: r + rows])[0]
    return out


def apply_filters_conv(
    cheap: torch.Tensor,
    buckets: torch.Tensor,
    filters: torch.Tensor,
    patch_size: int,
    pixel_types: int,
    patch_margin: int,
    ratio: int,
    chunk_rows: int = 128,
) -> torch.Tensor:
    """Dense-conv formulation. buckets [H,W] int in [0, 216);
    filters [216 * pixel_types, aligned]. Returns [H,W] f32.

    For pixel_types == 4 (ratio 2), output pixels of phase
    (pr, pc) = ((r - margin) % 2, (c - margin) % 2) form stride-2 subgrids;
    each phase contracts with its own 216-filter bank via a strided conv.
    """
    h, w = cheap.shape
    margin = patch_size // 2
    cheap = cheap.to(torch.float32)
    padded = F.pad(cheap, (margin, margin, margin, margin))
    num_buckets = filters.shape[0] // pixel_types
    # kernels[b, pt, i, j]
    kernels = filters[:, : patch_size * patch_size].to(torch.float32).reshape(
        num_buckets, pixel_types, patch_size, patch_size
    )

    if pixel_types == 1:
        return _chunked_conv_select(
            padded, buckets, kernels[:, 0].contiguous(), patch_size, 1, (0, 0),
            (h, w), chunk_rows,
        )

    if not pixel_types == ratio * ratio == 4:
        raise ValueError(
            f"the conv formulation takes 1 pixel type, or 4 at ratio 2; got "
            f"{pixel_types} at ratio {ratio}"
        )
    out = torch.empty((h, w), dtype=torch.float32, device=cheap.device)
    for r0 in range(2):
        pr = (r0 - patch_margin) % 2
        for c0 in range(2):
            pc = (c0 - patch_margin) % 2
            pt = pr * 2 + pc
            sub_h = (h - r0 + 1) // 2
            sub_w = (w - c0 + 1) // 2
            out[r0::2, c0::2] = _chunked_conv_select(
                padded, buckets[r0::2, c0::2], kernels[:, pt].contiguous(),
                patch_size, 2, (r0, c0), (sub_h, sub_w), chunk_rows,
            )
    return out
