"""Per-pixel hashed-filter application (the RAISR core op).

Port of raisr_tpu/ops/filter_apply.py's taps formulation. For each output
pixel, gather the learned 11x11 filter for (hash bucket, pixel phase) and dot
it with the centered 11x11 patch of the cheap-upscaled image (DotProdPatch_*,
reference: Raisr_AVX512.cpp:134-149, filter gather Raisr.cpp:1147-1160).

The taps are accumulated in order 0..120, the order the fused CUDA kernel
(csrc/full_kernel.cu) uses. The dense-conv formulation (`apply_filters_conv`,
raisr_tpu's `xla` backend) is not ported yet.
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
