"""Cheap (bilinear) 2x upscale, numerically compatible with IPP ippiResizeLinear.

Port of raisr_tpu/ops/resize.py's 2x path. The reference upsamples with IPP's
linear resizer (reference: Library/Raisr.cpp:950-957) using the half-pixel
mapping

    src = (dst + 0.5) * (in_size / out_size) - 0.5,  border-replicate,

and stores the result as integers (Raisr.cpp:985-991); that rounding is part of
the algorithm. At 2x the weights are fixed quarters, so the upscale is slices
and an interleave, and every intermediate is exact in float32.

Only 2x bilinear is ported so far. Other ratios (the exact-integer 1.5x form,
`cheap_upscale_stacked`) and the cubic/lanczos modes raise `RaisrError`.
"""

from __future__ import annotations

import torch

from raisr_tpu_torch.config import RaisrError


def _upscale_axis_2x(img: torch.Tensor, dim: int) -> torch.Tensor:
    """2x upsample along `dim`: out[2k] = in[k] + (in[k-1] - in[k]) * 0.25,
    out[2k+1] = in[k] + (in[k+1] - in[k]) * 0.25, edges clamped."""
    n = img.shape[dim]
    first = img.narrow(dim, 0, 1)
    last = img.narrow(dim, n - 1, 1)
    prev = torch.cat([first, img.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([img.narrow(dim, 1, n - 1), last], dim=dim)
    even = img + (prev - img) * 0.25
    odd = img + (nxt - img) * 0.25
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(img.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def bilinear_upscale(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """2x bilinear resize of the last two dims (float32 out, un-rounded).

    Columns first, then rows, as raisr_tpu's transpose-based form."""
    in_h, in_w = img.shape[-2:]
    if not (out_h == 2 * in_h and out_w == 2 * in_w):
        raise RaisrError(
            f"resize {in_h}x{in_w} -> {out_h}x{out_w}: only 2x bilinear is "
            "ported to raisr_tpu_torch so far."
        )
    img = img.to(torch.float32)
    return _upscale_axis_2x(_upscale_axis_2x(img, img.dim() - 1), img.dim() - 2)


def cheap_upscale(
    img: torch.Tensor, out_h: int, out_w: int, bits: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Integer-valued cheap upscale (float32 holding ints in [0, 2^bits-1]).

    Works on [H, W] or any batch of planes [..., H, W]."""
    if mode != "bilinear":
        raise RaisrError(
            f"resize mode: {mode} is not ported to raisr_tpu_torch yet."
        )
    out = bilinear_upscale(img, out_h, out_w)
    max_full = float((1 << bits) - 1)
    return torch.clamp(torch.floor(out + 0.5), 0.0, max_full)
