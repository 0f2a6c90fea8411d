"""Pass epilogue shared by every pass formulation: range reject, zone masks,
census blend and rounding (part of raisr_tpu/ops/pipeline.py).

Full-frame zone semantics (derived from the reference's segment planning,
RNLSetRes Raisr.cpp:1742-1779, and hot-loop bounds Raisr.cpp:1038-1066):
  - RAISR-processed zone: rows [6, H-6), cols [6, col_end), where with
    exact_edges col_end replicates the AVX-512 unrolled loop's ragged right
    edge (8-aligned, first iteration needs 16 columns: Raisr.cpp:1066,1247).
  - Randomness blending happens only on processed pixels (Raisr.cpp:1203-1242).
  - CountOfBitsChanged blending zone: rows [1, H-1) x cols [1, W-1)
    (CTmargin; Raisr.cpp:1758-1759, 719), with HR = cheap outside the
    processed zone.
  - Everything else: cheap-upscaled pixels pass through unrounded/unclamped
    (border memcpys, Raisr.cpp:998-1028, 1252-1265).

Zone tests use per-frame rows (frame_h/frame_pad, a guard-banded stack) and
global rows (row0/zone_h, a row stripe), as the fused kernel does.
"""

from __future__ import annotations

import torch

from raisr_tpu_torch.config import BlendingMode, CT_MARGIN
from raisr_tpu_torch.ops import census


def processed_col_end(width: int, loop_margin: int, exact_edges: bool) -> int:
    """Last processed column (exclusive) of the hot loop.

    The reference's AVX-512 loop starts at 16-wide unroll and drops to 8 near
    the edge (Raisr.cpp:1066-1250): columns [6, 6 + 8*floor((W-12)/8)) are
    processed, and nothing at all if fewer than 16 columns fit."""
    if not exact_edges:
        return width - loop_margin
    usable = width - 2 * loop_margin
    if usable < 16:
        return loop_margin
    return loop_margin + 8 * (usable // 8)


def _round_clamp(val: torch.Tensor, min_val: int, max_val: int) -> torch.Tensor:
    """floor(val + 0.5) then clamp — the output packing of both blend paths
    (Raisr.cpp:735-745, Raisr_AVX256.cpp:119-123)."""
    return torch.clamp(torch.floor(val + 0.5), float(min_val), float(max_val))


def zone_height(h: int, frame_h: int = 0, zone_h: int = 0) -> int:
    """Height the zone tests use (full_kernel.py:572): the frame's in a
    guard-banded stack, else a stripe's global height, else the plane's."""
    if frame_h > 0:
        return frame_h
    return zone_h if zone_h > 0 else h


def _frame_rows(h: int, frame_h: int, frame_pad: int, row0: int, device) -> torch.Tensor:
    """Frame coordinate of every plane row (full_kernel.py:559-570).

    frame_h == 0: the plane is one frame (rows offset by row0 for a stripe).
    Otherwise the plane is a vertical stack of frame_h-row frames separated
    by 2*frame_pad guard rows: guard rows map outside [0, frame_h) and fail
    every zone test, giving each stacked frame the single-frame zones."""
    rows = torch.arange(h, dtype=torch.int64, device=device) + row0
    if frame_h <= 0:
        return rows
    period = frame_h + 2 * frame_pad
    return torch.remainder(rows + (period - frame_pad), period)


def _finish_pass(
    cheap: torch.Tensor,
    raw: torch.Tensor,
    *,
    min_val: int,
    max_val: int,
    blending: int,
    loop_margin: int,
    col_end: int,
    frame_h: int = 0,
    frame_pad: int = 0,
    row0: int = 0,
    zone_h: int = 0,
) -> torch.Tensor:
    """Range-reject, CT blend, zone masks, rounding — shared pass epilogue."""
    h, w = cheap.shape
    lm = loop_margin
    eff_h = zone_height(h, frame_h, zone_h)
    # Out-of-range reject keeps the cheap pixel (exclusive compare,
    # Raisr.cpp:1196-1201); the rejected value also feeds the CT blend's HR
    # input, because raisr32f starts as a copy of the cheap plane
    # (Raisr.cpp:1029-1036).
    keep = (raw > float(min_val)) & (raw < float(max_val))
    raisr_px = torch.where(keep, raw, cheap)

    rows = _frame_rows(h, frame_h, frame_pad, row0, cheap.device)[:, None]
    cols = torch.arange(w, dtype=torch.int64, device=cheap.device)[None, :]
    proc = (rows >= lm) & (rows < eff_h - lm) & (cols >= lm) & (cols < col_end)

    if blending == BlendingMode.RANDOMNESS:
        blended = census.blend_randomness(cheap, raisr_px)
        return torch.where(proc, _round_clamp(blended, min_val, max_val), cheap)
    hr_buf = torch.where(proc, raisr_px, cheap)
    blended = census.blend_count_of_bits_changed(cheap, hr_buf)
    blend_zone = (
        (rows >= CT_MARGIN)
        & (rows < eff_h - CT_MARGIN)
        & (cols >= CT_MARGIN)
        & (cols < w - CT_MARGIN)
    )
    return torch.where(blend_zone, _round_clamp(blended, min_val, max_val), cheap)
