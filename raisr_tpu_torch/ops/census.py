"""Census-transform (CT) blending.

Port of raisr_tpu/ops/census.py. Two modes (reference:
Library/RaisrDefaults.h:30-34):
  Randomness          — census count of 3x3 neighbors < center on the *cheap*
                        image; weight = count/8; out = w*HR + (1-w)*LR
                        (CTRandomness_C, Raisr.cpp:750-765, blend :1222-1232).
  CountOfBitsChanged  — Hamming distance between LR and HR 3x3 census bit
                        patterns; weight = hd/8; out = w*LR + (1-w)*HR
                        (CTCountOfBitsChangedSegment, Raisr.cpp:712-748).
Note the deliberate weight asymmetry between the two modes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from raisr_tpu_torch.config import CT_NUM_OF_PIXEL

_NEIGHBORS = [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if (i, j) != (0, 0)]


def _shift(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Neighbor view with zero fill; border pixels are masked out by callers."""
    padded = F.pad(img, (1, 1, 1, 1))
    h, w = img.shape
    return padded[1 + di: 1 + di + h, 1 + dj: 1 + dj + w]


def census_count(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel count of 3x3 neighbors strictly less than the center."""
    count = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    for di, dj in _NEIGHBORS:
        count = count + (_shift(img, di, dj) < img).to(torch.float32)
    return count


def randomness_weight(lr: torch.Tensor) -> torch.Tensor:
    """Randomness blend weight w (out = w*HR + (1-w)*LR); depends on LR only."""
    return census_count(lr) / CT_NUM_OF_PIXEL


def cobc_weight(lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """CountOfBitsChanged blend weight w (out = w*LR + (1-w)*HR)."""
    hamming = torch.zeros(lr.shape, dtype=torch.float32, device=lr.device)
    for di, dj in _NEIGHBORS:
        bit_lr = _shift(lr, di, dj) < lr
        bit_hr = _shift(hr, di, dj) < hr
        hamming = hamming + (bit_lr != bit_hr).to(torch.float32)
    return hamming / CT_NUM_OF_PIXEL


def blend_randomness(lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """weight*HR + (1-weight)*LR with weight = LR census count / 8."""
    weight = randomness_weight(lr)
    return weight * hr + (1.0 - weight) * lr


def blend_count_of_bits_changed(lr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """weight*LR + (1-weight)*HR with weight = census Hamming distance / 8."""
    weight = cobc_weight(lr, hr)
    return weight * lr + (1.0 - weight) * hr
