"""Shared inputs for the raisr_tpu_torch tests.

Every test_torch_* file holds the PyTorch port against the JAX package on the
same inputs: a bank built in memory as a raisr_tpu RaisrModel (handed to the
port through from_jax_model) and images made with numpy from a seed. Nothing
here reads a filter folder from outside the repository.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# strength / coherence bin edges of the shape the shipped 2x banks use
QSTR = (0.001269, 0.022169)
QCOH = (0.192916, 0.405942)


def make_filters(rng: np.random.Generator) -> np.ndarray:
    """One pass's 2x bank of the real shape (216 buckets x 4 phases x 121 taps,
    rows padded to 128): centre tap 1 plus noise of 0.01."""
    filters = np.zeros((864, 128), np.float32)
    filters[:, :121] = rng.normal(size=(864, 121)).astype(np.float32) * 0.01
    filters[:, 60] += 1.0
    return filters


def make_jax_model(passes: int = 2, seed: int = 0):
    """A raisr_tpu RaisrModel of `passes` seeded 2x banks (make_filters)."""
    from raisr_tpu.model.loader import FilterBank, RaisrModel

    rng = np.random.default_rng(seed)
    banks = []
    for _ in range(passes):
        filters = make_filters(rng)
        banks.append(
            FilterBank(
                filters=filters,
                qstr=np.asarray(QSTR, np.float32),
                qcoh=np.asarray(QCOH, np.float32),
                pixel_types=4,
                taps=121,
                source_dtype="fp32",
            )
        )
    return RaisrModel(qangle=24, qstrength=3, qcoherence=3, patch_size=11,
                      banks=tuple(banks))


def smooth(h: int, w: int, bits: int = 8, seed: int = 0) -> np.ndarray:
    """Box-filtered noise scaled to the full integer range, as float32."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h, w))
    for ax in (0, 1):
        img = np.apply_along_axis(
            lambda r: np.convolve(r, np.ones(5) / 5, "same"), ax, img
        )
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return np.floor(img * ((1 << bits) - 1)).astype(np.float32)


def frac_and_median(a, b) -> tuple[float, float]:
    """Share of differing pixels and the median absolute difference."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float((d > 0).mean()), float(np.median(d))


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())
