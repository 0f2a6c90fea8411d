"""Gaussian weighting window for the gradient structure tensor.

The reference hardcodes an 11x16 table `gGaussian2DOriginal` (values of
outer(k, k) for an 11-tap sigma=2.0 kernel, printed to 6 significant digits;
reference: Library/Raisr_globals.h:213-224) and bakes the per-bit-depth
normalization factor NF = 1/(max^2 * 4) into derived tables
(Raisr_globals.h:208-210, 227-264). The `* 4` accounts for the un-divided
central-difference gradients (gradient = next - prev, not (next - prev)/2).

We embed the same 6-digit literal values (they are model constants the
reference computes with — using a freshly computed kernel would drift GTWG
values in the 6th digit and flip hash buckets at exact bin-edge ties), plus
the `createGaussianKernel` formula (Raisr.cpp:141-185) for patch sizes != 11.
"""

from __future__ import annotations

import numpy as np

# Upper-left 6x6 quadrant of the literal table (Raisr_globals.h:213-224);
# the full 11x11 window is mirror-symmetric in both axes.
_QUAD = np.array(
    [
        [7.76554e-05, 0.000239195, 0.0005738, 0.001072, 0.00155975, 0.00176743],
        [0.000239195, 0.000736774, 0.00176743, 0.00330199, 0.00480437, 0.00544406],
        [0.0005738, 0.00176743, 0.00423984, 0.00792107, 0.0115251, 0.0130596],
        [0.001072, 0.00330199, 0.00792107, 0.0147985, 0.0215317, 0.0243986],
        [0.00155975, 0.00480437, 0.0115251, 0.0215317, 0.0313284, 0.0354998],
        [0.00176743, 0.00544406, 0.0130596, 0.0243986, 0.0354998, 0.0402265],
    ],
    dtype=np.float64,
)


def _mirror(quad: np.ndarray) -> np.ndarray:
    n = quad.shape[0]
    full = np.zeros((2 * n - 1, 2 * n - 1), dtype=quad.dtype)
    full[:n, :n] = quad
    full[:n, n:] = quad[:, -2::-1]
    full[n:, :] = full[n - 2 :: -1, :]
    return full


GAUSSIAN_11x11 = _mirror(_QUAD).astype(np.float32)  # [11, 11], sums to ~1


def normalization_factor(bits: int) -> float:
    """NF_8 / NF_10 / NF_16 (reference: Raisr_globals.h:208-210)."""
    max_val = float((1 << bits) - 1)
    return 1.0 / (max_val * max_val * 2.0 * 2.0)


def gaussian_kernel_1d(n: int, sigma: float = 2.0) -> np.ndarray:
    """Port of createGaussianKernel (reference: Raisr.cpp:141-185).

    Only used when a model's config requests patchSize != 11 (the reference
    rejects those today, Raisr.cpp:1568-1572, but keeps the code path).
    """
    scale2x = -0.125 / (sigma * sigma)
    n2 = (n - 1) // 2
    xs = np.arange(1 - n, 0, 2, dtype=np.float64)[:n2]
    values = np.exp(xs * xs * scale2x)
    total = 2.0 * values.sum() + 1.0
    if n % 2 == 0:
        total += 1.0
    result = np.zeros(n, dtype=np.float64)
    result[:n2] = values / total
    result[n - 1 : n - 1 - n2 : -1] = values / total
    result[n2] = 1.0 / total
    if n % 2 == 0:
        result[n2 + 1] = result[n2]
    return result.astype(np.float32)


def gaussian_weights(patch_size: int, bits: int) -> np.ndarray:
    """[patch, patch] float32 window including the NF normalization,
    equivalent to gGaussian2D{8,10,16}bit (reference: Raisr_globals.h:227-264)."""
    if patch_size == 11:
        base = GAUSSIAN_11x11
    else:
        k = gaussian_kernel_1d(patch_size)
        base = np.outer(k, k)
    return (base * np.float32(normalization_factor(bits))).astype(np.float32)
