"""Image quality metrics (PSNR / SSIM) for golden comparisons.

The reference has no numerical test layer (SURVEY.md §4); BASELINE.md's
quality bar is "PSNR within 0.05 dB" of the AVX-512 output, so we provide
the metrics the validation flow needs.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float | None = None) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if max_val is None:
        max_val = 255.0 if a.max() <= 255 else 1023.0
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val * max_val / mse))


def ssim(a: np.ndarray, b: np.ndarray, max_val: float | None = None) -> float:
    """Single-scale SSIM (Wang et al. 2004), 11x11 Gaussian window,
    dependency-free separable implementation."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if max_val is None:
        max_val = 255.0 if a.max() <= 255 else 1023.0
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    x = np.arange(11) - 5
    k = np.exp(-(x**2) / (2 * 1.5**2))
    k /= k.sum()

    def blur(img):
        out = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, img)
        return np.apply_along_axis(lambda c: np.convolve(c, k, "valid"), 0, out)

    mu_a, mu_b = blur(a), blur(b)
    sa = blur(a * a) - mu_a**2
    sb = blur(b * b) - mu_b**2
    sab = blur(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (sa + sb + c2)
    return float(np.mean(num / den))
