"""Gradient structure tensor (GTWG) and hash-bucket quantization.

Port of raisr_tpu/ops/hashing.py. Per output pixel the reference computes an
11x11 Gaussian-weighted gradient Gram matrix (computeGTWG_Segment_*,
reference: Library/Raisr_AVX512.cpp:69-131) and quantizes its eigen-structure
into one of Qangle * Qstrength * Qcoherence = 216 buckets
(GetHashValue_AVX512_32f_16Elements, Raisr_AVX512.cpp:175-258).

Both structure tensors are written as shift-multiply-adds on zero-padded
planes, never as `conv2d`: that keeps them off cuDNN, whose float32
convolutions default to TF32, and fixes the order of the sums. The separable
form adds its taps in the same order as the fused CUDA kernel, so the two agree
bit for bit on the card. Tie semantics of the strength/coherence binning follow
the AVX-512 variant (`edge <= value` counting).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PI = float(np.pi)


def gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Un-divided central differences (gradient = next - prev; the missing /2
    is folded into the Gaussian normalization factor, Raisr_globals.h:208-210).

    gx is the vertical (row-direction) gradient, gy horizontal — matching
    GetGx/GetGy (Raisr_AVX256.cpp:186-194). Border rows/cols are zero."""
    gx = torch.zeros_like(img)
    gx[1:-1, :] = img[2:, :] - img[:-2, :]
    gy = torch.zeros_like(img)
    gy[:, 1:-1] = img[:, 2:] - img[:, :-2]
    return gx, gy


def _shift2d(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[r, c] = img[r - di, c - dj], zero outside the plane."""
    h, w = img.shape
    padded = F.pad(img, (max(dj, 0), max(-dj, 0), max(di, 0), max(-di, 0)))
    return padded[max(-di, 0): max(-di, 0) + h, max(-dj, 0): max(-dj, 0) + w]


def structure_tensor(
    gx: torch.Tensor, gy: torch.Tensor, weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted Gram maps a = sum w*gx^2, b = sum w*gx*gy, d = sum w*gy^2 over
    the centered (patch x patch) window (computeGTWG accumulation,
    Raisr_AVX256.cpp:295-313), zero padding. Uses the exact (non-separable)
    literal weight table; taps are added in row-major window order."""
    p = weights.shape[0]
    m = p // 2
    wts = [[float(weights[i, j]) for j in range(p)] for i in range(p)]
    outs = []
    for mp in (gx * gx, gx * gy, gy * gy):
        acc = None
        for i in range(p):
            for j in range(p):
                t = _shift2d(mp, m - i, m - j) * wts[i][j]
                acc = t if acc is None else acc + t
        outs.append(acc)
    return outs[0], outs[1], outs[2]


def structure_tensor_separable(
    gx: torch.Tensor, gy: torch.Tensor, k1d, nf: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Separable structure tensor: the vertical 11-tap sum, then the
    horizontal one, then `* nf`, each tap added in order 0..10.

    Uses the sigma=2 kernel from createGaussianKernel (Raisr.cpp:141-185) —
    the source of the reference's 6-digit literal table; results differ from
    the literal-table form only in the ~6th digit (exact-tie bucket flips)."""
    m = len(k1d) // 2
    outs = []
    for mp in (gx * gx, gx * gy, gy * gy):
        v = None
        for i, kv in enumerate(k1d):
            t = _shift2d(mp, m - i, 0) * float(kv)
            v = t if v is None else v + t
        out = None
        for j, kv in enumerate(k1d):
            t = _shift2d(v, 0, m - j) * float(kv)
            out = t if out is None else out + t
        outs.append(out * float(nf))
    return outs[0], outs[1], outs[2]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as the card's `sqrtf` (and XLA's) take
    it. PyTorch's CPU sqrt is MKL's vector routine: it is not correctly
    rounded, and on a process's first call some of its threads may round
    otherwise from run to run, which moves a bucket and then the pixels
    around it. On the CPU the root is therefore numpy's, the processor's own
    correctly rounded instruction."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def atan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 used by every reference SIMD path when built without
    SVML (USE_ATAN2_APPROX; reference: Raisr.cpp:770-793)."""
    abs_y = torch.abs(y) + 1e-10
    neg_x = x < 0.0
    r = torch.where(neg_x, (x + abs_y) / (abs_y - x), (x - abs_y) / (x + abs_y))
    quarter = torch.full_like(x, PI / 4.0)
    angle = torch.where(neg_x, torch.full_like(x, 3.0 * PI / 4.0), quarter)
    angle = angle + (0.1963 * r * r - 0.9817) * r
    return torch.where(y < 0.0, -angle, angle)


def hash_buckets(
    a: torch.Tensor,
    b: torch.Tensor,
    d: torch.Tensor,
    qstr,
    qcoh,
    qangle: int,
    qstrength: int,
    qcoherence: int,
) -> torch.Tensor:
    """(angle, strength, coherence) quantization -> int32 bucket index.

    Mirrors GetHashValue_AVX512_32f_16Elements (Raisr_AVX512.cpp:175-258):
      - eigenvalues of [[a, b], [b, d]]
      - angle = atan2(b, L1 - d) (or atan2(b != 0 ? .. : 1)), + pi if negative
      - strength = L1; coherence = (sqrt L1 - sqrt L2)/(sqrt L1 + sqrt L2 + 1e-17)
      - strength/coherence indices count `edge <= value` (ties round UP)

    qstr/qcoh are float32 tensors (or sequences of floats) of bin edges."""
    t = a + d
    det = a * d - b * b
    disc = torch.clamp(t * t * 0.25 - det, min=0.0)
    sqr = sqrt_rn(disc)
    half_t = t * 0.5
    l1 = half_t + sqr
    l2 = torch.clamp(half_t - sqr, min=0.0)

    x = torch.where(b != 0.0, l1 - d, torch.ones_like(l1))
    angle = atan2_approx(b, x)
    angle = angle + torch.where(
        angle < 0.0, torch.full_like(angle, PI), torch.zeros_like(angle)
    )

    sqrt_l1 = sqrt_rn(l1)
    sqrt_l2 = sqrt_rn(l2)
    coherence = (sqrt_l1 - sqrt_l2) / (sqrt_l1 + sqrt_l2 + 1e-17)
    strength = l1

    angle_idx = torch.floor(angle * (qangle / PI)).to(torch.int32)
    angle_idx = torch.clamp(angle_idx, 0, qangle - 1)

    strength_idx = torch.zeros_like(angle_idx)
    for edge in range(qstrength - 1):
        strength_idx = strength_idx + (qstr[edge] <= strength).to(torch.int32)
    coherence_idx = torch.zeros_like(angle_idx)
    for edge in range(qcoherence - 1):
        coherence_idx = coherence_idx + (qcoh[edge] <= coherence).to(torch.int32)

    return (
        angle_idx * (qstrength * qcoherence)
        + strength_idx * qcoherence
        + coherence_idx
    )


def pixel_types(
    h: int, w: int, ratio: int, patch_margin: int, use_pixel_type: bool,
    device: torch.device | str = "cpu", row0: int = 0,
) -> torch.Tensor:
    """Per-pixel phase -> filter variant index (reference: Raisr.cpp:1091-1094:
    pixelType = ((r - margin) % ratio) * ratio + ((c - margin) % ratio)),
    with a floor modulo for the negative rows and columns. `row0` is the
    global row of plane row 0 (a row stripe: raisr_tpu's
    parallel/sharding.py:313-317), so the phases are the whole frame's."""
    if not use_pixel_type:
        return torch.zeros((h, w), dtype=torch.int32, device=device)
    rows = torch.remainder(
        torch.arange(h, dtype=torch.int32, device=device) + row0 - patch_margin, ratio
    )
    cols = torch.remainder(
        torch.arange(w, dtype=torch.int32, device=device) - patch_margin, ratio
    )
    return rows[:, None] * ratio + cols[None, :]
