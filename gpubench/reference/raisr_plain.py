"""RAISR upscaling in plain PyTorch: the benchmark's reference.

One frame at a time, with no kernel, stack, cache or batching: the cheap
bilinear upscale of the Y plane, then each pass (gradients, the separable
Gaussian structure tensor, the angle / strength / coherence hash, the
121-tap filter dot with the pixel's bucket and phase, the exclusive range
reject, the CountOfBitsChanged census blend, floor(+0.5) and clamp, the
frame's zones), the cheap upscale of U and V, and the packing to integers.

The arithmetic is a frozen copy of the plain versions that raisr_tpu_torch
keeps beside its CUDA kernels (ops/hashing.py, ops/filter_apply.py,
ops/census.py, ops/epilogue.py, ops/resize.py, model/gaussian.py), which
round every step in the kernels' order: taps in order 0..120, the
vertical Gaussian sum before the horizontal one, each multiply and add on
its own. Kept here so that no later change to the program can move the
yardstick. It takes the raw float32 bank and the packed frames that the
benchmark made from its seed, and works out itself whatever the program's
set-up derives from them (Gaussian taps, bin edges as floats, phases). It
imports nothing of the program, and runs on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PI = float(np.pi)
N_TAPS = 121
CT_NEIGHBOURS = [(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1) if (i, j) != (0, 0)]
CT_MARGIN = 1
COUNT_OF_BITS_CHANGED = 2


# -- constants of the algorithm ---------------------------------------------


def gaussian_kernel_1d(n: int = 11, sigma: float = 2.0) -> np.ndarray:
    """The 1-D Gaussian of the structure tensor (createGaussianKernel of the
    upstream library), float32."""
    scale2x = -0.125 / (sigma * sigma)
    n2 = (n - 1) // 2
    xs = np.arange(1 - n, 0, 2, dtype=np.float64)[:n2]
    values = np.exp(xs * xs * scale2x)
    total = 2.0 * values.sum() + 1.0
    result = np.zeros(n, dtype=np.float64)
    result[:n2] = values / total
    result[n - 1: n - 1 - n2: -1] = values / total
    result[n2] = 1.0 / total
    return result.astype(np.float32)


def normalization_factor(bits: int) -> float:
    """1 / (max^2 * 4): the gradients are un-halved central differences."""
    max_val = float((1 << bits) - 1)
    return 1.0 / (max_val * max_val * 2.0 * 2.0)


def clamp_range(bits: int, video_range: bool) -> tuple[int, int]:
    """The output clamp of a pass: video range 16..235 (8 bits) or 64..940
    (10), else the full range."""
    if bits == 8 and video_range:
        return 16, 235
    if bits == 10 and video_range:
        return 64, 940
    return 0, (1 << bits) - 1


# -- packed planes ---------------------------------------------------------------


def unpack(t: torch.Tensor) -> torch.Tensor:
    """Packed integer planes (uint8, uint16) as float32; uint16 read through
    its int16 view, which every device can widen."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.float32)


def pack(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer-valued float32 planes as `dtype` (uint16 through int32 and an
    int16 view)."""
    if dtype == torch.uint16:
        return x.to(torch.int32).to(torch.int16).view(torch.uint16)
    return x.to(dtype)


# -- cheap upscale ------------------------------------------------------------


def _upscale_axis_2x(img: torch.Tensor, dim: int) -> torch.Tensor:
    """out[2k] = in[k] + (in[k-1] - in[k]) * 0.25, out[2k+1] = in[k] +
    (in[k+1] - in[k]) * 0.25, edges replicated."""
    n = img.shape[dim]
    prev = torch.cat([img.narrow(dim, 0, 1), img.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([img.narrow(dim, 1, n - 1), img.narrow(dim, n - 1, 1)], dim=dim)
    even = img + (prev - img) * 0.25
    odd = img + (nxt - img) * 0.25
    shape = list(img.shape)
    shape[dim] = 2 * n
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def _axis_exact(in_size: int, out_size: int, device) -> tuple:
    """(idx0, idx1, integer weight, den) of one axis of the half-pixel
    bilinear map src = (dst + 0.5) * in / out - 0.5, border replicated, at a
    ratio where every weight is w / den with a small integer w: 1.5x (den 6)
    or 2x (den 4)."""
    den = 4 if out_size == 2 * in_size else 6 if 2 * out_size == 3 * in_size else None
    if den is None:
        raise ValueError(f"no exact bilinear form for {in_size} -> {out_size}")
    dst = np.arange(out_size, dtype=np.float64)
    src = np.clip((dst + 0.5) * (in_size / out_size) - 0.5, 0.0, in_size - 1)
    idx0 = np.floor(src).astype(np.int64)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    frac = (src - idx0).astype(np.float32)
    w = np.round(frac.astype(np.float64) * den).astype(np.float32)
    return (torch.tensor(idx0, device=device), torch.tensor(idx1, device=device),
            torch.tensor(w, device=device), float(den))


def cheap_upscale(img: torch.Tensor, out_h: int, out_w: int, bits: int) -> torch.Tensor:
    """The integer-valued bilinear upscale of the last two dims (float32).
    2x: the slice-and-interleave form, columns first, floor(+0.5), clamped
    to the bit depth. 1.5x: exact integer arithmetic over den 6 on each
    axis, floor((s + 18) / 36), clamped."""
    in_h, in_w = img.shape[-2:]
    img = img.to(torch.float32)
    if (out_h, out_w) == (2 * in_h, 2 * in_w):
        out = _upscale_axis_2x(_upscale_axis_2x(img, img.dim() - 1), img.dim() - 2)
        return torch.clamp(torch.floor(out + 0.5), 0.0, float((1 << bits) - 1))
    r0, r1, rw, rden = _axis_exact(in_h, out_h, img.device)
    c0, c1, cw, cden = _axis_exact(in_w, out_w, img.device)
    a = img.index_select(-2, r0)
    t = a * rden + (img.index_select(-2, r1) - a) * rw[:, None]
    b = t.index_select(-1, c0)
    scaled = b * cden + (t.index_select(-1, c1) - b) * cw
    den = rden * cden
    return torch.clamp(torch.floor((scaled + den / 2) / den), 0.0, float((1 << bits) - 1))


# -- hash -----------------------------------------------------------------------


def _shift2d(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[r, c] = img[r - di, c - dj], zero outside the plane."""
    h, w = img.shape
    padded = F.pad(img, (max(dj, 0), max(-dj, 0), max(di, 0), max(-di, 0)))
    return padded[max(-di, 0): max(-di, 0) + h, max(-dj, 0): max(-dj, 0) + w]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root: the card's torch.sqrt, numpy's on the
    CPU (PyTorch's CPU sqrt is a vector routine that is not)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _atan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The upstream library's polynomial atan2 (USE_ATAN2_APPROX)."""
    abs_y = torch.abs(y) + 1e-10
    neg_x = x < 0.0
    r = torch.where(neg_x, (x + abs_y) / (abs_y - x), (x - abs_y) / (x + abs_y))
    angle = torch.where(neg_x, torch.full_like(x, 3.0 * PI / 4.0), torch.full_like(x, PI / 4.0))
    angle = angle + (0.1963 * r * r - 0.9817) * r
    return torch.where(y < 0.0, -angle, angle)


def hash_buckets(cheap: torch.Tensor, k1d, nf: float, qstr, qcoh,
                 qangle: int, qstrength: int, qcoherence: int) -> torch.Tensor:
    """int32 bucket of every pixel: un-halved central differences, the
    separable Gaussian structure tensor (vertical taps, then horizontal,
    then * nf), its eigenvalues, angle, strength and coherence, binned with
    `edge <= value`."""
    gx = torch.zeros_like(cheap)
    gx[1:-1, :] = cheap[2:, :] - cheap[:-2, :]
    gy = torch.zeros_like(cheap)
    gy[:, 1:-1] = cheap[:, 2:] - cheap[:, :-2]
    m = len(k1d) // 2
    maps = []
    for mp in (gx * gx, gx * gy, gy * gy):
        v = None
        for i, kv in enumerate(k1d):
            t = _shift2d(mp, m - i, 0) * float(kv)
            v = t if v is None else v + t
        out = None
        for j, kv in enumerate(k1d):
            t = _shift2d(v, 0, m - j) * float(kv)
            out = t if out is None else out + t
        maps.append(out * float(nf))
    a, b, d = maps

    t = a + d
    det = a * d - b * b
    sqr = _sqrt(torch.clamp(t * t * 0.25 - det, min=0.0))
    half_t = t * 0.5
    l1 = half_t + sqr
    l2 = torch.clamp(half_t - sqr, min=0.0)
    angle = _atan2_approx(b, torch.where(b != 0.0, l1 - d, torch.ones_like(l1)))
    angle = angle + torch.where(angle < 0.0, torch.full_like(angle, PI), torch.zeros_like(angle))
    sqrt_l1, sqrt_l2 = _sqrt(l1), _sqrt(l2)
    coherence = (sqrt_l1 - sqrt_l2) / (sqrt_l1 + sqrt_l2 + 1e-17)

    angle_idx = torch.clamp(torch.floor(angle * (qangle / PI)).to(torch.int32), 0, qangle - 1)
    strength_idx = torch.zeros_like(angle_idx)
    for edge in range(qstrength - 1):
        strength_idx = strength_idx + (qstr[edge] <= l1).to(torch.int32)
    coherence_idx = torch.zeros_like(angle_idx)
    for edge in range(qcoherence - 1):
        coherence_idx = coherence_idx + (qcoh[edge] <= coherence).to(torch.int32)
    return angle_idx * (qstrength * qcoherence) + strength_idx * qcoherence + coherence_idx


# -- filter ---------------------------------------------------------------------


def apply_filters(cheap: torch.Tensor, buckets: torch.Tensor, filters: torch.Tensor,
                  pixel_types: int, patch_size: int = 11) -> torch.Tensor:
    """Each pixel's 121-tap dot with its filter (row bucket * 4 + phase with
    4 phases, the bucket with 1), taps in order 0..120, the plane zero
    outside. A bucket outside the bank gives 0."""
    h, w = cheap.shape
    margin = patch_size // 2
    n_buckets = filters.shape[0] // pixel_types
    valid = (buckets >= 0) & (buckets < n_buckets)
    rows = torch.where(valid, buckets, 0)
    if pixel_types == 4:
        pr = torch.remainder(torch.arange(h, dtype=torch.int32, device=cheap.device) - margin, 2)
        pc = torch.remainder(torch.arange(w, dtype=torch.int32, device=cheap.device) - margin, 2)
        rows = rows * 4 + (pr[:, None] * 2 + pc[None, :])
    padded = F.pad(cheap, (margin, margin, margin, margin))
    idx = rows.to(torch.int64)
    acc = torch.zeros_like(cheap)
    for t in range(patch_size * patch_size):
        i, j = divmod(t, patch_size)
        acc = acc + padded[i: i + h, j: j + w] * filters[:, t][idx]
    return torch.where(valid, acc, 0.0)


# -- epilogue -------------------------------------------------------------------


def _shift1(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    h, w = img.shape
    return F.pad(img, (1, 1, 1, 1))[1 + di: 1 + di + h, 1 + dj: 1 + dj + w]


def _census_less(img: torch.Tensor):
    return [_shift1(img, di, dj) < img for di, dj in CT_NEIGHBOURS]


def processed_col_end(width: int, loop_margin: int) -> int:
    """The upstream hot loop's last processed column (exclusive): columns
    [6, 6 + 8 * floor((W - 12) / 8)), nothing if fewer than 16 fit."""
    usable = width - 2 * loop_margin
    if usable < 16:
        return loop_margin
    return loop_margin + 8 * (usable // 8)


def finish_pass(cheap: torch.Tensor, raw: torch.Tensor, min_val: int, max_val: int,
                loop_margin: int) -> torch.Tensor:
    """Range reject (exclusive), the processed zone, the CountOfBitsChanged
    census blend (weight = the Hamming distance of the 3x3 census bits of
    the cheap and the filtered plane / 8; out = w * cheap + (1 - w) * HR),
    floor(+0.5) and clamp in the blend zone, over one frame."""
    h, w = cheap.shape
    lm = loop_margin
    raisr_px = torch.where((raw > float(min_val)) & (raw < float(max_val)), raw, cheap)
    rows = torch.arange(h, dtype=torch.int64, device=cheap.device)[:, None]
    cols = torch.arange(w, dtype=torch.int64, device=cheap.device)[None, :]
    proc = (rows >= lm) & (rows < h - lm) & (cols >= lm) & (cols < processed_col_end(w, lm))
    hr = torch.where(proc, raisr_px, cheap)
    hamming = torch.zeros(cheap.shape, dtype=torch.float32, device=cheap.device)
    for bit_lr, bit_hr in zip(_census_less(cheap), _census_less(hr)):
        hamming = hamming + (bit_lr != bit_hr).to(torch.float32)
    weight = hamming / 8
    blended = weight * cheap + (1.0 - weight) * hr
    zone = ((rows >= CT_MARGIN) & (rows < h - CT_MARGIN)
            & (cols >= CT_MARGIN) & (cols < w - CT_MARGIN))
    return torch.where(zone, torch.clamp(torch.floor(blended + 0.5), float(min_val),
                                         float(max_val)), cheap)


# -- a frame --------------------------------------------------------------------


class Reference:
    """The reference upscaler of one configuration. `banks` is a float32
    tensor [passes, buckets * pixel_types, >= 121] of raw taps; `qstr`,
    `qcoh` the bin edges of each pass (float32 values)."""

    def __init__(self, cfg: dict, banks: torch.Tensor, qstr, qcoh):
        self.bits = int(cfg["bits"])
        self.ratio = float(cfg["ratio"])
        self.passes = int(cfg["passes"])
        self.mode = int(cfg["mode"]) if self.passes == 2 else 1
        if int(cfg["blending"]) != COUNT_OF_BITS_CHANGED:
            raise ValueError("the reference blends CountOfBitsChanged (2) only")
        self.min_val, self.max_val = clamp_range(self.bits, int(cfg["range"]) == 0)
        bank = cfg["bank"]
        self.qangle, self.qstrength, self.qcoherence = (
            int(bank["qangle"]), int(bank["qstrength"]), int(bank["qcoherence"]))
        self.patch_size = int(bank["patch_size"])
        self.pixel_types = 4 if self.ratio == 2.0 else 1
        if banks.shape[1] != self.qangle * self.qstrength * self.qcoherence * self.pixel_types:
            raise ValueError(f"bank of {banks.shape[1]} rows for {self.pixel_types} phases")
        self.banks = banks[..., :N_TAPS].to(torch.float32)
        self.edges = [(tuple(float(np.float32(v)) for v in s), tuple(float(np.float32(v)) for v in c))
                      for s, c in zip(qstr, qcoh)]
        self.k1d = tuple(float(v) for v in gaussian_kernel_1d(self.patch_size))
        self.nf = normalization_factor(self.bits)

    def out_size(self, h: int, w: int) -> tuple[int, int]:
        return int(h * self.ratio), int(w * self.ratio)

    def raisr_pass(self, cheap: torch.Tensor, pass_idx: int) -> torch.Tensor:
        qstr, qcoh = self.edges[pass_idx]
        buckets = hash_buckets(cheap, self.k1d, self.nf, qstr, qcoh,
                               self.qangle, self.qstrength, self.qcoherence)
        raw = apply_filters(cheap, buckets, self.banks[pass_idx], self.pixel_types,
                            self.patch_size)
        return finish_pass(cheap, raw, self.min_val, self.max_val, self.patch_size // 2 + 1)

    def luma(self, y: torch.Tensor) -> torch.Tensor:
        """One packed Y plane [H, W] -> the packed upscaled plane."""
        out_h, out_w = self.out_size(*y.shape)
        x = unpack(y)
        for pass_idx in range(self.passes):
            cheap = cheap_upscale(x, out_h, out_w, self.bits) if pass_idx + 1 == self.mode else x
            x = self.raisr_pass(cheap, pass_idx)
        return pack(x, y.dtype)

    def chroma(self, c: torch.Tensor) -> torch.Tensor:
        """One packed chroma plane [Hc, Wc] -> its packed cheap upscale."""
        out_h, out_w = self.out_size(*c.shape)
        return pack(cheap_upscale(unpack(c), out_h, out_w, self.bits), c.dtype)


def compare(got: torch.Tensor, want: torch.Tensor) -> tuple[int, float]:
    """(samples that differ, the largest absolute difference) of two
    packed planes; a shape that differs counts every sample."""
    if tuple(got.shape) != tuple(want.shape):
        return max(got.numel(), want.numel()), math.inf
    d = (unpack(got).to(torch.float64) - unpack(want).to(torch.float64)).abs()
    return int((d > 0).sum()), float(d.max()) if d.numel() else 0.0
