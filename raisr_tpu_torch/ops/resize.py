"""Cheap upscale, numerically compatible with IPP ippiResizeLinear.

Port of raisr_tpu/ops/resize.py. The reference upsamples with
IPP's linear resizer (reference: Library/Raisr.cpp:950-957) using the
half-pixel mapping

    src = (dst + 0.5) * (in_size / out_size) - 0.5,  border-replicate,

and stores the result as integers (Raisr.cpp:985-991); that rounding is part of
the algorithm. Three forms, as in raisr_tpu:
  - 2x: fixed quarter weights, so slices and an interleave, exact in float32;
  - exact 1.5x (either axis 1.5x or 2x): every weight is w/6 or w/4 with a
    small integer w, so the upscale runs in exact integer arithmetic and its
    rounding is exact whatever the order of operations;
  - any other ratio (odd sizes, `evenoutput` trims): the float form
    a + (b - a) * frac on gathered rows and columns.
`cheap_upscale_stacked` upscales a guard-banded frame stack so that each
frame's rows equal the per-frame upscale exactly.

The reference also compile-selects cubic (B=0, C=0.75) and 3-lobe Lanczos
resizers (USE_BICUBIC/USE_LANCZOS, Raisr_globals.h:63-81); here they are a
runtime knob (RaisrConfig.resize_mode) on the same half-pixel mapping and
border replicate: `resample_upscale` sums 4 or 6 taps per axis, rows then
columns, in float32, tap 0 first.

Everything works on the last two dims of [..., H, W]. The index and weight
vectors are built on the host once per (sizes, device) and cached, so only
the first call at a shape copies them to the device: run a shape once before
capturing it in a CUDA graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raisr_tpu_torch.config import RaisrError


def _axis_weights(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (idx0, idx1, frac) for one axis."""
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    idx0 = np.floor(src).astype(np.int32)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    frac = (src - idx0).astype(np.float32)
    return idx0, idx1, frac


def _exact_den(in_size: int, out_size: int) -> int | None:
    """Denominator of every bilinear weight of an exact ratio (2x -> 4,
    1.5x -> 6), None for any other ratio."""
    if out_size == 2 * in_size:
        return 4
    if 2 * out_size == 3 * in_size:
        return 6
    return None


def _axis_weights_exact(in_size: int, out_size: int):
    """Static (idx0, idx1, w, den) for one axis when the ratio makes every
    bilinear weight a rational with a tiny denominator: frac = w/den exactly,
    with w an exact small integer. None for any other ratio (e.g.
    evenoutput-trimmed widths)."""
    den = _exact_den(in_size, out_size)
    if den is None:
        return None
    idx0, idx1, frac = _axis_weights(in_size, out_size)
    w = np.round(frac.astype(np.float64) * den)
    assert np.abs(w / den - frac).max() < 1e-6  # ratio guarantees exactness
    return idx0, idx1, w.astype(np.float32), float(den)


def _plane_exact(in_h: int, in_w: int, out_h: int, out_w: int) -> bool:
    """The exact-integer form needs both axes exact, as in raisr_tpu."""
    return _exact_den(in_h, out_h) is not None and _exact_den(in_w, out_w) is not None


def _on(device: torch.device, idx0, idx1, weight, den: float):
    return (
        torch.tensor(idx0.astype(np.int64), device=device),
        torch.tensor(idx1.astype(np.int64), device=device),
        torch.tensor(weight, device=device),
        den,
    )


@functools.lru_cache(maxsize=128)
def _axis_vectors(in_size: int, out_size: int, exact: bool, device: torch.device):
    """(idx0, idx1, weight, den) of one axis on `device`: integer weights
    over den (4 or 6) in the exact form, float fractions over 1.0 otherwise."""
    if exact:
        return _on(device, *_axis_weights_exact(in_size, out_size))
    return _on(device, *_axis_weights(in_size, out_size), 1.0)


def _separable(img: torch.Tensor, rows, cols) -> torch.Tensor:
    """Rows then columns: a * den + (b - a) * weight on gathered neighbours.
    With den 1.0 this is the float form a + (b - a) * frac, value for value
    (a product by 1.0 is exact)."""
    r0, r1, rw, rden = rows
    c0, c1, cw, cden = cols
    a = img.index_select(-2, r0)
    t = a * rden + (img.index_select(-2, r1) - a) * rw[:, None]
    b = t.index_select(-1, c0)
    return b * cden + (t.index_select(-1, c1) - b) * cw


def _rounded(scaled: torch.Tensor, den: float, bits: int) -> torch.Tensor:
    """floor(value + 0.5), clamped, of `scaled` = den * value. Exact for the
    integer form: every intermediate is an integer below 2^24."""
    val = torch.floor((scaled + den / 2) / den)
    return torch.clamp(val, 0.0, float((1 << bits) - 1))


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
    """Bilinear resize of the last two dims (float32 out, un-rounded).

    2x: slices and an interleave, columns first, as raisr_tpu's
    transpose-based form. Any other size: the float gather form."""
    in_h, in_w = img.shape[-2:]
    img = img.to(torch.float32)
    if out_h == 2 * in_h and out_w == 2 * in_w:
        return _upscale_axis_2x(_upscale_axis_2x(img, img.dim() - 1), img.dim() - 2)
    return _separable(img, _axis_vectors(in_h, out_h, False, img.device),
                      _axis_vectors(in_w, out_w, False, img.device))


def _cubic_kernel(x: np.ndarray, c: float = 0.75) -> np.ndarray:
    """Two-parameter cubic with B=0 (Mitchell-Netravali family): the
    reference's USE_BICUBIC configures IPP with (0, 0.75), "the value
    OpenCV is using" (Raisr.cpp:458-473, Raisr_globals.h:67-70)."""
    ax = np.abs(x)
    inner = (2.0 - c) * ax**3 + (c - 3.0) * ax**2 + 1.0
    outer = c * (-(ax**3) + 5.0 * ax**2 - 8.0 * ax + 4.0)
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _lanczos3_kernel(x: np.ndarray) -> np.ndarray:
    """3-lobe Lanczos: the reference's USE_LANCZOS configures IPP with
    lobes=3 (Raisr.cpp:464,474, Raisr_globals.h:72-75)."""
    x = np.asarray(x, np.float64)
    out = np.sinc(x) * np.sinc(x / 3.0)
    return np.where(np.abs(x) < 3.0, out, 0.0)


_MODES = {"bilinear": None, "cubic": (_cubic_kernel, 2), "lanczos": (_lanczos3_kernel, 3)}


def _axis_taps(in_size: int, out_size: int, mode: str):
    """Static per-axis resample taps: (idx [ntaps, out] border-clipped,
    weights [ntaps, out] normalized) for the half-pixel mapping."""
    kern, support = _MODES[mode]
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * (in_size / out_size) - 0.5
    lo = np.floor(src).astype(np.int64) - support + 1
    ntaps = 2 * support
    idx = np.stack([lo + t for t in range(ntaps)])  # [ntaps, out]
    wgt = kern(src[None, :] - idx)
    wgt = wgt / wgt.sum(axis=0, keepdims=True)  # partition of unity
    idx = np.clip(idx, 0, in_size - 1)  # border replicate
    return idx.astype(np.int32), wgt.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _tap_vectors(in_size: int, out_size: int, mode: str, device: torch.device):
    """`_axis_taps` on `device`: (idx [ntaps, out] int64, weights [ntaps, out])."""
    idx, wgt = _axis_taps(in_size, out_size, mode)
    return (torch.tensor(idx.astype(np.int64), device=device),
            torch.tensor(wgt, device=device))


def resample_upscale(
    img: torch.Tensor, out_h: int, out_w: int, mode: str
) -> torch.Tensor:
    """Separable resize of the last two dims in the selected mode (float32
    out, un-rounded). Each axis is a sum over its taps of gathered rows (then
    columns) times the tap's weights, accumulated from tap 0 up, the order
    raisr_tpu sums them in."""
    if mode == "bilinear":
        return bilinear_upscale(img, out_h, out_w)
    if mode not in _MODES:
        raise RaisrError(f"resize mode: {mode} is NOT supported.")
    in_h, in_w = img.shape[-2:]
    img = img.to(torch.float32)
    ridx, rw = _tap_vectors(in_h, out_h, mode, img.device)
    cidx, cw = _tap_vectors(in_w, out_w, mode, img.device)
    rows = img.index_select(-2, ridx[0]) * rw[0][:, None]
    for t in range(1, ridx.shape[0]):
        rows = rows + img.index_select(-2, ridx[t]) * rw[t][:, None]
    out = rows.index_select(-1, cidx[0]) * cw[0]
    for t in range(1, cidx.shape[0]):
        out = out + rows.index_select(-1, cidx[t]) * cw[t]
    return out


def cheap_upscale(
    img: torch.Tensor, out_h: int, out_w: int, bits: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Integer-valued cheap upscale (float32 holding ints in [0, 2^bits-1]).

    Works on [H, W] or any batch of planes [..., H, W], in every mode."""
    in_h, in_w = img.shape[-2:]
    if mode == "bilinear" and not (out_h == 2 * in_h and out_w == 2 * in_w):
        # non-2x: the exact-integer form where the ratio allows it (the 2x
        # slice-interleave form is exact too, and stays the 2x fast path);
        # with den 1.0 the same code is the float form
        exact = _plane_exact(in_h, in_w, out_h, out_w)
        rows = _axis_vectors(in_h, out_h, exact, img.device)
        cols = _axis_vectors(in_w, out_w, exact, img.device)
        out = _separable(img.to(torch.float32), rows, cols)
        return _rounded(out, rows[3] * cols[3], bits)
    out = resample_upscale(img, out_h, out_w, mode)
    max_full = float((1 << bits) - 1)
    return torch.clamp(torch.floor(out + 0.5), 0.0, max_full)


@functools.lru_cache(maxsize=32)
def _stacked_row_vectors(n_frames: int, in_h: int, pad_in: int, out_h: int,
                         pad_out: int, exact: bool, device: torch.device):
    """Row vectors of a guard-banded stack: one frame's vectors (the same
    float64 arithmetic as the per-frame path), guard rows replicating the
    frame's edge rows, tiled over the frames at the input period."""
    if exact:
        r0, r1, rw, rden = _axis_weights_exact(in_h, out_h)
    else:
        (r0, r1, rw), rden = _axis_weights(in_h, out_h), 1.0
    top = np.full(pad_out, pad_in, np.int32)  # frame row 0
    bot = np.full(pad_out, pad_in + in_h - 1, np.int32)  # frame last row
    zf = np.zeros(pad_out, np.float32)
    p_r0 = np.concatenate([top, r0 + pad_in, bot])
    p_r1 = np.concatenate([top, r1 + pad_in, bot])
    p_rw = np.concatenate([zf, rw, zf])
    offs = (np.arange(n_frames, dtype=np.int32) * (in_h + 2 * pad_in))[:, None]
    return _on(device, (p_r0[None, :] + offs).reshape(-1),
               (p_r1[None, :] + offs).reshape(-1), np.tile(p_rw, n_frames), rden)


def cheap_upscale_stacked(
    img: torch.Tensor,
    n_frames: int,
    in_h: int,
    pad_in: int,
    out_h: int,
    pad_out: int,
    out_w: int,
    bits: int,
) -> torch.Tensor:
    """Cheap upscale of a guard-banded vertical frame stack
    [n_frames * (in_h + 2*pad_in), W] whose frame rows are bit-identical to
    cheap_upscale() of each frame alone.

    The vertical index/weight vectors are computed ONCE for a single frame
    and tiled across the stack (see _stacked_row_vectors): computing them
    from global stacked row indices can differ in the last ulp at non-2x
    ratios and flip rare round-half-up ties, so tiling makes the identity
    structural. Guard rows replicate the frame's edge rows; they fill the
    inter-frame guard band only and never reach frame outputs."""
    period_in = in_h + 2 * pad_in
    if img.shape[-2] != n_frames * period_in:
        raise ValueError(
            f"stack of {img.shape[-2]} rows is not {n_frames} frames of "
            f"{in_h} + 2*{pad_in} rows"
        )
    in_w = img.shape[-1]
    exact = _plane_exact(in_h, in_w, out_h, out_w)
    rows = _stacked_row_vectors(n_frames, in_h, pad_in, out_h, pad_out, exact,
                                img.device)
    cols = _axis_vectors(in_w, out_w, exact, img.device)
    out = _separable(img.to(torch.float32), rows, cols)
    return _rounded(out, rows[3] * cols[3], bits)
