"""Whole RAISR pass (float32 and 8-bit bfloat16 tiers), 4-phase and
single-phase: the CUDA kernel's wrappers and their plain PyTorch version.

Port of raisr_tpu/ops/pallas/full_kernel.py:raisr_pass_pallas_full (ratio 2,
4 pixel phases) and raisr_pass_pallas_full_single (single-phase banks, e.g.
ratio 1.5). One kernel, csrc/full_kernel.cu, serves both (two launches per
pass, see its header); the phase count is its only difference. The TPU tiling
and precision knobs (tb2, ostack, rowbatch, cchunk, gchunk, hashloop, mpack,
ftrans, mxu_passes, p_split, i8, pcenter, interpret) have no meaning here and
are gone. The tier is the bank's dtype: a float32 bank is the float32 tier; a
bfloat16 bank from `round_bf16_error_diffused` is the bf16 tier at 8 bits
(the TPU's mxu_passes=1: error-diffused bf16 filters, bf16 patches, exact for
8-bit values, float32 sums). The int8 and >8-bit bf16 tiers are later work.

`raisr_pass_full` and `raisr_pass_full_single` run the kernel on a CUDA
tensor and the plain version on a CPU tensor. There is no fallback: on CUDA
they launch the kernel or raise. `LAUNCHES` and `SINGLE_LAUNCHES` count the
passes that went through the kernel with a float32 bank, 4-phase and
single-phase; `BF16_LAUNCHES` and `SINGLE_BF16_LAUNCHES` those with a bfloat16
bank.
"""

from __future__ import annotations

import torch

from raisr_tpu_torch.ops.cuda.filter_kernel import (
    FILTER_STRIDE,
    _check_bank,
    _check_hash_args,
    _check_phases,
    _check_plane,
    _device_and_stream,
    _launch_hash_filter,
    apply_filters_reference,
    hash_buckets_reference,
)
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end, zone_height

LAUNCHES = 0  # 4-phase passes, float32 bank
SINGLE_LAUNCHES = 0  # single-phase passes, float32 bank
BF16_LAUNCHES = 0  # 4-phase passes, bfloat16 bank
SINGLE_BF16_LAUNCHES = 0  # single-phase passes, bfloat16 bank

_N_TAPS = 121


def round_bf16_error_diffused(filters: torch.Tensor) -> torch.Tensor:
    """A bank's taps rounded to bfloat16 with error diffusion along each row:
    the bank of the bf16 tier, prepared once on the host side.

    Counterpart of raisr_tpu's _round_bf16_error_diffused
    (ops/pallas/full_kernel.py:40-65), and bit-identical to it: per row, over
    taps 0..120 in order, q = bf16(f + carry) (round to nearest even), then
    carry = (carry + f) - q, all in float32. Carrying the residual keeps the
    sum of the rounding errors, which the DC content of a patch multiplies,
    under one ulp of a tap. Taps 121..127 stay 0. Returns a contiguous
    bfloat16 [rows, 128] tensor on the bank's device."""
    f = filters.to(torch.float32)
    out = torch.zeros((f.shape[0], FILTER_STRIDE), dtype=torch.bfloat16, device=f.device)
    carry = torch.zeros(f.shape[0], dtype=torch.float32, device=f.device)
    for k in range(_N_TAPS):
        q = (f[:, k] + carry).to(torch.bfloat16)
        carry = (carry + f[:, k]) - q.to(torch.float32)
        out[:, k] = q
    return out


def raisr_pass_full_reference(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [216 * pixel_types, 128] f32 or bf16
    *,
    k1d,
    nf: float,
    qstr,
    qcoh,
    qangle: int = 24,
    qstrength: int = 3,
    qcoherence: int = 3,
    patch_size: int = 11,
    min_val: int = 16,
    max_val: int = 235,
    blending: int = 2,
    exact_edges: bool = True,
    frame_h: int = 0,
    frame_pad: int = 0,
    row0: int = 0,
    zone_h: int = 0,
    pixel_types: int = 4,
) -> torch.Tensor:
    """Plain PyTorch version of one fused pass, on any device: the plain hash
    and filter apply of ops/cuda/filter_kernel.py (gradients -> separable
    structure tensor -> hash buckets -> (pixel phases) -> 121-tap filter),
    then the frame-aware pass epilogue. Same arguments as raisr_pass_full; a
    bfloat16 bank is widened to float32 (exact)."""
    w = cheap.shape[1]
    margin = patch_size // 2
    buckets = hash_buckets_reference(
        cheap, k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
        qstrength=qstrength, qcoherence=qcoherence)
    raw = apply_filters_reference(cheap, buckets, filters, patch_size=patch_size,
                                  pixel_types=pixel_types, patch_margin=margin)
    return _finish_pass(
        cheap, raw,
        min_val=min_val, max_val=max_val, blending=blending,
        loop_margin=margin + 1,
        col_end=processed_col_end(w, margin + 1, exact_edges),
        frame_h=frame_h, frame_pad=frame_pad, row0=row0, zone_h=zone_h,
    )


def raisr_pass_full_single_reference(cheap, filters, **kw) -> torch.Tensor:
    """Plain PyTorch version of the single-phase pass ([216, 128] bank):
    raisr_pass_full_reference with pixel_types=1."""
    return raisr_pass_full_reference(cheap, filters, pixel_types=1, **kw)


def _check(cheap, filters, k1d, qstr, qcoh, qangle, qstrength, qcoherence,
           patch_size, blending, pixel_types):
    _check_phases(pixel_types)
    _check_plane(cheap)
    _check_bank(filters, cheap.device, qangle * qstrength * qcoherence * pixel_types,
                (torch.float32, torch.bfloat16))
    _check_hash_args(k1d, qstr, qcoh, qstrength, qcoherence, patch_size)
    if blending not in (1, 2):
        raise ValueError(f"blending must be 1 or 2, got {blending}")


def raisr_pass_full(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [216 * pixel_types, 128] f32 or bf16
    *,
    k1d,
    nf: float,
    qstr,
    qcoh,
    qangle: int = 24,
    qstrength: int = 3,
    qcoherence: int = 3,
    patch_size: int = 11,
    min_val: int = 16,
    max_val: int = 235,
    blending: int = 2,
    exact_edges: bool = True,
    frame_h: int = 0,  # >0: plane is a guard-banded vertical frame stack
    frame_pad: int = 0,
    row0: int = 0,  # global row of plane row 0 (row stripes)
    zone_h: int = 0,  # >0: global frame height for zone tests (stripes)
    pixel_types: int = 4,  # 4: ratio-2 bank [864, 128]; 1: single-phase [216, 128]
) -> torch.Tensor:
    """One complete RAISR pass, fused: the CUDA kernel for a CUDA tensor,
    raisr_pass_full_reference for a CPU tensor. `filters` is float32, or
    bfloat16 for the bf16 tier (round_bf16_error_diffused).

    k1d, qstr and qcoh are sequences of floats (the edges taken from the
    bank's float32 arrays); they are passed to the kernel as float32."""
    kw = dict(
        k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
        qstrength=qstrength, qcoherence=qcoherence, patch_size=patch_size,
        min_val=min_val, max_val=max_val, blending=blending,
        exact_edges=exact_edges, frame_h=frame_h, frame_pad=frame_pad,
        row0=row0, zone_h=zone_h, pixel_types=pixel_types,
    )
    if cheap.device.type == "cpu":
        return raisr_pass_full_reference(cheap, filters, **kw)
    if cheap.device.type != "cuda":
        raise ValueError(f"raisr_pass_full runs on cpu or cuda, not {cheap.device}")
    _check(cheap, filters, k1d, qstr, qcoh, qangle, qstrength, qcoherence,
           patch_size, blending, pixel_types)

    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    raw = torch.empty_like(cheap)
    out = torch.empty_like(cheap)
    _launch_hash_filter(cheap, filters, raw, pixel_types, k1d=k1d, nf=nf, qstr=qstr,
                        qcoh=qcoh, qangle=qangle, qstrength=qstrength,
                        qcoherence=qcoherence)
    dev, stream = _device_and_stream(cheap)
    err = load_library().raisr_full_epilogue(
        cheap.data_ptr(), raw.data_ptr(), out.data_ptr(), h, w,
        float(min_val), float(max_val), int(blending),
        processed_col_end(w, patch_size // 2 + 1, exact_edges),
        frame_h, frame_pad, row0, zone_height(h, frame_h, zone_h), dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_full_epilogue launch failed: cudaError {err}")
    global LAUNCHES, SINGLE_LAUNCHES, BF16_LAUNCHES, SINGLE_BF16_LAUNCHES
    bf16 = filters.dtype == torch.bfloat16
    if pixel_types == 1 and bf16:
        SINGLE_BF16_LAUNCHES += 1
    elif pixel_types == 1:
        SINGLE_LAUNCHES += 1
    elif bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def raisr_pass_full_single(cheap, filters, **kw) -> torch.Tensor:
    """One complete RAISR pass for a single-phase bank ([216, 128] float32 or
    bfloat16; ratio != 2, the reference's gUsePixelType == false,
    Raisr.cpp:1477-1480): raisr_pass_full with pixel_types=1, counted in
    SINGLE_LAUNCHES (SINGLE_BF16_LAUNCHES for a bfloat16 bank)."""
    return raisr_pass_full(cheap, filters, pixel_types=1, **kw)
