"""Whole RAISR pass (float32 tier), 4-phase and single-phase: the CUDA
kernel's wrappers and their plain PyTorch version.

Port of raisr_tpu/ops/pallas/full_kernel.py:raisr_pass_pallas_full (ratio 2,
4 pixel phases) and raisr_pass_pallas_full_single (single-phase banks, e.g.
ratio 1.5). One kernel, csrc/full_kernel.cu, serves both (two launches per
pass, see its header); the phase count is its only difference. The TPU tiling
and precision knobs (tb2, ostack, rowbatch, cchunk, gchunk, hashloop, mpack,
ftrans, mxu_passes, p_split, i8, pcenter, interpret) have no meaning here and
are gone; the bf16, int8 and >8-bit fast tiers are later work.

`raisr_pass_full` and `raisr_pass_full_single` run the kernel on a CUDA
tensor and the plain version on a CPU tensor. There is no fallback: on CUDA
they launch the kernel or raise. `LAUNCHES` and `SINGLE_LAUNCHES` count the
passes that went through the kernel, 4-phase and single-phase.
"""

from __future__ import annotations

import ctypes

import torch

from raisr_tpu_torch.ops import hashing
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end, zone_height
from raisr_tpu_torch.ops.filter_apply import apply_filters_taps

LAUNCHES = 0  # 4-phase passes run through the CUDA kernel
SINGLE_LAUNCHES = 0  # single-phase passes run through the CUDA kernel

_PHASES = (4, 1)  # bank rows per hash bucket the kernel takes
_FILTER_STRIDE = 128
_MAX_EDGES = 8


def raisr_pass_full_reference(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [216 * pixel_types, 128] f32
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
    """Plain PyTorch version of one fused pass, on any device: gradients ->
    separable structure tensor -> hash buckets -> (pixel phases) -> 121-tap
    filter -> frame-aware pass epilogue. Same arguments as raisr_pass_full."""
    h, w = cheap.shape
    margin = patch_size // 2
    gx, gy = hashing.gradients(cheap)
    a, b, d = hashing.structure_tensor_separable(gx, gy, k1d, nf)
    buckets = hashing.hash_buckets(a, b, d, qstr, qcoh, qangle, qstrength, qcoherence)
    if pixel_types == 4:
        buckets = buckets * 4 + hashing.pixel_types(h, w, 2, margin, True,
                                                    device=cheap.device)
    raw = apply_filters_taps(cheap, buckets, filters, patch_size)
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
    if pixel_types not in _PHASES:
        raise ValueError(f"the CUDA kernel takes 4 or 1 pixel types, got {pixel_types}")
    if cheap.dim() != 2 or cheap.dtype != torch.float32 or not cheap.is_contiguous():
        raise ValueError(
            f"cheap must be a contiguous 2-D float32 tensor, got "
            f"{cheap.dtype} {tuple(cheap.shape)}"
        )
    n_rows = qangle * qstrength * qcoherence * pixel_types
    if (
        filters.device != cheap.device
        or filters.dtype != torch.float32
        or not filters.is_contiguous()
        or tuple(filters.shape) != (n_rows, _FILTER_STRIDE)
        or filters.data_ptr() % 16
    ):
        raise ValueError(
            f"filters must be a contiguous, 16-byte aligned float32 "
            f"[{n_rows}, {_FILTER_STRIDE}] tensor on {cheap.device}, got "
            f"{filters.dtype} {tuple(filters.shape)} on {filters.device}"
        )
    if patch_size != 11 or len(k1d) != 11:
        raise ValueError(f"the CUDA kernel takes patch_size 11, got {patch_size}")
    if len(qstr) != qstrength - 1 or len(qcoh) != qcoherence - 1:
        raise ValueError("qstr/qcoh must hold qstrength-1 / qcoherence-1 edges")
    if len(qstr) > _MAX_EDGES or len(qcoh) > _MAX_EDGES:
        raise ValueError(f"at most {_MAX_EDGES} strength/coherence edges")
    if blending not in (1, 2):
        raise ValueError(f"blending must be 1 or 2, got {blending}")


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * max(len(values), 1))(*(float(v) for v in values))


def raisr_pass_full(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [216 * pixel_types, 128] f32
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
    raisr_pass_full_reference for a CPU tensor.

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

    lib = load_library()
    h, w = cheap.shape
    raw = torch.empty_like(cheap)
    out = torch.empty_like(cheap)
    dev = cheap.device.index if cheap.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(cheap.device).cuda_stream
    k1d_c, qstr_c, qcoh_c = _floats(k1d), _floats(qstr), _floats(qcoh)
    err = lib.raisr_full_hash_filter(
        cheap.data_ptr(), filters.data_ptr(), raw.data_ptr(), h, w, pixel_types,
        ctypes.addressof(k1d_c), float(nf),
        ctypes.addressof(qstr_c), len(qstr), ctypes.addressof(qcoh_c), len(qcoh),
        qangle, qstrength, qcoherence, float(qangle / hashing.PI), dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_full_hash_filter launch failed: cudaError {err}")
    err = lib.raisr_full_epilogue(
        cheap.data_ptr(), raw.data_ptr(), out.data_ptr(), h, w,
        float(min_val), float(max_val), int(blending),
        processed_col_end(w, patch_size // 2 + 1, exact_edges),
        frame_h, frame_pad, row0, zone_height(h, frame_h, zone_h), dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_full_epilogue launch failed: cudaError {err}")
    global LAUNCHES, SINGLE_LAUNCHES
    if pixel_types == 1:
        SINGLE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def raisr_pass_full_single(cheap, filters, **kw) -> torch.Tensor:
    """One complete RAISR pass for a single-phase bank ([216, 128] float32;
    ratio != 2, the reference's gUsePixelType == false, Raisr.cpp:1477-1480):
    raisr_pass_full with pixel_types=1, counted in SINGLE_LAUNCHES."""
    return raisr_pass_full(cheap, filters, pixel_types=1, **kw)
