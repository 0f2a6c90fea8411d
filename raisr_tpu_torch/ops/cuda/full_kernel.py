"""Whole RAISR pass (ratio 2, float32 tier): the CUDA kernel's wrapper and
its plain PyTorch version.

Port of raisr_tpu/ops/pallas/full_kernel.py:raisr_pass_pallas_full. The
kernel is csrc/full_kernel.cu (two launches per pass, see its header). The
TPU tiling and precision knobs (tb2, rowbatch, cchunk, gchunk, hashloop,
mpack, ftrans, mxu_passes, p_split, i8, pcenter, interpret) have no meaning
here and are gone; the bf16, int8 and >8-bit fast tiers are later work.

`raisr_pass_full` runs the kernel on a CUDA tensor and the plain version on a
CPU tensor. There is no fallback: on CUDA it launches the kernel or raises.
`LAUNCHES` counts the passes that went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from raisr_tpu_torch.ops import hashing
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end, zone_height
from raisr_tpu_torch.ops.filter_apply import apply_filters_taps

LAUNCHES = 0  # passes run through the CUDA kernel (one per wrapper call)

_PIXEL_TYPES = 4
_FILTER_STRIDE = 128
_MAX_EDGES = 8


def raisr_pass_full_reference(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [864, 128] f32
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
) -> torch.Tensor:
    """Plain PyTorch version of one fused pass, on any device: gradients ->
    separable structure tensor -> hash buckets -> pixel phases -> 121-tap
    filter -> frame-aware pass epilogue. Same arguments as raisr_pass_full."""
    h, w = cheap.shape
    margin = patch_size // 2
    gx, gy = hashing.gradients(cheap)
    a, b, d = hashing.structure_tensor_separable(gx, gy, k1d, nf)
    buckets = hashing.hash_buckets(a, b, d, qstr, qcoh, qangle, qstrength, qcoherence)
    ptype = hashing.pixel_types(h, w, 2, margin, True, device=cheap.device)
    raw = apply_filters_taps(cheap, buckets * _PIXEL_TYPES + ptype, filters, patch_size)
    return _finish_pass(
        cheap, raw,
        min_val=min_val, max_val=max_val, blending=blending,
        loop_margin=margin + 1,
        col_end=processed_col_end(w, margin + 1, exact_edges),
        frame_h=frame_h, frame_pad=frame_pad, row0=row0, zone_h=zone_h,
    )


def _check(cheap, filters, k1d, qstr, qcoh, qangle, qstrength, qcoherence,
           patch_size):
    if cheap.dim() != 2 or cheap.dtype != torch.float32 or not cheap.is_contiguous():
        raise ValueError(
            f"cheap must be a contiguous 2-D float32 tensor, got "
            f"{cheap.dtype} {tuple(cheap.shape)}"
        )
    n_rows = qangle * qstrength * qcoherence * _PIXEL_TYPES
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


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * max(len(values), 1))(*(float(v) for v in values))


def raisr_pass_full(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [864, 128] f32
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
) -> torch.Tensor:
    """One complete RAISR pass (ratio 2), fused: the CUDA kernel for a CUDA
    tensor, raisr_pass_full_reference for a CPU tensor.

    k1d, qstr and qcoh are sequences of floats (the edges taken from the
    bank's float32 arrays); they are passed to the kernel as float32."""
    kw = dict(
        k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
        qstrength=qstrength, qcoherence=qcoherence, patch_size=patch_size,
        min_val=min_val, max_val=max_val, blending=blending,
        exact_edges=exact_edges, frame_h=frame_h, frame_pad=frame_pad,
        row0=row0, zone_h=zone_h,
    )
    if cheap.device.type == "cpu":
        return raisr_pass_full_reference(cheap, filters, **kw)
    if cheap.device.type != "cuda":
        raise ValueError(f"raisr_pass_full runs on cpu or cuda, not {cheap.device}")
    _check(cheap, filters, k1d, qstr, qcoh, qangle, qstrength, qcoherence,
           patch_size)
    if blending not in (1, 2):
        raise ValueError(f"blending must be 1 or 2, got {blending}")

    from raisr_tpu_torch.ops.cuda._build import load_library

    lib = load_library()
    h, w = cheap.shape
    raw = torch.empty_like(cheap)
    out = torch.empty_like(cheap)
    dev = cheap.device.index if cheap.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(cheap.device).cuda_stream
    k1d_c, qstr_c, qcoh_c = _floats(k1d), _floats(qstr), _floats(qcoh)
    err = lib.raisr_full_hash_filter(
        cheap.data_ptr(), filters.data_ptr(), raw.data_ptr(), h, w,
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
    global LAUNCHES
    LAUNCHES += 1
    return out
