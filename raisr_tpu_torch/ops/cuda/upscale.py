"""The serving step's glue in one CUDA launch (csrc/upscale.cu), and its
plain PyTorch version.

The counterpart of what XLA fuses inside raisr_tpu's one-jit serving step
(raisr_tpu/engine.py process_batch_device) next to the Pallas pass: the
unpack astype(float32), the guard-band pad and reshape of the frame stack
(raisr_tpu/ops/pipeline.py process_plane_y_batch), the cheap upscale
(raisr_tpu/ops/resize.py cheap_upscale, cheap_upscale_stacked), the chroma
batch upscale (process_plane_uv_batch) and the repack astype(dtype). Eager
PyTorch runs that chain (`unpack_planes`, `guard_band_stack`,
`ops/resize.py`, `pack_planes`, all here or there unchanged) as one memory
pass an op; the kernel reads the packed frames once and writes the stack a
fused pass reads, or the packed chroma planes, once.

  - `cheap_upscale_stack`: the float32 guard-banded stack of pass 1's input
    from [N, H, W] frames (uint8, uint16 or float32; the guard band is
    formed on the fly), or mode 2's inter-pass upscale of pass 1's float32
    stack; form "1x" (unpack and guard band only), "2x" or "vec".
  - `cheap_upscale_planes`: a batch of chroma planes, packed in and packed
    out (or float32 out); form "2x" or "vec".
Each runs the kernel on a CUDA tensor and its plain version
(`*_reference`) on a CPU tensor. There is no fallback: on CUDA it launches
or raises. `UPSCALE_LAUNCHES[form]` counts the kernel's launches.

Routes that keep the PyTorch glue, by configuration: the cubic and lanczos
resizes, process_plane_y_batch's non-stackable loop (and the per-frame
process_plane_y under it), the sharded stripes (parallel/sharding.py),
training (train/trainer.py), and every CPU run. The "vec" form's index and
weight vectors are the resize's own, built on the device at the first call
at a shape (ops/resize.py), so run a shape once before capturing it in a
CUDA graph.
"""

from __future__ import annotations

import math

import torch

from raisr_tpu_torch.ops.cuda.filter_kernel import _device_and_stream
from raisr_tpu_torch.ops.resize import (
    _axis_vectors,
    _plane_exact,
    _stacked_row_vectors,
    cheap_upscale,
    cheap_upscale_stacked,
)

# launches of the kernel, by form
UPSCALE_LAUNCHES = {"1x": 0, "2x": 0, "vec": 0}
_FORM_CODE = {"1x": 0, "2x": 1, "vec": 2}
# the element types the kernel reads, and their codes in csrc/upscale.cu
_TYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}


def unpack_planes(t: torch.Tensor) -> torch.Tensor:
    """Packed integer planes (uint8, uint16) -> float32, on their device.
    uint16 has few kernels on CUDA, so it is read through its int16 view (a
    reinterpretation, no copy) and widened in int32."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.float32)


def pack_planes(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integer-valued float32 planes in [0, 2^bits) -> `dtype` (uint8 or
    uint16; uint16 written through int32 and an int16 view)."""
    if dtype == torch.uint16:
        return x.to(torch.int32).to(torch.int16).view(torch.uint16)
    return x.to(dtype)


def guard_band_stack(batch: torch.Tensor, pad: int) -> torch.Tensor:
    """[N, H, W] -> [N*(H+2*pad), W]: each frame replicate-padded with `pad`
    rows above and below, the frames stacked vertically (the plane that one
    fused launch per pass takes, with frame_h=H and frame_pad=pad)."""
    n, h, w = batch.shape
    x = torch.cat(
        [batch[:, :1].expand(n, pad, w), batch, batch[:, -1:].expand(n, pad, w)], dim=1
    )
    return x.reshape(n * (h + 2 * pad), w)


def _stack_form(in_h: int, in_w: int, out_h: int, out_w: int) -> str:
    if (out_h, out_w) == (in_h, in_w):
        return "1x"
    if (out_h, out_w) == (2 * in_h, 2 * in_w):
        return "2x"
    return "vec"


def cheap_upscale_stack_reference(
    x: torch.Tensor, n_frames: int, in_h: int, pad: int, out_h: int, out_w: int, bits: int
) -> torch.Tensor:
    """Plain version of cheap_upscale_stack, on any device: the frames
    unpacked and guard-banded (`guard_band_stack`), then nothing at 1x, the
    whole-stack 2x upscale, or the stacked resize with per-frame row
    vectors, as process_plane_y_batch composed them."""
    if x.dim() == 3:
        x = guard_band_stack(unpack_planes(x), pad)
    form = _stack_form(in_h, x.shape[-1], out_h, out_w)
    if form == "1x":
        return x
    if form == "2x":
        return cheap_upscale(x, 2 * x.shape[0], out_w, bits)
    return cheap_upscale_stacked(x, n_frames, in_h, pad, out_h, pad * out_h // in_h, out_w,
                                 bits)


def cheap_upscale_planes_reference(
    planes: torch.Tensor, out_h: int, out_w: int, bits: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of cheap_upscale_planes, on any device: unpack, the
    bilinear cheap upscale of each plane, repack."""
    return pack_planes(cheap_upscale(unpack_planes(planes), out_h, out_w, bits), out_dtype)


def _check_input(x: torch.Tensor, name: str, dims: tuple[int, ...]) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _TYPE_CODE or x.dim() not in dims or min(x.shape, default=0) <= 0:
        raise ValueError(
            f"{name} takes a non-empty uint8, uint16 or float32 tensor of "
            f"{' or '.join(map(str, dims))} dims, got {x.dtype} {tuple(x.shape)}"
        )


def _launch(x: torch.Tensor, out: torch.Tensor, form: str, planes: int, frames: int,
            h: int, pad: int, vectors, bits: int) -> None:
    """One kernel launch on x's device and current stream; raises on a
    refused launch. `vectors` is the "vec" form's (rows, cols), each
    (idx0, idx1, weight, den) on the device, else None."""
    from raisr_tpu_torch.ops.cuda._build import load_library

    if vectors is None:
        ptrs, rden, cden = (None,) * 6, 1.0, 1.0
    else:
        (r0, r1, rw, rden), (c0, c1, cw, cden) = vectors
        ptrs = tuple(t.data_ptr() for t in (r0, r1, rw, c0, c1, cw))
    dev, stream = _device_and_stream(x)
    err = load_library().raisr_cheap_upscale(
        x.data_ptr(), _TYPE_CODE[x.dtype], out.data_ptr(), _TYPE_CODE[out.dtype],
        _FORM_CODE[form], planes, frames, h, x.shape[-1], pad, out.shape[-2],
        out.shape[-1], *ptrs, float(rden), float(cden), float((1 << bits) - 1), dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_cheap_upscale launch failed: cudaError {err}")
    UPSCALE_LAUNCHES[form] += 1


def cheap_upscale_stack(
    x: torch.Tensor, n_frames: int, in_h: int, pad: int, out_h: int, out_w: int, bits: int
) -> torch.Tensor:
    """The float32 guard-banded stack a fused pass reads,
    [n_frames * (out_h + 2 * out_pad), out_w] with out_pad = pad * out_h //
    in_h, whose frame rows equal the cheap upscale of each frame alone.

    `x` is [n_frames, in_h, W] frames (uint8, uint16 or integer-valued
    float32), guard-banded with `pad` replicated rows about each frame on the
    way in; or a float32 stack [n_frames * (in_h + 2 * pad), W] that has its
    guard band already (mode 2's pass-1 output). out (out_h, out_w) equal to
    (in_h, W) is the stack alone ("1x"); twice it, the 2x form; any other
    size, the stacked resize's vectors ("vec"). The kernel for a CUDA
    tensor, cheap_upscale_stack_reference for a CPU tensor; the two agree
    bit for bit."""
    if x.device.type == "cpu":
        return cheap_upscale_stack_reference(x, n_frames, in_h, pad, out_h, out_w, bits)
    _check_input(x, "cheap_upscale_stack", (2, 3))
    w = x.shape[-1]
    period = in_h + 2 * pad
    if x.dim() == 3:
        if tuple(x.shape[:2]) != (n_frames, in_h):
            raise ValueError(f"frames {tuple(x.shape)} are not {n_frames} of {in_h} rows")
        frames, h, gpad = n_frames, in_h, pad
    else:
        if x.dtype != torch.float32 or x.shape[0] != n_frames * period:
            raise ValueError(f"stack {x.dtype} {tuple(x.shape)} is not float32 "
                             f"{n_frames} frames of {in_h} + 2*{pad} rows")
        frames, h, gpad = 1, x.shape[0], 0
    x = x.contiguous()
    form = _stack_form(in_h, w, out_h, out_w)
    out_pad = pad * out_h // in_h
    vectors = None
    if form == "vec":
        exact = _plane_exact(in_h, w, out_h, out_w)
        vectors = (_stacked_row_vectors(n_frames, in_h, pad, out_h, out_pad, exact, x.device),
                   _axis_vectors(w, out_w, exact, x.device))
    out = torch.empty((n_frames * (out_h + 2 * out_pad), out_w), dtype=torch.float32,
                      device=x.device)
    _launch(x, out, form, 1, frames, h, gpad, vectors, bits)
    return out


def cheap_upscale_planes(
    planes: torch.Tensor, out_h: int, out_w: int, bits: int,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The bilinear cheap upscale of each plane of [..., H, W] (uint8,
    uint16 or integer-valued float32) to [..., out_h, out_w] of `out_dtype`,
    each plane with its own edge clamp: chroma packed in and packed out. The
    kernel for a CUDA tensor (one launch; float32 out and pack_planes where
    out_dtype is neither float32 nor the planes' type),
    cheap_upscale_planes_reference for a CPU tensor; the two agree bit for
    bit."""
    if planes.device.type == "cpu":
        return cheap_upscale_planes_reference(planes, out_h, out_w, bits, out_dtype)
    _check_input(planes, "cheap_upscale_planes", (2, 3))
    planes = planes.contiguous()
    lead = tuple(planes.shape[:-2])
    in_h, in_w = planes.shape[-2:]
    form = "2x" if (out_h, out_w) == (2 * in_h, 2 * in_w) else "vec"
    vectors = None
    if form == "vec":
        exact = _plane_exact(in_h, in_w, out_h, out_w)
        vectors = (_axis_vectors(in_h, out_h, exact, planes.device),
                   _axis_vectors(in_w, out_w, exact, planes.device))
    kernel_dtype = out_dtype if out_dtype == planes.dtype else torch.float32
    out = torch.empty(lead + (out_h, out_w), dtype=kernel_dtype, device=planes.device)
    _launch(planes, out, form, math.prod(lead), 1, in_h, 0, vectors, bits)
    return out if kernel_dtype == out_dtype else pack_planes(out, out_dtype)
