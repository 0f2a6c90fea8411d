"""Whole-frame functional RAISR pipeline (one pass, and the pass loop).

Port of raisr_tpu/ops/pipeline.py. Each pass is a function over the whole
plane (the reference's per-segment hot loop, Library/Raisr.cpp:890-1289).
The pass epilogue and its zone semantics (processed_col_end, _finish_pass)
live in ops/epilogue.py, which the fused kernel's wrapper shares.

Backends: "pallas" runs the fused pass (ops/cuda/full_kernel.py: the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor); "taps" is the
unfused reference formulation in plain PyTorch on any device. Where raisr_tpu
uses `vmap`, this module loops over the frames.
"""

from __future__ import annotations

import dataclasses

import torch

from raisr_tpu_torch.config import RaisrConfig, RaisrError
from raisr_tpu_torch.model.gaussian import (
    gaussian_kernel_1d,
    gaussian_weights,
    normalization_factor,
)
from raisr_tpu_torch.model.loader import RaisrModel
from raisr_tpu_torch.ops import hashing
from raisr_tpu_torch.ops.cuda.full_kernel import raisr_pass_full
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end
from raisr_tpu_torch.ops.filter_apply import apply_filters_taps
from raisr_tpu_torch.ops.resize import cheap_upscale


@dataclasses.dataclass(frozen=True)
class PassStatics:
    """Static (hashable) parameters of one RAISR pass."""

    qangle: int
    qstrength: int
    qcoherence: int
    patch_size: int
    pixel_types: int
    use_pixel_type: bool
    ratio_int: int
    bits: int
    min_val: int
    max_val: int
    blending: int
    exact_edges: bool
    backend: str  # "taps" | "pallas"
    # per-pass (qstr, qcoh) bin edges as python floats (the bank's float32
    # values): the fused kernel's launch arguments and the taps hash's edges
    bank_edges: tuple = ()
    # cheap-upscale resampler (RaisrConfig.resize_mode); only bilinear is ported
    resize_mode: str = "bilinear"

    @property
    def patch_margin(self) -> int:
        return self.patch_size >> 1

    @property
    def loop_margin(self) -> int:
        return (self.patch_size >> 1) + 1


def raisr_pass(
    cheap: torch.Tensor,
    filters: torch.Tensor,
    statics: PassStatics,
    pass_idx: int = 0,
    frame_h: int = 0,
    frame_pad: int = 0,
) -> torch.Tensor:
    """One RAISR pass over an integer-valued float32 plane. Returns the
    integer-valued output plane (float32). The pass's bin edges come from
    statics.bank_edges[pass_idx] (raisr_tpu also passes them as arrays).

    frame_h > 0: the plane is a vertical stack of frame_h-row frames
    separated by 2*frame_pad guard rows; zone masks are applied per frame
    (batched engine mode, see process_plane_y_batch)."""
    h, w = cheap.shape
    s = statics
    qstr, qcoh = s.bank_edges[pass_idx]

    if s.backend == "pallas":
        if not s.use_pixel_type:
            raise RaisrError(
                "the fused CUDA pass takes ratio-2 (4-phase) banks only; the "
                "single-phase (1.5x) kernel is ROADMAP B5."
            )
        return raisr_pass_full(
            cheap,
            filters,
            k1d=tuple(float(v) for v in gaussian_kernel_1d(s.patch_size)),
            nf=normalization_factor(s.bits),
            qstr=qstr,
            qcoh=qcoh,
            qangle=s.qangle,
            qstrength=s.qstrength,
            qcoherence=s.qcoherence,
            patch_size=s.patch_size,
            min_val=s.min_val,
            max_val=s.max_val,
            blending=int(s.blending),
            exact_edges=s.exact_edges,
            frame_h=frame_h,
            frame_pad=frame_pad,
        )
    if s.backend != "taps":
        raise RaisrError(f"backend {s.backend!r} is not ported to raisr_tpu_torch.")

    gx, gy = hashing.gradients(cheap)
    weights = gaussian_weights(s.patch_size, s.bits)
    a, b, d = hashing.structure_tensor(gx, gy, weights)
    buckets = hashing.hash_buckets(
        a, b, d, qstr, qcoh, s.qangle, s.qstrength, s.qcoherence
    )
    ptype = hashing.pixel_types(
        h, w, s.ratio_int, s.patch_margin, s.use_pixel_type, device=cheap.device
    )
    raw = apply_filters_taps(cheap, buckets * s.pixel_types + ptype, filters, s.patch_size)
    return _finish_pass(
        cheap, raw,
        min_val=s.min_val, max_val=s.max_val, blending=int(s.blending),
        loop_margin=s.loop_margin,
        col_end=processed_col_end(w, s.loop_margin, s.exact_edges),
        frame_h=frame_h, frame_pad=frame_pad,
    )


_LATER_TIERS = {
    "bfloat16": "the bf16 tier is ROADMAP B2 (B4 at 10/16-bit)",
    "bfloat16_exact": "the bf16 exact-patch tier is ROADMAP B2/B4",
    "int8": "the int8-pair tier is ROADMAP B3",
}


def pass_statics(cfg: RaisrConfig, model: RaisrModel, backend: str) -> PassStatics:
    """Static pass parameters. The fused backend runs the float32 tier only;
    the taps backend ignores the tier, as in raisr_tpu."""
    if backend == "pallas" and cfg.dtype in _LATER_TIERS:
        raise RaisrError(
            f"dtype {cfg.dtype} is not ported to the CUDA kernel yet: "
            f"{_LATER_TIERS[cfg.dtype]}."
        )
    bank_edges = tuple(
        (tuple(float(v) for v in b.qstr), tuple(float(v) for v in b.qcoh))
        for b in model.banks
    )
    return PassStatics(
        qangle=model.qangle,
        qstrength=model.qstrength,
        qcoherence=model.qcoherence,
        patch_size=model.patch_size,
        pixel_types=model.banks[0].pixel_types,
        use_pixel_type=cfg.use_pixel_type,
        ratio_int=int(cfg.ratio),
        bits=cfg.bits,
        min_val=cfg.min_val,
        max_val=cfg.max_val,
        blending=int(cfg.blending),
        exact_edges=cfg.exact_edges,
        backend=backend,
        bank_edges=bank_edges,
        resize_mode=cfg.resize_mode,
    )


def process_plane_y(
    lr: torch.Tensor,
    bank_filters: tuple[torch.Tensor, ...],
    statics: PassStatics,
    passes: int,
    two_pass_mode: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Full multi-pass luma pipeline (RNLProcess CPU path, Raisr.cpp:1294-1397).

    two_pass_mode selects which pass performs the cheap upscale
    ((passIdx+1) == gTwoPassMode, Raisr.cpp:945): mode 1 upscales before pass
    1 (sharpening second pass at HR); mode 2 runs pass 1 at LR size (denoise)
    and upscales before pass 2. Pass outputs are integer-valued, which is the
    inter-pass quantization of gIntermediateY (Raisr.cpp:918-927)."""
    x = lr.to(torch.float32)
    for pass_idx in range(passes):
        if pass_idx + 1 == two_pass_mode:
            cheap = cheap_upscale(x, out_h, out_w, statics.bits,
                                  mode=statics.resize_mode)
        else:
            cheap = x
        x = raisr_pass(cheap, bank_filters[pass_idx], statics, pass_idx)
    return x


def guard_band_stack(batch: torch.Tensor, pad: int) -> torch.Tensor:
    """[N, H, W] -> [N*(H+2*pad), W]: each frame replicate-padded with `pad`
    rows above and below, the frames stacked vertically (the plane that one
    fused launch per pass takes, with frame_h=H and frame_pad=pad)."""
    n, h, w = batch.shape
    x = torch.cat(
        [batch[:, :1].expand(n, pad, w), batch, batch[:, -1:].expand(n, pad, w)], dim=1
    )
    return x.reshape(n * (h + 2 * pad), w)


def process_plane_y_batch(
    batch_lr: torch.Tensor,  # [N, H, W]
    bank_filters: tuple[torch.Tensor, ...],
    statics: PassStatics,
    passes: int,
    two_pass_mode: int,
    out_h: int,
    out_w: int,
) -> torch.Tensor:
    """Batched luma pipeline: N frames ride ONE kernel launch per pass as a
    guard-banded vertical stack.

    Each frame is replicate-padded with guard rows and the fused pass applies
    its zone masks per frame (raisr_pass frame_h/frame_pad), so the result is
    exactly process_plane_y of each frame: the guard band exceeds the one-pass
    support radius of ~8 rows (5 patch + 1 tensor + 1 gradient + 1 census).
    Frames stay stacked across passes. Any other backend or ratio loops over
    the frames."""
    n, h, w = batch_lr.shape
    s = statics
    # LR guard: 6 rows covers the resize support; when pass 1 runs at LR
    # size (mode 2) it needs the full processing support at LR scale
    lr_pad = 12 if (passes == 2 and two_pass_mode == 2) else 6
    stackable = (
        s.backend == "pallas"
        and s.use_pixel_type
        and s.resize_mode == "bilinear"
        and out_h == 2 * h
        and out_w == 2 * w
    )
    if not stackable:
        return torch.stack([
            process_plane_y(
                y, bank_filters, statics, passes, two_pass_mode, out_h, out_w
            )
            for y in batch_lr
        ])

    x = guard_band_stack(batch_lr.to(torch.float32), lr_pad)
    cur_fh, cur_pad = h, lr_pad

    for pass_idx in range(passes):
        if pass_idx + 1 == two_pass_mode:
            # 2x: the slice-based resize has fixed per-row weights, so the
            # whole-stack upscale equals the per-frame one
            cheap = cheap_upscale(x, 2 * x.shape[0], out_w, s.bits)
            cur_fh, cur_pad = out_h, 2 * cur_pad
        else:
            cheap = x
        x = raisr_pass(
            cheap,
            bank_filters[pass_idx],
            statics,
            pass_idx,
            frame_h=cur_fh,
            frame_pad=cur_pad,
        )
    x = x.reshape(n, cur_fh + 2 * cur_pad, out_w)
    return x[:, cur_pad: cur_pad + cur_fh, :]


def process_plane_uv(
    lr: torch.Tensor, out_h: int, out_w: int, bits: int,
    mode: str = "bilinear",
) -> torch.Tensor:
    """Chroma planes only get the cheap upscale (Raisr.cpp:1373-1388).

    `lr` is one plane [H, W] or a batch [N, H, W]: the 2x upscale works on the
    last two dims, so each frame gets its own edge clamp. This one function
    stands for raisr_tpu's process_plane_uv and process_plane_uv_batch."""
    return cheap_upscale(lr.to(torch.float32), out_h, out_w, bits, mode=mode)
