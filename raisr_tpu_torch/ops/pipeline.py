"""Whole-frame functional RAISR pipeline (one pass, and the pass loop).

Port of raisr_tpu/ops/pipeline.py. Each pass is a function over the whole
plane (the reference's per-segment hot loop, Library/Raisr.cpp:890-1289).
The pass epilogue and its zone semantics (processed_col_end, _finish_pass)
live in ops/epilogue.py, which the fused kernel's wrapper shares.

Backends: "pallas" runs the fused pass (ops/cuda/full_kernel.py: the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor) for ratio-2
(4-phase) and single-phase (1.5x) banks, at every tier of raisr_tpu's
pass_statics (float32, bfloat16 with p_split at >8 bits, pcenter, int8; see
`_fused_tier`); "taps" is the unfused reference formulation in plain PyTorch on
any device; "conv" (the `xla` backend) is the taps pass with the filter apply
as a dense convolution over all buckets (ops/filter_apply.py), float32 only. A 4-phase bank at a ratio in (2, 3), e.g. 2.5x, uses phase 0 for
every pixel, as the reference and the taps path do, so the fused backend runs
it as a single-phase pass over the bank's phase-0 rows (see `pass_banks`).
Where raisr_tpu uses `vmap`, this module loops over the frames.
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
from raisr_tpu_torch.ops.cuda.full_kernel import (
    int8_bank,
    pcenter_bias,
    raisr_pass_full,
    round_bf16_error_diffused,
)
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end
from raisr_tpu_torch.ops.filter_apply import apply_filters_conv, apply_filters_taps
from raisr_tpu_torch.ops.resize import cheap_upscale, cheap_upscale_stacked


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
    backend: str  # "taps" | "conv" | "pallas"
    # the fused pass's tier (`_fused_tier`): "float32", "bfloat16" (the bank
    # rounded to bf16 with error diffusion: raisr_tpu's mxu_passes=1 at 8
    # bits, p_split at 10/16), "pcenter" (10 bits, 4 phases) or "int8"; the
    # taps backend runs float32
    tier: str = "float32"
    # per-pass (qstr, qcoh) bin edges as python floats (the bank's float32
    # values): the fused kernel's launch arguments and the taps hash's edges
    bank_edges: tuple = ()
    # cheap-upscale resampler (RaisrConfig.resize_mode); non-bilinear modes
    # loop over the frames of a batch (no stacked formulation)
    resize_mode: str = "bilinear"

    @property
    def patch_margin(self) -> int:
        return self.patch_size >> 1

    @property
    def loop_margin(self) -> int:
        return (self.patch_size >> 1) + 1


@dataclasses.dataclass(frozen=True)
class PassBank:
    """One pass's bank as the pass reads it (`pass_banks`): the filters and
    the tier's extras, the pcenter tier's per-row bias `pbias` and the int8
    tier's `inv_scale` (1/scale)."""

    filters: torch.Tensor
    pbias: torch.Tensor | None = None
    inv_scale: float | None = None


def raisr_pass(
    cheap: torch.Tensor,
    bank: PassBank,
    statics: PassStatics,
    pass_idx: int = 0,
    frame_h: int = 0,
    frame_pad: int = 0,
    row0: int = 0,
    zone_h: int = 0,
) -> torch.Tensor:
    """One RAISR pass over an integer-valued float32 plane. Returns the
    integer-valued output plane (float32). The pass's bin edges come from
    statics.bank_edges[pass_idx] (raisr_tpu also passes them as arrays).

    frame_h > 0: the plane is a vertical stack of frame_h-row frames
    separated by 2*frame_pad guard rows; zone masks are applied per frame
    (batched engine mode, see process_plane_y_batch).

    row0 / zone_h > 0: the plane is a row stripe (parallel/sharding.py)
    whose row 0 is global row `row0` of a zone_h-row frame; zones and pixel
    phases are the frame's. This is the one place that builds the fused
    kernel's arguments, for whole frames, stacks and stripes alike. The fused
    and conv passes take the pixel phase from the plane's own rows, so with
    phases they take a stripe that starts on a row of phase 0 only."""
    h, w = cheap.shape
    s = statics
    qstr, qcoh = s.bank_edges[pass_idx]
    if s.use_pixel_type and s.backend != "taps" and row0 % s.ratio_int:
        raise ValueError(
            f"the {s.backend} pass takes its pixel phases from the plane's rows: "
            f"a stripe must start on a multiple of {s.ratio_int}, got row0 {row0}"
        )

    if s.backend == "pallas":
        # whole pass in one fused call: 4-phase for ratio-2 banks, else the
        # single-phase form over a single-phase bank or the phase-0 rows of a
        # 4-phase one (pass_banks; pass_statics refuses any other bank), at
        # the statics' tier over the bank pass_banks prepared for it
        return raisr_pass_full(
            cheap,
            bank.filters,
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
            row0=row0,
            zone_h=zone_h,
            pixel_types=4 if s.use_pixel_type else 1,
            tier=s.tier,
            pbias=bank.pbias,
            inv_scale=bank.inv_scale,
        )
    if s.backend not in ("taps", "conv"):
        raise RaisrError(f"backend {s.backend!r} is not a backend of raisr_tpu_torch.")

    gx, gy = hashing.gradients(cheap)
    weights = gaussian_weights(s.patch_size, s.bits)
    a, b, d = hashing.structure_tensor(gx, gy, weights)
    buckets = hashing.hash_buckets(
        a, b, d, qstr, qcoh, s.qangle, s.qstrength, s.qcoherence
    )
    if s.backend == "conv":
        if s.use_pixel_type:
            raw = apply_filters_conv(cheap, buckets, bank.filters, s.patch_size,
                                     s.pixel_types, s.patch_margin, s.ratio_int)
        else:
            # every pixel is phase 0 (the taps path's row bucket *
            # pixel_types + 0): one conv over the bank's phase-0 rows
            raw = apply_filters_conv(cheap, buckets, bank.filters[0::s.pixel_types],
                                     s.patch_size, 1, s.patch_margin, 1)
    else:
        ptype = hashing.pixel_types(
            h, w, s.ratio_int, s.patch_margin, s.use_pixel_type, device=cheap.device,
            row0=row0,
        )
        raw = apply_filters_taps(cheap, buckets * s.pixel_types + ptype, bank.filters,
                                 s.patch_size)
    return _finish_pass(
        cheap, raw,
        min_val=s.min_val, max_val=s.max_val, blending=int(s.blending),
        loop_margin=s.loop_margin,
        col_end=processed_col_end(w, s.loop_margin, s.exact_edges),
        frame_h=frame_h, frame_pad=frame_pad, row0=row0, zone_h=zone_h,
    )


def _fused_tier(cfg: RaisrConfig, single_phase: bool) -> str:
    """The fused pass's tier for cfg.dtype ("auto" is already "bfloat16"),
    raisr_tpu's pass_statics (ops/pipeline.py:320-353) on the port's kernel:
      - float32 at every depth (mxu_passes 2 and 3) -> "float32";
      - bfloat16 at 8 bits (mxu_passes=1) and bfloat16_exact at 8 bits ->
        "bfloat16";
      - bfloat16 at 10 bits, 4 phases (pcenter=512) -> "pcenter";
      - bfloat16 at 16 bits, bfloat16 at 10 bits on the single-phase pass, and
        bfloat16_exact at 10/16 bits (p_split: F' against the exact patch) ->
        "bfloat16", the same bf16 bank and kernel (a bf16 tap times an integer
        of up to 16 bits is exact in float32);
      - int8 (8 bits, ratio 2) -> "int8".
    `single_phase`: the fused backend runs the single-phase pass, for a
    single-phase bank or for the phase-0 rows of a 4-phase one at a ratio in
    (2, 3). raisr_tpu decides on the bank alone, and at 2.5x and 10 bits runs
    its unfused kernel at mxu_passes=1 with no centring (ROADMAP C10); the
    port runs p_split there, as raisr_tpu's single-phase kernel would."""
    if cfg.dtype == "int8":
        return "int8"
    if cfg.dtype == "bfloat16" and cfg.bits == 10 and not single_phase:
        return "pcenter"
    if cfg.dtype in ("bfloat16", "bfloat16_exact"):
        return "bfloat16"
    return "float32"


def pass_statics(cfg: RaisrConfig, model: RaisrModel, backend: str) -> PassStatics:
    """Static pass parameters. The fused backend runs every tier of
    `_fused_tier`, for ratio-2 (4-phase) and single-phase banks, and a
    4-phase bank at a ratio in (2, 3) with phase 0 everywhere; the taps
    backend ignores the tier, as in raisr_tpu."""
    pixel_types = model.banks[0].pixel_types
    single_phase = pixel_types == 1 or not cfg.use_pixel_type
    tier = _fused_tier(cfg, single_phase) if backend == "pallas" else "float32"
    if (backend == "pallas" and not cfg.use_pixel_type and pixel_types != 1
            and not (pixel_types == 4 and int(cfg.ratio) == 2)):
        # raisr_tpu sends these banks to its unfused Pallas filter kernel,
        # which asserts 4 pixel types and ratio 2
        raise RaisrError(
            f"ratio {cfg.ratio} with a bank of {pixel_types} pixel types has no "
            "fused form: raisr_tpu's unfused filter kernel asserts pixel_types "
            "== 4 and ratio == 2 (ops/pallas/filter_kernel.py:252); use "
            "backend=reference."
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
        pixel_types=pixel_types,
        use_pixel_type=cfg.use_pixel_type,
        ratio_int=int(cfg.ratio),
        bits=cfg.bits,
        min_val=cfg.min_val,
        max_val=cfg.max_val,
        blending=int(cfg.blending),
        exact_edges=cfg.exact_edges,
        backend=backend,
        tier=tier,
        bank_edges=bank_edges,
        resize_mode=cfg.resize_mode,
    )


def pass_banks(statics: PassStatics, filters) -> tuple[PassBank, ...]:
    """The banks the passes read, prepared once (the engine calls this at
    construction, never per pass). For the fused backend:
      - a 4-phase bank at a ratio other than 2 keeps its phase-0 rows
        (filters[0::4], contiguous): the reference's pixelType is 0 there
        (Raisr.cpp:1477-1480), as in the taps path's row bucket * 4 + 0;
      - the bfloat16 and pcenter tiers round each bank with
        round_bf16_error_diffused, and pcenter adds its bias (pcenter_bias);
      - the int8 tier puts each bank on its int16 grid (int8_bank).
    The taps backend reads the banks as they are."""
    s = statics
    if s.backend != "pallas":
        return tuple(PassBank(f) for f in filters)
    out = []
    for f in filters:
        if not s.use_pixel_type and s.pixel_types == 4:
            f = f[0::4].contiguous()
        if s.tier == "int8":
            q, inv_scale = int8_bank(f)
            out.append(PassBank(q, inv_scale=inv_scale))
        elif s.tier in ("bfloat16", "pcenter"):
            f16 = round_bf16_error_diffused(f)
            out.append(PassBank(f16, pcenter_bias(f16) if s.tier == "pcenter" else None))
        else:
            out.append(PassBank(f))
    return tuple(out)


def process_plane_y(
    lr: torch.Tensor,
    bank_filters: tuple[PassBank, ...],
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
    bank_filters: tuple[PassBank, ...],
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
    Frames stay stacked across passes. The stack needs the fused backend,
    the bilinear resize and a ratio that scales the guard and the period to
    whole rows (2x always; 1.5x when h divides 1.5 * guard, e.g. 1080 ->
    1620 with a 9-row HR guard in mode 1, 18 in mode 2); anything else
    loops over the frames."""
    n, h, w = batch_lr.shape
    s = statics
    # LR guard: 6 rows covers the resize support; when pass 1 runs at LR
    # size (mode 2) it needs the full processing support at LR scale
    lr_pad = 12 if (passes == 2 and two_pass_mode == 2) else 6
    stackable = (
        s.backend == "pallas"
        and (s.use_pixel_type or s.pixel_types == 1)
        and s.resize_mode == "bilinear"
        and (out_h * lr_pad) % h == 0
        and (out_h * (h + 2 * lr_pad)) % h == 0
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
            if out_h == 2 * h and out_w == 2 * w:
                # 2x: the slice-based resize has fixed per-row weights, so
                # the whole-stack upscale equals the per-frame one
                cheap = cheap_upscale(x, 2 * x.shape[0], out_w, s.bits)
            else:
                # other ratios: per-frame weight vectors tiled over the
                # stack, so frame rows equal the per-frame upscale exactly
                cheap = cheap_upscale_stacked(
                    x, n, h, cur_pad, out_h, cur_pad * out_h // h, out_w, s.bits
                )
            cur_fh, cur_pad = out_h, cur_pad * out_h // h
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

    `lr` is one plane [H, W] or a batch [N, H, W]: the upscale works on the
    last two dims at any ratio, so each frame gets its own edge clamp. This one function
    stands for raisr_tpu's process_plane_uv and process_plane_uv_batch."""
    return cheap_upscale(lr.to(torch.float32), out_h, out_w, bits, mode=mode)
