"""Whole RAISR pass, every tier, 4-phase and single-phase: the CUDA kernel's
wrappers, their plain PyTorch version, and the tiers' bank preparation.

Port of raisr_tpu/ops/pallas/full_kernel.py:raisr_pass_pallas_full (ratio 2,
4 pixel phases) and raisr_pass_pallas_full_single (single-phase banks, e.g.
ratio 1.5). One kernel, csrc/full_kernel.cu, serves both (launch A, hash
then gather with the phase's bank resident in shared memory, and launch B,
the epilogue, which `pass_epilogue` also runs alone; see its header); the phase count is its only difference. The
TPU tiling and precision knobs (tb2, ostack, rowbatch, cchunk, gchunk,
hashloop, mpack, ftrans, mxu_passes, p_split, i8, pcenter, interpret) have no
meaning here and are gone. The caller names the tier (`tier`, from
`PassStatics.tier` on the engine's path); the pass and its plain version
hold the bank's dtype and extras to it (`_check_tier`). Each tier's bank is
prepared once on the host side (`FusedPass.prepare`):
  - float32: the TPU's float32 grade (mxu_passes 2 and 3), at every depth;
  - bfloat16 (`round_bf16_error_diffused`): the 8-bit bf16 tier
    (mxu_passes=1), and p_split at 10/16 bits: a bf16 tap times an integer
    of up to 16 bits is exact in float32, so [F', F'] x [Phi, Plo] is F' x P;
  - pcenter, 10 bits, 4 phases: the same bf16 bank against bf16(P - 512),
    plus the per-row bias `pcenter_bias` (512 * sum(F'));
  - int8, 8 bits, 4 phases: int16 taps from `int8_bank` (the bank's
    power-of-two scale, error-diffused rounding) in an exact integer dot,
    times 1/scale.

`FusedPass`, one pass prepared once (`ops/pipeline.pass_banks`), and
`raisr_pass_full`, the same as one call, run the kernel on a CUDA tensor and
the plain version on a CPU tensor. There is no fallback: on CUDA they launch
the kernel or raise. `LAUNCHES[(tier, phases)]` counts the passes that went
through the kernel, one per pass whatever its CUDA launches: float32 and
bfloat16 (p_split included) with 4 or 1 phases, pcenter and int8 with 4
only, as on the TPU. `EPILOGUE_LAUNCHES` counts launch B, inside a pass or
alone; `PACKED_EPILOGUE_LAUNCHES` those of them that wrote packed frames
(`out_dtype` uint8 or uint16: the last pass of a batched step).
"""

from __future__ import annotations

import torch

from raisr_tpu_torch.ops.cuda.filter_kernel import (
    FILTER_STRIDE,
    N_TAPS,
    PCENTER,
    _check_bank,
    _check_phases,
    _check_plane,
    _device_and_stream,
    _hash_launch_args,
    _launch_hash_filter,
    apply_filters_reference,
    hash_buckets_reference,
)
from raisr_tpu_torch.ops.cuda.upscale import pack_planes
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end, zone_height

# passes through the kernel, by (tier, phases): every form the kernel has
LAUNCHES = {
    ("float32", 4): 0, ("float32", 1): 0, ("bfloat16", 4): 0, ("bfloat16", 1): 0,
    ("pcenter", 4): 0, ("int8", 4): 0,
}
# each tier's bank dtype
TIER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "pcenter": torch.bfloat16, "int8": torch.int16}
EPILOGUE_LAUNCHES = 0  # launch B (epilogue_kernel), in a pass or through pass_epilogue
PACKED_EPILOGUE_LAUNCHES = 0  # of them, those that wrote packed frames
# launch B's output forms (the C entry's out_form)
_OUT_FORM = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}

# the int8 tier's grid: raisr_tpu's balanced hi/lo int8 pairs span
# [-32896, 32639] (full_kernel.py:76, :779)
_INT_LO, _INT_HI = -32896.0, 32639.0


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
    for k in range(N_TAPS):
        q = (f[:, k] + carry).to(torch.bfloat16)
        carry = (carry + f[:, k]) - q.to(torch.float32)
        out[:, k] = q
    return out


def round_int_error_diffused(f: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Taps onto the integer grid round(f * scale) with error diffusion along
    the last (tap) axis, clamped to [-32896, 32639]; returns the integer
    values as float32.

    Counterpart of raisr_tpu's _round_int_error_diffused
    (ops/pallas/full_kernel.py:68-79), and bit-identical to it: per tap in
    order, q = clip(round((f + carry) * scale)) (round half to even), then
    carry = (carry + f) - q / scale, all in float32."""
    f = f.to(torch.float32)
    carry = torch.zeros(f.shape[:-1], dtype=torch.float32, device=f.device)
    qs = []
    for k in range(f.shape[-1]):
        q = torch.clamp(torch.round((f[..., k] + carry) * scale), _INT_LO, _INT_HI)
        carry = (carry + f[..., k]) - q / scale
        qs.append(q)
    return torch.stack(qs, dim=-1)


def int8_scale(filters: torch.Tensor) -> torch.Tensor:
    """The int8 tier's power-of-two scale of one pass's bank, as raisr_tpu
    computes it (ops/pallas/full_kernel.py:780-781), in float32:
    exp2(floor(log2(32639 / max(absmax, 1e-6)))) over taps 0..120. Taken on
    the CPU, so every device gets the same scale (float32 log2 decides the
    floor just under a power of two)."""
    f = filters[:, :N_TAPS].detach().to("cpu", torch.float32)
    absmax = torch.clamp(f.abs().max(), min=1e-6)
    return torch.exp2(torch.floor(torch.log2(torch.tensor(_INT_HI) / absmax)))


def int8_bank(filters: torch.Tensor) -> tuple[torch.Tensor, float]:
    """One pass's bank for the int8 tier, prepared once: the taps on the
    int16 grid of `int8_scale`, rounded with error diffusion
    (round_int_error_diffused, taken on the CPU), as a contiguous int16
    [rows, 128] tensor on the bank's device (taps 121..127 are 0), and the
    float32 1/scale as a float. The TPU kernel splits each tap into a hi/lo
    int8 pair and shifts the patch by -128 (its bias 128 * rowsum undoes the
    shift); the CUDA kernel multiplies the whole int16 tap by the unshifted
    integer patch in int32, so it needs neither."""
    scale = int8_scale(filters)
    q = round_int_error_diffused(filters[:, :N_TAPS].detach().to("cpu"), scale)
    if q.min() < -32768:  # the carry stays within a step of the clamp
        raise ValueError("int8 bank: a tap fell below the int16 range")
    out = torch.zeros((q.shape[0], FILTER_STRIDE), dtype=torch.int16)
    out[:, :N_TAPS] = q.to(torch.int16)
    return out.to(filters.device), float(1.0 / scale)


def pcenter_bias(bank: torch.Tensor) -> torch.Tensor:
    """The pcenter tier's per-row bias, PCENTER * sum(F') of a bfloat16 bank
    (raisr_tpu: full_kernel.py:806-814): it adds back what centring the
    patch at 512 took away. The sum is taken in float64, where it is exact
    for bf16 taps within 2^40 of one another, and rounded once to float32,
    so it does not depend on the device's summation order. Returns a
    contiguous float32 [rows] tensor."""
    return (PCENTER * bank.to(torch.float64).sum(dim=1)).to(torch.float32).contiguous()


def raisr_pass_full_reference(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    filters: torch.Tensor,  # [216 * pixel_types, 128] f32, bf16 or int16
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
    tier: str = "float32",
    pbias: torch.Tensor | None = None,
    inv_scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of one fused pass, on any device: the plain hash
    and filter apply of ops/cuda/filter_kernel.py (gradients -> separable
    structure tensor -> hash buckets -> (pixel phases) -> 121-tap filter at
    the caller's tier, held by _check_tier), then the frame-aware pass
    epilogue. The arguments of FusedPass and of its call."""
    _check_tier(tier, filters, pixel_types, pbias, inv_scale, max_val)
    w = cheap.shape[1]
    margin = patch_size // 2
    buckets = hash_buckets_reference(
        cheap, k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
        qstrength=qstrength, qcoherence=qcoherence)
    raw = apply_filters_reference(cheap, buckets, filters, patch_size=patch_size,
                                  pixel_types=pixel_types, patch_margin=margin,
                                  pbias=pbias, inv_scale=inv_scale)
    return _finish_pass(
        cheap, raw,
        min_val=min_val, max_val=max_val, blending=blending,
        loop_margin=margin + 1,
        col_end=processed_col_end(w, margin + 1, exact_edges),
        frame_h=frame_h, frame_pad=frame_pad, row0=row0, zone_h=zone_h,
    )


def _check_tier(tier: str, filters: torch.Tensor, pixel_types: int,
                pbias: torch.Tensor | None, inv_scale: float | None, max_val: int) -> None:
    """Holds the bank and its extras to the caller's tier, on every device:
    the tier's bank dtype (TIER_DTYPES) and phase counts (LAUNCHES),
    `pbias` with pcenter and only there, `inv_scale` with int8 and only
    there. The int8 tier's int32 dot is exact for 8-bit planes only
    (121 * 32896 * 255 < 2^31), so it refuses a max_val above 255."""
    if tier not in TIER_DTYPES:
        raise ValueError(f"tier must be one of {sorted(TIER_DTYPES)}, got {tier!r}")
    if (tier, pixel_types) not in LAUNCHES:
        raise ValueError(f"the {tier} tier takes 4 pixel types, got {pixel_types}")
    if filters.dtype != TIER_DTYPES[tier]:
        raise ValueError(f"the {tier} tier takes a {TIER_DTYPES[tier]} bank, got {filters.dtype}")
    if (pbias is not None) != (tier == "pcenter"):
        raise ValueError(f"pbias goes with the pcenter tier, and only there (tier {tier})")
    if (inv_scale is not None) != (tier == "int8"):
        raise ValueError(f"inv_scale goes with the int8 tier, and only there (tier {tier})")
    if tier == "int8" and max_val > 255:
        raise ValueError(f"the int8 tier takes 8-bit planes (max_val <= 255), got {max_val}")


def pass_epilogue(
    cheap: torch.Tensor,  # [H, W] f32
    raw: torch.Tensor,  # [H, W] f32, the filter output
    *,
    min_val: int = 16,
    max_val: int = 235,
    blending: int = 2,
    patch_size: int = 11,
    exact_edges: bool = True,
    frame_h: int = 0,
    frame_pad: int = 0,
    row0: int = 0,
    zone_h: int = 0,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The pass epilogue alone (launch B): exclusive range reject,
    processed-zone mask, census blend (1 Randomness, 2 CountOfBitsChanged),
    floor(+0.5), clamp and the blend zone, with the zones of a frame stack
    (frame_h/frame_pad) or a row stripe (row0/zone_h). The CUDA kernel for
    CUDA tensors, ops/epilogue.py `_finish_pass`, its plain version, for CPU
    tensors; the two agree bit for bit. `out_dtype` uint8 or uint16 returns
    the output frames packed (`packed_frames`)."""
    _check_out(out_dtype, cheap.shape[0], frame_h, frame_pad, row0, zone_h)
    loop_margin = patch_size // 2 + 1
    col_end = processed_col_end(cheap.shape[-1], loop_margin, exact_edges)
    if cheap.device.type == "cpu":
        out = _finish_pass(cheap, raw, min_val=min_val, max_val=max_val, blending=blending,
                           loop_margin=loop_margin, col_end=col_end, frame_h=frame_h,
                           frame_pad=frame_pad, row0=row0, zone_h=zone_h)
        return packed_frames(out, out_dtype, frame_h, frame_pad)
    if cheap.device.type != "cuda":
        raise ValueError(f"pass_epilogue runs on cpu or cuda, not {cheap.device}")
    _check_plane(cheap)
    if (raw.dtype != torch.float32 or raw.shape != cheap.shape or raw.device != cheap.device
            or not raw.is_contiguous()):
        raise ValueError(
            f"raw must be a contiguous float32 {tuple(cheap.shape)} tensor on {cheap.device}, "
            f"got {raw.dtype} {tuple(raw.shape)} on {raw.device}"
        )
    if patch_size != 11:
        raise ValueError(f"the CUDA kernel takes patch_size 11, got {patch_size}")
    if blending not in (1, 2):
        raise ValueError(f"blending must be 1 or 2, got {blending}")
    return _launch_epilogue(cheap, raw, float(min_val), float(max_val), int(blending), col_end,
                            frame_h, frame_pad, row0, zone_h, out_dtype)


def _check_out(out_dtype: torch.dtype, h: int, frame_h: int, frame_pad: int, row0: int,
               zone_h: int) -> None:
    """Holds launch B's output form to what it can write, on every device:
    float32, or packed uint8 / uint16 frames of a whole plane or a whole
    frame stack (row0 0, zone_h 0, h a multiple of the stack's period)."""
    if out_dtype not in _OUT_FORM:
        raise ValueError(f"out_dtype must be float32, uint8 or uint16, got {out_dtype}")
    if out_dtype == torch.float32:
        return
    if row0 or zone_h:
        raise ValueError(f"packed frames come from a whole plane or stack, not a row stripe "
                         f"(row0 {row0}, zone_h {zone_h})")
    if frame_h > 0 and h % (frame_h + 2 * frame_pad):
        raise ValueError(f"packed frames come from a whole stack: {h} rows are not whole "
                         f"periods of {frame_h} + 2 * {frame_pad}")


def packed_frames(plane: torch.Tensor, out_dtype: torch.dtype, frame_h: int = 0,
                  frame_pad: int = 0) -> torch.Tensor:
    """Plain version of launch B's packed store, on any device: a pass's
    float32 output plane with a frame stack's guard rows left out (frame k
    at rows k * frame_h ..), packed as pack_planes packs. float32 returns
    the plane as it is, guard rows and all."""
    if out_dtype == torch.float32:
        return plane
    if frame_h > 0:
        w = plane.shape[1]
        period = frame_h + 2 * frame_pad
        plane = plane.reshape(-1, period, w)[:, frame_pad: frame_pad + frame_h].reshape(-1, w)
    return pack_planes(plane, out_dtype)


def _launch_epilogue(cheap, raw, min_val: float, max_val: float, blending: int, col_end: int,
                     frame_h: int, frame_pad: int, row0: int, zone_h: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch B on the current stream, over arguments the caller checked
    (`_check_out` among them); raises if the launch fails."""
    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    packed = out_dtype != torch.float32
    rows = h // (frame_h + 2 * frame_pad) * frame_h if packed and frame_h > 0 else h
    out = torch.empty((rows, w), dtype=out_dtype, device=cheap.device)
    dev, stream = _device_and_stream(cheap)
    err = load_library().raisr_full_epilogue(
        cheap.data_ptr(), raw.data_ptr(), out.data_ptr(), h, w,
        min_val, max_val, blending, col_end,
        frame_h, frame_pad, row0, zone_height(h, frame_h, zone_h), _OUT_FORM[out_dtype], dev,
        stream,
    )
    if err:
        raise RuntimeError(f"raisr_full_epilogue launch failed: cudaError {err}")
    global EPILOGUE_LAUNCHES, PACKED_EPILOGUE_LAUNCHES
    EPILOGUE_LAUNCHES += 1
    PACKED_EPILOGUE_LAUNCHES += int(packed)
    return out


class FusedPass:
    """One complete RAISR pass, fused, prepared once for its bank's device
    (the CUDA kernel, or raisr_pass_full_reference on the CPU) at the
    caller's tier: "float32"; "bfloat16" (a round_bf16_error_diffused bank;
    the 8-bit bf16 tier and p_split); "pcenter" (that bank with `pbias`, 4
    phases); "int8" (an int8_bank with `inv_scale`, 4 phases, 8-bit planes).

    Construction runs every check (`_check_tier` on every device; on CUDA
    the bank's layout, the hash's edges and grid, `blending`; the CPU takes
    any bank) and builds the launch's arguments, so a call checks only its
    plane. k1d, qstr and qcoh are sequences of floats (the edges taken from
    the bank's float32 arrays); the kernel takes them as float32."""

    def __init__(
        self,
        filters: torch.Tensor,  # [216 * pixel_types, 128] f32, bf16 or int16
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
        pixel_types: int = 4,  # 4: ratio-2 bank [864, 128]; 1: single-phase [216, 128]
        tier: str = "float32",  # a key of TIER_DTYPES (PassStatics.tier)
        pbias: torch.Tensor | None = None,  # pcenter: pcenter_bias of the bf16 bank
        inv_scale: float | None = None,  # int8: the 1/scale of int8_bank
    ):
        _check_tier(tier, filters, pixel_types, pbias, inv_scale, max_val)
        self.filters, self.pbias, self.inv_scale = filters, pbias, inv_scale
        self.tier, self.pixel_types, self.device = tier, pixel_types, filters.device
        self._plain = dict(
            k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle, qstrength=qstrength,
            qcoherence=qcoherence, patch_size=patch_size, min_val=min_val, max_val=max_val,
            blending=blending, exact_edges=exact_edges, pixel_types=pixel_types, tier=tier,
            pbias=pbias, inv_scale=inv_scale,
        )
        self._hash = None
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"the fused pass runs on cpu or cuda, not {self.device}")
        _check_phases(pixel_types)
        n_rows = qangle * qstrength * qcoherence * pixel_types
        _check_bank(filters, self.device, n_rows, (TIER_DTYPES[tier],))
        if blending not in (1, 2):
            raise ValueError(f"blending must be 1 or 2, got {blending}")
        if pbias is not None and (
            pbias.dtype != torch.float32 or tuple(pbias.shape) != (n_rows,)
            or pbias.device != self.device or not pbias.is_contiguous()
        ):
            raise ValueError(
                f"pbias must be a contiguous float32 [{n_rows}] tensor on {self.device}, "
                f"got {pbias.dtype} {tuple(pbias.shape)} on {pbias.device}"
            )
        self._hash = _hash_launch_args(k1d, nf, qstr, qcoh, qangle, qstrength, qcoherence,
                                       patch_size)
        self._epilogue = (float(min_val), float(max_val), int(blending))
        self._loop_margin, self._exact_edges = patch_size // 2 + 1, exact_edges

    @classmethod
    def prepare(cls, filters: torch.Tensor, *, tier: str, **kw) -> FusedPass:
        """The pass over a float32 bank, prepared for `tier` on the bank's
        device: rounded to bfloat16 with error diffusion (bfloat16; pcenter
        with its pcenter_bias) or put on the int16 grid (int8, with its
        1/scale); float32 reads it as it is. `kw` are the constructor's."""
        if tier == "int8":
            q, inv_scale = int8_bank(filters)
            return cls(q, tier=tier, inv_scale=inv_scale, **kw)
        if tier in ("bfloat16", "pcenter"):
            f16 = round_bf16_error_diffused(filters)
            return cls(f16, tier=tier, pbias=pcenter_bias(f16) if tier == "pcenter" else None,
                       **kw)
        return cls(filters, tier=tier, **kw)

    def __call__(
        self,
        cheap: torch.Tensor,  # [H, W] f32 (integer-valued), on the pass's device
        *,
        frame_h: int = 0,  # >0: plane is a guard-banded vertical frame stack
        frame_pad: int = 0,
        row0: int = 0,  # global row of plane row 0 (row stripes)
        zone_h: int = 0,  # >0: global frame height for zone tests (stripes)
        out_dtype: torch.dtype = torch.float32,  # uint8 / uint16: the frames packed
    ) -> torch.Tensor:
        """The pass over one plane: launch A then launch B on the current
        stream, counted in LAUNCHES[(tier, pixel_types)], or the plain
        version on the CPU. float32 returns the [H, W] plane; uint8 or
        uint16 the output frames packed, a stack's guard rows left out
        (`packed_frames`): the last pass of a batched step."""
        if cheap.device != self.device:
            raise ValueError(f"the fused pass runs on cpu or cuda, on its bank's device "
                             f"{self.device}; got a plane on {cheap.device}")
        _check_out(out_dtype, cheap.shape[0], frame_h, frame_pad, row0, zone_h)
        if self._hash is None:
            out = raisr_pass_full_reference(cheap, self.filters, frame_h=frame_h,
                                            frame_pad=frame_pad, row0=row0, zone_h=zone_h,
                                            **self._plain)
            return packed_frames(out, out_dtype, frame_h, frame_pad)
        _check_plane(cheap)
        raw = torch.empty_like(cheap)
        _launch_hash_filter(cheap, self.filters, raw, self.pixel_types, self._hash, self.tier,
                            self.pbias, self.inv_scale)
        col_end = processed_col_end(cheap.shape[1], self._loop_margin, self._exact_edges)
        out = _launch_epilogue(cheap, raw, *self._epilogue, col_end, frame_h, frame_pad, row0,
                               zone_h, out_dtype)
        LAUNCHES[self.tier, self.pixel_types] += 1
        return out


def raisr_pass_full(cheap: torch.Tensor, filters: torch.Tensor, *, frame_h: int = 0,
                    frame_pad: int = 0, row0: int = 0, zone_h: int = 0, **kw) -> torch.Tensor:
    """One complete RAISR pass as one call: FusedPass(filters, **kw) over
    `cheap` and its zones (a single-phase bank: pixel_types=1)."""
    return FusedPass(filters, **kw)(cheap, frame_h=frame_h, frame_pad=frame_pad, row0=row0,
                                    zone_h=zone_h)
