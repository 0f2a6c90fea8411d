"""Filter apply (to precomputed buckets, and with the hash): the CUDA kernels'
wrappers and their plain PyTorch versions. The output is the raw filtered
plane, with no pass epilogue.

Port of raisr_tpu/ops/pallas/filter_kernel.py, onto the kernels of
csrc/full_kernel.cu:
  - apply_filters_pallas (_band_kernel, 4 phases; _single_kernel, 1 phase)
    -> `apply_filters`: the gather launch alone,
    gather_resident_kernel<4 | 1, Tier::kF32, int>, over the caller's int32
    buckets (a bucket outside [0, n_buckets) gives 0). The phase's rows are
    resident in a block's shared memory, so the bank's size is bounded
    (`gather_smem_bytes`, `MAX_SMEM_BYTES`): a larger bank is refused;
  - apply_filters_hash_pallas (_band_kernel_fused, hash + filter, 4 phases)
    -> `apply_filters_hash`: launch A (hash_bucket_kernel, then
    gather_resident_kernel<4, Tier::kF32, uint8_t>), which the fused pass
    runs too.
`hash_buckets` runs the hash launch A1 alone (a uint8 bucket plane) and
`gather_buckets` the gather launch A2 alone over such a plane, at every
tier, for the tests and the timings of the kernels; no serving path calls
them. `gather_wavefronts` counts what A2's shared-memory reads cost on a
bucket plane (host arithmetic).
The TPU knobs (tb2, rowbatch, mxu_passes, interpret) have no meaning here and
are gone: the card computes plain float32 at every bit depth, so the 10-bit
case (mxu_passes=3 on the TPU) needs nothing extra.

Each wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; there is no fallback. `LAUNCHES`, `SINGLE_LAUNCHES` and `HASH_LAUNCHES`
count the calls that went through a kernel: apply_filters with 4 and with 1
phase, and apply_filters_hash. `hash_tile_counts` counts A1's tiles on a
plane by the path they take (host arithmetic).
"""

from __future__ import annotations

import ctypes

import torch

from raisr_tpu_torch.ops import hashing
from raisr_tpu_torch.ops.filter_apply import apply_filters_taps

LAUNCHES = 0  # apply_filters, 4 phases, through the gather launch
SINGLE_LAUNCHES = 0  # apply_filters, 1 phase, through the gather launch
HASH_LAUNCHES = 0  # apply_filters_hash, through launch A

# A1's output tile (csrc/full_kernel.cu kHashRows, kHashCols) and how far its
# staged window reaches past it: the tensor window's 5 and the gradient's 1
HASH_TILE_ROWS, HASH_TILE_COLS, HASH_HALO = 32, 54, 6

FILTER_STRIDE = 128  # taps per bank row, zero-padded
N_TAPS = 121
MAX_EDGES = 8  # strength / coherence edges the hash launch takes (kMaxEdges)
MAX_BUCKETS = 256  # launch A's bucket plane is uint8 (csrc/full_kernel.cu)
# the dynamic shared memory a block can ask for on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
# the pcenter tier's patch centre (raisr_tpu's pass_statics: pcenter=512.0);
# csrc/full_kernel.cu kPCenterValue
PCENTER = 512.0


def check_bank_limits(qangle: int, qstrength: int, qcoherence: int,
                      n_qstr: int, n_qcoh: int) -> None:
    """The CUDA pass's limits on a bank's hash: at most MAX_BUCKETS buckets
    (the hash launch hands each pixel's bucket on as one byte) and at most
    MAX_EDGES strength and coherence edges (its parameter block). Raises a
    ValueError that names the limit; plain Python, so every device can ask."""
    n_buckets = qangle * qstrength * qcoherence
    if not 0 < n_buckets <= MAX_BUCKETS:
        raise ValueError(
            f"the CUDA kernel hands each pixel's bucket on as one byte: at most "
            f"{MAX_BUCKETS} buckets, got {qangle} x {qstrength} x {qcoherence} = {n_buckets}"
        )
    if n_qstr > MAX_EDGES or n_qcoh > MAX_EDGES:
        raise ValueError(
            f"the CUDA kernel takes at most {MAX_EDGES} strength and {MAX_EDGES} coherence "
            f"edges, got {n_qstr} and {n_qcoh}"
        )


def gather_smem_bytes(n_buckets: int, pixel_types: int, tier: str = "float32",
                      hashed: bool = False) -> int:
    """Dynamic shared memory of one block of the gather launch A2
    (csrc/full_kernel.cu GatherSmem::bytes): the phase's `n_buckets` rows,
    taps 0..120 in an odd number of 16-byte groups (31 at float32: 496 B a
    row; 17 at the 16-bit tiers: 272 B), pcenter's float32 bias a row
    (16-byte aligned), the slot of each bucket where the buckets are the
    hash's (`hashed`: 256 bytes), then two tile buffers for each of the
    block's 2 groups: the patch region of 32 x 32 same-phase pixels, 73
    rows of 74 words for 4 phases, 42 of 42 for 1. apply_filters' launch is
    float32 over a caller's buckets, the defaults."""
    groups = -(-N_TAPS // (4 if tier == "float32" else 8))
    row_bytes = 16 * (groups | 1)
    bias = -(-n_buckets * 4 // 16) * 16 if tier == "pcenter" else 0
    step = 2 if pixel_types == 4 else 1
    tile_rows = tile_cols = step * 31 + 11
    tile_words = tile_rows * step * (-(-tile_cols // step))
    return n_buckets * row_bytes + bias + (256 if hashed else 0) + 2 * 2 * tile_words * 4


def check_gather_smem(n_buckets: int, pixel_types: int) -> None:
    """apply_filters' size rule: the float32 rows of one phase must fit in a
    block's shared memory beside the tile buffers (at most 294 buckets with
    4 phases, 411 with 1). Raises a ValueError that names the byte counts;
    there is no route that reads the rows from device memory instead."""
    if n_buckets < 1:
        raise ValueError(f"the bank holds no bucket of {pixel_types} pixel types")
    need = gather_smem_bytes(n_buckets, pixel_types)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a bank of {n_buckets} buckets needs {need} bytes of shared memory a block "
            f"({n_buckets} float32 rows of 496 bytes and "
            f"{gather_smem_bytes(0, pixel_types)} bytes of tile buffers); the card gives "
            f"{MAX_SMEM_BYTES}"
        )


def hash_tile_counts(h: int, w: int) -> tuple[int, int]:
    """A1's (interior, edge) tiles over an [h, w] plane. A tile is interior
    when its staged window (the tile and HASH_HALO rows and columns around
    it) lies inside the plane: then it runs with no bounds tests
    (csrc/full_kernel.cu hash_interior). Along an axis of n pixels and tile
    t, that is the tiles k >= 1 with (k + 1) * t + HASH_HALO <= n."""
    def inside(n: int, t: int) -> int:
        return max(0, (n - t - HASH_HALO) // t)

    tiles = -(-h // HASH_TILE_ROWS) * -(-w // HASH_TILE_COLS)
    interior = inside(h, HASH_TILE_ROWS) * inside(w, HASH_TILE_COLS)
    return interior, tiles - interior


def bank_slots(qangle: int, qstrength: int, qcoherence: int) -> torch.Tensor:
    """The slot of each bucket of a hash grid: the row the gather launch A2
    stages it at in shared memory (csrc/full_kernel.cu bank_slot). Bucket
    (angle * qstrength + strength) * qcoherence + coherence goes to slot
    (strength * qangle + angle) * qcoherence + coherence, so the buckets of
    one strength lie together; int64 [qangle * qstrength * qcoherence]."""
    b = torch.arange(qangle * qstrength * qcoherence)
    angle, strength = b // (qstrength * qcoherence), b // qcoherence % qstrength
    return (strength * qangle + angle) * qcoherence + b % qcoherence


def _quarter_wavefronts(rows: torch.Tensor) -> torch.Tensor:
    """Shared-memory wavefronts of each quarter-warp's 16-byte bank load,
    rows [..., 8] (the shared rows its 8 lanes read): a bank row's 16-byte
    group q lies in bank group (q -+ row) mod 8 (an odd row stride in
    16-byte groups), so distinct rows that agree mod 8 are served one after
    another, and equal rows are broadcasts."""
    s, _ = torch.sort(rows, dim=-1)
    new = torch.ones_like(s, dtype=torch.bool)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    per_group = torch.stack([(new & (s % 8 == g)).sum(-1) for g in range(8)], -1)
    return per_group.amax(-1)


def gather_wavefronts(buckets: torch.Tensor, pixel_types: int,
                      slots: torch.Tensor | None = None, *,
                      order: str = "kernel") -> tuple[float, float]:
    """What the gather launch A2's shared-memory reads cost on a bucket plane
    ([H, W], any integer dtype, every value a row of the bank): the mean
    wavefronts of a quarter-warp's 16-byte bank load, over every load of
    every warp (ragged tiles included: a pixel outside the plane reads
    bucket 0, as the kernel's lanes do), and the scalar patch reads a pixel.
    Host arithmetic, on the plane's device; no launch reads it.

    A warp takes `pixels` same-phase rows of a tile, `kStep` apart (2 for 4
    pixel types, 1 for 1), and 32 same-phase columns, a column a lane; a
    thread reads the patch rows its pixels share once. `order`:
      "parent": 2 pixels a thread, lane L on column L, the row of bucket b
                at b (A2 before the lanes were ordered);
      "kernel": 4 pixels a thread; each warp sorts its columns by the slot
                of pixel 1's bucket (ties by column) and lane L serves the
                L-th; bucket b's row is at slots[b] (`bank_slots` for the
                hash's buckets; None: at b, as apply_filters stages a
                caller's buckets)."""
    if order not in ("parent", "kernel"):
        raise ValueError(f"order is 'parent' or 'kernel', got {order!r}")
    step = 2 if pixel_types == 4 else 1
    pixels = 2 if order == "parent" else 4
    tile_rows = 8 * pixels
    rows_of = (slots.to(buckets.device) if slots is not None and order == "kernel"
               else None)
    total, loads = 0, 0
    for pr in range(step):
        for pc in range(step):
            sub = buckets[pr::step, pc::step].to(torch.int64)
            h, w = sub.shape
            hp, wp = -(-h // tile_rows) * tile_rows, -(-w // 32) * 32
            plane = torch.zeros((hp, wp), dtype=torch.int64, device=sub.device)
            plane[:h, :w] = sub
            if rows_of is not None:
                plane = rows_of[plane]
            # [warps, pixels, 32 lanes]
            warps = (plane.reshape(hp // tile_rows, 8, pixels, wp // 32, 32)
                     .permute(0, 1, 3, 2, 4).reshape(-1, pixels, 32))
            if order == "kernel":
                lane = torch.arange(32, device=plane.device)
                perm = torch.argsort(warps[:, 1, :] * 32 + lane, dim=-1)
                warps = torch.gather(warps, 2, perm[:, None, :].expand_as(warps))
            waves = _quarter_wavefronts(warps.reshape(-1, 4, 8))
            total += int(waves.sum())
            loads += waves.numel()
    return total / loads, (11 + step * (pixels - 1)) * 11 / pixels


def _check_phases(pixel_types: int, ratio: int | None = None) -> None:
    """4 or 1 phases; given the filter apply's ratio, 4 phases only at ratio 2."""
    if pixel_types not in (4, 1):
        raise ValueError(f"the CUDA kernel takes 4 or 1 pixel types, got {pixel_types}")
    if ratio is not None and pixel_types == 4 and ratio != 2:
        raise ValueError(
            f"4 pixel types need ratio 2, got {ratio} (raisr_tpu asserts it, "
            "ops/pallas/filter_kernel.py:252)"
        )


def hash_buckets_reference(
    cheap: torch.Tensor, *, k1d, nf: float, qstr, qcoh,
    qangle: int = 24, qstrength: int = 3, qcoherence: int = 3,
) -> torch.Tensor:
    """Plain PyTorch version of the hash of launch A: gradients -> separable
    structure tensor -> int32 hash buckets [H, W]."""
    gx, gy = hashing.gradients(cheap)
    a, b, d = hashing.structure_tensor_separable(gx, gy, k1d, nf)
    return hashing.hash_buckets(a, b, d, qstr, qcoh, qangle, qstrength, qcoherence)


def apply_filters_reference(
    cheap: torch.Tensor,  # [H, W] f32
    buckets: torch.Tensor,  # [H, W] int32
    filters: torch.Tensor,  # [n_buckets * pixel_types, 128] f32, bf16 or int16
    *,
    patch_size: int = 11,
    pixel_types: int = 4,
    patch_margin: int = 5,
    ratio: int = 2,
    pbias: torch.Tensor | None = None,
    inv_scale: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of apply_filters, on any device. A bucket
    outside [0, n_buckets) gives 0. The bank's tier (ops/cuda/full_kernel.py)
    decides the dot:
      - float32, or bfloat16 widened to float32 (exact): against the plane,
        taps in order 0..120;
      - bfloat16 with `pbias` (pcenter): against bf16(plane - PCENTER), the
        plane zero outside before the shift, then + pbias[row];
      - int16 (int8 tier): in int64 against the integer plane, rounded to
        float32 at the end and times `inv_scale`."""
    _check_phases(pixel_types, ratio)
    h, w = cheap.shape
    valid = (buckets >= 0) & (buckets < filters.shape[0] // pixel_types)
    rows = torch.where(valid, buckets, 0)
    if pixel_types == 4:
        rows = rows * 4 + hashing.pixel_types(h, w, 2, patch_margin, True,
                                              device=cheap.device)
    if filters.dtype == torch.int16:
        acc = apply_filters_taps(cheap.to(torch.int64), rows, filters.to(torch.int64),
                                 patch_size)
        raw = acc.to(torch.float32) * inv_scale
    elif pbias is not None:
        centred = (cheap - PCENTER).to(torch.bfloat16).to(torch.float32)
        raw = apply_filters_taps(centred, rows, filters.to(torch.float32), patch_size,
                                 pad_value=-PCENTER)
        raw = raw + pbias[rows.to(torch.int64)]
    else:
        raw = apply_filters_taps(cheap, rows, filters.to(torch.float32), patch_size)
    return torch.where(valid, raw, 0.0)


def apply_filters_hash_reference(
    cheap: torch.Tensor, filters: torch.Tensor, *, k1d, nf: float, qstr, qcoh,
    qangle: int = 24, qstrength: int = 3, qcoherence: int = 3,
    patch_size: int = 11, patch_margin: int = 5,
) -> torch.Tensor:
    """Plain PyTorch version of apply_filters_hash: the plain hash, then the
    plain 4-phase apply_filters."""
    buckets = hash_buckets_reference(
        cheap, k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
        qstrength=qstrength, qcoherence=qcoherence)
    return apply_filters_reference(cheap, buckets, filters, patch_size=patch_size,
                                   pixel_types=4, patch_margin=patch_margin)


# -- checks and launches shared with the fused pass (ops/cuda/full_kernel.py) --


def _check_plane(cheap: torch.Tensor) -> None:
    if cheap.dim() != 2 or cheap.dtype != torch.float32 or not cheap.is_contiguous():
        raise ValueError(
            f"cheap must be a contiguous 2-D float32 tensor, got "
            f"{cheap.dtype} {tuple(cheap.shape)}"
        )


def _check_bank(filters: torch.Tensor, device: torch.device, n_rows: int,
                dtypes=(torch.float32,)) -> None:
    if (
        filters.device != device
        or filters.dtype not in dtypes
        or not filters.is_contiguous()
        or tuple(filters.shape) != (n_rows, FILTER_STRIDE)
        or filters.data_ptr() % 16
    ):
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(
            f"filters must be a contiguous, 16-byte aligned {names} "
            f"[{n_rows}, {FILTER_STRIDE}] tensor on {device}, got "
            f"{filters.dtype} {tuple(filters.shape)} on {filters.device}"
        )


def _hash_launch_args(k1d, nf, qstr, qcoh, qangle, qstrength, qcoherence,
                      patch_size=11) -> tuple:
    """The hash's arguments in the order the two C entry points that hash
    take them after the plane (raisr_full_hash_filter, raisr_hash_buckets):
    k1d, nf, the strength and coherence edges each with its count, the grid
    and qangle / pi, the sequences as ctypes float arrays (the tuple keeps
    them alive). Raises unless the kernel takes them: patch 11, qstrength - 1
    and qcoherence - 1 edges, check_bank_limits. A fused pass builds them
    once; hash_buckets and apply_filters_hash a call."""
    if patch_size != 11 or len(k1d) != 11:
        raise ValueError(f"the CUDA kernel takes patch_size 11, got {patch_size}")
    if len(qstr) != qstrength - 1 or len(qcoh) != qcoherence - 1:
        raise ValueError("qstr/qcoh must hold qstrength-1 / qcoherence-1 edges")
    check_bank_limits(qangle, qstrength, qcoherence, len(qstr), len(qcoh))

    def floats(values) -> ctypes.Array:
        return (ctypes.c_float * max(len(values), 1))(*(float(v) for v in values))

    return (floats(k1d), float(nf), floats(qstr), len(qstr), floats(qcoh), len(qcoh),
            qangle, qstrength, qcoherence, float(qangle / hashing.PI))


def _device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


# each tier's code in csrc/full_kernel.cu, read only by the two C calls that
# take one (raisr_full_hash_filter, raisr_gather_buckets)
_TIER_CODE = {"float32": 0, "bfloat16": 1, "pcenter": 2, "int8": 3}


def _launch_hash_filter(cheap, filters, raw, pixel_types, hash_args: tuple,
                        tier: str = "float32", pbias: torch.Tensor | None = None,
                        inv_scale: float | None = None) -> None:
    """Launch A (the hash into a uint8 bucket plane, then the gather with
    the phase's bank resident in shared memory) on the current stream;
    raises if a launch fails or the gather cannot get its shared memory.
    `hash_args` come from _hash_launch_args; `tier` is a tier of
    ops/cuda/full_kernel.py (pcenter with `pbias`, int8 with `inv_scale`).
    The arguments are checked by the caller."""
    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    buckets = torch.empty((h, w), dtype=torch.uint8, device=cheap.device)
    dev, stream = _device_and_stream(cheap)
    err = load_library().raisr_full_hash_filter(
        cheap.data_ptr(), filters.data_ptr(), _TIER_CODE[tier],
        pbias.data_ptr() if pbias is not None else None,
        float(inv_scale) if inv_scale is not None else 1.0,
        raw.data_ptr(), buckets.data_ptr(), h, w, pixel_types, *hash_args, dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_full_hash_filter launch failed: cudaError {err}")


# -- the wrappers -----------------------------------------------------------


def hash_buckets(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    *,
    k1d,
    nf: float,
    qstr,
    qcoh,
    qangle: int = 24,
    qstrength: int = 3,
    qcoherence: int = 3,
) -> torch.Tensor:
    """The hash launch A1 alone: each pixel's bucket as a uint8 [H, W] plane,
    the one a fused pass hands its gather. The CUDA kernel for a CUDA tensor,
    hash_buckets_reference (as uint8) for a CPU tensor; the two agree byte
    for byte. At most MAX_BUCKETS buckets and MAX_EDGES edges on every
    device. No serving path calls it: it is how the tests and the timings
    reach the kernel."""
    kw = dict(k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
              qstrength=qstrength, qcoherence=qcoherence)
    hash_args = _hash_launch_args(**kw)
    if cheap.device.type == "cpu":
        return hash_buckets_reference(cheap, **kw).to(torch.uint8)
    if cheap.device.type != "cuda":
        raise ValueError(f"hash_buckets runs on cpu or cuda, not {cheap.device}")
    _check_plane(cheap)

    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    out = torch.empty((h, w), dtype=torch.uint8, device=cheap.device)
    dev, stream = _device_and_stream(cheap)
    err = load_library().raisr_hash_buckets(
        cheap.data_ptr(), out.data_ptr(), h, w, *hash_args, dev, stream)
    if err:
        raise RuntimeError(f"raisr_hash_buckets launch failed: cudaError {err}")
    return out


def gather_buckets(
    cheap: torch.Tensor,  # [H, W] f32 (integer-valued)
    buckets: torch.Tensor,  # [H, W] uint8, every value below qangle*qstrength*qcoherence
    filters: torch.Tensor,  # [n_buckets * pixel_types, 128] f32, bf16 or int16
    *,
    pixel_types: int = 4,
    qangle: int = 24,
    qstrength: int = 3,
    qcoherence: int = 3,
    tier: str = "float32",
    pbias: torch.Tensor | None = None,
    inv_scale: float | None = None,
) -> torch.Tensor:
    """The gather launch A2 alone over a uint8 bucket plane, the form a
    fused pass runs on A1's plane: raw filtered plane out. `tier` is a tier
    of ops/cuda/full_kernel.py (pcenter with `pbias`, int8 with
    `inv_scale`). The CUDA kernel for a CUDA tensor,
    apply_filters_reference for a CPU tensor; the two agree bit for bit. A
    bucket outside the bank is refused. No serving path calls it: it is how
    the tests and the timings reach A2's hashed form."""
    n_buckets = qangle * qstrength * qcoherence
    _check_phases(pixel_types)
    check_bank_limits(qangle, qstrength, qcoherence, 0, 0)
    if buckets.dtype != torch.uint8 or buckets.shape != cheap.shape:
        raise ValueError(f"buckets must be a uint8 {tuple(cheap.shape)} tensor, got "
                         f"{buckets.dtype} {tuple(buckets.shape)}")
    if buckets.numel() and int(buckets.max()) >= n_buckets:
        raise ValueError(f"a bucket of {int(buckets.max())} is outside the bank of "
                         f"{n_buckets} buckets")
    if cheap.device.type == "cpu":
        return apply_filters_reference(cheap, buckets.to(torch.int32), filters,
                                       pixel_types=pixel_types,
                                       ratio=2 if pixel_types == 4 else 1,
                                       pbias=pbias, inv_scale=inv_scale)
    if cheap.device.type != "cuda":
        raise ValueError(f"gather_buckets runs on cpu or cuda, not {cheap.device}")
    _check_plane(cheap)
    if buckets.device != cheap.device or not buckets.is_contiguous():
        raise ValueError(f"buckets must be contiguous on {cheap.device}")
    _check_bank(filters, cheap.device, n_buckets * pixel_types,
                (torch.float32, torch.bfloat16, torch.int16))

    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    raw = torch.empty_like(cheap)
    dev, stream = _device_and_stream(cheap)
    err = load_library().raisr_gather_buckets(
        cheap.data_ptr(), buckets.data_ptr(), filters.data_ptr(), _TIER_CODE[tier],
        pbias.data_ptr() if pbias is not None else None,
        float(inv_scale) if inv_scale is not None else 1.0,
        raw.data_ptr(), h, w, pixel_types, qangle, qstrength, qcoherence, dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_gather_buckets launch failed: cudaError {err}")
    return raw


def apply_filters(
    cheap: torch.Tensor,  # [H, W] f32
    buckets: torch.Tensor,  # [H, W] int32
    filters: torch.Tensor,  # [n_buckets * pixel_types, 128] f32
    *,
    patch_size: int = 11,
    pixel_types: int = 4,  # 4: ratio-2 bank, row bucket*4 + phase; 1: row bucket
    patch_margin: int = 5,
    ratio: int = 2,
) -> torch.Tensor:
    """Raw filtered plane: bank[row] . patch per pixel, 0 where the bucket is
    outside [0, n_buckets). The CUDA kernel for a CUDA tensor (float32, as
    the JAX function; a bank too large for its shared memory is refused,
    `check_gather_smem`), apply_filters_reference for a CPU tensor."""
    kw = dict(patch_size=patch_size, pixel_types=pixel_types,
              patch_margin=patch_margin, ratio=ratio)
    if cheap.device.type == "cpu":
        return apply_filters_reference(cheap, buckets, filters, **kw)
    if cheap.device.type != "cuda":
        raise ValueError(f"apply_filters runs on cpu or cuda, not {cheap.device}")
    _check_phases(pixel_types, ratio)
    _check_plane(cheap)
    if (buckets.dtype != torch.int32 or buckets.shape != cheap.shape
            or buckets.device != cheap.device or not buckets.is_contiguous()):
        raise ValueError(
            f"buckets must be a contiguous int32 {tuple(cheap.shape)} tensor on "
            f"{cheap.device}, got {buckets.dtype} {tuple(buckets.shape)} on "
            f"{buckets.device}"
        )
    if patch_size != 11 or patch_margin != 5:
        raise ValueError(
            f"the CUDA kernel takes patch_size 11 and patch_margin 5, got "
            f"{patch_size} and {patch_margin}"
        )
    n_buckets = filters.shape[0] // pixel_types
    _check_bank(filters, cheap.device, n_buckets * pixel_types)
    check_gather_smem(n_buckets, pixel_types)

    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    raw = torch.empty_like(cheap)
    dev, stream = _device_and_stream(cheap)
    err = load_library().raisr_filter_apply(
        cheap.data_ptr(), buckets.data_ptr(), filters.data_ptr(), raw.data_ptr(),
        h, w, pixel_types, n_buckets, dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_filter_apply launch failed: cudaError {err}")
    global LAUNCHES, SINGLE_LAUNCHES
    if pixel_types == 1:
        SINGLE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return raw


def apply_filters_hash(
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
    patch_margin: int = 5,
) -> torch.Tensor:
    """Hash + filter apply (ratio 2, 4 phases): cheap plane in, raw filtered
    plane out. Launch A for a CUDA tensor, apply_filters_hash_reference for a
    CPU tensor."""
    kw = dict(k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
              qstrength=qstrength, qcoherence=qcoherence)
    if cheap.device.type == "cpu":
        return apply_filters_hash_reference(
            cheap, filters, patch_size=patch_size, patch_margin=patch_margin, **kw)
    if cheap.device.type != "cuda":
        raise ValueError(f"apply_filters_hash runs on cpu or cuda, not {cheap.device}")
    _check_plane(cheap)
    _check_bank(filters, cheap.device, qangle * qstrength * qcoherence * 4)
    hash_args = _hash_launch_args(patch_size=patch_size, **kw)
    if patch_margin != 5:
        raise ValueError(f"the CUDA kernel takes patch_margin 5, got {patch_margin}")
    raw = torch.empty_like(cheap)
    _launch_hash_filter(cheap, filters, raw, 4, hash_args)
    global HASH_LAUNCHES
    HASH_LAUNCHES += 1
    return raw
