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
`hash_buckets` runs the hash launch A1 alone (a uint8 bucket plane), for
the tests and the timings of the kernel; no serving path calls it.
The TPU knobs (tb2, rowbatch, mxu_passes, interpret) have no meaning here and
are gone: the card computes plain float32 at every bit depth, so the 10-bit
case (mxu_passes=3 on the TPU) needs nothing extra.

Each wrapper runs its kernel on a CUDA tensor and its plain version on a CPU
tensor; there is no fallback. `LAUNCHES`, `SINGLE_LAUNCHES` and `HASH_LAUNCHES`
count the calls that went through a kernel: apply_filters with 4 and with 1
phase, and apply_filters_hash. `HASH_TILES` counts the tiles of every A1
launch (a fused pass, apply_filters_hash, hash_buckets) by the path they
take: "interior" (no bounds tests) and "edge" (`hash_tile_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from raisr_tpu_torch.ops import hashing
from raisr_tpu_torch.ops.filter_apply import apply_filters_taps

LAUNCHES = 0  # apply_filters, 4 phases, through the gather launch
SINGLE_LAUNCHES = 0  # apply_filters, 1 phase, through the gather launch
HASH_LAUNCHES = 0  # apply_filters_hash, through launch A
HASH_TILES = {"interior": 0, "edge": 0}  # A1's tiles by path, over every A1 launch

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


def gather_smem_bytes(n_buckets: int, pixel_types: int) -> int:
    """Dynamic shared memory of one block of the float32 gather launch
    (csrc/full_kernel.cu GatherSmem::bytes): the phase's `n_buckets` rows,
    taps 0..120 in an odd number of 16-byte groups (31: 496 B a row), then
    two tile buffers for each of the block's 4 groups: the patch region of
    16 x 32 same-phase pixels, 41 rows of 74 words for 4 phases, 26 of 42
    for 1."""
    row_bytes = 16 * (-(-N_TAPS // 4) | 1)
    step = 2 if pixel_types == 4 else 1
    tile_rows, tile_cols = step * 15 + 11, step * 31 + 11
    tile_words = tile_rows * step * (-(-tile_cols // step))
    return n_buckets * row_bytes + 2 * 4 * tile_words * 4


def check_gather_smem(n_buckets: int, pixel_types: int) -> None:
    """apply_filters' size rule: the float32 rows of one phase must fit in a
    block's shared memory beside the tile buffers (at most 272 buckets with
    4 phases, 398 with 1). Raises a ValueError that names the byte counts;
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


def _count_hash_tiles(h: int, w: int) -> None:
    interior, edge = hash_tile_counts(h, w)
    HASH_TILES["interior"] += interior
    HASH_TILES["edge"] += edge


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


def _check_hash_args(k1d, qstr, qcoh, qangle, qstrength, qcoherence, patch_size) -> None:
    if patch_size != 11 or len(k1d) != 11:
        raise ValueError(f"the CUDA kernel takes patch_size 11, got {patch_size}")
    if len(qstr) != qstrength - 1 or len(qcoh) != qcoherence - 1:
        raise ValueError("qstr/qcoh must hold qstrength-1 / qcoherence-1 edges")
    check_bank_limits(qangle, qstrength, qcoherence, len(qstr), len(qcoh))


def _device_and_stream(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def _floats(values) -> ctypes.Array:
    return (ctypes.c_float * max(len(values), 1))(*(float(v) for v in values))


def _launch_hash_filter(cheap, filters, raw, pixel_types, *, k1d, nf, qstr, qcoh,
                        qangle, qstrength, qcoherence, tier: int = 0,
                        pbias: torch.Tensor | None = None,
                        inv_scale: float | None = None) -> None:
    """Launch A (the hash into a uint8 bucket plane, then the gather with
    the phase's bank resident in shared memory) on the current stream;
    raises if a launch fails or the gather cannot get its shared memory.
    `tier` is csrc/full_kernel.cu's tier code (0 float32, 1 bfloat16,
    2 pcenter with `pbias`, 3 int8 with `inv_scale`). The arguments are
    checked by the caller."""
    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    buckets = torch.empty((h, w), dtype=torch.uint8, device=cheap.device)
    dev, stream = _device_and_stream(cheap)
    k1d_c, qstr_c, qcoh_c = _floats(k1d), _floats(qstr), _floats(qcoh)
    err = load_library().raisr_full_hash_filter(
        cheap.data_ptr(), filters.data_ptr(), tier,
        pbias.data_ptr() if pbias is not None else None,
        float(inv_scale) if inv_scale is not None else 1.0,
        raw.data_ptr(), buckets.data_ptr(), h, w, pixel_types,
        ctypes.addressof(k1d_c), float(nf),
        ctypes.addressof(qstr_c), len(qstr), ctypes.addressof(qcoh_c), len(qcoh),
        qangle, qstrength, qcoherence, float(qangle / hashing.PI), dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_full_hash_filter launch failed: cudaError {err}")
    _count_hash_tiles(h, w)


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
    _check_hash_args(k1d, qstr, qcoh, qangle, qstrength, qcoherence, 11)
    kw = dict(k1d=k1d, nf=nf, qstr=qstr, qcoh=qcoh, qangle=qangle,
              qstrength=qstrength, qcoherence=qcoherence)
    if cheap.device.type == "cpu":
        return hash_buckets_reference(cheap, **kw).to(torch.uint8)
    if cheap.device.type != "cuda":
        raise ValueError(f"hash_buckets runs on cpu or cuda, not {cheap.device}")
    _check_plane(cheap)

    from raisr_tpu_torch.ops.cuda._build import load_library

    h, w = cheap.shape
    out = torch.empty((h, w), dtype=torch.uint8, device=cheap.device)
    dev, stream = _device_and_stream(cheap)
    k1d_c, qstr_c, qcoh_c = _floats(k1d), _floats(qstr), _floats(qcoh)
    err = load_library().raisr_hash_buckets(
        cheap.data_ptr(), out.data_ptr(), h, w, ctypes.addressof(k1d_c), float(nf),
        ctypes.addressof(qstr_c), len(qstr), ctypes.addressof(qcoh_c), len(qcoh),
        qangle, qstrength, qcoherence, float(qangle / hashing.PI), dev, stream,
    )
    if err:
        raise RuntimeError(f"raisr_hash_buckets launch failed: cudaError {err}")
    _count_hash_tiles(h, w)
    return out


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
    _check_hash_args(k1d, qstr, qcoh, qangle, qstrength, qcoherence, patch_size)
    if patch_margin != 5:
        raise ValueError(f"the CUDA kernel takes patch_margin 5, got {patch_margin}")
    raw = torch.empty_like(cheap)
    _launch_hash_filter(cheap, filters, raw, 4, **kw)
    global HASH_LAUNCHES
    HASH_LAUNCHES += 1
    return raw
