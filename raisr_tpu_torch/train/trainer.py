"""RAISR filter training: hashed least squares per (bucket, pixel type).

Port of raisr_tpu/train/trainer.py; `train_step_sharded` spreads the pairs
over a mesh of devices (parallel/sharding.py). Per (bucket, pixelType) the
normal equations

    Q[f] += A^T A,   V[f] += A^T y

are accumulated over (cheap-upscaled LR, HR) pairs, where the rows of A are
the 11x11 patches of the cheap upscale whose centre hashes to filter f, then
(Q + lam I) w = V is solved for all filters at once. The accumulation is the
hand-written CUDA kernel of ops/cuda/normal_eq.py on the card (it gathers
each filter's pixels where the TPU contracts a one-hot matrix), its plain
PyTorch version on the CPU. The CT-aware sweep's provisional filtered plane
and the second-pass bank's pass-1 output go through the port's filter-apply
kernel (ops/cuda/filter_kernel.apply_filters) and epilogue kernel
(ops/cuda/full_kernel.pass_epilogue).

Every entry point takes `device` (default "cuda"); without a card a CUDA
device is refused with a RaisrError, and a kernel that fails raises.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from raisr_tpu_torch.config import RaisrConfig
from raisr_tpu_torch.engine import resolve_device, unpack_planes
from raisr_tpu_torch.model.gaussian import gaussian_weights
from raisr_tpu_torch.model.loader import FilterBank, RaisrModel
from raisr_tpu_torch.ops import census, hashing
from raisr_tpu_torch.ops.cuda.filter_kernel import apply_filters
from raisr_tpu_torch.ops.cuda.full_kernel import pass_epilogue
from raisr_tpu_torch.ops.cuda.normal_eq import accumulate_normal_eq, normal_eq_reference
from raisr_tpu_torch.ops.pipeline import pass_statics
from raisr_tpu_torch.ops.resize import cheap_upscale


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    ratio: float = 2.0
    bits: int = 8
    qangle: int = 24
    qstrength: int = 3
    qcoherence: int = 3
    patch_size: int = 11
    # strength/coherence bin edges; defaults match the shipped 2x banks
    qstr: tuple[float, ...] = (0.001269, 0.022169)
    qcoh: tuple[float, ...] = (0.192916, 0.405942)
    lam: float = 0.01  # Tikhonov regularization for the normal equations
    # rows per chunk of the plain accumulation (normal_eq_reference); the
    # CUDA kernel takes a filter's pixels in runs of its own
    chunk: int = 2048
    # accumulate each pair under all 8 dihedral transforms (rot90/flip of
    # both images), the standard RAISR augmentation (RAISR paper sec. IV-C)
    augment_symmetry: bool = False
    # cheap-upscale resampler the bank is trained against: must match the
    # inference RaisrConfig.resize_mode
    resize_mode: str = "bilinear"

    @property
    def pixel_types(self) -> int:
        return int(self.ratio) * int(self.ratio)

    # full-range reject bounds of the CT-aware sweep's provisional plane
    # (training content is full-range; not RaisrConfig's video range)
    @property
    def min_val(self) -> int:
        return 0

    @property
    def max_val(self) -> int:
        return (1 << self.bits) - 1

    @property
    def num_buckets(self) -> int:
        return self.qangle * self.qstrength * self.qcoherence

    @property
    def num_filters(self) -> int:
        return self.num_buckets * self.pixel_types


def _edges(values) -> tuple[float, ...]:
    """Bin edges as the float32 values JAX compares against."""
    return tuple(float(x) for x in np.asarray(values, np.float32))


def _core(h: int, w: int, cfg: TrainConfig) -> tuple[slice, slice]:
    lm = cfg.patch_size // 2 + 1
    return slice(lm, h - lm), slice(lm, w - lm)


def _hash(cheap: torch.Tensor, patch_size: int, bits: int, qstr, qcoh, qangle: int,
          qstrength: int, qcoherence: int) -> torch.Tensor:
    """The 2-D hash raisr_tpu trains and runs its taps pass with: gradients,
    the structure tensor with the literal Gaussian window (not the
    separable form of the fused pass's launch A1), bucket quantization.
    Returns the int32 bucket plane."""
    gx, gy = hashing.gradients(cheap)
    a, b, d = hashing.structure_tensor(gx, gy, gaussian_weights(patch_size, bits))
    return hashing.hash_buckets(a, b, d, qstr, qcoh, qangle, qstrength, qcoherence)


def _filter_index(cheap: torch.Tensor, cfg: TrainConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The hash of raisr_tpu's _patches_and_labels, without its im2col (the
    kernel reads the patches from the plane): `_hash` and the pixel phase
    (patch margin 5). Returns the bucket plane [H, W] int32 and the filter
    index bucket * pixel_types + phase over the core [H - 12, W - 12],
    contiguous int32."""
    m = cfg.patch_size // 2
    h, w = cheap.shape
    buckets = _hash(cheap, cfg.patch_size, cfg.bits, _edges(cfg.qstr), _edges(cfg.qcoh),
                    cfg.qangle, cfg.qstrength, cfg.qcoherence)
    ptype = hashing.pixel_types(h, w, int(cfg.ratio), m, cfg.pixel_types > 1,
                                device=cheap.device)
    idx = buckets * cfg.pixel_types + ptype
    return buckets, idx[_core(h, w, cfg)].contiguous()


def _accumulate(q, v, cheap, label, idx, cfg: TrainConfig, weight=None):
    """The normal-equation kernel on the card; on the CPU its plain version,
    `cfg.chunk` rows at a time."""
    if cheap.device.type == "cpu":
        return normal_eq_reference(q, v, cheap, label, idx, weight, chunk=cfg.chunk)
    return accumulate_normal_eq(q, v, cheap, label, idx, weight)


def accumulate_pair(
    q: torch.Tensor,  # [num_filters, 121, 121] f32, updated in place
    v: torch.Tensor,  # [num_filters, 121] f32, updated in place
    cheap: torch.Tensor,  # [H, W] integer-valued f32 (cheap-upscaled LR)
    hr: torch.Tensor,  # [H, W] integer-valued f32 (ground truth)
    cfg: TrainConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Add one image pair's normal-equation contributions to (Q, V), in
    place; returns (q, v)."""
    _, idx = _filter_index(cheap, cfg)
    return _accumulate(q, v, cheap, hr, idx, cfg)


def accumulate_pair_ct(
    q: torch.Tensor,
    v: torch.Tensor,
    cheap: torch.Tensor,  # [H, W] integer-valued f32 (cheap-upscaled LR)
    hr: torch.Tensor,  # [H, W] integer-valued f32 (ground truth)
    filters: torch.Tensor,  # [num_filters, 128] f32 provisional bank
    cfg: TrainConfig,
    blending: int,  # 1 = Randomness, 2 = CountOfBitsChanged
) -> tuple[torch.Tensor, torch.Tensor]:
    """CT-blend-aware weighted accumulation, in place; returns (q, v).

    At inference the filter reaches the output only through the census
    blend, out = s*filtered + (1-s)*cheap, with s = w for Randomness and
    s = 1-w for CountOfBitsChanged. Minimizing the blended error
    (y - (1-s) c - s p^T f)^2 is a weighted least squares: rows scale by s,
    labels become y - (1-s) c. For CountOfBitsChanged s depends on the
    filtered plane, so the caller passes a provisional bank: its raw plane
    is apply_filters over the hashed buckets, rejected against the
    full-range bounds (exclusive), the border kept as cheap; the weights are
    taken on that unrounded plane (no zone mask), as raisr_tpu does."""
    h, w = cheap.shape
    core = _core(h, w, cfg)
    buckets, idx = _filter_index(cheap, cfg)
    raw = apply_filters(cheap, buckets, filters, patch_size=cfg.patch_size,
                        pixel_types=cfg.pixel_types, patch_margin=cfg.patch_size // 2,
                        ratio=int(cfg.ratio))[core]
    c_vals = cheap[core]
    keep = (raw > float(cfg.min_val)) & (raw < float(cfg.max_val))
    plane = cheap.clone()
    plane[core] = torch.where(keep, raw, c_vals)
    if blending == 1:
        s = census.randomness_weight(cheap)
    else:
        s = 1.0 - census.cobc_weight(cheap, plane)
    label = hr - (1.0 - s) * cheap
    return _accumulate(q, v, cheap, label.contiguous(), idx, cfg, s.contiguous())


def init_accumulators(cfg: TrainConfig, device: torch.device | str = "cpu"):
    n_taps = cfg.patch_size * cfg.patch_size
    q = torch.zeros((cfg.num_filters, n_taps, n_taps), dtype=torch.float32, device=device)
    v = torch.zeros((cfg.num_filters, n_taps), dtype=torch.float32, device=device)
    return q, v


def solve_filters(q: torch.Tensor, v: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Regularized normal-equation solve -> [num_filters, 128] padded.

    Per-bucket relative Tikhonov regularization toward the identity filter:
        (Q + lam_b I) w = V + lam_b e_center,  lam_b = lam * trace(Q_b)/taps,
    plus 1e-8, solved batched in float32 (an LU solve: the TF32 matmul flag
    does not reach it). A bucket no pixel reached (trace 0, so Q and V are
    0) is the identity filter exactly."""
    n_taps = q.shape[-1]
    eye = torch.eye(n_taps, dtype=torch.float32, device=q.device)
    identity = torch.zeros(n_taps, dtype=torch.float32, device=q.device)
    identity[n_taps // 2] = 1.0
    trace = torch.diagonal(q, dim1=-2, dim2=-1).sum(-1)
    lam_b = cfg.lam * trace / n_taps + 1e-8
    a = q + lam_b[:, None, None] * eye[None]
    rhs = v + lam_b[:, None] * identity[None, :]
    w = torch.linalg.solve(a, rhs[..., None])[..., 0]
    w = torch.where((trace == 0)[:, None], identity[None, :], w)
    aligned = 16 * ((n_taps + 15) // 16)
    return F.pad(w, (0, aligned - n_taps))


def box_down2(x):
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def area_down_2of3(x):
    """Exact area resampling by 2/3 along both axes (for ratio 1.5):
    output pixel i covers source [1.5i, 1.5i + 1.5), so each 3-sample
    group yields 2 outputs with weights (1, 1/2)/1.5 and (1/2, 1)/1.5."""
    def rows(v):
        g = v.reshape(v.shape[0] // 3, 3, *v.shape[1:])
        a = (g[:, 0] + 0.5 * g[:, 1]) / 1.5
        b = (0.5 * g[:, 1] + g[:, 2]) / 1.5
        return np.stack([a, b], axis=1).reshape(-1, *v.shape[1:])

    return rows(rows(x.T).T)


def degrade(hr: np.ndarray, ratio: float, bits: int) -> tuple[np.ndarray, np.ndarray]:
    """One training pair from an HR plane, as `raisr train` makes it: the
    plane cropped to a multiple of 2 (ratio 2) or 3 (ratio 1.5), LR = its
    box (2x) or exact 2/3 area (1.5x) downscale, rounded half up and
    clipped to the bit depth. Returns (lr, hr) as uint16."""
    mod = 2 if ratio == 2.0 else 3
    h, w = hr.shape
    hr = hr[:h - h % mod, :w - w % mod].astype(np.float64)
    down = box_down2(hr) if ratio == 2.0 else area_down_2of3(hr)
    lr = np.clip(np.floor(down + 0.5), 0, (1 << bits) - 1).astype(np.uint16)
    return lr, hr.astype(np.uint16)


def _dihedral_transforms(lr, hr, enabled: bool):
    """Yield (lr, hr) under the dihedral group D4 (identity only if
    disabled), as contiguous arrays: np.rot90 and [:, ::-1] give views with
    negative strides, which torch.from_numpy refuses."""
    lr = np.asarray(lr)
    hr = np.asarray(hr)
    if not enabled:
        yield lr, hr
        return
    for flip in (False, True):
        lr_f = lr[:, ::-1] if flip else lr
        hr_f = hr[:, ::-1] if flip else hr
        for k in range(4):
            yield (np.ascontiguousarray(np.rot90(lr_f, k)),
                   np.ascontiguousarray(np.rot90(hr_f, k)))


def _plane(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _oriented_pairs(pairs, cfg: TrainConfig, device: torch.device):
    """(lr, hr) float32 planes on `device` for every pair and orientation."""
    for lr, hr in pairs:
        for lr_t, hr_t in _dihedral_transforms(lr, hr, cfg.augment_symmetry):
            yield _plane(lr_t, device), _plane(hr_t, device)


def _cheap(lr: torch.Tensor, hr: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    return cheap_upscale(lr, hr.shape[0], hr.shape[1], cfg.bits, mode=cfg.resize_mode)


def _bank(filters: torch.Tensor, cfg: TrainConfig) -> FilterBank:
    return FilterBank(
        filters=filters.cpu().numpy(),
        qstr=np.asarray(cfg.qstr, np.float32),
        qcoh=np.asarray(cfg.qcoh, np.float32),
        pixel_types=cfg.pixel_types,
        taps=cfg.patch_size * cfg.patch_size,
        source_dtype="fp32",
    )


def train_filterbank(
    pairs: Iterable[tuple[np.ndarray, np.ndarray]],
    cfg: TrainConfig,
    device: torch.device | str = "cuda",
) -> FilterBank:
    """Train from (lr, hr) uint pairs on one device."""
    dev = resolve_device(device)
    q, v = init_accumulators(cfg, dev)
    for lr, hr in _oriented_pairs(pairs, cfg, dev):
        accumulate_pair(q, v, _cheap(lr, hr, cfg), hr, cfg)
    return _bank(solve_filters(q, v, cfg), cfg)


def train_filterbank_ct(
    pairs_factory,  # () -> Iterable[(lr, hr)]; called twice (two sweeps)
    cfg: TrainConfig,
    blending: int = 2,
    device: torch.device | str = "cuda",
) -> FilterBank:
    """Train a CT-blend-aware bank (see accumulate_pair_ct).

    Sweep 1 trains a plain bank (the fixed-point seed that defines the
    CountOfBitsChanged weights); sweep 2 re-accumulates the normal equations
    weighted by each pixel's blend share and re-solves. Randomness weights do
    not depend on the bank, but both modes keep the two sweeps."""
    dev = resolve_device(device)
    bank0 = train_filterbank(pairs_factory(), cfg, dev)
    f0 = torch.tensor(bank0.filters, device=dev)
    q, v = init_accumulators(cfg, dev)
    for lr, hr in _oriented_pairs(pairs_factory(), cfg, dev):
        accumulate_pair_ct(q, v, _cheap(lr, hr, cfg), hr, f0, cfg, blending)
    return _bank(solve_filters(q, v, cfg), cfg)


def train_step_sharded(
    lr_batch: torch.Tensor,  # [N, h, w], N split over the mesh's `axis`
    hr_batch: torch.Tensor,  # [N, H, W]
    cfg: TrainConfig,
    mesh,
    axis: str = "data",
    ct_filters: torch.Tensor | None = None,  # the seed bank -> the CT-blend-aware
    #   weighted step (accumulate_pair_ct); None = plain least squares
    blending: int = 2,
) -> torch.Tensor:
    """One distributed training step (raisr_tpu/train/trainer.py:382-428):
    each data shard accumulates its pairs' normal equations on its own
    device (accumulate_pair, or accumulate_pair_ct with `ct_filters`: the
    sharded second sweep of train_filterbank_ct), then Q and V are summed
    onto the first device in mesh order, a fixed order, so the bank is the
    same bit for bit from run to run, and solved once there. Returns the
    solved [num_filters, 128] bank on the first device. `mesh` is a
    parallel.sharding.Mesh; no augmentation, as in raisr_tpu."""
    devs = list(mesh.grid(axis))
    n = lr_batch.shape[0]
    if n % len(devs):
        raise ValueError(f"{n} training pairs do not divide over {len(devs)} devices")
    k = n // len(devs)
    out_h, out_w = hr_batch.shape[1], hr_batch.shape[2]
    sums = []
    for i, dev in enumerate(devs):
        q, v = init_accumulators(cfg, dev)
        f0 = None if ct_filters is None else ct_filters.to(dev, torch.float32)
        for j in range(i * k, (i + 1) * k):
            hr = unpack_planes(hr_batch[j].to(dev))
            cheap = cheap_upscale(unpack_planes(lr_batch[j].to(dev)), out_h, out_w,
                                  cfg.bits, mode=cfg.resize_mode)
            if f0 is None:
                accumulate_pair(q, v, cheap, hr, cfg)
            else:
                accumulate_pair_ct(q, v, cheap, hr, f0, cfg, blending)
        sums.append((q, v))
    q, v = sums[0]
    for qi, vi in sums[1:]:
        q = q + qi.to(devs[0])
        v = v + vi.to(devs[0])
    return solve_filters(q, v, cfg)


def _taps_pass(cheap: torch.Tensor, filters: torch.Tensor, statics) -> torch.Tensor:
    """raisr_tpu's taps pass (ops/pipeline.raisr_pass, backend "taps") on the
    port's kernels: the 2-D hash, apply_filters (bit-identical to the taps
    filter apply at float32), then launch B (pass_epilogue, bit-identical
    to the plain epilogue) with the statics' range, blending and edges."""
    s = statics
    buckets = _hash(cheap, s.patch_size, s.bits, *s.bank_edges[0], s.qangle, s.qstrength,
                    s.qcoherence)
    raw = apply_filters(cheap, buckets, filters, patch_size=s.patch_size,
                        pixel_types=4 if s.use_pixel_type else 1,
                        patch_margin=s.patch_margin, ratio=s.ratio_int)
    return pass_epilogue(cheap, raw, min_val=s.min_val, max_val=s.max_val,
                         blending=s.blending, patch_size=s.patch_size,
                         exact_edges=s.exact_edges)


def train_filterbank_pass2(
    pairs: Iterable[tuple[np.ndarray, np.ndarray]],
    cfg: TrainConfig,
    bank1: FilterBank,
    device: torch.device | str = "cuda",
) -> FilterBank:
    """Train a second-pass (sharpening) bank on top of a trained pass-1 bank,
    the role of the reference's shipped `filterbin_*_2` files.

    Two-pass mode 1: the pass-2 input is the first pass's full inference
    output (filtered, census-blended, integer-quantized) at HR scale, with
    raisr_tpu's RaisrConfig(bits, ratio, passes=1, resize_mode) statics
    (video range, CountOfBitsChanged, exact edges); the target is the HR."""
    dev = resolve_device(device)
    model1 = RaisrModel(qangle=cfg.qangle, qstrength=cfg.qstrength,
                        qcoherence=cfg.qcoherence, patch_size=cfg.patch_size,
                        banks=(bank1,))
    rcfg = RaisrConfig(bits=cfg.bits, ratio=cfg.ratio, passes=1,
                       resize_mode=cfg.resize_mode)
    statics = pass_statics(rcfg, model1, "taps")
    f1 = torch.tensor(np.asarray(bank1.filters, np.float32), device=dev)
    q, v = init_accumulators(cfg, dev)
    for lr, hr in _oriented_pairs(pairs, cfg, dev):
        pass1 = _taps_pass(_cheap(lr, hr, cfg), f1, statics)
        accumulate_pair(q, v, pass1, hr, cfg)
    return _bank(solve_filters(q, v, cfg), cfg)
