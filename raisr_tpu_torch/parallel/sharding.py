"""Multi-device sharding for RAISR, from one process.

Port of raisr_tpu/parallel/sharding.py. The reference's only compute
parallelism is a thread pool slicing each frame into halo-expanded
horizontal row segments (reference: Library/Raisr.cpp:1369-1394, zones
:1742-1779). JAX drives a mesh of chips from one controller (shard_map over
Mesh(devices, ("data", "rows"))); this module does the same from one Python
process over a `Mesh` of torch devices, with no process group:

  data parallelism   a batch's frames split over the data axis; each device
                     runs the guard-banded stacked pipeline
                     (process_plane_y_batch) on its own frames. No
                     communication.
  row stripes        one frame's rows split over the rows axis; before each
                     pass every stripe gets its neighbours' boundary rows
                     (the halo) as a copy to its own device, runs the pass
                     there and keeps its core rows.

A shard's work is enqueued on its device's current stream; a halo, a shard's
input and the gathered output are `.to(device, non_blocking=True)` copies,
which PyTorch orders against the current streams of both devices. Nothing
here waits for the device or reads a value back, so on several cards the
shards run concurrently. A mesh may name one device more than once
(make_mesh(devices=[dev] * n)): its shards then run one after another on that
device, with real halo copies, as the JAX tests run their sharded paths on
virtual CPU devices.

Row stripes run the same pass as whole frames: ops/pipeline.raisr_pass with
`row0`/`zone_h`, which put every zone and pixel phase at global rows, so on
the fused backend a stripe launches the same CUDA kernel as a frame. Stripes
start on even rows, so the kernel's local pixel phases are the frame's.

Exactness: data-parallel and striped outputs equal the unsharded pipeline
bit for bit at every ratio, tier and backend. The halo covers the resize,
patch, gradient and census support; zones use global rows; and the striped
resize (_upscale_stripe) does the whole-plane resize's arithmetic on the
same values (raisr_tpu's striped non-2x resize may flip an exact .5 tie,
since XLA fuses the two forms differently; eager PyTorch does not).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from raisr_tpu_torch.ops.pipeline import (
    PassBank,
    PassStatics,
    process_plane_y_batch,
    raisr_pass,
)
from raisr_tpu_torch.ops.resize import (
    _axis_vectors,
    _axis_weights,
    _axis_weights_exact,
    _plane_exact,
    _rounded,
    _separable,
)

# Halo (in HR rows) a stripe needs beyond its core rows: patch/gradient
# support (loop_margin = 6) + census margin (1), rounded up to an even 8.
HR_HALO = 8


def _device(d) -> torch.device:
    """A torch.device, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An array of torch devices with named axes, as jax.sharding.Mesh:
    `devices` is an object array of torch.device (one may appear more than
    once), `shape` maps each axis name to its size."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                             f"got {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = [_device(d) for d in arr.reshape(-1)]
        self.shape = dict(zip(self.axis_names, arr.shape))

    def grid(self, *axes: str) -> np.ndarray:
        """The devices along `axes`, in that order, at index 0 of every other
        axis (a shard_map spec that names only `axes` replicates the work
        over the others; here the first copy does it)."""
        order = [self.axis_names.index(a) for a in axes]
        moved = np.moveaxis(self.devices, order, list(range(len(order))))
        return moved[(Ellipsis,) + (0,) * (moved.ndim - len(order))]

    def distinct(self) -> list[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.reshape(-1)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_devices: int | None = None, axis_names=("data", "rows"),
              devices=None) -> Mesh:
    """Mesh over `devices` (by default the visible CUDA cards): frames x row
    stripes, in raisr_tpu's shape, (n // 2, 2) for an even n >= 4, else
    (n, 1), or (n,) over one axis name. `devices` may name a device more than
    once, e.g. [torch.device("cpu")] * 8 or [torch.device("cuda", 0)] * 4."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_device(d) for d in devices]
    n = n_devices if n_devices is not None else len(devices)
    if n < 1 or len(devices) < n:
        raise ValueError(
            f"make_mesh: {n} devices requested but only {len(devices)} visible; "
            "name them with devices=[...], where one device may repeat "
            "(e.g. [torch.device('cpu')] * n)"
        )
    flat = np.empty(n, dtype=object)
    flat[:] = devices[:n]
    if len(axis_names) == 1:
        shape = (n,)
    elif n % 2 == 0 and n >= 4:
        shape = (n // 2, 2)
    else:
        shape = (n, 1)
    return Mesh(flat.reshape(shape), axis_names)


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: asynchronous into a CUDA device (PyTorch orders the
    copy against both devices' current streams); into host memory it waits,
    since a non-blocking copy to pageable memory may not have landed."""
    return t.to(device, non_blocking=device.type == "cuda")


# --------------------------------------------------------------------------
# Data parallelism over a batch of frames
# --------------------------------------------------------------------------


def process_batch_dp(
    batch_lr: torch.Tensor,
    banks: dict[torch.device, tuple[PassBank, ...]],
    statics: PassStatics,
    passes: int,
    two_pass_mode: int,
    out_h: int,
    out_w: int,
    mesh: Mesh,
    axis: str = "data",
) -> torch.Tensor:
    """[N, H, W] -> [N, oH, oW], N split over `axis`. Pure DP, no
    communication: each device runs the batched path on its own frames
    (guard-banded stack, one fused launch per pass) with its own pass banks
    (`banks`: each mesh device's pass_banks, as RaisrEngine._banks), and the
    outputs come back in mesh order onto the input's device."""
    devs = list(mesh.grid(axis))
    n = batch_lr.shape[0]
    if n % len(devs):
        raise ValueError(f"batch of {n} frames does not divide over {len(devs)} devices")
    k = n // len(devs)
    outs = [
        process_plane_y_batch(_to(batch_lr[i * k:(i + 1) * k], d), banks[d],
                              statics, passes, two_pass_mode, out_h, out_w)
        for i, d in enumerate(devs)
    ]
    return torch.cat([_to(o, batch_lr.device) for o in outs])


# --------------------------------------------------------------------------
# Spatial (row-stripe) parallelism within one frame
# --------------------------------------------------------------------------


def _exchange_halo(stripes: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Each stripe as [halo from above, stripe, halo from below], on its own
    device. The first and last stripes replicate their own edge row, which
    reproduces the whole-frame border-replicate clamp."""
    n = len(stripes)
    out = []
    for i, s in enumerate(stripes):
        up = (_to(stripes[i - 1][-halo:], s.device) if i > 0
              else s[:1].expand(halo, s.shape[1]))
        down = (_to(stripes[i + 1][:halo], s.device) if i < n - 1
                else s[-1:].expand(halo, s.shape[1]))
        out.append(torch.cat([up, s, down]))
    return out


@functools.lru_cache(maxsize=64)
def _stripe_rows(lr_h: int, out_h: int, exact: bool, hr_halo: int, hr_stripe: int,
                 lr_stripe: int, lr_halo: int, idx: int, device: torch.device):
    """Row vectors (idx0, idx1, weight, den) of stripe `idx`'s upscale, as
    indices into its LR rows with halo. They are the whole-plane resize's
    vectors (resize._axis_weights_exact at an exact ratio, else
    _axis_weights) for global rows [-hr_halo, out_h + hr_halo), the rows
    outside the frame copying its edge row at weight 0, sliced to the
    stripe; built on the host once per stripe and device."""
    if exact:
        r0, r1, w, den = _axis_weights_exact(lr_h, out_h)
    else:
        (r0, r1, w), den = _axis_weights(lr_h, out_h), 1.0
    top, bot = np.zeros(hr_halo, np.int64), np.full(hr_halo, lr_h - 1, np.int64)
    zero = np.zeros(hr_halo, np.float32)
    r0 = np.concatenate([top, r0, bot])
    r1 = np.concatenate([np.minimum(top + 1, lr_h - 1), r1, bot])
    w = np.concatenate([zero, w, zero])
    start, total = idx * hr_stripe, hr_stripe + 2 * hr_halo
    lr_start = idx * lr_stripe - lr_halo  # global LR row of the stripe's row 0
    last = lr_stripe + 2 * lr_halo - 1

    def local(r):
        return torch.tensor(np.clip(r[start:start + total] - lr_start, 0, last), device=device)

    return local(r0), local(r1), torch.tensor(w[start:start + total], device=device), den


def _upscale_stripe(
    lr_ext: torch.Tensor, lr_halo: int, out_rows: int, hr_halo: int, out_w: int,
    out_h_global: int, bits: int, lr_h_global: int, idx: int, lr_stripe_rows: int,
) -> torch.Tensor:
    """Cheap-upscale stripe `idx`'s LR rows with halo to its HR rows with
    halo (out_rows core rows, hr_halo either side). The same arithmetic as
    resize.cheap_upscale on the whole plane, on the same values: the exact
    integer form when both axes are exact (2x: den 4, 1.5x: den 6; the
    whole plane's 2x slice form is exact too, so the two agree), else the
    float form; columns as for the whole plane."""
    in_w = lr_ext.shape[1]
    exact = _plane_exact(lr_h_global, in_w, out_h_global, out_w)
    rows = _stripe_rows(lr_h_global, out_h_global, exact, hr_halo, out_rows, lr_stripe_rows,
                        lr_halo, idx, lr_ext.device)
    cols = _axis_vectors(in_w, out_w, exact, lr_ext.device)
    return _rounded(_separable(lr_ext, rows, cols), rows[3] * cols[3], bits)


def _raisr_pass_stripe(
    cheap_ext: torch.Tensor,
    bank: PassBank,
    statics: PassStatics,
    hr_halo: int,
    core_rows: int,
    total_h: int,
    idx: int,
    pass_idx: int = 0,
) -> torch.Tensor:
    """One RAISR pass on stripe `idx` with halo; returns its core rows.
    ops/pipeline.raisr_pass with the stripe's global first row and the
    frame's height, so every tier's bank and extras (PassBank) and every
    backend reach the stripe exactly as they reach a whole frame."""
    g_start = idx * core_rows - hr_halo  # global row of cheap_ext[0]
    out = raisr_pass(cheap_ext, bank, statics, pass_idx, row0=g_start, zone_h=total_h)
    return out[hr_halo:hr_halo + core_rows]


def stripe_problem(statics: PassStatics, passes: int, two_pass_mode: int, lr_h: int,
                   out_h: int, n_stripes: int) -> str | None:
    """Why `n_stripes` row stripes cannot carry this pipeline, or None.
    raisr_tpu's conditions (make_stripe_fn's asserts: bilinear resize; the
    stripe count divides both heights; HR stripes of an even height), and
    two of the port's: a halo comes from the neighbouring stripe alone, so a
    stripe is at least as high as its halo; and a pass that takes pixel
    phases from the plane's rows (fused, conv) over LR stripes (two-pass
    mode 2) needs an even LR stripe height, as HR stripes do."""
    if statics.resize_mode != "bilinear":
        return f"sharding supports resize_mode=bilinear only (got {statics.resize_mode})"
    if out_h % n_stripes or lr_h % n_stripes:
        return f"{n_stripes} stripes must divide the heights {lr_h} and {out_h}"
    hr_stripe, lr_stripe = out_h // n_stripes, lr_h // n_stripes
    if hr_stripe % 2:
        return f"stripes of {hr_stripe} rows would start on odd rows (pixel-phase alignment)"
    lr_halo = _lr_halo(lr_h, out_h)
    for p in range(passes):
        rows = hr_stripe if p + 1 >= two_pass_mode else lr_stripe
        halo = lr_halo if p + 1 == two_pass_mode else HR_HALO
        src = lr_stripe if p + 1 == two_pass_mode else rows
        if src < halo:
            return f"a stripe of {src} rows is shorter than its halo of {halo}"
        if (p + 1 < two_pass_mode and lr_stripe % 2 and statics.use_pixel_type
                and statics.backend != "taps"):
            return (f"LR stripes of {lr_stripe} rows would start on odd rows "
                    "(pixel-phase alignment of the pass at LR size)")
    return None


def _lr_halo(lr_h: int, out_h: int) -> int:
    """LR rows a stripe needs beyond its own to make HR_HALO more HR rows."""
    return int(np.ceil((HR_HALO + 1) * lr_h / out_h)) + 1


def make_stripe_fn(
    statics: PassStatics,
    passes: int,
    two_pass_mode: int,
    lr_h: int,
    out_h: int,
    out_w: int,
    n_stripes: int,
):
    """The stripe pipeline of one frame: a list of n_stripes LR stripes
    ([lr_h / n, W], each on its device) and each device's pass banks ->
    the list of HR stripes, each on its stripe's device. Raises ValueError
    where stripe_problem names a reason."""
    problem = stripe_problem(statics, passes, two_pass_mode, lr_h, out_h, n_stripes)
    if problem:
        raise ValueError(problem)
    hr_stripe = out_h // n_stripes
    lr_stripe = lr_h // n_stripes
    lr_halo = _lr_halo(lr_h, out_h)

    def per_frame(stripes: list[torch.Tensor], banks) -> list[torch.Tensor]:
        x = [s.to(torch.float32) for s in stripes]
        for p in range(passes):
            if p + 1 == two_pass_mode:
                cheap = [
                    _upscale_stripe(e, lr_halo, hr_stripe, HR_HALO, out_w, out_h,
                                    statics.bits, lr_h, i, lr_stripe)
                    for i, e in enumerate(_exchange_halo(x, lr_halo))
                ]
            else:
                cheap = _exchange_halo(x, HR_HALO)
            at_hr = p + 1 >= two_pass_mode
            x = [
                _raisr_pass_stripe(c, banks[c.device][p], statics, HR_HALO,
                                   hr_stripe if at_hr else lr_stripe,
                                   out_h if at_hr else lr_h, i, pass_idx=p)
                for i, c in enumerate(cheap)
            ]
        return x

    return per_frame


def _scatter(plane: torch.Tensor, devs) -> list[torch.Tensor]:
    """A plane's rows cut into len(devs) stripes, each sent to its device."""
    s = plane.shape[0] // len(devs)
    return [_to(plane[i * s:(i + 1) * s], d) for i, d in enumerate(devs)]


def _gather(stripes: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    return torch.cat([_to(s, device) for s in stripes])


def process_plane_row_sharded(
    lr: torch.Tensor,
    banks: dict[torch.device, tuple[PassBank, ...]],
    statics: PassStatics,
    passes: int,
    two_pass_mode: int,
    out_h: int,
    out_w: int,
    mesh: Mesh,
    axis: str = "rows",
) -> torch.Tensor:
    """One frame, rows split over `axis` (single-stream latency mode); the
    output on the input's device."""
    devs = list(mesh.grid(axis))
    per_frame = make_stripe_fn(statics, passes, two_pass_mode, lr.shape[0], out_h, out_w,
                               len(devs))
    return _gather(per_frame(_scatter(lr, devs), banks), lr.device)


def process_batch_2d(
    batch_lr: torch.Tensor,
    banks: dict[torch.device, tuple[PassBank, ...]],
    statics: PassStatics,
    passes: int,
    two_pass_mode: int,
    out_h: int,
    out_w: int,
    mesh: Mesh,
    data_axis: str = "data",
    rows_axis: str = "rows",
) -> torch.Tensor:
    """[N, H, W] with N split over `data_axis` and each frame's rows over
    `rows_axis`: the full multi-device step. raisr_tpu vmaps the frames of a
    data shard; here each shard loops over its frames."""
    grid = mesh.grid(data_axis, rows_axis)
    n_data, n_rows = grid.shape
    n = batch_lr.shape[0]
    if n % n_data:
        raise ValueError(f"batch of {n} frames does not divide over {n_data} devices")
    k = n // n_data
    per_frame = make_stripe_fn(statics, passes, two_pass_mode, batch_lr.shape[1], out_h,
                               out_w, n_rows)
    return torch.stack([
        _gather(per_frame(_scatter(batch_lr[f], list(grid[d])), banks), batch_lr.device)
        for d in range(n_data) for f in range(d * k, (d + 1) * k)
    ])
