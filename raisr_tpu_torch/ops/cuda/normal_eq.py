"""Per-bucket normal equations of filter training: the CUDA kernel's wrapper
and its plain PyTorch version.

`accumulate_normal_eq` adds, for every core pixel n of a training pair (the
pixels `CORE` from every edge), its augmented row into the accumulators of
its filter index f = idx[n]:

    Q[f] += (s_n p_n)(s_n p_n)^T        V[f] += y_n (s_n p_n)

where p_n is the pixel's 11x11 patch of the cheap plane (121 taps, row-major),
s_n the weight plane at the pixel (1 without one) and y_n the label plane at
the pixel. Q [num_filters, 121, 121] and V [num_filters, 121] are float32 and
are updated in place (JAX's functions return new arrays; here the 50 MB of a
2x bank's Q is not copied per pair).

It replaces XLA's one-hot contraction of raisr_tpu/train/trainer.py
(_accumulate_chunked, :119-147), not a Pallas kernel: the TPU builds a
[chunk, num_filters] one-hot matrix and multiplies its transpose with the
chunk's outer products, num_filters times the arithmetic the sums need. The
CUDA kernel (csrc/normal_eq.cu, see its header) gathers instead: the pixels
are sorted by filter index here (torch.sort, stable, and bincount/cumsum for
the runs: glue, not the kernel's work), each block sums one run of at most
RUN pixels of one index (64 pixels at a time in registers, then into the
run's sums in shared memory), and a second launch adds the runs of each index
in order, in double. No float atomics decide an order, so the result is the
same bit for bit from run to run.

The wrapper runs the kernel on CUDA tensors and the plain version on CPU
tensors; there is no fallback. `LAUNCHES` counts the calls that went through
the kernel (one per call, whatever its two CUDA launches).
"""

from __future__ import annotations

import contextlib

import torch

from raisr_tpu_torch.ops.cuda.filter_kernel import _device_and_stream

LAUNCHES = 0  # accumulate_normal_eq calls that went through the CUDA kernel

N_TAPS = 121
PATCH = 11
CORE = PATCH // 2 + 1  # the core starts this far from every edge (JAX's lm)
RUN = 1024  # pixels of one filter index a block of launch 1 takes at most
# one run's partial Gram: 136 upper-triangle tiles of 8 x 8 (csrc/normal_eq.cu)
PARTIAL = 136 * 64


def _tap_offsets(w: int, device) -> torch.Tensor:
    """Offsets of the 121 taps from the patch centre in a row-major plane of
    width w, in tap order (row by row of the 11x11 patch)."""
    m = PATCH // 2
    r = torch.arange(PATCH, device=device)
    return ((r[:, None] - m) * w + (r[None, :] - m)).reshape(-1)


def normal_eq_reference(
    q: torch.Tensor,  # [nf, 121, 121], updated in place
    v: torch.Tensor,  # [nf, 121], updated in place
    cheap: torch.Tensor,  # [H, W] f32
    label: torch.Tensor,  # [H, W] f32
    idx: torch.Tensor,  # [H - 12, W - 12] int, filter index of each core pixel
    weight: torch.Tensor | None = None,  # [H, W] f32, or None for 1
    *,
    chunk: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of accumulate_normal_eq, on any device; it never
    forms the one-hot matrix. The core pixels are sorted by filter index;
    each index's pixels are taken `chunk` rows at a time as an augmented
    matrix A = [s * patches, y] (the products s * p rounded in float32, as
    JAX rounds them), cast to the accumulators' dtype, and A^T A is added
    to Q and V. The upper triangle of each A^T A is mirrored, so Q stays
    exactly symmetric. With float64 accumulators the sums are float64.
    TF32 is off for the products. Returns (q, v)."""
    _check_core(cheap, idx)
    nf = q.shape[0]
    w = cheap.shape[1]
    core_w = idx.shape[1]
    flat = idx.reshape(-1).to(torch.int64)
    if flat.numel() == 0:
        return q, v
    counts = torch.bincount(flat, minlength=nf)
    if counts.numel() != nf:
        raise ValueError(f"a filter index is >= the {nf} filters of the accumulators")
    order = torch.sort(flat, stable=True).indices
    centre = (order // core_w + CORE) * w + order % core_w + CORE
    offs = _tap_offsets(w, cheap.device)
    plane, lab = cheap.reshape(-1), label.reshape(-1)
    ends = torch.cumsum(counts, 0).tolist()
    with _no_tf32():
        for f, n in enumerate(counts.tolist()):
            for lo in range(ends[f] - n, ends[f], chunk):
                ctr = centre[lo: min(lo + chunk, ends[f])]
                p = plane[ctr[:, None] + offs[None, :]]
                if weight is not None:
                    p = p * weight.reshape(-1)[ctr][:, None]
                a = torch.cat([p, lab[ctr][:, None]], dim=1).to(q.dtype)
                g = torch.triu(a.T @ a)
                g = g + torch.triu(g, 1).T
                q[f] += g[:N_TAPS, :N_TAPS]
                v[f] += g[N_TAPS, :N_TAPS]
    return q, v


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for float32 matrix products inside the block; the caller's
    setting is restored."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _check_core(cheap: torch.Tensor, idx: torch.Tensor) -> None:
    if cheap.dim() != 2 or idx.dim() != 2:
        raise ValueError("cheap and idx must be 2-D")
    h, w = cheap.shape
    want = (max(h - 2 * CORE, 0), max(w - 2 * CORE, 0))
    if tuple(idx.shape) != want:
        raise ValueError(
            f"idx must cover the core of the {h}x{w} plane, {want}, got {tuple(idx.shape)}"
        )


def _check_plane(name: str, t: torch.Tensor, shape, device) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous float32 {tuple(shape)} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def accumulate_normal_eq(
    q: torch.Tensor,
    v: torch.Tensor,
    cheap: torch.Tensor,
    label: torch.Tensor,
    idx: torch.Tensor,
    weight: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Q[f] += sum (s p)(s p)^T, V[f] += sum y (s p) over the core pixels of
    filter index f, in place; returns (q, v). The CUDA kernel for CUDA
    tensors (float32 accumulators), normal_eq_reference for CPU tensors."""
    if cheap.device.type == "cpu":
        return normal_eq_reference(q, v, cheap, label, idx, weight)
    if cheap.device.type != "cuda":
        raise ValueError(f"accumulate_normal_eq runs on cpu or cuda, not {cheap.device}")
    dev = cheap.device
    _check_core(cheap, idx)
    h, w = cheap.shape
    _check_plane("cheap", cheap, (h, w), dev)
    _check_plane("label", label, (h, w), dev)
    if weight is not None:
        _check_plane("weight", weight, (h, w), dev)
    nf = q.shape[0] if q.dim() == 3 else -1
    _check_plane("q", q, (nf, N_TAPS, N_TAPS), dev)
    _check_plane("v", v, (nf, N_TAPS), dev)
    if idx.dtype != torch.int32 or idx.device != dev or not idx.is_contiguous():
        raise ValueError(
            f"idx must be a contiguous int32 tensor on {dev}, got {idx.dtype} on {idx.device}"
        )
    flat = idx.reshape(-1)
    if flat.numel() == 0:
        return q, v
    counts = torch.bincount(flat, minlength=nf)
    if counts.numel() != nf:
        raise ValueError(f"a filter index is >= the {nf} filters of the accumulators")
    order = torch.sort(flat, stable=True).indices.to(torch.int32)
    runs_of = (counts + RUN - 1) // RUN
    ends = torch.cumsum(runs_of, 0)
    n_runs = int(ends[-1])
    first_run = ends - runs_of
    run_f = torch.repeat_interleave(torch.arange(nf, device=dev), runs_of,
                                    output_size=n_runs)
    j = torch.arange(n_runs, device=dev) - first_run[run_f]
    run_start = (torch.cumsum(counts, 0) - counts)[run_f] + j * RUN
    run_len = torch.clamp(counts[run_f] - j * RUN, max=RUN)
    partials = torch.empty((n_runs, PARTIAL), dtype=torch.float32, device=dev)
    tables = [t.to(torch.int32).contiguous() for t in (run_start, run_len, first_run, runs_of)]

    from raisr_tpu_torch.ops.cuda._build import load_library

    device, stream = _device_and_stream(cheap)
    err = load_library().raisr_normal_eq(
        cheap.data_ptr(), label.data_ptr(), weight.data_ptr() if weight is not None else None,
        order.data_ptr(), tables[0].data_ptr(), tables[1].data_ptr(), n_runs,
        tables[2].data_ptr(), tables[3].data_ptr(), nf, partials.data_ptr(), q.data_ptr(),
        v.data_ptr(), h, w, device, stream,
    )
    if err:
        raise RuntimeError(f"raisr_normal_eq launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return q, v
