"""Shared inputs for the raisr_tpu_torch tests.

Every test_torch_* file holds the PyTorch port against the JAX package on the
same inputs: a bank built in memory as a raisr_tpu RaisrModel (handed to the
port through from_jax_model) and images made with numpy from a seed. Nothing
here reads a filter folder from outside the repository.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# strength / coherence bin edges of the shape the shipped 2x banks use
QSTR = (0.001269, 0.022169)
QCOH = (0.192916, 0.405942)


def make_filters(rng: np.random.Generator, pixel_types: int = 4,
                 n_buckets: int = 216) -> np.ndarray:
    """One pass's bank of the real shape (216 buckets x pixel_types phases x
    121 taps, rows padded to 128; 4 phases for 2x, 1 for 1.5x), or of another
    bucket count: centre tap 1 plus noise of 0.01."""
    rows = n_buckets * pixel_types
    filters = np.zeros((rows, 128), np.float32)
    filters[:, :121] = rng.normal(size=(rows, 121)).astype(np.float32) * 0.01
    filters[:, 60] += 1.0
    return filters


def make_jax_model(passes: int = 2, seed: int = 0, pixel_types: int = 4):
    """A raisr_tpu RaisrModel of `passes` seeded banks (make_filters): 2x
    banks, or single-phase (1.5x) banks with pixel_types=1."""
    from raisr_tpu.model.loader import FilterBank, RaisrModel

    rng = np.random.default_rng(seed)
    banks = []
    for _ in range(passes):
        filters = make_filters(rng, pixel_types)
        banks.append(
            FilterBank(
                filters=filters,
                qstr=np.asarray(QSTR, np.float32),
                qcoh=np.asarray(QCOH, np.float32),
                pixel_types=pixel_types,
                taps=121,
                source_dtype="fp32",
            )
        )
    return RaisrModel(qangle=24, qstrength=3, qcoherence=3, patch_size=11,
                      banks=tuple(banks))


def smooth(h: int, w: int, bits: int = 8, seed: int = 0) -> np.ndarray:
    """Box-filtered noise scaled to the full integer range, as float32."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(h, w))
    for ax in (0, 1):
        img = np.apply_along_axis(
            lambda r: np.convolve(r, np.ones(5) / 5, "same"), ax, img
        )
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return np.floor(img * ((1 << bits) - 1)).astype(np.float32)


def smooth_frames(n: int, h: int, w: int, bits: int = 8, seed: int = 0) -> np.ndarray:
    """n frames of `smooth` content at 8, 10 or 16 bits, packed as the
    engine takes them: uint8 at 8 bits, uint16 above."""
    dtype = np.uint8 if bits == 8 else np.uint16
    return np.stack([smooth(h, w, bits, seed + i) for i in range(n)]).astype(dtype)


def patchwork(h: int, w: int, bits: int = 8, seed: int = 0, blk: int = 16) -> np.ndarray:
    """A plane of blk x blk blocks, each two crossed gratings of a random
    angle, frequency and amplitude (log-uniform over three decades), so that
    the hash's buckets spread over nearly all 216 (a 384 x 512 plane from
    seeds 1-5 reaches 213-215). Integer-valued float32 in [0, 2^bits)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:blk, 0:blk].astype(np.float64)
    top = (1 << bits) - 1
    img = np.zeros((h, w))
    for by in range(0, h, blk):
        for bx in range(0, w, blk):
            th, f = rng.uniform(0, np.pi), rng.uniform(0.1, 0.8)
            a = top / 2 * np.exp(rng.uniform(np.log(1e-3), 0))
            b = a * rng.uniform(0, 1)
            p = (a * np.sin(f * (np.cos(th) * xx + np.sin(th) * yy) + rng.uniform(0, 6))
                 + b * np.sin(f * (-np.sin(th) * xx + np.cos(th) * yy) + rng.uniform(0, 6)))
            img[by:by + blk, bx:bx + blk] = (p + top / 2)[:min(blk, h - by), :min(blk, w - bx)]
    return np.clip(np.round(img), 0, top).astype(np.float32)


def jax_tier(js) -> str:
    """The port's tier for raisr_tpu's pass statics (mxu_passes / p_split /
    pcenter / i8): p_split is the bf16 bank against the exact patch, which
    is the bf16 tier's arithmetic on the card."""
    if js.i8:
        return "int8"
    if js.pcenter:
        return "pcenter"
    if js.p_split or js.mxu_passes == 1:
        return "bfloat16"
    return "float32"


def frac_and_median(a, b) -> tuple[float, float]:
    """Share of differing pixels and the median absolute difference."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float((d > 0).mean()), float(np.median(d))


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA card is present (decided at run
    time, never at import, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


_SUBSAMPLING = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}
_Y4M_CTAG = {8: "", 10: "p10", 16: "p16"}


def write_bank_folder(folder, passes: int = 2, seed: int = 0, pixel_types: int = 4,
                      bits: int = 8) -> str:
    """Write `passes` seeded banks (make_filters) as a filter folder of `bits`
    in the reference's on-disk format, loadable by both packages."""
    from raisr_tpu_torch.model.loader import FilterBank
    from raisr_tpu_torch.train.export import save_filter_folder

    rng = np.random.default_rng(seed)
    banks = [
        FilterBank(filters=make_filters(rng, pixel_types),
                   qstr=np.asarray(QSTR, np.float32), qcoh=np.asarray(QCOH, np.float32),
                   pixel_types=pixel_types, taps=121, source_dtype="fp32")
        for _ in range(passes)
    ]
    save_filter_folder(str(folder), banks, bits=bits)
    return str(folder)


def write_y4m_clip(path, n_frames: int, h: int, w: int, seed: int = 0, bits: int = 8,
                   subsampling: str = "420") -> list[tuple]:
    """Write a seeded Y4M clip byte by byte (through neither package's
    writer): smooth Y, uniform U/V in the video range, or Y alone for
    "mono". Returns the frames as (y, u, v) arrays (u, v None for mono)."""
    dt = np.uint8 if bits == 8 else np.dtype("<u2")
    rng = np.random.default_rng(seed + 1000)
    ys = smooth_frames(n_frames, h, w, bits, seed)
    ctag = "mono" + ("" if bits == 8 else str(bits)) if subsampling == "mono" else (
        subsampling + ("jpeg" if (subsampling, bits) == ("420", 8) else _Y4M_CTAG[bits]))
    frames = []
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{ctag}\n".encode())
        for i in range(n_frames):
            y = ys[i].astype(dt)
            u = v = None
            if subsampling != "mono":
                sv, sh = _SUBSAMPLING[subsampling]
                lo, hi = (16, 240) if bits == 8 else (64, 960)
                u = rng.integers(lo, hi, (h // sv, w // sh)).astype(dt)
                v = rng.integers(lo, hi, (h // sv, w // sh)).astype(dt)
            f.write(b"FRAME\n")
            for p in (y, u, v):
                if p is not None:
                    f.write(p.tobytes())
            frames.append((y, u, v))
    return frames


def write_bank_and_clip(root, n_frames: int = 5, h: int = 24, w: int = 32,
                        passes: int = 2, seed: int = 0, bits: int = 8,
                        subsampling: str = "420", pixel_types: int = 4):
    """A seeded bank folder and a seeded Y4M clip under `root` (a tmp_path):
    returns (folder, clip path, frames as (y, u, v) arrays). The stream,
    video and CLI tests share it; chip_smoke.py keeps its own copy of the
    recipe, since it imports nothing from the tests."""
    import os

    folder = write_bank_folder(os.path.join(str(root), "bank"), passes, seed,
                               pixel_types, bits)
    clip = os.path.join(str(root), "clip.y4m")
    return folder, clip, write_y4m_clip(clip, n_frames, h, w, seed, bits, subsampling)
