"""The CUDA pass's limits as plain functions, held on the CPU: the hash's
bucket and edge limits (ops/cuda/filter_kernel.py check_bank_limits), the
engine's refusal of a bank over them at construction on a CUDA device, the
shared-memory size rule of apply_filters (gather_smem_bytes,
check_gather_smem), and the hash launch's count of interior and edge tiles
(hash_tile_counts) with its wrapper on the CPU (hash_buckets). raisr_tpu has
no such limits (its loader and kernels take any qangle x qstrength x
qcoherence), so the CPU and the taps backend must go on taking those banks,
as raisr_tpu does.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.config import RaisrConfig as JConfig
from raisr_tpu.engine import RaisrEngine as JEngine
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.config import RaisrError
from raisr_tpu_torch.engine import check_cuda_bank
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import filter_kernel as flk
from torch_port_util import frac_and_median, make_filters, smooth


def _jax_model(qangle, qstrength, qcoherence, seed=0):
    """A one-pass 4-phase raisr_tpu model of qangle x qstrength x qcoherence
    buckets, with evenly spaced edges."""
    from raisr_tpu.model.loader import FilterBank, RaisrModel

    bank = FilterBank(
        filters=make_filters(np.random.default_rng(seed), 4, qangle * qstrength * qcoherence),
        qstr=np.linspace(0.001, 0.03, qstrength - 1).astype(np.float32),
        qcoh=np.linspace(0.15, 0.6, qcoherence - 1).astype(np.float32),
        pixel_types=4, taps=121, source_dtype="fp32")
    return RaisrModel(qangle=qangle, qstrength=qstrength, qcoherence=qcoherence,
                      patch_size=11, banks=(bank,))


@pytest.mark.parametrize("dims,edges,match", [
    ((24, 3, 3), (2, 2), None),
    ((16, 4, 4), (3, 3), None),  # 256 buckets: the most one byte holds
    ((2, 9, 9), (8, 8), None),  # 8 edges each: the most the hash launch takes
    ((25, 4, 3), (3, 2), "at most 256 buckets, got 25 x 4 x 3 = 300"),
    ((257, 1, 1), (0, 0), "at most 256 buckets"),
    ((0, 3, 3), (2, 2), "at most 256 buckets"),
    ((2, 10, 3), (9, 2), "at most 8 strength and 8 coherence edges, got 9 and 2"),
    ((2, 3, 10), (2, 9), "at most 8 strength and 8 coherence edges, got 2 and 9"),
])
def test_check_bank_limits(dims, edges, match):
    if match is None:
        flk.check_bank_limits(*dims, *edges)
        return
    with pytest.raises(ValueError, match=match):
        flk.check_bank_limits(*dims, *edges)
    # the kernel wrappers' own check is the same function
    k1d = (0.0,) * 11
    with pytest.raises(ValueError, match=match):
        flk._check_hash_args(k1d, (0.0,) * edges[0], (0.0,) * edges[1], *dims, 11)


@pytest.mark.parametrize("dims,match", [
    ((25, 4, 3), "pass 1: .*at most 256 buckets, got 25 x 4 x 3 = 300"),
    ((2, 11, 3), "pass 1: .*at most 8 strength and 8 coherence edges, got 10 and 2"),
])
def test_engine_refuses_bank_over_cuda_limits_at_construction(monkeypatch, dims, match):
    """On a CUDA device (its availability check stubbed: there is no card
    here) the fused backend refuses the bank when the engine is built, before
    any tensor moves; nothing falls back to taps or to the CPU."""
    tm = from_jax_model(_jax_model(*dims))
    with pytest.raises(RaisrError, match=match):
        check_cuda_bank(tm)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stub")  # the init banner
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in ("auto", "pallas"):
        with pytest.raises(RaisrError, match=match):
            RaisrEngine(RaisrConfig(passes=1, backend=backend), tm, device="cuda")


def test_cpu_and_taps_take_a_bank_over_the_limits():
    """300 buckets: the taps backend and the fused backend's plain version
    serve it on the CPU, within raisr_tpu's cross-backend bar (under 2% of
    pixels differ, median 0) of raisr_tpu's own engine on the same bank."""
    jm = _jax_model(25, 4, 3, seed=1)
    tm = from_jax_model(jm)
    y = smooth(24, 32, seed=2)
    ref = np.asarray(JEngine(JConfig(passes=1, backend="reference"), jm).upscale_y(jnp.asarray(y)))
    for backend in ("reference", "pallas"):
        eng = RaisrEngine(RaisrConfig(passes=1, backend=backend), tm, device="cpu")
        out = eng.upscale_y(torch.from_numpy(y)).numpy()
        frac, med = frac_and_median(out, ref)
        assert out.shape == (48, 64) and frac < 0.02 and med == 0.0, (backend, frac, med)


@pytest.mark.parametrize("pixel_types,tiles", [(4, 97_088), (1, 34_944)])
@pytest.mark.parametrize("n_buckets", [1, 216, 256])
def test_gather_smem_bytes_fits(n_buckets, pixel_types, tiles):
    """The phase's float32 rows at 496 bytes (31 16-byte groups) and two tile
    buffers for each of 4 groups: 41 x 74 words (4 phases) or 26 x 42 (1)."""
    assert tiles == 8 * 4 * (41 * 74 if pixel_types == 4 else 26 * 42)
    need = flk.gather_smem_bytes(n_buckets, pixel_types)
    assert need == n_buckets * 496 + tiles
    assert need <= flk.MAX_SMEM_BYTES
    flk.check_gather_smem(n_buckets, pixel_types)


def test_gather_smem_bytes_of_the_fused_pass():
    """The rule gives the sizes the fused float32 pass's 216-bucket forms
    ask for (ptxas and the launch on the card agree with them)."""
    assert flk.gather_smem_bytes(216, 4) == 204_224
    assert flk.gather_smem_bytes(216, 1) == 142_080


@pytest.mark.parametrize("pixel_types,most", [(4, 272), (1, 398)])
def test_check_gather_smem_refuses_too_many_buckets(pixel_types, most):
    flk.check_gather_smem(most, pixel_types)
    for n in (most + 1, 1000):
        need = flk.gather_smem_bytes(n, pixel_types)
        with pytest.raises(ValueError, match=f"{n} buckets needs {need} bytes.*gives 232448"):
            flk.check_gather_smem(n, pixel_types)
    with pytest.raises(ValueError, match="no bucket"):
        flk.check_gather_smem(0, pixel_types)


@pytest.mark.parametrize("pixel_types", [4, 1])
def test_apply_filters_on_cpu_takes_any_bank_size(pixel_types):
    """The size rule is the CUDA kernel's: on a CPU tensor apply_filters runs
    the plain version on a bank over it, out-of-range buckets giving 0."""
    rng = np.random.default_rng(5)
    n = 400
    f = torch.from_numpy(make_filters(rng, pixel_types, n))
    img = torch.from_numpy(smooth(20, 24, seed=5))
    b = torch.from_numpy(rng.integers(-5, n + 5, (20, 24)).astype(np.int32))
    out = flk.apply_filters(img, b, f, pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1)
    bad = (b < 0) | (b >= n)
    assert bad.any() and (out[bad] == 0).all() and (out[~bad] != 0).all()


@pytest.mark.parametrize("h,w", [(1, 1), (16, 16), (22, 34), (37, 63), (38, 60), (70, 120),
                                 (70, 130), (101, 244), (75, 4700), (2160, 3840),
                                 (8736, 3840), (6552, 2880)])
def test_hash_tile_counts_match_a_plain_count(h, w):
    """The hash launch's tiles, counted over their coordinates: interior
    where the tile and the halo around it lie inside the plane."""
    rows, cols, halo = flk.HASH_TILE_ROWS, flk.HASH_TILE_COLS, flk.HASH_HALO
    interior = edge = 0
    for y0 in range(0, h, rows):
        for x0 in range(0, w, cols):
            inside = (y0 - halo >= 0 and x0 - halo >= 0 and y0 + rows + halo <= h
                      and x0 + cols + halo <= w)
            interior += inside
            edge += not inside
    assert flk.hash_tile_counts(h, w) == (interior, edge)
    if h < rows + 2 * halo or w < cols + 2 * halo:
        assert interior == 0


def test_hash_tile_counts_of_the_serving_stacks():
    """The share of interior tiles on the 2x and 1.5x stacks of four 1080p
    frames and on one 4K plane."""
    assert flk.hash_tile_counts(8736, 3840) == (271 * 70, 273 * 72 - 271 * 70)
    assert flk.hash_tile_counts(6552, 2880) == (203 * 52, 205 * 54 - 203 * 52)
    assert flk.hash_tile_counts(2160, 3840) == (66 * 70, 68 * 72 - 66 * 70)


def test_hash_buckets_on_cpu_is_the_plain_hash_in_bytes():
    """On a CPU tensor hash_buckets runs the plain hash, as uint8, launches
    nothing and counts no tile; it takes the CUDA kernel's bucket and edge
    limits on every device."""
    from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
    from torch_port_util import QCOH, QSTR

    img = torch.from_numpy(smooth(40, 70, seed=9))
    hkw = dict(k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
               nf=normalization_factor(8), qstr=QSTR, qcoh=QCOH)
    before = dict(flk.HASH_TILES)
    got = flk.hash_buckets(img, **hkw)
    assert got.dtype == torch.uint8
    assert torch.equal(got, flk.hash_buckets_reference(img, **hkw).to(torch.uint8))
    assert flk.HASH_TILES == before
    with pytest.raises(ValueError, match="at most 256 buckets"):
        flk.hash_buckets(img, **hkw, qangle=30)
