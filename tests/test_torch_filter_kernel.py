"""The port's filter apply (apply_filters, apply_filters_hash and their plain
PyTorch versions) held against raisr_tpu's Pallas filter kernels
(apply_filters_pallas, apply_filters_hash_pallas), run in interpret mode on
the CPU; and the 4-phase bank at 2.5x (ROADMAP C9).

Tolerances are the JAX tests' own (tests/test_pallas.py,
tests/test_pallas_fused.py): the TPU kernels get float32 grade from hi/lo
bfloat16 splits on the MXU (mxu_passes=2, ~2^-17 relative: max abs error
< 5e-3 on 8-bit content) and add a low-order image plane at 10 bits
(mxu_passes=3: < 0.05), while the port computes in plain float32. The
border is outside the processed zone, so only [6:-6, 6:-6] is compared.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.filter_apply import apply_filters_taps as j_taps
from raisr_tpu.ops.resize import cheap_upscale as j_cheap
from raisr_tpu.ops.pallas.filter_kernel import (
    apply_filters_hash_pallas,
    apply_filters_pallas,
)
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import filter_kernel as flk
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end
from raisr_tpu_torch.ops.resize import cheap_upscale
from torch_port_util import QCOH, QSTR, frac_and_median, make_filters, make_jax_model, smooth

CORE = np.s_[6:-6, 6:-6]
FUZZ_FRAC = 0.02  # engine against engine: the JAX package's cross-backend bar


def _phases(h, w):
    return ((np.arange(h)[:, None] - 5) % 2) * 2 + (np.arange(w)[None, :] - 5) % 2


def _hash_kw(bits=8):
    return dict(k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
                nf=normalization_factor(bits), qstr=QSTR, qcoh=QCOH)


def _jax_apply(img, buckets, filters, pixel_types, mxu_passes):
    return np.asarray(apply_filters_pallas(
        jnp.asarray(img), jnp.asarray(buckets), jnp.asarray(filters),
        pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1,
        mxu_passes=mxu_passes, interpret=True))


def _port_apply(img, buckets, filters, pixel_types):
    return flk.apply_filters(
        torch.from_numpy(img), torch.from_numpy(buckets), torch.from_numpy(filters),
        pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1).numpy()


@pytest.mark.parametrize("pixel_types", [4, 1])
@pytest.mark.parametrize("bits,mxu_passes,tol", [(8, 2, 5e-3), (10, 3, 0.05)])
def test_apply_filters_matches_jax_kernel(pixel_types, bits, mxu_passes, tol):
    rng = np.random.default_rng(30 + pixel_types + bits)
    h, w = 36, 44
    img = rng.integers(0, (1 << bits) - 1, (h, w)).astype(np.float32)
    filters = make_filters(rng, pixel_types)
    buckets = rng.integers(0, 216, (h, w)).astype(np.int32)
    ref = _jax_apply(img, buckets, filters, pixel_types, mxu_passes)
    out = _port_apply(img, buckets, filters, pixel_types)
    assert out.shape == (h, w) and np.isfinite(out).all()
    d = np.abs(out[CORE] - ref[CORE]).max()
    assert d < tol, d
    # the plain version is the taps path on rows bucket * 4 + phase (or bucket)
    pt = _phases(h, w) if pixel_types == 4 else 0
    taps = np.asarray(j_taps(jnp.asarray(img), jnp.asarray(buckets * pixel_types + pt),
                             jnp.asarray(filters), 11))
    np.testing.assert_allclose(out, taps, rtol=0, atol=1e-3 * (1 << (bits - 8)))


@pytest.mark.parametrize("pixel_types", [4, 1])
def test_out_of_range_buckets_give_zero(pixel_types):
    """Buckets outside [0, 216) give raw 0 on both sides: the TPU select over
    224 zero-padded rows finds a zero row or no row at all."""
    rng = np.random.default_rng(40 + pixel_types)
    h, w = 36, 44
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    filters = make_filters(rng, pixel_types)
    buckets = rng.integers(-8, 232, (h, w)).astype(np.int32)
    out = _port_apply(img, buckets, filters, pixel_types)
    ref = _jax_apply(img, buckets, filters, pixel_types, 2)
    bad = (buckets < 0) | (buckets >= 216)
    assert bad[CORE].sum() > 20
    assert (out[bad] == 0).all()
    assert (ref[CORE][bad[CORE]] == 0).all()
    assert np.abs(out[CORE] - ref[CORE]).max() < 5e-3


def test_apply_filters_hash_matches_jax_kernel():
    h, w = 48, 64
    img = smooth(h, w, seed=11)
    filters = make_filters(np.random.default_rng(11))
    kw = _hash_kw()
    ref = np.asarray(apply_filters_hash_pallas(
        jnp.asarray(img), jnp.asarray(filters), interpret=True, **kw))
    out = flk.apply_filters_hash(torch.from_numpy(img), torch.from_numpy(filters), **kw)
    assert tuple(out.shape) == (h, w) and torch.isfinite(out).all()
    diff = np.abs(out.numpy()[CORE] - ref[CORE])
    # the JAX test's bar: only exact float ties may flip a bucket
    assert (diff > 0.5).mean() < 0.005, (diff > 0.5).mean()
    assert np.median(diff) < 5e-3


@pytest.mark.parametrize("blending", [1, 2])
def test_staged_pass_equals_fused_plain_pass(blending):
    """The fused pass is its hash, the filter apply and the epilogue: the
    plain hash -> apply_filters -> _finish_pass, and apply_filters_hash ->
    _finish_pass, equal raisr_pass_full_reference exactly."""
    h, w = 40, 56
    img = torch.from_numpy(smooth(h, w, seed=12))
    f = torch.from_numpy(make_filters(np.random.default_rng(12)))
    kw = _hash_kw()
    buckets = flk.hash_buckets_reference(img, **kw)
    raw = flk.apply_filters(img, buckets, f)
    assert torch.equal(raw, flk.apply_filters_hash(img, f, **kw))
    out = _finish_pass(img, raw, min_val=16, max_val=235, blending=blending,
                       loop_margin=6, col_end=processed_col_end(w, 6, True))
    want = fk.raisr_pass_full_reference(img, f, blending=blending, **kw)
    assert torch.equal(out, want)


def test_wrappers_on_cpu_run_plain_versions():
    img = torch.from_numpy(smooth(24, 40, seed=13))
    f4 = torch.from_numpy(make_filters(np.random.default_rng(13)))
    buckets = torch.from_numpy(np.random.default_rng(13).integers(0, 216, (24, 40)).astype(np.int32))
    before = (flk.LAUNCHES, flk.SINGLE_LAUNCHES, flk.HASH_LAUNCHES)
    assert torch.equal(flk.apply_filters(img, buckets, f4),
                       flk.apply_filters_reference(img, buckets, f4))
    f1 = f4[:216].contiguous()
    assert torch.equal(flk.apply_filters(img, buckets, f1, pixel_types=1, ratio=1),
                       flk.apply_filters_reference(img, buckets, f1, pixel_types=1))
    assert torch.equal(flk.apply_filters_hash(img, f4, **_hash_kw()),
                       flk.apply_filters_hash_reference(img, f4, **_hash_kw()))
    assert (flk.LAUNCHES, flk.SINGLE_LAUNCHES, flk.HASH_LAUNCHES) == before


def test_wrappers_refuse():
    """No fallback off the CPU and CUDA, and the JAX entry's own asserts:
    4 or 1 phases, 4 phases only at ratio 2."""
    f = torch.from_numpy(make_filters(np.random.default_rng(14)))
    meta = torch.empty((24, 40), device="meta")
    b = torch.zeros((24, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flk.apply_filters(meta, b, f)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flk.apply_filters_hash(meta, f, **_hash_kw())
    img = torch.zeros((24, 40))
    with pytest.raises(ValueError, match="4 or 1 pixel types"):
        flk.apply_filters(img, b, f, pixel_types=9)
    with pytest.raises(ValueError, match="ratio 2"):
        flk.apply_filters(img, b, f, pixel_types=4, ratio=3)
    # launch A hands each bucket on as one byte
    kw = _hash_kw()
    with pytest.raises(ValueError, match="at most 256 buckets"):
        flk._hash_launch_args(kw["k1d"], kw["nf"], kw["qstr"], kw["qcoh"], 30, 3, 3)
    flk._hash_launch_args(kw["k1d"], kw["nf"], kw["qstr"], kw["qcoh"], 24, 3, 3)


# -- ROADMAP C9: a 4-phase (2x) bank at 2.5x --------------------------------


def test_jax_unfused_kernel_diverges_at_25x():
    """Pins the fault in raisr_tpu: at 2.5x its unfused Pallas kernel picks
    the filter phase from the pixel position (filter_kernel.py:252, 286-287),
    while its taps path, like the reference, uses phase 0 everywhere."""
    rng = np.random.default_rng(50)
    h, w = 36, 44
    img = rng.integers(0, 255, (h, w)).astype(np.float32)
    filters = make_filters(rng)
    buckets = rng.integers(0, 216, (h, w)).astype(np.int32)
    pallas = _jax_apply(img, buckets, filters, 4, 2)
    phase0 = np.asarray(j_taps(jnp.asarray(img), jnp.asarray(buckets * 4),
                               jnp.asarray(filters), 11))
    frac = (np.abs(pallas[CORE] - phase0[CORE]) > 0.01).mean()
    assert frac > 0.5, frac
    # the port's single-phase apply over the phase-0 rows is the taps result
    out = _port_apply(img, buckets, np.ascontiguousarray(filters[0::4]), 1)
    np.testing.assert_allclose(out, phase0, rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def yuv25():
    rng = np.random.default_rng(51)
    y = rng.integers(16, 235, (2, 24, 32)).astype(np.uint8)
    u = rng.integers(16, 240, (2, 12, 16)).astype(np.uint8)
    return y, u


@pytest.mark.parametrize("dtype", ["float32", "auto"])
def test_25x_fused_engine_matches_jax_taps_engine(yuv25, dtype):
    """2.5x with a 2x bank: the port's fused engine (the single-phase pass
    over the phase-0 rows, its plain version here) against the JAX taps
    engine under the fuzz bar; the bf16 tier (auto) as well."""
    jm = make_jax_model(passes=1, seed=52)
    y, u = yuv25
    eng = RaisrEngine(RaisrConfig(ratio=2.5, passes=1, backend="pallas", dtype=dtype),
                      from_jax_model(jm), device="cpu")
    before = dict(fk.LAUNCHES)
    oy, ou, _ = eng.process_batch_device(torch.from_numpy(y), torch.from_numpy(u))
    assert fk.LAUNCHES == before  # the plain version ran
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(ratio=2.5, passes=1, backend="reference"), jm)
    jy, ju, _ = (np.asarray(a) if a is not None else None
                 for a in jeng.process_batch_device(y, u))
    assert tuple(oy.shape) == jy.shape == (2, 60, 80)
    frac, med = frac_and_median(oy.numpy(), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    # U against raisr_tpu's per-plane upscale, exactly (its jitted batch
    # form at 2.5x rounds one tie of these 2,400 pixels the other way)
    for i in range(2):
        want = np.asarray(j_cheap(jnp.asarray(u[i].astype(np.float32)), 30, 40, 8))
        assert np.array_equal(ou[i].numpy(), want), i
    assert np.abs(ou.numpy().astype(int) - ju).max() <= 1


def test_25x_fused_engine_is_the_single_phase_pass_on_phase0_rows(yuv25):
    """Frame by frame, the 2.5x fused engine equals the plain single-phase
    pass over the bank's phase-0 rows, exactly."""
    jm = make_jax_model(passes=1, seed=52)
    tm = from_jax_model(jm)
    eng = RaisrEngine(RaisrConfig(ratio=2.5, passes=1, backend="pallas"), tm, device="cpu")
    y = torch.from_numpy(yuv25[0])
    oy = eng.process_batch_y(y)
    f0 = torch.from_numpy(np.ascontiguousarray(tm.banks[0].filters[0::4]))
    kw = dict(_hash_kw(), qstr=tuple(float(v) for v in tm.banks[0].qstr),
              qcoh=tuple(float(v) for v in tm.banks[0].qcoh), blending=2)
    for i in range(y.shape[0]):
        cheap = cheap_upscale(y[i].to(torch.float32), 60, 80, 8)
        assert torch.equal(oy[i], fk.raisr_pass_full_reference(cheap, f0, pixel_types=1,
                                                               **kw)), i
