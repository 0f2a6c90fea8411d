"""The port's int8 tier held against raisr_tpu's (i8=True): the bank on the
int16 grid, the integer dot, the fused pass and the engine at dtype="int8".

Tolerances:
  - int8_scale and int8_bank are bit-identical to raisr_tpu's scale
    (ops/pallas/full_kernel.py:780-781) and _round_int_error_diffused (the
    same float32 operations, round half to even in both), on banks whose
    32639 / absmax is exactly a power of two, just under and just over it
    (there float32 log2 decides the floor);
  - the plain int8 raw equals a numpy int64 oracle bit for bit: the dot is
    exact in integers, then one rounding to float32 and a power-of-two
    multiply;
  - the pass and the engine meet the JAX package's cross-backend bar
    (tests/test_fuzz_shapes.py): under 2% of pixels differ, median 0. The
    raw values agree exactly; the TPU kernel's float32 hash sums run in
    another order, so exact-tie buckets may flip. The rows that the TPU
    kernel's zone shift moves (ROADMAP C6) are left out of the pass
    comparison.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pallas.full_kernel import _round_int_error_diffused, raisr_pass_pallas_full
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import filter_kernel as flk
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.resize import cheap_upscale
from torch_port_util import frac_and_median, make_filters, make_jax_model, smooth, smooth_frames

FUZZ_FRAC = 0.02
POW2_ABSMAX = 32639.0 / 16384.0  # exact in float32: 32639 / absmax == 2^14


def _kw(bank, blending):
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(8),
        qstr=tuple(float(v) for v in bank.qstr),
        qcoh=tuple(float(v) for v in bank.qcoh),
        min_val=16, max_val=235, blending=blending,
    )


def _bank(kind: str) -> np.ndarray:
    f = make_filters(np.random.default_rng(70))
    if kind == "spread":
        # magnitudes over four decades, so that the carry crosses binades
        f[:, :121] *= np.random.default_rng(71).uniform(0.01, 100, (f.shape[0], 1))
    else:
        top = np.float32(POW2_ABSMAX)
        if kind == "under_pow2":  # absmax one ulp up: 32639 / absmax just under 2^14
            top = np.nextafter(top, np.float32(np.inf))
        elif kind == "over_pow2":
            top = np.nextafter(top, np.float32(0))
        f[:, :121] = np.clip(f[:, :121], -1.5, 1.5)
        f[5, 60] = -top  # the largest magnitude, negative
    return f.astype(np.float32)


def _jax_scale(f: np.ndarray):
    """raisr_tpu's int8 scale (full_kernel.py:780-781) over taps 0..120."""
    absmax = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(f[:, :121]))), 1e-6)
    return jnp.exp2(jnp.floor(jnp.log2(32639.0 / absmax)))


@pytest.mark.parametrize("kind", ["spread", "pow2", "under_pow2", "over_pow2"])
def test_int8_bank_bit_identical_to_jax(kind):
    f = _bank(kind)
    scale = _jax_scale(f)
    assert float(fk.int8_scale(torch.from_numpy(f))) == float(scale)
    if kind == "pow2":
        assert float(scale) == 16384.0
    q, inv_scale = fk.int8_bank(torch.from_numpy(f))
    assert q.dtype == torch.int16 and tuple(q.shape) == f.shape and q.is_contiguous()
    assert (q[:, 121:] == 0).all()
    ref = np.asarray(_round_int_error_diffused(jnp.asarray(f[:, :121]), scale))
    assert np.array_equal(q[:, :121].numpy().astype(np.float32), ref)
    assert np.float32(inv_scale) == np.asarray((1.0 / scale).astype(jnp.float32))
    # the port's own rounding is the same function of the same scale
    mine = fk.round_int_error_diffused(torch.from_numpy(f[:, :121]), fk.int8_scale(torch.from_numpy(f)))
    assert np.array_equal(mine.numpy(), ref)
    # error diffusion keeps each row's sum within a step of the exact sum
    err = np.abs(ref.astype(np.float64).sum(1) * inv_scale - f[:, :121].astype(np.float64).sum(1))
    assert err.max() <= 1.01 * inv_scale


def _oracle(img: np.ndarray, buckets: np.ndarray, q16: np.ndarray, inv_scale: float):
    """numpy int64 raw of the int8 tier: bank row bucket*4 + phase, zero
    outside the plane, one rounding to float32, times 1/scale."""
    h, w = img.shape
    valid = (buckets >= 0) & (buckets < 216)
    r, c = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rows = np.where(valid, buckets, 0) * 4 + ((r - 5) % 2) * 2 + (c - 5) % 2
    pad = np.pad(img.astype(np.int64), 5)
    acc = np.zeros((h, w), np.int64)
    for t in range(121):
        i, j = divmod(t, 11)
        acc += pad[i:i + h, j:j + w] * q16[rows, t].astype(np.int64)
    return np.where(valid, acc.astype(np.float32) * np.float32(inv_scale), np.float32(0))


@pytest.mark.parametrize("kind", ["spread", "pow2"])
def test_plain_int8_raw_equals_int64_oracle(kind):
    rng = np.random.default_rng(72)
    h, w = 37, 53
    img = rng.integers(0, 256, (h, w)).astype(np.float32)  # full 8-bit range
    buckets = rng.integers(-8, 232, (h, w)).astype(np.int32)  # some out of range
    q, inv_scale = fk.int8_bank(torch.from_numpy(_bank(kind)))
    raw = flk.apply_filters_reference(torch.from_numpy(img), torch.from_numpy(buckets), q,
                                      inv_scale=inv_scale).numpy()
    assert raw.dtype == np.float32
    assert np.array_equal(raw, _oracle(img, buckets, q.numpy(), inv_scale))


def test_plain_int8_pass_matches_jax_i8():
    bank = make_jax_model(passes=1, seed=73).banks[0]
    h, w = 48, 64
    img = smooth(h, w, seed=73)
    kw = _kw(bank, 2)
    ref = np.asarray(raisr_pass_pallas_full(jnp.asarray(img), jnp.asarray(bank.filters),
                                            i8=True, interpret=True, **kw))
    q, inv_scale = fk.int8_bank(torch.from_numpy(bank.filters))
    out = fk.raisr_pass_full_reference(torch.from_numpy(img), q, tier="int8",
                                       inv_scale=inv_scale, **kw).numpy()
    assert out.shape == (h, w) and np.isfinite(out).all()
    rows = np.setdiff1d(np.arange(h), [0, h - 2])  # C6 rows under CoBC
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    # the tier differs from the float32 pass, as on the TPU
    f32 = fk.raisr_pass_full_reference(torch.from_numpy(img), torch.from_numpy(bank.filters),
                                       **kw).numpy()
    assert not np.array_equal(out, f32)


def test_int8_wrapper_checks_and_cpu_plain_version():
    """On the CPU the wrapper runs the plain version (no launch counted); the
    int8 tier needs its 1/scale, and takes 4 phases and 8-bit planes only."""
    bank = make_jax_model(passes=1, seed=74).banks[0]
    img = torch.from_numpy(smooth(24, 40, seed=74))
    q, inv_scale = fk.int8_bank(torch.from_numpy(bank.filters))
    kw = _kw(bank, 2)
    before = dict(fk.LAUNCHES)
    out = fk.raisr_pass_full(img, q, tier="int8", inv_scale=inv_scale, **kw)
    assert torch.equal(out, fk.raisr_pass_full_reference(img, q, tier="int8",
                                                         inv_scale=inv_scale, **kw))
    assert fk.LAUNCHES == before
    with pytest.raises(ValueError, match="inv_scale"):
        fk._check_tier("int8", q, 4, None, None, 235)
    with pytest.raises(ValueError, match="inv_scale"):
        fk._check_tier("float32", torch.from_numpy(bank.filters), 4, None, inv_scale, 235)
    with pytest.raises(ValueError, match="4 pixel types"):
        fk._check_tier("int8", q[:216].contiguous(), 1, None, inv_scale, 235)
    with pytest.raises(ValueError, match="8-bit planes"):
        fk._check_tier("int8", q, 4, None, inv_scale, 1023)
    with pytest.raises(ValueError, match="takes a torch.float32 bank"):
        fk.raisr_pass_full(img, q, inv_scale=inv_scale, **kw)  # the tier is not inferred
    fk._check_tier("int8", q, 4, None, inv_scale, 235)


@pytest.fixture(scope="module")
def yuv():
    # one small frame keeps the JAX engine's interpreted kernels short
    y = smooth_frames(1, 16, 24, seed=75)
    u = np.random.default_rng(75).integers(16, 240, (1, 8, 12)).astype(np.uint8)
    return y, u


def test_engine_int8_matches_jax_engine(yuv):
    """dtype="int8" through process_batch_device, 2x, 2 passes: the port's
    fused engine (its plain version here) against the JAX engine's fused
    int8 Pallas pipeline (interpreted off a TPU); U exact."""
    jm = make_jax_model(passes=2, seed=76)
    cfg = dict(passes=2, dtype="int8", backend="pallas")
    eng = RaisrEngine(RaisrConfig(**cfg), from_jax_model(jm), device="cpu")
    assert eng._statics.tier == "int8"
    y, u = yuv
    oy, ou, _ = eng.process_batch_device(torch.from_numpy(y), torch.from_numpy(u))
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(**cfg), jm)
    assert jeng._statics.i8 and jeng._statics.backend_interpret
    jy, ju, _ = (np.asarray(a) if a is not None else None
                 for a in jeng.process_batch_device(y, u))
    assert oy.dtype == torch.uint8 and tuple(oy.shape) == jy.shape
    frac, med = frac_and_median(oy.numpy(), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    assert np.array_equal(ou.numpy(), ju)
    # every frame is the plain int8 passes over the engine's banks, exactly
    x = cheap_upscale(torch.from_numpy(y[0]).to(torch.float32), 32, 48, 8)
    for p, bank in enumerate(eng._filters):
        x = fk.raisr_pass_full_reference(x, bank.filters, tier="int8",
                                         inv_scale=bank.inv_scale, **_kw(jm.banks[p], 2))
    assert torch.equal(oy[0], x.to(torch.uint8))
