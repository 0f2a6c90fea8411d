"""The port's 8-bit bfloat16 tier held against raisr_tpu's (mxu_passes=1):
the error-diffused bank rounding, the fused pass in both phase counts, and
the engine at dtype="auto".

Tolerances:
  - round_bf16_error_diffused is bit-identical to raisr_tpu's
    _round_bf16_error_diffused (the same float32 operations, round to
    nearest even in both);
  - the passes and the engine meet the JAX package's cross-backend bar
    (tests/test_fuzz_shapes.py): under 2% of pixels differ, median 0. Both
    sides multiply the same bf16 taps by exact 8-bit patches; the TPU kernel
    sums on the MXU in another order, so exact-tie hash buckets and rounding
    ties may flip. The rows that the TPU kernels' one-row zone shift moves
    (ROADMAP C6/C7) are left out of the pass comparison, as in
    tests/test_torch_full_kernel*.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pipeline import pass_statics as j_statics
from raisr_tpu.ops.pallas.full_kernel import (
    _round_bf16_error_diffused,
    raisr_pass_pallas_full,
    raisr_pass_pallas_full_single,
)
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.resize import cheap_upscale
from torch_port_util import frac_and_median, jax_tier, make_filters, make_jax_model, smooth

FUZZ_FRAC = 0.02


def _kw(bank, blending):
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(8),
        qstr=tuple(float(v) for v in bank.qstr),
        qcoh=tuple(float(v) for v in bank.qcoh),
        min_val=16, max_val=235, blending=blending,
    )


@pytest.mark.parametrize("pixel_types", [4, 1])
def test_round_bf16_bit_identical_to_jax(pixel_types):
    filters = make_filters(np.random.default_rng(60 + pixel_types), pixel_types)
    # a wider spread of magnitudes than a trained bank, so that many taps
    # round and the carry crosses binades
    filters[:, :121] *= np.random.default_rng(61).uniform(0.01, 100, (filters.shape[0], 1))
    filters = filters.astype(np.float32)
    out = fk.round_bf16_error_diffused(torch.from_numpy(filters))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == filters.shape
    assert out.is_contiguous()
    ref = np.asarray(_round_bf16_error_diffused(jnp.asarray(filters[:, :121])))
    assert np.array_equal(out[:, :121].float().numpy(), ref)
    assert (out[:, 121:] == 0).all()
    # the diffusion keeps each row's sum of rounding errors under one ulp of
    # a tap, far below plain rounding's random walk
    err = (out[:, :121].double().sum(1) - torch.from_numpy(filters[:, :121]).double().sum(1)).abs()
    plain = (torch.from_numpy(filters[:, :121]).to(torch.bfloat16).double().sum(1)
             - torch.from_numpy(filters[:, :121]).double().sum(1)).abs()
    assert err.mean() < plain.mean() / 4


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("pixel_types", [4, 1])
def test_plain_bf16_pass_matches_jax_mxu1(pixel_types, blending):
    bank = make_jax_model(passes=1, seed=62, pixel_types=pixel_types).banks[0]
    h, w = 48, 64
    img = smooth(h, w, seed=62)
    kw = _kw(bank, blending)
    jfn = raisr_pass_pallas_full if pixel_types == 4 else raisr_pass_pallas_full_single
    ref = np.asarray(jfn(jnp.asarray(img), jnp.asarray(bank.filters), mxu_passes=1,
                         interpret=True, **kw))
    f16 = fk.round_bf16_error_diffused(torch.from_numpy(bank.filters))
    out = fk.raisr_pass_full_reference(torch.from_numpy(img), f16, tier="bfloat16",
                                       pixel_types=pixel_types, **kw).numpy()
    assert out.shape == (h, w) and np.isfinite(out).all()
    first, last = (6, h - 7) if blending == 1 else (1, h - 2)
    rows = np.setdiff1d(np.arange(h), [first - 1, last])  # C6/C7 rows
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    # the tier differs from the float32 pass, as on the TPU
    f32 = fk.raisr_pass_full_reference(torch.from_numpy(img), torch.from_numpy(bank.filters),
                                       pixel_types=pixel_types, **kw).numpy()
    assert not np.array_equal(out, f32)


def test_plain_bf16_pass_is_float32_arithmetic_on_the_widened_bank():
    """A bf16 tap is widened to float32 exactly, so the bf16 pass is the
    float32 pass over bank.float(), and its wrapper on the CPU is the plain
    version (no kernel launch is counted)."""
    bank = make_jax_model(passes=1, seed=63).banks[0]
    img = torch.from_numpy(smooth(32, 48, seed=63))
    f16 = fk.round_bf16_error_diffused(torch.from_numpy(bank.filters))
    kw = _kw(bank, 2)
    before = dict(fk.LAUNCHES)
    out = fk.raisr_pass_full(img, f16, tier="bfloat16", **kw)
    assert torch.equal(out, fk.raisr_pass_full_reference(img, f16.float(), **kw))
    assert fk.LAUNCHES == before


@pytest.fixture(scope="module")
def yuv():
    # one frame keeps the JAX engine's interpreted kernels short
    rng = np.random.default_rng(64)
    y = rng.integers(16, 235, (1, 32, 48)).astype(np.uint8)
    u = rng.integers(16, 240, (1, 16, 24)).astype(np.uint8)
    return y, u


@pytest.mark.parametrize("ratio,passes,pixel_types", [(2.0, 2, 4), (1.5, 1, 1)])
def test_engine_auto_matches_jax_bf16_engine(yuv, ratio, passes, pixel_types):
    """dtype="auto" (the bf16 tier at 8 bits) through process_batch_device:
    the port's fused engine (its plain version here) against the JAX
    engine's fused bf16 Pallas pipeline (interpreted off a TPU); U exact."""
    jm = make_jax_model(passes=passes, seed=65, pixel_types=pixel_types)
    cfg = dict(ratio=ratio, passes=passes, dtype="auto", backend="pallas")
    eng = RaisrEngine(RaisrConfig(**cfg), from_jax_model(jm), device="cpu")
    assert eng._statics.tier == "bfloat16"
    y, u = yuv
    oy, ou, _ = eng.process_batch_device(torch.from_numpy(y), torch.from_numpy(u))
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(**cfg), jm)
    assert jeng._statics.mxu_passes == 1 and jeng._statics.backend_interpret
    jy, ju, _ = jeng.process_batch_device(y, u)
    jy, ju = np.asarray(jy), np.asarray(ju)
    assert oy.dtype == torch.uint8 and tuple(oy.shape) == jy.shape
    frac, med = frac_and_median(oy.numpy(), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    assert np.array_equal(ou.numpy(), ju)


def test_engine_auto_is_the_plain_bf16_passes(yuv):
    """The engine rounds each pass's bank once, at construction, and every
    served frame equals the plain passes over the rounded banks exactly."""
    jm = make_jax_model(passes=2, seed=66)
    tm = from_jax_model(jm)
    eng = RaisrEngine(RaisrConfig(passes=2, dtype="auto", backend="pallas"), tm, device="cpu")
    y = torch.from_numpy(yuv[0])
    oy = eng.process_batch_y(y)
    banks = [fk.round_bf16_error_diffused(torch.from_numpy(b.filters)) for b in tm.banks]
    assert all(torch.equal(a.filters, b) for a, b in zip(eng._filters, banks))
    h, w = y.shape[1:]
    for i in range(y.shape[0]):
        x = cheap_upscale(y[i].to(torch.float32), 2 * h, 2 * w, 8)
        for bank, f16 in zip(tm.banks, banks):
            x = fk.raisr_pass_full_reference(x, f16, tier="bfloat16", **_kw(bank, 2))
        assert torch.equal(oy[i], x), i
        assert torch.equal(oy[i], eng.upscale_y(y[i].to(torch.float32))), i


def test_engine_builds_every_tier():
    """Every tier builds an engine: at 10/16 bits every bf16 dtype, float32
    and int8 build an engine on the fused backend, at the tier raisr_tpu's
    pass_statics gives (pcenter for bfloat16/auto at 10 bits, the bf16 bank
    (p_split) otherwise, float32 at every depth, int8 with its int16 banks).
    The taps backend ignores the tier."""
    jm = make_jax_model(passes=1, seed=67)
    tm = from_jax_model(jm)
    cases = [(d, b) for d in ("bfloat16", "bfloat16_exact", "auto", "float32")
             for b in (10, 16)] + [("int8", 8)]
    for dtype, bits in cases:
        eng = RaisrEngine(RaisrConfig(dtype=dtype, bits=bits, backend="pallas"), tm,
                          device="cpu")
        want = jax_tier(j_statics(jcfg.RaisrConfig(dtype=dtype, bits=bits), jm, "pallas"))
        assert eng._statics.tier == want, (dtype, bits)
        (bank,) = eng._filters
        assert bank.filters.dtype == {"float32": torch.float32, "int8": torch.int16}.get(
            want, torch.bfloat16), (dtype, bits)
        assert (bank.pbias is not None) == (want == "pcenter")
        assert (bank.inv_scale is not None) == (want == "int8")
    # the tiers raisr_tpu names for these configs
    assert [jax_tier(j_statics(jcfg.RaisrConfig(dtype=d, bits=b), jm, "pallas"))
            for d, b in (("auto", 10), ("bfloat16_exact", 10), ("auto", 16),
                         ("float32", 16), ("int8", 8))] == [
        "pcenter", "bfloat16", "bfloat16", "float32", "int8"]
    # the taps backend ignores the tier
    assert RaisrEngine(RaisrConfig(dtype="int8", backend="reference"), tm,
                       device="cpu")._statics.tier == "float32"
