"""The port's >8-bit tiers held against raisr_tpu's: pcenter (10-bit
bfloat16, 4 phases: bf16(P - 512) against the error-diffused bf16 bank, plus
512 * sum(F')), p_split (bfloat16 at 16 bits, bfloat16_exact at 10/16, and
bfloat16 at 10 bits on the single-phase pass: the bf16 bank against the
exact patch) and the float32 grade at 10/16 bits, with uint16 frames.

Tolerances:
  - the plain passes and the engine meet the JAX package's cross-backend bar
    (tests/test_fuzz_shapes.py): under 2% of pixels differ, median 0. Both
    sides multiply the same bf16 taps by the same patch values; the TPU
    kernel sums on the MXU in another order and adds its bias in another
    rounding, so exact-tie buckets and rounding ties may flip. The rows the
    TPU kernels' zone shift moves (ROADMAP C6/C7) are left out of the pass
    comparison;
  - p_split needs no bank of its own: a bf16 tap times an integer of up to
    16 bits is exact in float32, so the bf16 bank against the plane is
    [F', F'] x [Phi, Plo] (checked exactly on 16-bit values);
  - every served frame equals the plain passes over the engine's prepared
    banks, exactly, at 10 and 16 bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pallas.full_kernel import (
    _round_bf16_error_diffused,
    raisr_pass_pallas_full,
    raisr_pass_pallas_full_single,
)
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.resize import cheap_upscale
from torch_port_util import frac_and_median, make_jax_model, smooth, smooth_frames

FUZZ_FRAC = 0.02


def _kw(bank, blending, bits=10):
    cfg = RaisrConfig(bits=bits)
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(bits),
        qstr=tuple(float(v) for v in bank.qstr),
        qcoh=tuple(float(v) for v in bank.qcoh),
        min_val=cfg.min_val, max_val=cfg.max_val, blending=blending,
    )


def _held_rows(h, blending):
    """Rows outside the TPU kernels' one-row zone shift (C6/C7)."""
    first, last = (6, h - 7) if blending == 1 else (1, h - 2)
    return np.setdiff1d(np.arange(h), [first - 1, last])


def test_pcenter_bias():
    """512 * sum(F') per row, F' the bf16 bank: against raisr_tpu's
    pcenter * sum(fhi) (full_kernel.py:806-814) within float32 rounding of
    the sum, and exact in the port (float64 sum, one rounding)."""
    f = make_jax_model(passes=1, seed=80).banks[0].filters
    f16 = fk.round_bf16_error_diffused(torch.from_numpy(f))
    bias = fk.pcenter_bias(f16)
    assert bias.dtype == torch.float32 and tuple(bias.shape) == (864,)
    exact = 512.0 * f16.double().sum(1)
    assert torch.equal(bias, exact.float())
    ref = 512.0 * np.asarray(jnp.sum(_round_bf16_error_diffused(jnp.asarray(f[:, :121])), axis=1))
    np.testing.assert_allclose(bias.numpy(), ref, rtol=2e-6, atol=0)


def test_plain_pcenter_pass_matches_jax():
    bank = make_jax_model(passes=1, seed=81).banks[0]
    h, w = 48, 64
    img = smooth(h, w, bits=10, seed=81)
    kw = _kw(bank, 2)
    ref = np.asarray(raisr_pass_pallas_full(
        jnp.asarray(img), jnp.asarray(bank.filters), mxu_passes=1, pcenter=512.0,
        interpret=True, **kw))
    f16 = fk.round_bf16_error_diffused(torch.from_numpy(bank.filters))
    out = fk.raisr_pass_full_reference(torch.from_numpy(img), f16, tier="pcenter",
                                       pbias=fk.pcenter_bias(f16), **kw).numpy()
    assert out.shape == (h, w) and np.isfinite(out).all()
    rows = _held_rows(h, 2)
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    # centring rounds 10-bit values to bf16: not the exact-patch pass
    exact = fk.raisr_pass_full_reference(torch.from_numpy(img), f16, tier="bfloat16",
                                         **kw).numpy()
    assert not np.array_equal(out, exact)


@pytest.mark.parametrize("pixel_types", [4, 1])
def test_plain_p_split_pass_matches_jax(pixel_types):
    """p_split, 10 bits: the 4-phase kernel (bfloat16_exact) and the
    single-phase one (bfloat16 at 1.5x) against raisr_tpu's p_split."""
    bank = make_jax_model(passes=1, seed=82, pixel_types=pixel_types).banks[0]
    h, w = 48, 64
    img = smooth(h, w, bits=10, seed=82)
    kw = _kw(bank, 2)
    jfn = raisr_pass_pallas_full if pixel_types == 4 else raisr_pass_pallas_full_single
    ref = np.asarray(jfn(jnp.asarray(img), jnp.asarray(bank.filters), mxu_passes=2,
                         p_split=True, interpret=True, **kw))
    f16 = fk.round_bf16_error_diffused(torch.from_numpy(bank.filters))
    out = fk.raisr_pass_full_reference(torch.from_numpy(img), f16, pixel_types=pixel_types,
                                       tier="bfloat16", **kw).numpy()
    rows = _held_rows(h, 2)
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


def test_p_split_products_are_exact_at_16_bits():
    """[F', F'] x [Phi, Plo] equals F' x P: every product of a bf16 tap and a
    16-bit integer is exact in float32, and Phi + Plo == P."""
    rng = np.random.default_rng(83)
    f16 = fk.round_bf16_error_diffused(
        torch.from_numpy(make_jax_model(passes=1, seed=83).banks[0].filters))[:, :121]
    p = torch.from_numpy(rng.integers(0, 65536, f16.shape).astype(np.float32))
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    assert torch.equal(hi + lo, p)
    prod = f16.float() * p
    assert torch.equal(prod.double(), f16.double() * p.double())
    assert torch.equal(prod, f16.float() * hi + f16.float() * lo)


@pytest.fixture(scope="module")
def yuv10():
    # one small frame keeps the JAX engine's interpreted kernels short
    y = smooth_frames(1, 16, 24, bits=10, seed=84)
    u = np.random.default_rng(84).integers(64, 960, (1, 8, 12)).astype(np.uint16)
    return y, u


@pytest.mark.parametrize("dtype,tier", [("bfloat16", "pcenter"), ("bfloat16_exact", "bfloat16")])
def test_engine_10bit_matches_jax_engine(yuv10, dtype, tier):
    """10-bit uint16 frames through process_batch_device, 2x, 1 pass: the
    port's fused engine (its plain version here) against the JAX engine's
    fused Pallas pipeline at the same tier (interpreted off a TPU); U
    exact."""
    jm = make_jax_model(passes=1, seed=85)
    cfg = dict(passes=1, bits=10, dtype=dtype, backend="pallas")
    eng = RaisrEngine(RaisrConfig(**cfg), from_jax_model(jm), device="cpu")
    assert eng._statics.tier == tier
    y, u = yuv10
    oy, ou, _ = eng.process_batch_device(torch.from_numpy(y), torch.from_numpy(u))
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(**cfg), jm)
    js = jeng._statics
    assert (js.pcenter == 512.0) == (tier == "pcenter") and js.p_split == (tier != "pcenter")
    jy, ju, _ = (np.asarray(a) if a is not None else None
                 for a in jeng.process_batch_device(y, u))
    assert oy.dtype == ou.dtype == torch.uint16 and tuple(oy.shape) == jy.shape
    frac, med = frac_and_median(oy.numpy().astype(np.int64), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    assert np.array_equal(ou.numpy(), ju)


@pytest.mark.parametrize("bits,dtype,ratio", [
    (16, "bfloat16", 2.0), (16, "float32", 2.0), (10, "float32", 2.0),
    (10, "bfloat16", 1.5), (10, "bfloat16", 2.0),
])
def test_engine_hibit_is_the_plain_passes(bits, dtype, ratio):
    """Every served uint16 frame equals the plain passes over the engine's
    prepared banks, exactly; the batch equals the frames one by one; 16-bit
    values reach 65535 and come back as uint16."""
    pt = 4 if ratio == 2.0 else 1
    jm = make_jax_model(passes=1, seed=86, pixel_types=pt)
    cfg = RaisrConfig(passes=1, bits=bits, dtype=dtype, ratio=ratio, backend="pallas")
    eng = RaisrEngine(cfg, from_jax_model(jm), device="cpu")
    y = smooth_frames(2, 16, 24, bits=bits, seed=87)
    y[:, 8, 12] = (1 << bits) - 1  # the top code, 65535 at 16 bits
    y = torch.from_numpy(y)
    oy, _, _ = eng.process_batch_device(y)
    assert oy.dtype == torch.uint16
    out_h, out_w = cfg.output_size(16, 24)
    (bank,) = eng._filters
    for i in range(2):
        x = cheap_upscale(y[i].to(torch.float32), out_h, out_w, bits)
        x = fk.raisr_pass_full_reference(x, bank.filters, tier=eng._statics.tier,
                                         pbias=bank.pbias, pixel_types=pt,
                                         **_kw(jm.banks[0], 2, bits))
        assert torch.equal(oy[i].to(torch.int32), x.to(torch.int32)), i
        assert torch.equal(oy[i].to(torch.float32),
                           eng.upscale_y(y[i].to(torch.float32))), i
