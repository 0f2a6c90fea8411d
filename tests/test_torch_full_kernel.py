"""The port's fused pass (raisr_pass_full and its plain PyTorch version) held
against raisr_tpu's fused Pallas kernel, run in interpret mode on the CPU.

Tolerance: at most 0.5% of pixels differ, median difference 0. The TPU kernel
gets its float32 grade from hi/lo bfloat16 splits on the MXU while the port
computes in plain float32, so a few exact-tie hash buckets flip (the JAX
paths measure 0.03-0.08% against each other).

The TPU kernel's output zone test sits one row low: it tests row r + 1 for
output row r (full_kernel.py:645-647, `g0 + 1`), while its own plain epilogue
(pipeline._finish_pass) and the reference test row r. So on the first row
above each zone edge the two differ by design: the port follows
pipeline._finish_pass. On a 48-row plane those two rows are left out of
the share and pinned separately; on a 160-row plane the whole plane stays
inside the bar.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pallas.full_kernel import raisr_pass_pallas_full
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops import pipeline
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from torch_port_util import frac_and_median, make_jax_model, smooth, smooth_frames

MAX_FRAC = 0.005


def _kw(bank, blending):
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(8),
        qstr=tuple(float(v) for v in bank.qstr),
        qcoh=tuple(float(v) for v in bank.qcoh),
        min_val=16, max_val=235, blending=blending,
    )


def _zone_rows(blending, eff_h):
    """(first, last) row of the output zone of one frame."""
    return (6, eff_h - 7) if blending == 1 else (1, eff_h - 2)


@pytest.fixture(scope="module")
def bank():
    return make_jax_model(passes=1, seed=0).banks[0]


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("h,w", [(48, 64), (160, 64)])
def test_plain_version_matches_jax_kernel(bank, blending, h, w):
    img = smooth(h, w, seed=21)
    kw = _kw(bank, blending)
    ref = np.asarray(raisr_pass_pallas_full(
        jnp.asarray(img), jnp.asarray(bank.filters), interpret=True, **kw))
    out = fk.raisr_pass_full_reference(
        torch.from_numpy(img), torch.from_numpy(bank.filters), **kw).numpy()
    assert out.shape == (h, w) and np.isfinite(out).all()

    first, last = _zone_rows(blending, h)
    shifted = [first - 1, last]  # rows the TPU kernel's zone test moves
    rows = np.setdiff1d(np.arange(h), shifted)
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac <= MAX_FRAC and med == 0.0, (frac, med)
    whole, whole_med = frac_and_median(out, ref)
    assert whole_med == 0.0
    if h >= 160:
        # tall enough that the two shifted rows stay inside the bar too
        assert whole <= MAX_FRAC, whole
    # the TPU kernel leaves the zone's last row as the cheap plane
    assert np.array_equal(ref[last], img[last])
    if blending == 1:
        # the port filters and blends that row (it is processed), as
        # pipeline._finish_pass does; under CoBC the row next to the border
        # is unprocessed and differs from cheap only where it clamps
        assert not np.array_equal(out[last, 6:-6], img[last, 6:-6])


def test_stacked_frames(bank):
    """Guard-banded stack of 3 frames (frame_h/frame_pad): the port against
    the JAX kernel on the stack, and the port's stack against its own
    per-frame passes, which must be exactly equal."""
    h, w, pad = 48, 128, 12
    kw = _kw(bank, 2)
    frames = [smooth(h, w, seed=40 + i) for i in range(3)]
    stack = np.concatenate(
        [np.pad(img, ((pad, pad), (0, 0)), mode="edge") for img in frames]
    )
    ref = np.asarray(raisr_pass_pallas_full(
        jnp.asarray(stack), jnp.asarray(bank.filters), frame_h=h,
        frame_pad=pad, interpret=True, **kw))
    f = torch.from_numpy(bank.filters)
    out = fk.raisr_pass_full_reference(
        torch.from_numpy(stack), f, frame_h=h, frame_pad=pad, **kw).numpy()
    frac, med = frac_and_median(out, ref)
    assert frac <= MAX_FRAC and med == 0.0, (frac, med)

    period = h + 2 * pad
    for i, img in enumerate(frames):
        single = fk.raisr_pass_full_reference(torch.from_numpy(img), f, **kw)
        got = out[i * period + pad: i * period + pad + h]
        assert np.array_equal(got, single.numpy()), i


def test_wrapper_on_cpu_runs_plain_version(bank):
    img = torch.from_numpy(smooth(24, 40, seed=5))
    f = torch.from_numpy(bank.filters)
    kw = _kw(bank, 2)
    before = dict(fk.LAUNCHES)
    out = fk.raisr_pass_full(img, f, **kw)
    assert torch.equal(out, fk.raisr_pass_full_reference(img, f, **kw))
    assert fk.LAUNCHES == before  # the kernel was not launched


def _tier_bank(tier, filters, pixel_types):
    """(bank, extras) of a tier from a float32 bank, as the engine prepares it."""
    f = filters if pixel_types == 4 else filters[0::4].contiguous()
    if tier == "int8":
        q, inv_scale = fk.int8_bank(f)
        return q, dict(inv_scale=inv_scale)
    if tier == "float32":
        return f, {}
    f16 = fk.round_bf16_error_diffused(f)
    return f16, (dict(pbias=fk.pcenter_bias(f16)) if tier == "pcenter" else {})


@pytest.mark.parametrize("tier,pixel_types", sorted(fk.LAUNCHES))
def test_wrapper_takes_each_tier_with_its_bank(bank, tier, pixel_types):
    """The caller names the tier; on the CPU each (tier, phases) form runs
    the plain version over the tier's bank and counts no launch. A
    FusedPass prepared from the float32 bank holds the tier's bank and
    extras and gives the same pass."""
    img = torch.from_numpy(smooth(24, 40, seed=7))
    f, extra = _tier_bank(tier, torch.from_numpy(bank.filters), pixel_types)
    kw = dict(_kw(bank, 2), pixel_types=pixel_types, tier=tier, **extra)
    before = dict(fk.LAUNCHES)
    out = fk.raisr_pass_full(img, f, **kw)
    assert torch.equal(out, fk.raisr_pass_full_reference(img, f, **kw))
    f32 = torch.from_numpy(bank.filters)
    prepared = fk.FusedPass.prepare(f32 if pixel_types == 4 else f32[0::4].contiguous(),
                                    **dict(_kw(bank, 2), pixel_types=pixel_types, tier=tier))
    assert prepared.filters.dtype == f.dtype and torch.equal(prepared.filters, f)
    assert (prepared.pbias is None) == ("pbias" not in extra)
    if "pbias" in extra:
        assert torch.equal(prepared.pbias, extra["pbias"])
    assert prepared.inv_scale == extra.get("inv_scale")
    assert torch.equal(prepared(img), out)
    assert fk.LAUNCHES == before


@pytest.mark.parametrize("tier,bank_tier,pixel_types,extras,max_val,match", [
    ("float64", "float32", 4, (), 235, "tier must be one of"),
    ("float32", "bfloat16", 4, (), 235, "float32 tier takes a torch.float32 bank"),
    ("bfloat16", "float32", 1, (), 235, "bfloat16 tier takes a torch.bfloat16 bank"),
    ("pcenter", "int8", 4, ("pbias",), 235, "pcenter tier takes a torch.bfloat16 bank"),
    ("int8", "bfloat16", 4, ("inv_scale",), 235, "int8 tier takes a torch.int16 bank"),
    ("pcenter", "bfloat16", 4, (), 1023, "pbias goes with the pcenter tier"),
    ("bfloat16", "pcenter", 4, ("pbias",), 1023, "pbias goes with the pcenter tier"),
    ("pcenter", "pcenter", 1, ("pbias",), 1023, "4 pixel types"),
    ("int8", "int8", 4, (), 235, "inv_scale goes with the int8 tier"),
    ("float32", "int8", 4, ("inv_scale",), 235, "takes a torch.float32 bank"),
    ("int8", "int8", 4, ("inv_scale",), 1023, "8-bit planes"),
])
def test_wrapper_refuses_a_bank_of_another_tier(bank, tier, bank_tier, pixel_types, extras,
                                                max_val, match):
    """The tier is never inferred from the bank: a bank, bias or 1/scale that
    is not the named tier's is refused on every device, before any kernel
    or plain version runs, and by the plain version itself."""
    f, extra = _tier_bank(bank_tier, torch.from_numpy(bank.filters), 4)
    kw = dict(_kw(bank, 2), max_val=max_val, pixel_types=pixel_types,
              **{k: extra.get(k, 1.0) for k in extras})
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match=match):
            fk.raisr_pass_full(torch.zeros((24, 40), device=dev), f, tier=tier, **kw)
    with pytest.raises(ValueError, match=match):
        fk.raisr_pass_full_reference(torch.zeros((24, 40)), f, tier=tier, **kw)


# the engine's configuration of each (tier, phases) form of the fused pass
_ENGINE_FORMS = {
    ("float32", 4): dict(), ("float32", 1): dict(ratio=1.5),
    ("bfloat16", 4): dict(dtype="bfloat16"), ("bfloat16", 1): dict(ratio=1.5, dtype="bfloat16"),
    ("pcenter", 4): dict(dtype="bfloat16", bits=10), ("int8", 4): dict(dtype="int8"),
}


@pytest.mark.parametrize("tier,pixel_types", sorted(fk.LAUNCHES))
def test_engine_passes_derive_nothing_after_construction(monkeypatch, tier, pixel_types):
    """The engine prepares its fused passes once: with the Gaussian kernel
    and the normalization factor unreachable from ops/pipeline after
    construction, process_batch_device and the rows=2 striped upscale_y run
    on and give the same outputs bit for bit."""
    form = _ENGINE_FORMS[tier, pixel_types]
    cfg = RaisrConfig(passes=2, backend="pallas", **form)
    model = from_jax_model(make_jax_model(passes=2, seed=31, pixel_types=pixel_types))
    eng = RaisrEngine(cfg, model, device="cpu")
    rows = RaisrEngine(cfg, model, shard="rows=2", device="cpu")
    assert eng._statics.tier == tier and eng._statics.pixel_types == pixel_types
    y = torch.from_numpy(smooth_frames(2, 32, 40, bits=cfg.bits, seed=32))

    def run():
        return eng.process_batch_device(y)[0], rows.upscale_y(y[0].to(torch.float32))

    want = run()

    def derived(*a, **k):
        raise AssertionError("a pass derived what its construction prepared")

    monkeypatch.setattr(pipeline, "gaussian_kernel_1d", derived)
    monkeypatch.setattr(pipeline, "normalization_factor", derived)
    got = run()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[1], eng.upscale_y(y[0].to(torch.float32)))


def test_wrapper_refuses_other_devices(bank):
    """No fallback: a tensor that is neither on the CPU nor on CUDA is
    refused, never run through the plain version."""
    img = torch.empty((24, 40), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fk.raisr_pass_full(img, torch.from_numpy(bank.filters), **_kw(bank, 2))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from raisr_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
