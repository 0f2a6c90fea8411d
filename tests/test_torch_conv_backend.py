"""The dense-conv filter apply (`apply_filters_conv`, the `xla` backend) held
against raisr_tpu's on the same plane, buckets and bank, and the engine with
backend="xla" against taps.

raisr_tpu computes the conv with lax.conv at Precision.HIGHEST, the port with
torch.nn.functional.conv2d in float32 (TF32 off): both sum the same 121
products per pixel in an order the library picks, so the raw values are held
to 1e-3 absolute on 8-bit content (values up to ~300), and the served pixels
to the cross-backend bar (under 2% of pixels differ, median 0).
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.ops import filter_apply as jfa
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.engine import _resolve_backend
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops import filter_apply as tfa
from torch_port_util import frac_and_median, make_filters, make_jax_model, smooth

RAW_ATOL = 1e-3
FUZZ_FRAC = 0.02


@pytest.mark.parametrize("pixel_types,ratio", [(4, 2), (1, 1)])
@pytest.mark.parametrize("h,w,chunk", [(37, 53, 8), (24, 32, 128), (16, 47, 5)])
def test_conv_matches_jax_conv_and_taps(pixel_types, ratio, h, w, chunk):
    rng = np.random.default_rng(h + w + pixel_types)
    filters = make_filters(rng, pixel_types)
    img = smooth(h, w, seed=h)
    buckets = rng.integers(0, 216, (h, w)).astype(np.int32)
    want = np.asarray(jfa.apply_filters_conv(
        jnp.asarray(img), jnp.asarray(buckets), jnp.asarray(filters), 11, pixel_types, 5,
        ratio, chunk_rows=chunk))
    got = tfa.apply_filters_conv(
        torch.from_numpy(img), torch.from_numpy(buckets), torch.from_numpy(filters), 11,
        pixel_types, 5, ratio, chunk_rows=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h, w)
    assert np.abs(got.numpy() - want).max() <= RAW_ATOL
    # and the port's own taps formulation over the same filter rows
    from raisr_tpu_torch.ops import hashing

    ptype = hashing.pixel_types(h, w, 2, 5, pixel_types == 4, device=torch.device("cpu"))
    taps = tfa.apply_filters_taps(
        torch.from_numpy(img), torch.from_numpy(buckets) * pixel_types + ptype,
        torch.from_numpy(filters), 11)
    assert float((got - taps).abs().max()) <= RAW_ATOL


def test_conv_refuses_other_phase_counts():
    f = torch.zeros((216 * 9, 128))
    with pytest.raises(ValueError, match="pixel type"):
        tfa.apply_filters_conv(torch.zeros((8, 8)), torch.zeros((8, 8), dtype=torch.int32),
                               f, 11, 9, 5, 3)


def test_conv_restores_the_callers_tf32_flag():
    before = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            tfa._conv_all_buckets(torch.zeros((12, 12)), torch.zeros((3, 11, 11)), 1)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.fixture(scope="module")
def models():
    jm = make_jax_model(passes=2, seed=6)
    return jm, from_jax_model(jm)


@pytest.mark.parametrize("passes", [1, 2])
def test_engine_xla_against_taps_and_jax_xla(models, passes):
    jm, tm = models
    assert _resolve_backend(RaisrConfig(backend="xla"), torch.device("cpu")) == "conv"
    rng = np.random.default_rng(12)
    y = np.stack([smooth(24, 40, seed=i) for i in range(2)]).astype(np.uint8)
    u = rng.integers(16, 240, (2, 12, 20)).astype(np.uint8)
    outs = {}
    for backend in ("xla", "reference"):
        eng = RaisrEngine(RaisrConfig(passes=passes, backend=backend), tm, device="cpu")
        assert eng._statics.tier == "float32"
        outs[backend] = [t.numpy() for t in eng.process_batch_device(
            torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(u))]
    assert np.array_equal(outs["xla"][1], outs["reference"][1])
    frac, med = frac_and_median(outs["xla"][0], outs["reference"][0])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(passes=passes, backend="xla"), jm)
    jy, ju, _ = (np.asarray(a) for a in jeng.process_batch_device(y, u, u))
    assert np.array_equal(outs["xla"][1], ju)
    frac, med = frac_and_median(outs["xla"][0], jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


def test_engine_xla_single_phase_and_phase0_rows():
    """1.5x with a single-phase bank, and a 4-phase bank at 2.5x (every pixel
    phase 0, as the taps path reads it): xla against taps."""
    rng = np.random.default_rng(13)
    y = torch.from_numpy(smooth(24, 32, seed=3).astype(np.uint8))[None]
    for ratio, pixel_types in ((1.5, 1), (2.5, 4)):
        tm = from_jax_model(make_jax_model(passes=1, seed=7, pixel_types=pixel_types))
        outs = [RaisrEngine(RaisrConfig(ratio=ratio, backend=b), tm, device="cpu")
                .process_batch_device(y)[0].numpy() for b in ("xla", "reference")]
        assert outs[0].shape == (1, int(24 * ratio), int(32 * ratio))
        frac, med = frac_and_median(*outs)
        assert frac < FUZZ_FRAC and med == 0.0, (ratio, frac, med)
