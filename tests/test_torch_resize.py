"""The port's non-2x bilinear resize held against raisr_tpu.ops.resize.

Exact ratios (1.5x, and 1.5x on one axis with 2x on the other) run in exact
integer arithmetic on both sides, so they must be bit-identical. Other sizes
(odd heights, `evenoutput` trims) take the float form a + (b - a) * frac. The
port rounds each product and sum on its own; XLA on the CPU may contract the
product and the add into one FMA, which can move a value that lies on a .5
tie to the other side and change that pixel by 1. So the float form is held
to at most 0.1% of pixels differing, by at most 1 (0 measured here with the
shapes below).
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.ops import resize as jr
from raisr_tpu_torch.config import RaisrConfig
from raisr_tpu_torch.ops import resize as tr
from torch_port_util import smooth

FLOAT_MAX_FRAC = 0.001


def _both(img, out_h, out_w, bits):
    ref = np.asarray(jr.cheap_upscale(jnp.asarray(img), out_h, out_w, bits))
    out = tr.cheap_upscale(torch.from_numpy(img), out_h, out_w, bits)
    assert out.dtype == torch.float32 and tuple(out.shape) == (out_h, out_w)
    return out.numpy(), ref


@pytest.mark.parametrize("h,w,bits", [(20, 30, 8), (22, 34, 8), (32, 48, 10),
                                      (12, 300, 16), (1080, 1920, 8)])
def test_exact_ratios_bit_identical(h, w, bits):
    img = smooth(h, w, bits, seed=h + w + bits)
    out_h, out_w = (3 * h) // 2, (3 * w) // 2
    assert tr._plane_exact(h, w, out_h, out_w)
    out, ref = _both(img, out_h, out_w, bits)
    assert np.array_equal(out, ref)
    # mixed: 1.5x rows, 2x columns (and the reverse) is exact too
    out, ref = _both(img, out_h, 2 * w, bits)
    assert np.array_equal(out, ref)
    out, ref = _both(img, 2 * h, out_w, bits)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("h,w,evenoutput", [(17, 23, False), (17, 23, True),
                                            (33, 49, False), (9, 131, True),
                                            (1, 5, False)])
def test_float_form_matches(h, w, evenoutput):
    """Odd sizes at ratio 1.5: int(1.5 * h) is not exactly 1.5 h, so both
    packages take the float form."""
    out_h, out_w = RaisrConfig(ratio=1.5, evenoutput=evenoutput).output_size(h, w)
    assert not tr._plane_exact(h, w, out_h, out_w)
    img = smooth(h, w, seed=h * w)
    out, ref = _both(img, out_h, out_w, 8)
    d = np.abs(out - ref)
    assert d.max() <= 1 and (d > 0).mean() <= FLOAT_MAX_FRAC, (d.max(), (d > 0).mean())
    # the un-rounded float form itself
    raw_ref = np.asarray(jr.bilinear_upscale(jnp.asarray(img), out_h, out_w))
    raw = tr.bilinear_upscale(torch.from_numpy(img), out_h, out_w).numpy()
    np.testing.assert_allclose(raw, raw_ref, rtol=0, atol=2 * np.spacing(np.float32(255)))


@pytest.mark.parametrize("h,w,out", [(20, 30, (30, 45)), (17, 23, (25, 34))])
def test_batch_upscales_each_plane(h, w, out):
    """[N, H, W] is upscaled plane by plane, as raisr_tpu's per-frame vmap."""
    frames = np.stack([smooth(h, w, seed=s) for s in (1, 2, 3)])
    got = tr.cheap_upscale(torch.from_numpy(frames), *out, 8).numpy()
    for i, img in enumerate(frames):
        assert np.array_equal(got[i], tr.cheap_upscale(torch.from_numpy(img), *out, 8).numpy())


@pytest.mark.parametrize("pad", [6, 12])
@pytest.mark.parametrize("h,w,out_h,out_w", [(32, 48, 48, 72), (20, 34, 30, 51)])
def test_stacked_matches_jax_and_per_frame(pad, h, w, out_h, out_w):
    n = 3
    frames = [smooth(h, w, seed=7 + i) for i in range(n)]
    stack = np.concatenate([np.pad(f, ((pad, pad), (0, 0)), mode="edge") for f in frames])
    pad_out = pad * out_h // h
    ref = np.asarray(jr.cheap_upscale_stacked(
        jnp.asarray(stack), n, h, pad, out_h, pad_out, out_w, 8))
    out = tr.cheap_upscale_stacked(
        torch.from_numpy(stack), n, h, pad, out_h, pad_out, out_w, 8).numpy()
    assert out.shape == (n * (out_h + 2 * pad_out), out_w)
    assert np.array_equal(out, ref)
    period = out_h + 2 * pad_out
    for i, img in enumerate(frames):
        per = tr.cheap_upscale(torch.from_numpy(img), out_h, out_w, 8).numpy()
        assert np.array_equal(out[i * period + pad_out: i * period + pad_out + out_h], per), i


def test_stacked_float_form_rows_equal_per_frame():
    """A stack at a non-exact ratio (float form): frame rows still equal the
    per-frame upscale exactly, because the row vectors are tiled."""
    n, h, w, pad, out_h, out_w = 2, 16, 23, 6, 24, 34
    frames = [smooth(h, w, seed=30 + i) for i in range(n)]
    stack = np.concatenate([np.pad(f, ((pad, pad), (0, 0)), mode="edge") for f in frames])
    assert not tr._plane_exact(h, w, out_h, out_w)
    out = tr.cheap_upscale_stacked(torch.from_numpy(stack), n, h, pad, out_h, 9,
                                   out_w, 8).numpy()
    for i, img in enumerate(frames):
        per = tr.cheap_upscale(torch.from_numpy(img), out_h, out_w, 8).numpy()
        assert np.array_equal(out[i * (out_h + 18) + 9: i * (out_h + 18) + 9 + out_h], per)
    with pytest.raises(ValueError, match="not 3 frames"):
        tr.cheap_upscale_stacked(torch.from_numpy(stack), 3, h, pad, out_h, 9, out_w, 8)


def test_vectors_are_cached_per_device():
    """The index/weight vectors are built once per (sizes, device): the
    second call at a shape makes no new host-to-device copy."""
    first = tr._axis_vectors(32, 48, True, torch.device("cpu"))
    again = tr._axis_vectors(32, 48, True, torch.device("cpu"))
    assert first[0] is again[0] and first[3] == again[3] == 6.0
