"""The port's cubic and lanczos cheap upscale (RaisrConfig.resize_mode) held
against raisr_tpu's on the same inputs, and the cases of
tests/test_resize_modes.py against the port.

The taps are numpy float64 cast to float32 in both packages, and each axis is
the same chain of float32 products and sums from tap 0 up, so the port is held
to raisr_tpu bit for bit (max abs error 0), un-rounded and rounded.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.ops import resize as jresize
from raisr_tpu_torch import RaisrConfig, RaisrEngine, RaisrError
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops import resize as tresize
from raisr_tpu_torch.ops.resize import (
    _cubic_kernel,
    _lanczos3_kernel,
    bilinear_upscale,
    cheap_upscale,
    resample_upscale,
)
from torch_port_util import make_jax_model

MODES = ("cubic", "lanczos")
# (in_h, in_w, out_h, out_w): 2x, 1.5x, an odd size with an evenoutput-like trim
SIZES = [(24, 32, 48, 64), (24, 32, 36, 48), (23, 31, 45, 62)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("in_size,out_size", [(24, 48), (24, 36), (23, 45), (1080, 2160),
                                              (1080, 1620), (5, 17)])
def test_axis_taps_equal_jax(mode, in_size, out_size):
    jidx, jw = jresize._axis_taps(in_size, out_size, mode)
    tidx, tw = tresize._axis_taps(in_size, out_size, mode)
    assert tidx.dtype == jidx.dtype == np.int32 and tw.dtype == jw.dtype == np.float32
    assert np.array_equal(tidx, jidx)
    assert np.array_equal(tw, jw)  # float32 weights, exactly


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("in_h,in_w,out_h,out_w", SIZES)
def test_resample_and_cheap_upscale_match_jax_bit_for_bit(mode, in_h, in_w, out_h, out_w):
    rng = np.random.default_rng(in_h * out_w)
    img = rng.integers(0, 256, (in_h, in_w)).astype(np.float32)
    raw_j = np.asarray(jresize.resample_upscale(jnp.asarray(img), out_h, out_w, mode))
    raw_t = resample_upscale(torch.from_numpy(img), out_h, out_w, mode).numpy()
    assert raw_t.shape == (out_h, out_w)
    assert np.array_equal(raw_t, raw_j), float(np.abs(raw_t - raw_j).max())
    for bits, scale in ((8, 1), (10, 4)):
        x = img * scale
        cheap_j = np.asarray(jresize.cheap_upscale(jnp.asarray(x), out_h, out_w, bits, mode))
        cheap_t = cheap_upscale(torch.from_numpy(x), out_h, out_w, bits, mode=mode).numpy()
        assert np.array_equal(cheap_t, cheap_j)
        assert cheap_t.min() >= 0 and cheap_t.max() <= (1 << bits) - 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("in_h,in_w,out_h,out_w", SIZES)
def test_batch_equals_per_plane_and_jax(mode, in_h, in_w, out_h, out_w):
    """cheap_upscale takes [..., H, W] in these modes too (process_plane_uv
    hands it batches): each plane of the batch equals the plane alone, and
    raisr_tpu's."""
    rng = np.random.default_rng(7)
    batch = rng.integers(16, 240, (3, in_h, in_w)).astype(np.float32)
    out = cheap_upscale(torch.from_numpy(batch), out_h, out_w, 8, mode=mode)
    assert tuple(out.shape) == (3, out_h, out_w)
    nested = cheap_upscale(torch.from_numpy(batch)[None], out_h, out_w, 8, mode=mode)
    assert torch.equal(nested[0], out)
    for i in range(3):
        alone = cheap_upscale(torch.from_numpy(batch[i]), out_h, out_w, 8, mode=mode)
        assert torch.equal(out[i], alone), i
        want = np.asarray(jresize.cheap_upscale(jnp.asarray(batch[i]), out_h, out_w, 8, mode))
        assert np.array_equal(out[i].numpy(), want), i


def _oracle(img: np.ndarray, out_h: int, out_w: int, kern, support: int):
    """Direct per-pixel separable resample: half-pixel mapping, border
    replicate, per-pixel weight normalization."""
    def axis(v, out_size):
        in_size = v.shape[0]
        res = np.zeros((out_size,) + v.shape[1:], np.float64)
        for i in range(out_size):
            src = (i + 0.5) * (in_size / out_size) - 0.5
            lo = int(np.floor(src)) - support + 1
            ws, acc = 0.0, 0.0
            for j in range(lo, lo + 2 * support):
                w = float(kern(np.asarray([src - j]))[0])
                ws += w
                acc = acc + w * v[min(max(j, 0), in_size - 1)]
            res[i] = acc / ws
        return res

    return axis(axis(img.astype(np.float64), out_h).T, out_w).T


class TestKernels:
    def test_cubic_matches_oracle(self):
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (9, 13)).astype(np.float32)
        out = resample_upscale(torch.from_numpy(img), 18, 26, "cubic").numpy()
        exp = _oracle(img, 18, 26, _cubic_kernel, 2)
        np.testing.assert_allclose(out, exp, rtol=1e-4, atol=1e-3)

    def test_lanczos_matches_oracle(self):
        rng = np.random.default_rng(1)
        img = rng.uniform(0, 255, (10, 12)).astype(np.float32)
        out = resample_upscale(torch.from_numpy(img), 15, 18, "lanczos").numpy()
        exp = _oracle(img, 15, 18, _lanczos3_kernel, 3)
        np.testing.assert_allclose(out, exp, rtol=1e-4, atol=1e-3)

    def test_constant_preserved_exactly(self):
        img = torch.full((8, 8), 127.0)
        for mode in MODES:
            out = resample_upscale(img, 16, 12, mode).numpy()
            np.testing.assert_allclose(out, 127.0, atol=1e-4)

    def test_flip_symmetry(self):
        # even kernels + the half-pixel mapping commute with flips
        rng = np.random.default_rng(6)
        img = rng.uniform(0, 255, (12, 10)).astype(np.float32)
        for mode in MODES:
            out = resample_upscale(torch.from_numpy(img), 24, 20, mode).numpy()
            flipped = resample_upscale(
                torch.from_numpy(img[::-1, ::-1].copy()), 24, 20, mode).numpy()
            np.testing.assert_allclose(out, flipped[::-1, ::-1], atol=1e-3)

    def test_bilinear_mode_is_the_default_path(self):
        rng = np.random.default_rng(2)
        img = torch.from_numpy(rng.uniform(0, 255, (7, 9)).astype(np.float32))
        assert torch.equal(resample_upscale(img, 14, 18, "bilinear"),
                           bilinear_upscale(img, 14, 18))


@pytest.fixture(scope="module")
def models():
    jm = make_jax_model(passes=1, seed=4)
    return jm, from_jax_model(jm)


def _plane(h=24, w=32, seed=3):
    # smooth content + mild noise: resamplers should nearly agree here
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(w), np.arange(h))
    img = 120 + 60 * np.sin(x / 5.0) + 40 * np.cos(y / 4.0)
    return np.clip(img + rng.normal(0, 3, (h, w)), 16, 235).astype(np.float32)


class TestEngineWiring:
    def _engine(self, tm, mode, backend="reference"):
        return RaisrEngine(RaisrConfig(backend=backend, resize_mode=mode), tm, device="cpu")

    def test_modes_differ_but_agree_closely(self, models):
        y = torch.from_numpy(_plane())
        outs = {m: self._engine(models[1], m).upscale_y(y).numpy()
                for m in ("bilinear", "cubic", "lanczos")}
        assert not np.array_equal(outs["bilinear"], outs["cubic"])
        assert not np.array_equal(outs["cubic"], outs["lanczos"])
        for mode in MODES:
            mse = np.mean((outs[mode] - outs["bilinear"]) ** 2)
            psnr = 10 * np.log10(255.0**2 / max(mse, 1e-9))
            assert psnr > 25.0, (mode, psnr)

    def test_uv_mode_wiring(self, models):
        uv = torch.from_numpy(_plane(12, 16, seed=4))
        a = self._engine(models[1], "bilinear").upscale_uv(uv).numpy()
        b = self._engine(models[1], "cubic").upscale_uv(uv).numpy()
        assert a.shape == b.shape == (24, 32)
        assert not np.array_equal(a, b)

    @pytest.mark.parametrize("backend", ["reference", "pallas"])
    def test_batch_matches_per_frame_cubic(self, models, backend):
        """A non-bilinear mode has no stacked form: the batch loops over the
        frames, on the taps and on the fused backend alike."""
        eng = self._engine(models[1], "cubic", backend)
        rng = np.random.default_rng(5)
        batch = torch.from_numpy(rng.integers(16, 235, (3, 24, 32)).astype(np.float32))
        out = eng.process_batch_y(batch)
        for i in range(3):
            assert torch.equal(out[i], eng.upscale_y(batch[i])), i
        uv = torch.from_numpy(rng.integers(16, 240, (3, 12, 16)).astype(np.float32))
        out_uv = eng.process_batch_uv(uv)
        for i in range(3):
            assert torch.equal(out_uv[i], eng.upscale_uv(uv[i])), i

    def test_bad_mode_rejected(self):
        with pytest.raises(RaisrError):
            RaisrConfig(resize_mode="bicubic")

    def test_shard_plus_nonbilinear_rejected(self, models):
        with pytest.raises(RaisrError, match="resize_mode=bilinear only"):
            RaisrEngine(RaisrConfig(resize_mode="cubic"), models[1], shard="data=2",
                        device="cpu")

    @pytest.mark.parametrize("mode", MODES)
    def test_engine_matches_jax_engine(self, models, mode):
        """The whole device step on taps, raisr_tpu against the port, with a
        non-bilinear resize: U and V (the resize alone) exact, Y under the
        cross-backend bar (under 2% of pixels differ, median 0)."""
        jm, tm = models
        rng = np.random.default_rng(8)
        y = np.clip(_plane(seed=9)[None], 16, 235).astype(np.uint8)
        u = rng.integers(16, 240, (1, 12, 16)).astype(np.uint8)
        jeng = jengine.RaisrEngine(
            jcfg.RaisrConfig(backend="reference", resize_mode=mode), jm)
        jy, ju, jv = (np.asarray(a) for a in jeng.process_batch_device(y, u, u))
        oy, ou, ov = self._engine(tm, mode).process_batch_device(
            torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(u))
        assert np.array_equal(ou.numpy(), ju) and np.array_equal(ov.numpy(), jv)
        d = np.abs(oy.numpy().astype(np.int64) - jy)
        assert (d > 0).mean() < 0.02 and np.median(d) == 0.0, ((d > 0).mean(), d.max())
