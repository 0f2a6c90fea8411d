"""The serving step's glue (raisr_tpu_torch/ops/cuda/upscale.py) held
against raisr_tpu on the CPU, where its wrappers run the plain version.

raisr_tpu's one-jit step (engine.py process_batch_device) fuses the unpack,
the guard-band pad (ops/pipeline.py process_plane_y_batch), the cheap upscale
(ops/resize.py cheap_upscale, cheap_upscale_stacked), the chroma batch
upscale (process_plane_uv_batch) and the repack. The port's
cheap_upscale_stack and cheap_upscale_planes compute the same on the same
frames: 3 frames of 36x52 at 2x (72x104), exact 1.5x (54x78) and a size of
the float form (53x77), at 8, 10 and 16 bits with both ends of the range
present, with guards of 6 and 12 rows, from uint8, uint16 and float32
input, bit for bit (max abs error 0): the exact forms are exact in any
order, and the float form's order is the plain one on both sides. One
exception is raisr_tpu's own: its per-plane float form (resize.py
bilinear_upscale, which process_plane_uv_batch runs at a ratio that is not
whole) is a + (b - a) * f, which XLA on the CPU may contract into one FMA and
so move a value on a .5 tie by 1 (tests/test_torch_resize.py); the chroma
planes of the float form are held to that file's bar, at most 0.1% of
pixels differing, by at most 1 (1 of 2964 at 16 bits here). The engine's
step on the CPU (the plain glue on the stacked route) is held against
raisr_tpu's on the same frames: Y under the JAX package's cross-backend bar
(tests/test_fuzz_shapes.py:51-53), U and V exact. The kernel itself is held
against this plain version on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.ops import pipeline as jp
from raisr_tpu.ops import resize as jr
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import upscale as up
from torch_port_util import frac_and_median, make_jax_model

N, H, W = 3, 36, 52
SIZES = [(72, 104), (54, 78), (53, 77)]  # 2x, exact 1.5x, the float form
# (packed type, bits): every input type, uint16 at 10 and 16 bits
TYPES = [(np.uint8, 8), (np.uint16, 10), (np.uint16, 16), (np.float32, 8)]
FUZZ_FRAC = 0.02
FLOAT_MAX_FRAC = 0.001  # raisr_tpu's contracted float form (tests/test_torch_resize.py)


def _frames(dtype, bits, seed, shape=(N, H, W)) -> np.ndarray:
    """Seeded integers over [0, 2^bits - 1], both ends present."""
    top = (1 << bits) - 1
    v = np.random.default_rng(seed).integers(0, top + 1, shape)
    v.flat[0], v.flat[-1] = 0, top
    return v.astype(dtype)


def _jax_stack(frames: np.ndarray, pad: int) -> jnp.ndarray:
    """raisr_tpu's guard-banded stack (ops/pipeline.py:480-482)."""
    n, h, w = frames.shape
    x = jnp.pad(jnp.asarray(frames).astype(jnp.float32), ((0, 0), (pad, pad), (0, 0)),
                mode="edge")
    return x.reshape(n * (h + 2 * pad), w)


def _jax_upscale_stack(x: jnp.ndarray, pad: int, out_h: int, out_w: int, bits: int):
    """raisr_tpu's upscale of a guard-banded stack (ops/pipeline.py:486-497)."""
    if out_h == 2 * H and out_w == 2 * W:
        return jr.cheap_upscale(x, 2 * x.shape[0], out_w, bits)
    return jr.cheap_upscale_stacked(x, N, H, pad, out_h, pad * out_h // H, out_w, bits)


@pytest.mark.parametrize("dtype,bits", TYPES)
@pytest.mark.parametrize("pad", [6, 12])
@pytest.mark.parametrize("out_h,out_w", SIZES)
def test_stack_from_frames_bit_identical(dtype, bits, pad, out_h, out_w):
    """Pass 1's input from packed frames: the guard-banded stack, upscaled."""
    frames = _frames(dtype, bits, seed=bits + pad + out_h)
    want = np.asarray(_jax_upscale_stack(_jax_stack(frames, pad), pad, out_h, out_w, bits))
    before = dict(up.UPSCALE_LAUNCHES)
    got = up.cheap_upscale_stack(torch.from_numpy(frames), N, H, pad, out_h, out_w, bits)
    assert up.UPSCALE_LAUNCHES == before  # the CPU runs the plain version
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (N * (out_h + 2 * (pad * out_h // H)), out_w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,bits", TYPES)
@pytest.mark.parametrize("pad", [6, 12])
def test_stack_alone_bit_identical(dtype, bits, pad):
    """Mode 2's LR stack: unpack and guard band only."""
    frames = _frames(dtype, bits, seed=3 * bits + pad)
    got = up.cheap_upscale_stack(torch.from_numpy(frames), N, H, pad, H, W, bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_stack(frames, pad)))


@pytest.mark.parametrize("bits", [8, 10, 16])
@pytest.mark.parametrize("out_h,out_w", SIZES)
def test_upscale_of_a_float_stack_bit_identical(bits, out_h, out_w):
    """Mode 2's inter-pass upscale of pass 1's float32 stack (guard 12)."""
    stack = _jax_stack(_frames(np.float32, bits, seed=bits + out_w), 12)
    want = np.asarray(_jax_upscale_stack(stack, 12, out_h, out_w, bits))
    got = up.cheap_upscale_stack(torch.tensor(np.asarray(stack)), N, H, 12, out_h, out_w,
                                 bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,bits", TYPES)
@pytest.mark.parametrize("out_h,out_w", [(H, W), (27, 39), (26, 38)])
@pytest.mark.parametrize("packed", [True, False])
def test_chroma_planes_bit_identical(dtype, bits, out_h, out_w, packed):
    """Chroma of 18x26 at 2x, exact 1.5x and the float form, against
    raisr_tpu's process_plane_uv_batch, packed out (the engine's type) or
    float32."""
    planes = _frames(dtype, bits, seed=5 * bits + out_h, shape=(N, H // 2, W // 2))
    want = np.asarray(jp.process_plane_uv_batch(
        jnp.asarray(planes).astype(jnp.float32), out_h, out_w, bits))
    out_dtype = (torch.uint8 if bits == 8 else torch.uint16) if packed else torch.float32
    got = up.cheap_upscale_planes(torch.from_numpy(planes), out_h, out_w, bits, out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == (N, out_h, out_w)
    d = np.abs(up.unpack_planes(got).numpy() - want)
    if (out_h, out_w) == (26, 38):  # the float form
        assert d.max() <= 1 and (d > 0).mean() <= FLOAT_MAX_FRAC, (d.max(), (d > 0).mean())
    else:
        assert d.max() == 0, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("cfg,pixel_types", [
    (dict(passes=2), 4),
    (dict(passes=2, mode=2), 4),
    (dict(passes=1, ratio=1.5), 1),
    (dict(passes=2, bits=10), 4),
])
def test_engine_step_matches_jax(cfg, pixel_types):
    """process_batch_device on the CPU, the stacked route (backend pallas:
    the plain glue and the plain fused pass) against raisr_tpu's step (its
    taps backend) on the same packed frames."""
    jm = make_jax_model(passes=cfg["passes"], seed=9, pixel_types=pixel_types)
    bits = cfg.get("bits", 8)
    dtype = np.uint8 if bits == 8 else np.uint16
    lo, hi = (16, 235) if bits == 8 else (64, 940)
    rng = np.random.default_rng(bits + cfg["passes"])
    y = rng.integers(lo, hi + 1, (N, H, W)).astype(dtype)
    u = rng.integers(lo, hi + 1, (N, H // 2, W // 2)).astype(dtype)
    v = rng.integers(lo, hi + 1, (N, H // 2, W // 2)).astype(dtype)
    eng = RaisrEngine(RaisrConfig(backend="pallas", **cfg), from_jax_model(jm), device="cpu")
    oy, ou, ov = eng.process_batch_device(*(torch.from_numpy(a) for a in (y, u, v)))
    jy, ju, jv = (np.asarray(a) for a in jengine.RaisrEngine(
        jcfg.RaisrConfig(backend="reference", **cfg), jm).process_batch_device(y, u, v))
    assert oy.dtype == ou.dtype == ov.dtype == torch.from_numpy(y).dtype
    assert tuple(oy.shape) == jy.shape and tuple(ou.shape) == ju.shape
    frac, med = frac_and_median(up.unpack_planes(oy).numpy(), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    np.testing.assert_array_equal(up.unpack_planes(ou).numpy(), ju)
    np.testing.assert_array_equal(up.unpack_planes(ov).numpy(), jv)
