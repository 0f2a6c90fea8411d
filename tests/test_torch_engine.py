"""The port's engine held against raisr_tpu's engine on the main path:
8-bit YUV420, 2x, 2 passes, two-pass mode 1, CountOfBitsChanged blending,
through process_batch_device.

Y is held to the JAX package's cross-backend bar (tests/test_fuzz_shapes.py:
under 2% of pixels differ, median difference 0); U and V are exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu.ops.pipeline import pass_statics as j_statics
from raisr_tpu_torch import RaisrConfig, RaisrEngine, RaisrError
from raisr_tpu_torch.engine import Frame, _resolve_backend
from raisr_tpu_torch.model.loader import from_jax_model
from torch_port_util import frac_and_median, jax_tier, make_jax_model

N, H, W = 2, 32, 48
FUZZ_FRAC = 0.02


@pytest.fixture(scope="module")
def models():
    jm = make_jax_model(passes=2, seed=1)
    return jm, from_jax_model(jm)


@pytest.fixture(scope="module")
def yuv():
    rng = np.random.default_rng(5)
    y = rng.integers(16, 235, (N, H, W)).astype(np.uint8)
    u = rng.integers(16, 240, (N, H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(16, 240, (N, H // 2, W // 2)).astype(np.uint8)
    return y, u, v


def _port_step(model, backend, yuv):
    eng = RaisrEngine(RaisrConfig(passes=2, backend=backend), model, device="cpu")
    y, u, v = (torch.from_numpy(a) for a in yuv)
    return eng, eng.process_batch_device(y, u, v)


def _jax_step(model, backend, yuv):
    eng = jengine.RaisrEngine(jcfg.RaisrConfig(passes=2, backend=backend), model)
    return [np.asarray(a) for a in eng.process_batch_device(*yuv)]


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_device_step_matches_jax_engine(models, yuv, backend):
    """pallas: the port's fused pass (its plain version on the CPU) against
    the JAX engine's fused Pallas kernel (interpreted off-TPU); reference:
    the taps paths of both packages."""
    jm, tm = models
    _, (oy, ou, ov) = _port_step(tm, backend, yuv)
    jy, ju, jv = _jax_step(jm, backend, yuv)
    assert oy.dtype == ou.dtype == ov.dtype == torch.uint8
    assert tuple(oy.shape) == (N, 2 * H, 2 * W)
    assert tuple(ou.shape) == tuple(ov.shape) == (N, H, W)
    frac, med = frac_and_median(oy.numpy(), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    assert np.array_equal(ou.numpy(), ju)
    assert np.array_equal(ov.numpy(), jv)


@pytest.mark.parametrize("backend", ["pallas", "reference"])
def test_batch_equals_per_frame(models, yuv, backend):
    _, tm = models
    eng, (oy, ou, ov) = _port_step(tm, backend, yuv)
    y, u, v = yuv
    for i in range(N):
        ref = eng.process(Frame(y=y[i], u=u[i], v=v[i]))
        assert ref.y.dtype == np.uint8
        assert np.array_equal(oy[i].numpy(), ref.y), i
        assert np.array_equal(ou[i].numpy(), ref.u), i
        assert np.array_equal(ov[i].numpy(), ref.v), i


@pytest.mark.parametrize("h,w,passes", [(23, 31, 2), (17, 129, 1), (16, 16, 1), (8, 300, 1)])
def test_awkward_shapes_fused_matches_taps(models, h, w, passes):
    """Odd, tiny and wide planes (ragged edge, zones that vanish): the fused
    pass against the taps path within the fuzz bar, as
    tests/test_fuzz_shapes.py holds the JAX backends."""
    _, tm = models
    rng = np.random.default_rng(h * 100 + w)
    y = torch.from_numpy(
        np.clip(rng.normal(128, 40, (2, h, w)), 16, 235).round().astype(np.uint8))
    outs = {}
    for backend in ("pallas", "reference"):
        eng = RaisrEngine(RaisrConfig(passes=passes, backend=backend), tm, device="cpu")
        outs[backend] = eng.process_batch_device(y)[0].numpy()
    assert outs["pallas"].shape == (2, 2 * h, 2 * w)
    frac, med = frac_and_median(outs["pallas"], outs["reference"])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


def test_mode2_batch_equals_per_frame(models, yuv):
    """Two-pass mode 2 (pass 1 at LR size, 12-row guard) through the stack."""
    _, tm = models
    eng = RaisrEngine(RaisrConfig(passes=2, mode=2, backend="pallas"), tm,
                      device="cpu")
    y = torch.from_numpy(yuv[0])
    out = eng.process_batch_y(y)
    for i in range(N):
        assert torch.equal(out[i], eng.upscale_y(y[i].to(torch.float32))), i


def test_backend_resolution_and_refusals(models):
    _, tm = models
    cpu = torch.device("cpu")
    assert _resolve_backend(RaisrConfig(), cpu) == "taps"
    assert _resolve_backend(RaisrConfig(), torch.device("cuda", 0)) == "pallas"
    assert _resolve_backend(RaisrConfig(backend="pallas"), cpu) == "pallas"
    assert _resolve_backend(RaisrConfig(backend="reference"), torch.device("cuda", 0)) == "taps"
    # xla is the dense-conv formulation on any device (tests/test_torch_conv_backend.py)
    assert _resolve_backend(RaisrConfig(backend="xla"), cpu) == "conv"
    assert RaisrEngine(RaisrConfig(backend="xla"), tm, device="cpu")._statics.backend == "conv"
    # a shard spec builds a mesh over the engine's device (two CPU entries
    # here; tests/test_torch_sharding.py holds what it serves)
    sharded = RaisrEngine(RaisrConfig(), tm, shard="data=2", device="cpu")
    assert sharded._mesh.shape == {"data": 2, "rows": 1}
    assert list(sharded._mesh.devices.reshape(-1)) == [cpu, cpu]
    # every tier is served, at the tier raisr_tpu's pass_statics gives: bf16
    # at 8 bits (auto resolves to it), pcenter at 10 bits (its banks carry
    # their bias) and int8 (int16 banks, 1/scale)
    jm, _ = models

    def tier(dtype, bits=8):
        return jax_tier(j_statics(jcfg.RaisrConfig(dtype=dtype, bits=bits), jm, "pallas"))

    eng16 = RaisrEngine(RaisrConfig(backend="pallas", dtype="auto"), tm, device="cpu")
    assert eng16._statics.tier == tier("auto") == "bfloat16"
    assert all(b.filters.dtype == torch.bfloat16 and b.pbias is None for b in eng16._filters)
    eng10 = RaisrEngine(RaisrConfig(backend="pallas", dtype="bfloat16", bits=10), tm,
                        device="cpu")
    assert eng10._statics.tier == tier("bfloat16", 10) == "pcenter"
    assert all(b.filters.dtype == torch.bfloat16 and b.pbias.dtype == torch.float32
               for b in eng10._filters)
    eng8 = RaisrEngine(RaisrConfig(backend="pallas", dtype="int8"), tm, device="cpu")
    assert eng8._statics.tier == tier("int8") == "int8"
    assert all(b.filters.dtype == torch.int16 and b.inv_scale > 0 for b in eng8._filters)
    # ratio 1.5 with a single-phase bank is served by the fused backend
    m15 = from_jax_model(make_jax_model(passes=1, seed=2, pixel_types=1))
    eng15 = RaisrEngine(RaisrConfig(ratio=1.5, backend="pallas"), m15, device="cpu")
    assert eng15._backend == "pallas" and eng15._statics.pixel_types == 1
    assert tuple(eng15.process_batch_device(
        torch.full((1, 16, 24), 100, dtype=torch.uint8))[0].shape) == (1, 24, 36)
    eng = RaisrEngine(RaisrConfig(passes=2), tm, device="cpu")
    with pytest.raises(RaisrError, match="meta"):
        eng.process_batch_device(torch.empty((1, 8, 8), dtype=torch.uint8, device="meta"))


def test_cuda_engine_without_cuda_raises(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RaisrError, match="CUDA is not available"):
        RaisrEngine(RaisrConfig(), models[1], device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import raisr_tpu_torch\n"
        "from raisr_tpu_torch.ops.cuda.full_kernel import raisr_pass_full\n"
        "from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor\n"
        "f = torch.zeros(864, 128); f[:, 60] = 1.0\n"
        "img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (24, 32)).astype(np.float32))\n"
        "out = raisr_pass_full(img, f, k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),\n"
        "                      nf=normalization_factor(8), qstr=(0.001, 0.02), qcoh=(0.2, 0.4))\n"
        "assert out.shape == img.shape\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raisr_tpu.')))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_JAX_OK" in r.stdout


def test_10bit_fused_matches_jax_taps(models):
    """10-bit content on the fused float32 pass (its plain version here)
    against the JAX taps engine: uint16 in and out, the fuzz bar on Y."""
    jm, tm = models
    rng = np.random.default_rng(6)
    y = rng.integers(64, 940, (1, 24, 40)).astype(np.uint16)
    eng = RaisrEngine(RaisrConfig(passes=2, bits=10, backend="pallas"), tm, device="cpu")
    oy, _, _ = eng.process_batch_device(torch.from_numpy(y))
    jeng = jengine.RaisrEngine(
        jcfg.RaisrConfig(passes=2, bits=10, backend="reference"), jm)
    jy = np.asarray(jeng.process_batch_device(y)[0])
    assert oy.dtype == torch.uint16 and jy.dtype == np.uint16
    frac, med = frac_and_median(oy.numpy().astype(np.int64), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
