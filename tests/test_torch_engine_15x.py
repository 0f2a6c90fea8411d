"""The port's engine at ratio 1.5 (single-phase banks) held against
raisr_tpu's engine: 8-bit YUV420 through process_batch_device, for 1 pass
and for 2 passes in two-pass modes 1 and 2.

Y is held to the JAX package's cross-backend bar (tests/test_fuzz_shapes.py:
under 2% of pixels differ, median difference 0); U and V are exact. The JAX
engine's Pallas path runs interpreted here (8-17 s a step), so each JAX step
runs once per module.
"""

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.engine import Frame
from raisr_tpu_torch.model.loader import from_jax_model
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from torch_port_util import frac_and_median, make_jax_model

N, H, W = 2, 32, 48
FUZZ_FRAC = 0.02
PASS_MODES = [(1, 1), (2, 1), (2, 2)]


@pytest.fixture(scope="module")
def models():
    jm = make_jax_model(passes=2, seed=1, pixel_types=1)
    return jm, from_jax_model(jm)


@pytest.fixture(scope="module")
def yuv():
    rng = np.random.default_rng(5)
    y = rng.integers(16, 235, (N, H, W)).astype(np.uint8)
    u = rng.integers(16, 240, (N, H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(16, 240, (N, H // 2, W // 2)).astype(np.uint8)
    return y, u, v


def _cfg(passes, mode, backend):
    return dict(ratio=1.5, passes=passes, mode=mode, backend=backend)


def _port_step(model, yuv, **cfg):
    eng = RaisrEngine(RaisrConfig(**cfg), model, device="cpu")
    return eng, eng.process_batch_device(*(torch.from_numpy(a) for a in yuv))


@pytest.mark.parametrize("backend", ["pallas", "reference"])
@pytest.mark.parametrize("passes,mode", PASS_MODES)
def test_device_step_matches_jax_engine(models, yuv, passes, mode, backend):
    """pallas: the port's single-phase fused pass (its plain version on the
    CPU) against the JAX engine's single-phase Pallas kernel, interpreted;
    reference: the taps paths of both packages."""
    jm, tm = models
    _, (oy, ou, ov) = _port_step(tm, yuv, **_cfg(passes, mode, backend))
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(**_cfg(passes, mode, backend)), jm)
    jy, ju, jv = (np.asarray(a) for a in jeng.process_batch_device(*yuv))
    assert oy.dtype == ou.dtype == ov.dtype == torch.uint8
    assert tuple(oy.shape) == (N, 48, 72) == jy.shape
    assert tuple(ou.shape) == tuple(ov.shape) == (N, 24, 36)
    frac, med = frac_and_median(oy.numpy(), jy)
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
    assert np.array_equal(ou.numpy(), ju)
    assert np.array_equal(ov.numpy(), jv)


@pytest.mark.parametrize("passes,mode", PASS_MODES)
def test_batch_equals_per_frame(models, yuv, passes, mode):
    """The guard-banded 1.5x stack (HR guard 9 rows in mode 1, 18 in mode 2)
    equals the per-frame path exactly, and goes through one fused call per
    pass (the plain version here: the counters stay put on the CPU)."""
    _, tm = models
    before = dict(fk.LAUNCHES)
    eng, (oy, ou, ov) = _port_step(tm, yuv, **_cfg(passes, mode, "pallas"))
    assert fk.LAUNCHES == before
    y, u, v = yuv
    for i in range(N):
        ref = eng.process(Frame(y=y[i], u=u[i], v=v[i]))
        assert np.array_equal(oy[i].numpy(), ref.y), i
        assert np.array_equal(ou[i].numpy(), ref.u), i
        assert np.array_equal(ov[i].numpy(), ref.v), i


@pytest.mark.parametrize("h,w,passes,evenoutput", [
    (22, 34, 1, False), (23, 31, 1, False), (17, 129, 1, True), (16, 16, 1, False),
    (8, 300, 1, False), (30, 40, 2, True),
])
def test_awkward_shapes_fused_matches_taps(models, h, w, passes, evenoutput):
    """Odd, tiny and wide planes at 1.5x (the float resize form, per-frame
    loop, vanishing zones; 30 rows stack with a 9-row guard): the fused pass
    against the taps path within the fuzz bar, as tests/test_fuzz_shapes.py
    holds raisr_tpu's 1.5x case (22, 34, one pass).

    The inputs are white noise, where the hash sits on ties. A second pass
    spreads the few tie flips of the first one (separable against literal
    structure tensor) over its 13x13 support: at 23x31 one pass differs in
    0.26% of pixels and two passes in 3.6%, while pass 2 alone on the same
    input differs in none. So the 2-pass case runs on a larger plane."""
    _, tm = models
    rng = np.random.default_rng(h * 100 + w)
    y = torch.from_numpy(
        np.clip(rng.normal(128, 40, (2, h, w)), 16, 235).round().astype(np.uint8))
    outs = {}
    for backend in ("pallas", "reference"):
        cfg = RaisrConfig(ratio=1.5, passes=passes, backend=backend, evenoutput=evenoutput)
        eng = RaisrEngine(cfg, tm, device="cpu")
        outs[backend] = eng.process_batch_device(y)[0].numpy()
    assert outs["pallas"].shape == (2, *cfg.output_size(h, w))
    frac, med = frac_and_median(outs["pallas"], outs["reference"])
    assert frac < FUZZ_FRAC and med == 0.0, (frac, med)
