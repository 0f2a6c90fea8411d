"""The port's CUDA kernel on the card: held against its plain PyTorch
version, inside the engine's batched step, and under CUDA-graph capture.

Every test here needs a CUDA card and skips without one. This file imports
no jax, so it also runs where jax is absent; tests/conftest.py imports jax,
so there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu_torch.model.loader import FilterBank, RaisrModel
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from torch_port_util import QCOH, QSTR, make_filters, require_cuda, smooth

pytestmark = pytest.mark.cuda

# The kernel rounds every step as the plain version does (nvcc --fmad=false,
# the same order of operations), so the two must agree bit for bit.


def _model(passes=2, seed=0) -> RaisrModel:
    rng = np.random.default_rng(seed)
    return RaisrModel(24, 3, 3, 11, tuple(
        FilterBank(filters=make_filters(rng), qstr=np.asarray(QSTR, np.float32),
                   qcoh=np.asarray(QCOH, np.float32), pixel_types=4, taps=121,
                   source_dtype="fp32")
        for _ in range(passes)
    ))


def _kw(blending):
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(8), qstr=QSTR, qcoh=QCOH,
        min_val=16, max_val=235, blending=blending,
    )


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("h,w", [(270, 481), (37, 64), (46, 62), (16, 16), (40, 9400)])
def test_kernel_matches_plain_version(blending, h, w):
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, seed=h + w), device=dev)
    f = torch.tensor(make_filters(np.random.default_rng(1)), device=dev)
    before = fk.LAUNCHES
    got = fk.raisr_pass_full(img, f, **_kw(blending))
    want = fk.raisr_pass_full_reference(img, f, **_kw(blending))
    torch.cuda.synchronize()
    assert fk.LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert torch.equal(got, want), (int((diff > 0).sum()), float(diff.max()))


def test_kernel_stack_equals_per_frame():
    dev = require_cuda()
    h, w, pad = 64, 200, 12
    f = torch.tensor(make_filters(np.random.default_rng(2)), device=dev)
    frames = [smooth(h, w, seed=60 + i) for i in range(3)]
    stack = np.concatenate([np.pad(x, ((pad, pad), (0, 0)), mode="edge") for x in frames])
    tall = fk.raisr_pass_full(torch.tensor(stack, device=dev), f, frame_h=h,
                              frame_pad=pad, **_kw(2))
    period = h + 2 * pad
    for i, x in enumerate(frames):
        single = fk.raisr_pass_full(torch.tensor(x, device=dev), f, **_kw(2))
        assert torch.equal(tall[i * period + pad: i * period + pad + h], single), i


def test_device_step_and_graph_capture():
    dev = require_cuda()
    model = _model()
    rng = np.random.default_rng(3)
    y = torch.tensor(rng.integers(16, 235, (2, 40, 64)), dtype=torch.uint8, device=dev)
    u = torch.tensor(rng.integers(16, 240, (2, 20, 32)), dtype=torch.uint8, device=dev)
    eng = RaisrEngine(RaisrConfig(passes=2), model, device=dev)
    fk.LAUNCHES = 0
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == 2  # one fused launch per pass for the whole batch
    assert oy.device.type == "cuda" and oy.dtype == torch.uint8
    # the same step through the plain version on the CPU
    cpu = RaisrEngine(RaisrConfig(passes=2, backend="pallas"), model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(y.cpu(), u.cpu(), u.cpu())
    assert torch.equal(oy.cpu(), cy), int((oy.cpu() != cy).sum())
    assert torch.equal(ou.cpu(), cu)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eng.process_batch_device(y, u, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy, gu, gv = eng.process_batch_device(y, u, u)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)
