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
import torch

from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pallas.full_kernel import raisr_pass_pallas_full
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from torch_port_util import frac_and_median, make_jax_model, smooth

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
    before = fk.LAUNCHES
    out = fk.raisr_pass_full(img, f, **kw)
    assert torch.equal(out, fk.raisr_pass_full_reference(img, f, **kw))
    assert fk.LAUNCHES == before  # the kernel was not launched


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
