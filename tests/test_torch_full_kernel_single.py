"""The port's single-phase fused pass (raisr_pass_full with pixel_types=1 and
its plain PyTorch version) held against raisr_tpu's single-phase Pallas kernel
(raisr_pass_pallas_full_single), run in interpret mode on the CPU.

Tolerance: at most 0.5% of pixels differ, median difference 0, as for the
4-phase pass (tests/test_torch_full_kernel.py): the TPU kernel gets its
float32 grade from hi/lo bfloat16 splits on the MXU while the port computes in
plain float32, so a few exact-tie hash buckets flip.

The single-phase TPU kernel tests its output zone one row low, as the
4-phase one does: row g0 + 1 + t for output row g0 + t
(full_kernel.py:1201-1204), while its own processed-zone mask uses the right
row (:1153-1156). Under Randomness it leaves the zone's last row (H-7) as the
cheap plane. The port follows pipeline._finish_pass; those two rows are left
out of the share and the TPU behaviour is pinned.
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pallas.full_kernel import raisr_pass_pallas_full_single
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


@pytest.fixture(scope="module")
def bank():
    return make_jax_model(passes=1, seed=0, pixel_types=1).banks[0]


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("h,w", [(48, 96), (160, 96)])
def test_plain_version_matches_jax_kernel(bank, blending, h, w):
    img = smooth(h, w, seed=21)
    kw = _kw(bank, blending)
    ref = np.asarray(raisr_pass_pallas_full_single(
        jnp.asarray(img), jnp.asarray(bank.filters), interpret=True, **kw))
    out = fk.raisr_pass_full_reference(
        torch.from_numpy(img), torch.from_numpy(bank.filters), pixel_types=1, **kw).numpy()
    assert out.shape == (h, w) and np.isfinite(out).all()

    first, last = (6, h - 7) if blending == 1 else (1, h - 2)
    shifted = [first - 1, last]  # rows the TPU kernel's zone test moves
    rows = np.setdiff1d(np.arange(h), shifted)
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac <= MAX_FRAC and med == 0.0, (frac, med)
    assert frac_and_median(out, ref)[1] == 0.0
    # the TPU kernel leaves the zone's last row as the cheap plane
    assert np.array_equal(ref[last], img[last])
    if blending == 1:
        # the port filters and blends that processed row, as
        # pipeline._finish_pass does
        assert not np.array_equal(out[last, 6:-6], img[last, 6:-6])


def test_stacked_frames(bank):
    """Guard-banded stack of 3 frames with the 1.5x mode-1 guard (9 rows, odd):
    the port against the JAX kernel on the stack, and the port's stack
    against its own per-frame passes, which must be exactly equal."""
    h, w, pad = 48, 96, 9
    kw = _kw(bank, 2)
    frames = [smooth(h, w, seed=40 + i) for i in range(3)]
    stack = np.concatenate(
        [np.pad(img, ((pad, pad), (0, 0)), mode="edge") for img in frames]
    )
    ref = np.asarray(raisr_pass_pallas_full_single(
        jnp.asarray(stack), jnp.asarray(bank.filters), frame_h=h,
        frame_pad=pad, interpret=True, **kw))
    f = torch.from_numpy(bank.filters)
    out = fk.raisr_pass_full_reference(
        torch.from_numpy(stack), f, frame_h=h, frame_pad=pad, pixel_types=1, **kw).numpy()
    frac, med = frac_and_median(out, ref)
    assert frac <= MAX_FRAC and med == 0.0, (frac, med)

    period = h + 2 * pad
    for i, img in enumerate(frames):
        single = fk.raisr_pass_full_reference(torch.from_numpy(img), f, pixel_types=1, **kw)
        got = out[i * period + pad: i * period + pad + h]
        assert np.array_equal(got, single.numpy()), i


def test_single_wrapper_on_cpu_runs_plain_version(bank):
    img = torch.from_numpy(smooth(24, 40, seed=5))
    f = torch.from_numpy(bank.filters)
    kw = dict(_kw(bank, 2), pixel_types=1)
    before = dict(fk.LAUNCHES)
    out = fk.raisr_pass_full(img, f, **kw)
    assert torch.equal(out, fk.raisr_pass_full_reference(img, f, **kw))
    assert fk.LAUNCHES == before  # no kernel launch


def test_single_phase_picks_bucket_rows(bank):
    """A single-phase bank is indexed by bucket alone: the same pass through
    a 4-phase bank whose four phase rows all copy the bucket's row is equal."""
    img = torch.from_numpy(smooth(40, 56, seed=6))
    kw = _kw(bank, 1)
    f1 = torch.from_numpy(bank.filters)
    f4 = f1.repeat_interleave(4, dim=0).contiguous()
    assert torch.equal(fk.raisr_pass_full_reference(img, f1, pixel_types=1, **kw),
                       fk.raisr_pass_full_reference(img, f4, **kw))


def test_wrapper_refuses_bad_phase_counts_and_banks(bank):
    """A plane off the pass's device is refused, and a phase count or bank
    shape the kernel does not take by the checks a pass runs on a CUDA
    device when it is built."""
    img = torch.empty((24, 40), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fk.raisr_pass_full(img, torch.from_numpy(bank.filters), pixel_types=1, **_kw(bank, 2))
    with pytest.raises(ValueError, match="4 or 1 pixel types"):
        fk._check_phases(9)
    with pytest.raises(ValueError, match=r"\[216, 128\]"):
        fk._check_bank(torch.zeros(864, 128), torch.device("cpu"), 216, (torch.float32,))
