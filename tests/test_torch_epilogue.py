"""The port's pass epilogue (ops/epilogue.py _finish_pass, and its wrapper
ops/cuda/full_kernel.py pass_epilogue, the plain version of launch B) on
frame stacks and row stripes.

raisr_tpu's plain epilogue (ops/pipeline.py _finish_pass) knows one frame
only, so a stack is held frame by frame and a stripe row by row against the
whole frame: bit-identical, since every stage is exact in float32 or rounds
the same single operations. Against raisr_tpu's fused Pallas kernel, run in
interpret mode with frame_h/frame_pad and row0/zone_h, the bar is the one of
tests/test_torch_full_kernel.py (at most 0.5% of pixels differ, median 0:
the hash's exact ties), with the rows its zone test moves left out (it tests
row r + 1 for output row r, full_kernel.py:645-647).
"""

import numpy as np
import jax.numpy as jnp
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu.config import RaisrConfig as JConfig
from raisr_tpu.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu.ops.pallas.full_kernel import raisr_pass_pallas_full
from raisr_tpu.ops.pipeline import _finish_pass as j_finish, pass_statics as j_statics
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.epilogue import _finish_pass as t_finish, processed_col_end
from torch_port_util import frac_and_median, make_jax_model, smooth

MAX_FRAC = 0.005


def _planes(h, w, seed, bits=8):
    """An integer-valued cheap plane and a raw plane around it, part of it
    outside (16, 235) and part exactly on the bounds (the reject is
    exclusive)."""
    rng = np.random.default_rng(seed)
    cheap = np.round(rng.uniform(0, (1 << bits) - 1, (h, w))).astype(np.float32)
    raw = cheap + rng.normal(0, 6, cheap.shape).astype(np.float32)
    edge = rng.random((h, w))
    raw[edge < 0.02] = 16.0
    raw[edge > 0.98] = 235.0
    return cheap, raw


def _jax_frame(cheap, raw, blending):
    js = j_statics(JConfig(blending=blending), make_jax_model(passes=1), "taps")
    return np.asarray(j_finish(jnp.asarray(cheap), jnp.asarray(raw), js))


def _port(cheap, raw, blending, **zone):
    return t_finish(torch.from_numpy(cheap), torch.from_numpy(raw), min_val=16, max_val=235,
                    blending=blending, loop_margin=6,
                    col_end=processed_col_end(cheap.shape[1], 6, True), **zone).numpy()


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("pad", [7, 12])
def test_finish_pass_stack_equals_jax_per_frame(blending, pad):
    """A guard-banded stack (an odd and an even pad): each frame's rows equal
    raisr_tpu's epilogue of that frame alone, bit for bit, and every guard
    row passes the cheap plane through."""
    h, w, n = 30, 41, 3
    frames = [_planes(h, w, 10 * pad + i) for i in range(n)]
    guard = [_planes(pad, w, 100 + i) for i in range(2 * n)]
    cheap = np.concatenate([x for i in range(n)
                            for x in (guard[2 * i][0], frames[i][0], guard[2 * i + 1][0])])
    raw = np.concatenate([x for i in range(n)
                          for x in (guard[2 * i][1], frames[i][1], guard[2 * i + 1][1])])
    out = _port(cheap, raw, blending, frame_h=h, frame_pad=pad)
    period = h + 2 * pad
    for i, (fc, fr) in enumerate(frames):
        top = i * period + pad
        assert np.array_equal(out[top: top + h], _jax_frame(fc, fr, blending)), i
        assert np.array_equal(out[top - pad: top], cheap[top - pad: top])
        assert np.array_equal(out[top + h: top + h + pad], cheap[top + h: top + h + pad])


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("row0,rows", [(17, 20), (-5, 25), (38, 30), (0, 60)])
def test_finish_pass_stripe_equals_jax_frame_rows(blending, row0, rows):
    """A row stripe of a 60-row frame (row0 inside, above the frame, and
    running past its bottom; out-of-frame rows replicate the edge row, as a
    halo does): every in-frame row but the stripe's own first and last, whose
    census misses a neighbour row, equals that row of raisr_tpu's epilogue
    of the whole frame, bit for bit."""
    zone_h, w = 60, 41
    cheap, raw = _planes(zone_h, w, 200 + row0)
    want = _jax_frame(cheap, raw, blending)
    g = np.clip(np.arange(row0, row0 + rows), 0, zone_h - 1)
    out = _port(cheap[g], raw[g], blending, row0=row0, zone_h=zone_h)
    inner = np.arange(1, rows - 1)
    held = inner[(row0 + inner >= 0) & (row0 + inner < zone_h)]
    assert held.size >= 15
    assert np.array_equal(out[held], want[row0 + held])
    # rows outside the frame fail every zone test
    outside = np.setdiff1d(np.arange(rows), np.arange(-row0, zone_h - row0))
    assert np.array_equal(out[outside], cheap[g][outside])


@pytest.mark.parametrize("blending", [1, 2])
def test_pass_epilogue_on_cpu_is_finish_pass(blending):
    """The wrapper of launch B runs the plain version on CPU tensors, with
    the wrapper's own zone arguments, and counts no launch."""
    cheap, raw = _planes(45, 52, 300)
    before = fk.EPILOGUE_LAUNCHES
    for zone in ({}, dict(frame_h=11, frame_pad=2), dict(row0=-4, zone_h=70)):
        got = fk.pass_epilogue(torch.from_numpy(cheap), torch.from_numpy(raw), min_val=16,
                               max_val=235, blending=blending, **zone)
        assert np.array_equal(got.numpy(), _port(cheap, raw, blending, **zone))
    assert fk.EPILOGUE_LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        fk.pass_epilogue(torch.empty((4, 4), device="meta"), torch.empty((4, 4), device="meta"))


# -- against the fused Pallas kernel (interpret mode) ----------------------------


def _kw(bank, blending):
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(8),
        qstr=tuple(float(v) for v in bank.qstr),
        qcoh=tuple(float(v) for v in bank.qcoh),
        min_val=16, max_val=235, blending=blending,
    )


def _shifted_rows(blending, eff_h):
    """Frame rows on which the TPU kernel's zone test differs by design: the
    row above the output zone and the zone's last row."""
    first, last = (6, eff_h - 7) if blending == 1 else (1, eff_h - 2)
    return first - 1, last


@pytest.fixture(scope="module")
def bank():
    return make_jax_model(passes=1, seed=3).banks[0]


@pytest.mark.parametrize("blending", [1, 2])
def test_stack_with_odd_pad_matches_jax_kernel(bank, blending):
    """3 frames with a 7-row guard band: the port's plain pass against the
    TPU kernel on the same stack. (An odd guard moves a frame's pixel phases,
    so with a 4-phase bank the stack is not the per-frame passes, in either
    package; the serving paths stack 4-phase banks with even guards.)"""
    h, w, pad = 40, 64, 7
    frames = [smooth(h, w, seed=50 + i) for i in range(3)]
    stack = np.concatenate([np.pad(x, ((pad, pad), (0, 0)), mode="edge") for x in frames])
    kw = dict(_kw(bank, blending), frame_h=h, frame_pad=pad)
    ref = np.asarray(raisr_pass_pallas_full(
        jnp.asarray(stack), jnp.asarray(bank.filters), interpret=True, **kw))
    out = fk.raisr_pass_full_reference(
        torch.from_numpy(stack), torch.from_numpy(bank.filters), **kw).numpy()
    period = h + 2 * pad
    moved = [i * period + pad + r for i in range(3) for r in _shifted_rows(blending, h)]
    rows = np.setdiff1d(np.arange(stack.shape[0]), moved)
    frac, med = frac_and_median(out[rows], ref[rows])
    assert frac <= MAX_FRAC and med == 0.0, (frac, med)
    # every guard row passes the cheap plane through, in both
    guard = np.setdiff1d(np.arange(stack.shape[0]),
                         [i * period + pad + r for i in range(3) for r in range(h)])
    assert np.array_equal(out[guard], stack[guard])
    assert np.array_equal(ref[guard], stack[guard])


@pytest.mark.parametrize("blending", [1, 2])
def test_stripe_matches_jax_kernel(bank, blending):
    """A 48-row stripe from global row 20 of a 60-row frame, its rows past
    the frame's bottom replicating the last one: zones in global
    coordinates (row0/zone_h), against the TPU kernel on the same stripe.
    The stripe's first 8 rows are halo: their patches and tensor windows
    reach above the stripe, where the two packages pad differently, and a
    sharded run drops them."""
    zone_h, w, row0, rows = 60, 64, 20, 48
    frame = smooth(zone_h, w, seed=60)
    stripe = frame[np.clip(np.arange(row0, row0 + rows), 0, zone_h - 1)]
    kw = _kw(bank, blending)
    ref = np.asarray(raisr_pass_pallas_full(
        jnp.asarray(stripe), jnp.asarray(bank.filters), interpret=True,
        row0=jnp.asarray(row0, jnp.int32), zone_h=zone_h, **kw))
    out = fk.raisr_pass_full_reference(
        torch.from_numpy(stripe), torch.from_numpy(bank.filters), row0=row0, zone_h=zone_h,
        **kw).numpy()
    moved = [r - row0 for r in _shifted_rows(blending, zone_h) if row0 <= r < row0 + rows]
    assert len(moved) == 1  # the bottom zone edge lies in the stripe
    keep = np.setdiff1d(np.arange(8, rows), moved)
    frac, med = frac_and_median(out[keep], ref[keep])
    assert frac <= MAX_FRAC and med == 0.0, (frac, med)
    # below the frame nothing is processed, in either
    below = np.arange(zone_h - row0, rows)
    assert np.array_equal(out[below], stripe[below])
    assert np.array_equal(ref[below], stripe[below])
