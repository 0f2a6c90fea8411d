"""The port's CUDA kernels on the card: held against their plain PyTorch
versions, inside the engine's batched step, and under CUDA-graph capture:
the fused pass (every tier: float32, bf16 at 8 bits and p_split at 10/16,
pcenter, int8; 4 and 1 phases), launch B alone (pass_epilogue) and its
packed store (the batched step's last pass), the filter apply
(apply_filters, 4 and 1 phases, banks of 1 to 256 buckets and the refusal
above shared memory, the largest bank it admits), launch A alone
(apply_filters_hash), launch A2 alone over uint8 buckets (gather_buckets:
planes that stress its lane order, the largest grid, the serving stacks), the
engine's refusal of a bank over the CUDA pass's limits, the s8 matmul
probe, the serving step's glue (cheap_upscale_stack, cheap_upscale_planes:
every instance of csrc/upscale.cu against its plain version, the launches of
a step), and filter training's normal-equation kernel (against its float64
plain version, run to run, its refusals, and one train_filterbank on the
card against the CPU), and the C ABI on the card (capi_bridge at each tier
against engine.process; RTPU_Process from a second host thread).

Every test here needs a CUDA card and skips without one. This file imports
no jax, so it also runs where jax is absent; tests/conftest.py imports jax,
so there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu_torch.model.loader import FilterBank, RaisrModel
from raisr_tpu_torch.ops.cuda import filter_kernel as flk
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.cuda import probe_s16 as ps
from raisr_tpu_torch.ops.cuda import upscale as up
from raisr_tpu_torch.ops.epilogue import _finish_pass, processed_col_end
from torch_port_util import (QCOH, QSTR, make_filters, patchwork, require_cuda, smooth,
                             smooth_frames)

pytestmark = pytest.mark.cuda

# The kernels round every step as the plain versions do (nvcc --fmad=false,
# the same order of operations), so the two must agree bit for bit.


def _model(passes=2, seed=0, pixel_types=4) -> RaisrModel:
    rng = np.random.default_rng(seed)
    return RaisrModel(24, 3, 3, 11, tuple(
        FilterBank(filters=make_filters(rng, pixel_types),
                   qstr=np.asarray(QSTR, np.float32),
                   qcoh=np.asarray(QCOH, np.float32), pixel_types=pixel_types,
                   taps=121, source_dtype="fp32")
        for _ in range(passes)
    ))


def _kw(blending, bits=8):
    cfg = RaisrConfig(bits=bits)
    return dict(
        k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
        nf=normalization_factor(bits), qstr=QSTR, qcoh=QCOH,
        min_val=cfg.min_val, max_val=cfg.max_val, blending=blending,
    )


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("h,w", [(270, 481), (37, 64), (46, 62), (16, 16), (40, 9400)])
def test_kernel_matches_plain_version(blending, h, w):
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, seed=h + w), device=dev)
    f = torch.tensor(make_filters(np.random.default_rng(1)), device=dev)
    before = fk.LAUNCHES[("float32", 4)]
    got = fk.raisr_pass_full(img, f, **_kw(blending))
    want = fk.raisr_pass_full_reference(img, f, **_kw(blending))
    torch.cuda.synchronize()
    assert fk.LAUNCHES[("float32", 4)] == before + 1
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


def _zero(counts: dict) -> None:
    counts.update(dict.fromkeys(counts, 0))


def _graph_step(eng, y, u):
    """Warm up on a side stream, capture one step in a CUDA graph, replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eng.process_batch_device(y, u, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = eng.process_batch_device(y, u, u)
    graph.replay()
    torch.cuda.synchronize()
    return out


def test_device_step_and_graph_capture():
    dev = require_cuda()
    model = _model()
    rng = np.random.default_rng(3)
    y = torch.tensor(rng.integers(16, 235, (2, 40, 64)), dtype=torch.uint8, device=dev)
    u = torch.tensor(rng.integers(16, 240, (2, 20, 32)), dtype=torch.uint8, device=dev)
    eng = RaisrEngine(RaisrConfig(passes=2), model, device=dev)
    _zero(fk.LAUNCHES)
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[("float32", 4)] == 2  # one fused pass per pass for the whole batch
    assert oy.device.type == "cuda" and oy.dtype == torch.uint8
    # the same step through the plain version on the CPU
    cpu = RaisrEngine(RaisrConfig(passes=2, backend="pallas"), model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(y.cpu(), u.cpu(), u.cpu())
    assert torch.equal(oy.cpu(), cy), int((oy.cpu() != cy).sum())
    assert torch.equal(ou.cpu(), cu)
    gy, gu, gv = _graph_step(eng, y, u)
    assert torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)


# -- the single-phase (1.5x) form of the kernel ------------------------------


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("h,w", [(405, 720), (37, 64), (16, 16), (40, 9400)])
def test_single_kernel_matches_plain_version(blending, h, w):
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, seed=h + w + 1), device=dev)
    f = torch.tensor(make_filters(np.random.default_rng(4), 1), device=dev)
    before = dict(fk.LAUNCHES)
    got = fk.raisr_pass_full(img, f, pixel_types=1, **_kw(blending))
    want = fk.raisr_pass_full_reference(img, f, pixel_types=1, **_kw(blending))
    torch.cuda.synchronize()
    before[("float32", 1)] += 1
    assert fk.LAUNCHES == before
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert torch.equal(got, want), (int((diff > 0).sum()), float(diff.max()))


def test_single_kernel_stack_equals_per_frame():
    """A stack with the odd 9-row guard of the 1.5x mode-1 path."""
    dev = require_cuda()
    h, w, pad = 60, 200, 9
    f = torch.tensor(make_filters(np.random.default_rng(5), 1), device=dev)
    frames = [smooth(h, w, seed=70 + i) for i in range(3)]
    stack = np.concatenate([np.pad(x, ((pad, pad), (0, 0)), mode="edge") for x in frames])
    tall = fk.raisr_pass_full(torch.tensor(stack, device=dev), f, frame_h=h,
                              frame_pad=pad, pixel_types=1, **_kw(2))
    assert torch.equal(tall, fk.raisr_pass_full_reference(
        torch.tensor(stack, device=dev), f, frame_h=h, frame_pad=pad, pixel_types=1, **_kw(2)))
    period = h + 2 * pad
    for i, x in enumerate(frames):
        single = fk.raisr_pass_full(torch.tensor(x, device=dev), f, pixel_types=1, **_kw(2))
        assert torch.equal(tall[i * period + pad: i * period + pad + h], single), i


@pytest.mark.parametrize("passes,mode", [(1, 1), (2, 2)])
def test_15x_device_step_and_graph_capture(passes, mode):
    dev = require_cuda()
    model = _model(passes=passes, seed=6, pixel_types=1)
    rng = np.random.default_rng(7)
    y = torch.tensor(rng.integers(16, 235, (2, 48, 64)), dtype=torch.uint8, device=dev)
    u = torch.tensor(rng.integers(16, 240, (2, 24, 32)), dtype=torch.uint8, device=dev)
    cfg = dict(ratio=1.5, passes=passes, mode=mode)
    eng = RaisrEngine(RaisrConfig(**cfg), model, device=dev)
    _zero(fk.LAUNCHES)
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    # one single-phase pass per pass for the whole guard-banded stack
    assert fk.LAUNCHES == {k: passes if k == ("float32", 1) else 0 for k in fk.LAUNCHES}
    assert tuple(oy.shape) == (2, 72, 96) and tuple(ou.shape) == (2, 36, 48)
    cpu = RaisrEngine(RaisrConfig(backend="pallas", **cfg), model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(y.cpu(), u.cpu(), u.cpu())
    assert torch.equal(oy.cpu(), cy), int((oy.cpu() != cy).sum())
    assert torch.equal(ou.cpu(), cu)
    gy, gu, gv = _graph_step(eng, y, u)
    assert torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)


# -- the filter apply (apply_filters) and launch A alone (apply_filters_hash) -


@pytest.mark.parametrize("pixel_types", [4, 1])
@pytest.mark.parametrize("h,w", [(270, 481), (37, 64), (16, 16), (40, 9400)])
def test_apply_filters_matches_plain_version(pixel_types, h, w):
    """Real buckets and out-of-range ones (uniform over [-8, 232): raw 0)."""
    dev = require_cuda()
    rng = np.random.default_rng(h + w + pixel_types)
    img = torch.tensor(smooth(h, w, seed=h + w), device=dev)
    f = torch.tensor(make_filters(rng, pixel_types), device=dev)
    kw = dict(pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1)
    for lo, hi in ((0, 216), (-8, 232)):
        b = torch.tensor(rng.integers(lo, hi, (h, w)).astype(np.int32), device=dev)
        before = (flk.LAUNCHES, flk.SINGLE_LAUNCHES)
        got = flk.apply_filters(img, b, f, **kw)
        want = flk.apply_filters_reference(img, b, f, **kw)
        torch.cuda.synchronize()
        four = pixel_types == 4
        assert (flk.LAUNCHES, flk.SINGLE_LAUNCHES) == (before[0] + four, before[1] + (not four))
        assert torch.isfinite(got).all()
        bad = (b < 0) | (b >= 216)
        assert (got[bad] == 0).all()
        diff = (got - want).abs()
        assert torch.equal(got, want), (lo, int((diff > 0).sum()), float(diff.max()))


@pytest.mark.parametrize("h,w", [(270, 481), (37, 64), (16, 16), (40, 9400)])
def test_apply_filters_hash_and_staged_pass(h, w):
    """apply_filters_hash against its plain version; it equals apply_filters
    on the plain hash's buckets, and the epilogue over either equals the
    fused pass, bit for bit."""
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, seed=h + w + 2), device=dev)
    f = torch.tensor(make_filters(np.random.default_rng(8)), device=dev)
    kw = _kw(2)
    hkw = {k: kw[k] for k in ("k1d", "nf", "qstr", "qcoh")}
    before = flk.HASH_LAUNCHES
    raw = flk.apply_filters_hash(img, f, **hkw)
    want = flk.apply_filters_hash_reference(img, f, **hkw)
    torch.cuda.synchronize()
    assert flk.HASH_LAUNCHES == before + 1
    assert torch.equal(raw, want), int(((raw - want).abs() > 0).sum())
    staged = flk.apply_filters(img, flk.hash_buckets_reference(img, **hkw), f)
    assert torch.equal(staged, raw)
    out = _finish_pass(img, staged, min_val=16, max_val=235, blending=2, loop_margin=6,
                       col_end=processed_col_end(w, 6, True))
    assert torch.equal(out, fk.raisr_pass_full(img, f, **kw))


# -- the 8-bit bf16 tier ------------------------------------------------------


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("pixel_types", [4, 1])
@pytest.mark.parametrize("h,w", [(270, 481), (37, 64), (16, 16), (40, 9400)])
def test_bf16_kernel_matches_plain_version(pixel_types, blending, h, w):
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, seed=h + w + 3), device=dev)
    f = fk.round_bf16_error_diffused(
        torch.tensor(make_filters(np.random.default_rng(9), pixel_types), device=dev))
    assert f.dtype == torch.bfloat16
    before = fk.LAUNCHES[("bfloat16", pixel_types)]
    kw = dict(_kw(blending), pixel_types=pixel_types, tier="bfloat16")
    got = fk.raisr_pass_full(img, f, **kw)
    want = fk.raisr_pass_full_reference(img, f, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[("bfloat16", pixel_types)] == before + 1
    diff = (got - want).abs()
    assert torch.equal(got, want), (int((diff > 0).sum()), float(diff.max()))


@pytest.mark.parametrize("ratio,passes,pixel_types", [(2.0, 2, 4), (1.5, 1, 1)])
def test_bf16_device_step_and_graph_capture(ratio, passes, pixel_types):
    """dtype="auto" through process_batch_device: the bf16 kernel, one launch
    per pass for the stack, equal to the plain bf16 passes (the CPU engine),
    eagerly and as a replayed CUDA graph."""
    dev = require_cuda()
    model = _model(passes=passes, seed=10, pixel_types=pixel_types)
    rng = np.random.default_rng(11)
    y = torch.tensor(rng.integers(16, 235, (2, 48, 64)), dtype=torch.uint8, device=dev)
    u = torch.tensor(rng.integers(16, 240, (2, 24, 32)), dtype=torch.uint8, device=dev)
    cfg = dict(ratio=ratio, passes=passes, dtype="auto")
    eng = RaisrEngine(RaisrConfig(**cfg), model, device=dev)
    _zero(fk.LAUNCHES)
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {k: passes if k == ("bfloat16", pixel_types) else 0
                           for k in fk.LAUNCHES}
    cpu = RaisrEngine(RaisrConfig(backend="pallas", **cfg), model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(y.cpu(), u.cpu(), u.cpu())
    assert torch.equal(oy.cpu(), cy), int((oy.cpu() != cy).sum())
    assert torch.equal(ou.cpu(), cu)
    gy, gu, gv = _graph_step(eng, y, u)
    assert torch.equal(gy, oy) and torch.equal(gu, ou) and torch.equal(gv, ov)


# -- a 4-phase bank at 2.5x (ROADMAP C9) --------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "auto"])
def test_25x_route(dtype):
    """2.5x with a 2x bank: the single-phase kernel over the bank's phase-0
    rows, once per frame and pass (the frames are not stacked), equal to the
    plain version (the CPU engine)."""
    dev = require_cuda()
    model = _model(passes=1, seed=12)
    y = torch.tensor(np.random.default_rng(13).integers(16, 235, (2, 40, 56)),
                     dtype=torch.uint8, device=dev)
    cfg = dict(ratio=2.5, passes=1, dtype=dtype)
    eng = RaisrEngine(RaisrConfig(**cfg), model, device=dev)
    _zero(fk.LAUNCHES)
    oy = eng.process_batch_device(y)[0]
    torch.cuda.synchronize()
    tier = "float32" if dtype == "float32" else "bfloat16"
    assert fk.LAUNCHES == {k: 2 if k == (tier, 1) else 0 for k in fk.LAUNCHES}
    assert tuple(oy.shape) == (2, 100, 140)
    cpu = RaisrEngine(RaisrConfig(backend="pallas", **cfg), model, device="cpu")
    assert torch.equal(oy.cpu(), cpu.process_batch_device(y.cpu())[0])


# -- the int8, pcenter and p_split tiers ---------------------------------------


def _tier_bank(tier, pixel_types=4, seed=14):
    """(bank, extras) of a tier, prepared on the card as the engine does."""
    f = torch.tensor(make_filters(np.random.default_rng(seed), pixel_types),
                     device=torch.device("cuda", torch.cuda.current_device()))
    if tier == "int8":
        q, inv_scale = fk.int8_bank(f)
        return q, dict(inv_scale=inv_scale)
    if tier == "float32":
        return f, {}
    f16 = fk.round_bf16_error_diffused(f)
    return f16, (dict(pbias=fk.pcenter_bias(f16)) if tier == "pcenter" else {})


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("tier,bits,pixel_types", [
    ("int8", 8, 4), ("pcenter", 10, 4), ("bfloat16", 10, 4), ("bfloat16", 16, 4),
    ("bfloat16", 16, 1),
])
@pytest.mark.parametrize("h,w", [(270, 481), (37, 64), (16, 16), (40, 9400)])
def test_tier_kernel_matches_plain_version(tier, bits, pixel_types, blending, h, w):
    """The int8 and pcenter kernels, and the bf16 kernel on 10/16-bit planes
    (p_split), against their plain versions, bit for bit."""
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, bits=bits, seed=h + w + 4), device=dev)
    f, extra = _tier_bank(tier, pixel_types)
    before = fk.LAUNCHES[(tier, pixel_types)]
    kw = dict(_kw(blending, bits), pixel_types=pixel_types, tier=tier, **extra)
    got = fk.raisr_pass_full(img, f, **kw)
    want = fk.raisr_pass_full_reference(img, f, **kw)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[(tier, pixel_types)] == before + 1
    assert torch.isfinite(got).all()
    diff = (got - want).abs()
    assert torch.equal(got, want), (int((diff > 0).sum()), float(diff.max()))


@pytest.mark.parametrize("bits,dtype,ratio,passes,tier", [
    (8, "int8", 2.0, 2, "int8"),
    (10, "bfloat16", 2.0, 2, "pcenter"),
    (10, "bfloat16_exact", 2.0, 1, "bfloat16"),
    (16, "bfloat16", 2.0, 1, "bfloat16"),
    (16, "float32", 2.0, 1, "float32"),
    (10, "bfloat16", 1.5, 1, "bfloat16"),
])
def test_tier_device_step_and_graph_capture(bits, dtype, ratio, passes, tier):
    """Each tier through process_batch_device with uint8 or uint16 frames:
    one launch per pass for the stack, counted in the tier's count, equal to
    the plain passes (the CPU engine), eagerly and as a replayed CUDA graph.
    uint16 tensors are compared through their int16 view."""
    dev = require_cuda()
    pt = 4 if ratio == 2.0 else 1
    model = _model(passes=passes, seed=15, pixel_types=pt)
    y_np = smooth_frames(2, 48, 64, bits=bits, seed=16)
    y_np[:, 20, 30] = (1 << bits) - 1
    u_np = smooth_frames(2, 24, 32, bits=bits, seed=18)
    y, u = torch.tensor(y_np, device=dev), torch.tensor(u_np, device=dev)
    cfg = dict(bits=bits, dtype=dtype, ratio=ratio, passes=passes)
    eng = RaisrEngine(RaisrConfig(**cfg), model, device=dev)
    _zero(fk.LAUNCHES)
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {k: passes if k == (tier, pt) else 0 for k in fk.LAUNCHES}

    def bits16(t):
        return t.view(torch.int16) if t.dtype == torch.uint16 else t

    cpu = RaisrEngine(RaisrConfig(backend="pallas", **cfg), model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(torch.from_numpy(y_np), torch.from_numpy(u_np),
                                         torch.from_numpy(u_np))
    assert oy.dtype == cy.dtype == (torch.uint8 if bits == 8 else torch.uint16)
    assert torch.equal(bits16(oy).cpu(), bits16(cy)), int((bits16(oy).cpu() != bits16(cy)).sum())
    assert torch.equal(bits16(ou).cpu(), bits16(cu))
    gy, gu, gv = _graph_step(eng, y, u)
    assert torch.equal(bits16(gy), bits16(oy)) and torch.equal(bits16(gu), bits16(ou))
    assert torch.equal(bits16(gv), bits16(ov))


# -- launch A with the phase's bank resident in shared memory ---------------

# every form of the kernel: (tier, phases, bits of the planes)
FORMS = [("float32", 4, 8), ("float32", 1, 8), ("bfloat16", 4, 8), ("bfloat16", 1, 16),
         ("pcenter", 4, 10), ("int8", 4, 8)]


def _plane(kind, bits):
    """Awkward planes for launch A: a 1x1 and a 7x5 plane, widths 33 and
    4700, a flat plane (every pixel on one bucket, so every bank read is a
    broadcast) and a patchwork whose buckets spread over nearly all 216."""
    top = (1 << bits) - 1
    if kind == "flat":
        return np.full((64, 96), top // 2, np.float32)
    if kind == "spread":
        return patchwork(384, 512, bits=bits, seed=4)
    h, w = {"1x1": (1, 1), "7x5": (7, 5), "w33": (37, 33), "w4700": (19, 4700)}[kind]
    return smooth(h, w, bits=bits, seed=h + w)


@pytest.mark.parametrize("kind", ["1x1", "7x5", "w33", "w4700", "flat", "spread"])
@pytest.mark.parametrize("tier,pixel_types,bits", FORMS)
def test_launch_a_raw_matches_plain_version(tier, pixel_types, bits, kind):
    """Launch A alone (hash, then the gather from the resident bank) against
    the plain hash and filter apply, raw value for raw value, and the whole
    pass against its plain version, bit for bit."""
    dev = require_cuda()
    img = torch.tensor(_plane(kind, bits), device=dev)
    f, extra = _tier_bank(tier, pixel_types)
    kw = _kw(2, bits)
    hkw = {k: kw[k] for k in ("k1d", "nf", "qstr", "qcoh")}
    buckets = flk.hash_buckets_reference(img, **hkw)
    n_buckets = int(torch.unique(buckets).numel())
    if kind == "flat":
        assert n_buckets == 1
    if kind == "spread":
        assert n_buckets >= 200, n_buckets
    raw = torch.empty_like(img)
    flk._launch_hash_filter(img, f, raw, pixel_types, flk._hash_launch_args(
        **hkw, qangle=24, qstrength=3, qcoherence=3), tier, **extra)
    want = flk.apply_filters_reference(img, buckets, f, pixel_types=pixel_types,
                                       ratio=2 if pixel_types == 4 else 1, **extra)
    torch.cuda.synchronize()
    assert torch.equal(raw, want), int((raw != want).sum())
    pkw = dict(kw, pixel_types=pixel_types, tier=tier, **extra)
    got = fk.raisr_pass_full(img, f, **pkw)
    assert torch.equal(got, fk.raisr_pass_full_reference(img, f, **pkw))


@pytest.mark.parametrize("tier,pixel_types,bits", FORMS)
def test_launch_a_stacks_and_stripes(tier, pixel_types, bits):
    """Guard-banded stacks with odd pads (7 and 9 rows) and a row stripe
    (row0, zone_h) at every form, against the plain version, bit for bit."""
    dev = require_cuda()
    f, extra = _tier_bank(tier, pixel_types)
    base = dict(_kw(2, bits), pixel_types=pixel_types, tier=tier, **extra)
    h, w = 41, 75
    for pad in (7, 9):
        frames = [smooth(h, w, bits=bits, seed=80 + pad + i) for i in range(3)]
        stack = torch.tensor(np.concatenate(
            [np.pad(x, ((pad, pad), (0, 0)), mode="edge") for x in frames]), device=dev)
        got = fk.raisr_pass_full(stack, f, frame_h=h, frame_pad=pad, **base)
        want = fk.raisr_pass_full_reference(stack, f, frame_h=h, frame_pad=pad, **base)
        assert torch.equal(got, want), (pad, int((got != want).sum()))
    stripe = torch.tensor(smooth(53, 70, bits=bits, seed=90), device=dev)
    got = fk.raisr_pass_full(stripe, f, row0=17, zone_h=120, **base)
    assert torch.equal(got, fk.raisr_pass_full_reference(stripe, f, row0=17, zone_h=120,
                                                         **base))


# -- launch A2 alone over uint8 buckets (gather_buckets): the lanes' order -------


def _tier_bank_of(tier, pixel_types, n_buckets, seed=15):
    """_tier_bank for a bank of n_buckets buckets."""
    f = torch.tensor(make_filters(np.random.default_rng(seed), pixel_types, n_buckets),
                     device=torch.device("cuda", torch.cuda.current_device()))
    if tier == "int8":
        q, inv_scale = fk.int8_bank(f)
        return q, dict(inv_scale=inv_scale)
    if tier == "float32":
        return f, {}
    f16 = fk.round_bf16_error_diffused(f)
    return f16, (dict(pbias=fk.pcenter_bias(f16)) if tier == "pcenter" else {})


def _stress_buckets(kind, h, w, pixel_types, bits, dev):
    """uint8 bucket planes for A2's lane order: one bucket everywhere (every
    load a broadcast); every slot in one class mod 8, pixel 1 of a thread
    on one slot (so the sort keeps the columns' order) and the others on 8
    distinct slots a quarter-warp, whose loads then take 8 wavefronts each;
    uniform random over the bank; a smooth plane's own hash."""
    step = 2 if pixel_types == 4 else 1
    i = torch.arange(h, device=dev)[:, None] // step
    j = torch.arange(w, device=dev)[None, :] // step
    if kind == "one":
        return torch.full((h, w), 121, dtype=torch.uint8, device=dev)
    if kind == "one_class":
        inv = torch.argsort(flk.bank_slots(24, 3, 3)).to(dev)
        return inv[torch.where(i % 4 == 1, 3, 8 * (j % 8 + 8 * (i % 3)) + 3)].to(torch.uint8)
    if kind == "random":
        gen = torch.Generator(device=dev).manual_seed(h * w)
        return torch.randint(0, 216, (h, w), generator=gen, device=dev, dtype=torch.uint8)
    img = torch.tensor(smooth(h, w, bits=bits, seed=h + w), device=dev)
    kw = _kw(2, bits)
    return flk.hash_buckets_reference(img, **{k: kw[k] for k in ("k1d", "nf", "qstr", "qcoh")}
                                      ).to(torch.uint8)


@pytest.mark.parametrize("h,w", [(75, 203), (130, 4700)])
@pytest.mark.parametrize("kind", ["one", "one_class", "random", "hashed"])
@pytest.mark.parametrize("tier,pixel_types,bits", FORMS)
def test_gather_buckets_lane_order(tier, pixel_types, bits, kind, h, w):
    """A2 over uint8 planes that stress its lane order, on sides that are no
    multiple of its 32 x 32 tiles, at every form, against the plain filter
    apply: max abs error 0."""
    dev = require_cuda()
    img = torch.tensor(smooth(h, w, bits=bits, seed=h + w + 1), device=dev)
    f, extra = _tier_bank(tier, pixel_types)
    b = _stress_buckets(kind, h, w, pixel_types, bits, dev)
    if kind == "one_class":  # the counter sees the conflicts the plane was built for
        # (6.25 on whole tiles; ragged tiles' idle lanes read one row)
        assert flk.gather_wavefronts(b, pixel_types, flk.bank_slots(24, 3, 3))[0] > 3
    got = flk.gather_buckets(img, b, f, pixel_types=pixel_types, tier=tier, **extra)
    want = flk.apply_filters_reference(img, b.to(torch.int32), f, pixel_types=pixel_types,
                                       ratio=2 if pixel_types == 4 else 1, **extra)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("tier,pixel_types,bits", FORMS)
def test_gather_buckets_largest_grid(tier, pixel_types, bits):
    """The largest grid A1 hands on, 256 buckets (16 x 4 x 4), random over
    it, at every form: the slot table and its bank fit and agree."""
    dev = require_cuda()
    h, w = 97, 330
    img = torch.tensor(smooth(h, w, bits=bits, seed=7), device=dev)
    f, extra = _tier_bank_of(tier, pixel_types, 256)
    gen = torch.Generator(device=dev).manual_seed(3)
    b = torch.randint(0, 256, (h, w), generator=gen, device=dev).to(torch.uint8)
    got = flk.gather_buckets(img, b, f, pixel_types=pixel_types, qangle=16, qstrength=4,
                             qcoherence=4, tier=tier, **extra)
    want = flk.apply_filters_reference(img, b.to(torch.int32), f, pixel_types=pixel_types,
                                       ratio=2 if pixel_types == 4 else 1, **extra)
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("pixel_types", [4, 1])
def test_apply_filters_largest_bank(pixel_types):
    """The largest bank check_gather_smem admits (294 buckets at 4 phases,
    411 at 1), caller buckets over it and outside it, against the plain
    version: max abs error 0."""
    dev = require_cuda()
    n = 294 if pixel_types == 4 else 411
    flk.check_gather_smem(n, pixel_types)
    with pytest.raises(ValueError):
        flk.check_gather_smem(n + 1, pixel_types)
    rng = np.random.default_rng(n)
    h, w = 133, 517
    img = torch.tensor(smooth(h, w, seed=n), device=dev)
    f = torch.tensor(make_filters(rng, pixel_types, n), device=dev)
    b = torch.tensor(rng.integers(-4, n + 4, (h, w)).astype(np.int32), device=dev)
    kw = dict(pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1)
    got = flk.apply_filters(img, b, f, **kw)
    bad = (b < 0) | (b >= n)
    assert bad.any() and (got[bad] == 0).all()
    assert torch.equal(got, flk.apply_filters_reference(img, b, f, **kw))


def test_gather_buckets_serving_stacks():
    """A2 alone on the serving stacks' own buckets (2x 8736 x 3840 and 1.5x
    6552 x 2880, four seeded 1080p frames), float32 and bf16: max abs error
    0, and it equals launch A's raw."""
    dev = require_cuda()
    kw = _kw(2)
    hkw = {k: kw[k] for k in ("k1d", "nf", "qstr", "qcoh")}
    for ratio, pixel_types in ((2, 4), (1.5, 1)):
        stack = _serving_stack(ratio, dev)
        b = flk.hash_buckets(stack, **hkw)
        for tier in ("float32", "bfloat16"):
            f, extra = _tier_bank(tier, pixel_types)
            got = flk.gather_buckets(stack, b, f, pixel_types=pixel_types, tier=tier)
            want = flk.apply_filters_reference(stack, b.to(torch.int32), f,
                                               pixel_types=pixel_types,
                                               ratio=2 if pixel_types == 4 else 1)
            raw = torch.empty_like(stack)
            flk._launch_hash_filter(stack, f, raw, pixel_types, flk._hash_launch_args(
                **hkw, qangle=24, qstrength=3, qcoherence=3), tier)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (ratio, tier, int((got != want).sum()))
            assert torch.equal(raw, got), (ratio, tier)


# -- launch A1 alone (hash_buckets) -----------------------------------------------


def _serving_stack(ratio, dev, n=4, lr_h=1080, lr_w=1920, seed=60):
    """Pass 1's input on a serving path: n smooth 8-bit frames as the 2x path
    stacks them (LR guard rows 6, upscaled: 8736 x 3840 at 1080p) or the
    1.5x path (6552 x 2880)."""
    from raisr_tpu_torch.ops.resize import cheap_upscale, cheap_upscale_stacked

    frames = torch.tensor(smooth_frames(n, lr_h, lr_w, seed=seed), device=dev)
    lr = up.guard_band_stack(frames.to(torch.float32), 6)
    if ratio == 2:
        return cheap_upscale(lr, 2 * (lr_h + 12) * n, 2 * lr_w, 8)
    out_h, out_w = RaisrConfig(ratio=1.5).output_size(lr_h, lr_w)
    return cheap_upscale_stacked(lr, n, lr_h, 6, out_h, 6 * out_h // lr_h, out_w, 8)


def _a1_plane(kind, dev):
    """Planes for A1 alone: smaller than one tile (16x16, 22x34); sides that
    are no multiple of 4 or of the 32x54 tile, with and without interior
    tiles, on the word-by-word copies (w % 4 != 0) and the 16-byte ones; a
    plane whose rows start 4 bytes off 16 (word-by-word, w % 4 == 0); 4700
    wide; the 2x and 1.5x serving stacks; a row stripe of a plane; the flat
    and patchwork planes of launch A's tests at 8 and 16 bits."""
    sizes = {"16x16": (16, 16), "22x34": (22, 34), "37x63": (37, 63), "70x130": (70, 130),
             "101x244": (101, 244), "75x4700": (75, 4700)}
    if kind in sizes:
        h, w = sizes[kind]
        return torch.tensor(smooth(h, w, seed=h + w), device=dev)
    if kind == "misaligned":
        flat = torch.zeros(1 + 90 * 172, device=dev)
        img = flat[1:].view(90, 172)
        img.copy_(torch.tensor(smooth(90, 172, seed=3), device=dev))
        assert img.data_ptr() % 16 == 4
        return img
    if kind == "stripe":  # rows 37..136 of a 1080p-wide plane, as a row stripe takes them
        return torch.tensor(smooth(300, 1920, seed=8), device=dev)[37:137]
    if kind in ("stack2x", "stack15x"):
        return _serving_stack(2 if kind == "stack2x" else 1.5, dev)
    bits = 16 if kind.endswith("16") else 8
    return torch.tensor(_plane(kind.removesuffix("16"), bits), device=dev)


@pytest.mark.parametrize("kind", ["16x16", "22x34", "37x63", "70x130", "101x244", "75x4700",
                                  "misaligned", "stripe", "stack2x", "stack15x", "flat",
                                  "spread", "spread16"])
def test_hash_buckets_equal_plain_hash(kind):
    """A1 alone: the uint8 bucket plane equals the plain hash byte for
    byte."""
    dev = require_cuda()
    img = _a1_plane(kind, dev)
    hkw = {k: v for k, v in _kw(2, 16 if kind == "spread16" else 8).items()
           if k in ("k1d", "nf", "qstr", "qcoh")}
    got = flk.hash_buckets(img, **hkw)
    want = flk.hash_buckets_reference(img, **hkw).to(torch.uint8)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("qangle,qstr,qcoh", [
    (8, (0.0008, 0.004, 0.012, 0.03), (0.15, 0.3, 0.55)),  # 4 and 3 edges: the general count
    (16, (0.01,), (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)),  # 1 and 7
    (12, (), ()),  # one strength and one coherence bin
    (24, (0.001269,), (0.192916, 0.405942)),  # 1 and 2: the two-edge count, padded
])
def test_hash_buckets_bucket_grids(qangle, qstr, qcoh):
    """Bucket grids other than 24 x 3 x 3: the general edge count (up to 8
    a kind) and the two-edge count with fewer edges, byte for byte against
    the plain hash on a patchwork plane."""
    dev = require_cuda()
    img = torch.tensor(patchwork(96, 172, seed=7), device=dev)
    kw = _kw(2)
    hkw = dict(k1d=kw["k1d"], nf=kw["nf"], qstr=qstr, qcoh=qcoh, qangle=qangle,
               qstrength=len(qstr) + 1, qcoherence=len(qcoh) + 1)
    got = flk.hash_buckets(img, **hkw)
    want = flk.hash_buckets_reference(img, **hkw).to(torch.uint8)
    assert torch.equal(got, want), int((got != want).sum())
    assert int(torch.unique(want).numel()) > 1


@pytest.mark.parametrize("kind", ["70x130", "101x244", "spread"])
def test_hash_buckets_non_symmetric_taps(kind):
    """A k1d whose taps are not symmetric bit for bit (tap 0 one ulp up) takes
    the general form, and still equals the plain hash byte for byte; so does
    the fused pass that runs it."""
    dev = require_cuda()
    img = _a1_plane(kind, dev)
    kw = _kw(2)
    k1d = list(kw["k1d"])
    k1d[0] = float(np.nextafter(np.float32(k1d[0]), np.float32(1)))
    hkw = dict(k1d=tuple(k1d), nf=kw["nf"], qstr=kw["qstr"], qcoh=kw["qcoh"])
    got = flk.hash_buckets(img, **hkw)
    want = flk.hash_buckets_reference(img, **hkw).to(torch.uint8)
    assert torch.equal(got, want), int((got != want).sum())
    f = torch.tensor(_model().banks[0].filters, device=dev)
    pkw = dict(kw, k1d=tuple(k1d))
    assert torch.equal(fk.raisr_pass_full(img, f, **pkw),
                       fk.raisr_pass_full_reference(img, f, **pkw))


# -- launch B alone (pass_epilogue) ---------------------------------------------


def _epilogue_inputs(h, w, bits, seed, dev, misalign=False):
    """An integer-valued cheap plane over the depth's full range and a raw
    plane around it, some of it outside [min_val, max_val] and some exactly on
    the bounds (the reject is exclusive); `misalign` puts both 4 bytes off a
    16-byte boundary."""
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    cfg = RaisrConfig(bits=bits)
    cheap = np.round(rng.uniform(0, top, (h, w))).astype(np.float32)
    raw = (cheap + rng.normal(0, top / 40, (h, w))).astype(np.float32)
    edge = rng.random((h, w))
    raw[edge < 0.02] = cfg.min_val
    raw[edge > 0.98] = cfg.max_val

    def put(a):
        if not misalign:
            return torch.tensor(a, device=dev)
        t = torch.empty(a.size + 1, dtype=torch.float32, device=dev)[1:].view(a.shape)
        t.copy_(torch.from_numpy(a))
        assert t.data_ptr() % 16 == 4 and t.is_contiguous()
        return t

    return put(cheap), put(raw), dict(min_val=cfg.min_val, max_val=cfg.max_val)


def _hold_epilogue(cheap, raw, **kw):
    before = fk.EPILOGUE_LAUNCHES
    got = fk.pass_epilogue(cheap, raw, **kw)
    torch.cuda.synchronize()
    assert fk.EPILOGUE_LAUNCHES == before + 1
    w = cheap.shape[1]
    want = _finish_pass(cheap, raw, min_val=kw["min_val"], max_val=kw["max_val"],
                        blending=kw["blending"], loop_margin=6,
                        col_end=processed_col_end(w, 6, True),
                        **{k: kw[k] for k in ("frame_h", "frame_pad", "row0", "zone_h")
                           if k in kw})
    diff = (got - want).abs()
    assert torch.equal(got, want), (int((diff > 0).sum()), float(diff.max()))


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("bits", [8, 10, 16])
@pytest.mark.parametrize("h,w", [(270, 480), (37, 63), (5, 64), (40, 1), (1, 300), (66, 132),
                                 (19, 4700), (128, 128), (129, 129)])
def test_epilogue_matches_plain_version(h, w, bits, blending):
    """Launch B against _finish_pass, bit for bit: widths that are and are
    not multiples of 4 (16-byte and 4-byte accesses), a height below a
    warp's 16 rows, a 1-column and a 1-row plane, and a plane that fills one
    block's 128 x 128 and one a row and a column over it."""
    dev = require_cuda()
    cheap, raw, kw = _epilogue_inputs(h, w, bits, h + w + bits, dev)
    _hold_epilogue(cheap, raw, blending=blending, **kw)


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("w", [76, 75])
def test_epilogue_stacks_stripes_and_alignment(blending, w):
    """Frame stacks with even and odd guard bands (a period that is no
    multiple of a warp's rows), row stripes with a positive and a negative
    row0, and planes 4 bytes off a 16-byte boundary, against _finish_pass."""
    dev = require_cuda()
    h = 41
    for pad in (12, 7, 9):
        cheap, raw, kw = _epilogue_inputs(3 * (h + 2 * pad), w, 8, pad + w, dev)
        _hold_epilogue(cheap, raw, blending=blending, frame_h=h, frame_pad=pad, **kw)
    for row0, zone_h in ((17, 120), (-3, 60), (-9, 40), (90, 100)):
        cheap, raw, kw = _epilogue_inputs(53, w, 10, 100 + row0 + w, dev)
        _hold_epilogue(cheap, raw, blending=blending, row0=row0, zone_h=zone_h, **kw)
    cheap, raw, kw = _epilogue_inputs(70, w, 8, 7 + w, dev, misalign=True)
    _hold_epilogue(cheap, raw, blending=blending, **kw)


@pytest.mark.parametrize("bits,dtype", [(8, torch.uint8), (10, torch.uint16),
                                        (16, torch.uint16)])
@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("w", [76, 75])
@pytest.mark.parametrize("pixel_types", [4, 1])
def test_packed_epilogue_equals_float_and_pack(pixel_types, w, blending, bits, dtype):
    """Launch B's packed store, the last pass of a batched step, against its
    float32 store and pack_planes, bit for bit: uint8 at 8 bits, uint16 at
    10 and 16; both blendings; 4-pixel and one-by-one accesses (a width
    that is no multiple of 4); a 4-frame stack with an odd guard band,
    through the 4-phase (2x) and the single-phase (1.5x) fused pass, whose
    output holds no guard row; then launch B alone (pass_epilogue)."""
    dev = require_cuda()
    frame_h, pad = 41, 7
    period = frame_h + 2 * pad
    stack = np.concatenate([np.pad(smooth(frame_h, w, bits=bits, seed=30 + i), ((pad, pad), (0, 0)),
                                   mode="edge") for i in range(4)])
    stack = torch.tensor(stack, device=dev)
    f = torch.tensor(make_filters(np.random.default_rng(4), pixel_types), device=dev)
    fused = fk.FusedPass(f, pixel_types=pixel_types, **_kw(blending, bits))
    zone = dict(frame_h=frame_h, frame_pad=pad)
    before, packed = fk.EPILOGUE_LAUNCHES, fk.PACKED_EPILOGUE_LAUNCHES
    full = fused(stack, **zone)
    got = fused(stack, **zone, out_dtype=dtype)
    torch.cuda.synchronize()
    assert (fk.EPILOGUE_LAUNCHES, fk.PACKED_EPILOGUE_LAUNCHES) == (before + 2, packed + 1)
    frames = full.reshape(4, period, w)[:, pad: pad + frame_h].reshape(4 * frame_h, w)
    assert got.dtype == dtype and got.shape == (4 * frame_h, w)
    assert torch.equal(got, up.pack_planes(frames, dtype)), int((got != up.pack_planes(
        frames, dtype)).sum())
    cheap, raw, kw = _epilogue_inputs(4 * period, w, bits, w + bits, dev)
    alone = fk.pass_epilogue(cheap, raw, blending=blending, **kw, **zone, out_dtype=dtype)
    plane = fk.pass_epilogue(cheap, raw, blending=blending, **kw, **zone)
    torch.cuda.synchronize()
    assert fk.PACKED_EPILOGUE_LAUNCHES == packed + 2
    want = up.pack_planes(plane.reshape(4, period, w)[:, pad: pad + frame_h].reshape(-1, w),
                          dtype)
    assert torch.equal(alone, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ratio,passes,pixel_types", [(2.0, 2, 4), (1.5, 1, 1)])
def test_device_step_packs_y_in_launch_b(monkeypatch, dtype, ratio, passes, pixel_types):
    """The batched step on the card: its last pass's launch B writes the
    packed Y frames, one packed launch a step and no pack_planes (made to
    raise), equal to the float32 route (process_batch_y, then pack_planes)
    and to the CPU engine; engine.process counts no packed launch."""
    from raisr_tpu_torch import engine as eng_mod
    from raisr_tpu_torch.engine import Frame
    from raisr_tpu_torch.ops import pipeline

    dev = require_cuda()
    model = _model(passes=passes, seed=9, pixel_types=pixel_types)
    y = torch.tensor(smooth_frames(4, 40, 64, seed=12), device=dev)
    u = torch.tensor(smooth_frames(4, 20, 32, seed=13), device=dev)
    eng = RaisrEngine(RaisrConfig(ratio=ratio, passes=passes, dtype=dtype), model, device=dev)
    want = up.pack_planes(eng.process_batch_y(y), torch.uint8)

    def refused(*args, **kw):
        raise AssertionError("the batched step packed Y with pack_planes")

    monkeypatch.setattr(eng_mod, "pack_planes", refused)
    monkeypatch.setattr(pipeline, "pack_planes", refused)
    before = fk.PACKED_EPILOGUE_LAUNCHES
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    assert fk.PACKED_EPILOGUE_LAUNCHES == before + 1
    monkeypatch.undo()
    assert oy.dtype == torch.uint8 and oy.shape == (4, *eng.cfg.output_size(40, 64))
    assert torch.equal(oy, want), int((oy != want).sum())
    cpu = RaisrEngine(RaisrConfig(ratio=ratio, passes=passes, dtype=dtype, backend="pallas"),
                      model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(y.cpu(), u.cpu(), u.cpu())
    assert torch.equal(oy.cpu(), cy) and torch.equal(ou.cpu(), cu)
    before = fk.PACKED_EPILOGUE_LAUNCHES
    one = eng.process(Frame(y=y[0].cpu().numpy(), u=u[0].cpu().numpy(), v=u[0].cpu().numpy()))
    assert fk.PACKED_EPILOGUE_LAUNCHES == before
    assert np.array_equal(one.y, cy[0].numpy())


# -- apply_filters on the resident bank: bank sizes and the refusal ---------------


@pytest.mark.parametrize("pixel_types", [4, 1])
@pytest.mark.parametrize("n_buckets", [1, 216, 256])
def test_apply_filters_bank_sizes(n_buckets, pixel_types):
    """Banks of 1, 216 and 256 buckets, with buckets in and out of range
    (raw 0 there), against the plain version, bit for bit."""
    dev = require_cuda()
    rng = np.random.default_rng(n_buckets + pixel_types)
    h, w = 75, 203
    img = torch.tensor(smooth(h, w, seed=n_buckets), device=dev)
    f = torch.tensor(make_filters(rng, pixel_types, n_buckets), device=dev)
    b = torch.tensor(rng.integers(-3, n_buckets + 3, (h, w)).astype(np.int32), device=dev)
    b[0, 0], b[0, 1] = -2**31, 2**31 - 1
    kw = dict(pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1)
    got = flk.apply_filters(img, b, f, **kw)
    torch.cuda.synchronize()
    bad = (b < 0) | (b >= n_buckets)
    assert bad.any() and (got[bad] == 0).all() and (got[~bad] != 0).any()
    assert torch.equal(got, flk.apply_filters_reference(img, b, f, **kw))


@pytest.mark.parametrize("pixel_types,n_buckets", [(4, 295), (1, 412)])
def test_apply_filters_refuses_a_bank_over_shared_memory(pixel_types, n_buckets):
    """One bucket over what fits beside the tile buffers: a ValueError that
    names the byte counts, and no launch; one fewer runs."""
    dev = require_cuda()
    rng = np.random.default_rng(n_buckets)
    img = torch.tensor(smooth(20, 40, seed=1), device=dev)
    b = torch.zeros((20, 40), dtype=torch.int32, device=dev)
    kw = dict(pixel_types=pixel_types, ratio=2 if pixel_types == 4 else 1)
    f = torch.tensor(make_filters(rng, pixel_types, n_buckets), device=dev)
    before = (flk.LAUNCHES, flk.SINGLE_LAUNCHES)
    with pytest.raises(ValueError, match=f"{flk.gather_smem_bytes(n_buckets, pixel_types)} bytes"):
        flk.apply_filters(img, b, f, **kw)
    assert (flk.LAUNCHES, flk.SINGLE_LAUNCHES) == before
    fits = f[:-pixel_types].contiguous()
    b[:] = n_buckets - 2
    got = flk.apply_filters(img, b, fits, **kw)
    assert torch.equal(got, flk.apply_filters_reference(img, b, fits, **kw))


def test_engine_refuses_a_bank_over_the_cuda_limits():
    """300 buckets, or 9 strength edges: refused when the engine is built on
    the card with the fused backend, served by the taps backend."""
    from raisr_tpu_torch.config import RaisrError

    dev = require_cuda()
    rng = np.random.default_rng(20)
    for qa, qs, qc in ((25, 4, 3), (2, 10, 3)):
        bank = FilterBank(filters=make_filters(rng, 4, qa * qs * qc),
                          qstr=np.linspace(0.001, 0.02, qs - 1).astype(np.float32),
                          qcoh=np.linspace(0.2, 0.4, qc - 1).astype(np.float32),
                          pixel_types=4, taps=121, source_dtype="fp32")
        model = RaisrModel(qa, qs, qc, 11, (bank,))
        with pytest.raises(RaisrError, match="at most (256 buckets|8 strength)"):
            RaisrEngine(RaisrConfig(passes=1), model, device=dev)
        eng = RaisrEngine(RaisrConfig(passes=1, backend="reference"), model, device=dev)
        y = torch.tensor(smooth(24, 32, seed=3), device=dev)
        assert tuple(eng.upscale_y(y).shape) == (48, 64)


# -- the s8 matmul probe --------------------------------------------------------

SIZES = (1, 17, 33, 144, 145)


@pytest.mark.parametrize("m,k,n", [(ps.M, ps.K, ps.N), (17, 5, 33), (1, 300, 2),
                                   (145, 320, 144)] + [
    (m, k, n) for m in SIZES for k in SIZES for n in SIZES])
def test_s8_matmul_matches_plain_version_and_int_mm(m, k, n):
    """The tensor-core tile against the int64 product, exactly, and against
    torch._int_mm where it takes the shape (m > 16; k and n at least 16 and
    multiples of 8). k = 300 (byte staging) and k = 320 (16-byte staging)
    run the loop over two K chunks of 160."""
    dev = require_cuda()
    rng = np.random.default_rng(m + k + n)
    a = torch.tensor(rng.integers(-128, 128, (m, k)).astype(np.int8), device=dev)
    b = torch.tensor(rng.integers(-128, 128, (k, n)).astype(np.int8), device=dev)
    a[0] = -128
    b[:, 0] = -128
    before = ps.LAUNCHES
    got = ps.s8_matmul(a, b)
    torch.cuda.synchronize()
    assert ps.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ps.s8_matmul_reference(a, b))
    assert int(got[0, 0]) == 128 * 128 * k
    if m > 16 and min(k, n) >= 16 and k % 8 == 0 and n % 8 == 0:
        assert torch.equal(got, torch._int_mm(a, b))


# -- the serving path: the stream, the CLI, the resize modes, the conv backend --


def _host_frames(n, h, w, seed, bits=8):
    from raisr_tpu_torch.engine import Frame

    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits == 8 else np.uint16
    ys = smooth_frames(n, h, w, bits, seed)
    lo, hi = (16, 240) if bits == 8 else (64, 960)
    return [Frame(y=ys[i], u=rng.integers(lo, hi, (h // 2, w // 2)).astype(dt),
                  v=rng.integers(lo, hi, (h // 2, w // 2)).astype(dt)) for i in range(n)]


def _frames_same(a, b):
    return (a.y.dtype == b.y.dtype and np.array_equal(a.y, b.y)
            and np.array_equal(a.u, b.u) and np.array_equal(a.v, b.v))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("batch,n", [(1, 5), (4, 10), (4, 3), (2, 24)])
def test_stream_on_the_card_equals_engine_process(depth, batch, n):
    """Pinned staging, non-blocking copies on side streams and one event a
    dispatch: every streamed frame of a clip of distinct
    frames (with a tail) equals engine.process of it, bit for bit, and the
    fused pass is launched twice a group."""
    from raisr_tpu_torch.stream import StreamProcessor

    dev = require_cuda()
    eng = RaisrEngine(RaisrConfig(passes=2), _model(seed=21), device=dev)
    frames = _host_frames(n, 72, 96, 30 + n)
    want = [eng.process(f) for f in frames]
    torch.cuda.synchronize()
    _zero(fk.LAUNCHES)
    got = list(StreamProcessor(eng, depth=depth, batch=batch).process(iter(frames)))
    assert fk.LAUNCHES[("float32", 4)] == 2 * -(-n // batch) == sum(fk.LAUNCHES.values())
    assert len(got) == n
    assert all(_frames_same(a, b) for a, b in zip(got, want))


def test_stream_on_the_card_uint16_and_mono():
    from raisr_tpu_torch.engine import Frame
    from raisr_tpu_torch.stream import StreamProcessor

    dev = require_cuda()
    eng = RaisrEngine(RaisrConfig(passes=2, bits=10), _model(seed=22), device=dev)
    frames = _host_frames(5, 48, 64, 40, bits=10)
    got = list(StreamProcessor(eng, depth=2, batch=2).process(iter(frames)))
    assert all(_frames_same(a, eng.process(f)) for a, f in zip(got, frames))
    assert got[0].y.dtype == np.uint16
    mono = [Frame(y=f.y) for f in frames]
    got = list(StreamProcessor(eng, depth=2, batch=2).process(iter(mono)))
    assert all(g.u is None and np.array_equal(g.y, eng.process(f).y)
               for g, f in zip(got, mono))


def test_cli_upscale_defaults_to_the_card(tmp_path):
    """`raisr-torch upscale` with no --device runs the fused kernels."""
    from raisr_tpu_torch import video
    from raisr_tpu_torch.cli import main as cli_main
    from torch_port_util import write_bank_and_clip

    require_cuda()
    folder, clip, frames = write_bank_and_clip(tmp_path, n_frames=5, h=48, w=64, seed=23)
    dst = tmp_path / "out.y4m"
    _zero(fk.LAUNCHES)
    assert cli_main(["upscale", "-i", clip, "-o", str(dst), "--filterfolder", folder,
                     "--passes", "2", "--batch", "2"]) == 0
    assert fk.LAUNCHES[("float32", 4)] == 2 * 3
    rd = video.Y4MReader(str(dst))
    got = list(rd)
    assert (rd.fmt.width, rd.fmt.height, len(got)) == (128, 96, 5)
    cpu = tmp_path / "cpu.y4m"
    assert cli_main(["upscale", "-i", clip, "-o", str(cpu), "--filterfolder", folder,
                     "--passes", "2", "--backend", "pallas", "--device", "cpu"]) == 0
    # the kernel equals its plain version, so the card's file equals the CPU's
    assert dst.read_bytes() == cpu.read_bytes()


@pytest.mark.parametrize("mode", ["cubic", "lanczos"])
@pytest.mark.parametrize("h,w,oh,ow", [(90, 160, 180, 320), (90, 160, 135, 240),
                                       (45, 77, 89, 153)])
def test_resize_modes_card_equals_cpu(mode, h, w, oh, ow):
    from raisr_tpu_torch.ops.resize import cheap_upscale

    dev = require_cuda()
    x = torch.tensor(smooth_frames(2, h, w, 8, seed=h)).to(torch.float32)
    got = cheap_upscale(x.to(dev), oh, ow, 8, mode=mode)
    assert torch.equal(got.cpu(), cheap_upscale(x, oh, ow, 8, mode=mode))


def test_cubic_engine_on_the_card_equals_plain_passes():
    from raisr_tpu_torch.ops.resize import cheap_upscale

    dev = require_cuda()
    model = _model(seed=24)
    eng = RaisrEngine(RaisrConfig(passes=2, resize_mode="cubic"), model, device=dev)
    y = torch.tensor(smooth_frames(2, 60, 80, 8, seed=5), device=dev)
    oy = eng.process_batch_device(y)[0]
    for i in range(2):
        x = cheap_upscale(y[i].to(torch.float32), 120, 160, 8, mode="cubic")
        for b in model.banks:
            x = fk.raisr_pass_full_reference(x, torch.tensor(b.filters, device=dev), **_kw(2))
        assert torch.equal(oy[i].to(torch.float32), x), i


def test_conv_backend_turns_tf32_off_for_its_call_only():
    """With TF32 left on globally the xla backend still meets the bar against
    taps (the context around the conv works), and the flag is handed back."""
    dev = require_cuda()
    model = _model(passes=1, seed=25)
    y = torch.tensor(smooth_frames(1, 120, 160, 8, seed=6), device=dev)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = RaisrEngine(RaisrConfig(backend="xla"), model, device=dev) \
            .process_batch_device(y)[0]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    taps = RaisrEngine(RaisrConfig(backend="reference"), model, device=dev) \
        .process_batch_device(y)[0]
    d = (conv.to(torch.int32) - taps.to(torch.int32)).abs()
    assert float((d > 0).float().mean()) < 0.02 and float(d.median()) == 0.0


def test_stream_on_the_card_abandoned_then_reused():
    """A caller that stops early leaves dispatches in flight; the processor
    waits for them before their memory goes back, and serves the next clip
    bit for bit."""
    from raisr_tpu_torch.stream import StreamProcessor

    dev = require_cuda()
    eng = RaisrEngine(RaisrConfig(passes=2), _model(seed=26), device=dev)
    frames = _host_frames(12, 72, 96, 50)
    sp = StreamProcessor(eng, depth=4, batch=2)
    gen = sp.process(iter(frames))
    first = next(gen)
    gen.close()
    assert _frames_same(first, eng.process(frames[0]))
    other = _host_frames(12, 72, 96, 51)
    got = list(sp.process(iter(other)))
    assert all(_frames_same(a, eng.process(f)) for a, f in zip(got, other))


# -- filter training: the normal-equation kernel (ops/cuda/normal_eq.py) ----


def _training_pair(dev, ratio=2.0, h=256, w=320, seed=30):
    """A (cheap, hr) pair on the card from smooth HR content with fine noise,
    LR by the CLI's degradation, and the filter index of its core."""
    from raisr_tpu_torch.ops.resize import cheap_upscale
    from raisr_tpu_torch.train import trainer as tr

    rng = np.random.default_rng(seed)
    hr = np.clip(smooth(h, w, seed=seed) + rng.integers(-2, 3, (h, w)), 0, 255)
    lr, hr = tr.degrade(hr, ratio, 8)
    hr_t = torch.tensor(hr.astype(np.float32), device=dev)
    cheap = cheap_upscale(torch.tensor(lr.astype(np.float32), device=dev), *hr.shape, 8)
    cfg = tr.TrainConfig(ratio=ratio)
    return cfg, cheap, hr_t, tr._filter_index(cheap, cfg)[1]


def _weighted(cheap, hr_t, weighted):
    from raisr_tpu_torch.ops import census

    if not weighted:
        return hr_t, None
    s = census.randomness_weight(cheap).contiguous()
    return (hr_t - (1.0 - s) * cheap).contiguous(), s


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ratio", [2.0, 1.5])
def test_normal_eq_matches_plain_version(ratio, weighted):
    """The kernel against its plain version accumulated in float64: within
    1e-5 of each filter's largest entry (float32 sums in another order;
    1080p pairs read ~3e-7), Q exactly symmetric, one launch counted."""
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    cfg, cheap, hr_t, idx = _training_pair(dev, ratio)
    label, s = _weighted(cheap, hr_t, weighted)
    q, v = tr.init_accumulators(cfg, dev)
    q += 1.0  # accumulates into what is there
    before = ne.LAUNCHES
    ne.accumulate_normal_eq(q, v, cheap, label, idx, s)
    q64 = torch.ones(q.shape, dtype=torch.float64, device=dev)
    v64 = torch.zeros(v.shape, dtype=torch.float64, device=dev)
    ne.normal_eq_reference(q64, v64, cheap, label, idx, s)
    torch.cuda.synchronize()
    assert ne.LAUNCHES == before + 1
    assert torch.equal(q, q.transpose(1, 2))
    for got, want, dims in ((q, q64, (1, 2)), (v, v64, (1,))):
        err = (got.double() - want).abs().amax(dim=dims)
        assert bool((err <= 1e-5 * want.abs().amax(dim=dims)).all()), float(err.max())


@pytest.mark.parametrize("ratio", [2.0, 1.5])
def test_normal_eq_counts_every_pixel_once(ratio):
    """On a plane of ones every entry of Q[f] is f's pixel count and V[f]
    the sum of the label over f's pixels: exact, so a pixel dropped or taken
    twice at a run's or a stage's edge shows."""
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    cfg, cheap, _, idx = _training_pair(dev, ratio, seed=35)
    h, w = cheap.shape
    label = (torch.arange(h * w, device=dev) % 7).reshape(h, w).to(torch.float32)
    q, v = tr.init_accumulators(cfg, dev)
    ne.accumulate_normal_eq(q, v, torch.ones_like(cheap), label, idx)
    flat = idx.reshape(-1).long()
    count = torch.bincount(flat, minlength=cfg.num_filters).float()
    core = label[ne.CORE: h - ne.CORE, ne.CORE: w - ne.CORE].reshape(-1)
    lsum = torch.zeros(cfg.num_filters, device=dev).index_add_(0, flat, core)
    assert torch.equal(q, count[:, None, None].expand_as(q))
    assert torch.equal(v, lsum[:, None].expand_as(v))


def test_solve_filters_unaffected_by_tf32():
    """The batched LU solve of solve_filters gives the same bank bit for bit
    with the TF32 matmul flag on and off, so it needs no TF32 guard."""
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    cfg, cheap, hr_t, idx = _training_pair(dev, seed=36)
    q, v = tr.init_accumulators(cfg, dev)
    ne.accumulate_normal_eq(q, v, cheap, hr_t, idx)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        banks = []
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            banks.append(tr.solve_filters(q, v, cfg))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert torch.equal(banks[0], banks[1])


def test_normal_eq_is_deterministic():
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    cfg, cheap, hr_t, idx = _training_pair(dev, seed=31)
    label, s = _weighted(cheap, hr_t, True)
    runs = []
    for _ in range(3):
        q, v = tr.init_accumulators(cfg, dev)
        runs.append(ne.accumulate_normal_eq(q, v, cheap, label, idx, s))
    assert all(torch.equal(a[0], runs[0][0]) and torch.equal(a[1], runs[0][1]) for a in runs)


def test_normal_eq_refuses_what_it_cannot_take():
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    cfg, cheap, hr_t, idx = _training_pair(dev, h=64, w=80, seed=32)
    q, v = tr.init_accumulators(cfg, dev)
    wide = torch.zeros((64, 160), device=dev)[:, ::2]
    bad = [
        dict(cheap=wide),  # not contiguous
        dict(label=hr_t.double()),
        dict(idx=idx.long()),
        dict(idx=idx[1:].contiguous()),  # not the core's shape
        dict(q=q.double()),
        dict(v=v[:, :120].contiguous()),
        dict(weight=torch.ones((64, 80), device=dev).t().contiguous()),
        dict(idx=torch.full_like(idx, cfg.num_filters)),  # past the last filter
    ]
    for change in bad:
        args = {**dict(q=q, v=v, cheap=cheap, label=hr_t, idx=idx, weight=None), **change}
        before = ne.LAUNCHES
        with pytest.raises(ValueError):
            ne.accumulate_normal_eq(args["q"], args["v"], args["cheap"], args["label"],
                                    args["idx"], args["weight"])
        assert ne.LAUNCHES == before, change


def test_train_filterbank_card_equals_cpu():
    """One train_filterbank on the card against device="cpu" on the same two
    pairs: the same hash on both (the same float32 operations in the same
    order), Q summed in another order and solved by another LAPACK, so the
    banks agree within the JAX package's tolerance (lam 0.05, as in
    tests/test_torch_train.py)."""
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    pairs = []
    for seed in (33, 34):
        rng = np.random.default_rng(seed)
        hr = np.clip(smooth(128, 160, seed=seed) + rng.integers(-2, 3, (128, 160)), 0, 255)
        pairs.append(tr.degrade(hr, 2.0, 8))
    cfg = tr.TrainConfig(lam=0.05)
    before = ne.LAUNCHES
    card = tr.train_filterbank(pairs, cfg)
    assert ne.LAUNCHES == before + 2
    cpu = tr.train_filterbank(pairs, cfg, device="cpu")
    np.testing.assert_allclose(card.filters, cpu.filters, rtol=2e-3, atol=2e-4)


# -- multi-device paths over a mesh that names the one card four times -----


def test_sharded_2d_on_the_card_equals_unsharded_and_plain():
    """process_batch_2d over [cuda] * 4 (data 2 x rows 2): 4 frames x 2
    stripes x 2 passes fused launches, the output equal to the unsharded
    card step and to the plain version's sharded run on the CPU; then
    train_step_sharded over data 4 against one-device training."""
    from raisr_tpu_torch.parallel import make_mesh
    from raisr_tpu_torch.parallel import sharding as sh
    from raisr_tpu_torch.ops.cuda import normal_eq as ne
    from raisr_tpu_torch.train import trainer as tr

    dev = require_cuda()
    model = _model()
    batch = torch.tensor(smooth_frames(4, 64, 96, seed=70).astype(np.float32), device=dev)
    eng = RaisrEngine(RaisrConfig(passes=2), model, device=dev)
    cpu = RaisrEngine(RaisrConfig(passes=2, backend="pallas"), model, device="cpu")
    mesh = make_mesh(4, devices=[dev] * 4)
    _zero(fk.LAUNCHES)
    got = sh.process_batch_2d(batch, eng._banks, eng._statics, 2, 1, 128, 192, mesh)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[("float32", 4)] == 4 * 2 * 2
    assert got.device == dev and torch.equal(got, eng.process_batch_y(batch))
    plain = sh.process_batch_2d(batch.cpu(), cpu._banks, cpu._statics, 2, 1, 128, 192,
                                make_mesh(4, devices=["cpu"] * 4))
    assert torch.equal(got.cpu(), plain), int((got.cpu() != plain).sum())

    pairs = []
    for seed in range(4):
        rng = np.random.default_rng(80 + seed)
        hr = np.clip(smooth(64, 80, seed=80 + seed) + rng.integers(-2, 3, (64, 80)), 0, 255)
        pairs.append(tr.degrade(hr, 2.0, 8))
    lr_b = torch.tensor(np.stack([p[0] for p in pairs]).astype(np.float32), device=dev)
    hr_b = torch.tensor(np.stack([p[1] for p in pairs]).astype(np.float32), device=dev)
    cfg = tr.TrainConfig(lam=0.05)
    before = ne.LAUNCHES
    bank = tr.train_step_sharded(lr_b, hr_b, cfg, make_mesh(4, ("data",), devices=[dev] * 4))
    assert ne.LAUNCHES == before + 4
    assert torch.equal(bank, tr.train_step_sharded(
        lr_b, hr_b, cfg, make_mesh(4, ("data",), devices=[dev] * 4)))
    one = tr.train_filterbank(pairs, cfg, device=dev)
    np.testing.assert_allclose(bank.cpu().numpy(), one.filters, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("dtype,bits,ratio", [
    ("float32", 8, 2.0), ("auto", 8, 2.0), ("bfloat16", 10, 2.0), ("int8", 8, 2.0),
    ("float32", 8, 1.5), ("bfloat16", 10, 1.5)])
def test_stripe_launch_on_the_card(dtype, bits, ratio):
    """Rows over [cuda] * 4 at each tier equal the unsharded card run, and an
    interior stripe's launch (row0 = its first row with halo, zone_h the
    frame's height) equals the plain version bit for bit."""
    from raisr_tpu_torch.ops.resize import cheap_upscale
    from raisr_tpu_torch.parallel import make_mesh
    from raisr_tpu_torch.parallel import sharding as sh

    dev = require_cuda()
    pt = 4 if ratio == 2.0 else 1
    cfg = RaisrConfig(passes=1, dtype=dtype, bits=bits, ratio=ratio)
    eng = RaisrEngine(cfg, _model(1, seed=9, pixel_types=pt), device=dev)
    lr = torch.tensor(smooth(64, 96, bits, seed=5), device=dev)
    out_h, out_w = cfg.output_size(64, 96)
    mesh = make_mesh(4, ("rows",), devices=[dev] * 4)
    _zero(fk.LAUNCHES)
    got = sh.process_plane_row_sharded(lr, eng._banks, eng._statics, 1, 1, out_h, out_w, mesh)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[(eng._statics.tier, pt)] == 4
    assert torch.equal(got, eng.upscale_y(lr))
    hs = out_h // 4
    ext = cheap_upscale(lr, out_h, out_w, bits)[hs - sh.HR_HALO: 2 * hs + sh.HR_HALO].contiguous()
    b = eng._filters[0]
    kw = dict(_kw(2, bits), row0=hs - sh.HR_HALO, zone_h=out_h, pixel_types=pt,
              tier=eng._statics.tier, pbias=b.pbias, inv_scale=b.inv_scale)
    launch = fk.raisr_pass_full(ext, b.filters, **kw)
    assert torch.equal(launch, fk.raisr_pass_full_reference(ext, b.filters, **kw))
    assert torch.equal(launch[sh.HR_HALO: sh.HR_HALO + hs], got[hs: 2 * hs])


# the engine's configuration of each (tier, phases) form of the fused pass
_ENGINE_FORMS = {
    ("float32", 4): dict(), ("float32", 1): dict(ratio=1.5),
    ("bfloat16", 4): dict(dtype="bfloat16"), ("bfloat16", 1): dict(ratio=1.5, dtype="bfloat16"),
    ("pcenter", 4): dict(dtype="bfloat16", bits=10), ("int8", 4): dict(dtype="int8"),
}


@pytest.mark.parametrize("tier,pixel_types", sorted(fk.LAUNCHES))
def test_engine_passes_derive_nothing_after_construction(monkeypatch, tier, pixel_types):
    """After construction the engine's fused passes derive nothing on the
    card: with the Gaussian kernel, the normalization factor, the tier,
    phase, bank and edge checks and the hash-argument builder all raising,
    process_batch_device, its CUDA graph and a rows=2 striped pass run on,
    a counted pass a pass, and give the same outputs bit for bit."""
    from raisr_tpu_torch.ops import pipeline
    from raisr_tpu_torch.parallel import make_mesh
    from raisr_tpu_torch.parallel import sharding as sh

    dev = require_cuda()
    cfg = RaisrConfig(passes=2, **_ENGINE_FORMS[tier, pixel_types])
    eng = RaisrEngine(cfg, _model(2, seed=31, pixel_types=pixel_types), device=dev)
    assert eng._statics.tier == tier
    y = torch.tensor(smooth_frames(2, 64, 96, bits=cfg.bits, seed=32), device=dev)
    out_h, out_w = cfg.output_size(64, 96)
    mesh = make_mesh(2, ("rows",), devices=[dev] * 2)

    def run():
        oy = eng.process_batch_device(y)[0]
        striped = sh.process_plane_row_sharded(y[0].to(torch.float32), eng._banks,
                                               eng._statics, 2, cfg.two_pass_mode, out_h,
                                               out_w, mesh)
        torch.cuda.synchronize()
        return oy, striped

    want = run()

    def derived(*a, **k):
        raise AssertionError("a pass derived what its construction prepared")

    for module, name in ((pipeline, "gaussian_kernel_1d"), (pipeline, "normalization_factor"),
                         (fk, "_check_tier"), (fk, "_check_phases"), (fk, "_check_bank"),
                         (fk, "_hash_launch_args"), (flk, "_hash_launch_args"),
                         (flk, "check_bank_limits")):
        monkeypatch.setattr(module, name, derived)
    _zero(fk.LAUNCHES)
    got = run()
    # two stacked passes, then two passes over each of two stripes
    assert fk.LAUNCHES == {k: 6 if k == (tier, pixel_types) else 0 for k in fk.LAUNCHES}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[1], eng.upscale_y(y[0].to(torch.float32)))
    assert torch.equal(_graph_step(eng, y, None)[0], want[0])


@pytest.mark.parametrize("tier,dtype", [(0, "float32"), (1, "bfloat16"), (2, "int8")])
def test_capi_bridge_on_the_card_equals_engine_process(tmp_path, monkeypatch, tier, dtype):
    """The C ABI's bridge with no device request runs on the card, at the
    tier RTPU_InitEx names, and writes engine.process's frame into the
    caller's strided planes bit for bit."""
    from raisr_tpu_torch import capi_bridge as cb
    from torch_port_util import StridedFrame, write_bank_folder

    dev = require_cuda()
    monkeypatch.delenv(cb.DEVICE_ENV, raising=False)
    folder = write_bank_folder(tmp_path / "bank", passes=2, seed=22)
    fr = StridedFrame(seed=22, h=64, w=96, pad=64)
    try:
        assert cb.init(folder, 2.0, 8, 0, 2, 1, tier=tier) == 0
        assert cb._engine.device == dev and cb._engine._statics.tier == dtype
        _zero(fk.LAUNCHES)
        assert cb.process(*fr.args(), 2) == 0
        assert fk.LAUNCHES[(dtype, 4)] == 2
    finally:
        cb.deinit()
    want = RaisrEngine(RaisrConfig(filterfolder=folder, passes=2, dtype=dtype),
                       device=dev).process(fr.frame())
    for got, ref in zip(fr.got(), (want.y, want.u, want.v)):
        np.testing.assert_array_equal(got, ref)


def test_capi_library_second_host_thread_on_the_card(tmp_path, monkeypatch):
    """build/capi_torch/libraisr_tpu.so loaded here: RTPU_Process from a
    second thread returns within its limit with the main thread's bytes."""
    import threading

    from raisr_tpu_torch import capi_bridge as cb
    from raisr_tpu_torch.native import build_capi
    from torch_port_util import StridedFrame, write_bank_folder

    require_cuda()
    monkeypatch.delenv(cb.DEVICE_ENV, raising=False)
    folder = write_bank_folder(tmp_path / "bank", passes=2, seed=23)
    fr = StridedFrame(seed=23, h=64, w=96, pad=64)
    lib = build_capi.load()
    out, rc = fr.fresh_out(), []
    try:
        assert lib.RTPU_InitEx(folder.encode(), 2.0, 8, 0, 2, 1, 0) == 0
        assert lib.RTPU_Process(*fr.rtpu(), 2) == 0
        t = threading.Thread(target=lambda: rc.append(lib.RTPU_Process(*fr.rtpu(out), 2)),
                             daemon=True)
        t.start()
        t.join(60)
    finally:
        lib.RTPU_Deinit()
    assert not t.is_alive() and rc == [0]
    for a, b in zip(fr.got(), fr.got(out)):
        np.testing.assert_array_equal(a, b)


# -- the serving step's glue (csrc/upscale.cu) --------------------------------

# (packed type, bits): each input type the kernel reads, uint16 at 10 and 16 bits
_GLUE_TYPES = [(torch.uint8, 8), (torch.uint16, 10), (torch.uint16, 16), (torch.float32, 8)]
_GLUE_SHAPES = [(n, h, w) for n in (1, 4) for h in (1, 2, 5) for w in (1, 7, 33, 4700)]


def _packed(v: np.ndarray, dtype, dev) -> torch.Tensor:
    np_type = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.float32: np.float32}
    return torch.from_numpy(np.ascontiguousarray(v.astype(np_type[dtype]))).to(dev)


def _glue_frames(n, h, w, bits, dtype, seed, dev) -> torch.Tensor:
    """Seeded integers over [0, 2^bits - 1], both ends present."""
    top = (1 << bits) - 1
    v = np.random.default_rng(seed).integers(0, top + 1, (n, h, w))
    v.flat[0], v.flat[-1] = 0, top
    return _packed(v, dtype, dev)


def _same(got, want) -> bool:
    """Equal type, shape and bits (uint16 through its int16 view)."""
    view = lambda t: t.view(torch.int16) if t.dtype == torch.uint16 else t
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(view(got), view(want)))


def _glue_sizes(h, w):
    """(form, out_h, out_w): the stack alone, 2x, and 1.5x (exact where the
    size is even, the float form where it is odd)."""
    return [("1x", h, w), ("2x", 2 * h, 2 * w), ("vec", 3 * h // 2, 3 * w // 2)]


@pytest.mark.parametrize("dtype,bits", _GLUE_TYPES)
def test_upscale_stack_from_frames_matches_plain_version(dtype, bits):
    """Pass 1's input from packed frames, guard band on the fly, every form
    (1x with mode 2's 12-row guard), widths 1 to 4700, 1 and 4 frames."""
    dev = require_cuda()
    for n, h, w in _GLUE_SHAPES:
        x = _glue_frames(n, h, w, bits, dtype, n * h * w, dev)
        for form, oh, ow in _glue_sizes(h, w):
            pad = 12 if form == "1x" else 6
            before = dict(up.UPSCALE_LAUNCHES)
            got = up.cheap_upscale_stack(x, n, h, pad, oh, ow, bits)
            want = up.cheap_upscale_stack_reference(x, n, h, pad, oh, ow, bits)
            torch.cuda.synchronize()
            before[up._stack_form(h, w, oh, ow)] += 1
            assert up.UPSCALE_LAUNCHES == before
            assert _same(got, want), (n, h, w, form, float((got - want).abs().max()))


@pytest.mark.parametrize("bits", [8, 10, 16])
def test_upscale_of_a_float_stack_matches_plain_version(bits):
    """Mode 2's inter-pass upscale: a float32 stack that has its guard band
    (12 rows), 2x and 1.5x."""
    dev = require_cuda()
    for n, h, w in _GLUE_SHAPES:
        x = up.guard_band_stack(_glue_frames(n, h, w, bits, torch.float32, h + w, dev), 12)
        for form, oh, ow in _glue_sizes(h, w)[1:]:
            got = up.cheap_upscale_stack(x, n, h, 12, oh, ow, bits)
            want = up.cheap_upscale_stack_reference(x, n, h, 12, oh, ow, bits)
            assert _same(got, want), (n, h, w, form)


@pytest.mark.parametrize("dtype,bits", _GLUE_TYPES)
@pytest.mark.parametrize("packed_out", [True, False])
def test_upscale_planes_matches_plain_version(dtype, bits, packed_out):
    """Chroma batches, each plane its own edge clamp, 2x and 1.5x, packed
    out (the input's type, or uint8/uint16 from float32 input) or float32."""
    dev = require_cuda()
    out_dtype = torch.float32
    if packed_out:
        out_dtype = dtype if dtype != torch.float32 else torch.uint8
    for n, h, w in _GLUE_SHAPES:
        x = _glue_frames(n, h, w, bits, dtype, 7 * n + h + w, dev)
        for form, oh, ow in _glue_sizes(h, w)[1:]:
            before = sum(up.UPSCALE_LAUNCHES.values())
            got = up.cheap_upscale_planes(x, oh, ow, bits, out_dtype)
            want = up.cheap_upscale_planes_reference(x, oh, ow, bits, out_dtype)
            torch.cuda.synchronize()
            assert sum(up.UPSCALE_LAUNCHES.values()) == before + 1
            assert _same(got, want), (n, h, w, form, out_dtype)
            assert _same(up.cheap_upscale_planes(x[0], oh, ow, bits, out_dtype), want[0])


@pytest.mark.parametrize("dtype,bits", _GLUE_TYPES)
def test_upscale_ties_and_extremes(dtype, bits):
    """A plane of 2^bits - 1 everywhere, and columns alternating 0 and
    2^bits - 1: the quarter weights land on .5 ties and at the clamp."""
    dev = require_cuda()
    top = (1 << bits) - 1
    full = np.full((2, 6, 40), top)
    stripes = np.zeros((2, 6, 40), np.int64)
    stripes[..., 1::2] = top
    for v in (full, stripes, stripes.transpose(0, 2, 1).copy()):
        x = _packed(v, dtype, dev)
        n, h, w = x.shape
        for form, oh, ow in _glue_sizes(h, w)[1:]:
            assert _same(up.cheap_upscale_stack(x, n, h, 6, oh, ow, bits),
                         up.cheap_upscale_stack_reference(x, n, h, 6, oh, ow, bits))
            assert _same(up.cheap_upscale_planes(x, oh, ow, bits, dtype),
                         up.cheap_upscale_planes_reference(x, oh, ow, bits, dtype))


def test_upscale_in_a_cuda_graph_equals_eager():
    dev = require_cuda()
    x = _glue_frames(4, 36, 52, 8, torch.uint8, 9, dev)
    calls = [lambda: up.cheap_upscale_stack(x, 4, 36, 6, 72, 104, 8),
             lambda: up.cheap_upscale_stack(x, 4, 36, 6, 54, 78, 8),
             lambda: up.cheap_upscale_planes(x, 54, 78, 8, torch.uint8)]
    eager = [fn() for fn in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in calls]
    graph.replay()
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(outs, eager))


def test_upscale_refuses_what_it_does_not_take():
    dev = require_cuda()
    with pytest.raises(ValueError, match="uint8, uint16 or float32"):
        up.cheap_upscale_planes(torch.zeros((4, 4), dtype=torch.int32, device=dev), 8, 8, 8)
    with pytest.raises(ValueError, match="are not 2 of 4 rows"):
        up.cheap_upscale_stack(torch.zeros((3, 4, 4), dtype=torch.uint8, device=dev),
                               2, 4, 6, 8, 8, 8)


@pytest.mark.parametrize("cfg,y_shape,counts", [
    (dict(passes=2), (4, 36, 52), {"1x": 0, "2x": 3, "vec": 0}),
    (dict(passes=2, mode=2), (4, 36, 52), {"1x": 1, "2x": 3, "vec": 0}),
    (dict(passes=1, ratio=1.5), (4, 36, 52), {"1x": 0, "2x": 0, "vec": 3}),
])
def test_step_glue_launches(monkeypatch, cfg, y_shape, counts):
    """One step on the card: the glue's launches (Y, U, V; mode 2 adds the
    LR stack) and none of the PyTorch chain's pieces, which are made to
    raise; the frames equal the CPU engine's."""
    from raisr_tpu_torch import engine as eng_mod
    from raisr_tpu_torch.ops import pipeline, resize

    dev = require_cuda()
    pt = 1 if cfg.get("ratio") == 1.5 else 4
    model = _model(passes=cfg["passes"], seed=8, pixel_types=pt)
    y = _glue_frames(*y_shape, 8, torch.uint8, 10, dev)
    u = _glue_frames(4, 18, 26, 8, torch.uint8, 11, dev)
    eng = RaisrEngine(RaisrConfig(**cfg), model, device=dev)
    eng.process_batch_device(y, u, u)  # the vectors of a shape, built once
    torch.cuda.synchronize()

    def refused(*args, **kw):
        raise AssertionError("the PyTorch glue ran on the card's route")

    for mod, name in ((up, "guard_band_stack"), (up, "unpack_planes"), (up, "cheap_upscale"),
                      (up, "cheap_upscale_stacked"), (resize, "_upscale_axis_2x"),
                      (pipeline, "unpack_planes"), (eng_mod, "unpack_planes")):
        monkeypatch.setattr(mod, name, refused)
    _zero(up.UPSCALE_LAUNCHES)
    oy, ou, ov = eng.process_batch_device(y, u, u)
    torch.cuda.synchronize()
    assert up.UPSCALE_LAUNCHES == counts
    monkeypatch.undo()
    cpu = RaisrEngine(RaisrConfig(backend="pallas", **cfg), model, device="cpu")
    cy, cu, _ = cpu.process_batch_device(y.cpu(), u.cpu(), u.cpu())
    assert torch.equal(oy.cpu(), cy) and torch.equal(ou.cpu(), cu)
