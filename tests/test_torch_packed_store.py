"""Launch B's packed store on the CPU: the last pass of a batched step hands
back the Y frames packed (uint8 at 8 bits, uint16 above), a stack's guard
rows left out, so the engine's step runs no pack of Y of its own. On the CPU
the fused pass runs its plain version and packs with pack_planes
(full_kernel.packed_frames), so the routes are held here against the
float32 route and pack_planes, frame by frame, and the packed-launch count
stays 0; the kernel's own store is held on the card (test_torch_cuda.py).
Banks are built in memory from a seed; nothing here imports jax."""

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch

from raisr_tpu_torch import RaisrConfig, RaisrEngine
from raisr_tpu_torch import engine as engine_mod
from raisr_tpu_torch.model.gaussian import gaussian_kernel_1d, normalization_factor
from raisr_tpu_torch.model.loader import FilterBank, RaisrModel
from raisr_tpu_torch.ops import pipeline
from raisr_tpu_torch.ops.cuda import full_kernel as fk
from raisr_tpu_torch.ops.cuda.upscale import pack_planes
from torch_port_util import QCOH, QSTR, make_filters, smooth, smooth_frames


def _model(passes, pixel_types, seed=0) -> RaisrModel:
    rng = np.random.default_rng(seed)
    return RaisrModel(24, 3, 3, 11, tuple(
        FilterBank(filters=make_filters(rng, pixel_types), qstr=np.asarray(QSTR, np.float32),
                   qcoh=np.asarray(QCOH, np.float32), pixel_types=pixel_types, taps=121,
                   source_dtype="fp32")
        for _ in range(passes)
    ))


def _engine(bits, ratio, passes, mode=1, shard=None, **kw):
    cfg = RaisrConfig(bits=bits, ratio=ratio, passes=passes, mode=mode, backend="pallas", **kw)
    return RaisrEngine(cfg, _model(passes, 4 if ratio == 2.0 else 1, seed=bits + passes),
                       shard=shard, device="cpu")


def _count_packs(monkeypatch):
    """Counts the calls of pack_planes made by the engine and the pipeline
    (not by the fused pass's plain store)."""
    calls = []

    def counted(x, dtype):
        calls.append(dtype)
        return pack_planes(x, dtype)

    monkeypatch.setattr(engine_mod, "pack_planes", counted)
    monkeypatch.setattr(pipeline, "pack_planes", counted)
    return calls


@pytest.mark.parametrize("bits,ratio,passes,mode", [
    (8, 2.0, 2, 1), (10, 2.0, 2, 1), (8, 2.0, 2, 2), (8, 1.5, 1, 1), (10, 1.5, 1, 1),
])
def test_step_equals_float_route_and_pack(monkeypatch, bits, ratio, passes, mode):
    """process_batch_device on the stacked route: the last pass's packed
    frames equal process_batch_y then pack_planes, and each frame equals its
    own upscale_y packed; the step packs nothing itself, and no launch of
    the packed form is counted on the CPU."""
    eng = _engine(bits, ratio, passes, mode)
    y = torch.from_numpy(smooth_frames(3, 24, 36, bits=bits, seed=bits + mode))
    dtype = torch.uint8 if bits == 8 else torch.uint16
    calls = _count_packs(monkeypatch)
    before = fk.PACKED_EPILOGUE_LAUNCHES
    oy, _, _ = eng.process_batch_device(y)
    assert calls == [] and fk.PACKED_EPILOGUE_LAUNCHES == before
    assert oy.dtype == dtype and oy.is_contiguous()
    assert oy.shape == (3, *eng.cfg.output_size(24, 36))
    assert torch.equal(oy, pack_planes(eng.process_batch_y(y), dtype))
    for i in range(3):
        assert torch.equal(oy[i], pack_planes(eng.upscale_y(y[i].to(torch.float32)), dtype)), i


@pytest.mark.parametrize("ratio,passes", [(2.0, 2), (1.5, 1)])
def test_float32_out_dtype_leaves_the_batch_as_it_was(ratio, passes):
    """process_plane_y_batch with out_dtype float32 is the call without it:
    the same float32 view of the stack's frames, equal to the per-frame
    pipeline."""
    eng = _engine(8, ratio, passes)
    y = torch.from_numpy(smooth_frames(2, 24, 36, seed=7))
    args = (eng._filters, eng._statics, passes, 1, *eng.cfg.output_size(24, 36))
    default = pipeline.process_plane_y_batch(y, *args)
    got = pipeline.process_plane_y_batch(y, *args, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == default.shape
    assert got.stride() == default.stride() and not got.is_contiguous()
    assert torch.equal(got, default)
    for i in range(2):
        assert torch.equal(got[i], pipeline.process_plane_y(y[i], *args))


@pytest.mark.parametrize("route", ["data=2", "rows=2", "cubic"])
def test_mesh_and_loop_routes_pack_with_pack_planes(monkeypatch, route):
    """A mesh (data or rows) and the per-frame loop (a cubic resize does not
    stack) still pack Y with pack_planes, once a step, and count no packed
    launch; their frames equal the float32 route's packed."""
    kw = dict(resize_mode="cubic") if route == "cubic" else dict(shard=route)
    eng = _engine(8, 2.0, 2, **kw)
    y = torch.from_numpy(smooth_frames(2, 24, 36, seed=11))
    calls = _count_packs(monkeypatch)
    before = fk.PACKED_EPILOGUE_LAUNCHES
    oy, _, _ = eng.process_batch_device(y)
    assert calls == [torch.uint8] and fk.PACKED_EPILOGUE_LAUNCHES == before
    monkeypatch.undo()
    ys = y if route != "rows=2" else y.to(torch.float32)
    assert torch.equal(oy, pack_planes(eng.process_batch_y(ys), torch.uint8))
    if route != "cubic":
        assert torch.equal(oy, _engine(8, 2.0, 2).process_batch_device(y)[0])


def _pass_kw(bits, blending):
    cfg = RaisrConfig(bits=bits)
    return dict(k1d=tuple(float(v) for v in gaussian_kernel_1d(11)),
                nf=normalization_factor(bits), qstr=QSTR, qcoh=QCOH,
                min_val=cfg.min_val, max_val=cfg.max_val, blending=blending)


@pytest.mark.parametrize("blending", [1, 2])
@pytest.mark.parametrize("pixel_types", [4, 1])
@pytest.mark.parametrize("bits,dtype", [(8, torch.uint8), (10, torch.uint16)])
@pytest.mark.parametrize("frame_h,pad", [(0, 0), (26, 7)])
def test_packed_pass_and_epilogue_equal_float_and_pack(blending, pixel_types, bits, dtype,
                                                       frame_h, pad):
    """The fused pass and launch B alone with a packed out_dtype: the float32
    plane with a stack's guard rows left out (frame k at rows k * frame_h),
    packed by pack_planes; a whole plane keeps every row."""
    w = 45
    h = 3 * (frame_h + 2 * pad) if frame_h else 30
    cheap = torch.from_numpy(smooth(h, w, bits=bits, seed=h + blending))
    f = torch.from_numpy(make_filters(np.random.default_rng(5), pixel_types))
    fused = fk.FusedPass(f, pixel_types=pixel_types, **_pass_kw(bits, blending))
    zone = dict(frame_h=frame_h, frame_pad=pad)
    full = fused(cheap, **zone)
    got = fused(cheap, **zone, out_dtype=dtype)
    rows = [r for r in range(h) if not frame_h or pad <= r % (frame_h + 2 * pad) < pad + frame_h]
    assert got.dtype == dtype and got.shape == (len(rows), w)
    assert torch.equal(got, pack_planes(full[rows], dtype))
    ekw = {k: v for k, v in _pass_kw(bits, blending).items() if k in ("min_val", "max_val",
                                                                        "blending")}
    raw = cheap + torch.from_numpy(smooth(h, w, bits=bits, seed=3)) / 64
    alone = fk.pass_epilogue(cheap, raw, **ekw, **zone, out_dtype=dtype)
    assert torch.equal(alone, pack_planes(fk.pass_epilogue(cheap, raw, **ekw, **zone)[rows],
                                          dtype))


def test_packed_store_refusals():
    """A packed store takes uint8 or uint16 over a whole plane or a whole
    stack: another dtype, a row stripe and a stack cut short are refused,
    on the fused pass and launch B alike."""
    cheap = torch.from_numpy(smooth(40, 32, seed=2))
    f = torch.from_numpy(make_filters(np.random.default_rng(6)))
    fused = fk.FusedPass(f, **_pass_kw(8, 2))
    for call in (lambda **k: fused(cheap, **k),
                 lambda **k: fk.pass_epilogue(cheap, cheap, **k)):
        with pytest.raises(ValueError, match="float32, uint8 or uint16"):
            call(out_dtype=torch.int32)
        with pytest.raises(ValueError, match="not a row stripe"):
            call(row0=4, zone_h=60, out_dtype=torch.uint8)
        with pytest.raises(ValueError, match="whole stack"):
            call(frame_h=14, frame_pad=4, out_dtype=torch.uint16)
        assert call(frame_h=12, frame_pad=4, out_dtype=torch.uint8).shape == (24, 32)
