"""The port's spans on the CPU: the engine's bank preparation, the serving
step's, the stream's and the per-frame path's stages as torch.profiler
ranges, in order and nested; no range at all, and no host-clock stage from
a disabled Tracer, while no profiler records; and the stream's "wait" stage
without the caller's time. Banks are written under tmp_path."""

import time

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import torch
from torch.profiler import ProfilerActivity, profile

from raisr_tpu_torch import RaisrConfig, RaisrEngine, load_model
from raisr_tpu_torch import capi_bridge as cb
from raisr_tpu_torch.engine import Frame
from raisr_tpu_torch.stream import StreamProcessor
from raisr_tpu_torch.utils import profiler
from raisr_tpu_torch.utils.profiler import Tracer, device_fence, span
from torch_port_util import StridedFrame, write_bank_folder


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_bank_folder(tmp_path_factory.mktemp("spans") / "bank", passes=2, seed=3)


def _engine(folder, shard=None, **kw):
    cfg = RaisrConfig(filterfolder=folder, backend="pallas", **kw)
    return RaisrEngine(cfg, load_model(folder, cfg), shard=shard, device="cpu")


def _frames(n, h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return [Frame(y=rng.integers(16, 235, (h, w)).astype(np.uint8),
                  u=rng.integers(16, 235, (h // 2, w // 2)).astype(np.uint8),
                  v=rng.integers(16, 235, (h // 2, w // 2)).astype(np.uint8))
            for _ in range(n)]


def _spans(fn):
    """The `raisr.*` ranges recorded while fn runs, as (name, start, end),
    outer before inner."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("raisr.")), key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    """The names of the ranges inside `outer`, in the order they started."""
    _, t0, t1 = outer
    return [s[0] for s in spans if s is not outer and t0 <= s[1] and s[2] <= t1]


def _only(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, spans)
    return found[0]


@pytest.mark.parametrize("passes,mode", [(1, 1), (2, 1), (2, 2)])
def test_step_spans_in_order(folder, passes, mode):
    """`raisr.step` holds the Y glue, one `raisr.pass` a pass, then
    `raisr.chroma`; mode 2 upscales between the passes. The last pass hands
    back Y packed, so the stacked step has no `raisr.pack`."""
    engine = _engine(folder, passes=passes, mode=mode)
    fr = _frames(2, 24, 32, seed=passes + mode)
    batch = [torch.from_numpy(np.stack([getattr(f, p) for f in fr])) for p in "yuv"]
    spans = _spans(lambda: engine.process_batch_device(*batch))
    stages = {(1, 1): ["glue", "pass"], (2, 1): ["glue", "pass", "pass"],
              (2, 2): ["glue", "pass", "glue", "pass"]}[passes, mode]
    want = [f"raisr.{s}" for s in stages + ["chroma"]]
    assert _inside(spans, _only(spans, "raisr.step")) == want
    assert [s[0] for s in spans] == ["raisr.step"] + want


@pytest.mark.parametrize("shard", [None, "data=2"])
def test_bank_preparation_span(folder, monkeypatch, shard):
    """Building an engine marks `raisr.banks` once a device (a CPU mesh
    names one device twice), around the tier's bank preparation."""
    from raisr_tpu_torch import engine as engine_mod

    prepare = engine_mod.pass_banks

    def marked(*a, **k):
        with span("raisr.pass_banks"):
            return prepare(*a, **k)

    monkeypatch.setattr(engine_mod, "pass_banks", marked)
    spans = _spans(lambda: _engine(folder, passes=2, dtype="bfloat16", shard=shard))
    assert [s[0] for s in spans] == ["raisr.banks", "raisr.pass_banks"]
    assert _inside(spans, _only(spans, "raisr.banks")) == ["raisr.pass_banks"]


def test_no_range_without_a_profiler(folder, monkeypatch):
    """With no profiler recording, no span enters `record_function` (it is
    patched to raise) on the engine's construction, the step, the stream or
    the per-frame path, every span is the one shared no-op context, and a
    disabled Tracer records nothing."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(profiler, "record_function", refuse)
    assert span("raisr.step") is span("raisr.pass") is span("raisr.banks")
    engine = _engine(folder, passes=2)
    frames = _frames(3)
    tracer = Tracer(enabled=False)
    out = list(StreamProcessor(engine, depth=2, batch=2, tracer=tracer).process(iter(frames)))
    assert len(out) == 3 and not tracer.stages
    engine.process(frames[0])
    device_fence(torch.ones(2), None, np.zeros(2))  # nothing on a device: returns at once


def test_stream_stages_are_ranges_without_a_tracer(folder):
    """A stream built with tracer=None still marks its stages in a trace:
    each group's "dispatch" holds its "stage" and then its step, and each
    group has one "wait"."""
    engine = _engine(folder, passes=2)
    out = []
    spans = _spans(lambda: out.extend(
        StreamProcessor(engine, depth=2, batch=2).process(iter(_frames(5)))))
    names = [s[0] for s in spans]
    assert len(out) == 5
    for name in ("raisr.stream.dispatch", "raisr.stream.stage", "raisr.stream.wait",
                 "raisr.step"):
        assert names.count(name) == 3, (name, names)
    for d in (s for s in spans if s[0] == "raisr.stream.dispatch"):
        inner = _inside(spans, d)
        assert [n for n in inner if n in ("raisr.stream.stage", "raisr.step")] == \
            ["raisr.stream.stage", "raisr.step"]
        assert "raisr.stream.wait" not in inner


def test_wait_leaves_out_the_callers_time(folder):
    """The caller holds each frame for 20 ms; the "wait" stage, closed
    before a frame is handed out, counts none of it."""
    engine = _engine(folder)
    tracer = Tracer()
    for _ in StreamProcessor(engine, depth=1, batch=2, tracer=tracer).process(
            iter(_frames(4))):
        time.sleep(0.02)
    wait = tracer.stages["wait"]
    assert wait.count == 2 and wait.total_s < 0.02


def test_per_frame_spans(folder, monkeypatch):
    """A frame through the C ABI's bridge: `raisr.frame` holds the copy in,
    the passes and the copy back, and `raisr.capi.write` follows it."""
    monkeypatch.setattr(cb, "_device_index", None)
    assert cb.init(folder, 2.0, 8, 0, 2, 1, device="cpu") == 0
    try:
        fr = StridedFrame(seed=1)
        spans = _spans(lambda: cb.process(*fr.args(), 2))
    finally:
        cb.deinit()
    assert _inside(spans, _only(spans, "raisr.frame")) == [
        "raisr.frame.put", "raisr.glue", "raisr.pass", "raisr.pass", "raisr.frame.get"]
    assert spans[-1][0] == "raisr.capi.write" and spans[-1][1] >= _only(spans, "raisr.frame")[2]
