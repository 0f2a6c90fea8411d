"""The readers of the program's own spans, on a hand-built trace and
window: the mean "raisr.step" range of the traced slice, and the stream's
"stage" and "wait" Tracer stages a group; each reads None without its
span."""

from __future__ import annotations

import types

import pytest
from conftest import ROOT

from gpubench import devtrace, spec
from gpubench.drivers.base import Window


def read(name, trace=None, spans=None):
    run = types.SimpleNamespace(cfg={}, traffic={"batch": 4}, trace=trace,
                                window=Window(seconds=1.0, spans=spans or {}))
    return spec.reader(ROOT, name)(run)


def trace(host):
    ranges = [devtrace.Event("gpubench.step", "user_annotation", 0.0, 3000.0)]
    return devtrace.TraceData(device=[], host=ranges + host, ranges=ranges, groups=[])


def test_step_enqueue_ms():
    t = trace([devtrace.Event("raisr.step", "user_annotation", 10.0, 500.0),
               devtrace.Event("raisr.step", "user_annotation", 1500.0, 700.0),
               devtrace.Event("raisr.pass", "user_annotation", 20.0, 200.0),
               # the device's copy of the range is not the host's enqueue
               devtrace.Event("raisr.step", "gpu_user_annotation", 600.0, 4000.0)])
    assert read("step_enqueue_ms", trace=t) == pytest.approx(0.6)


def test_step_enqueue_ms_without_the_span():
    t = trace([devtrace.Event("aten::empty", "cpu_op", 10.0, 5.0)])
    assert read("step_enqueue_ms", trace=t) is None
    assert read("step_enqueue_ms") is None


@pytest.mark.parametrize("name,stage", [("stream_stage_ms", "stage"),
                                        ("stream_wait_ms", "wait")])
def test_stream_stage_readers(name, stage):
    spans = {"dispatch": {"count": 8, "total_s": 0.032},
             stage: {"count": 8, "total_s": 0.012}}
    assert read(name, spans=spans) == pytest.approx(1.5)
    assert read(name, spans={"dispatch": spans["dispatch"]}) is None
    assert read(name, spans={stage: {"count": 0, "total_s": 0.0}}) is None
    assert read(name) is None
