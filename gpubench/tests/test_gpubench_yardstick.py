"""The yardstick's counts against hand counts, and the trace reading and the
metric readers on a synthetic trace."""

from __future__ import annotations

import json
import types

import pytest
from conftest import ROOT

from gpubench import devtrace, spec, yardstick


def config(name: str) -> dict:
    return json.loads((ROOT / "gpubench/configs" / f"{name}.json").read_text())


def test_counts_2x():
    cfg = config("raisr-2x-highres-2pass-f32")
    px = 3840 * 2160  # 8,294,400 output pixels a pass, two passes at 4K
    assert yardstick.frame_shapes(cfg) == {"y_in": (1080, 1920), "y_out": (2160, 3840),
                                           "c_in": (540, 960), "c_out": (1080, 1920)}
    assert yardstick.frame_ops(cfg) == 2 * px * (242 + 170) == 6_834_585_600
    # Y 2,073,600 + U, V 1,036,800 in; pass 1's float32 plane 33,177,600 and
    # U, V 4,147,200 out
    assert yardstick.glue_bytes(cfg) == 2_073_600 + 1_036_800 + 33_177_600 + 4_147_200
    # operations bind each pass: 3.4173e9 / 67e12 against 66.4e6 / 3.35e12
    assert yardstick.pass_least_seconds(cfg) == pytest.approx(2 * px * 412 / 67e12)
    assert yardstick.least_seconds(px * 412, px * 8, "float32")[1] == "operations"
    assert yardstick.glue_least_seconds(cfg) == pytest.approx(40_435_200 / 3.35e12)
    assert yardstick.peak_ops(cfg) == 67e12


def test_counts_15x():
    cfg = config("raisr-1.5x-1pass-f32")
    px = 2880 * 1620  # 4,665,600
    assert yardstick.frame_shapes(cfg)["y_out"] == (1620, 2880)
    assert yardstick.frame_shapes(cfg)["c_out"] == (810, 1440)
    assert yardstick.frame_ops(cfg) == px * 412 == 1_922_227_200
    assert yardstick.glue_bytes(cfg) == 2_073_600 + 1_036_800 + px * 4 + 2 * 810 * 1440
    assert yardstick.pass_least_seconds(cfg) == pytest.approx(px * 412 / 67e12)


def test_mode_2_runs_its_first_pass_at_the_input_size():
    cfg = {**config("raisr-2x-highres-2pass-f32"), "mode": 2}
    assert yardstick.pass_planes(cfg) == [(1080, 1920), (2160, 3840)]
    assert yardstick.frame_ops(cfg) == (1080 * 1920 + 2160 * 3840) * 412


def test_union():
    assert devtrace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert devtrace.union_us([]) == 0
    assert devtrace.merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def synthetic_trace(tmp_path, groups):
    """Two steps of 10 µs on the host; the first step's three pass kernels
    and a glue kernel, a copy, and a gap under a synchronize."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "gpubench.step", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "gpubench.step", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 12, "dur": 8},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 1, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "void cheap_upscale_kernel<a>", "ts": 2, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "hash_bucket_kernel", "ts": 4, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "void gather_resident_kernel<4>", "ts": 6, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "epilogue_kernel<true>", "ts": 10, "dur": 1},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 16,
         "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 3},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return devtrace.read_trace(str(path), groups)


def test_trace_reading(tmp_path):
    t = synthetic_trace(tmp_path, spec.kernel_groups(ROOT))
    assert (t.t0, t.t1, t.window_us) == (0, 20, 20)
    # device busy 2..11 and 16..18
    assert t.busy_us() == 11
    assert t.idle_gaps() == [(0, 2), (11, 16), (18, 20)]
    assert t.layer_us("pass") == 8 and t.layer_us("glue") == 2 and t.layer_us("copy") == 2
    assert t.host_at(1.5) == "gpubench.step / aten::empty"
    assert t.host_at(13) == "gpubench.step / cudaDeviceSynchronize"
    b = t.breakdown()
    assert b["device_ops"][0] == ["pass A2 gather_resident_kernel", 4e-6]
    # gaps labelled at their start: 0 and 11 in a step before any host
    # event, 18 inside the synchronize
    assert dict(b["idle_gaps"]) == {"gpubench.step": 7e-6,
                                    "gpubench.step / cudaDeviceSynchronize": 2e-6}
    assert t.busy_us(10, 20) == 3


def test_readers_on_a_trace(tmp_path):
    t = synthetic_trace(tmp_path, spec.kernel_groups(ROOT))
    t.units, t.frames = 2, 8
    cfg = config("raisr-2x-highres-2pass-f32")
    run = types.SimpleNamespace(cfg=cfg, traffic={"batch": 4}, trace=t, yard=yardstick,
                                window=types.SimpleNamespace(frames=880, seconds=1.0,
                                                             latencies_s=[], spans={}))

    def read(name):
        return spec.reader(ROOT, name)(run)

    assert read("pass_roofline") == pytest.approx(
        100 * 8 * yardstick.pass_least_seconds(cfg) * 1e6 / 8)
    assert read("glue_roofline") == pytest.approx(
        100 * 8 * yardstick.glue_least_seconds(cfg) * 1e6 / 2)
    assert read("device_idle_pct.batch") == pytest.approx(100 - 100 * 11 / 20)
    assert read("stream_copy_ms") == pytest.approx(2e-3 / 2)
    assert read("step_mfu_pct") == pytest.approx(100 * 880 * 6_834_585_600 / 67e12)
    assert read("stream_dispatch_ms") is None
    # per frame: 10 µs of wall, 8 and 3 of it with the device busy
    for r in t.ranges:
        r.name = "gpubench.frame"
    assert read("frame_host_ms") == pytest.approx(((10 - 8) + (10 - 3)) / 2 / 1e3)


def test_readers_without_a_trace_read_nothing():
    cfg = config("raisr-2x-highres-2pass-f32")
    run = types.SimpleNamespace(cfg=cfg, traffic={"batch": 4}, trace=None, yard=yardstick,
                                window=types.SimpleNamespace(frames=0, seconds=1.0,
                                                             latencies_s=[], spans={}))
    for name in ("pass_roofline", "glue_roofline", "device_idle_pct.batch",
                 "device_idle_pct.frame", "stream_copy_ms", "frame_host_ms", "step_mfu_pct",
                 "frame_mfu_pct", "frames_per_s", "frame_ms_p95", "stream_dispatch_ms"):
        assert spec.reader(ROOT, name)(run) is None, name
