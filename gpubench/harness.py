"""One run of one cell: inputs from the seed, the driver's set-up and warm-up,
the measured window, a traced slice (with --trace 1), the check against the
plain reference, and the metrics.

Importing this module imports neither the program nor JAX; the drivers
import the program when they set it up.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import types

import torch

from gpubench import data, devtrace, spec, yardstick
from gpubench.drivers.base import Context, now, sync


@dataclasses.dataclass
class Outcome:
    """A run's result: the JSON object run.py prints last (`line`), the
    checks, each number beside its limit, for standard error, and notes
    for earlier lines."""

    line: dict
    checks: dict
    notes: list


def check_outputs(cfg: dict, banks, qstr, qcoh, frames, samples) -> dict:
    """Every kept output frame against the plain reference of the same input
    frame: the samples that differ and the largest absolute difference, over
    Y, U and V. An exact comparison: the limits are 0."""
    ref_mod = importlib.import_module(f"gpubench.reference.{cfg['reference']}")
    ref = ref_mod.Reference(cfg, banks, qstr, qcoh)
    differing, max_abs, checked = 0, 0.0, 0
    y, u, v = frames
    with torch.no_grad():
        for idx, oy, ou, ov in samples:
            for got, want in ((oy, ref.luma(y[idx])), (ou, ref.chroma(u[idx])),
                              (ov, ref.chroma(v[idx]))):
                d, m = ref_mod.compare(got, want)
                differing += d
                max_abs = max(max_abs, m)
            checked += 1
    return {"differing": {"value": differing, "limit": 0},
            "max_abs_diff": {"value": max_abs, "limit": 0.0},
            "frames_checked": {"value": checked, "least": 1}}


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, program_overrides: dict | None = None) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    program_cfg = {**cfg, **(program_overrides or {})}
    driver_mod = importlib.import_module(f"gpubench.drivers.{traffic['entry']}")
    banks, qstr, qcoh = data.make_banks(cfg, seed, device)
    frames = data.make_frames(cfg, driver_mod.frames_needed(traffic), seed, device)
    ctx = Context(cfg, program_cfg, traffic, device, seed, banks, qstr, qcoh, frames)
    t_data = now() - t_start
    driver = driver_mod.Driver(ctx)
    driver.setup()
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # what set-up made stays: no collection walks it inside the window
    gc.collect()
    gc.freeze()
    setup_s = now() - t_start

    window = driver.window(seconds, spans=trace)
    traced = None
    if trace:
        prof = devtrace.Profiler(device.type)
        sliced = driver.trace_slice(prof)
        traced = prof.read(spec.kernel_groups(cell.root))
        traced.units, traced.frames = sliced.units, sliced.frames
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    samples = driver.samples()
    driver.release()
    del driver
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = now()
    checks = check_outputs(cfg, banks, qstr, qcoh, frames, samples)
    sync(device)
    t_check = now() - t_check
    del samples
    correct = (window.attempted > 0 and window.failed == 0
               and checks["frames_checked"]["value"] >= checks["frames_checked"]["least"]
               and all(c["value"] <= c["limit"] for c in checks.values() if "limit" in c))

    rec = types.SimpleNamespace(cfg=cfg, traffic=traffic, setup_s=setup_s, window=window,
                                trace=traced, yard=yardstick)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell.root, m.name)(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    notes = [f"set-up: inputs made at {t_data} s, the driver's set-up and warm-up done at "
             f"{setup_s} s"]
    if window.latencies_s:
        lat = sorted(window.latencies_s)
        notes.append(f"frame latency over {len(lat)} frames: median "
                     f"{1e3 * lat[len(lat) // 2]} ms, max {1e3 * lat[-1]} ms")
    notes.append(f"window {window.seconds} s: {window.units} units, {window.frames} frames, "
                 f"setup {setup_s} s, check {t_check} s")
    line = {"correct": bool(correct), "attempted": window.attempted, "failed": window.failed,
            "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_us() / 1e6
        dev["window_s"] = traced.window_us / 1e6
        line["breakdown"] = traced.breakdown()
    line["checks"] = checks
    return Outcome(line, checks, notes)
