"""Tracing / profiling utilities.

Port of raisr_tpu/utils/profiler.py. The reference's only instrumentation is
a compile-time MEASURE_TIME flag wrapping processSegment with chrono prints
(reference: Raisr.cpp:42,898,1282-1287). Here: structured per-stage timers, a
frames/sec meter, and torch.profiler integration (Chrome traces viewable in
Perfetto / chrome://tracing).

Note on timing: CUDA work is asynchronous, so a host timer around a call that
only enqueues kernels measures the enqueue. `device_fence` waits for the
device; a stage timed with `fence=` includes its device work.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


def device_fence(*arrays) -> None:
    """True barrier: waits for everything queued on the device of each CUDA
    tensor in `arrays`. Nothing to wait for on the CPU."""
    seen = set()
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.is_cuda and a.device not in seen:
            seen.add(a.device)
            torch.cuda.synchronize(a.device)


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Tracer:
    """Per-stage wall-clock tracing + frame throughput meter."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        self._frames = 0
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                device_fence(fence)
            self.stages[name].add(time.perf_counter() - start)

    def count_frame(self, n: int = 1):
        self._frames += n

    @property
    def fps(self) -> float:
        return self._frames / max(time.perf_counter() - self._t0, 1e-9)

    def reset(self):
        self.stages.clear()
        self._frames = 0
        self._t0 = time.perf_counter()

    def report(self) -> dict:
        return {
            "frames": self._frames,
            "fps": round(self.fps, 3),
            "stages": {
                k: {
                    "count": v.count,
                    "mean_ms": round(v.mean_s * 1e3, 3),
                    "min_ms": round(v.min_s * 1e3, 3),
                    "max_ms": round(v.max_s * 1e3, 3),
                    "total_s": round(v.total_s, 3),
                }
                for k, v in self.stages.items()
            },
        }

    def dump(self) -> str:
        return json.dumps(self.report(), indent=2)


@contextlib.contextmanager
def xprof_trace(logdir: str):
    """Capture a torch.profiler trace of the block (host, and the device's
    kernels where there is a CUDA card) and write it as a Chrome trace to
    `logdir`/trace.json (open with Perfetto or chrome://tracing). Keeps the
    name raisr_tpu gives its profiler context."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
