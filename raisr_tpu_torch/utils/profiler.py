"""Tracing: named spans on the profiler's clock, stage times on the host's.

Port of raisr_tpu/utils/profiler.py. The reference's only instrumentation is
a compile-time MEASURE_TIME flag wrapping processSegment with chrono prints
(reference: Raisr.cpp:42,898,1282-1287).

`span(name)` marks a stage of the program. While a torch.profiler records,
it is a `record_function` range, so the stage sits in the same Chrome trace
as the kernels and copies it launches, on the profiler's clock; otherwise it
is one shared no-op context, and costs a flag check. `Tracer.stage` is a
span that also adds its host-clock time to `Tracer.stages` when the Tracer
is enabled.

Note on timing: CUDA work is asynchronous, so a host timer around a call that
only enqueues kernels measures the enqueue. `device_fence` waits for the
device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# the context every span is while no profiler records: entered and left
# again and again, it holds no state
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in a torch.profiler trace while a
    profiler records, and does nothing otherwise. `record_function` costs
    microseconds even with no profiler running, so the flag comes first."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return record_function(name)


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


class Tracer:
    """The stream's stages: each is the span `raisr.stream.<name>`, and an
    enabled Tracer also counts it and sums its host-clock time in
    `stages[name]`."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stages: dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(f"raisr.stream.{name}"):
            if not self.enabled:
                yield
                return
            start = time.perf_counter()
            try:
                yield
            finally:
                stats = self.stages[name]
                stats.count += 1
                stats.total_s += time.perf_counter() - start
