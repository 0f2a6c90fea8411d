"""A torch.profiler trace of a slice of the run, read back: device operations
by group, the busy union, idle gaps and what the host was doing in them.

`union_us`, the kernel grouping and the busy share over the traced window
are copied from chip_smoke.py (`_union_us`, `kernel_groups`,
`profile_steps`); the groups come from gpubench/kernel_groups.json.
Imports nothing of the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
RANGE_PREFIX = "gpubench."


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merged(spans))


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    ts: float  # microseconds
    dur: float

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class TraceData:
    """The slice's events: device operations, host events, and the harness's
    own `gpubench.*` ranges; `units` and `frames` the slice completed."""

    device: list
    host: list
    ranges: list
    groups: list
    units: int = 0
    frames: int = 0
    _sorted: list | None = dataclasses.field(default=None, repr=False)

    @property
    def t0(self) -> float:
        return min(e.ts for e in self.ranges)

    @property
    def t1(self) -> float:
        return max([e.end for e in self.ranges] + [e.end for e in self.device])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def clipped(self, events, lo: float | None = None, hi: float | None = None):
        lo = self.t0 if lo is None else lo
        hi = self.t1 if hi is None else hi
        return [(max(e.ts, lo), min(e.end, hi)) for e in events if e.end > lo and e.ts < hi]

    def busy_us(self, lo: float | None = None, hi: float | None = None) -> float:
        """The union of device operations inside [lo, hi] (the window)."""
        return union_us(self.clipped(self.device, lo, hi))

    def group_of(self, name: str) -> tuple[str, str]:
        """(group, layer) of a device operation by the first matching entry
        of kernel_groups.json; (the name, "other") without one."""
        for g in self.groups:
            if g["match"] in name:
                return g["group"], g["layer"]
        return name[:80], "other"

    def layer_us(self, layer: str) -> float:
        """Device microseconds of the operations of `layer`."""
        return sum(e.dur for e in self.device if self.group_of(e.name)[1] == layer)

    def group_us(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for e in self.device:
            g = self.group_of(e.name)[0]
            out[g] = out.get(g, 0.0) + e.dur
        return out

    def idle_gaps(self) -> list[tuple[float, float]]:
        """Intervals of the window in which no device operation ran."""
        gaps, cur = [], self.t0
        for s, e in merged(self.clipped(self.device)):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        return gaps

    def host_at(self, t: float) -> str:
        """What the host was doing at time t: the innermost harness range and
        the innermost other host event around t (of nested events, the one
        that contains t and started last)."""
        if self._sorted is None:
            self._sorted = [sorted(self.ranges, key=lambda e: e.ts),
                            sorted((e for e in self.host if not e.name.startswith(RANGE_PREFIX)),
                                   key=lambda e: e.ts)]
        names = []
        for events in self._sorted:
            i = bisect.bisect_right(events, t, key=lambda e: e.ts)
            found = None
            for e in reversed(events[max(0, i - 512):i]):
                if e.end > t:
                    found = e.name
                    break
            names.append(found)
        rng = names[0] or "outside"
        return f"{rng} / {names[1]}" if names[1] else rng

    def breakdown(self, top: int = 10) -> dict:
        """The device operation groups with the most time, and the idle time
        by what the host was doing, in seconds, at most `top` each."""
        ops = sorted(self.group_us().items(), key=lambda kv: -kv[1])[:top]
        idle: dict[str, float] = {}
        for s, e in self.idle_gaps():
            label = self.host_at(s)
            idle[label] = idle.get(label, 0.0) + (e - s)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v / 1e6] for k, v in ops],
                "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


def read_trace(path: str, groups: list) -> TraceData:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, ranges = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(str(e.get("name", "")), str(e.get("cat", "")), float(e["ts"]),
                   float(e["dur"]))
        if ev.cat in DEVICE_CATS:
            device.append(ev)
        elif ev.cat in HOST_CATS:
            host.append(ev)
            if ev.name.startswith(RANGE_PREFIX) and ev.cat == "user_annotation":
                ranges.append(ev)
    return TraceData(device, host, ranges, groups)


class Profiler:
    """torch.profiler over a slice the driver chooses (start, stop), its
    trace written under TMPDIR and deleted once read."""

    def __init__(self, device_type: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def read(self, groups: list) -> TraceData:
        fd, path = tempfile.mkstemp(prefix="gpubench_trace_", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return read_trace(path, groups)
        finally:
            os.unlink(path)
