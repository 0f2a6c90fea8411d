"""Closed loop of the file-to-file and pipe user's path,
`StreamProcessor.process`: packed YUV420 frames in pageable host memory
handed in one after another, `batch` frames a dispatch, `depth` dispatches
in flight, the upscaled planes yielded in host memory and dropped.

Traffic parameters: `batch`, `depth`, a `pool` of distinct frames cycled,
`warmup_units`, `check_units` and `trace_units` frames. A frame's latency
runs from when the stream takes it from the caller's iterator to when its
upscaled planes are yielded.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from gpubench.drivers.base import Context, Reservoir, Window, now, program_engine


def frames_needed(traffic: dict) -> int:
    return traffic["pool"]


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return t.view(torch.int16).numpy().view("<u2") if t.dtype == torch.uint16 else t.numpy()


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.traffic
        self.batch, self.depth, self.pool = t["batch"], t["depth"], t["pool"]
        self.kept = Reservoir(t["check_units"], ctx.seed)
        self.engine = None

    def setup(self) -> None:
        from raisr_tpu_torch.engine import Frame

        self.engine = program_engine(self.ctx)
        y, u, v = self.ctx.frames
        self.inputs = [Frame(y=_host(y[i]), u=_host(u[i]), v=_host(v[i]))
                       for i in range(self.pool)]
        # a frame kept for the check holds its group's pinned output planes,
        # so the window holds up to `check_units` groups' planes besides the
        # stream's own: the warm-up holds as many, so that the pinned pool
        # is grown here and not by the page-locking of new blocks in the window
        n = max(self.ctx.traffic["warmup_units"], self.batch * (self.kept.k + self.depth + 2))
        held = []
        frames = self._stream(None).process(self.inputs[i % self.pool] for i in range(n))
        for j, frame in enumerate(frames):
            if j % self.batch == 0 and len(held) < self.kept.k:
                held.append(frame)
        del held

    def _stream(self, tracer):
        from raisr_tpu_torch.stream import StreamProcessor

        return StreamProcessor(self.engine, depth=self.depth, batch=self.batch, tracer=tracer)

    def window(self, seconds: float, spans: bool = False) -> Window:
        """Frames handed in until `seconds` have passed (to the end of a
        batch), then the stream drained; the window ends with the last
        frame yielded."""
        from raisr_tpu_torch.utils.profiler import Tracer

        tracer = Tracer(enabled=spans)
        taken: list[float] = []
        win = Window()
        pool, inputs, batch, kept = self.pool, self.inputs, self.batch, self.kept

        def feed():
            i = 0
            while now() < end or i % batch:
                taken.append(now())
                yield inputs[i % pool]
                i += 1

        t0 = now()
        end = t0 + seconds
        for j, frame in enumerate(self._stream(tracer).process(feed())):
            win.latencies_s.append(now() - taken[j])
            slot = kept.slot()
            if slot is not None:
                kept.put(slot, (j, frame))
        win.seconds = now() - t0
        win.units = win.frames = win.attempted = len(win.latencies_s)
        win.failed = len(taken) - win.frames
        if spans:
            win.spans = {k: {"count": s.count, "total_s": s.total_s}
                         for k, s in tracer.stages.items()}
        return win

    def trace_slice(self, prof) -> Window:
        """`trace_units` frames traced in the middle of a stream: the
        profiler starts once the pipeline is full and stops before it
        drains."""
        units = self.ctx.traffic["trace_units"]
        lead = self.batch * (self.depth + 2)
        total = lead + units + lead
        win = Window()
        rng = record_function("gpubench.stream")
        t0 = 0.0
        stream = self._stream(None).process(self.inputs[i % self.pool] for i in range(total))
        for j, _ in enumerate(stream):
            if j == lead:
                prof.start()
                rng.__enter__()
                t0 = now()
            elif j == lead + units:
                win.seconds = now() - t0
                rng.__exit__(None, None, None)
                prof.stop()
            if lead <= j < lead + units:
                with record_function("gpubench.take"):
                    win.units += 1
                    win.frames += 1
        return win

    def samples(self) -> list:
        dev = self.ctx.device

        def put(a):
            a = np.ascontiguousarray(a)
            t = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a).to(dev)
            return t.view(torch.uint16) if a.dtype == np.uint16 else t

        return [(j % self.pool, put(f.y), put(f.u), put(f.v)) for j, f in self.kept.items]

    def release(self) -> None:
        self.engine = None
