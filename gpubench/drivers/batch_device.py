"""Closed loop of the device-resident serving step,
`RaisrEngine.process_batch_device`: batches of packed Y, U and V already
on the card, outputs left on the card, steps back to back.

Traffic parameters: `batch` frames a step, a `pool` of distinct batches
cycled, `warmup_units` steps of warm-up, `check_units` steps kept for the
check, `trace_units` steps traced.
"""

from __future__ import annotations

from torch.profiler import record_function

from gpubench.drivers.base import Context, Reservoir, Window, now, program_engine, sync


def frames_needed(traffic: dict) -> int:
    return traffic["batch"] * traffic["pool"]


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.traffic
        self.batch, self.pool = t["batch"], t["pool"]
        self.kept = Reservoir(t["check_units"], ctx.seed)
        self.engine = None

    def setup(self) -> None:
        self.engine = program_engine(self.ctx)
        b = self.batch
        y, u, v = self.ctx.frames
        self.inputs = [(y[i * b:(i + 1) * b], u[i * b:(i + 1) * b], v[i * b:(i + 1) * b])
                       for i in range(self.pool)]
        for i in range(self.ctx.traffic["warmup_units"]):
            self.engine.process_batch_device(*self.inputs[i % self.pool])
        sync(self.ctx.device)

    def window(self, seconds: float, spans: bool = False) -> Window:
        """Steps back to back until `seconds` have passed on the host, then a
        synchronize: every step enqueued is counted, and the window ends
        when the last one has finished."""
        step, inputs, pool, kept = self.engine.process_batch_device, self.inputs, self.pool, self.kept
        n = 0
        t0 = now()
        end = t0 + seconds
        while True:
            out = step(*inputs[n % pool])
            slot = kept.slot()
            if slot is not None:
                kept.put(slot, (n, out))
            n += 1
            if now() >= end:
                break
        sync(self.ctx.device)
        frames = n * self.batch
        return Window(seconds=now() - t0, units=n, frames=frames, attempted=frames)

    def trace_slice(self, prof) -> Window:
        step, inputs, pool = self.engine.process_batch_device, self.inputs, self.pool
        units = self.ctx.traffic["trace_units"]
        sync(self.ctx.device)
        prof.start()
        t0 = now()
        for n in range(units):
            with record_function("gpubench.step"):
                step(*inputs[n % pool])
        with record_function("gpubench.sync"):
            sync(self.ctx.device)
        t1 = now()
        prof.stop()
        return Window(seconds=t1 - t0, units=units, frames=units * self.batch)

    def samples(self) -> list:
        """(pool frame, Y, U, V) of every frame of the kept steps."""
        out = []
        for n, (oy, ou, ov) in self.kept.items:
            first = (n % self.pool) * self.batch
            out += [(first + j, oy[j], ou[j], ov[j]) for j in range(self.batch)]
        return out

    def release(self) -> None:
        self.engine = self.inputs = None
