"""Closed loop of one caller of the C ABI's Python side, as FFmpeg's
vf_raisr calls RTPU_Process: `capi_bridge.init` once on a bank folder,
then `capi_bridge.process` a frame at a time on strided planes in host
memory, the call returning when the upscaled planes are in the caller's
buffers.

Traffic parameters: a `pool` of distinct frames cycled, `row_pad` bytes
past each row's samples (the caller's line size), `warmup_units`,
`check_units` and `trace_units` frames. The tier is the configuration's
precision.
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch
from torch.profiler import record_function

from gpubench.data import write_bank_folder
from gpubench.drivers.base import Context, Reservoir, Window, now

TIERS = {"float32": 0, "bfloat16": 1, "int8": 2}
SENTINEL = 0xAB


def frames_needed(traffic: dict) -> int:
    return traffic["pool"]


class Plane:
    """A plane in a caller's buffer: `h` rows of `step` bytes, the first
    `w` samples of each in use."""

    def __init__(self, h: int, w: int, itemsize: int, pad: int):
        self.h, self.w, self.itemsize = h, w, itemsize
        self.step = w * itemsize + pad
        self.buf = np.full((h, self.step), SENTINEL, np.uint8)

    def arg(self) -> tuple:
        return (self.buf.ctypes.data, self.w, self.h, self.step)

    def view(self) -> np.ndarray:
        samples = self.buf[:, :self.w * self.itemsize]
        return samples if self.itemsize == 1 else samples.view("<u2")

    def tensor(self, device) -> torch.Tensor:
        v = np.ascontiguousarray(self.view())
        t = torch.from_numpy(v.view(np.int16) if self.itemsize == 2 else v)
        t = t.to(device)
        return t.view(torch.uint16) if self.itemsize == 2 else t


class Driver:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        t = ctx.traffic
        self.pool, self.pad = t["pool"], t["row_pad"]
        self.kept = Reservoir(t["check_units"], ctx.seed)
        self.bridge = None
        self.folder = None

    def _plane_set(self, shapes) -> tuple:
        size = 1 if self.ctx.cfg["bits"] == 8 else 2
        return tuple(Plane(h, w, size, self.pad) for h, w in shapes)

    def setup(self) -> None:
        from raisr_tpu_torch import capi_bridge

        cfg, pcfg = self.ctx.cfg, self.ctx.program_cfg
        self.folder = tempfile.mkdtemp(prefix="gpubench_bank_")
        write_bank_folder(self.folder, cfg, self.ctx.banks, self.ctx.qstr, self.ctx.qcoh)
        rc = capi_bridge.init(self.folder, float(pcfg["ratio"]), int(pcfg["bits"]),
                              int(pcfg["range"]), int(pcfg["passes"]), int(pcfg["mode"]),
                              TIERS[pcfg["dtype"]], device=str(self.ctx.device))
        if rc:
            raise RuntimeError(f"capi_bridge.init returned {rc}")
        self.bridge = capi_bridge
        self.blending = int(pcfg["blending"])
        y, u, v = self.ctx.frames
        (h, w), (ch, cw) = y.shape[1:], u.shape[1:]
        r = float(cfg["ratio"])
        self.inputs = []
        for i in range(self.pool):
            planes = self._plane_set([(h, w), (ch, cw), (ch, cw)])
            for plane, src in zip(planes, (y[i], u[i], v[i])):
                host = src.cpu()
                host = host.view(torch.int16) if host.dtype == torch.uint16 else host
                plane.view()[:] = host.numpy().view(plane.view().dtype)
            self.inputs.append(planes)
        out_shapes = [(int(h * r), int(w * r)), (int(ch * r), int(cw * r)),
                      (int(ch * r), int(cw * r))]
        # the kept sample's buffers and one to write into
        self.outputs = [self._plane_set(out_shapes) for _ in range(self.kept.k + 1)]
        self.free = list(range(len(self.outputs)))
        self.cur = self.free.pop()
        for i in range(self.ctx.traffic["warmup_units"]):
            self._call(self.inputs[i % self.pool], self.outputs[self.cur])

    def _call(self, src, dst) -> int:
        return self.bridge.process(*(p.arg() for p in src), *(p.arg() for p in dst),
                                   self.blending)

    def _frame(self, i: int, win: Window) -> None:
        t = now()
        rc = self._call(self.inputs[i % self.pool], self.outputs[self.cur])
        win.latencies_s.append(now() - t)
        win.attempted += 1
        win.failed += rc != 0
        win.units += 1
        win.frames += 1
        slot = self.kept.slot()
        if slot is not None:
            old = self.kept.items[slot]
            self.kept.put(slot, (i, self.cur))
            if old is not None:
                self.free.append(old[1])
            self.cur = self.free.pop()

    def window(self, seconds: float, spans: bool = False) -> Window:
        """Frames one after another until `seconds` have passed; each
        call returns with its planes written, so the window ends with the
        last one."""
        win = Window()
        i = 0
        t0 = now()
        end = t0 + seconds
        while now() < end:
            self._frame(i, win)
            i += 1
        win.seconds = now() - t0
        return win

    def trace_slice(self, prof) -> Window:
        win = Window()
        prof.start()
        t0 = now()
        for i in range(self.ctx.traffic["trace_units"]):
            with record_function("gpubench.frame"):
                t = now()
                self._call(self.inputs[i % self.pool], self.outputs[self.cur])
                win.latencies_s.append(now() - t)
            win.units += 1
            win.frames += 1
        win.seconds = now() - t0
        prof.stop()
        return win

    def samples(self) -> list:
        dev = self.ctx.device
        return [(i % self.pool, *(p.tensor(dev) for p in self.outputs[k]))
                for i, k in self.kept.items]

    def release(self) -> None:
        if self.bridge is not None:
            self.bridge.deinit()
            self.bridge = None
        if self.folder is not None:
            shutil.rmtree(self.folder, ignore_errors=True)
            self.folder = None
