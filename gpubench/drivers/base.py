"""What every driver shares: the run's context, the sample of outputs kept for
the check, and the program's engine built from the benchmark's own banks.

A driver (gpubench/drivers/<entry>.py, named by a traffic file's "entry")
drives one entry point of the program: `setup` builds what the entry point
needs and warms up the cell's shapes, `window` drives it for a number of
seconds, `trace_slice` drives a bounded slice between the profiler's start
and stop, `release` drops the program's state, and `samples` hands the
kept outputs to the check.
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch


@dataclasses.dataclass
class Context:
    """What the harness hands a driver: the configuration as the program
    runs it (`program_cfg`, the cell's own unless a test overrides a key),
    the traffic's parameters, the device, the seed, and the inputs made
    from it."""

    cfg: dict
    program_cfg: dict
    traffic: dict
    device: torch.device
    seed: int
    banks: torch.Tensor
    qstr: list
    qcoh: list
    frames: tuple  # packed (Y, U, V) [n, H, W] on the device


@dataclasses.dataclass
class Window:
    """What a window or a slice completed: its length on the host clock,
    the units (steps, calls or frames) and frames done, the requests
    attempted and failed, each frame's latency, and the program's own
    spans where the driver read them."""

    seconds: float = 0.0
    units: int = 0
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)


class Reservoir:
    """A uniform sample of k of the outputs a window completed, drawn from
    the seed (algorithm R): the i-th output replaces a kept one with
    probability k / (i + 1). It holds references only, so keeping one costs
    no copy."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def slot(self) -> int | None:
        """The slot the next output goes to, or None if it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(None)
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        self.items[slot] = item


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def program_model(ctx: Context):
    """The program's RaisrModel of the benchmark's banks, in memory: each
    pass's taps padded to the program's 128-wide rows."""
    from raisr_tpu_torch.model.loader import FilterBank, RaisrModel

    bank = ctx.cfg["bank"]
    host = ctx.banks.detach().to("cpu", torch.float32).numpy()
    banks = []
    for p in range(ctx.cfg["passes"]):
        filters = np.zeros((host.shape[1], 128), np.float32)
        filters[:, :bank["taps"]] = host[p]
        banks.append(FilterBank(filters=filters, qstr=np.asarray(ctx.qstr[p], np.float32),
                                qcoh=np.asarray(ctx.qcoh[p], np.float32),
                                pixel_types=bank["pixel_types"], taps=bank["taps"],
                                source_dtype="fp32"))
    return RaisrModel(qangle=bank["qangle"], qstrength=bank["qstrength"],
                      qcoherence=bank["qcoherence"], patch_size=bank["patch_size"],
                      banks=tuple(banks))


def program_config(cfg: dict):
    """The program's RaisrConfig of a configuration file (`backend` where
    the file or a test names one, else the program's default)."""
    from raisr_tpu_torch import RaisrConfig
    from raisr_tpu_torch.config import Backend, BlendingMode, RangeType

    extra = {"backend": Backend(cfg["backend"])} if "backend" in cfg else {}
    return RaisrConfig(filterfolder="", ratio=float(cfg["ratio"]), bits=int(cfg["bits"]),
                       range=RangeType(int(cfg["range"])),
                       blending=BlendingMode(int(cfg["blending"])),
                       passes=int(cfg["passes"]), mode=int(cfg["mode"]),
                       dtype=cfg["dtype"], **extra)


def program_engine(ctx: Context):
    from raisr_tpu_torch import RaisrEngine

    return RaisrEngine(program_config(ctx.program_cfg), model=program_model(ctx),
                       device=ctx.device)
