"""Shared pieces of the benchmark's tests: the checkout's root on the path,
and cells cut to a tiny size for the CPU, where the program's fused backend
runs its plain PyTorch versions."""

from __future__ import annotations

import dataclasses
import functools
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# cells whose files are in gpubench/ but which BENCHMARK.json does not list
# yet (PERF.md, Open questions): the per-frame C ABI path
PENDING = {"x2-ffmpeg-frame": ("raisr-2x-highres-2pass-f32", "capi_frame")}


@pytest.fixture
def tiny_cell(monkeypatch):
    """A cell of BENCHMARK.json at 64x48 frames on the CPU: the program's
    fused backend (its plain versions; `auto` would take the taps form
    there), pools of at most 8 frames or batches (two distinct groups of
    the stream's 4) and short warm-ups. The C ABI's bridge gets the
    same backend through its RaisrConfig."""
    import torch

    from gpubench import spec
    from raisr_tpu_torch import RaisrConfig, capi_bridge

    torch.set_num_threads(2)
    monkeypatch.setattr(capi_bridge, "RaisrConfig",
                        functools.partial(RaisrConfig, backend="pallas"))

    def make(name: str):
        if name in PENDING:  # a cell of PERF.md's plan, from its files
            conf, traffic = PENDING[name]
            cell = spec.Cell(ROOT, name, conf, traffic, 1,
                             spec.load_json(ROOT / "gpubench/configs" / f"{conf}.json"),
                             spec.load_json(ROOT / "gpubench/traffic" / f"{traffic}.json"),
                             (), ())
        else:
            cell = spec.Bench(ROOT).cell(name)
        traffic = {**cell.traffic, "pool": min(cell.traffic["pool"], 8), "warmup_units": 4,
                   "trace_units": 8}
        cfg = {**cell.config, "height": 48, "width": 64, "backend": "pallas"}
        return dataclasses.replace(cell, config=cfg, traffic=traffic)

    return make
