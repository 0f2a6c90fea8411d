"""A run with its timed path broken underneath comes out not correct: the
harness's whole run (inputs, set-up, window, the kept sample, the check)
on the CPU at a tiny size, the look for a card skipped, with each fault a
cell can have planted in the program's entry point. The exchange between
cards is no fault of these one-card cells. The cells are BENCHMARK.json's
and PENDING's (conftest.py), each with the faults of its traffic file's
entry point."""

from __future__ import annotations

import pytest
import torch
from conftest import cells

from gpubench import harness

BATCHED = cells({"batch_device", "stream"})
PER_FRAME = cells({"capi_process"})


def stale(entry):
    """The entry point hands back the outputs of the call before (its state
    unchanged)."""
    last = []

    def run(self, *a, **k):
        out = entry(self, *a, **k)
        prev = last[0] if last else out
        last[:] = [out]
        return prev
    return run


def half_batch(step):
    """The second half of the batch left out (zeros in its place)."""
    def run(self, *a, **k):
        y, u, v = step(self, *a, **k)
        n = y.shape[0]
        for t in (y, u, v):
            t[n - n // 2:] = 0
        return y, u, v
    return run


def altered(step):
    """One output sample of every step changed where it is produced."""
    def run(self, *a, **k):
        y, u, v = step(self, *a, **k)
        # uint16 planes through their int16 view, which every device adds in
        (y.view(torch.int16) if y.dtype == torch.uint16 else y)[0, 7, 9] += 1
        return y, u, v
    return run


def frame_half(process):
    """Half of the frame's rows left out."""
    def run(self, frame):
        out = process(self, frame)
        out.y[out.y.shape[0] // 2:] = 0
        return out
    return run


def frame_altered(process):
    def run(self, frame):
        out = process(self, frame)
        out.y[7, 9] += 1
        return out
    return run


def run_cell(cell, seed=2**31 + 17):
    return harness.run(cell, seed, 0.4, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", cells())
def test_sound_run_is_correct(tiny_cell, name):
    out = run_cell(tiny_cell(name))
    assert out.line["correct"], out.checks
    assert out.checks["differing"]["value"] == 0


@pytest.mark.parametrize("fault", [stale, half_batch, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", BATCHED)
def test_batched_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    from raisr_tpu_torch.engine import RaisrEngine

    monkeypatch.setattr(RaisrEngine, "process_batch_device",
                        fault(RaisrEngine.process_batch_device))
    out = run_cell(tiny_cell(name))
    assert not out.line["correct"]
    assert out.checks["differing"]["value"] > 0


# an id is the fault's name while one cell takes the per-frame path
@pytest.mark.parametrize("name,fault", [
    pytest.param(n, f, id=f.__name__ if len(PER_FRAME) == 1 else f"{n}-{f.__name__}")
    for n in PER_FRAME for f in (stale, frame_half, frame_altered)])
def test_per_frame_fault_is_caught(tiny_cell, monkeypatch, name, fault):
    from raisr_tpu_torch.engine import RaisrEngine

    monkeypatch.setattr(RaisrEngine, "process", fault(RaisrEngine.process))
    out = run_cell(tiny_cell(name))
    assert not out.line["correct"]
    assert out.checks["differing"]["value"] > 0
