"""The control comes out not correct, on the card, at each cell's own sizes
and load, for every cell of BENCHMARK.json: `calibrate.control_overrides`
of the cell's configuration (its file's own "control", else the program's
own lower-precision path: the bf16 tier for a float32 configuration) in
place of the configuration's, on three seeds,
held to the same exact comparison that decides `correct`. A sound run of
the same cell beside it comes out correct.

    python -m pytest gpubench/tests/test_gpubench_control.py -q -s
"""

from __future__ import annotations

import pytest
import torch
from conftest import ROOT, cells

from gpubench import calibrate, spec

pytestmark = pytest.mark.cuda

SEEDS = [3_700_000_001, 3_700_104_731, 3_700_209_461]


@pytest.mark.parametrize("name", cells(pending=False))
def test_control_fails_and_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs the cell at its own size")
    device = torch.device("cuda", 0)
    cell = spec.Bench(ROOT).cell(name)
    sound = calibrate.readings(cell, SEEDS[:1], 1.0, device)
    assert sound[0]["correct"], sound
    control = calibrate.readings(cell, SEEDS, 1.0, device,
                                 calibrate.control_overrides(cell.config))
    assert not any(r["correct"] for r in control), control
    assert min(r["differing"] for r in control) > 0
