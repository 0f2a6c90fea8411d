"""The benchmark is driven by data: BENCHMARK.json names every cell, and a
configuration, a cell and a per-layer metric are added as files; names and
units are held to the benchmark's rules; without a card no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import pytest
from conftest import ROOT

from gpubench import spec

CELLS = ["x2-resident", "x15-resident", "x2-stream"]


def test_every_cell_resolves():
    bench = spec.Bench(ROOT)
    assert bench.cell_names() == CELLS
    for name in CELLS:
        cell = bench.cell(name)
        assert cell.chips == 1
        assert cell.traffic["entry"] in ("batch_device", "capi_process", "stream")
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        # each per-layer metric moves an end-to-end metric the cell reports
        for m in cell.per_layer:
            assert m.moves in names, (name, m.name)


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_added_files_are_found(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries; the harness lists and
    resolves them with no edit to its code."""
    root = _copy(tmp_path)
    cfg = json.loads((root / "gpubench/configs/raisr-2x-highres-2pass-f32.json").read_text())
    cfg.update(name="raisr-2x-10bit", bits=10)
    (root / "gpubench/configs/raisr-2x-10bit.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "gpubench/traffic/resident.json").read_text())
    traffic.update(batch=1)
    (root / "gpubench/traffic/resident-b1.json").write_text(json.dumps(traffic))
    (root / "gpubench/metrics/frames_per_step.py").write_text(
        "def read(run):\n    return run.window.frames / run.window.units\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "raisr-2x-10bit", "source": "https://example.org/x",
                             "file": "gpubench/configs/raisr-2x-10bit.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "x2-10bit-b1", "config": "raisr-2x-10bit",
                               "traffic": "resident-b1", "chips": 1, "why": "a throwaway"})
    bench["end_to_end"][0]["workloads"].append("x2-10bit-b1")
    bench["per_layer"].append({"name": "frames_per_step", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "Engine step",
                               "moves": "frames_per_s", "workloads": ["x2-10bit-b1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.Bench(root)
    assert b.cell_names() == CELLS + ["x2-10bit-b1"]
    cell = b.cell("x2-10bit-b1")
    assert cell.config["bits"] == 10 and cell.traffic["batch"] == 1
    assert [m.name for m in cell.per_layer] == ["frames_per_step"]
    run = types.SimpleNamespace(window=types.SimpleNamespace(frames=12, units=12))
    assert spec.reader(root, "frames_per_step")(run) == 1
    # the cells that were there keep their metrics
    assert [m.name for m in b.cell("x2-resident").per_layer] == \
        [m.name for m in spec.Bench(ROOT).cell("x2-resident").per_layer]


@pytest.mark.parametrize("bad", ["", "has space", "comma,name", "slash/name", ".dot",
                                 "-dash", "x" * 65, "µs", "tab\tname"])
def test_bad_names_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "metric")


@pytest.mark.parametrize("bad", ["", "tokens per second", "x" * 17, "µs", "ms,"])
def test_bad_units_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_unit(bad, "m")


@pytest.mark.parametrize("good", ["frames/s", "%", "ms", "s", "GiB", "tokens/s"])
def test_units_taken(good):
    assert spec.check_unit(good, "m") == good


def test_a_bad_name_in_the_file_is_refused(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"][0]["unit"] = "frames per second"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError):
        spec.Bench(root)


def test_a_metric_without_its_reader_is_refused(tmp_path):
    root = _copy(tmp_path)
    (root / "gpubench/metrics/pass_roofline.py").unlink()
    with pytest.raises(spec.SpecError):
        spec.Bench(root).cell("x2-resident")


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    sys.path.insert(0, str(ROOT / "gpubench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "gpubench"))
    for name in ("raisr_tpu_torch", "raisr_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"raisr_tpu_torch", "raisr_tpu_torch.engine", "jaxtyping", "flaxen"} & \
        set(run.loaded_forbidden())
    for name in ("raisr_tpu.ops", "jax", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name in run.loaded_forbidden()


def _run(root):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "x2-resident", "--seed",
         "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and gpubench/, a run
    exits nonzero and prints nothing on standard output."""
    proc = _run(_copy(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert proc.stderr


def test_no_card_no_result():
    """Without a CUDA card a run exits nonzero and prints no result; it
    never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(ROOT)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA card" in proc.stderr
