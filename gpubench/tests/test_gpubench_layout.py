"""The benchmark is driven by data: BENCHMARK.json names every cell, and a
configuration, a cell and a per-layer metric are added as files and
entries; names and units are held to the benchmark's rules; without a card
no result.

A change that adds a configuration and its cell (a `model_config` change)
edits no file that is already here. It adds:

- the configuration's file under gpubench/configs/, with the program's
  settings and the `reference` module that checks it, and a `"control"`
  object (the program's keys to override for the control) where the
  program has no lower tier of its dtype (gpubench/calibrate.py);
- a reference module under gpubench/reference/ where its tier needs one:
  `Reference(cfg, banks, qstr, qcoh)` with `luma` and `chroma`, and
  `compare(got, want)`, as `harness.check_outputs` calls them;
- its own CPU test file under gpubench/tests/ for what is new in it;
- its entries in BENCHMARK.json: the configuration, the cell, and the
  cell's name in the `workloads` of each end-to-end and per-layer metric
  it reports.

The tests take their cells and configurations from BENCHMARK.json
(conftest.py `cells`, `configs`), so the new cell then gets with no edit:
the layout checks here, its sound run and planted faults on the CPU
(test_gpubench_faults.py), its configuration against its reference
(test_gpubench_reference.py), a control that resolves (here) and the
control on the card (test_gpubench_control.py).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import types

import pytest
from conftest import ROOT, cells, config_file, configs
from test_gpubench_faults import altered, run_cell

from gpubench import calibrate, spec


def check_cell(name, root=ROOT):
    """The cell resolves, with its driver, configuration file and reference
    module; it reports setup_s and another end-to-end metric, and a
    per-layer metric each of which moves one of them."""
    cell = spec.Bench(root).cell(name)  # its configuration and traffic files read
    assert cell.chips in (1, 4)
    assert (root / spec.PATH / "drivers" / f"{cell.traffic['entry']}.py").is_file()
    assert (root / spec.PATH / "reference" / f"{cell.config['reference']}.py").is_file()
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m.moves in names, (name, m.name)


@pytest.mark.parametrize("name", cells(pending=False))
def test_every_cell_resolves(name):
    check_cell(name)


def test_cells_are_listed_once():
    listed, every = cells(pending=False), cells()
    assert listed
    assert len(set(every)) == len(every)


@pytest.mark.parametrize("config", configs())
def test_every_configuration_has_a_control(config):
    """The control of every configuration in use resolves, and changes what
    the program runs."""
    cfg = config_file(config)
    overrides = calibrate.control_overrides(cfg)
    assert overrides
    assert any(cfg.get(k) != v for k, v in overrides.items()), overrides


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
    assert b.cell_names() == spec.Bench(ROOT).cell_names() + ["x2-10bit-b1"]
    assert cells(pending=False, root=root) == b.cell_names()
    cell = b.cell("x2-10bit-b1")
    assert cell.config["bits"] == 10 and cell.traffic["batch"] == 1
    assert [m.name for m in cell.per_layer] == ["frames_per_step"]
    run = types.SimpleNamespace(window=types.SimpleNamespace(frames=12, units=12))
    assert spec.reader(root, "frames_per_step")(run) == 1
    # the cells that were there keep their metrics
    assert [m.name for m in b.cell("x2-resident").per_layer] == \
        [m.name for m in spec.Bench(ROOT).cell("x2-resident").per_layer]


def test_a_configuration_and_its_cell_are_added_as_files_and_entries(tmp_path, tiny_cell,
                                                                     monkeypatch):
    """A mode-2 10-bit configuration with its resident cell, and an int8
    configuration with a control of its own, added to a copied checkout as
    new files and entries only: the lists take up the cell and its
    configuration, the cell resolves, its sound run at 64x48 is correct and
    a planted fault is caught; the int8 configuration's control resolves,
    and without it the error names the configuration."""
    from raisr_tpu_torch.engine import RaisrEngine

    root = _copy(tmp_path)
    base = json.loads((root / "gpubench/configs/raisr-2x-highres-2pass-f32.json").read_text())
    mode2 = {**base, "name": "raisr-2x-mode2-10bit", "mode": 2, "bits": 10}
    # no lower tier of int8 in the program: the file states its control (a
    # throwaway here, the full range in place of the video range)
    int8 = {**base, "name": "raisr-2x-int8", "dtype": "int8", "control": {"range": 1}}
    for cfg in (mode2, int8):
        (root / "gpubench/configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    name = "x2-mode2-10bit-resident"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": mode2["name"], "source": "https://example.org/x",
                             "file": f"gpubench/configs/{mode2['name']}.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": name, "config": mode2["name"], "traffic": "resident",
                               "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # what x2-resident reports
        if "x2-resident" in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert name in cells(root=root)
    assert name in cells({"batch_device", "stream"}, root=root)
    assert name in cells(pending=False, root=root)
    assert mode2["name"] in configs(root=root)
    check_cell(name, root)
    out = run_cell(tiny_cell(name, root))
    assert out.line["correct"], out.checks
    monkeypatch.setattr(RaisrEngine, "process_batch_device",
                        altered(RaisrEngine.process_batch_device))
    out = run_cell(tiny_cell(name, root))
    assert not out.line["correct"]
    assert out.checks["differing"]["value"] > 0

    assert calibrate.control_overrides(int8) == {"range": 1}
    del int8["control"]
    with pytest.raises(ValueError, match=int8["name"]):
        calibrate.control_overrides(int8)


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
