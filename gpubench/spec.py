"""The benchmark's registry: BENCHMARK.json at the root of the checkout, and
the files it names under gpubench/.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name:

  configs:   the file a `configs` entry names (gpubench/configs/<name>.json)
  traffic:   gpubench/traffic/<traffic>.json, parameters for the driver
             gpubench/drivers/<entry>.py that its "entry" names
  reference: gpubench/reference/<module>.py, the plain reference that a
             configuration's "reference" names
  metrics:   gpubench/metrics/<metric name>.py, a reader with read(run)
  kernels:   gpubench/kernel_groups.json, kernel names to groups and layers

So a later change adds a configuration, a cell or a metric by adding files
and entries, and edits no code. Imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

PATH = "gpubench"  # the benchmark's folder in a checkout
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    """A BENCHMARK.json, or a file it names, outside the benchmark's rules."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{what} {name!r} is not a name: 1 to 64 of A-Z a-z 0-9 _ . -, "
                        "not starting with . or -")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise SpecError(f"unit {unit!r} of {what} is not a unit: 1 to 16 of "
                        "A-Z a-z 0-9 _ / % . -")
    return unit


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" | "per_layer"
    workloads: tuple | None
    moves: str | None = None
    layer: str | None = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    root: pathlib.Path
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


class Bench:
    """BENCHMARK.json of the checkout at `root`, checked against the rules
    the harness relies on."""

    def __init__(self, root: pathlib.Path | str):
        self.root = pathlib.Path(root)
        path = self.root / "BENCHMARK.json"
        try:
            self.raw = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            raise SpecError(f"cannot read {path}: {e}") from e
        self.configs = {}
        for c in self.raw["configs"]:
            check_name(c["name"], "config")
            for key in c.get("reduced", []):
                check_name(key, "reduced key")
            self.configs[c["name"]] = c
        self.metrics = {}
        for kind in ("end_to_end", "per_layer"):
            for m in self.raw[kind]:
                check_name(m["name"], "metric")
                check_unit(m["unit"], m["name"])
                if m["better"] not in ("lower", "higher"):
                    raise SpecError(f"metric {m['name']}: better is {m['better']!r}")
                if m["source"] not in SOURCES:
                    raise SpecError(f"metric {m['name']}: source {m['source']!r}")
                if m["name"] in self.metrics:
                    raise SpecError(f"metric {m['name']} appears twice")
                wl = m.get("workloads")
                self.metrics[m["name"]] = Metric(
                    m["name"], m["unit"], m["better"], m["source"], kind,
                    tuple(wl) if wl is not None else None, m.get("moves"), m.get("layer"))
        self.workloads = {}
        for w in self.raw["workloads"]:
            for key in ("name", "config", "traffic"):
                check_name(w[key], f"workload {key}")
            if w["name"] in self.workloads:
                raise SpecError(f"workload {w['name']} appears twice")
            if w["config"] not in self.configs:
                raise SpecError(f"workload {w['name']}: no config {w['config']!r}")
            self.workloads[w["name"]] = w

    def cell_names(self) -> list[str]:
        return list(self.workloads)

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json "
                            f"(have {', '.join(self.workloads)})")
        w = self.workloads[name]
        conf = self.configs[w["config"]]
        config = load_json(self.root / conf["file"])
        traffic = load_json(self.root / PATH / "traffic" / f"{w['traffic']}.json")
        e2e = tuple(m for m in self.metrics.values()
                    if m.kind == "end_to_end" and m.applies_to(name))
        layer = tuple(m for m in self.metrics.values()
                      if m.kind == "per_layer" and m.applies_to(name))
        for m in e2e + layer:
            reader_path(self.root, m.name)  # every metric has its reader
        return Cell(self.root, name, w["config"], w["traffic"], int(w["chips"]), config, traffic,
                    e2e, layer)


def load_json(path: pathlib.Path) -> dict:
    try:
        return json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError) as e:
        raise SpecError(f"cannot read {path}: {e}") from e


def reader_path(root: pathlib.Path, metric: str) -> pathlib.Path:
    path = pathlib.Path(root) / PATH / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise SpecError(f"metric {metric} has no reader {path}")
    return path


def reader(root: pathlib.Path, metric: str):
    """The `read(run)` function of gpubench/metrics/<metric>.py."""
    path = reader_path(root, metric)
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_groups(root: pathlib.Path) -> list[dict]:
    """gpubench/kernel_groups.json: [{"match", "group", "layer"}], the first
    entry whose `match` is in a kernel's name names its group."""
    return load_json(pathlib.Path(root) / PATH / "kernel_groups.json")["groups"]
