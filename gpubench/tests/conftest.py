"""Shared pieces of the benchmark's tests: the checkout's root on the path,
the lists of cells and configurations that every test takes from the
checkout's BENCHMARK.json, and cells cut to a tiny size for the CPU, where
the program's fused backend runs its plain PyTorch versions."""

from __future__ import annotations

import dataclasses
import functools
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import spec  # noqa: E402

# cells whose files are in gpubench/ but which BENCHMARK.json does not list
# yet (PERF.md, Open questions): the per-frame C ABI path
PENDING = {"x2-ffmpeg-frame": ("raisr-2x-highres-2pass-f32", "capi_frame")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason without one")


def _rows(root: pathlib.Path, pending: bool) -> list[tuple[str, str, str]]:
    """(cell, configuration, traffic) of BENCHMARK.json's cells in its
    order, then PENDING's that it does not list."""
    bench = spec.Bench(root)
    rows = [(w["name"], w["config"], w["traffic"]) for w in bench.raw["workloads"]]
    if pending:
        rows += [(n, c, t) for n, (c, t) in PENDING.items() if n not in bench.workloads]
    return rows


def _traffic(root: pathlib.Path, name: str) -> dict:
    return spec.load_json(root / spec.PATH / "traffic" / f"{name}.json")


def cells(entries=None, pending: bool = True, root: pathlib.Path = ROOT) -> list[str]:
    """The cells of the checkout at `root` (PENDING's too, unless `pending`
    is false), those whose traffic file's "entry" is in `entries` where it
    is given."""
    return [n for n, _, t in _rows(root, pending)
            if entries is None or _traffic(root, t)["entry"] in entries]


def configs(entries=None, root: pathlib.Path = ROOT) -> list[str]:
    """The configurations that `cells(entries)` use, each once, in the
    order of their first cell."""
    wanted = set(cells(entries, root=root))
    return list(dict.fromkeys(c for n, c, _ in _rows(root, True) if n in wanted))


def config_file(name: str, root: pathlib.Path = ROOT) -> dict:
    """The file of a configuration of BENCHMARK.json, as the harness reads it."""
    return spec.load_json(root / spec.Bench(root).configs[name]["file"])


def resolve(name: str, root: pathlib.Path = ROOT) -> spec.Cell:
    """A cell of the checkout at `root`: BENCHMARK.json's, or one of
    PENDING's from its files, with no metrics."""
    bench = spec.Bench(root)
    if name in bench.workloads or name not in PENDING:
        return bench.cell(name)
    conf, traffic = PENDING[name]
    return spec.Cell(root, name, conf, traffic, 1, config_file(conf, root),
                     _traffic(root, traffic), (), ())


@pytest.fixture
def tiny_cell(monkeypatch):
    """A cell at 64x48 frames on the CPU: the program's fused backend (its
    plain versions; `auto` would take the taps form there), pools of at
    most 8 frames or batches (two distinct groups of the stream's 4) and
    short warm-ups. The C ABI's bridge gets the same backend through its
    RaisrConfig."""
    import torch

    from raisr_tpu_torch import RaisrConfig, capi_bridge

    torch.set_num_threads(2)
    monkeypatch.setattr(capi_bridge, "RaisrConfig",
                        functools.partial(RaisrConfig, backend="pallas"))

    def make(name: str, root: pathlib.Path = ROOT):
        cell = resolve(name, root)
        traffic = {**cell.traffic, "pool": min(cell.traffic["pool"], 8), "warmup_units": 4,
                   "trace_units": 8}
        cfg = {**cell.config, "height": 48, "width": 64, "backend": "pallas"}
        return dataclasses.replace(cell, config=cfg, traffic=traffic)

    return make
