"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every import statement of every
module under gpubench/, compared by whole top-level name."""

from __future__ import annotations

import ast

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "raisr_tpu", "chip_smoke", "bench"}
SOURCES = sorted((ROOT / "gpubench").rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "gpubench/reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "raisr_tpu_torch" not in names
    assert names <= {"__future__", "math", "numpy", "torch"}


def test_whole_names_tell_the_port_from_the_jax_package(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import raisr_tpu_torch.engine\nfrom raisr_tpu_torch import capi_bridge\n")
    assert not top_level_imports(src) & FORBIDDEN
    src.write_text("from raisr_tpu.ops import pallas\n")
    assert top_level_imports(src) & FORBIDDEN == {"raisr_tpu"}
