"""No module that a run of the benchmark loads has the top-level name jax,
jaxlib, flax or genomics_general_tpu (compared whole, so the port's
genomics_general_tpu_torch passes), and the references import nothing of
the port."""

import ast
from pathlib import Path

from conftest import BENCH, drive
from benchmark.harness import cell

FORBIDDEN = {"jax", "jaxlib", "flax", "genomics_general_tpu"}


def test_forbidden_names_compare_whole():
    assert cell.FORBIDDEN == ("jax", "jaxlib", "flax", "genomics_general_tpu")
    import sys
    sys.modules.setdefault("genomics_general_tpu_torch_probe", object())
    assert "genomics_general_tpu" not in cell.forbidden_modules()


def test_a_run_loads_no_jax(tiny_bench):
    # run.emit refuses (exit 3) when any is loaded: a result line means none
    out = drive(tiny_bench, "tiny.kg3.popdist", trace=1)
    assert out["correct"]


def imports_of(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_references_no_port():
    for path in BENCH.rglob("*.py"):
        assert not imports_of(path) & FORBIDDEN, path
    for sub in ("reference", "gen"):
        for path in (BENCH / sub).glob("*.py"):
            assert "genomics_general_tpu_torch" not in imports_of(path), path
            assert "genomics_general_tpu_torch" not in path.read_text(), path
