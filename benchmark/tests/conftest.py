"""Fixtures of the benchmark's CPU tests: a temporary copy of the
benchmark with tiny configurations and cells, driven on the CPU
(``GGT_DEVICE=cpu``) in a child process by ``drive.py``.

Tests marked ``chip`` need a CUDA card; each decides inside the test
whether there is one and skips otherwise."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DRIVE = Path(__file__).resolve().parent / "drive.py"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips "
                            "without one)")


# kg3_superpops cut to a cohort of 22 in the same 5 super-populations
TINY_KG = dict(populations=[["GBR", "EUR", 4], ["YRI", "AFR", 5],
                            ["CHB", "EAS", 3], ["PEL", "AMR", 4],
                            ["GIH", "SAS", 4], ["FIN", "EUR", 2]],
               superpopulations={"AFR": 5, "AMR": 4, "EAS": 3, "EUR": 6,
                                 "SAS": 4},
               n_individuals=22, n_sites=6000, sequence_length=300000)


def tiny_configs(root: Path) -> None:
    """Small cohorts of each configuration's shape, and a cell of each
    cell's flags on them (``tiny.<cell>``, reporting the cell's metrics)."""
    cfgs = root / "benchmark" / "configs"
    kg = json.loads((cfgs / "kg3_superpops.json").read_text())
    (cfgs / "tiny_kg.json").write_text(json.dumps({**kg, **TINY_KG}))
    works = root / "benchmark" / "workloads"
    for cell in ("kg3.popdist",):
        w = json.loads((works / f"{cell}.json").read_text())
        w.update(config="tiny_kg", sites=6000)
        (works / f"tiny.{cell}.json").write_text(json.dumps(w))


def copy_benchmark(dest: Path) -> Path:
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"tiny.{c}" for c in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    tiny_configs(dest)
    return dest


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return copy_benchmark(tmp_path_factory.mktemp("bench"))


def drive(root: Path, cell: str, seed: int = 7, trace: int = 0,
          fault: str = "", seconds: float = 0.2, timeout: int = 600) -> dict:
    """Run ``cell`` of the copy at ``root`` on the CPU in a child process,
    the port broken by ``fault`` (drive.FAULTS); returns the result line."""
    env = {**os.environ, "GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, str(DRIVE), str(root), cell,
                        str(seed), str(seconds), str(trace), fault],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=root)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])
