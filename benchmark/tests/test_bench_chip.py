"""On the card: a short traced run of each cell of BENCHMARK.json that
fits the cards present, and the control at kg3.popdist's own size.  Run
from the checkout root: ``python -m pytest benchmark/tests -m chip``."""

import json
import subprocess
import sys

import pytest

from conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json")
                                       .read_text())["workloads"]]


def need_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    work = json.loads((REPO / "benchmark/workloads" / f"{cell}.json")
                      .read_text())
    need_cards(work["chips"])
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "2147483999", "--seconds", "2",
                        "--trace", "1"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == work["chips"]
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    assert 0 < out["metrics"]["kernels_roofline"]["value"] <= 100


@pytest.mark.chip
def test_control_at_the_cells_size():
    need_cards(1)
    r = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                        "kg3.popdist", "--seeds", "2147483998"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["device"].startswith("cuda")
    assert got["control_float32"]["correct"] is False
    assert got["reference_float64"]["correct"] is True
