"""The control (the reference in float32, control.py) comes out not
correct by the cell's limits, and the float64 reference through the
CSV's rounding comes out correct, at a size a test run holds."""

import os
import subprocess
import sys
import json

import pytest

from conftest import REPO


@pytest.mark.parametrize("cell", ["tiny.kg3.popdist"])
def test_control_fails_and_reference_passes(tiny_bench, cell):
    env = {**os.environ, "GGT_DEVICE": "cpu", "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                        cell, "--seeds", "1,2,3"], cwd=tiny_bench, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    for line in r.stdout.strip().splitlines():
        got = json.loads(line)
        assert got["control_float32"]["correct"] is False
        assert got["control_float32"]["max_gap"] > 1e-8
        assert got["reference_float64"]["correct"] is True
