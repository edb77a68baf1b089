"""A new cell and a new metric are files and BENCHMARK.json entries only:
a temporary copy of the benchmark gains a workload file and a metric
reader, and run.py takes both with no code edited."""

import hashlib
import json

from conftest import copy_benchmark, drive

READER = '''"""Windows planned a pass (a throwaway metric of the test)."""


def read(record):
    return float(record["windows_per_pass"])
'''


def digest(root):
    h = hashlib.sha256()
    for p in sorted((root / "benchmark").rglob("*.py")):
        if "metrics" not in p.parts:
            h.update(p.read_bytes())
    return h.hexdigest()


def test_throwaway_cell_and_metric(tmp_path):
    root = copy_benchmark(tmp_path)
    before = digest(root)
    work = json.loads((root / "benchmark/workloads/tiny.kg3.popdist.json")
                      .read_text())
    work["flags"] = ["-f", "phased", "-w", "20000", "-m", "10",
                     "--roundTo", "10", "--analysis", "popDist",
                     "-p", "EUR", "-p", "AFR", "--popsFile", "{pops}"]
    work["traffic"] = "throwaway_w20kb"
    (root / "benchmark/workloads/throwaway.json").write_text(json.dumps(work))
    (root / "benchmark/metrics/windows_planned.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "throwaway", "config": "tiny_kg",
                               "traffic": "throwaway_w20kb", "chips": 1,
                               "why": "a throwaway cell of the test"})
    bench["per_layer"].append({
        "name": "windows_planned", "unit": "windows", "better": "higher",
        "source": "program_counter", "layer": "plan", "moves": "sites_per_s",
        "workloads": ["throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert digest(root) == before
    traced = drive(root, "throwaway", trace=1)
    assert traced["correct"], traced["compared"]
    assert traced["metrics"]["windows_planned"] == {"value": 15.0,
                                                    "unit": "windows"}
    plain = drive(root, "throwaway", trace=0)
    assert set(plain["metrics"]) == {"sites_per_s", "setup_s"}
