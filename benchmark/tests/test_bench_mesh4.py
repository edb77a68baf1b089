"""The four-card cell ``kg3.popdist.mesh4``: its configuration and cell
load by name, every seed plans the same 24 windows, its four stage
readers read a recorded traced run (on 4 x NVIDIA H100 80GB HBM3 at 700
W, seed 2147493032, 51 s: the record run.py logs), and the cell with its
readers runs through the harness as it is on a mesh of four CPU shards."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.reference import _plain
from conftest import REPO, copy_benchmark

CELL = "kg3.popdist.mesh4"
CONFIG = "kg3_superpops_node4"
STAGES = ("replicate", "gather", "mirror", "dist_stats")
RECORD = json.loads((Path(__file__).parent / "data" /
                     f"{CELL}.traced.json").read_text())

# run.py's window on a copy of the benchmark, with cli.common.get_mesh
# patched to four CPU shards (GGT_DEVICE=cpu has no mesh of its own)
ON_A_MESH = """
import importlib.util, os, sys, time
T0 = time.perf_counter()
root, cell = sys.argv[1:3]
sys.path.insert(0, root)
s = importlib.util.spec_from_file_location(
    "bench_run", os.path.join(root, "benchmark", "run.py"))
run = importlib.util.module_from_spec(s)
s.loader.exec_module(run)
from genomics_general_tpu_torch.cli import common
from genomics_general_tpu_torch.parallel import mesh
four = mesh.make_mesh(4)
common.get_mesh = lambda: four
from benchmark.harness import cell as harness
out = harness.run_cell(cell, 2**31 + 29, 0.2, True, T0, run.log)
sys.exit(run.emit(cell, out, True))
"""


def test_config_and_cell_load_by_name():
    bench = spec.benchmark()
    work = spec.workload(CELL)
    cfg = spec.config(work["config"])
    entry = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert entry["config"] == CONFIG == cfg["name"]
    assert entry["chips"] == work["chips"] == 4
    assert entry["traffic"] == work["traffic"]
    conf = {c["name"]: c for c in bench["configs"]}[CONFIG]
    assert conf["file"] == f"benchmark/configs/{CONFIG}.json"
    assert conf["reduced"] == cfg["reduced"] == ["n_sites", "sequence_length"]
    one = spec.workload("kg3.popdist")
    assert work["flags"] == one["flags"] and work["limits"] == one["limits"]
    assert work["sites"] == cfg["n_sites"] == 32_400
    base = spec.config(one["config"])
    same = {k for k in base if k not in ("name", "source", "deployment",
                                         "reduced_why", "assumed")}
    assert {k for k in same if base[k] != cfg[k]} == set(cfg["reduced"])
    # phase 3's density, 27 sites a kb
    assert cfg["n_sites"] / cfg["sequence_length"] * 1000 == 27.0
    assert cfg["assumed"][:-1] != base["assumed"] and \
        len(cfg["assumed"]) == len(base["assumed"]) + 1
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for stage in STAGES:
        m = per_layer[f"{stage}_busy_pct"]
        assert m["workloads"] == [CELL] and m["moves"] == "sites_per_s"
        assert m["source"] == "program_span" and m["better"] == "lower"


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 2**31 + 977, 4_294_967_301,
                                  9_007_199_254])
def test_every_seed_plans_24_windows(seed):
    cfg = spec.config(CONFIG)
    gen = spec.generator(cfg["generator"])
    pos = gen.positions(cfg, seed)
    assert pos.size == 32_400 and 1_150_000 < pos[-1] <= 1_200_000
    win = _plain.plan({"windType": "coordinate", "windSize": 50_000,
                       "stepSize": None}, pos)
    k = np.arange(24)
    assert np.array_equal(win.start, 1 + 50_000 * k)
    assert np.array_equal(win.end, 50_000 * (k + 1))
    assert (win.n_sites >= 100).all()


@pytest.mark.parametrize("stage", STAGES)
def test_stage_readers(stage):
    reader = spec.metric_reader(f"{stage}_busy_pct")
    wall = RECORD["traced_pass_wall_s"]
    assert reader.read(RECORD) == pytest.approx(
        100 * RECORD["stages"][stage] / wall, rel=1e-15)
    assert 0 < reader.read(RECORD) < 100
    without = {**RECORD, "stages": {k: v for k, v in RECORD["stages"].items()
                                    if k != stage}}
    assert reader.read(without) is None


def test_recorded_run_reads_as_predicted():
    """The recorded run's stages: the host mirror and distance stats take
    most of the wall, the gather little of it, and the replicate (on the
    dispatch lane, beside the collect) a few per cent: each flush's span
    is padded to the 65,536-site bucket and pinned once a card."""
    read = {s: spec.metric_reader(f"{s}_busy_pct").read(RECORD)
            for s in STAGES}
    assert read["mirror"] + read["dist_stats"] >= 85
    assert read["gather"] <= 10 and read["replicate"] <= 6
    assert RECORD["windows_per_pass"] == 24 and RECORD["chips"] == 4


def test_cell_runs_through_the_harness_on_a_cpu_mesh(tmp_path):
    root = copy_benchmark(tmp_path)
    work = json.loads((root / "benchmark/workloads" / f"{CELL}.json")
                      .read_text())
    work.update(config="tiny_kg", sites=6000)
    (root / "benchmark/workloads" / f"tiny.{CELL}.json").write_text(
        json.dumps(work))
    env = {**os.environ, "GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", ON_A_MESH, str(root),
                        f"tiny.{CELL}"], capture_output=True, text=True,
                       timeout=600, env=env, cwd=root)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    record = json.loads(next(
        line for line in r.stderr.splitlines()
        if line.startswith("[bench] record "))[len("[bench] record "):])
    for stage in STAGES:
        got = out["metrics"][f"{stage}_busy_pct"]
        assert got["unit"] == "%"
        assert got["value"] == pytest.approx(
            100 * record["stages"][stage] / record["traced_pass_wall_s"],
            rel=1e-12)
    assert record["windows_per_pass"] == 6
