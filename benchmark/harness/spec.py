"""Finding a cell's files by name.

``BENCHMARK.json`` (at the root of the checkout) lists the cells and the
metrics; ``workloads/<cell>.json`` holds a cell's traffic (CLI, flags,
sites, limits), ``configs/<config>.json`` its configuration,
``gen/<generator>.py`` its generator, ``reference/<analysis>.py`` the plain
reference of each ``--analysis``, and ``metrics/<metric>.py`` the reader of
each metric.  Nothing here names a cell, a configuration or a metric."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHECKOUT = ROOT.parent
PACKAGE = ROOT.name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def workload(name: str) -> dict:
    path = ROOT / "workloads" / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"no workload file {path}")
    return {**load_json(path), "name": name}


def config(name: str) -> dict:
    return {**load_json(ROOT / "configs" / f"{name}.json"), "name": name}


def generator_path(name: str) -> Path:
    return ROOT / "gen" / f"{name}.py"


def generator(name: str):
    return importlib.import_module(f"{PACKAGE}.gen.{name}")


def reference(analysis: str):
    return importlib.import_module(f"{PACKAGE}.reference.{analysis}")


def metric_reader(name: str):
    return importlib.import_module(f"{PACKAGE}.metrics.{name}")


def metrics_of(cell: str, trace: bool) -> list[dict]:
    """The metric entries of BENCHMARK.json that this cell reports: its
    end-to-end metrics without a trace, its per-layer metrics with one."""
    entries = benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
