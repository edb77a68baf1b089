"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cell's cards.  The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device, with --trace 1 a breakdown, and last the numbers compared
with their limits, which also end standard error.  Exits non-zero, printing
no result, without a CUDA card, with fewer cards than the cell asks for,
or when JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
TOP = 10


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_cards(chips: int) -> None:
    """Let the process see the cell's first ``chips`` cards only (before
    CUDA starts), so a cell runs on the cards it names."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = [v for v in vis.split(",") if v.strip()] if vis is not None \
        else [str(i) for i in range(chips)]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:chips])


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def breakdown(record: dict) -> dict:
    dev = record.get("device") or {}
    ops = sorted((dev.get("ops") or {}).items(), key=lambda kv: -kv[1])
    lanes = sorted((record.get("lanes") or {}).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:120], v] for k, v in ops[:TOP]],
            "idle_gaps": [[f"{k} lane busy", v] for k, v in lanes[:TOP]]}


def traced_record(rec: dict) -> dict:
    """The record as logged: the device's ops cut to the longest."""
    rec = dict(rec)
    if rec.get("device"):
        ops = sorted(rec["device"]["ops"].items(), key=lambda kv: -kv[1])
        rec["device"] = {**rec["device"], "ops": dict(ops[:TOP])}
    return rec


def report(name: str, out: dict, traced: bool) -> dict:
    """The result line from run_cell's output (metrics read by their
    readers, from the cell's entries in BENCHMARK.json)."""
    spec = importlib.import_module(f"{HERE.name}.harness.spec")
    record, res = out["record"], out["result"]
    metrics = {}
    for entry in spec.metrics_of(name, traced):
        value = spec.metric_reader(entry["name"]).read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = dict(out["device"])
    if traced and record.get("device"):
        device["busy_s"] = record["device"]["busy_s"]
        device["window_s"] = record["device"]["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if traced:
        line["breakdown"] = breakdown(record)
    line["compared"] = {k: {"value": v, "limit": out["limits"][k]}
                        for k, v in res["numbers"].items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    path = HERE / "workloads" / f"{args.workload}.json"
    if not path.exists():
        log(f"no workload file {path}")
        return 2
    chips = json.loads(path.read_text())["chips"]
    pin_cards(chips)
    import torch
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is False: the benchmark needs a card")
        return 2
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
            "are visible")
        return 2
    cell = importlib.import_module(f"{HERE.name}.harness.cell")
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START, log)
    return emit(args.workload, out, bool(args.trace))


def emit(name: str, out: dict, traced: bool) -> int:
    cell = importlib.import_module(f"{HERE.name}.harness.cell")
    bad = cell.forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    rec = out["record"]
    log(f"{name}: setup {rec['setup_s']:.3f} s, {rec['passes']} passes in "
        f"{rec['elapsed_s']:.3f} s (walls {rec['pass_walls_s']}), reference "
        f"{rec['reference_s']:.3f} s, card {power_limit()}")
    if traced:
        log("record " + json.dumps(traced_record(rec)))
        if rec.get("device"):
            d = rec["device"]
            log(f"device busy {d['busy_s']} s of {d['window_s']} s, kernel "
                f"{d['kernel_s']} s in {d['kernel_events']} kernel events; "
                f"launches counted {sum(rec['launches'].values())}")
    line = report(name, out, traced)
    for k, v in line["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
