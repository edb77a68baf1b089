"""The control of a cell's comparison: the reference itself, computed in
float32 (the precision below the float64 the program states), put in the
program's place and judged by the cell's comparison against the float64
reference.  It has to come out not correct.  Also prints the float64
reference judged against itself through the CSV's rounding, the floor of
``max_gap``.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3

Runs where the benchmark runs (the card, or the CPU under
GGT_DEVICE=cpu), at the cell's own size; the benchmark's runs do not run
it.  Prints one JSON line a seed."""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def judge(name: str, seed: int) -> dict:
    import torch
    cell = importlib.import_module(f"{HERE.name}.harness.cell")
    spec = importlib.import_module(f"{HERE.name}.harness.spec")
    compare = importlib.import_module(f"{HERE.name}.harness.compare")
    work = spec.workload(name)
    cfg = spec.config(work["config"])
    dev = cell.device()
    round_to = cell.reference_opts(work["flags"])["roundTo"]
    t0 = time.perf_counter()
    ref, _ = cell.expected(cfg, work, seed, dev, torch.float64)
    t1 = time.perf_counter()
    low, _ = cell.expected(cfg, work, seed, dev, torch.float32)
    t2 = time.perf_counter()
    out = {"workload": name, "seed": seed, "device": str(dev),
           "reference_s": t1 - t0, "control_s": t2 - t1}
    for label, table in (("control_float32", low), ("reference_float64", ref)):
        header, rows = compare.as_csv_values(table, round_to)
        numbers, off, gap = compare.compare_rows(header, rows, ref)
        out[label] = numbers
        out[label]["correct"] = all(
            numbers[k] <= work["limits"][k] for k in compare.NUMBERS)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(judge(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
