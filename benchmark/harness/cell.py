"""One run of one cell: set-up, the timed window, the reference, the
record the metric readers read.

The window drives the port's CLI ``main(argv)`` in this process in a
closed loop with one client: whole passes over the cell's input back to
back, the pass in progress when the seconds run out finished and counted.
Set-up (``setup_s``) is everything before the window but the making of
the input, which is the benchmark's own work and is done only on a cache
miss (its seconds are logged and kept in the record as ``input_made_s``):
the imports, the CUDA context, the input's lookup in the cache, and one
warm pass over the whole input with the cell's flags, which loads the
kernel libraries from the checkout's ``build/`` (building them on a
checkout's first run) and makes every buffer the window's passes use.  The
traced run (``trace``) runs the same window under torch.profiler, with
``--profile`` on each pass and the program's stage timers and launch
counters read."""

from __future__ import annotations

import argparse
import gc
import importlib
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, inputs, spec, trace
from ..gen import _common as C

FORBIDDEN = ("jax", "jaxlib", "flax", "genomics_general_tpu")


def device() -> torch.device:
    """Where the benchmark's own generator and reference run: the card,
    unless the port is told to run on the CPU (``GGT_DEVICE=cpu``)."""
    if os.environ.get("GGT_DEVICE") == "cpu" or not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", 0)


def reference_opts(flags: list[str]) -> dict:
    """The flags the reference needs, read from the cell's CLI flags."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--windType", default="coordinate")
    p.add_argument("-w", "--windSize", type=int)
    p.add_argument("-s", "--stepSize", type=int)
    p.add_argument("-m", "--minSites", type=int, default=1)
    p.add_argument("--minData", type=float, default=0.01)
    p.add_argument("--analysis", nargs="+",
                   default=["popDist", "popPairDist"])
    p.add_argument("-p", "--population", action="append", nargs="+")
    p.add_argument("--roundTo", type=int, default=4)
    opts = vars(p.parse_known_args(flags)[0])
    if not opts["minSites"]:
        opts["minSites"] = opts["windSize"]
    if any(len(p) != 1 for p in opts["population"] or []):
        raise ValueError("the reference takes populations from the pops "
                         "file only (-p NAME)")
    opts["pops"] = [p[0] for p in opts["population"] or []]
    return opts


def groups(cfg: dict, pops: list[str]) -> dict:
    """Haplotype rows of each population named by -p, in -p order."""
    names = list(cfg["superpopulations"])
    g = C.haplotype_groups(cfg)
    return {p: np.flatnonzero(g == names.index(p)) for p in pops}


def expected(cfg: dict, work: dict, seed: int, dev, dtype):
    """(the reference's table of the cell's CSV in ``dtype``, its job):
    the genotype codes made again from the seed, on ``dev``."""
    opts = reference_opts(work["flags"])
    gen = spec.generator(cfg["generator"])
    plain = importlib.import_module(f"{spec.PACKAGE}.reference._plain")
    job = plain.Job(
        codes=torch.cat(list(gen.chunks(cfg, seed, work["sites"], dev))),
        positions=gen.positions(cfg, seed)[:work["sites"]],
        scaffold=cfg["scaffold"], groups=groups(cfg, opts["pops"]),
        opts=opts, dtype=dtype)
    modules = {a: spec.reference(a) for a in opts["analysis"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return plain.table(job, opts["analysis"], modules), job


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, log) -> dict:
    """Run the cell once; returns the result's fields and the record."""
    work = spec.workload(name)
    cfg = spec.config(work["config"])
    dev = device()
    cli = importlib.import_module(
        f"genomics_general_tpu_torch.cli.{work['cli']}")
    cards = range(work["chips"] if dev.type == "cuda" else 0)
    for d in cards:
        torch.ones(1, device=f"cuda:{d}").sum().item()
    files = inputs.get(cfg, work, seed, dev, log)
    tmp = Path(tempfile.mkdtemp(prefix="ggbench-"))
    try:
        def argv(geno, out):
            flags = [f.replace("{pops}", str(files.pops))
                     for f in work["flags"]]
            return ["-g", str(geno), *flags, "-o", str(out)] \
                + (["--profile"] if traced else [])
        cli.main(argv(files.geno, tmp / "warm.csv"))
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        mods = trace.kernel_modules()
        trace.reset_launches(mods)
        setup_s = time.perf_counter() - t_start - (files.made_s or 0.0)
        outs, walls = [], []
        with trace.profiled(traced) as traced_run, \
                trace.stage_timers(traced) as timers:
            t0 = time.perf_counter()
            while True:
                out = tmp / f"pass{len(outs)}.csv"
                t = time.perf_counter()
                cli.main(argv(files.geno, out))
                walls.append(time.perf_counter() - t)
                outs.append(out)
                if time.perf_counter() - t0 >= seconds:
                    break
            elapsed = time.perf_counter() - t0
        counted = trace.launches(mods)
        peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
                   default=0)
        n_dev = max(len(cards), 1)
        record = {
            "cell": name, "seed": seed, "chips": n_dev, "traced": traced,
            "setup_s": setup_s, "input_made_s": files.made_s,
            "sites_per_pass": work["sites"], "passes": len(outs),
            "elapsed_s": elapsed, "pass_walls_s": walls}
        if traced:
            stages, lanes = trace.lanes(timers)
            record.update(stages=stages, lanes=lanes, launches=counted,
                          traced_pass_wall_s=sum(walls))
            if traced_run.prof is not None and cards:
                dev_sum = trace.summarize(
                    trace.device_events(traced_run.prof), n_dev)
                dev_sum["window_s"] = elapsed
                record["device"] = dev_sum
        del traced_run, timers
        gc.collect()
        if cards:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        table, job = expected(cfg, work, seed, dev, torch.float64)
        win = job.windows
        n_stats = sum(k != "key" for k in table["kinds"].values())
        record["windows_per_pass"] = int(win.first.size)
        record["work"] = {
            "haplotypes": int(job.codes.shape[1]),
            "window_sites": int(win.n_sites.sum()),
            "stat_values": int(job.good.sum()) * n_stats,
            "passes": len(outs)}
        del job
        result = compare.compare(outs, table, work["limits"])
        record["reference_s"] = time.perf_counter() - t_ref
        return {"result": result, "record": record, "limits": work["limits"],
                "device": {"platform": "gpu" if cards else "cpu",
                           "kind": torch.cuda.get_device_name(0) if cards
                           else "cpu",
                           "count": n_dev, "memory_peak_bytes": peak}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
