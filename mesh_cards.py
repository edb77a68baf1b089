#!/usr/bin/env python3
"""The port's device mesh across the distinct cards of one host.  Run from
the repository root on a machine with two or more NVIDIA GPUs:

    python3 mesh_cards.py [--sites 500000]

It builds the kernels from the checkout, makes chip_smoke.py's cohorts
(H = 512 in 4 populations, 50 kb windows, ``--sites`` sites, and run I's
cohort) and first runs chip_smoke.py's run S with one gloo rank a card
(``CUDA_VISIBLE_DEVICES=<rank>``), at 2 ranks and at one rank for every
card: each output byte-identical to its one-process run on one card,
every rank that owns a scaffold launching its route's kernels
(chip_smoke.run_s).  Then three of chip_smoke.py's runs through the port's
CLIs: popDist (popDist popPairDist), run A (popFreq popDist popPairDist
indHet hapStats, WC) and run C (ABBABABAwindows).  Each runs four times,
in the order meshless, mesh, mesh, meshless: meshless under
``GGT_NO_MESH=1`` (one card), mesh with the CLIs' own default
(parallel/dispatch.default_mesh(): every card).
It fails unless that mesh holds every card once, every mesh run writes the
bytes of the meshless runs, launches exactly its mesh route's kernels, all
of them inside per-card shard calls with every call launching, and every
card gets calls and holds memory.  Then K15 on each card against its
plain version (chip_smoke.k15_each_card), and entry.dryrun_multichip over
every card.  It prints each card's name and power limit, each run's walls
and shard calls per card, and as its last line one JSON object of them.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

# each run: its mesh route's kernels and the dispatches that split
MESH_ROUTES = {
    "popDist": cs.RUNS["popDist"][2],
    "run_A": ("pair_counts_4state", "tri_pack", "site_pop_counts"),
    "run_C": cs.ABBA_KERNELS,
}


def compare_runs(mods, clis, transfer, mesh, geno, pops, n_sites,
                 work: Path) -> dict:
    """Each run of MESH_ROUTES meshless, on ``mesh``, on ``mesh`` again and
    meshless again; ``mesh`` is what ``cli.common.get_mesh`` gives.  Raises
    AssertionError on any difference or any launch, card or call out of
    place.  Returns {run: report}."""
    import torch
    pair, counts, abba = mods
    dispatches = [(pair, "window_pair_counts_dispatch"),
                  (pair, "window_pair_block_stats_dispatch"),
                  (counts, "site_pop_counts_dispatch"),
                  (abba, "window_abba_sums_dispatch")]
    cards = list(dict.fromkeys(mesh.devices))
    report = {}
    for name, need in MESH_ROUTES.items():
        cli, tail, _, _ = cs.RUNS[name]
        walls = {"meshless": [], "mesh": []}
        outs = []
        for i, way in enumerate(("meshless", "mesh", "mesh", "meshless")):
            out = work / f"{name}.{i}.csv"
            argv = ["-g", str(geno), "-f", "phased", *tail, "--popsFile",
                    str(pops), "--profile", "-o", str(out)]
            env = {"GGT_EXEC": "device"}
            if way == "meshless":
                env["GGT_NO_MESH"] = "1"
                wall, err = cs.run_cli(clis[cli], argv, env)
            else:
                for d in cards:
                    if d.type == "cuda":
                        torch.cuda.reset_peak_memory_stats(d)
                with cs.shard_calls(transfer, mods, dispatches) as groups:
                    cs.reset(mods)
                    wall, err = cs.run_cli(clis[cli], argv, env)
                    got = cs.launches_of(mods)
                check_mesh_run(name, need, got, groups, cards)
                calls = [c for g in groups for c in g]
                per_card = {str(d): sum(c[0] == str(d) for c in calls)
                            for d in cards}
                held = {str(d): torch.cuda.max_memory_allocated(d)
                        for d in cards if d.type == "cuda"}
                if not all(held.values()):
                    raise AssertionError(f"{name}: a card held no memory "
                                         f"{held}")
            walls[way].append(wall)
            outs.append(out)
            cs.log(f"[e2e] {name} {way}: wall {wall:.3f}s, "
                   f"{n_sites / wall:.0f} sites/s; {cs.profile_line(err)}")
        cs.same_bytes(outs, f"{name} on {mesh} vs meshless")
        report[name] = {"walls_s": walls, "sites": n_sites,
                        "kernels": {k: v for k, v in got.items() if v},
                        "shard_calls_per_card": per_card,
                        "dispatches": len(groups),
                        "peak_bytes_per_card": held}
        cs.log(f"[e2e] {name}: {len(calls)} shard calls over {len(groups)} "
               f"dispatches, per card {per_card}, peak bytes per card "
               f"{held}; mesh output byte-identical to meshless")
    return report


def check_mesh_run(name, need, got, groups, cards) -> None:
    """The mesh run launched exactly ``need``, every launch inside a shard
    call, every shard call launching, and every card called."""
    ran = {k for k, v in got.items() if v}
    calls = [c for g in groups for c in g]
    in_calls = {k: sum(c[1].get(k, 0) for c in calls) for k in need}
    called = {c[0] for c in calls}
    if ran != set(need) or in_calls != {k: got[k] for k in need} or \
            not all(c[1] for c in calls) or \
            called != {str(d) for d in cards}:
        raise AssertionError(
            f"{name}: launched {sorted(ran)} (expected {sorted(need)}), "
            f"{in_calls} of them in {len(calls)} shard calls, cards called "
            f"{sorted(called)} of {[str(d) for d in cards]}")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sites", type=int, default=cs.N_SITES)
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    from genomics_general_tpu_torch import entry as port_entry
    from genomics_general_tpu_torch import testing
    from genomics_general_tpu_torch.cli import common
    from genomics_general_tpu_torch.io import native
    from genomics_general_tpu_torch.kernels import _build
    from genomics_general_tpu_torch.kernels import abba
    from genomics_general_tpu_torch.kernels import counts
    from genomics_general_tpu_torch.kernels import pairdist as pair
    from genomics_general_tpu_torch.kernels import transfer
    os.environ["GGT_DEVICE"] = "cuda"
    os.environ.pop("GGT_NO_MESH", None)
    t_start = time.perf_counter()
    n = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        cs.log(line)
    mesh = common.get_mesh()
    want = tuple(torch.device("cuda", i) for i in range(n))
    if mesh is None or mesh.devices != want:
        raise AssertionError(f"the CLIs' default mesh is {mesh}, not the "
                             f"{n} cards")
    with ThreadPoolExecutor(len(cs.SOURCES) + 1) as ex:
        futs = [ex.submit(_build.build, s) for s in cs.SOURCES]
        gxx = ex.submit(native.get_lib)
        for f in futs:
            f.result()
        if gxx.result() is None:
            raise AssertionError("the native C tokenizer did not build")
    cs.log(f"[build] done at {time.perf_counter() - t_start:.1f}s")
    mods = (pair, counts, abba)
    (cs.REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="mesh_cards-",
                                 dir=cs.REPO / "build"))
    try:
        geno, pops = cs.make_cohort(testing, work, "cohort", args.sites,
                                    20 * args.sites)
        cohorts = {"cohort": (geno, pops),
                   "cohort_i": cs.make_cohort(testing, work, "cohort_i",
                                              cs.N_SITES_I, cs.SCAFFOLD_I,
                                              cs.MISSING_I)}
        report = {f"run_S_{k}_ranks": cs.run_s(cs.port_clis(), cohorts,
                                               work, n_ranks=k)
                  for k in sorted({2, n})}
        report.update(compare_runs(mods, cs.port_clis(), transfer, mesh,
                                   geno, pops, args.sites, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.reset(mods)
    cs.k15_each_card(counts)
    cs.log(f"[parity] K15 on each of {n} cards (int32 and uint16) == plain")
    cs.reset(mods)
    t0 = time.perf_counter()
    port_entry.dryrun_multichip(n)
    report["dryrun"] = {"cards": n, "wall_s": time.perf_counter() - t0,
                        "kernels": {k: v for k, v in
                                    cs.launches_of(mods).items() if v}}
    cs.log(f"[e2e] dryrun_multichip({n}): {report['dryrun']}; every mesh "
           "route equal to its meshless route")
    cs.log(f"[done] {time.perf_counter() - t_start:.1f}s")
    cs.log(json.dumps({"cards": smi, "mesh": str(mesh), "runs": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
