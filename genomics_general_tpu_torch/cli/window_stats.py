"""Windowed summary statistics over numeric site tables.

The port of genomics_general_tpu/cli/window_stats.py, with the same flags
and output bytes; it launches no kernel.

Mirror of the reference ``windowStats.py``: sliding/predefined windows over
any whitespace table with scaffold/position leading columns, emitting
mean/median/min/max/sd/sum/quantile summaries per column
(windowStats.py:34-36, 147-190).  Output text matches the reference
(including the failed-window NaN rows and str(float) formatting).
"""

from __future__ import annotations

import argparse
import gzip
import sys

import numpy as np

from ..io.table import read_numeric_table
from ..windows import (plan_coordinate_windows, plan_predefined_windows,
                       plan_sites_windows)

STAT_CHOICES = ("mean", "median", "min", "max", "sd", "sum",
                "q5", "q10", "q25", "q75", "q90", "q95")
QUANTS = {"q5": 0.05, "q10": 0.1, "q25": 0.25,
          "q75": 0.75, "q90": 0.9, "q95": 0.95}


def _stat(x: np.ndarray, stat: str) -> str:
    """One summary over the non-NaN values, rendered as the reference does
    (str() of the numpy scalar; sd rounded to 6; windowStats.py:169-180)."""
    x = x[~np.isnan(x)]
    if stat == "mean":
        return str(x.mean())
    if stat == "median":
        return str(np.median(x))
    if stat == "min":
        return str(np.min(x))
    if stat == "max":
        return str(np.max(x))
    if stat == "sd":
        return str(round(np.std(x), 6))
    if stat == "sum":
        return str(np.sum(x))
    try:
        return str(np.quantile(x, QUANTS[stat]))
    except (IndexError, ValueError):
        return str(np.nan)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--windType", action="store",
                        choices=("sites", "coordinate", "predefined"),
                        default="coordinate")
    parser.add_argument("-w", "--windSize", type=int, action="store")
    parser.add_argument("-s", "--stepSize", type=int, action="store")
    parser.add_argument("-m", "--minSites", type=int, action="store", default=1)
    parser.add_argument("-O", "--overlap", type=int, action="store")
    parser.add_argument("-D", "--maxDist", type=int, action="store")
    parser.add_argument("--windCoords", required=False)
    parser.add_argument("--stats", action="store", nargs="+",
                        choices=STAT_CHOICES,
                        default=("mean", "median", "min", "max", "sd", "sum"))
    parser.add_argument("-i", "--inFile", required=False)
    parser.add_argument("-o", "--outFile", required=False)
    parser.add_argument("--headers", nargs="+", action="store",
                        help="Headers text if no header in input")
    parser.add_argument("--columns", required=False, nargs="+")
    parser.add_argument("--exclude", required=False)
    parser.add_argument("--include", required=False)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--writeFailedWindows", action="store_true")
    args = parser.parse_args(argv)

    wind_type = args.windType
    if wind_type == "coordinate":
        assert args.windSize, "Window size must be provided."
        step = args.stepSize or args.windSize
        assert not args.overlap, \
            "Overlap does not apply to coordinate windows. Use --stepSize instead."
        assert not args.maxDist, "Maximum distance only applies to sites windows."
    elif wind_type == "sites":
        assert args.windSize, "Window size (number of sites) must be provided."
        overlap = args.overlap or 0
        max_dist = args.maxDist or np.inf
        assert not args.stepSize, \
            "Step size only applies to coordinate windows. Use --overlap instead."
    else:
        assert args.windCoords, "Please provide a file of window coordinates."
        assert not args.overlap and not args.maxDist and not args.stepSize
        assert not args.include and not args.exclude
        with open(args.windCoords, "rt") as wc:
            wind_coords = [line.split()[:3] for line in wc if line.strip()]
    min_sites = args.minSites or args.windSize

    if args.inFile:
        in_file = gzip.open(args.inFile, "rt") if args.inFile.endswith(".gz") \
            else open(args.inFile, "rt")
    else:
        in_file = sys.stdin
    out_file = (gzip.open(args.outFile, "wt") if args.outFile.endswith(".gz")
                else open(args.outFile, "wt")) if args.outFile else sys.stdout

    header_line = " ".join(args.headers) if args.headers else None
    scaffold_names, sids, positions, names, values = read_numeric_table(
        in_file, header_line=header_line, columns=args.columns)

    def scaf_list(path):
        if not path:
            return None
        with open(path, "rt") as f:
            return [l.rstrip() for l in f.readlines()]

    include, exclude = scaf_list(args.include), scaf_list(args.exclude)
    if include or exclude:
        from ..windows import filter_scaffolds
        keep = filter_scaffolds(sids, scaffold_names, include, exclude)
        sids, positions, values = sids[keep], positions[keep], values[:, keep]

    if wind_type == "coordinate":
        plan = plan_coordinate_windows(sids, positions, args.windSize, step)
    elif wind_type == "sites":
        plan = plan_sites_windows(sids, positions, args.windSize, overlap,
                                  max_dist, min_sites)
    else:
        plan = plan_predefined_windows(sids, positions, scaffold_names,
                                       wind_coords)

    out_file.write("scaffold,start,end,mid,sites")
    mids = plan.mid(positions)
    stats = list(args.stats)
    for n in range(plan.n_windows):
        if n == 0:
            for name in names:
                out_file.write("," + ",".join(f"{name}_{s}" for s in stats))
            out_file.write("\n")
        f, l = int(plan.first[n]), int(plan.last[n])
        sites = l - f
        if wind_type in ("coordinate", "predefined"):
            start, end = int(plan.start[n]), int(plan.end[n])
        else:
            start, end = int(positions[f]), int(positions[l - 1])
        mid = "nan" if np.isnan(mids[n]) else str(int(mids[n]))
        scaf = scaffold_names[int(plan.scaffold_id[n])]
        out_file.write(",".join([scaf, str(start), str(end), mid,
                                 str(sites)]) + ",")
        if sites >= min_sites:
            out_file.write(",".join(_stat(values[j, f:l], s)
                                    for j in range(len(names))
                                    for s in stats))
        else:
            out_file.write(",".join([str(np.nan)] * (len(names) * len(stats))))
        out_file.write("\n")
        if (n + 1) % 100 == 0:
            sys.stderr.write(f"{n + 1} windows analysed...\n")

    return 0


if __name__ == "__main__":
    main()
