"""Block-jackknife CLI over window-statistics tables.

The port of genomics_general_tpu/cli/jackknife.py, with the same flags and
output bytes; it launches no kernel.

Replaces jackknife.R (the reference's significance
machinery for D and related statistics) with a standalone command: blocks
are genome intervals (per chromosome), leave-one-block-out pseudovalues
give the mean / variance / SD / SE — plus the Z score (overall / SE) used
to test D != 0.

Modes
-----
* ``--mode mean --statCol col``: jackknife the mean of a column.
* ``--mode ratio --numCol a --denCol b``: jackknife sum(a)/sum(b) — the
  ratio-of-sums form of all ABBA-BABA statistics (genomics.py:1684-1688);
  e.g. for D over an ABBABABAwindows output, precompute
  num = ABBA-BABA, den = ABBA+BABA per window, or use --D.
* ``--D``: shortcut for D from ABBA/BABA columns of ABBABABAwindows output.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.geno import open_maybe_gz
from ..stats import jackknife as J


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jackknife")
    p.add_argument("-i", "--inFile", action="store")
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("--sep", action="store", default=",")
    p.add_argument("--blockSize", type=int, required=True)
    p.add_argument("--scafCol", action="store", default="scaffold")
    p.add_argument("--posCol", action="store", default="mid")
    p.add_argument("--mode", action="store", choices=("mean", "ratio"),
                   default="ratio")
    p.add_argument("--statCol", action="store")
    p.add_argument("--numCol", action="store")
    p.add_argument("--denCol", action="store")
    p.add_argument("--D", action="store_true",
                   help="jackknife Patterson's D from ABBA/BABA columns")
    args = p.parse_args(argv)

    f = open_maybe_gz(args.inFile, "rt") if args.inFile else sys.stdin
    header = f.readline().rstrip("\n").split(args.sep)
    col = {c: i for i, c in enumerate(header)}
    rows = [line.rstrip("\n").split(args.sep) for line in f if line.strip()]
    if args.inFile:
        f.close()

    def column(name, dtype=float):
        idx = col[name]
        return np.array([dtype(r[idx]) if r[idx] not in ("nan", "NA", "")
                         else np.nan for r in rows])

    scafs = np.array([r[col[args.scafCol]] for r in rows])
    positions = column(args.posCol)

    if args.D:
        abba, baba = column("ABBA"), column("BABA")
        num, den = abba - baba, abba + baba
        mode, label = "ratio", "D"
    elif args.mode == "ratio":
        assert args.numCol and args.denCol, \
            "--numCol and --denCol required for ratio mode"
        num, den = column(args.numCol), column(args.denCol)
        mode, label = "ratio", f"{args.numCol}/{args.denCol}"
    else:
        assert args.statCol, "--statCol required for mean mode"
        values = column(args.statCol)
        mode, label = "mean", args.statCol

    # drop rows with NaN position or NaN inputs
    ok = ~np.isnan(positions)
    if mode == "ratio":
        ok &= ~np.isnan(num) & ~np.isnan(den)
    else:
        ok &= ~np.isnan(values)
    scafs, positions = scafs[ok], positions[ok]
    indices = J.block_indices(args.blockSize, positions, scafs)

    if mode == "ratio":
        num, den = num[ok], den[ok]
        overall = num.sum() / den.sum()
        block_num = np.array([num[i].sum() for i in indices])
        block_den = np.array([den[i].sum() for i in indices])
        res = J.ratio_jackknife(block_num, block_den)
    else:
        values = values[ok]
        overall = values.mean()
        res = J.mean_jackknife(values, indices)

    out = open(args.outFile, "wt") if args.outFile else sys.stdout
    out.write("\t".join(["stat", "overall", "jackknife_mean", "variance",
                         "standard_deviation", "standard_error", "Z",
                         "n_blocks"]) + "\n")
    z = overall / res["standard_error"] if res["standard_error"] > 0 \
        else np.nan
    out.write("\t".join([label, str(overall), str(res["mean"]),
                         str(res["variance"]),
                         str(res["standard_deviation"]),
                         str(res["standard_error"]), str(z),
                         str(len(indices))]) + "\n")
    if args.outFile:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
