"""Generic coordinate liftover for column files via AGP/transfers tables.

The port of genomics_general_tpu/cli/transfer_scaf_pos.py, with the same
flags and output bytes; it launches no kernel.

Mirror of tools/transferScafPos.py: per line, find the
unique transfer interval containing both start and end positions, map
positions (reverse-strand flip via newPos, transferScafPos.py:15-22), and
write NA / fail-file records for broken or missing transfers
(transferScafPos.py:118-171).  Interval lookup uses sorted arrays +
searchsorted instead of the reference's per-line O(intervals) scan.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.geno import open_maybe_gz
from ..io.writers import open_out


def new_pos(pos, start=1, new_start=None, new_end=None, reverse=False):
    pos = pos - start + 1
    if not reverse:
        return new_start + pos - 1
    return new_end - pos + 1


def read_transfers(agp_file=None, transfers_file=None, allow_agp_fails=False,
                   chroms=None):
    """Returns {scaf: list of dicts}.  AGP rows with component N/U are
    assembly gaps and are skipped (transferScafPos.py:91)."""
    transfers: dict[str, list[dict]] = {}

    def add(new_scaf, new_start, new_end, scaf, start, end, strand):
        if chroms and new_scaf not in chroms:
            return
        transfers.setdefault(scaf, []).append(
            {"scaf": scaf, "start": int(start), "end": int(end),
             "strand": strand, "newScaf": new_scaf,
             "newStart": int(new_start), "newEnd": int(new_end)})

    if agp_file:
        with open(agp_file, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                try:
                    (new_scaf, new_start, new_end, _part, component, scaf,
                     start, end, strand) = line.split()[:9]
                except ValueError:
                    if allow_agp_fails:
                        sys.stderr.write(
                            "WARNING: skipping malformed agp line:\n" + line)
                        continue
                    raise ValueError("agp file should have nine fields.")
                if component in ("N", "U"):
                    continue
                add(new_scaf, new_start, new_end, scaf, start, end, strand)
    else:
        with open(transfers_file, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                try:
                    (new_scaf, new_start, new_end, scaf, start, end,
                     strand) = line.split()
                except ValueError:
                    raise ValueError(
                        "Transfers file should have seven fields for "
                        "newChrom, newStart, newEnd, chrom, start, end and "
                        "strand.")
                add(new_scaf, new_start, new_end, scaf, start, end, strand)
    return transfers


class IntervalIndex:
    """Per-scaffold interval membership: which transfer intervals contain a
    point (replicates the reference's possibly-overlapping lookup,
    transferScafPos.py:12-13, 127-129)."""

    def __init__(self, rows: list[dict]):
        self.rows = rows
        self.starts = np.array([r["start"] for r in rows])
        self.ends = np.array([r["end"] for r in rows])

    def containing(self, x) -> np.ndarray:
        return np.flatnonzero((x >= self.starts) & (x <= self.ends))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="transferScafPos")
    p.add_argument("-i", "--inFile", action="store")
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("-p", "--preset", action="store", choices=("vcf", "gff"))
    p.add_argument("--scafCol", action="store", type=int, default=1)
    p.add_argument("--startCol", action="store", type=int, default=2)
    p.add_argument("--endCol", action="store", type=int, default=2)
    p.add_argument("--strandCol", action="store", type=int)
    p.add_argument("--floatPositions", action="store_true")
    p.add_argument("--sep", action="store", default=None)
    p.add_argument("-f", "--failFile", action="store")
    p.add_argument("-a", "--agpFile", action="store")
    p.add_argument("-t", "--transfersFile", action="store")
    p.add_argument("--header", action="store_true")
    p.add_argument("--keepFails", action="store_true")
    p.add_argument("--allowAGPfails", action="store_true")
    args = p.parse_args(argv)

    in_file = open_maybe_gz(args.inFile, "rt") if args.inFile else sys.stdin
    out_file = open_out(args.outFile)
    if args.failFile:
        fail_file = open_out(args.failFile)
    else:
        fail_file = open("/dev/null", "wt")
        if not args.keepFails:
            sys.stderr.write("\nWARNING: Failed transfers will not be shown. "
                             "To catch them, specify a --failFile\n\n")

    if args.preset == "vcf":
        scaf_col, start_col, end_col, strand_col, float_pos = 1, 2, 2, None, False
    elif args.preset == "gff":
        scaf_col, start_col, end_col, strand_col, float_pos = 1, 4, 5, 7, False
    else:
        scaf_col, start_col, end_col, strand_col, float_pos = (
            args.scafCol, args.startCol, args.endCol, args.strandCol,
            args.floatPositions)
    get_pos = float if float_pos else int
    sep = args.sep
    outsep = sep if sep is not None else "\t"

    if not args.transfersFile and not args.agpFile:
        raise ValueError("Please provide an AGP file (or a 'transfers' file)")
    transfers = {s: IntervalIndex(rows) for s, rows in read_transfers(
        args.agpFile, args.transfersFile, args.allowAGPfails).items()}

    if args.header:
        head = in_file.readline()
        out_file.write(head)
        fail_file.write(head)

    def write_fail(tag, elements):
        fail_file.write(tag + "\n")
        fail_file.write(outsep.join(elements) + "\n")
        if args.keepFails:
            elements[scaf_col - 1] = "NA"
            elements[start_col - 1] = "NA"
            elements[end_col - 1] = "NA"
            if strand_col:
                elements[strand_col - 1] = "NA"
            out_file.write(outsep.join(elements) + "\n")

    for line in in_file:
        if line.startswith("#"):
            continue
        elements = line.strip().split(sep)
        scaf = elements[scaf_col - 1]
        start = get_pos(elements[start_col - 1])
        end = get_pos(elements[end_col - 1])
        strand = elements[strand_col - 1] if strand_col else "+"
        assert strand in ("+", "-")
        if scaf not in transfers:
            write_fail("#MISSING", elements)
            continue
        idx = transfers[scaf]
        si = idx.containing(start)
        ei = idx.containing(end)
        if not (len(si) == len(ei) == 1 and si[0] == ei[0]):
            write_fail("#BROKEN", elements)
            continue
        t = idx.rows[si[0]]
        if t["strand"] == "+":
            ns = new_pos(start, t["start"], t["newStart"], t["newEnd"], False)
            ne = new_pos(end, t["start"], t["newStart"], t["newEnd"], False)
            new_strand = strand
        else:
            ns = new_pos(end, t["start"], t["newStart"], t["newEnd"], True)
            ne = new_pos(start, t["start"], t["newStart"], t["newEnd"], True)
            new_strand = "-" if strand == "+" else "+"
        elements[scaf_col - 1] = t["newScaf"]
        elements[start_col - 1] = str(ns)
        elements[end_col - 1] = str(ne)
        if strand_col:
            elements[strand_col - 1] = new_strand
        out_file.write(outsep.join(elements) + "\n")

    if out_file is not sys.stdout:
        out_file.close()
    fail_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
