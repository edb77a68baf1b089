"""Merge multiple position-sorted geno files over a reference genome.

The port of genomics_general_tpu/cli/merge_geno.py, with the same flags and
output bytes; it launches no kernel.

Mirror of mergeGeno.py: walks scaffolds in .fai order and
positions 1..length, consuming each input's head line only when it matches
the walked (scaffold, position) exactly — so unsorted or un-indexed input
lines block their file, exactly as in the reference (mergeGeno.py:57-88).
intersect / union(--unionMin, --mustIncludeFirst) / all methods, dummy
missing genotypes, --outputOnly column selection.

Unlike the reference's O(genome-length) scan, intersect/union jump straight
between candidate positions (positions some head can match), which is
output-identical because non-candidate positions can never satisfy
``filesRepresented >= 1``.
"""

from __future__ import annotations

import argparse
import sys

from ..io.geno import open_maybe_gz
from ..io.writers import open_out

INF = float("inf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mergeGeno")
    p.add_argument("-i", "--inputFile", action="append", required=True)
    p.add_argument("-f", "--fai", action="store", required=True)
    p.add_argument("-o", "--outputFile", action="store")
    p.add_argument("--method", action="store",
                   choices=("intersect", "union", "all"), default="intersect")
    p.add_argument("--unionMin", action="store", type=int, default=1)
    p.add_argument("--mustIncludeFirst", action="store", type=int, default=0)
    p.add_argument("--outSep", action="store", default="\t")
    p.add_argument("--missing", action="store", default="N")
    p.add_argument("--outputOnly", action="store", type=int, nargs="+")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    files = [open_maybe_gz(f, "rt") for f in args.inputFile]
    n_files = len(files)
    out = open_out(args.outputFile)
    output_idx = [i - 1 for i in args.outputOnly] if args.outputOnly \
        else list(range(n_files))

    with open(args.fai, "rt") as fai:
        scaf_lens = [(s, int(l)) for s, l in
                     (ln.split()[:2] for ln in fai if ln.strip())]
    scafs = [x[0] for x in scaf_lens]
    scaf_lens = dict(scaf_lens)

    headers = [f.readline().split() for f in files]
    dummy_genos = [[args.missing] * (len(h) - 2) for h in headers]
    union_min = max(args.unionMin, args.mustIncludeFirst)

    out.write(args.outSep.join(
        [args.outSep.join(headers[0][0:2]),
         args.outSep.join(args.outSep.join(headers[x][2:])
                          for x in output_idx)]) + "\n")

    heads = [f.readline().split() for f in files]
    lines_written = 0
    # positions are candidates only when some head can match; with method
    # "all" (or a zero union threshold) every genome position emits a line
    skip_gaps = not (args.method == "all" or
                     (args.method == "union" and union_min < 1))

    for scaf in scafs:
        sys.stderr.write(f"Merging {scaf}...\n")
        length = scaf_lens[scaf]
        t = 1
        while t <= length:
            if skip_gaps:
                nxt = INF
                for x in range(n_files):
                    h = heads[x]
                    if len(h) >= 2 and h[0] == scaf:
                        try:
                            hp = int(h[1])
                        except ValueError:
                            continue
                        if t <= hp < nxt:
                            nxt = hp
                if nxt == INF or nxt > length:
                    break
                t = int(nxt)
            site = str(t)
            files_represented = 0
            out_objects = [scaf, site]
            fail = False
            for x in range(n_files):
                h = heads[x]
                if len(h) >= 2 and h[0] == scaf and h[1] == site:
                    if x in output_idx:
                        out_objects += h[2:]
                    heads[x] = files[x].readline().split()
                    files_represented += 1
                else:
                    if args.method == "intersect" or x < args.mustIncludeFirst:
                        fail = True
                        continue
                    if x in output_idx:
                        out_objects += dummy_genos[x]
            if args.verbose:
                sys.stderr.write(
                    f"{scaf} {site}: {files_represented} files represented.\n")
            if not fail and (
                    args.method == "all" or
                    (args.method == "union" and
                     files_represented >= union_min) or
                    (args.method == "intersect" and
                     files_represented == n_files)):
                if args.verbose:
                    sys.stderr.write("Writing line.\n")
                out.write(args.outSep.join(out_objects) + "\n")
                lines_written += 1
                if lines_written % 100000 == 0:
                    sys.stderr.write(
                        f"{lines_written} lines written to output...\n")
            t += 1

    for f in files:
        f.close()
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
