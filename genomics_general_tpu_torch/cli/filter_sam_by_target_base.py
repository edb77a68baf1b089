"""Extract BAM reads carrying a given base at given positions.

The port of genomics_general_tpu/cli/filter_sam_by_target_base.py, with the
same flags and output bytes; it launches no kernel.

Mirror of SAM_processing/filterSAMbyTargetBase.py: for each
(contig, position, base) target, find reads whose aligned base at that
reference position matches, then write ALL records of the selected read
names (both mates) to the output BAM (filterSAMbyTargetBase.py:33-65).

Uses the pure-Python BAM layer (no pysam/htslib): one streaming pass
selects names, a second writes matching records; input coordinate order is
preserved, so a sorted input yields a sorted output.  When pysam is
available it is used instead (random-access fetch + bai indexing).
"""

from __future__ import annotations

import argparse
import gzip
import sys


def run_pysam(args):
    import os

    import pysam
    in_bam = pysam.AlignmentFile(args.inBam, "rb")
    out_bam = pysam.AlignmentFile(args.outBam + "_unsorted", "wb",
                                  template=in_bam)
    selected = set()
    targets_file = gzip.open(args.targetsFile, "rt") \
        if args.targetsFile.endswith("gz") else open(args.targetsFile, "rt")
    sys.stderr.write("\nFinding entries containing the target base...\n")
    for line in targets_file:
        if line.startswith("#"):
            continue
        contig, pos, base = line.split()
        pos = int(pos) - 1
        for entry in in_bam.fetch(contig=contig, start=pos, stop=pos + 1):
            try:
                q_pos, r_pos = zip(*entry.get_aligned_pairs())
            except ValueError:
                continue
            if pos in r_pos:
                read_pos = q_pos[r_pos.index(pos)]
                if read_pos is not None and \
                        entry.query_sequence[read_pos].upper() == base:
                    selected.add(entry.query_name)
    sys.stderr.write(f"\nFound {len(selected)} entries carrying a target "
                     "base\n")
    index = pysam.IndexedReads(in_bam)
    index.build()
    for name in selected:
        for entry in index.find(name):
            out_bam.write(entry)
    in_bam.close()
    out_bam.close()
    targets_file.close()
    pysam.sort("-o", args.outBam, args.outBam + "_unsorted")
    os.remove(args.outBam + "_unsorted")
    pysam.index(args.outBam)


def run_pure(args):
    from ..io.bam import BamReader, BamWriter
    reader = BamReader(args.inBam)
    ref_index = {n: i for i, n in enumerate(reader.ref_names)}
    targets: dict[int, dict[int, str]] = {}
    targets_file = gzip.open(args.targetsFile, "rt") \
        if args.targetsFile.endswith("gz") else open(args.targetsFile, "rt")
    for line in targets_file:
        if line.startswith("#"):
            continue
        contig, pos, base = line.split()
        if contig in ref_index:
            targets.setdefault(ref_index[contig], {})[int(pos) - 1] = base
    targets_file.close()

    sys.stderr.write("\nFinding entries containing the target base...\n")
    selected = set()
    for rec in reader.records():
        by_pos = targets.get(rec.ref_id)
        if not by_pos:
            continue
        for q_pos, r_pos in rec.aligned_pairs():
            if r_pos is not None and r_pos in by_pos and q_pos is not None:
                if rec.seq[q_pos].upper() == by_pos[r_pos]:
                    selected.add(rec.read_name)
    sys.stderr.write(f"\nFound {len(selected)} entries carrying a target "
                     "base\n")
    writer = BamWriter(args.outBam, reader.raw_header)
    written = 0
    for rec in reader.records():
        if rec.read_name in selected:
            writer.write_record(rec)
            written += 1
    writer.close()
    sys.stderr.write(f"\nWrote {written} selected entries.\nDone.\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="filterSAMbyTargetBase")
    p.add_argument("-i", "--inBam", action="store", required=True)
    p.add_argument("-o", "--outBam", action="store", required=True)
    p.add_argument("-t", "--targetsFile", action="store", required=True)
    p.add_argument("--pure", action="store_true",
                   help="force the pure-Python BAM path even if pysam "
                        "is available")
    args = p.parse_args(argv)
    if not args.pure:
        try:
            import pysam  # noqa: F401
            run_pysam(args)
            return 0
        except ImportError:
            pass
    run_pure(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
