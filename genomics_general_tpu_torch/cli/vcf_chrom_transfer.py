"""Liftover a VCF onto a new assembly via an AGP/transfers table.

The port of genomics_general_tpu/cli/vcf_chrom_transfer.py, with the same
flags and output bytes; it launches no kernel.

Mirror of VCF_processing/vcfChromTransfer.py: header
##contig lines are replaced with the new chromosomes (lengths = last
transfer end), then each transfer interval's records are emitted with
transferred CHROM/POS — reverse-strand intervals are position-flipped and
line-order reversed (vcfChromTransfer.py:113-144).  REF/ALT are
complemented on every emitted line, matching the reference exactly (its
translate calls are unconditional, :142-143 — note this complements
forward-strand transfers too).

Region extraction uses an in-memory per-chromosome position index instead
of shelling out to ``tabix`` (unavailable here); and ``-o`` works (the
reference opens its output for reading, :53).
"""

from __future__ import annotations

import argparse
import sys
from collections import OrderedDict

import numpy as np

from ..io.geno import open_maybe_gz
from ..io.writers import open_out

complement_trans = str.maketrans("ACGT", "TGCA")


def new_pos(pos, start=1, new_start=None, new_end=None, reverse=False):
    pos = pos - start + 1
    if not reverse:
        return new_start + pos - 1
    return new_end - pos + 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vcfChromTransfer")
    p.add_argument("-v", "--vcfFile", action="store", required=True)
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("-a", "--agpFile", action="store")
    p.add_argument("-t", "--transfersFile", action="store")
    p.add_argument("--chroms", nargs="+", action="store")
    args = p.parse_args(argv)

    if not args.transfersFile and not args.agpFile:
        raise ValueError("Please provide an AGP file (or a 'transfers' file)")
    out = open_out(args.outFile)

    transfers = []
    if args.agpFile:
        with open(args.agpFile, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                try:
                    (new_chrom, new_start, new_end, _part, component, chrom,
                     start, end, strand) = line.split()
                except ValueError:
                    sys.stderr.write("\nWARNING: failed to extract 9 fields "
                                     f"from agp line\n{line}Line will be "
                                     "ignored\n.")
                    continue
                if component in ("N", "U"):
                    continue
                if not args.chroms or new_chrom in args.chroms:
                    transfers.append([new_chrom, new_start, new_end, chrom,
                                      start, end, strand])
    else:
        with open(args.transfersFile, "rt") as f:
            for line in f:
                if line.startswith("#"):
                    continue
                try:
                    (new_chrom, new_start, new_end, chrom, start, end,
                     strand) = line.split()
                except ValueError:
                    sys.stderr.write("\nWARNING: failed to extract 7 fields "
                                     f"from transfers line\n{line}Line will "
                                     "be ignored\n.")
                    continue
                if not args.chroms or new_chrom in args.chroms:
                    transfers.append([new_chrom, new_start, new_end, chrom,
                                      start, end, strand])

    new_chrom_lengths = OrderedDict()
    for t in transfers:
        end = int(t[2])
        if t[0] in new_chrom_lengths:
            assert end > new_chrom_lengths[t[0]], (
                f"Transfers for chrom {t[0]} not in correct order. {end} is "
                f"not more than than {new_chrom_lengths[t[0]]}\n")
        new_chrom_lengths[t[0]] = end

    # header pass: copy header lines (swapping contigs); stops at the first
    # data line
    import os as _os
    tbi = args.vcfFile + ".tbi" if args.vcfFile else None
    use_index = bool(tbi) and _os.path.exists(tbi)
    contigs_output = False
    with open_maybe_gz(args.vcfFile, "rt") as vcf:
        for line in vcf:
            if line.startswith("##contig"):
                if not contigs_output:
                    for c in new_chrom_lengths:
                        out.write(f"##contig=<ID={c},length="
                                  f"{new_chrom_lengths[c]}>\n")
                    contigs_output = True
                continue
            if line.startswith("#"):
                out.write(line)
                continue
            break

    chrom_lines: dict[str, list[str]] = {}
    chrom_pos: dict[str, list[int]] = {}
    if use_index:
        # .tbi present: per-region BGZF random access (io/tabix) — a
        # small-region liftover against a huge VCF reads only the blocks
        # the index points at, like the reference's tabix subprocess
        # (vcfChromTransfer.py:17-26)
        from ..io import tabix as T
        idx = T.TabixIndex(tbi)
        rd = T.BGZFReader(args.vcfFile)
    else:
        # no index: one whole-file pass building a per-chrom position index
        with open_maybe_gz(args.vcfFile, "rt") as vcf:
            for line in vcf:
                if line.startswith("#"):
                    continue
                tab = line.find("\t")
                chrom = line[:tab]
                pos = int(line[tab + 1:line.find("\t", tab + 1)])
                chrom_lines.setdefault(chrom, []).append(line.rstrip("\n"))
                chrom_pos.setdefault(chrom, []).append(pos)
    pos_arrays = {c: np.asarray(v) for c, v in chrom_pos.items()}

    for t in transfers:
        new_chrom, new_start, new_end, chrom, start, end, strand = t
        region = f"{chrom}:{start}-{end}"
        sys.stderr.write(f"\nGetting region {region} from vcf...\n")
        if use_index:
            # match the non-indexed path's semantics exactly: POS within
            # [start, end] (span-overlapping records starting earlier are
            # not included)
            vcf_lines = [ln.decode() for ln in T.region_lines(
                args.vcfFile, chrom, int(start), int(end),
                index=idx, reader=rd)
                if int(ln.split(b"\t", 2)[1]) >= int(start)]
        elif chrom in pos_arrays:
            pa = pos_arrays[chrom]
            lo = int(np.searchsorted(pa, int(start), side="left"))
            hi = int(np.searchsorted(pa, int(end), side="right"))
            vcf_lines = chrom_lines[chrom][lo:hi]
        else:
            vcf_lines = []
        if not vcf_lines:
            sys.stderr.write("WARNING: Region empty. If this is unexpected, "
                             "ensure input vcf is sorted.\n")
            continue
        sys.stderr.write(f"Region extracted. {len(vcf_lines)} lines.\n")
        reverse = strand == "-"
        if reverse:
            sys.stderr.write("Orientation is reverse.\nreversing...\n")
            vcf_lines = vcf_lines[::-1]
        else:
            sys.stderr.write("Orientation is forward.\n")
        sys.stderr.write(f"Writing new region {new_chrom}:{new_start}-"
                         f"{new_end}...\n")
        for vcf_line in vcf_lines:
            fields = vcf_line.split("\t")
            assert fields[0] == chrom, (
                f"Something went wrong: Found chrom {fields[0]} but expected "
                f"chrom {chrom}.")
            fields[0] = new_chrom
            fields[1] = str(new_pos(int(fields[1]), start=int(start),
                                    new_start=int(new_start),
                                    new_end=int(new_end), reverse=reverse))
            fields[3] = fields[3].translate(complement_trans)
            fields[4] = fields[4].translate(complement_trans)
            out.write("\t".join(fields) + "\n")

    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
