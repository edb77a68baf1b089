"""MAF multiple-alignment blocks -> geno rows keyed on a reference track.

The port of genomics_general_tpu/cli/maf_to_geno.py, with the same flags and
output bytes; it launches no kernel.

Mirror of tools/mafToGeno.py: per 'a' block, positions come
from the named reference track (reverse-strand blocks flip positions and
reverse-complement all sequences, mafToGeno.py:121-130), gaps/lowercase are
cleaned per --keepLowercase/--lowercaseToN, and rows are emitted only for
non-gap reference columns (:133-134).

The reference's missing-sequence fill crashes (``sequences`` is assigned
before it exists and then reset, mafToGeno.py:103-118); here absent tracks
are filled with N after the block's sequences are built, with
alignment-length buffers so the gap-index lookup stays in range.
"""

from __future__ import annotations

import argparse
import sys

from ..io.geno import open_maybe_gz
from ..io.writers import open_out

complement_trans = str.maketrans("AaCcGgTtKkMmRrYyVvHhBbDdNn",
                                 "TtGgCcAaMmKkYyRrBbDdVvHhNn")


def maf_block_reader(maf_file):
    line = maf_file.readline()
    while line and line[0] != "a":
        line = maf_file.readline()
    block = []
    while line != "":
        line = maf_file.readline()
        if line == "" or line[0] == "a":
            yield block
            block = []
        elif line and line[0] == "s":
            block.append(line)


def parse_maf_block(block):
    out = {}
    for line in block:
        source, start, size, strand, src_size, seq = line.split()[1:]
        out[source] = {"start": int(start), "size": int(size),
                       "strand": strand, "srcSize": int(src_size),
                       "seq": seq}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mafToGeno")
    p.add_argument("-m", "--mafFile", action="store")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("--ref", action="store", type=str, required=True)
    p.add_argument("--renameChromAs", action="store", type=str)
    p.add_argument("--seqNames", action="store", nargs="+", type=str,
                   required=True)
    p.add_argument("--renameSeqsAs", nargs="+", type=str)
    p.add_argument("--minSeqsRequired", action="store", type=int, default=1)
    p.add_argument("--minSize", action="store", type=int, default=1)
    p.add_argument("--keepLowercase", action="store_true")
    p.add_argument("--lowercaseToN", action="store_true")
    args = p.parse_args(argv)

    maf_file = open_maybe_gz(args.mafFile, "rt") if args.mafFile else sys.stdin
    geno_file = open_out(args.genoFile)

    if args.renameSeqsAs:
        assert len(args.renameSeqsAs) == len(args.seqNames), \
            "Incorrect number of new sequence names."
        out_names = args.renameSeqsAs
    else:
        out_names = args.seqNames
    geno_file.write("#CHROM\tPOS\t" + "\t".join(out_names) + "\n")
    chrom = args.renameChromAs if args.renameChromAs else args.ref

    if args.keepLowercase:
        cleanup = str.maketrans("-", "N")
    elif args.lowercaseToN:
        cleanup = str.maketrans("-acgtkmryvhbdn", "NNNNNNNNNNNNNN")
    else:
        cleanup = str.maketrans("-acgtkmryvhbdn", "NACGTKMRYVHBDN")

    for block in maf_block_reader(maf_file):
        data = parse_maf_block(block)
        present = data.keys()
        sys.stderr.write(
            f"\nProcessing block with {len(present)} sequences:\n")
        for name in present:
            d = data[name]
            sys.stderr.write(f"source={name}, start={d['start']}, "
                             f"size={d['size']}, strand={d['strand']}\n")
        if args.ref not in present:
            sys.stderr.write("Reference absent - skipping block.\n")
            continue
        ref = data[args.ref]
        if ref["size"] < args.minSize:
            sys.stderr.write("Block too short - skipping block.\n")
            continue
        desired = [n for n in present if n in args.seqNames]
        sys.stderr.write(f"{len(desired)} of {len(args.seqNames)} desired "
                         "sequences are present\n")
        if len(desired) < args.minSeqsRequired:
            sys.stderr.write("Too few sequences - skipping block.\n")
            continue

        ref_true_len = ref["size"]
        ref_aln_len = len(ref["seq"])
        ref_indices = [i for i in range(ref_aln_len) if ref["seq"][i] != "-"]

        sequences = {}
        if ref["strand"] == "-":
            positions = list(range(ref["start"] + 1,
                                   ref["start"] + 1 - ref_true_len, -1))[::-1]
            for name in desired:
                sequences[name] = data[name]["seq"].translate(cleanup) \
                    .translate(complement_trans)[::-1]
        else:
            positions = list(range(ref["start"] + 1,
                                   ref["start"] + 1 + ref_true_len))
            for name in desired:
                sequences[name] = data[name]["seq"].translate(cleanup)
        for name in args.seqNames:
            if name not in sequences:
                sequences[name] = "N" * ref_aln_len

        for i in range(ref_true_len):
            geno_file.write("\t".join(
                [chrom, str(positions[i]),
                 "\t".join(sequences[n][ref_indices[i]]
                           for n in args.seqNames)]) + "\n")

    if args.mafFile:
        maf_file.close()
    if geno_file is not sys.stdout:
        geno_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
