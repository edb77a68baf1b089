"""Sequence alignment (fasta/phylip) -> geno converter.

The port of genomics_general_tpu/cli/seq_to_geno.py, with the same flags and
output bytes; it launches no kernel.

Mirror of seqToGeno.py: single alignments emit either one
contig with sequences as samples (--mode samples) or one sample with
sequences as contigs (--mode contigs); multi-phylip input emits one contig
per alignment.  --ploidy fuses haploid sequences into phased genotypes
(the reference's single-element ploidy list crashes under Python 3 via a
float list-multiply, genomics.py:277 — fixed here).
"""

from __future__ import annotations

import argparse
import sys

from ..io import seqio
from ..io.geno import open_maybe_gz
from ..io.writers import open_out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seqToGeno")
    p.add_argument("-s", "--seqFile", action="store")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("-f", "--format", action="store",
                   choices=("phylip", "fasta"), default="fasta")
    p.add_argument("-M", "--mode", action="store",
                   choices=("samples", "contigs"), default="samples")
    p.add_argument("-C", "--chrom", action="store", default="contig0")
    p.add_argument("-N", "--name", action="store", default="sample0")
    p.add_argument("-S", "--sequences", action="store", nargs="+", type=str)
    p.add_argument("--merge", action="store_true")
    p.add_argument("-P", "--ploidy", action="store", nargs="+", type=int,
                   default=[1])
    p.add_argument("--randomPhase", action="store_true")
    args = p.parse_args(argv)

    seq_file = open_maybe_gz(args.seqFile, "rt") if args.seqFile else sys.stdin
    geno_file = open_out(args.genoFile)
    text = seq_file.read()

    multi = False
    if args.format == "fasta":
        seq_names, seqs = seqio.parse_fasta(text)
    else:
        pieces = seqio.parse_phylip(text)
        if isinstance(pieces, tuple):
            seq_names, seqs = pieces
        else:
            multi_names, multi_seqs = zip(*pieces)
            multi = True

    if not multi:
        if args.sequences is not None:
            seqs = [seqs[seq_names.index(x)] for x in args.sequences]
            seq_names = args.sequences
        if max(args.ploidy) > 1:
            seqs, seq_names = seqio.haplo_to_phased(
                seqs, seq_names=seq_names, ploidy=args.ploidy,
                random_phase=args.randomPhase)
        if args.mode == "samples":
            geno_file.write("#CHROM\tPOS\t" + "\t".join(seq_names) + "\n")
            for x in range(len(seqs[0])):
                geno_file.write(args.chrom + "\t" + str(x + 1) + "\t" +
                                "\t".join(s[x] for s in seqs) + "\n")
        else:
            geno_file.write("#CHROM\tPOS\t" + args.name + "\n")
            for y in range(len(seq_names)):
                for x in range(len(seqs[y])):
                    geno_file.write(seq_names[y] + "\t" + str(x + 1) + "\t" +
                                    seqs[y][x] + "\n")
    else:
        assert len(set(map(len, multi_names))) == 1, \
            "For multi phylip, all alignments must have same number of sequences"
        seq_names = args.sequences if args.sequences else multi_names[0]
        indices = [[names.index(n) for n in seq_names]
                   for names in multi_names]
        aln_seqs = [[multi_seqs[i][j] for j in indices[i]]
                    for i in range(len(multi_seqs))]
        if max(args.ploidy) > 1:
            aln_seqs = [seqio.haplo_to_phased(s, ploidy=args.ploidy,
                                              random_phase=args.randomPhase)
                        for s in aln_seqs]
            seq_names = seqio.make_phased_names(list(seq_names), args.ploidy)
        geno_file.write("#CHROM\tPOS\t" + "\t".join(seq_names) + "\n")
        for i, seqs_i in enumerate(aln_seqs):
            contig = args.chrom if args.merge else args.chrom + str(i)
            for x in range(len(seqs_i[0])):
                geno_file.write(contig + "\t" + str(x + 1) + "\t" +
                                "\t".join(s[x] for s in seqs_i) + "\n")

    if args.seqFile:
        seq_file.close()
    if geno_file is not sys.stdout:
        geno_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
