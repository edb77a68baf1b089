"""geno -> minimal VCF converter.

The port of genomics_general_tpu/cli/geno_to_vcf.py, with the same flags and
output bytes; it launches no kernel.

Mirror of VCF_processing/genoToVCF.py: REF is the reference
fasta base when provided (remaining alleles keep frequency order after it),
else the overall-majority allele; genotypes are emitted 0/1-coded with the
input's phase separators (makeVCFline, genoToVCF.py:5-21).  Allele
frequency ranking replicates GenomeSite.alleles(byFreq=True)
(genomics.py:549-557), including collapse of partially-missing genotypes to
fully missing (Genotype.numAlleles, genomics.py:352-353) and the
argsort-reverse tie order.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.geno import open_maybe_gz
from ..io.seqio import parse_fasta
from ..io.writers import open_out

DIPLO_PAIRS = {"A": "AA", "C": "CC", "G": "GG", "T": "TT", "N": "NN",
               "K": "GT", "M": "AC", "R": "AG", "S": "CG", "W": "AT",
               "Y": "CT"}


def parse_genotype(gt: str, geno_format: str | None):
    """Return (alleles tuple, phase char).  Mirrors Genotype.__init__
    (genomics.py:317-352) for phased/pairs/diplo."""
    if geno_format == "phased" or (geno_format is None and
                                   len(gt) > 1 and gt[1] in "|/"):
        alleles = tuple(gt[::2])
        phase = gt[1] if len(gt) > 1 and len(gt) % 2 == 1 else "/"
    elif geno_format == "diplo" or (geno_format is None and len(gt) == 1):
        alleles = tuple(DIPLO_PAIRS.get(gt, "NN"))
        phase = "/"
    else:  # pairs
        alleles = tuple(gt)
        phase = "/"
    return alleles, phase


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="genoToVCF")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("-f", "--genoFormat", action="store",
                   choices=["phased", "diplo", "pairs"])
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("-r", "--reference", action="store")
    p.add_argument("-s", "--samples", action="store")
    args = p.parse_args(argv)

    geno_file = open_maybe_gz(args.genoFile, "rt") if args.genoFile \
        else sys.stdin
    out = open_out(args.outFile)

    ref_dict = None
    scafs_lengths = None
    if args.reference:
        sys.stderr.write("Parsing reference. This could take a while...\n")
        try:
            with open(args.reference + ".fai", "rt") as fai:
                scafs_lengths = [line.split()[:2] for line in fai]
        except OSError:
            sys.stderr.write("WARNING: Could not parse fai file, vcf header "
                             "will not contain contig entries...\n")
        with open_maybe_gz(args.reference, "rt") as ref:
            ref_dict = dict(zip(*parse_fasta(ref.read())))

    header = geno_file.readline()
    all_names = header.split()[2:]
    names = args.samples.split(",") if args.samples else all_names
    col_of = {n: i for i, n in enumerate(all_names)}
    cols = [col_of[n] for n in names]

    out.write("##fileformat=VCFv4.2\n")
    if ref_dict:
        out.write("##reference=file:{}\n".format(
            args.reference.split("/")[-1]))
        if scafs_lengths:
            for s, l in scafs_lengths:
                out.write(f"##contig=<ID={s},length={l}>\n")
    out.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" +
              "\t".join(names) + "\n")

    bases = np.array(["A", "C", "G", "T"])
    base_idx = {"A": 0, "C": 1, "G": 2, "T": 3}
    gt_cache: dict[str, tuple] = {}
    lines_done = 0
    sys.stderr.write("Converting...\n")
    for line in geno_file:
        if not line.strip() or line[0] == "#":
            continue
        parts = line.split()
        scaffold, position = parts[0], parts[1]
        parsed = []
        counts = np.zeros(4, np.int64)
        for c in cols:
            gt = parts[c + 2]
            hit = gt_cache.get(gt)
            if hit is None:
                alleles, phase = parse_genotype(gt, args.genoFormat)
                ok = all(a in base_idx for a in alleles)
                hit = (alleles, phase, ok)
                if len(gt_cache) < 10000:
                    gt_cache[gt] = hit
            parsed.append(hit)
            if hit[2]:
                for a in hit[0]:
                    counts[base_idx[a]] += 1
        # byFreq order: argsort-reverse of the compacted present counts,
        # default (non-stable) sort — exactly GenomeSite.alleles
        # (genomics.py:549-557); tie order is introsort's
        idx = np.flatnonzero(counts > 0)
        alleles = [bases[i] for i in idx[np.argsort(counts[idx])[::-1]]]
        if not alleles:
            alleles = ["N"]
        if ref_dict:
            ref_base = ref_dict[scaffold][int(position) - 1]
            if ref_base in alleles:
                alleles.remove(ref_base)
            alleles = [ref_base] + alleles
        else:
            ref_base = alleles[0]
        alt = alleles[1:] or ["."]
        code = {a: str(i) for i, a in enumerate(alleles)}
        coded = []
        for al, phase, ok in parsed:
            try:
                coded.append(phase.join(code[a] for a in al))
            except KeyError:
                coded.append(phase.join(["."] * len(al)))
        out.write("\t".join([scaffold, position, ".", ref_base,
                             ",".join(alt), ".", ".", ".", "GT"] + coded) +
                  "\n")
        lines_done += 1
        if lines_done % 100000 == 0:
            sys.stderr.write(f"{lines_done} lines converted...\n")
    if args.genoFile:
        geno_file.close()
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
