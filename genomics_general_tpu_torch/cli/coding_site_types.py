"""Annotate coding sites: codon position, syn/non, degeneracy.

The port of genomics_general_tpu/cli/coding_site_types.py, with the same
flags and output bytes; it launches no kernel.

Mirror of codingSiteTypes.py: GFF3/GTF mRNAs + reference
fasta (+ optional VCF ALTs) -> per-site codon position, substitution type,
fold degeneracy, with cross-mRNA conflict detection
(codingSiteTypes.py:86-171).  Reference quirks kept: the N-removal loop is
a no-op there (it iterates dict keys, :130-132), so N alleles stay in the
sets here too; VCF ALT alleles are added per CHARACTER of the ALT field
(:126-127).

VCF variant extraction uses an in-memory per-chromosome index instead of
tabix subprocesses.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import cds as C
from ..encoding import complement
from ..io.geno import open_maybe_gz
from ..io.seqio import parse_fasta
from ..io.writers import open_out


class VcfVariantIndex:
    """chrom -> (sorted positions, ALT strings)."""

    def __init__(self, path):
        self.pos: dict[str, np.ndarray] = {}
        self.alt: dict[str, list[str]] = {}
        pos: dict[str, list[int]] = {}
        alt: dict[str, list[str]] = {}
        with open_maybe_gz(path, "rt") as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                p = line.split("\t", 5)
                pos.setdefault(p[0], []).append(int(p[1]))
                alt.setdefault(p[0], []).append(p[4])
        for c in pos:
            self.pos[c] = np.asarray(pos[c])
            self.alt[c] = alt[c]

    def in_region(self, chrom, start, end):
        if chrom not in self.pos:
            return []
        pa = self.pos[chrom]
        lo = int(np.searchsorted(pa, start, side="left"))
        hi = int(np.searchsorted(pa, end, side="right"))
        return [(int(pa[i]), self.alt[chrom][i]) for i in range(lo, hi)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="codingSiteTypes")
    p.add_argument("-a", "--annotation", action="store", required=True)
    p.add_argument("-f", "--format", action="store",
                   choices=("gff3", "gtf"), default="gff3")
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("-v", "--vcf", action="store")
    p.add_argument("-r", "--ref", action="store", required=True)
    p.add_argument("--ignoreConflicts", action="store_true")
    p.add_argument("--scaffoldLookup", action="store")
    p.add_argument("--useAnnotationScaffoldNames", action="store_true")
    p.add_argument("--noheader", action="store_true")
    args = p.parse_args(argv)

    sys.stderr.write("Parsing annotation\n")
    with open_maybe_gz(args.annotation, "rt") as ann:
        gene_data = C.parse_genes(ann.readlines(), fmt=args.format)

    sys.stderr.write("Loading reference genome\n")
    with open_maybe_gz(args.ref, "rt") as ref:
        scaffolds, seq_list = parse_fasta(ref.read(), make_uppercase=True)
    sequences = dict(zip(scaffolds, seq_list))

    if args.scaffoldLookup and args.useAnnotationScaffoldNames:
        with open(args.scaffoldLookup) as lookup:
            names = dict(line.split() for line in lookup)
        renamed, order = {}, []
        for s in scaffolds:
            if s in names:
                renamed[names[s]] = sequences[s]
                order.append(names[s])
            else:
                sys.stderr.write(f" WARNING!: {s} is not in scaffoldLookup "
                                 "and will not be analysed\n")
        sequences, scaffolds = renamed, order
    if args.scaffoldLookup and not args.useAnnotationScaffoldNames:
        with open(args.scaffoldLookup) as lookup:
            names = dict(line.split()[::-1] for line in lookup)
        gene_data = {s: gene_data[names[s]] for s in scaffolds}

    variants = VcfVariantIndex(args.vcf) if args.vcf else None

    out = open_out(args.outFile)
    if not args.noheader:
        out.write("\t".join(["scaffold", "position", "codon_position",
                             "substitution_type", "degeneracy"]) + "\n")

    for scaffold in scaffolds:
        pos_data: dict[int, tuple] = {}
        analysed: set[int] = set()
        if scaffold not in gene_data:
            sys.stderr.write(f"Skipping {scaffold}. No annotated mRNAs\n")
            continue
        mrnas = gene_data[scaffold]
        sys.stderr.write(f"Analysing {scaffold}: {len(mrnas)} mRNAs\n")
        counter = 0
        for mrna, g in mrnas.items():
            region = f"{scaffold}:{g['start']}-{g['end']}"
            sys.stderr.write(f"    Analysing mRNA {mrna}: {region}, "
                             f"{g['exons']} exons\n")
            site_alleles: dict[int, set] = {}
            for i in range(g["exons"]):
                start, end = g["cdsStarts"][i], g["cdsEnds"][i]
                site_alleles.update(
                    {pos: set(base) for pos, base in
                     zip(range(start, end + 1),
                         sequences[scaffold][start - 1:end])})
                if variants:
                    for pos, alt in variants.in_region(scaffold, start, end):
                        for a in alt:
                            if a in "ACGT":
                                site_alleles[pos].add(a)
            # NOTE: the reference's N-removal loop is a silent no-op
            # (codingSiteTypes.py:130-132); N alleles intentionally remain.
            positions = C.cds_positions(g["cdsStarts"], g["cdsEnds"],
                                        g["strand"], trim=True)
            codon_alleles = [
                [site_alleles[positions[y]] if g["strand"] == "+"
                 else {complement(a) for a in site_alleles[positions[y]]}
                 for y in range(x, x + 3)]
                for x in range(0, len(positions), 3)]
            new_data = dict(zip(positions, [
                x for triple in codon_alleles
                for x in zip(range(1, 4), C.syn_non(*triple),
                             C.degeneracy(*triple))]))
            for pos in analysed.intersection(positions):
                if pos_data[pos] != new_data[pos]:
                    if args.ignoreConflicts:
                        new_data[pos] = ("NA", "NA", "NA")
                    else:
                        raise AssertionError(
                            f"Position {pos} of {scaffold} occurs in two "
                            "mRNAs giving conflicting site "
                            "classifications.\n")
            pos_data.update(new_data)
            analysed.update(positions)
            counter += 1
        sys.stderr.write(f"    Done analysing {counter} mRNAs. Writing "
                         f"output for {scaffold}\n")
        for pos in sorted(analysed):
            out.write("\t".join([scaffold, str(pos)] +
                                [str(x) for x in pos_data[pos]]) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
