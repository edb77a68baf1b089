"""Codon / CDS machinery: genetic code, syn/non classification, degeneracy,
GFF3/GTF gene parsing, CDS position extraction.

The port of genomics_general_tpu/cds.py, with the same functions and
results; it launches no kernel.

Host-side mirror of the reference codon layer (genomics.py:96-252).
``syn_non`` / ``degeneracy`` results are memoized on the allele-set triple —
the classification is a pure function of at most 4^3 small sets, so the
cache turns the per-codon set algebra into a dict hit.
"""

from __future__ import annotations

import itertools
from collections import defaultdict

import numpy as np

from .encoding import complement

gencode = {
    'ATA': 'I', 'ATC': 'I', 'ATT': 'I', 'ATG': 'M',
    'ACA': 'T', 'ACC': 'T', 'ACG': 'T', 'ACT': 'T',
    'AAC': 'N', 'AAT': 'N', 'AAA': 'K', 'AAG': 'K',
    'AGC': 'S', 'AGT': 'S', 'AGA': 'R', 'AGG': 'R',
    'CTA': 'L', 'CTC': 'L', 'CTG': 'L', 'CTT': 'L',
    'CCA': 'P', 'CCC': 'P', 'CCG': 'P', 'CCT': 'P',
    'CAC': 'H', 'CAT': 'H', 'CAA': 'Q', 'CAG': 'Q',
    'CGA': 'R', 'CGC': 'R', 'CGG': 'R', 'CGT': 'R',
    'GTA': 'V', 'GTC': 'V', 'GTG': 'V', 'GTT': 'V',
    'GCA': 'A', 'GCC': 'A', 'GCG': 'A', 'GCT': 'A',
    'GAC': 'D', 'GAT': 'D', 'GAA': 'E', 'GAG': 'E',
    'GGA': 'G', 'GGC': 'G', 'GGG': 'G', 'GGT': 'G',
    'TCA': 'S', 'TCC': 'S', 'TCG': 'S', 'TCT': 'S',
    'TTC': 'F', 'TTT': 'F', 'TTA': 'L', 'TTG': 'L',
    'TAC': 'Y', 'TAT': 'Y', 'TAA': '_', 'TAG': '_',
    'TGC': 'C', 'TGT': 'C', 'TGA': '_', 'TGG': 'W'}


def translate(sequence: str, missing: str = "X") -> str:
    """Protein from +1 reading frame (genomics.py:114-116)."""
    return "".join(gencode.get(sequence[3 * i:3 * i + 3], missing)
                   for i in range(len(sequence) // 3))


def possible_codons(a1, a2, a3):
    return ["".join(x) for x in itertools.product(a1, a2, a3)]


def possible_aas(a1, a2, a3):
    aas = {translate(c) for c in possible_codons(a1, a2, a3)}
    aas.discard("X")
    return sorted(aas)


# how degenerate a site is, from the number of distinct amino acids formed
# when the site is mutated (genomics.py:146)
degen_dict = {4: 0, 3: 2, 2: 2, 1: 4, 0: "NA"}

_syn_cache: dict = {}
_degen_cache: dict = {}


def _key(a1, a2, a3):
    return (frozenset(a1), frozenset(a2), frozenset(a3))


def syn_non(a1, a2, a3):
    """Per-codon-position syn/non classification (genomics.py:126-140):
    requires exactly one biallelic position, others monomorphic."""
    k = _key(a1, a2, a3)
    hit = _syn_cache.get(k)
    if hit is not None:
        return list(hit)
    output = ["NA", "NA", "NA"]
    n_alleles = [len(a1), len(a2), len(a3)]
    if sorted(n_alleles) == [1, 1, 2]:
        focal = n_alleles.index(2)
        l = len(possible_aas(a1, a2, a3))
        if l == 1:
            output[focal] = "syn"
        elif l > 1:
            output[focal] = "non"
    _syn_cache[k] = tuple(output)
    return output


def degeneracy(a1, a2, a3):
    """Per-codon-position fold degeneracy (genomics.py:148-170)."""
    k = _key(a1, a2, a3)
    hit = _degen_cache.get(k)
    if hit is not None:
        return list(hit)
    n1, n2, n3 = len(a1), len(a2), len(a3)
    if n1 == n2 == n3 == 1:
        output = [degen_dict[len(possible_aas("ACGT", a2, a3))],
                  degen_dict[len(possible_aas(a1, "ACGT", a3))],
                  degen_dict[len(possible_aas(a1, a2, "ACGT"))]]
    elif n1 == 2 and n2 == n3 == 1:
        output = [degen_dict[len(possible_aas("ACGT", a2, a3))], "NA", "NA"]
    elif n2 == 2 and n1 == n3 == 1:
        output = ["NA", degen_dict[len(possible_aas(a1, "ACGT", a3))], "NA"]
    elif n3 == 2 and n1 == n2 == 1:
        output = ["NA", "NA", degen_dict[len(possible_aas(a1, a2, "ACGT"))]]
    else:
        output = ["NA", "NA", "NA"]
    _degen_cache[k] = tuple(output)
    return output


def parse_genes(lines, fmt: str = "gff3", targets=None):
    """GFF3/GTF -> {scaffold: {mRNA: {start,end,strand,exons,cdsStarts,
    cdsEnds}}} (genomics.py:174-202)."""
    if fmt == "gtf":
        def info(s):
            return dict(x.strip().split() for x in s.strip(";").split(";"))
        id_key = parent_key = "transcript_id"
    else:
        def info(s):
            return dict(x.strip().split("=") for x in s.strip(";").split(";"))
        id_key, parent_key = "ID", "Parent"
    output: dict = defaultdict(dict)
    for line in lines:
        if len(line) <= 1 or line[0] == "#":
            continue
        f = line.strip().split("\t")
        scaffold = f[0]
        if f[2].lower() == "mrna" or f[2] == "transcript":
            try:
                mrna = info(f[-1])[id_key]
            except Exception:
                raise ValueError("Problem parsing mRNA information: " + f[-1])
            if not targets or mrna in targets:
                output[scaffold][mrna] = {
                    "start": int(f[3]), "end": int(f[4]), "strand": f[6],
                    "exons": 0, "cdsStarts": [], "cdsEnds": []}
        elif f[2].lower() == "cds":
            mrna = info(f[-1])[parent_key]
            if not targets or mrna in targets:
                output[scaffold][mrna]["exons"] += 1
                output[scaffold][mrna]["cdsStarts"].append(int(f[3]))
                output[scaffold][mrna]["cdsEnds"].append(int(f[4]))
    return output


def cds_positions(exon_starts, exon_ends, strand, trim=False):
    """Ordered genomic positions of a CDS (genomics.py:206-227)."""
    assert len(exon_starts) == len(exon_ends)
    idx = np.argsort(exon_ends)[::-1] if strand == "-" \
        else np.argsort(exon_starts)
    coding = [list(range(exon_starts[i], exon_ends[i] + 1)) for i in idx]
    if strand == "-":
        for c in coding:
            c.reverse()
    coding = [p for c in coding for p in c]
    if trim:
        overhang = len(coding) % 3
        if overhang != 0:
            coding = coding[:-overhang]
    return coding


def cds_sequence(exon_starts, exon_ends, strand, seq_dict=None, seq=None,
                 seq_pos=None, trim=True) -> str:
    """CDS sequence from per-position bases (genomics.py:230-244)."""
    if seq_dict is None:
        assert len(seq) == len(seq_pos)
        seq_dict = defaultdict(lambda: "N", zip(seq_pos, seq))
    coding = cds_positions(exon_starts, exon_ends, strand, trim=trim)
    cds_seq = "".join(seq_dict[p] for p in coding)
    if strand == "-":
        cds_seq = complement(cds_seq)
    return cds_seq


def count_stops(cds: str, include_terminal: bool = False) -> int:
    rng = range(0, len(cds) if include_terminal else len(cds) - 3, 3)
    stops = {"TAA", "TAG", "TGA"}
    return sum(1 for i in rng if cds[i:i + 3] in stops)
