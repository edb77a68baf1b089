"""Extract per-mRNA CDS alignments from a geno file + GFF annotation.

The port of genomics_general_tpu/cli/extract_cds_alignments.py, with the
same flags and output bytes; it launches no kernel.

Mirror of extractCDSAlignments.py: per mRNA, exon genotype
columns are collected (haplotype-split by default), '-'-strand genes are
complemented with exon order and positions reversed (CDSpositions,
genomics.py:206-227), and one fasta/phylip alignment is written per mRNA
with names ``sample_mRNA`` (:129-141).

Region extraction uses an in-memory per-scaffold geno index instead of
tabix subprocesses.  The reference's --samples handling is broken there
(it sizes buffers by ALL header names, extractCDSAlignments.py:119-133);
here --samples selects columns consistently.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import cds as C
from ..encoding import complement
from ..io.geno import open_maybe_gz
from ..io.seqio import make_haploid_names
from ..io.writers import make_aln_string, open_out
from ..regions import Intervals, parse_region_text


class GenoRegionIndex:
    """scaffold -> (sorted positions, raw genotype-string rows)."""

    def __init__(self, path, samples=None):
        self.pos: dict[str, np.ndarray] = {}
        self.rows: dict[str, list[list[str]]] = {}
        pos: dict[str, list[int]] = {}
        rows: dict[str, list[list[str]]] = {}
        with open_maybe_gz(path, "rt") as f:
            header = f.readline().split()
            all_names = header[2:]
            if samples:
                cols = [all_names.index(s) + 2 for s in samples]
                self.names = list(samples)
            else:
                cols = list(range(2, len(header)))
                self.names = all_names
            for line in f:
                if not line.strip() or line[0] == "#":
                    continue
                p = line.split()
                pos.setdefault(p[0], []).append(int(p[1]))
                rows.setdefault(p[0], []).append([p[c] for c in cols])
        for c in pos:
            self.pos[c] = np.asarray(pos[c])
            self.rows[c] = rows[c]

    def in_region(self, chrom, start, end):
        if chrom not in self.pos:
            return []
        pa = self.pos[chrom]
        lo = int(np.searchsorted(pa, start, side="left"))
        hi = int(np.searchsorted(pa, end, side="right"))
        return [(int(pa[i]), self.rows[chrom][i]) for i in range(lo, hi)]


class TabixGenoRegionIndex:
    """Random-access variant of :class:`GenoRegionIndex` for BGZF geno
    files with a native ``.tbi`` alongside (io/tabix): each CDS region
    reads only the blocks the index points at instead of holding the whole
    genome in memory — the reference's tabix workflow
    (extractCDSAlignments.py:12-20) without the subprocess."""

    def __init__(self, path, samples=None):
        from ..io import tabix as T
        self._T = T
        self.path = path
        self.idx = T.TabixIndex(path + ".tbi")
        self.rd = T.BGZFReader(path)
        # header line = start of the first block
        payload, _ = self.rd.block_at(0)
        header = payload.split(b"\n", 1)[0].decode().split()
        all_names = header[2:]
        if samples:
            self.cols = [all_names.index(s) + 2 for s in samples]
            self.names = list(samples)
        else:
            self.cols = list(range(2, len(header)))
            self.names = all_names

    def in_region(self, chrom, start, end):
        out = []
        for ln in self._T.region_lines(self.path, chrom, int(start),
                                       int(end), index=self.idx,
                                       reader=self.rd):
            p = ln.decode().split()
            out.append((int(p[1]), [p[c] for c in self.cols]))
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="extractCDSAlignments")
    p.add_argument("--annotation", action="store", required=True)
    p.add_argument("--annotationFormat", choices=("gff3", "gtf"),
                   action="store", default="gff3")
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("--outFormat", action="store",
                   choices=["fasta", "phylip"], default="phylip")
    p.add_argument("--includeCoordinates", action="store_true")
    p.add_argument("-g", "--genoFile", action="store", required=True)
    p.add_argument("-s", "--samples", nargs="+", action="store")
    p.add_argument("-t", "--targets", nargs="+", action="store")
    p.add_argument("-r", "--regions", nargs="+", action="store")
    p.add_argument("--regionsFile", action="store")
    p.add_argument("--exclude", nargs="+", action="store")
    p.add_argument("--split", dest="split", action="store_true")
    p.add_argument("--no-split", dest="split", action="store_false")
    p.add_argument("--ploidy", action="store", type=int, nargs="+",
                   default=2)
    p.set_defaults(split=True)
    args = p.parse_args(argv)

    with open_maybe_gz(args.annotation, "rt") as gff:
        gff_lines = gff.readlines()
    sys.stderr.write("Parsing gene data\n")
    gene_data = C.parse_genes(gff_lines, fmt=args.annotationFormat,
                              targets=args.targets)

    regions = None
    if args.regions or args.regionsFile:
        region_tuples = []
        if args.regions:
            region_tuples += [parse_region_text(r) for r in args.regions]
        if args.regionsFile:
            with open(args.regionsFile, "rt") as rf:
                for line in rf:
                    if line.strip():
                        parts = line.split()
                        region_tuples.append(parse_region_text(
                            ":".join(parts[:1] +
                                     (["-".join(parts[1:3])]
                                      if len(parts) >= 3 else []))))
        regions = Intervals(tuples=region_tuples).reduced()
    if regions is not None or args.exclude:
        new_data = {}
        for scaffold in gene_data:
            if args.exclude and scaffold in args.exclude:
                continue
            if regions is not None:
                if scaffold not in regions.chrom_set:
                    continue
                new_data[scaffold] = {
                    m: g for m, g in gene_data[scaffold].items()
                    if np.any(regions.contains_interval(
                        g["start"], g["end"], scaffold))}
            else:
                new_data[scaffold] = gene_data[scaffold]
        gene_data = new_data

    out = open_out(args.outFile)
    import os as _os
    index = TabixGenoRegionIndex(args.genoFile, samples=args.samples) \
        if _os.path.exists(args.genoFile + ".tbi") \
        else GenoRegionIndex(args.genoFile, samples=args.samples)
    ploidy = args.ploidy if isinstance(args.ploidy, list) else [args.ploidy]
    if args.split:
        out_base_names = make_haploid_names(index.names, ploidy)
    else:
        out_base_names = list(index.names)
    n_seqs = len(out_base_names)

    for scaffold in gene_data:
        mrnas = gene_data[scaffold]
        sys.stderr.write(f"Extracting {len(mrnas)} gene sequences from "
                         f"{scaffold}\n")
        for mrna, g in mrnas.items():
            region = f"{scaffold}:{g['start']}-{g['end']}"
            if g["exons"] < 1:
                sys.stderr.write(f"    Skipping mRNA {mrna}: {region}. "
                                 "No exons\n")
                continue
            sys.stderr.write(f"    Extracting mRNA {mrna}: {region}, "
                             f"{g['exons']} exons\n")
            strand = g["strand"]
            order = np.argsort(g["cdsStarts"])
            if strand == "-":
                order = order[::-1]
            cds_starts = [g["cdsStarts"][x] for x in order]
            cds_ends = [g["cdsEnds"][x] for x in order]

            empty = ["N"] * n_seqs
            site_gts: dict[int, list[str]] = {}
            for i in range(g["exons"]):
                for pos, row in index.in_region(scaffold, cds_starts[i],
                                                cds_ends[i]):
                    if args.split:
                        gts = [a for gt in row for a in gt[::2]]
                    else:
                        gts = row
                    site_gts[pos] = [complement(gt) for gt in gts] \
                        if strand == "-" else gts

            positions = C.cds_positions(cds_starts, cds_ends, strand)
            cds_seqs = [[site_gts.get(pos, empty)[i] for pos in positions]
                        for i in range(n_seqs)]
            if args.includeCoordinates:
                names = [f"{n}_{mrna} {scaffold}:{g['start']}-{g['end']}"
                         for n in out_base_names]
            else:
                names = [f"{n}_{mrna}" for n in out_base_names]
            out.write(make_aln_string(names, cds_seqs,
                                      out_format=args.outFormat,
                                      line_len=None) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
