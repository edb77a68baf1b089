"""geno -> Eigenstrat geno/snp/ind converter.

The port of genomics_general_tpu/cli/geno_to_eigenstrat.py, with the same
flags and output bytes; it launches no kernel.

Mirror of tools/genoToEigenstrat.py: biallelic sites only
(alleles over ALL samples, alphabetical for the snp columns,
genoToEigenstrat.py:52-54), per-sample counts of the LEAST-frequent allele
(asList mode="count" with countAllele = byFreq[-1], genomics.py:538-541;
missing genotypes -> 9), snp ids are the 0-based input line indices,
chromosome renumbering via --chromFile with --cumulativePos offsets
(genoToEigenstrat.py:59-68).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..encoding import byfreq_allele_order
from ..io import geno as geno_io
from ..samples import SampleData


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="genoToEigenstrat")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("-f", "--genoFormat", action="store",
                   choices=["phased", "diplo", "paired"])
    p.add_argument("--genoOutFile", action="store", required=True)
    p.add_argument("--snpOutFile", action="store", required=True)
    p.add_argument("--indOutFile", action="store", required=True)
    p.add_argument("-s", "--samples", action="store")
    p.add_argument("--chromFile", action="store")
    p.add_argument("--cumulativePos", action="store_true")
    p.add_argument("--nullChrom", action="store", type=int, default=22)
    args = p.parse_args(argv)

    src = args.genoFile if args.genoFile else sys.stdin
    fmt = {"paired": "pairs", None: "phased"}.get(args.genoFormat,
                                                  args.genoFormat)
    probe = geno_io.GenoReader(src, geno_format=fmt)
    all_names = list(probe.file_ind_names)
    if args.samples is None:
        samples = all_names
    else:
        requested = args.samples.split(",")
        samples = [s for s in all_names if s in requested]

    # alleles/biallelic gate use ALL samples (genoToEigenstrat.py:50-54)
    sd = SampleData(ind_names=all_names, ploidy={n: 2 for n in all_names})
    reader = geno_io.rebind_reader(probe, sd)
    model = reader.model
    row_of = dict(zip(model.sample_names, model.sample_rows))
    rows_all = np.stack([row_of[s] for s in all_names])     # [n_all, 2]
    rows_sel = np.stack([row_of[s] for s in samples])       # [n_sel, 2]

    chrom_dict = {}
    if args.chromFile:
        with open(args.chromFile, "rt") as f:
            chrom_dict = dict(line.split() for line in f if line.strip())

    bases = "ACGT"
    geno_out = open(args.genoOutFile, "wt")
    snp_out = open(args.snpOutFile, "wt")
    chrom_offset = {c: 0 for c in chrom_dict.values()}
    chrom_offset[str(args.nullChrom)] = 0
    state = {"scaf": None, "chrom": None, "pos": 0, "off": 0}

    def process(chunk):
        """One streamed chunk: vectorized site stats + ordered row emission
        (rows are site-major, so the stream needs only O(chunk) memory)."""
        alleles = chunk.alleles
        S = alleles.shape[1]
        a0_all, a1_all = alleles[rows_all[:, 0]], alleles[rows_all[:, 1]]
        geno_missing_all = (a0_all < 0) | (a1_all < 0)
        eff0 = np.where(geno_missing_all, -1, a0_all)
        eff1 = np.where(geno_missing_all, -1, a1_all)
        counts = np.zeros((S, 4), np.int64)
        for arr in (eff0, eff1):
            for b in range(4):
                counts[:, b] += (arr == b).sum(axis=0)
        n_present = (counts > 0).sum(axis=1)
        biallelic = n_present == 2
        order = byfreq_allele_order(counts)                 # [S, 4]
        count_allele = order[np.arange(S), np.maximum(n_present - 1, 0)]

        # per selected sample: copies of count_allele (0..2) or 9 if missing
        a0s, a1s = alleles[rows_sel[:, 0]], alleles[rows_sel[:, 1]]
        miss_s = (a0s < 0) | (a1s < 0)
        cnt = ((a0s == count_allele[None, :]).astype(np.int8) +
               (a1s == count_allele[None, :]).astype(np.int8))
        cnt = np.where(miss_s, 9, cnt)                      # [n_sel, S]
        digits = np.char.mod("%d", cnt.T)                   # [S, n_sel]

        off = state["off"]
        for s in range(S):
            gs = off + s
            if not biallelic[s]:
                continue
            geno_out.write("".join(digits[s]) + "\n")
            site_scaf = reader.scaffold_names[int(chunk.scaffold_ids[s])]
            if site_scaf != state["scaf"]:
                if state["chrom"] is not None and args.cumulativePos:
                    chrom_offset[state["chrom"]] = state["pos"]
                state["scaf"] = site_scaf
                state["chrom"] = chrom_dict.get(site_scaf,
                                                str(args.nullChrom))
            state["pos"] = int(chunk.positions[s]) if not args.cumulativePos \
                else int(chunk.positions[s]) + chrom_offset[state["chrom"]]
            # present alleles, alphabetical (alleles(), genomics.py:557)
            ab = [bases[b] for b in range(4) if counts[s, b] > 0]
            snp_out.write("\t".join([str(gs), state["chrom"], "0.0",
                                     str(state["pos"]), ab[0], ab[1]]) + "\n")
            if (gs + 1) % 100000 == 0:
                print(gs + 1, "lines done...")
        state["off"] = off + S

    from .. import engine as _engine
    for chunk in _engine._prefetched(reader.iter_chunks()):
        process(chunk)
    geno_out.close()
    snp_out.close()
    with open(args.indOutFile, "wt") as ind_file:
        for sample in samples:
            ind_file.write(sample + "  U  NA\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
