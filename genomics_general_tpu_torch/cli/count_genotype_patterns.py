"""Counts of coded genotype patterns across samples.

The port of genomics_general_tpu/cli/count_genotype_patterns.py, with the
same flags and output bytes; it launches no kernel.

Mirror of countGenotypePatterns.py: each site's alleles are
ranked by overall frequency (GenomeSite.alleles(byFreq=True),
genomics.py:549-557 — ties break toward the later base via argsort-reverse),
each genotype is coded by allele rank ("01", ".." when any allele is
missing; Genotype.asCoded, genomics.py:363-366), and the resulting pattern
tuple is tallied against the itertools.product enumeration
(countGenotypePatterns.py:61-104).  Counting is vectorized: per-site rank
tables + a bytes-view np.unique over the pattern matrix replace the
reference's per-site dict lookups.

Reference semantics kept: a genotype with ANY missing allele contributes
nothing to the frequency ranking (Genotype.numAlleles collapses to all
-999 on any N, genomics.py:352-353); unsorted codes like "10" are counted
only if enumerated (they are not, so they fall through silently); counts
print as str(float).
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np

from ..io import geno as geno_io
from ..io import writers
from ..samples import SampleData


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="countGenotypePatterns")
    parser.add_argument("-i", "--infile", action="store")
    parser.add_argument("-f", "--genoFormat", action="store",
                        choices=("phased", "diplo", "alleles"),
                        default="phased")
    parser.add_argument("-o", "--outfile", action="store")
    parser.add_argument("-s", "--samples", action="store")
    parser.add_argument("--maxAlleles", type=int, action="store", default=2,
                        choices=[2, 3, 4])
    parser.add_argument("--includeNull", action="store_true")
    parser.add_argument("--maxSites", type=int, action="store")
    parser.add_argument("--test", action="store_true")
    args = parser.parse_args(argv)

    src = args.infile if args.infile else sys.stdin
    fmt = "pairs" if args.genoFormat == "alleles" else args.genoFormat
    probe = geno_io.GenoReader(src, geno_format=fmt)
    all_names = probe.file_ind_names
    samples = args.samples.split(",") if args.samples else list(all_names)
    for s in samples:
        assert s in all_names, "Specified sample name not in VCF header."
    n_samples = len(samples)
    sys.stderr.write(f"\n {n_samples} samples will be considered.")

    sd = SampleData(ind_names=samples, ploidy={s: 2 for s in samples})
    reader = geno_io.rebind_reader(probe, sd)
    model = reader.model
    # per-sample haplotype rows, in the requested sample order
    row_of = dict(zip(model.sample_names, model.sample_rows))
    rows = np.stack([row_of[s] for s in samples])          # [n_ind, 2]

    elements = [str(x) for x in range(args.maxAlleles)]
    if args.includeNull:
        elements += ["N"]
    genotypes = ["".join(x) for x in
                 itertools.combinations_with_replacement(elements, 2)]
    sys.stderr.write("\nThe following genotypes will be considered:\n")
    sys.stderr.write(" ".join(genotypes))
    n_patterns = len(genotypes) ** n_samples
    sys.stderr.write(f"\nThis corresponds to {n_patterns} unique patterns.\n")
    assert n_patterns <= 1000000, \
        "Trying to evaluate this many patterns will use too much memory."
    patterns = list(itertools.product(genotypes, repeat=n_samples))

    from ..encoding import alleles_by_freq_ranks

    def chunk_keys(alleles: np.ndarray) -> np.ndarray:
        """Vectorized per-site coded-pattern byte keys for one chunk."""
        S = alleles.shape[1]
        a0 = alleles[rows[:, 0]]                # [n_ind, S]
        a1 = alleles[rows[:, 1]]
        geno_missing = (a0 < 0) | (a1 < 0)      # any-N -> genotype missing

        # allele counts per site over non-missing genotypes only
        eff0 = np.where(geno_missing, -1, a0)
        eff1 = np.where(geno_missing, -1, a1)
        counts = np.zeros((S, 4), np.int64)
        for arr in (eff0, eff1):
            for b in range(4):
                counts[:, b] += (arr == b).sum(axis=0)

        # rank of each base per site (byFreq quicksort tie order)
        rank = alleles_by_freq_ranks(counts)
        code_chars = np.array([ord("0") + i for i in range(4)], np.uint8)
        c0 = np.where(geno_missing, ord("."),
                      code_chars[rank[np.arange(S)[None, :],
                                      np.maximum(a0, 0)]])
        c1 = np.where(geno_missing, ord("."),
                      code_chars[rank[np.arange(S)[None, :],
                                      np.maximum(a1, 0)]])
        pat = np.empty((S, n_samples * 2), np.uint8)
        pat[:, 0::2] = c0.T
        pat[:, 1::2] = c1.T
        return pat.view([("k", f"S{n_samples * 2}")]).ravel()["k"]

    # stream chunks; the tally is O(distinct patterns), not O(sites)
    from .. import engine as _engine
    tally: dict[str, int] = {}
    sites_left = args.maxSites if args.maxSites else None
    for chunk in _engine._prefetched(reader.iter_chunks()):
        alleles = chunk.alleles
        if sites_left is not None:
            if sites_left <= 0:
                break
            alleles = alleles[:, :sites_left]
            sites_left -= alleles.shape[1]
        if alleles.shape[1] == 0:
            continue
        keys = chunk_keys(alleles)
        if args.test:
            # the reference's --test echoes each parsed site + its coded
            # pattern to stderr (countGenotypePatterns.py:96-103; its
            # scaffold/position echo crashes on a "positin" typo — we print
            # the working equivalent, without the 50 ms/site sleep)
            for s in range(keys.shape[0]):
                k = keys[s].decode()
                sys.stderr.write(
                    f"{reader.scaffold_names[chunk.scaffold_ids[s]]},"
                    f"{int(chunk.positions[s])},"
                    f"{','.join(k[i:i + 2] for i in range(0, len(k), 2))}\n")
        uniq, cnt = np.unique(keys, return_counts=True)
        for u, c in zip(uniq, cnt):
            key = u.decode()
            tally[key] = tally.get(key, 0) + int(c)

    out = writers.open_out(args.outfile)
    out.write(",".join(samples) + ",count\n")
    for patt in patterns:
        for geno in patt:
            out.write(geno + ",")
        out.write(str(float(tally.get("".join(patt), 0))) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
