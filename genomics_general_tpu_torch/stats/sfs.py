"""Site-frequency-spectrum accumulation.

Replicates the reference sfs.py semantics on top of device-computed
per-site per-population base counts:

* conservative complete-data gate: a site contributes only if every ingroup
  population's (possibly downsampled) counts sum to its haplotype count
  (sfs.py:453),
* polarized target selection via getTargetCounts (sfs.py:60-85), including
  its quirks: the outgroup-monomorphy test parses as ``(True & nOut) != 1``;
  invariant sites take the first all-absent allele as target; folded spectra
  take ``totalCounts.argsort()[-2]`` with numpy argsort tie order,
* downsampling without replacement via np.random.choice on the seeded global
  RNG, consuming the stream in the reference's per-site per-pop order
  (sfs.py:23-24, 51),
* sparse nested-dict spectra whose OUTPUT ORDER is the nested first-insertion
  order of the reference's SparseFS.asChains (sfs.py:94-122).
"""

from __future__ import annotations

import numpy as np


class SparseFS:
    """Nested insertion-ordered sparse spectrum (reference SparseFS)."""

    def __init__(self, dimensions: int, intervals: int = 1):
        self.dimensions = dimensions
        self.intervals = intervals
        self.d: dict = {}

    def add(self, freqs, value=1):
        node = self.d
        for f in freqs[:-1]:
            node = node.setdefault(int(f), {})
        k = int(freqs[-1])
        if k not in node:
            node[k] = np.zeros(self.intervals, dtype=int)
        node[k] = node[k] + value

    def chains(self, node=None, prefix=()):
        if node is None:
            node = self.d
        for k, v in node.items():
            if isinstance(v, dict):
                yield from self.chains(v, prefix + (k,))
            else:
                yield list(prefix) + [k] + list(v)

    def as_text(self) -> str:
        return "\n".join("\t".join(str(x) for x in chain)
                         for chain in self.chains()) + "\n"


def down_sample_base_counts(base_counts: np.ndarray, n: int) -> np.ndarray:
    """Reference downSampleBaseCounts (sfs.py:23-24): sample n haplotypes
    without replacement from the expanded allele list, via the global
    np.random stream (seeded by --seed)."""
    return np.bincount(
        np.random.choice(np.repeat(np.arange(4), base_counts), n, replace=False),
        minlength=4)


def get_target_counts(pop_counts: np.ndarray, outgroup_counts=None,
                      outgroup_mono: bool = True):
    """Reference getTargetCounts (sfs.py:60-85).  pop_counts [P,4] for
    ingroup pops; returns [P] target-allele counts or None."""
    total = pop_counts.sum(axis=0)
    alleles = total > 0
    if outgroup_counts is not None:
        out_alleles = outgroup_counts > 0
        all_alleles = alleles | out_alleles
    else:
        all_alleles = alleles
    if not 1 <= all_alleles.sum() <= 2:
        return None
    if outgroup_counts is not None:
        n_out = int(out_alleles.sum())
        # reference: `nOutAlleles == 0 or (outgroupMono & nOutAlleles != 1)`
        # parses as (outgroupMono & nOutAlleles) != 1
        if n_out == 0 or ((int(outgroup_mono) & n_out) != 1):
            return None
        cand = np.where(~out_alleles & alleles)[0]
        if cand.size:
            target = cand[0]
        else:
            target = np.where(~alleles)[0][0]
    else:
        target = total.argsort()[-2]
    return pop_counts[:, target]
