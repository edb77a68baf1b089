"""popPairDist: dxy of each pair of populations (the mean distance between
their haplotypes) and Fst = 1 - pi_s / pi_t, with pi_s the mean of the two
pi weighted by haplotype counts and pi_t the pi of the pooled haplotypes
(genomics.py groupDistStats)."""

from __future__ import annotations

import itertools

import numpy as np

from . import _plain, popDist

RANK = 30


def columns(pops: list[str]) -> list[tuple[str, str]]:
    pairs = list(itertools.combinations(pops, 2))
    return ([(f"dxy_{x}_{y}", "float") for x, y in pairs]
            + [(f"Fst_{x}_{y}", "float") for x, y in pairs])


def compute(job) -> dict:
    sums, counts = _plain.block_sums(job)
    pi = popDist.pi(job)
    dt = job.np_dtype
    md = job.opts["minData"]
    names = list(job.groups)
    size = {p: len(r) for p, r in job.groups.items()}
    out = {}
    for x, y in itertools.combinations(names, 2):
        i, j = names.index(x), names.index(y)
        nx, ny = size[x], size[y]
        out[f"dxy_{x}_{y}"] = _plain.gated_mean(
            sums[:, i, j], counts[:, i, j], nx * ny, md, dt)
        w = dt(nx / (nx + ny))
        pi_s = w * pi[x] + (dt(1) - w) * pi[y]
        blk = np.ix_(range(sums.shape[0]), [i, j], [i, j])
        pi_t = _plain.gated_mean(sums[blk].sum(axis=(1, 2)),
                                 counts[blk].sum(axis=(1, 2)),
                                 (nx + ny) ** 2, md, dt)
        with np.errstate(invalid="ignore", divide="ignore"):
            out[f"Fst_{x}_{y}"] = dt(1) - pi_s / pi_t
    return out
