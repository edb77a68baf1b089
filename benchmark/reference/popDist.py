"""popDist: pi of each population, the mean distance over the pairs of its
haplotypes (genomics.py groupDistStats)."""

from __future__ import annotations

from . import _plain

RANK = 20


def columns(pops: list[str]) -> list[tuple[str, str]]:
    return [(f"pi_{p}", "float") for p in pops]


def pi(job) -> dict:
    sums, counts = _plain.block_sums(job)
    dt = job.np_dtype
    out = {}
    for i, (p, rows) in enumerate(job.groups.items()):
        out[p] = _plain.gated_mean(sums[:, i, i], counts[:, i, i],
                                   len(rows) ** 2, job.opts["minData"], dt)
    return out


def compute(job) -> dict:
    return {f"pi_{p}": v for p, v in pi(job).items()}
