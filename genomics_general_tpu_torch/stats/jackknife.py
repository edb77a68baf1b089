"""Block jackknife: genome-block resampling for statistic standard errors.

Mirror of jackknife.R: position/chromosome block assignment
(get.block.indices, jackknife.R:5-36) and delete-one-block pseudovalues ->
mean / variance / sd / SE (block.jackknife, jackknife.R:41-61; variance is
the n-1 sample variance, as in R).

For ratio-of-sums statistics (D, fd, fdM, ... — every ABBA-BABA statistic
is sum(num)/sum(den) over sites or windows) ``ratio_jackknife`` computes
all leave-one-out values from per-block partial sums in O(blocks) — one
subtraction per block instead of a full re-reduction, which is also the
shape a ``psum``-based multi-host merge wants: hosts contribute per-block
partial sums and the jackknife runs on the tiny [n_blocks] vectors.
"""

from __future__ import annotations

import numpy as np


def block_indices(block_size: int, positions, chromosomes=None):
    """Assign observation indices to genome blocks (jackknife.R:5-36).
    Returns a list of index arrays for the non-empty blocks."""
    positions = np.asarray(positions)
    out = []
    if chromosomes is None:
        starts = np.arange(positions.min(), positions.max() + 1, block_size)
        for s in starts:
            idx = np.flatnonzero((positions >= s) &
                                 (positions <= s + block_size - 1))
            if idx.size:
                out.append(idx)
    else:
        chromosomes = np.asarray(chromosomes)
        seen = []
        for c in chromosomes:
            if c not in seen:
                seen.append(c)
        for c in seen:
            on_c = chromosomes == c
            p = positions[on_c]
            starts = np.arange(p.min(), p.max() + 1, block_size)
            for s in starts:
                idx = np.flatnonzero(on_c & (positions >= s) &
                                     (positions <= s + block_size - 1))
                if idx.size:
                    out.append(idx)
    return out


def _summarize(pseudovalues: np.ndarray) -> dict:
    n = pseudovalues.shape[0]
    mean = float(np.mean(pseudovalues))
    var = float(np.var(pseudovalues, ddof=1))
    sd = var ** 0.5
    return {"mean": mean, "variance": var, "standard_deviation": sd,
            "standard_error": sd / n ** 0.5}


def block_jackknife(indices: list, fun, *arrays) -> dict:
    """Generic delete-one-block jackknife (jackknife.R:41-61).  ``fun`` maps
    the arrays (indexed along axis 0) to a scalar."""
    n = len(indices)
    overall = fun(*arrays)
    pseudo = np.empty(n)
    for i, idx in enumerate(indices):
        keep = np.ones(arrays[0].shape[0], bool)
        keep[idx] = False
        pseudo[i] = overall * n - fun(*(a[keep] for a in arrays)) * (n - 1)
    return _summarize(pseudo)


def ratio_jackknife(num_by_block: np.ndarray,
                    den_by_block: np.ndarray) -> dict:
    """Jackknife of sum(num)/sum(den) from per-block partial sums.
    Identical to block_jackknife with fun = ratio-of-sums, but O(blocks)."""
    num_by_block = np.asarray(num_by_block, np.float64)
    den_by_block = np.asarray(den_by_block, np.float64)
    n = num_by_block.shape[0]
    tn, td = num_by_block.sum(), den_by_block.sum()
    overall = tn / td
    loo = (tn - num_by_block) / (td - den_by_block)
    pseudo = overall * n - loo * (n - 1)
    return _summarize(pseudo)


def mean_jackknife(values_by_obs: np.ndarray, indices: list) -> dict:
    """Jackknife of the plain mean, from block partial sums — O(blocks)."""
    v = np.asarray(values_by_obs, np.float64)
    n_obs = v.shape[0]
    n = len(indices)
    total = v.sum()
    block_sums = np.array([v[idx].sum() for idx in indices])
    block_counts = np.array([idx.size for idx in indices])
    overall = total / n_obs
    loo = (total - block_sums) / (n_obs - block_counts)
    pseudo = overall * n - loo * (n - 1)
    return _summarize(pseudo)
