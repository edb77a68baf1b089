"""Vectorized site filtering (reference siteTest, genomics.py:742-799)
and the exact Hardy-Weinberg test (Wigginton et al. 2005; genomics.py:678-739).

All filters evaluate as boolean masks over the site axis from device-computed
base counts plus per-individual call masks; the conjunction replicates the
reference's accept/reject decision per site (the reference short-circuits,
which only matters for inputs where it would crash).
"""

from __future__ import annotations

import math

import numpy as np


def hwe_test(obs_het: int, obs_hom1: int, obs_hom2: int, side: str = "both") -> float:
    """Exact HWE P-value (genomics.py:678-723)."""
    if obs_hom1 < 0 or obs_hom2 < 0 or obs_het < 0:
        return -1.0
    N = obs_het + obs_hom1 + obs_hom2
    obs_hom_rare, obs_hom_com = sorted([obs_hom1, obs_hom2])
    rare = obs_hom_rare * 2 + obs_het
    probs = [0.0] * (rare + 1)
    mid = math.floor(rare * (2 * N - rare) / (2 * N))
    if mid % 2 != rare % 2:
        mid += 1
    probs[int(mid)] = 1.0
    my_sum = 1.0
    curr_het = int(mid)
    curr_hom_rare = int(rare - mid) / 2
    curr_hom_com = N - curr_het - curr_hom_rare
    while curr_het >= 2:
        probs[curr_het - 2] = probs[curr_het] * curr_het * (curr_het - 1.0) / \
            (4.0 * (curr_hom_rare + 1.0) * (curr_hom_com + 1.0))
        my_sum += probs[curr_het - 2]
        curr_het -= 2
        curr_hom_rare += 1
        curr_hom_com += 1
    curr_het = int(mid)
    curr_hom_rare = int(rare - mid) / 2
    curr_hom_com = N - curr_het - curr_hom_rare
    while curr_het <= rare - 2:
        probs[curr_het + 2] = probs[curr_het] * 4.0 * curr_hom_rare * curr_hom_com / \
            ((curr_het + 2.0) * (curr_het + 1.0))
        my_sum += probs[curr_het + 2]
        curr_het += 2
        curr_hom_rare -= 1
        curr_hom_com -= 1
    if side == "top":
        p = min(1.0, sum(probs[obs_het:(rare + 1)]) / my_sum)
    elif side == "bottom":
        p = min(1.0, sum(probs[0:(obs_het + 1)]) / my_sum)
    else:
        target = probs[obs_het]
        p = min(1.0, sum(prob for prob in probs if prob <= target) / my_sum)
    return p


def in_hwe_site(ind_codes: np.ndarray, p_value: float, side: str = "both") -> bool:
    """Reference inHWE (genomics.py:725-739) for one site: ind_codes [n_ind, 2]
    diploid allele codes (-1 missing).  Genotypes with any missing allele are
    dropped (the reference converts to 'N' diplotypes)."""
    complete = (ind_codes >= 0).all(axis=1)
    g = ind_codes[complete]
    if g.shape[0] == 0:
        return True
    alleles = np.unique(g)
    if alleles.size == 1:
        return True
    if alleles.size > 2:
        return False
    a, b = int(alleles[0]), int(alleles[1])
    hom1 = int(((g[:, 0] == a) & (g[:, 1] == a)).sum())
    hom2 = int(((g[:, 0] == b) & (g[:, 1] == b)).sum())
    het = g.shape[0] - hom1 - hom2
    p = hwe_test(het, hom1, hom2)
    return p > p_value


def site_test_masks(counts_all: np.ndarray, ind_nonmissing: np.ndarray,
                    ind_het: np.ndarray, pop_counts: dict | None,
                    pop_ind_nonmissing: dict | None,
                    min_calls=1, min_pop_calls=None, min_alleles=0,
                    max_alleles=float("inf"), min_pop_alleles=None,
                    max_pop_alleles=None, min_var_count=None, max_het=None,
                    min_freq=None, max_freq=None, fixed=False,
                    nearly_fixed_diff=None) -> np.ndarray:
    """Vectorized siteTest (HWE applied separately).

    counts_all : int [S, 4] base counts over the tested samples' haplotypes
    ind_nonmissing : bool [S, n_ind] — individual has no missing allele
    ind_het : bool [S, n_ind] — individual has >1 distinct allele value
        (including missing-vs-called, matching GenomeSite.hets; genomics.py:565-570)
    pop_counts : pop -> int [S, 4]
    pop_ind_nonmissing : pop -> bool [S, n_pop_ind]
    """
    S = counts_all.shape[0]
    good = np.ones(S, dtype=bool)

    n_calls = ind_nonmissing.sum(axis=1)
    good &= n_calls >= min_calls

    n_alleles = (counts_all > 0).sum(axis=1)
    good &= (min_alleles <= n_alleles) & (n_alleles <= max_alleles)

    variant = n_alleles > 1
    if min_var_count:
        second = np.sort(counts_all, axis=1)[:, 2]
        good &= ~variant | (second >= min_var_count)
    if max_het is not None:
        with np.errstate(invalid="ignore", divide="ignore"):
            het_prop = ind_het.sum(axis=1) / n_calls
        good &= ~variant | ~(het_prop > max_het)
    if min_freq or max_freq:
        tot = counts_all.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            freqs = counts_all / tot[:, None]
        second_f = np.sort(freqs, axis=1)[:, 2]
        if min_freq:
            good &= ~variant | (min_freq <= second_f)
        if max_freq:
            good &= ~variant | (second_f <= max_freq)

    if pop_counts:
        pop_names = list(pop_counts.keys())
        if min_pop_calls:
            for p in pop_names:
                good &= pop_ind_nonmissing[p].sum(axis=1) >= min_pop_calls[p]
        pop_n_alleles = {p: (pop_counts[p] > 0).sum(axis=1) for p in pop_names}
        if fixed:
            all_mono = np.ones(S, dtype=bool)
            for p in pop_names:
                all_mono &= pop_n_alleles[p] == 1
            union_present = np.zeros((S, 4), dtype=bool)
            for p in pop_names:
                union_present |= pop_counts[p] > 0
            good &= all_mono & (union_present.sum(axis=1) > 1)
        if min_pop_alleles or max_pop_alleles:
            mn = min_pop_alleles or {p: 0 for p in pop_names}
            mx = max_pop_alleles or {p: 4 for p in pop_names}
            for p in pop_names:
                good &= (mn[p] <= pop_n_alleles[p]) & (pop_n_alleles[p] <= mx[p])
        if nearly_fixed_diff is not None:
            any_big = np.zeros(S, dtype=bool)
            freqs = {}
            for p in pop_names:
                tot = pop_counts[p].sum(axis=1)
                with np.errstate(invalid="ignore", divide="ignore"):
                    freqs[p] = pop_counts[p] / tot[:, None]
            import itertools
            for a, b in itertools.combinations(pop_names, 2):
                with np.errstate(invalid="ignore"):
                    d = np.abs(freqs[a] - freqs[b])
                    any_big |= np.any(d >= nearly_fixed_diff, axis=1)
            good &= any_big
    return good
