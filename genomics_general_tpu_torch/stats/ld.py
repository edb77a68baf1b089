"""Linkage-disequilibrium statistics and LD-maximizing pseudo-phasing.

Host mirror of the reference LD layer: per-pair D / D' / r / r2
(genomics.py:1132-1157 — including the D/Dmin sign convention and
major-allele 'ancestral' default), whole-window LD matrices
(genomics.py:1072-1077), and the greedy haplotype re-phasing
``max_ld_phase`` (genomics.py:1166-1194) used by phyml_sliding_windows
--maxLDphase.
"""

from __future__ import annotations

import itertools

import numpy as np

NAN_LD = {"D": np.nan, "Dprime": np.nan, "r": np.nan, "r2": np.nan}


def ld_pair(bases_a: np.ndarray, bases_b: np.ndarray, anc_a=None, anc_b=None):
    """LD between two sites given per-haplotype allele codes (missing < 0)."""
    arr = np.column_stack([bases_a, bases_b])
    arr = arr[(arr >= 0).all(axis=1)]
    alleles_a, counts_a = np.unique(arr[:, 0], return_counts=True)
    alleles_b, counts_b = np.unique(arr[:, 1], return_counts=True)
    if not len(alleles_a) == len(alleles_b) == 2:
        return dict(NAN_LD)
    if anc_a is None:
        anc_a = alleles_a[counts_a == max(counts_a)][0]
    else:
        assert anc_a in alleles_a, "ancestral allele not present"
    if anc_b is None:
        anc_b = alleles_b[counts_b == max(counts_b)][0]
    else:
        assert anc_b in alleles_b, "ancestral allele not present"
    bool_arr = arr != [anc_a, anc_b]
    p_a, p_b = np.mean(bool_arr, axis=0)
    p_ab = np.mean(bool_arr.all(axis=1))
    d = p_ab - p_a * p_b
    d_min = max(-p_a * p_b, -(1 - p_a) * (1 - p_b)) if d < 0 \
        else min(p_a * (1 - p_b), (1 - p_a) * p_b)
    with np.errstate(invalid="ignore", divide="ignore"):
        d_prime = d / d_min
        r = d / np.sqrt(p_a * (1 - p_a) * p_b * (1 - p_b))
    return {"D": d, "Dprime": d_prime, "r": r, "r2": r ** 2}


def ld_from_tables(tables: np.ndarray, stat: str = "r2") -> np.ndarray:
    """Float64 LD stats from joint allele-count tables [..., 4, 4]
    (vectorized ld_pair: per-PAIR biallelic gate over the jointly-called
    subset, major-allele 'ancestral' with lowest-code tie-break, D/Dmin
    sign convention — genomics.py:1132-1157)."""
    N = tables.astype(np.int64)
    na = N.sum(axis=-1)                       # [..., 4] site-a marginals
    nb = N.sum(axis=-2)                       # [..., 4] site-b marginals
    n = na.sum(axis=-1).astype(np.float64)    # jointly-called haplotypes
    bial = ((na > 0).sum(axis=-1) == 2) & ((nb > 0).sum(axis=-1) == 2)
    anc_a = np.argmax(na, axis=-1)            # first max = lowest code
    anc_b = np.argmax(nb, axis=-1)
    ia = np.expand_dims(anc_a, (-2, -1))
    ib = np.expand_dims(anc_b, (-2, -1))
    n_aa = np.take_along_axis(na, anc_a[..., None], -1)[..., 0]
    n_bb = np.take_along_axis(nb, anc_b[..., None], -1)[..., 0]
    n_ab = np.take_along_axis(
        np.take_along_axis(N, ia, -2), ib, -1)[..., 0, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        # derived-count / n, matching ld_pair's np.mean over booleans
        # bit-for-bit (1 - n_aa/n would round differently)
        p_a = (n - n_aa) / n
        p_b = (n - n_bb) / n
        p_ab = (n - n_aa - n_bb + n_ab) / n
        d = p_ab - p_a * p_b
        d_min = np.where(
            d < 0,
            np.maximum(-p_a * p_b, -(1 - p_a) * (1 - p_b)),
            np.minimum(p_a * (1 - p_b), (1 - p_a) * p_b))
        d_prime = d / d_min
        r = d / np.sqrt(p_a * (1 - p_a) * p_b * (1 - p_b))
        out = {"D": d, "Dprime": d_prime, "r": r, "r2": r ** 2}[stat]
    return np.where(bial, out, np.nan)


def joint_tables(cols: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Joint allele tables of one column vs many: [K, 4, 4] int64.

    cols [H, K], cand [H]; rows where either is missing are excluded."""
    called = (cols >= 0) & (cand >= 0)[:, None]               # [H, K]
    codes = np.arange(4, dtype=np.int8)
    oh_cols = (cols[:, :, None] == codes) & called[:, :, None]
    oh_cand = cand[:, None] == codes                          # [H, 4]
    return np.einsum("hka,hb->kab", oh_cols.astype(np.int64),
                     oh_cand.astype(np.int64))


def ld_matrix(alleles: np.ndarray, stat: str = "r2",
              use_device: bool = False) -> np.ndarray:
    """[S, S] pairwise LD over a window's [H, S] allele matrix
    (Alignment.LDmatrix, genomics.py:1072-1077).

    ``use_device=True`` computes the joint tables on the device
    ``GGT_DEVICE`` names (kernels/ld.window_pair_tables: the CUDA kernel
    K17 on a card); otherwise a vectorized numpy einsum.
    Either way the float64 finalize is :func:`ld_from_tables` — both paths
    replace the reference's O(S^2) per-pair np.unique loop."""
    if use_device:
        from ..kernels.ld import window_pair_tables
        tables = window_pair_tables(alleles)
    else:
        codes = np.arange(4, dtype=np.int8)
        oh = (alleles[:, :, None] == codes).astype(np.int64)  # [H, S, 4]
        H, S, _ = oh.shape
        flat = oh.reshape(H, S * 4)
        tables = (flat.T @ flat).reshape(S, 4, S, 4).transpose(0, 2, 1, 3)
    return ld_from_tables(tables, stat)


def unique_indices(things, preserve_order=False):
    t, first, inverse = np.unique(things, return_index=True,
                                  return_inverse=True)
    indices = [np.where(inverse == i)[0] for i in range(len(t))]
    order = np.argsort(first) if preserve_order else np.arange(len(first))
    return [t[order], [indices[i] for i in order]]


def max_ld_phase(alleles: np.ndarray, sample_names, stat: str = "r2"):
    """Greedy LD-maximizing pseudo-phasing (genomics.py:1166-1194).

    alleles: [H, S] haplotype codes; sample_names: per-row sample labels
    (consecutive rows of one sample are that sample's haplotypes).  Returns
    a re-phased copy.

    The greedy ordering and comparisons are the reference's, but each
    step's "candidate vs all placed columns" LD sweep is one vectorized
    table build + :func:`ld_from_tables` instead of per-pair np.unique
    calls — a ~250-site window drops from ~31k python LD calls to ~250
    einsums (tested bit-identical against the reference in
    tests/test_phylo.py)."""
    sample_indices = unique_indices(sample_names, preserve_order=True)[1]
    H, S = alleles.shape
    assert H == sum(len(ind) for ind in sample_indices)
    nan_mask = alleles >= 0
    n_hets = np.array([
        sum(len(np.unique(alleles[ind, x][nan_mask[ind, x]])) > 1
            for ind in sample_indices) for x in range(S)])
    sites_to_do = np.argsort(n_hets)[::-1]
    sites_to_do = sites_to_do[n_hets[sites_to_do] >= 1]
    new = alleles.copy()
    if len(sites_to_do) >= 2:
        first = sites_to_do[0]
        new[:, first] = list(itertools.chain(
            *[sorted(new[ind, first]) for ind in sample_indices]))
        for x in range(1, len(sites_to_do)):
            opt1 = np.fromiter(itertools.chain(
                *[sorted(new[ind, sites_to_do[x]])
                  for ind in sample_indices]), dtype=alleles.dtype, count=H)
            opt2 = np.fromiter(itertools.chain(
                *[sorted(new[ind, sites_to_do[x]])[::-1]
                  for ind in sample_indices]), dtype=alleles.dtype, count=H)
            placed = new[:, sites_to_do[:x]]                  # [H, x]
            with np.errstate(invalid="ignore", divide="ignore"):
                ld1 = np.mean(ld_from_tables(joint_tables(placed, opt1),
                                             stat))
                ld2 = np.mean(ld_from_tables(joint_tables(placed, opt2),
                                             stat))
            new[:, sites_to_do[x]] = opt1 if ld1 >= ld2 else opt2
    return new
