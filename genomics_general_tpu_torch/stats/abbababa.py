"""ABBA-BABA / f4-statistic family, finalized in float64 on host.

Implements the full panel of four-taxon statistics from the reference
(f4 family genomics.py:1409-1581; window drivers ``fourPop``
:1585-1643 and ``ABBABABA`` :1647-1695) on top of device-computed per-site
per-population base counts.  All semantics are preserved:

* site selection: biallelic across the 4-population union AND per-pop
  non-missing fraction >= minData (genomics.py:1655-1660),
* allele choice: ``polarize`` -> every allele present overall but absent from
  P4 (can be 0 or >1 per site; sitesUsed counts (site, allele) pairs);
  ``fixed`` -> additionally P1/P2/P3 each fixed; default/minor -> the
  second-highest-frequency allele via ``np.argsort(freqs)[:, 2]``
  (:1672-1677, including argsort tie behavior),
* ratio-of-sums (not mean-of-ratios) for every statistic.
"""

from __future__ import annotations

import numpy as np

FOURPOP_STATS = ['fhom', "fhom'", 'D', 'fd', "fd'", 'fdm', "fdm'",
                 'fdh', 'fdh2', 'fh', "ABBA", "BABA", "ABAA", "BAAA", "sitesUsed"]
ABBABABA_STATS = ['D', 'fd', 'fdM', "ABBA", "BABA", "sitesUsed"]


# ---- f4 family (genomics.py:1409-1581), verbatim math ----------------------

def f4(p1, p2, p3, p4):
    return (1 - p1) * p2 * p3 * (1 - p4) - p1 * (1 - p2) * p3 * (1 - p4)


def f4_c(p1, p2, p3, p4):
    return f4(p1, p2, p3, p4) + f4(1 - p1, 1 - p2, 1 - p3, 1 - p4)


def fhom_old(p1, p2, p3, p4):
    return f4(p1, p2, p3, p4).sum() * 1.0 / f4(p1, p3, p3, p4).sum()


def fhom_new(p1, p2, p3, p4):
    return (f4_c(p1, p2, p3, p4)).sum() * 1.0 / (f4_c(p1, p3, p3, p4)).sum()


def D_stat(p1, p2, p3, p4):
    return f4(p1, p2, p3, p4).sum() * 1.0 / (
        (1 - p1) * p2 * p3 * (1 - p4) + p1 * (1 - p2) * p3 * (1 - p4)).sum()


def fd(p1, p2, p3, p4):
    pd = p2 * (p2 > p3) + p3 * (p3 >= p2)
    return f4(p1, p2, p3, p4).sum() * 1.0 / f4(p1, pd, pd, p4).sum()


def fd_new(p1, p2, p3, p4):
    pd = p2 * (p2 > p3) + p3 * (p3 >= p2)
    return (f4_c(p1, p2, p3, p4)).sum() * 1.0 / (f4_c(p1, pd, pd, p4)).sum()


def get_fdm_p(p1, p2, p3):
    a = (p3 > p1)
    b = (p3 > p2)
    x = (p1 > p2)
    y = ~x
    pdm1 = p3 * (x & a) + p1 * (~(x & a))
    pdm2 = p3 * (y & b) + p2 * (~(y & b))
    pdm3 = -p3 * (x & a) + p3 * (y & b) - p1 * (x & ~a) + p2 * (y & ~b)
    return pdm1, pdm2, pdm3


def fdm(p1, p2, p3, p4):
    pdm1, pdm2, pdm3 = get_fdm_p(p1, p2, p3)
    denom = f4(pdm1, pdm2, pdm3, p4)
    return f4(p1, p2, p3, p4).sum() * 1.0 / denom.sum()


def fdm_new(p1, p2, p3, p4):
    pdm1, pdm2, pdm3 = get_fdm_p(p1, p2, p3)
    denom = f4_c(pdm1, pdm2, pdm3, p4)
    return (f4_c(p1, p2, p3, p4)).sum() * 1.0 / denom.sum()


def fdh(p1, p2, p3, p4):
    num = f4_c(p1, p2, p3, p4)
    t11 = f4_c(p1, p3, p3, p4)
    t12 = f4_c(p4, p2, p3, p4)
    t21 = f4_c(p3, p2, p3, p4)
    t22 = f4_c(p1, p4, p3, p4)
    denom = np.amax([t11, t12, t21, t22], axis=0)
    return num.sum() * 1.0 / denom.sum()


def fdh2(p1, p2, p3, p4):
    num = f4_c(p1, p2, p3, p4)
    t11 = f4_c(p1, p3, p3, p4)
    t12 = f4_c(p4, p2, p3, p4)
    t21 = f4_c(p3, p2, p3, p4)
    t22 = f4_c(p1, p4, p3, p4)
    t31 = f4_c(p1, p2, p2, p4)
    t32 = f4_c(p1, p2, p3, p1)
    t41 = f4_c(p1, p2, p1, p4)
    t42 = f4_c(p1, p2, p3, p2)
    denom = np.amax([t11, t12, t21, t22, t31, t32, t41, t42], axis=0)
    return num.sum() * 1.0 / denom.sum()


def fh(p1, p2, p3, p4):
    t1 = np.abs((p1 - p2))
    t2 = np.abs((p3 - p4))
    denom = (t1 * (t1 > t2) + t2 * (t2 >= t1)) ** 2
    return (f4(p1, p2, p3, p4) + f4(1 - p1, 1 - p2, 1 - p3, 1 - p4)).sum() * 1.0 / denom.sum()


def ABAA(p1, p2, p3, p4):
    return ((1 - p1) * p2 * (1 - p3) * (1 - p4)).sum()


def BAAA(p1, p2, p3, p4):
    return (p1 * (1 - p2) * (1 - p3) * (1 - p4)).sum()


def ABBA(p1, p2, p3, p4):
    return ((1 - p1) * p2 * p3 * (1 - p4)).sum()


def BABA(p1, p2, p3, p4):
    return (p1 * (1 - p2) * p3 * (1 - p4)).sum()


# ---- window drivers --------------------------------------------------------

def _freqs(counts: np.ndarray) -> np.ndarray:
    """[S,4] counts -> [S,4] float64 freqs; all-missing sites -> NaN row
    (binBaseFreqs empty case, genomics.py:592-599)."""
    n = counts.sum(axis=1, dtype=np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        f = counts.astype(np.float64) / n[:, None].astype(np.float64)
    f[n == 0] = np.nan
    return f


def window_four_pop_panel(counts_pops: list[np.ndarray], counts_union: np.ndarray,
                          n_pops: list[int], min_data: float,
                          polarize: bool, fixed: bool,
                          full_panel: bool, with_sums: bool = False) -> dict:
    """One window.  counts_pops: four [S,4] int arrays (P1..P4=outgroup);
    counts_union: [S,4] over the union of the four pops' haplotype rows.

    ``with_sums`` adds the raw ratio components ``_num_f4`` / ``_den_D`` /
    ``_den_fd`` / ``_den_fdm`` (window-level partial sums for the block
    jackknife, jackknife.R:41-61)."""
    nonmiss_union = counts_union.sum(axis=1, dtype=np.int64)
    biallelic = (counts_union > 0).sum(axis=1) == 2
    enough = np.ones(counts_union.shape[0], dtype=bool)
    for c, n in zip(counts_pops, n_pops):
        nm = c.sum(axis=1, dtype=np.int64)
        enough &= (nm * 1.0 / n) >= min_data
    good = np.flatnonzero(biallelic & enough)
    stats_names = FOURPOP_STATS if full_panel else ABBABABA_STATS
    if good.size < 1:
        out = dict(zip(stats_names, [np.nan] * (len(stats_names) - 1) + [0]))
        if with_sums:
            out.update(_num_f4=0.0, _den_D=0.0, _den_fd=0.0, _den_fdm=0.0)
        return out

    all4freqs = _freqs(counts_union[good])
    Pfreqs = [_freqs(c[good]) for c in counts_pops]
    P1f, P2f, P3f, P4f = Pfreqs

    with np.errstate(invalid="ignore"):
        if polarize:
            allele_index = np.where((all4freqs > 0) & (P4f == 0))
        elif fixed:
            allele_index = np.where((all4freqs > 0) & (P4f == 0) &
                                    ((P1f == 0) | (P1f == 1)) &
                                    ((P2f == 0) | (P2f == 1)) &
                                    ((P3f == 0) | (P3f == 1)))
        else:
            allele_index = (np.arange(all4freqs.shape[0]),
                            np.argsort(all4freqs, axis=1)[:, 2])

    p1 = P1f[allele_index[0], allele_index[1]]
    p2 = P2f[allele_index[0], allele_index[1]]
    p3 = P3f[allele_index[0], allele_index[1]]
    p4 = P4f[allele_index[0], allele_index[1]]
    sites_used = len(allele_index[0])

    with np.errstate(invalid="ignore", divide="ignore"):
        if full_panel:
            vals = [fhom_old(p1, p2, p3, p4), fhom_new(p1, p2, p3, p4),
                    D_stat(p1, p2, p3, p4), fd(p1, p2, p3, p4),
                    fd_new(p1, p2, p3, p4), fdm(p1, p2, p3, p4),
                    fdm_new(p1, p2, p3, p4), fdh(p1, p2, p3, p4),
                    fdh2(p1, p2, p3, p4), fh(p1, p2, p3, p4),
                    ABBA(p1, p2, p3, p4), BABA(p1, p2, p3, p4),
                    ABAA(p1, p2, p3, p4), BAAA(p1, p2, p3, p4), sites_used]
        else:
            vals = [D_stat(p1, p2, p3, p4), fd(p1, p2, p3, p4),
                    fdm(p1, p2, p3, p4), ABBA(p1, p2, p3, p4),
                    BABA(p1, p2, p3, p4), sites_used]
    out = dict(zip(stats_names, vals))
    if with_sums:
        with np.errstate(invalid="ignore"):
            pd_ = p2 * (p2 > p3) + p3 * (p3 >= p2)
            pdm1, pdm2, pdm3 = get_fdm_p(p1, p2, p3)
            out["_num_f4"] = float(f4(p1, p2, p3, p4).sum())
            out["_den_D"] = float((
                (1 - p1) * p2 * p3 * (1 - p4)
                + p1 * (1 - p2) * p3 * (1 - p4)).sum())
            out["_den_fd"] = float(f4(p1, pd_, pd_, p4).sum())
            out["_den_fdm"] = float(f4(pdm1, pdm2, pdm3, p4).sum())
    return out


def abbababa_windows(counts_pops: list[np.ndarray], counts_union: np.ndarray,
                     n_pops: list[int], spans, min_data: float,
                     polarize: bool = True, fixed: bool = False,
                     full_panel: bool = False) -> list[dict]:
    """Apply the window driver to each (first, last) span (chunk-level count
    arrays are sliced per window; windows are contiguous spans)."""
    out = []
    for f, l in spans:
        out.append(window_four_pop_panel(
            [c[f:l] for c in counts_pops], counts_union[f:l],
            n_pops, min_data, polarize, fixed, full_panel))
    return out
