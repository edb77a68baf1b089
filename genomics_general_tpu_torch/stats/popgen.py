"""Float64 finalize for distance- and frequency-based window statistics.

The device produces exact integer count tensors (mismatch/shared pair counts,
per-site per-pop base counts); this module reproduces the reference's numpy
float64 arithmetic on top of them, including its quirks:

* ``nanmean_min`` minData gate with strict ``<`` (genomics.py:88-90),
* diagonal-NaN / minSites-mask mutation of the *cached* distance matrix, which
  makes later analyses in the same window see the mutated matrix
  (genomics.py:963, 935-940; popgenWindows.py:51-64 ordering),
* the ``sampleHet`` operator-precedence bug (genomics.py:924): the guard
  parses as ``len(x) == (2 & shared) >= minSites``, so a diploid's het is NaN
  unless bit 1 of the shared-site count is set,
* sequential (non-pairwise) Python ``sum`` in groupFreqStats/TajimaD
  (genomics.py:1017-1019, 621-623) — replicated with cumsum tails,
* ``baseCountPi`` term order (genomics.py:609-616).
"""

from __future__ import annotations

import numpy as np


def nanmean_min_blocks(blocks: np.ndarray, min_data: float) -> np.ndarray:
    """Vectorized reference nanmean_min (genomics.py:88-90) over [W, ...] blocks.

    Returns [W] with NaN where the non-NaN fraction is < min_data (strict),
    else np.nanmean of the block.
    """
    W = blocks.shape[0]
    flat = blocks.reshape(W, -1)
    size = flat.shape[1]
    n_nan = np.isnan(flat).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        means = np.nanmean(flat, axis=1)
    gate = (1 - (1.0 * n_nan) / size) < min_data
    means[gate] = np.nan
    return means


def dist_matrix(mismatch: np.ndarray, shared: np.ndarray) -> np.ndarray:
    """float64 proportion distances; 0/0 -> NaN (numHamming of empty mask ->
    np.mean of empty -> NaN, genomics.py:1219-1221)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        d = mismatch.astype(np.float64) / shared.astype(np.float64)
    return d


class DistStatsContext:
    """Holds the (mutable) per-window distance matrices the way the reference
    wrapper holds ``Aln._distMat_`` across analyses (popgenWindows.py:44-64)."""

    def __init__(self, mismatch: np.ndarray, shared: np.ndarray):
        self.shared = shared.astype(np.int64)
        self.dist = dist_matrix(mismatch, shared)   # [W, H, H]
        self.min_sites_applied = False
        self.diag_nan = False

    def apply_min_sites(self, min_sites: int):
        if min_sites:
            self.dist[self.shared < min_sites] = np.nan
        self.min_sites_applied = True

    def fill_diag_nan(self):
        W, H, _ = self.dist.shape
        idx = np.arange(H)
        self.dist[:, idx, idx] = np.nan
        self.diag_nan = True


def group_dist_stats(ctx: DistStatsContext, row_group: list,
                     do_pairs: bool, min_sites: int | None,
                     min_data: float) -> dict:
    """Reference Alignment.groupDistStats (genomics.py:956-995) over a window
    batch.  Mutates ctx.dist exactly like the reference mutates _distMat_."""
    if min_sites:
        ctx.apply_min_sites(min_sites)
    ctx.fill_diag_nan()
    dist = ctx.dist
    groups = np.array(["" if g is None else g for g in row_group])
    pops = np.unique(groups)                       # sorted, genomics.py:965
    pop_idx = [np.flatnonzero(groups == p) for p in pops]

    out = {}
    for x, p in enumerate(pops):
        block = dist[:, pop_idx[x][:, None], pop_idx[x][None, :]]
        out["pi_" + p] = nanmean_min_blocks(block, min_data)

    if len(pops) == 1 or not do_pairs:
        return out

    for x in range(len(pops) - 1):
        for y in range(x + 1, len(pops)):
            bi, bj = pop_idx[x], pop_idx[y]
            dxy = nanmean_min_blocks(dist[:, bi[:, None], bj[None, :]], min_data)
            out["dxy_" + pops[x] + "_" + pops[y]] = dxy
            out["dxy_" + pops[y] + "_" + pops[x]] = dxy
            n_x, n_y = bi.size, bj.size
            w = 1.0 * n_x / (n_x + n_y)
            pi_s = w * out["pi_" + pops[x]] + (1 - w) * out["pi_" + pops[y]]
            pooled = np.concatenate([bi, bj])      # x-then-y order, :992
            pi_t = nanmean_min_blocks(dist[:, pooled[:, None], pooled[None, :]],
                                      min_data)
            with np.errstate(invalid="ignore", divide="ignore"):
                fst = 1 - pi_s / pi_t
            out["Fst_" + pops[x] + "_" + pops[y]] = fst
            out["Fst_" + pops[y] + "_" + pops[x]] = fst
    return out


def group_dist_stats_from_blocks(sums: np.ndarray, cnts: np.ndarray,
                                 pops: list[str], pop_sizes: list[int],
                                 do_pairs: bool, min_data: float) -> dict:
    """group_dist_stats from device-reduced pop-block sums.

    ``sums``/``cnts`` float64 [W, P, P] are per-window sums of valid pair
    distances / valid-pair counts per pop-row x pop-col block (pops in the
    same np.unique order as the host path; see kernels/pairdist.
    window_pair_block_stats_dispatch).  Reproduces the reference
    ``groupDistStats`` arithmetic (genomics.py:956-995): nanmean = sum/count
    (empty -> 0/0 -> NaN), the strict nanmean_min gate on the non-NaN
    fraction, sample-size-weighted pi_s, pooled pi_t from the block sums
    (x-then-y pooled square = xx + xy + yx + yy blocks), Fst = 1 - pi_s/pi_t.
    """
    out = {}
    P = len(pops)
    with np.errstate(invalid="ignore", divide="ignore"):
        for x, p in enumerate(pops):
            size = pop_sizes[x] * pop_sizes[x]
            cnt = cnts[:, x, x]
            mean = sums[:, x, x] / cnt
            gate = (1 - (1.0 * (size - cnt)) / size) < min_data
            mean[gate] = np.nan
            out["pi_" + p] = mean
        if P == 1 or not do_pairs:
            return out
        for x in range(P - 1):
            for y in range(x + 1, P):
                n_x, n_y = pop_sizes[x], pop_sizes[y]
                size = n_x * n_y
                cnt = cnts[:, x, y]
                dxy = sums[:, x, y] / cnt
                gate = (1 - (1.0 * (size - cnt)) / size) < min_data
                dxy[gate] = np.nan
                out["dxy_" + pops[x] + "_" + pops[y]] = dxy
                out["dxy_" + pops[y] + "_" + pops[x]] = dxy
                w = 1.0 * n_x / (n_x + n_y)
                pi_s = w * out["pi_" + pops[x]] + (1 - w) * out["pi_" + pops[y]]
                pool_size = (n_x + n_y) * (n_x + n_y)
                pool_cnt = (cnts[:, x, x] + cnts[:, y, y]
                            + cnts[:, x, y] + cnts[:, y, x])
                pi_t = (sums[:, x, x] + sums[:, y, y]
                        + sums[:, x, y] + sums[:, y, x]) / pool_cnt
                gate = (1 - (1.0 * (pool_size - pool_cnt)) / pool_size) \
                    < min_data
                pi_t[gate] = np.nan
                fst = 1 - pi_s / pi_t
                out["Fst_" + pops[x] + "_" + pops[y]] = fst
                out["Fst_" + pops[y] + "_" + pops[x]] = fst
    return out


def hudson_fst_from_stats(values: dict, pop_names: list[str]) -> dict:
    """Hudson's Fst estimator (Hudson et al. 1992; Bhatia et al. 2013
    "ratio of averages" form) from the already-computed window stats:

        Fst_H = 1 - Hw / Hb,   Hw = (pi_x + pi_y) / 2,   Hb = dxy_x_y

    pi from mean pairwise differences IS Hudson's unbiased within-population
    heterozygosity (the n/(n-1) correction is implicit in excluding
    self-pairs), and dxy is exactly Hb.  Engine extension beyond the
    reference (whose only Fst is 1 - pi_s/pi_t, genomics.py:987-993),
    labeled FstHud_* ; NaN gates from pi/dxy propagate."""
    import itertools
    out = {}
    with np.errstate(invalid="ignore", divide="ignore"):
        for x, y in itertools.combinations(pop_names, 2):
            hw = 0.5 * (values["pi_" + x] + values["pi_" + y])
            hb = values["dxy_" + x + "_" + y]
            out["FstHud_" + x + "_" + y] = 1 - hw / hb
    return out


def sample_het(ctx: DistStatsContext, sample_names: list[str],
               sample_rows: list[np.ndarray], min_sites: int | None = None) -> dict:
    """Reference Alignment.sampleHet (genomics.py:918-929), including the
    operator-precedence bug in the guard (see module docstring)."""
    _min_sites = 1 if min_sites is None else min_sites
    W = ctx.dist.shape[0]
    out = {}
    for name, rows in zip(sample_names, sample_rows):
        if rows.size != 2:
            # reference raises IndexError for non-diploids here; we emit NaN
            out[name] = np.full(W, np.nan)
            continue
        i, j = int(rows[0]), int(rows[1])
        shared = ctx.shared[:, i, j]
        c2 = 2 & shared                                  # the buggy guard
        ok = (2 == c2) & (c2 >= _min_sites)
        vals = np.where(ok, ctx.dist[:, i, j], np.nan)
        out[name] = vals
    return out


def ind_pair_dists(ctx: DistStatsContext, sample_names: list[str],
                   sample_rows: list[np.ndarray],
                   include_same_with_same: bool = False,
                   min_sites: int | None = None) -> dict:
    """Reference Alignment.indPairDists (genomics.py:934-954): nanmean over
    haplotype blocks of the (possibly already mutated) distance matrix."""
    if min_sites:
        ctx.apply_min_sites(min_sites)
    if not include_same_with_same:
        ctx.fill_diag_nan()
    dist = ctx.dist
    out: dict = {n: {} for n in sample_names}
    with np.errstate(invalid="ignore"):
        for i, ni in enumerate(sample_names):
            ri = sample_rows[i]
            for j, nj in enumerate(sample_names):
                rj = sample_rows[j]
                block = dist[:, ri[:, None], rj[None, :]].reshape(dist.shape[0], -1)
                out[ni][nj] = np.nanmean(block, axis=1)
    return out


def ind_pair_dists_from_blocks(sums: np.ndarray, cnts: np.ndarray,
                               sample_names: list[str]) -> dict:
    """indPairDists (genomics.py:934-954) from device-reduced per-individual
    block sums: nanmean of the haplotype block == valid-pair sum / count
    (0/0 -> NaN), with the diagonal-NaN / minSites mutations already baked
    into the device valid gate exactly as the shared-context path bakes them
    into the cached matrix."""
    out: dict = {n: {} for n in sample_names}
    with np.errstate(invalid="ignore", divide="ignore"):
        for i, ni in enumerate(sample_names):
            for j, nj in enumerate(sample_names):
                out[ni][nj] = sums[:, i, j] / cnts[:, i, j]
    return out


def sample_het_from_pairs(het_m: np.ndarray, het_s: np.ndarray,
                          sample_names: list[str], diploid: np.ndarray,
                          min_sites_mutation: int) -> dict:
    """sampleHet (genomics.py:918-929) from each individual's raw own-pair
    (mismatch, shared) counts, including the operator-precedence bug guard.

    ``min_sites_mutation``: the minSites that group_dist_stats applied to
    the shared context before sampleHet ran (0 when popDist/popPairDist is
    not in the analysis list, mirroring the wrapper's call order,
    popgenWindows.py:51-64)."""
    W = het_m.shape[0]
    out = {}
    with np.errstate(invalid="ignore", divide="ignore"):
        d = het_m.astype(np.float64) / het_s.astype(np.float64)
    if min_sites_mutation:
        d[het_s < min_sites_mutation] = np.nan
    c2 = 2 & het_s.astype(np.int64)
    ok = (c2 == 2) & (c2 >= 1)                       # the buggy guard
    vals = np.where(ok, d, np.nan)
    for i, name in enumerate(sample_names):
        out[name] = vals[:, i] if diploid[i] else np.full(W, np.nan)
    return out


def cluster_sizes(dist_block: np.ndarray, max_dist: float) -> list[int]:
    """Greedy haplotype clustering (genomics.py:1239-1261)."""
    with np.errstate(invalid="ignore"):
        match = dist_block <= max_dist                 # NaN -> False
    sizes: list[int] = []
    while match.shape[0] > 0:
        most = int(match.sum(axis=1).argmax())
        matches = int(match[most, :].sum())
        if matches > 1:
            sizes.append(matches)
            keep = ~match[most, :]
            match = match[np.ix_(keep, keep)]
        else:
            sizes += [1] * match.shape[0]
            break
    return sizes


def batch_cluster_sizes(dist_blocks: np.ndarray, max_dist: float):
    """Greedy haplotype clustering (genomics.py:1239-1261) vectorized over
    the window axis.

    dist_blocks: [W, n, n].  Returns (sizes [W, n] int64 — recorded cluster
    sizes left-justified, zero-padded — and ones [W] int64 — how many
    trailing size-1 clusters the reference's break step appends).

    Exactly replicates the scalar greedy loop: each iteration picks the
    first row with the maximal match count over the remaining submatrix;
    counts > 1 are recorded and the matched rows removed; otherwise every
    remaining row becomes a singleton and the window is done.
    """
    W, n, _ = dist_blocks.shape
    with np.errstate(invalid="ignore"):
        match = dist_blocks <= max_dist                    # NaN -> False
    alive = np.ones((W, n), dtype=bool)
    done = np.zeros(W, dtype=bool)
    sizes = np.zeros((W, n), dtype=np.int64)
    ones = np.zeros(W, dtype=np.int64)
    ptr = np.zeros(W, dtype=np.int64)
    rows = np.arange(W)
    for _ in range(n):
        if done.all():
            break
        sub = match & alive[:, None, :] & alive[:, :, None]
        rowsum = sub.sum(axis=2)                           # [W, n]
        rowsum[~alive] = -1
        most = rowsum.argmax(axis=1)                       # first max, like argmax
        matches = rowsum[rows, most]
        act = ~done
        big = act & (matches > 1)
        if big.any():
            sizes[rows[big], ptr[big]] = matches[big]
            ptr[big] += 1
            alive[big] &= ~sub[rows[big], most[big]]
            # windows whose matrix emptied out stop (while match.shape[0] > 0)
            emptied = big & ~alive.any(axis=1)
            done |= emptied
        small = act & (matches <= 1)
        if small.any():
            ones[small] = alive[small].sum(axis=1)
            done |= small
    return sizes, ones


def h12_stats(ctx: DistStatsContext, row_group: list, max_dist: float) -> dict:
    """Reference Alignment.H12stats (genomics.py:1079-1098), window-axis
    vectorized (the scalar greedy loop is batch_cluster_sizes)."""
    dist = ctx.dist
    W = dist.shape[0]
    groups = np.array(["" if g is None else g for g in row_group])
    pops = np.unique(groups)
    out = {}
    for p in pops:
        idx = np.flatnonzero(groups == p)
        blocks = dist[:, idx[:, None], idx[None, :]]
        sizes, ones = batch_cluster_sizes(blocks, max_dist)
        n_rec = (sizes > 0).sum(axis=1)
        total = (sizes.sum(axis=1) + ones).astype(np.float64)
        freq = sizes / total[:, None]
        one_f = np.where(ones > 0, 1.0 / total, 0.0)
        h1 = (freq ** 2).sum(axis=1) + ones * one_f ** 2
        # first two recorded frequencies (sizes are recorded non-increasing;
        # trailing singletons fill in when fewer than two were recorded)
        f0 = np.where(n_rec >= 1, freq[:, 0], one_f)
        f1 = np.where(n_rec >= 2, freq[:, 1] if sizes.shape[1] > 1 else 0.0,
                      np.where(n_rec + ones >= 2, one_f, 0.0))
        n_clusters = n_rec + ones
        h12 = np.where(n_clusters > 1, h1 + 2 * f0 * f1, h1)
        h2 = np.where(n_clusters > 1, h1 - f0 ** 2, 0.0)
        out["H1_" + p] = h1
        out["H12_" + p] = h12
        out["H2_" + p] = h2
    return out


def wc_fst_windows(counts_x: np.ndarray, counts_y: np.ndarray,
                   window_spans) -> np.ndarray:
    """Weir & Cockerham (1984) theta per window — ENGINE EXTENSION.

    The reference's only Fst is 1 - pi_s/pi_t (genomics.py:987-993); this
    adds the WC estimator for two populations of *haploid samples* (our
    haplotype rows), i.e. the two-level variance decomposition with no
    individual-heterozygosity component:

    per site, per allele a (r = 2 pops, n_i = called haplotypes in pop i,
    p_ia = allele frequency in pop i):
        n_c   = (n. - sum n_i^2 / n.) / (r - 1)
        MSP_a = sum_i n_i (p_ia - pbar_a)^2 / (r - 1)
        MSG_a = sum_i n_i p_ia (1 - p_ia) / (n. - r)
        a_a   = (MSP_a - MSG_a) / n_c          (between-pop component)
        b_a   = MSG_a                          (within-pop component)
    and theta(window) = sum_{sites,a} a_a / sum_{sites,a} (a_a + b_a)
    (ratio of sums, multi-allelic sites contribute one term per allele).

    Sites need n_i >= 1 in both pops and n. > 2; others contribute nothing.
    Validated against an independent per-site re-derivation in
    tests/test_wc_fst.py.

    Parameters: counts_x/counts_y int [S, 4] per-site base counts; returns
    float64 [W].
    """
    cx = counts_x.astype(np.float64)
    cy = counts_y.astype(np.float64)
    n1 = cx.sum(axis=1)
    n2 = cy.sum(axis=1)
    n_tot = n1 + n2
    ok = (n1 >= 1) & (n2 >= 1) & (n_tot > 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        p1 = cx / n1[:, None]
        p2 = cy / n2[:, None]
        pbar = (cx + cy) / n_tot[:, None]
        n_c = n_tot - (n1 ** 2 + n2 ** 2) / n_tot           # r - 1 == 1
        msp = (n1[:, None] * (p1 - pbar) ** 2
               + n2[:, None] * (p2 - pbar) ** 2)            # / (r - 1) == 1
        msg = (n1[:, None] * p1 * (1 - p1)
               + n2[:, None] * p2 * (1 - p2)) / (n_tot - 2)[:, None]
        a_comp = ((msp - msg) / n_c[:, None]).sum(axis=1)
        b_comp = msg.sum(axis=1)
    a_comp = np.where(ok, a_comp, 0.0)
    b_comp = np.where(ok, b_comp, 0.0)
    a_comp = np.nan_to_num(a_comp, nan=0.0)
    b_comp = np.nan_to_num(b_comp, nan=0.0)
    cs_a = np.concatenate([[0.0], np.cumsum(a_comp)])
    cs_b = np.concatenate([[0.0], np.cumsum(b_comp)])
    spans = list(window_spans)
    out = np.full(len(spans), np.nan)
    for w, (f, l_) in enumerate(spans):
        num = cs_a[l_] - cs_a[f]
        den = num + (cs_b[l_] - cs_b[f])
        out[w] = num / den if den != 0 else np.nan
    return out


def base_count_pi(counts: np.ndarray) -> np.ndarray:
    """Sitewise multi-allelic pi from base counts [..., 4]
    (baseCountPi, genomics.py:609-616; exact term order)."""
    c = counts.astype(np.int64)
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    num = c0 * c1 + c0 * c2 + c0 * c3 + c1 * c2 + c1 * c3 + c2 * c3
    N = c.sum(axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return num / (0.5 * N * (N - 1))


def _seq_sum(a: np.ndarray, axis: int = -1) -> np.ndarray:
    """Sequential (left-to-right) float64 sum — matches Python builtin ``sum``
    over a numpy array, which the reference uses (genomics.py:1017-1019)."""
    if a.shape[axis] == 0:
        return np.zeros(a.shape[:axis] + a.shape[axis:][1:])
    return np.cumsum(a, axis=axis).take(-1, axis=axis)


def tajima_constants(n: int) -> tuple[float, float, float]:
    """(a1, e1, e2) from TajimaD (genomics.py:619-632), sequential sums."""
    a = sum(1.0 / i for i in range(1, n))
    a2 = sum(1.0 / (i ** 2) for i in range(1, n))
    b1 = (n + 1.0) / (3 * (n - 1))
    b2 = (2.0 * (n ** 2 + n + 3)) / (9 * n * (n - 1))
    c1 = b1 - (1.0 / a)
    c2 = b2 - ((n + 2) / (a * n)) + a2 / (a ** 2)
    e1 = c1 / a
    e2 = c2 / (a ** 2 + a2)
    return a, e1, e2


def group_freq_stats(group_counts: dict, group_sizes: dict,
                     complete_mask: np.ndarray, window_spans) -> dict:
    """Reference Alignment.groupFreqStats (genomics.py:1002-1028) per window.

    Parameters
    ----------
    group_counts : dict group -> int32 [S, 4] per-site base counts
        (for the group's haplotype rows).
    group_sizes : dict group -> N haplotypes.
    complete_mask : bool [S] — sites with no missing data across the WHOLE
        alignment (the reference tests all rows, not just the group's;
        genomics.py:1010).
    window_spans : iterable of (first, last) site spans.

    Returns dict "l_/S_/thetaPi_/thetaW_/TajD_<group>" -> [W] arrays.
    """
    spans = list(window_spans)
    W = len(spans)
    firsts = np.array([f for f, _ in spans], dtype=np.int64)
    lasts = np.array([l for _, l in spans], dtype=np.int64)
    cs_l = np.concatenate([[0], np.cumsum(complete_mask.astype(np.int64))])
    out = {}
    groups = sorted(group_counts.keys())
    for g in groups:
        N = group_sizes[g]
        counts = group_counts[g]
        site_pi_all = base_count_pi(counts)
        l_arr = cs_l[lasts] - cs_l[firsts]           # complete sites / window
        S_arr = np.full(W, np.nan)
        tp_arr = np.full(W, np.nan)
        tw_arr = np.full(W, np.nan)
        td_arr = np.full(W, np.nan)
        if N >= 2:
            # vectorized over windows via float64 prefix sums (sequential
            # left-to-right accumulation like the reference's builtin sum,
            # genomics.py:1017-1019; window sums are prefix differences)
            harm = sum(1.0 / np.arange(1, N))        # builtin sum: sequential
            a1, e1, e2 = tajima_constants(N)
            seg = complete_mask & (site_pi_all != 0.0)
            cs_S = np.concatenate([[0], np.cumsum(seg.astype(np.int64))])
            masked_pi = np.where(complete_mask, site_pi_all, 0.0)
            cs_pi = np.concatenate([[0.0], np.cumsum(masked_pi)])
            nz = l_arr >= 1
            S = (cs_S[lasts] - cs_S[firsts]).astype(np.float64)
            theta_pi = cs_pi[lasts] - cs_pi[firsts]
            with np.errstate(invalid="ignore", divide="ignore"):
                theta_w = S / harm
                d = theta_pi - S / a1
                denom = np.sqrt(e1 * S + e2 * S * (S - 1))
                taj_d = d / denom
            S_arr[nz] = S[nz]
            tp_arr[nz] = theta_pi[nz]
            tw_arr[nz] = theta_w[nz]
            td_arr[nz] = taj_d[nz]
        else:
            # degenerate single-haplotype group: site pi is NaN everywhere,
            # so replicate the reference's scalar arithmetic per window
            harm = 0.0
            for w in range(W):
                l = int(l_arr[w])
                if l >= 1:
                    S = l                            # NaN != 0 counts
                    S_arr[w] = S
                    tp_arr[w] = np.nan
                    with np.errstate(invalid="ignore", divide="ignore"):
                        tw_arr[w] = np.float64(S) / 0.0 if S else np.nan
                    td_arr[w] = np.nan
        out["l_" + g] = l_arr
        out["S_" + g] = S_arr
        out["thetaPi_" + g] = tp_arr
        out["thetaW_" + g] = tw_arr
        out["TajD_" + g] = td_arr
    return out
