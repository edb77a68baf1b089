"""Neighbor-joining tree construction (built-in tree backend).

The reference delegates per-window tree inference to external phyml/RAxML
binaries (phylo/phyml_sliding_windows.py:25-58).  This module provides a
self-contained NJ implementation (Saitou & Nei 1987, with the standard
Studier-Keppler O(n^3) Q-matrix recurrence) over the engine's masked-
Hamming window distance matrices, so sliding-window trees work with no
external dependency.  Distances may optionally be Jukes-Cantor corrected.
"""

from __future__ import annotations

import numpy as np


def jukes_cantor(d: np.ndarray) -> np.ndarray:
    """JC69 distance correction; saturated distances (p >= 0.75) are capped
    at the maximum finite correctable value."""
    p = np.minimum(d, 0.74999)
    with np.errstate(invalid="ignore"):
        return np.where(np.isnan(d), np.nan, -0.75 * np.log1p(-4.0 * p / 3.0))


def neighbor_joining(dist: np.ndarray, names: list[str],
                     round_to: int = 6) -> str:
    """Newick tree from a symmetric distance matrix.

    NaN entries are treated as 0 (no information).  Negative branch lengths
    are clamped to 0, as is conventional.
    """
    n = dist.shape[0]
    assert n == len(names)
    if n == 1:
        return names[0] + ";"
    if n == 2:
        d = max(float(np.nan_to_num(dist[0, 1])), 0.0) / 2
        return (f"({names[0]}:{round(d, round_to)},"
                f"{names[1]}:{round(d, round_to)});")
    d = np.nan_to_num(np.asarray(dist, dtype=np.float64)).copy()
    nodes = list(names)
    active = list(range(n))
    while len(active) > 2:
        m = len(active)
        sub = d[np.ix_(active, active)]
        r = sub.sum(axis=1)
        q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        i, j = np.unravel_index(np.argmin(q), q.shape)
        if i > j:
            i, j = j, i
        ai, aj = active[i], active[j]
        dij = sub[i, j]
        li = 0.5 * dij + (r[i] - r[j]) / (2 * (m - 2))
        lj = dij - li
        li, lj = max(li, 0.0), max(lj, 0.0)
        # new node distances
        new_d = 0.5 * (d[ai, :] + d[aj, :] - dij)
        d = np.pad(d, ((0, 1), (0, 1)))
        d[-1, :-1] = new_d
        d[:-1, -1] = new_d
        d[-1, -1] = 0.0
        nodes.append(f"({nodes[ai]}:{round(li, round_to)},"
                     f"{nodes[aj]}:{round(lj, round_to)})")
        active = [a for a in active if a not in (ai, aj)] + [d.shape[0] - 1]
    a, b = active
    dab = max(float(d[a, b]), 0.0)
    return f"({nodes[a]}:{round(dab / 2, round_to)}," \
           f"{nodes[b]}:{round(dab / 2, round_to)});"
