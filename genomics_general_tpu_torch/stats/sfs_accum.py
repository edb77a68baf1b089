"""Dense vectorized SFS accumulation with reference-ordered output.

The reference accumulates spectra one site at a time into nested
defaultdicts (sfs.py:94-122, 428-496) and emits chains in
**nested first-insertion order** — the order at each nesting level is the
order in which that level's value first appeared among sites sharing the
chain prefix.  A dense bincount accumulator is ~100x faster but loses that
order; this module keeps it by also recording, per spectrum cell, the
*first-occurrence key* of the cell (a monotone file-order key), from which
the nested order is reconstructed exactly:

    chain order = lexsort by (min key over prefix-1 subtree,
                              min key over prefix-2 subtree, ...,
                              key of the full cell)

because a nested dict's level-j ordering is by the first site that created
that level-j node = the min key within its subtree.

Keys are ``(scaffold_file_index << 40) | intra_scaffold_site_index`` so
they are comparable across hosts in scaffold-sharded multi-host runs: the
merged (summed counts, min-ed keys) accumulators reproduce the single-host
stream order byte-for-byte.
"""

from __future__ import annotations

import numpy as np

_HUGE = np.int64(1 << 62)


class DenseFS:
    """Dense spectrum accumulator emitting SparseFS-compatible text."""

    def __init__(self, dims: tuple[int, ...], intervals: int = 1):
        self.dims = tuple(int(d) for d in dims)
        self.size = int(np.prod(self.dims)) if self.dims else 1
        self.intervals = intervals
        self.counts = np.zeros((self.size, intervals), dtype=np.int64)
        self.first = np.full(self.size, _HUGE, dtype=np.int64)

    def flat_index(self, tuples: np.ndarray) -> np.ndarray:
        """[C, k] per-pop target counts -> [C] flat cell indices."""
        flat = np.zeros(tuples.shape[0], dtype=np.int64)
        for j, d in enumerate(self.dims):
            flat = flat * d + tuples[:, j]
        return flat

    def add_batch(self, flat: np.ndarray, keys: np.ndarray,
                  values: np.ndarray | None = None):
        """Accumulate cells ``flat`` with first-occurrence ``keys``.

        ``values``: optional [C, intervals] add vectors (the per-interval
        ``contains_point`` result in regions mode); omitted = plain +1 per
        site (single-interval mode)."""
        if flat.size == 0:
            return
        if values is None:
            assert self.intervals == 1
            self.counts[:, 0] += np.bincount(flat, minlength=self.size)
        else:
            for i in range(self.intervals):
                self.counts[:, i] += np.bincount(flat, weights=values[:, i],
                                                 minlength=self.size
                                                 ).astype(np.int64)
        np.minimum.at(self.first, flat, keys)

    # -------------------------------------------------------------- merge

    def merge_from(self, counts: np.ndarray, first: np.ndarray):
        """Merge another host's accumulator (sum counts, min keys)."""
        self.counts += counts
        self.first = np.minimum(self.first, first)

    # -------------------------------------------------------------- output

    def chain_order(self) -> np.ndarray:
        """Occupied flat indices in nested first-insertion order."""
        occ = np.flatnonzero(self.first < _HUGE)
        if occ.size == 0:
            return occ
        k = len(self.dims)
        grid = self.first.reshape(self.dims)
        sort_keys = []
        for j in range(k - 1, -1, -1):
            if j == k - 1:
                pm = self.first
            else:
                # min key over the subtree sharing the first j+1 coordinates
                pm = grid.min(axis=tuple(range(j + 1, k)), keepdims=True)
                pm = np.broadcast_to(pm, self.dims).reshape(-1)
            sort_keys.append(pm[occ])
        # np.lexsort: LAST key is primary -> level-0 prefix min goes last
        return occ[np.lexsort(tuple(sort_keys))]

    def as_text(self) -> str:
        occ = self.chain_order()
        if occ.size == 0:
            return "\n"
        coords = np.stack(np.unravel_index(occ, self.dims), axis=1)
        lines = []
        for r, f in enumerate(occ):
            lines.append("\t".join(
                [str(int(c)) for c in coords[r]]
                + [str(int(v)) for v in self.counts[f]]))
        return "\n".join(lines) + "\n"


class ScaffoldKeyTracker:
    """Monotone per-site file-order keys usable across hosts.

    key = (scaffold file index << 40) | running site index within the
    scaffold.  The scaffold file index comes from the reader's stable id
    assignment (genome order), which every host observes identically even
    when it keeps only its own scaffolds' sites."""

    def __init__(self):
        self._counts: dict[int, int] = {}

    def keys_for(self, scaffold_ids: np.ndarray) -> np.ndarray:
        if scaffold_ids.size == 0:
            return np.empty(0, dtype=np.int64)
        out = np.empty(scaffold_ids.shape[0], dtype=np.int64)
        boundaries = np.concatenate(
            [[0], np.flatnonzero(np.diff(scaffold_ids)) + 1,
             [scaffold_ids.shape[0]]])
        for b0, b1 in zip(boundaries[:-1], boundaries[1:]):
            sid = int(scaffold_ids[b0])
            base = self._counts.get(sid, 0)
            n = b1 - b0
            out[b0:b1] = (np.int64(sid) << 40) + base + np.arange(n)
            self._counts[sid] = base + n
        return out


def vector_targets(in_counts: np.ndarray, out_counts: np.ndarray | None):
    """Vectorized reference getTargetCounts (sfs.py:60-85) over [C, Pin, 4]
    ingroup base counts (+ optional [C, 4] outgroup counts).

    Returns (ok [C] bool, tgt_counts [C, Pin] int64) — ok replicates the
    reference gates (1 <= total alleles <= 2; with an outgroup, exactly one
    outgroup allele), tgt_counts the per-pop count of the target allele
    (polarized: the allele absent from the outgroup, falling back to the
    first absent allele at invariant sites; folded: argsort()[-2] with
    numpy tie order)."""
    total = in_counts.sum(axis=1)                     # [C, 4]
    alleles = total > 0
    if out_counts is not None:
        out_alleles = out_counts > 0
        all_alleles = alleles | out_alleles
        n_all = all_alleles.sum(axis=1)
        n_out = out_alleles.sum(axis=1)
        ok = (n_all >= 1) & (n_all <= 2) & (n_out == 1)
        cand_mask = ~out_alleles & alleles
        has_cand = cand_mask.any(axis=1)
        target = np.where(has_cand, np.argmax(cand_mask, axis=1),
                          np.argmax(~alleles, axis=1))
    else:
        n_all = alleles.sum(axis=1)
        ok = (n_all >= 1) & (n_all <= 2)
        target = np.argsort(total, axis=1)[:, -2]
    rows = np.arange(in_counts.shape[0])
    tgt = in_counts[rows[:, None],
                    np.arange(in_counts.shape[1])[None, :],
                    target[:, None]]
    return ok, tgt.astype(np.int64)
