"""Sample / population metadata and the haplotype-row model.

The engine's compute object is a dense int8 matrix of haplotype rows
(individuals split by ploidy).  This module owns the mapping from individuals
(+ ploidy, + population assignment) to haplotype rows, replicating the
reference's row model exactly:

* each individual with ploidy k>1 contributes rows named ``ind_A .. ind_<k>``;
  ploidy-1 individuals contribute a single row with the bare name
  (reference genoToAlignment, genomics.py:1112-1121),
* rows are sorted by haplotype name (numpy argsort of the name array,
  genomics.py:1122) — this fixes the row order of distance matrices and the
  "first appearance" order used by per-individual outputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SampleData:
    """Population <-> individual mapping plus ploidy (reference SampleData,
    genomics.py:1264-1290; default ploidy 2 at :1280)."""

    ind_names: list[str]
    pop_names: list[str] = field(default_factory=list)
    pop_inds: dict[str, list[str]] = field(default_factory=dict)
    ploidy: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        for ind in self.ind_names:
            self.ploidy.setdefault(ind, 2)

    @classmethod
    def from_pop_args(cls, population_args=None, pops_file: str | None = None,
                      extra_inds=None, ploidy_list=None, ploidy_file: str | None = None,
                      haploid=None, geno_format: str | None = None,
                      default_ploidy: int | None = None):
        """Build from CLI-style inputs, mirroring the parsing block shared by
        the reference CLIs (e.g. popgenWindows.py:258-307):

        * ``population_args``: list of ``[popName]`` or ``[popName, "i1,i2"]``,
        * ``pops_file``: two-column (ind, pop) file appended to named pops,
        * ploidy resolution order: explicit list -> file -> format default
          (haplo => 1, else 2) with ``--haploid`` overrides.
        """
        pop_names: list[str] = []
        pop_inds: dict[str, list[str]] = {}
        if population_args:
            for p in population_args:
                pop_names.append(p[0])
                pop_inds[p[0]] = p[1].split(",") if len(p) > 1 else []
        if pops_file:
            with open(pops_file, "rt") as pf:
                for ln in pf:
                    parts = ln.split()
                    if not parts:
                        continue
                    ind, pop = parts[0], parts[1]
                    if pop in pop_inds and ind not in pop_inds[pop]:
                        pop_inds[pop].append(ind)
        for name in pop_names:
            assert len(pop_inds[name]) >= 1, \
                "All populations must be represented by at least one sample."
        # reference: allInds = list(set(...)) — set order is arbitrary; we keep
        # deterministic first-appearance order instead (column VALUES are keyed
        # by name everywhere, so only cosmetic column order can differ).
        all_inds = []
        seen = set()
        for name in pop_names:
            for ind in pop_inds[name]:
                if ind not in seen:
                    seen.add(ind)
                    all_inds.append(ind)
        for ind in (extra_inds or []):
            if ind not in seen:
                seen.add(ind)
                all_inds.append(ind)

        if ploidy_list is not None:
            pl = list(ploidy_list)
            if len(pl) == 1:
                pl = pl * len(all_inds)
            assert len(pl) == len(all_inds), "Incorrect number of ploidy values supplied."
            ploidy = dict(zip(all_inds, pl))
        elif ploidy_file is not None:
            with open(ploidy_file, "rt") as pf:
                ploidy = {s[0]: int(s[1]) for s in (l.split() for l in pf) if s}
        else:
            if default_ploidy is not None:
                d = default_ploidy
            else:
                d = 1 if geno_format == "haplo" else 2
            ploidy = {ind: d for ind in all_inds}
            for sample in (haploid or []):
                ploidy[sample] = 1

        return cls(ind_names=all_inds, pop_names=pop_names, pop_inds=pop_inds,
                   ploidy=ploidy)

    def get_pop(self, ind: str):
        pops = [p for p in self.pop_names if ind in self.pop_inds.get(p, ())]
        if len(pops) == 0:
            return None
        if len(pops) == 1:
            return pops[0]
        return tuple(pops)


@dataclass
class HaplotypeModel:
    """The haplotype-row layout derived from a SampleData.

    Attributes
    ----------
    row_names : haplotype names, in final (sorted) row order.
    row_sample : individual name per row.
    row_sample_idx : int32 index into ``sample_names`` per row.
    sample_names : unique individual names in first-appearance (row) order —
        the order the reference's ``uniqueIndices(..., preserveOrder=True)``
        produces (genomics.py:1160-1164).
    sample_rows : list of row-index arrays per sample (same order).
    row_group : group (pop name or None) per row.
    pop_row_indices : dict pop -> int32 row indices.
    ind_order : per-individual (input order) the list of row indices, used by
        the reader to scatter decoded haplotypes into sorted row order.
    """

    row_names: list[str]
    row_sample: list[str]
    sample_names: list[str]
    sample_rows: list[np.ndarray]
    row_group: list
    pop_row_indices: dict
    ind_order: list[np.ndarray]
    ploidies: list[int]

    @classmethod
    def build(cls, sample_data: SampleData, ind_names: list[str] | None = None):
        from . import encoding
        inds = ind_names if ind_names is not None else sample_data.ind_names
        ploidies = [sample_data.ploidy.get(ind, 2) or 2 for ind in inds]
        hap_names: list[str] = []
        hap_sample: list[str] = []
        hap_group: list = []
        ind_row_lists: list[list[int]] = []
        r = 0
        for ind, p in zip(inds, ploidies):
            names = encoding.haploid_names([ind], [p])
            hap_names.extend(names)
            hap_sample.extend([ind] * p)
            hap_group.extend([sample_data.get_pop(ind)] * p)
            ind_row_lists.append(list(range(r, r + p)))
            r += p
        order = np.argsort(np.array(hap_names))  # genomics.py:1122
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        row_names = [hap_names[i] for i in order]
        row_sample = [hap_sample[i] for i in order]
        row_group = [hap_group[i] for i in order]
        ind_order = [inv[np.array(lst, dtype=np.int64)] for lst in ind_row_lists]

        sample_names: list[str] = []
        sample_rows_d: dict[str, list[int]] = {}
        for i, s in enumerate(row_sample):
            if s not in sample_rows_d:
                sample_names.append(s)
                sample_rows_d[s] = []
            sample_rows_d[s].append(i)
        sample_rows = [np.array(sample_rows_d[s], dtype=np.int32) for s in sample_names]

        pop_row_indices = {}
        for pop in sample_data.pop_names:
            idx = [i for i, g in enumerate(row_group)
                   if g == pop or (isinstance(g, tuple) and pop in g)]
            pop_row_indices[pop] = np.array(idx, dtype=np.int32)

        return cls(row_names=row_names, row_sample=row_sample,
                   sample_names=sample_names, sample_rows=sample_rows,
                   row_group=row_group, pop_row_indices=pop_row_indices,
                   ind_order=ind_order, ploidies=ploidies)

    @property
    def n_rows(self) -> int:
        return len(self.row_names)

    def pop_mask(self, pops: list[str]) -> np.ndarray:
        """One-hot [P, H] float mask of pop membership over haplotype rows."""
        H = self.n_rows
        m = np.zeros((len(pops), H), dtype=np.float32)
        for k, pop in enumerate(pops):
            m[k, self.pop_row_indices[pop]] = 1.0
        return m

    def group_pops_unique(self) -> list[str]:
        """Pops in np.unique order of the group labels — the iteration order of
        reference groupDistStats/groupFreqStats (genomics.py:965, 1007)."""
        groups = [g for g in self.row_group if g is not None]
        return sorted(set(groups))
