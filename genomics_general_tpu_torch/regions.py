"""Genomic intervals and region-text parsing.

Replicates the reference Intervals class and region parsing
(genomics.py:2323-2429): region text ``CHR[:FROM-TO[:ORI]]``,
point/interval containment as boolean vectors over the interval list, sort
(chrom, then lexsort(starts, ends)), and overlap reduction.
"""

from __future__ import annotations

import numpy as np


def parse_region_text(region_text: str):
    split = region_text.split(":")
    seq_name = split[0]
    if len(split) < 3 or split[2] == "":
        ori = "+"
    else:
        ori = split[2]
    if ori not in "+-":
        raise ValueError("Incorrect region specification")
    try:
        from_to = [int(x) for x in split[1].split("-")]
        if len(from_to) == 1:
            from_to.append(None)
        if from_to[1] is not None and from_to[0] > from_to[1]:
            from_to = from_to[::-1]
            ori = "-"
        return (seq_name, from_to[0], from_to[1], ori)
    except (IndexError, ValueError):
        return (seq_name, None, None, ori)


def parse_region_list(region_list):
    """parseRegionText's tabular twin (genomics.py:2339-2351).

    ``region_list`` is a whitespace-split line: NAME [FROM [TO [ORI]]].
    Coordinates given in reverse order flip the orientation to ``-``.
    """
    seq_name = region_list[0]
    if len(region_list) < 4:
        ori = "+"
    else:
        ori = region_list[3]
    if ori not in "+-":
        raise ValueError("Orientation must be + or -")
    try:
        from_to = [int(x) for x in region_list[1:3]]
        if len(from_to) == 1:
            from_to.append(None)
        if from_to[1] is not None and from_to[0] > from_to[1]:
            from_to = from_to[::-1]
            ori = "-"
        return (seq_name, from_to[0], from_to[1], ori)
    except (IndexError, ValueError):
        return (seq_name, None, None, ori)


class Intervals:
    def __init__(self, regions=None, tuples=None, chroms=None, starts=None,
                 ends=None):
        if regions is not None:
            tuples = [parse_region_text(r) for r in regions]
        if tuples is not None:
            self.chroms = np.array([t[0] for t in tuples], dtype=str)
            self.starts = np.array(
                [t[1] if len(t) > 1 and t[1] is not None else 0 for t in tuples],
                dtype=int)
            self.ends = np.array(
                [t[2] if len(t) > 2 and t[2] is not None
                 else t[1] if len(t) > 1 and t[1] is not None else np.iinfo(np.int64).max
                 for t in tuples], dtype=int)
        else:
            n = len(starts) if starts is not None else len(chroms)
            self.chroms = np.array(chroms, dtype=str) if chroms is not None \
                else np.repeat("", n)
            self.starts = np.array(starts, dtype=int) if starts is not None \
                else np.repeat(0, n)
            self.ends = np.array(ends, dtype=int) if ends is not None \
                else np.array(starts, dtype=int)
        self.l = len(self.starts)
        self.chrom_set = set(self.chroms)

    def contains_point(self, pos, chrom=""):
        return (self.chroms == chrom) & (self.starts <= pos) & (pos <= self.ends)

    def contains_interval(self, start, end, chrom=""):
        return (self.chroms == chrom) & (self.starts <= start) & (end <= self.ends)

    def overlaps_interval(self, start, end, chrom=""):
        return (self.chroms == chrom) & (self.starts <= end) & (start <= self.ends)

    def sort(self, positions_only=False):
        if len(self.chrom_set) > 1 and not positions_only:
            idx = np.argsort(self.chroms)
            self.chroms = self.chroms[idx]
            self.starts = self.starts[idx]
            self.ends = self.ends[idx]
        for c in dict.fromkeys(self.chroms.tolist()):
            idx = np.flatnonzero(self.chroms == c)
            sub = np.lexsort((self.ends[idx], self.starts[idx]))
            self.starts[idx] = self.starts[idx][sub]
            self.ends[idx] = self.ends[idx][sub]

    def reduced(self, skip_sort=False):
        if not skip_sort:
            self.sort()
        new_chroms = [self.chroms[0]]
        new_starts = [self.starts[0]]
        new_ends = [self.ends[0]]
        for i in range(1, self.l):
            if self.chroms[i] == new_chroms[-1] and self.starts[i] <= new_ends[-1]:
                if self.ends[i] > new_ends[-1]:
                    new_ends[-1] = self.ends[i]
                continue
            new_chroms.append(self.chroms[i])
            new_starts.append(self.starts[i])
            new_ends.append(self.ends[i])
        return Intervals(chroms=new_chroms, starts=new_starts, ends=new_ends)
