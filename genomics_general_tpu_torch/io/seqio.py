"""Sequence-alignment parsing and haploid<->phased sequence helpers.

The port of genomics_general_tpu/io/seqio.py, with the same functions and
results; it launches no kernel.

Host-side mirror of the reference alignment I/O (parseFasta / parsePhylip,
genomics.py:2256-2285) and phasing utilities (haploToPhased /
makeHaploidNames / makePhasedNames, genomics.py:412-457; chunkList,
genomics.py:267-288 — with the reference's float-division list-multiply bug
fixed so a single-element ploidy list works under Python 3).
"""

from __future__ import annotations

import random
import string


def parse_fasta(text: str, make_uppercase: bool = False):
    parts = text.split(">")[1:]
    names = [s.split()[0] for s in parts]
    seqs = [s[s.index("\n"):].replace("\n", "").replace(" ", "")
            for s in parts]
    if make_uppercase:
        seqs = [s.upper() for s in seqs]
    return names, seqs


def parse_phylip(text: str, as_list: bool = False):
    """Parse (possibly multi-alignment) phylip.  Returns (names, seqs) for a
    single alignment, else a list of such tuples (genomics.py:2265-2285)."""
    line_parts = [l.strip().split() for l in text.strip().split("\n")]
    line_parts = [p for p in line_parts if p]
    head_idx, ns = [], []
    for x, parts in enumerate(line_parts):
        try:
            int(parts[1])
            ns.append(int(parts[0]))
            head_idx.append(x)
        except (IndexError, ValueError):
            pass
    head_idx.append(len(line_parts))
    names = [[line_parts[head_idx[i] + 1 + j][0] for j in range(ns[i])]
             for i in range(len(head_idx) - 1)]
    seq_idx = [[range(head_idx[i] + 1 + j, head_idx[i + 1], ns[i])
                for j in range(ns[i])] for i in range(len(head_idx) - 1)]
    seqs = [["".join(line_parts[y][1] for y in x) for x in w] for w in seq_idx]
    if not as_list and len(names) == 1:
        return names[0], seqs[0]
    return list(zip(names, seqs))


def _resolve_ploidy(n: int, ploidy) -> list[int]:
    p = list(ploidy) if not isinstance(ploidy, int) else [ploidy]
    if len(p) == 1:
        assert n % p[0] == 0, "Sequence number must be divizable by ploidy"
        p = p * (n // p[0])
    else:
        assert n == sum(p), "Ploidys must sum to number of sequences"
    return p


def chunk_indices(n: int, sizes: list[int]):
    out, i = [], 0
    for c in sizes:
        out.append(list(range(i, i + c)))
        i += c
    return out


def haplo_to_phased(seqs, seq_names=None, ploidy=2, random_phase=False):
    """Fuse haploid sequences into |-joined phased sequences
    (genomics.py:412-446)."""
    n = len(seqs)
    p = _resolve_ploidy(n, ploidy)
    if set(p) == {1}:
        if seq_names is not None:
            assert len(seq_names) == n, "incorrect number of sequence names"
            return seqs, seq_names
        return seqs
    indices = chunk_indices(n, p)
    zip_seqs = [list(zip(*[seqs[x] for x in ind])) for ind in indices]
    if random_phase:
        for i, ind in enumerate(indices):
            if p[i] > 1:
                for j in range(len(zip_seqs[i])):
                    zip_seqs[i][j] = random.sample(list(zip_seqs[i][j]), p[i])
    fused = [["|".join(x) for x in zs] for zs in zip_seqs]
    if seq_names is not None:
        assert len(seq_names) == n, "incorrect number of sequence names"
        names = ["_".join(seq_names[x] for x in ind) for ind in indices]
        return fused, names
    return fused


def make_haploid_names(names, ploidy=2):
    """ind -> ind_A, ind_B, ... per ploidy (genomics.py:449-454)."""
    p = list(ploidy) if not isinstance(ploidy, int) else [ploidy]
    if len(p) == 1:
        p = p * len(names)
    if all(x == 1 for x in p):
        return list(names)
    ploidy_of = dict(zip(names, p))
    return [n + "_" + letter for n in names
            for letter in string.ascii_uppercase[:ploidy_of[n]]]


def make_phased_names(names, ploidy=2):
    p = _resolve_ploidy(len(names), ploidy)
    return ["_".join(group)
            for group in ([names[i] for i in ind]
                          for ind in chunk_indices(len(names), p))]
