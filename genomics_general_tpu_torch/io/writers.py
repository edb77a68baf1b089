"""Output formatting matching the reference CSV/matrix text exactly.

Number formatting rule (popgenWindows.py:66: ``round(x, roundTo)`` then
``str``): Python ``round`` on a float (correctly-rounded decimal, banker's
ties) and ``str`` shortest-repr.  NaN prints as ``nan``; integer-valued
columns (sites, l_, S_, sitesUsed, mid) print without a decimal point.
"""

from __future__ import annotations

import gzip
import sys

import numpy as np


def open_out(path: str | None):
    if path is None:
        return sys.stdout
    if path.endswith(".gz"):
        return gzip.open(path, "wt")
    return open(path, "wt")


def fmt_float(v, round_to: int = 4) -> str:
    """str(round(v, round_to)) with reference semantics.

    The reference rounds numpy float64 scalars, whose ``__round__`` is
    numpy's scale-rint-unscale (NOT Python's correctly-rounded decimal), so
    e.g. round(0.34625, 4) -> 0.3462 for np.float64 but 0.3463 for float.
    """
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    v = np.float64(v)
    if v != v:
        return "nan"
    return str(round(v, round_to))


def fmt_int_or_nan(v) -> str:
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    v = float(v)
    if v != v:
        return "nan"
    return str(int(v))


def dist_mat_string(dist: np.ndarray, round_to: int = 10) -> str:
    """makeDistMatString (genomics.py:2288-2289)."""
    return "\n".join(" ".join(i) for i in dist.round(round_to).astype(str))


def dist_mat_phylip_string(dist: np.ndarray, names, round_to: int = 10) -> str:
    """makeDistMatPhylipString (genomics.py:2291-2295)."""
    output = str(dist.shape[0]) + "\n"
    for i in range(len(names)):
        output += (str(names[i]) + "  " +
                   " ".join(dist[i, :].round(round_to).astype(str)) + "\n")
    return output


def dist_mat_nexus_string(dist: np.ndarray, names, round_to: int = 10) -> str:
    """makeDistMatNexusString (genomics.py:2297-2306)."""
    output = "\nBEGIN Taxa;\nDIMENSIONS ntax={};\nTAXLABELS\n".format(len(names))
    for i in range(len(names)):
        output += "[{}] '{}'\n".format(i + 1, names[i])
    output += ";\nEND; [Taxa]\n"
    output += ("\nBEGIN Distances;\nDIMENSIONS ntax={};\n"
               "FORMAT labels=left diagonal triangle=both;\nMATRIX\n").format(len(names))
    for i in range(len(names)):
        output += ("[{}] '{}'    ".format(i + 1, names[i]) +
                   " ".join(dist[i, :].round(round_to).astype(str)) + "\n")
    output += ";\nEND; [Distances]\n"
    return output


def make_aln_string(names, seqs, out_format="phylip", line_len=None,
                    n_to_gap=False) -> str:
    """makeAlnString (genomics.py:2232-2251)."""
    seqs = ["".join(s) for s in seqs]
    if n_to_gap:
        trans = str.maketrans("Nn", "--")
        seqs = [s.translate(trans) for s in seqs]
    output = []
    n_samp = len(names)
    seq_len = max(len(s) for s in seqs)
    if line_len:
        seqs = ["\n".join(s[i:i + line_len] for i in range(0, len(s), line_len))
                for s in seqs]
    if out_format == "phylip":
        output.append(" " + str(n_samp) + " " + str(seq_len))
        for x in range(n_samp):
            output.append(names[x] + "   " + seqs[x])
    elif out_format == "fasta":
        for x in range(n_samp):
            output.append(">" + names[x])
            output.append(seqs[x])
    else:
        raise ValueError("outFormat must be 'phylip' or 'fasta'")
    return "\n".join(output) + "\n"
