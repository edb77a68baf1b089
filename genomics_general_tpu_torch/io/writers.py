"""Output formatting matching the reference CSV/matrix text exactly.

Number formatting rule (popgenWindows.py:66: ``round(x, roundTo)`` then
``str``): Python ``round`` on a float (correctly-rounded decimal, banker's
ties) and ``str`` shortest-repr.  NaN prints as ``nan``; integer-valued
columns (sites, l_, S_, sitesUsed, mid) print without a decimal point.
"""

from __future__ import annotations

import gzip
import io
import sys
import zlib

import numpy as np


class PiecedGzipFile(gzip.GzipFile):
    """One gzip member whose text is deflated in pieces of ``PIECE`` bytes,
    each ended by a full flush (an empty stored block, ``00 00 FF FF``,
    and a fresh dictionary).  Any gzip reader reads it as one member; the
    port's reader inflates the pieces in parallel (``io/native.GzFlushes``),
    as it does ``pigz -i`` output."""

    PIECE = 8 << 20

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._piece = 0

    def write(self, data):
        data = memoryview(data).cast("B")
        n = len(data)
        while len(data) >= self.PIECE - self._piece:
            k = self.PIECE - self._piece
            super().write(data[:k])
            self.flush(zlib.Z_FULL_FLUSH)
            self._piece, data = 0, data[k:]
        super().write(data)
        self._piece += len(data)
        return n


def open_gz_out(path: str, mode: str = "wt"):
    """``gzip.open(path, mode)`` for writing, in :class:`PiecedGzipFile`
    pieces."""
    f = PiecedGzipFile(path, "wb")
    return io.TextIOWrapper(f, io.text_encoding(None)) if "t" in mode else f


def open_out(path: str | None):
    if path is None:
        return sys.stdout
    if path.endswith(".gz"):
        return open_gz_out(path)
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
