"""Generic numeric site-table reader (scaffold, position, value columns).

The port of genomics_general_tpu/io/table.py, with the same functions and
results; it launches no kernel.

Backs windowStats: the reference reads such tables through GenoFileReader
with str typing and converts to float per window (windowStats.py:161-163);
here the whole table is parsed once into dense arrays.
"""

from __future__ import annotations

import numpy as np

from .geno import open_maybe_gz


def read_numeric_table(path_or_file, header_line: str | None = None,
                       columns: list[str] | None = None):
    """Parse a whitespace-delimited table with scaffold/position leading
    columns.

    Returns (scaffold_names, scaffold_ids, positions, col_names, values)
    where values is float64 [n_cols, n_sites]; non-numeric entries parse
    as NaN (matching np.array(..., dtype=float) on the reference path).
    """
    close = False
    if isinstance(path_or_file, (str, bytes)):
        f = open_maybe_gz(path_or_file, "rb")
        close = True
    else:
        f = path_or_file
    try:
        if header_line is None:
            header_line = f.readline()
            if isinstance(header_line, bytes):
                header_line = header_line.decode()
        names = header_line.split()[2:]

        # C tokenizer fast path (exact float parsing; falls back on any
        # token outside the numeric grammar, e.g. text columns)
        data = f.read()
        if isinstance(data, str):
            data = data.encode()
        fast = None
        try:
            from . import native
            fast = native.parse_name_table(data, 1 + len(names))
        except Exception:
            fast = None
        if fast is not None:
            vals, bnames, bounds = fast
            if columns:
                idx = [names.index(c) for c in columns]
                names = list(columns)
            else:
                idx = list(range(len(names)))
            positions = vals[:, 0].astype(np.int64)
            values = np.ascontiguousarray(vals[:, 1:].T[idx])
            scaffold_names = []
            sid_of = {}
            sids = np.empty(vals.shape[0], np.int32)
            for k in range(len(bnames)):
                s = bnames[k].decode()
                if s not in sid_of:
                    sid_of[s] = len(scaffold_names)
                    scaffold_names.append(s)
                sids[bounds[k]:bounds[k + 1]] = sid_of[s]
            return scaffold_names, sids, positions, names, values

        scafs, poss, rows = [], [], []
        for line in data.split(b"\n"):
            line = line.decode()
            if not line.strip() or line[0] == "#":
                continue
            parts = line.split()
            scafs.append(parts[0])
            poss.append(int(parts[1]))
            rows.append(parts[2:])
    finally:
        if close:
            f.close()

    if columns:
        idx = [names.index(c) for c in columns]
        names = list(columns)
    else:
        idx = list(range(len(names)))

    scaffold_names: list[str] = []
    sid_of = {}
    sids = np.empty(len(scafs), np.int32)
    for i, s in enumerate(scafs):
        if s not in sid_of:
            sid_of[s] = len(scaffold_names)
            scaffold_names.append(s)
        sids[i] = sid_of[s]
    positions = np.asarray(poss, np.int64)

    raw = np.asarray(rows, dtype=object)
    values = np.empty((len(names), len(scafs)), np.float64)
    for j, c in enumerate(idx):
        col = raw[:, c] if raw.size else np.empty(0, object)
        try:
            values[j] = col.astype(np.float64)
        except ValueError:
            out = np.empty(len(col), np.float64)
            for i, v in enumerate(col):
                try:
                    out[i] = float(v)
                except ValueError:
                    out[i] = np.nan
            values[j] = out
    return scaffold_names, sids, positions, names, values
