"""Holding the CSVs of the timed passes against the reference's table.

Four numbers, each beside the cell's limit (``limits`` in its workload
file):

* ``layout_off``: header cells, rows and key cells (scaffold, start, end,
  mid, sites) that differ from the reference, and rows missing or extra;
* ``int_cells_off``: integer statistics (l_, S_) that differ, reported
  where the table has such a column;
* ``nan_cells_off``: float statistics that are NaN on one side only;
* ``max_gap``: the widest |program - reference| / max(1, |reference|) over
  the float statistics.

Every row of every pass is compared; a number is the worst over passes."""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

NUMBERS = ("layout_off", "int_cells_off", "nan_cells_off", "max_gap")


def read_csv(path: Path) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return (rows[0], rows[1:]) if rows else ([], [])


def _float(cell: str) -> float:
    try:
        return float(cell)
    except ValueError:
        return float("inf")       # unparsable: off by any measure


def compare_rows(header, rows, table):
    """(the four numbers, whether each expected row is off in a count,
    each expected row's widest gap) for one pass's CSV."""
    cols, kinds, values = table["columns"], table["kinds"], table["values"]
    n = len(values["start"])
    num = dict.fromkeys(NUMBERS, 0)
    num["max_gap"] = 0.0
    row_off = np.zeros(n, dtype=bool)
    row_gap = np.zeros(n)
    num["layout_off"] += sum(a != b for a, b in zip(header, cols)) \
        + abs(len(header) - len(cols))
    num["layout_off"] += abs(len(rows) - n)
    if len(rows) != n:
        row_off[len(rows):] = True
    at = {c: header.index(c) for c in cols if c in header}
    for r, row in enumerate(rows[:n]):
        for c in cols:
            want = values[c][r]
            if c not in at or at[c] >= len(row):
                num["layout_off"] += 1
                row_off[r] = True
                continue
            got = row[at[c]]
            kind = kinds[c]
            if kind == "key":
                if c == "scaffold":
                    ok = got == want
                elif np.isnan(float(want)):
                    ok = got == "nan"
                else:
                    ok = _float(got) == float(want)
                if not ok:
                    num["layout_off"] += 1
                    row_off[r] = True
            elif kind == "int":
                ok = got == "nan" if np.isnan(want) else \
                    _float(got) == float(want)
                if not ok:
                    num["int_cells_off"] += 1
                    row_off[r] = True
            else:
                g = _float(got) if got != "nan" else float("nan")
                if np.isnan(g) != np.isnan(want):
                    num["nan_cells_off"] += 1
                    row_off[r] = True
                elif not np.isnan(want):
                    gap = abs(g - want) / max(1.0, abs(want))
                    row_gap[r] = max(row_gap[r], gap)
    num["max_gap"] = float(row_gap.max()) if n else 0.0
    return num, row_off, row_gap


def compare(paths: list[Path], table: dict, limits: dict) -> dict:
    """Numbers over all passes, the rows attempted and failed, and
    ``correct``."""
    n = len(table["values"]["start"])
    names = [k for k in NUMBERS if k != "int_cells_off"
             or "int" in table["kinds"].values()]
    worst = dict.fromkeys(names, 0)
    worst["max_gap"] = 0.0
    failed = 0
    for path in paths:
        try:
            header, rows = read_csv(path)
        except OSError:
            header, rows = [], []
        num, off, gap = compare_rows(header, rows, table)
        for k in names:
            worst[k] = max(worst[k], num[k])
        failed += int((off | (gap > limits["max_gap"])).sum())
    correct = all(worst[k] <= limits[k] for k in names) and bool(paths)
    return {"numbers": worst, "attempted": n * len(paths), "failed": failed,
            "correct": correct}


def as_csv_values(table: dict, round_to: int) -> tuple[list[str], list[list[str]]]:
    """The reference's table as the program would print it: floats rounded
    to ``round_to`` places (numpy's round), integers as integers, NaN as
    nan.  The control of a lower precision is judged through this."""
    cols = table["columns"]
    values, kinds = table["values"], table["kinds"]
    n = len(values["start"])
    out = []
    for r in range(n):
        row = []
        for c in cols:
            v = values[c][r]
            if c == "scaffold":
                row.append(str(v))
            elif isinstance(v, (float, np.floating)) and np.isnan(v):
                row.append("nan")
            elif kinds[c] in ("key", "int"):
                row.append(str(int(v)))
            else:
                row.append(repr(float(np.round(np.float64(v), round_to))))
        out.append(row)
    return cols, out
