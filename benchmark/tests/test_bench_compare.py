"""The comparison of a pass's CSV with the reference's table."""

import numpy as np

from benchmark.harness import compare

LIMITS = {"layout_off": 0, "int_cells_off": 0, "nan_cells_off": 0,
          "max_gap": 1e-9}


def table():
    cols = ["scaffold", "start", "end", "mid", "sites", "l_A", "pi_A"]
    kinds = {"scaffold": "key", "start": "key", "end": "key", "mid": "key",
             "sites": "key", "l_A": "int", "pi_A": "float"}
    values = {"scaffold": np.array(["s", "s"], object),
              "start": np.array([1, 11]), "end": np.array([10, 20]),
              "mid": np.array([5.0, 15.0]), "sites": np.array([3, 4]),
              "l_A": np.array([2.0, np.nan]),
              "pi_A": np.array([0.123456789012, 12.5])}
    return {"columns": cols, "kinds": kinds, "values": values}


def rows_of(t, round_to=10):
    return compare.as_csv_values(t, round_to)


def test_exact_rows_compare_equal():
    header, rows = rows_of(table())
    num, off, gap = compare.compare_rows(header, rows, table())
    assert num["layout_off"] == num["int_cells_off"] == 0
    assert num["nan_cells_off"] == 0 and num["max_gap"] < 5.1e-11
    assert rows[0] == ["s", "1", "10", "5", "3", "2", "0.123456789"]


def test_each_number_counts_its_fault():
    t = table()
    header, rows = rows_of(t)
    bad = [r[:] for r in rows]
    bad[0][2] = "11"            # a key cell
    bad[1][5] = "3"             # an int cell where the reference is NaN
    bad[0][6] = "nan"           # NaN on one side
    bad[1][6] = "12.5000001"    # a gap of 1e-7 relative to 12.5
    num, off, gap = compare.compare_rows(header, bad, t)
    assert num["layout_off"] == 1 and num["int_cells_off"] == 1
    assert num["nan_cells_off"] == 1
    assert abs(num["max_gap"] - 1e-7 / 12.5) < 1e-12
    assert off.tolist() == [True, True]


def test_missing_rows_header_and_files(tmp_path):
    t = table()
    header, rows = rows_of(t)
    num, off, _ = compare.compare_rows(header[:-1], rows[:1], t)
    assert num["layout_off"] == 1 + 1 + 1 and off.tolist() == [True, True]
    p = tmp_path / "a.csv"
    p.write_text(",".join(header) + "\n"
                 + "\n".join(",".join(r) for r in rows) + "\n")
    ok = compare.compare([p, p], t, LIMITS)
    assert ok["correct"] and ok["attempted"] == 4 and ok["failed"] == 0
    gone = compare.compare([p, tmp_path / "missing.csv"], t, LIMITS)
    assert not gone["correct"] and gone["failed"] == 2
    assert not compare.compare([], t, LIMITS)["correct"]


def test_gap_over_the_limit_fails_its_row(tmp_path):
    t = table()
    header, rows = rows_of(t)
    rows[0][6] = "0.1234568"
    p = tmp_path / "b.csv"
    p.write_text(",".join(header) + "\n"
                 + "\n".join(",".join(r) for r in rows) + "\n")
    res = compare.compare([p], t, LIMITS)
    assert not res["correct"] and res["failed"] == 1
