"""The program's spans against the device's trace (harness/spans.py): one
clock, each card's busy intervals, and every idle nanosecond put down to
the innermost span open on the main thread, on synthetic intervals and on
a real run's timer."""

import pytest

from benchmark.harness import spans
from conftest import REPO

# two passes on the main thread ("MainThread"), one span on another
PASSES = [
    [("cli.main", "MainThread", 0, 100), ("A", "MainThread", 10, 30),
     ("B", "MainThread", 15, 20), ("C", "MainThread", 50, 60),
     ("parse", "Thread-1", 0, 90)],
    [("cli.main", "MainThread", 110, 150), ("D", "MainThread", 120, 140)],
]


def test_timeline_names_the_innermost_span():
    one = [(s, e, n) for n, th, s, e in PASSES[0] if th == "MainThread"]
    assert spans.host_timeline(one) == [
        (0, 10, "cli.main"), (10, 15, "A"), (15, 20, "B"), (20, 30, "A"),
        (30, 50, "cli.main"), (50, 60, "C"), (60, 100, "cli.main")]


def test_timeline_keeps_the_main_thread_of_each_pass():
    line = spans.main_thread_timeline(PASSES, lambda p: p)
    assert [seg[2] for seg in line] == [
        "cli.main", "A", "B", "A", "cli.main", "C", "cli.main",
        "cli.main", "D", "cli.main"]
    assert line[-3:] == [(110, 120, "cli.main"), (120, 140, "D"),
                         (140, 150, "cli.main")]
    assert spans.main_thread_timeline([[("parse", "T", 0, 5)]],
                                      lambda p: p) == []


def test_idle_gaps_nested_spans_between_passes_two_cards():
    # card 0 busy 12-18, 55-70, 125-130 (two events overlap); card 1 idle
    events = [(0, "k1", 12, 6), (0, "k2", 55, 10), (0, "Memcpy", 60, 10),
              (0, "k3", 125, 5)]
    busy = spans.busy_intervals(events)
    assert busy == {0: [(12, 18), (55, 70), (125, 130)]}
    line = spans.main_thread_timeline(PASSES, lambda p: p)
    got = spans.idle_by_host(busy, line, 0, 160, n_devices=2)
    # card 0: main 80, A 12, B 2, C 5, D 15, none 20 (100-110, 150-160)
    # card 1: main 90, A 15, B 5, C 10, D 20, none 20
    want = {"cli.main": 85, "A": 13.5, "B": 3.5, "C": 7.5, "D": 17.5,
            "none": 20}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()},
                                rel=1e-12)
    # every idle nanosecond is put down once
    assert sum(got.values()) == pytest.approx((160 - 26 + 160) / 2 / 1e9,
                                              rel=1e-12)


def test_idle_outside_every_span_and_busy_past_the_window():
    busy = {0: [(-50, 5), (95, 400)]}
    got = spans.idle_by_host(busy, [(20, 30, "X")], 0, 100, n_devices=1)
    assert got == pytest.approx({"none": 80e-9, "X": 10e-9}, rel=1e-12)


def test_perf_counter_maps_onto_the_profilers_clock():
    to = spans.perf_to_profiler((1000, 10), (2010, 1010))
    assert to(10) == 1000 and to(1010) == 2010 and to(510) == 1505


def test_seconds_and_counters_over_passes():
    assert spans.span_seconds(PASSES) == pytest.approx(
        {"cli.main": 140e-9, "A": 20e-9, "B": 5e-9, "C": 10e-9,
         "parse": 90e-9, "D": 20e-9}, rel=1e-12)

    class Timer:
        def __init__(self, counters):
            self.counters = counters
    assert spans.counters([Timer({"flushes": 1, "windows": 148}),
                           Timer({"flushes": 1, "windows": 148}),
                           object()]) == {"flushes": 2, "windows": 296}
    # a program whose timer keeps no spans gives empty passes
    assert spans.timer_spans([object()]) == [[]]


def test_record_keys_of_two_passes(tmp_path, monkeypatch):
    """Two popgenWindows passes with --profile on the CPU, and a device
    event over each ``dispatch.launch`` span: the keys' idle seconds are
    the window less the busy ones, none of them inside a launch."""
    from genomics_general_tpu_torch import engine
    from genomics_general_tpu_torch.cli import popgen_windows
    made = []

    class Recording(engine.StageTimer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("GGT_FLUSH_SITES", "1000")
    monkeypatch.setattr(engine, "StageTimer", Recording)
    data = REPO / "tests" / "data"
    c0 = spans.clock_pair()
    for k in range(2):
        assert popgen_windows.main([
            "-g", str(data / "sim1.geno.gz"), "-f", "phased", "-w", "20000",
            "-m", "100", "-p", "pop1", "-p", "pop2", "--popsFile",
            str(data / "sim1.pops.txt"), "--profile",
            "-o", str(tmp_path / f"{k}.csv")]) == 0
    c1 = spans.clock_pair()
    to = spans.perf_to_profiler(c0, c1)
    launches = [s for t in made for s in t.spans
                if s.name == "dispatch.launch"]
    events = [(0, "k", to(s.start), to(s.end) - to(s.start))
              for s in launches]
    keys = spans.record_keys(made, events, c0, c1, 1)
    idle = keys["idle_by_host"]
    window = (c1[0] - c0[0]) / 1e9
    busy = sum(e[3] for e in events) / 1e9
    assert sum(idle.values()) == pytest.approx(window - busy, rel=1e-6)
    assert "dispatch.launch" not in idle and idle["none"] > 0
    assert idle["dispatch.wait_parse"] > 0 and idle["cli.setup"] > 0
    assert keys["counters"]["flushes"] == sum(
        s.name == "flush" for t in made for s in t.spans) > 2
    assert keys["span_s"]["cli.main"] < window
    assert spans.record_keys([engine.StageTimer(False)], events, c0, c1,
                             1) == {}
