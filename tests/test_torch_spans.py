"""The port's span and counter recorder (engine.StageTimer): disabled it
reads no clock and records nothing; enabled on a popgenWindows run of
many chunks and flushes, its spans nest by thread and flush, its counters
agree with the output, its stages keep their names, and the output bytes
are an untraced run's."""

import gzip
import time

import numpy as np
import pytest

from genomics_general_tpu_torch import engine
from genomics_general_tpu_torch.cli import popgen_windows
from genomics_general_tpu_torch.io import geno as geno_io
from genomics_general_tpu_torch.kernels import pairdist

from .util import REPO

D = REPO / "tests" / "data"
GENO = D / "sim1.geno.gz"
ARGS = ["-g", str(GENO), "-f", "phased", "-w", "20000", "-m", "100",
        "-p", "pop1", "-p", "pop2", "-p", "pop3",
        "--popsFile", str(D / "sim1.pops.txt"),
        "--analysis", "popDist", "popPairDist", "--writeFailedWindows"]
STAGES = {"parse", "kernel", "d2h", "finalize", "write"}
DISPATCH_CHILDREN = ("dispatch.pack", "dispatch.stage", "dispatch.launch")


def _no_clock(*a, **kw):
    raise AssertionError("a disabled StageTimer read a clock")


def test_disabled_timer_reads_no_clock_and_records_nothing(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setattr(time, "perf_counter_ns", _no_clock)
    monkeypatch.setattr(time, "perf_counter", _no_clock)
    timer = engine.StageTimer(False, start_ns=123)
    assert timer.stage("parse") is timer.span("parse.inflate") \
        is engine.NO_TIMER.stage("kernel")
    with timer.stage("parse"), timer.span("parse.inflate", flush=3):
        timer.count("chunks")
    timer.span_from_start("cli.setup")
    # a whole stream and a blocks-route dispatch under the disabled timer
    reader = geno_io.GenoReader(str(GENO), chunk_bytes=20000)
    wind = {"windType": "coordinate", "windSize": 20000, "stepSize": 20000,
            "minSites": 100}
    n = 0
    for batch in engine.stream_windows(reader, wind, min_flush_windows=4,
                                       timer=timer):
        plan = batch.plan
        if not plan.n_windows:
            continue
        mask = np.zeros((1, reader.model.n_rows))
        mask[0] = 1.0
        pairdist.window_pair_block_stats_dispatch(
            batch.alleles[:, :batch.needed_end],
            plan.first.astype(np.int32), plan.n_sites.astype(np.int32),
            mask, 100, timer=timer).collect()
        n += plan.n_windows
    timer.report()
    assert n > 0
    assert timer.spans == [] and timer.t == {} and timer.counters == {}


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """One popgenWindows run with --profile in this process, in chunks of
    20 kB and flushes of at most 1,000 sites; (its timer, its output
    bytes, an untraced run's output bytes)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("spans")
    made = []

    class Recording(engine.StageTimer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    try:
        mp.setenv("GGT_DEVICE", "cpu")
        mp.setenv("GGT_CHUNK_BYTES", "20000")
        mp.setenv("GGT_FLUSH_SITES", "1000")
        mp.setattr(engine, "StageTimer", Recording)
        assert popgen_windows.main(
            ARGS + ["--profile", "-o", str(tmp / "traced.csv")]) == 0
        assert popgen_windows.main(ARGS + ["-o", str(tmp / "plain.csv")]) == 0
    finally:
        mp.undo()
    assert [t.enabled for t in made] == [True, False]
    return (made[0], (tmp / "traced.csv").read_bytes(),
            (tmp / "plain.csv").read_bytes())


def _inside(child, parent):
    return (child.thread == parent.thread and parent.start <= child.start
            and child.end <= parent.end)


def test_every_span_closed_and_rooted(traced_run):
    timer = traced_run[0]
    assert all(s.end is not None and s.start <= s.end for s in timer.spans)
    root = [s for s in timer.spans if s.name == "cli.main"]
    assert len(root) == 1 and root[0].parent is None
    main = root[0].thread
    for name in ("cli.setup", "cli.close", "plan", "flush",
                 "dispatch.wait_parse", "dispatch.wait_collect", "kernel"):
        got = [s for s in timer.spans if s.name == name]
        assert got, name
        assert all(s.thread == main and s.parent is root[0]
                   and _inside(s, root[0]) for s in got), name
    setup = [s for s in timer.spans if s.name == "cli.setup"][0]
    assert setup.start == root[0].start
    assert setup.end <= min(s.start for s in timer.spans
                            if s.name == "dispatch.wait_parse")


def test_parse_children_lie_inside_parse(traced_run):
    timer = traced_run[0]
    children = [s for s in timer.spans if s.name.startswith("parse.")]
    assert {s.name for s in children} >= {"parse.inflate", "parse.append"}
    for s in children:
        assert s.parent is not None and s.parent.name == "parse"
        assert _inside(s, s.parent)
    parse_threads = {s.thread for s in timer.spans if s.name == "parse"}
    main = [s for s in timer.spans if s.name == "cli.main"][0].thread
    assert main not in parse_threads
    for s in timer.spans:
        if s.name == "prefetch.wait_put":
            assert s.thread in parse_threads and s.parent is None


def test_dispatch_children_carry_their_flush(traced_run):
    timer = traced_run[0]
    flushes = {s.flush: s for s in timer.spans if s.name == "flush"}
    assert len(flushes) == timer.counters["flushes"] > 2
    assert sorted(flushes) == list(range(len(flushes)))
    kernels = [s for s in timer.spans if s.name == "kernel"]
    children = [s for s in timer.spans if s.name in DISPATCH_CHILDREN]
    assert {s.name for s in children} >= {"dispatch.pack", "dispatch.launch"}
    for s in children:
        assert s.parent.name == "kernel" and _inside(s, s.parent)
        assert s.flush == s.parent.flush
    for k in kernels:
        assert flushes[k.flush].end <= k.start
        assert {s.name for s in children if s.parent is k} >= \
            {"dispatch.pack", "dispatch.launch"}
    assert sorted(k.flush for k in kernels) == sorted(flushes)
    for s in timer.spans:
        if s.name in ("d2h", "finalize", "write"):
            assert s.flush in flushes
        if s.name.startswith("dispatch.wait_"):
            assert s.parent.name == "cli.main"


def test_counters_agree_with_the_output(traced_run):
    timer, traced, _ = traced_run
    rows = traced.decode().splitlines()[1:]
    assert timer.counters["windows"] == len(rows) > 10
    text = gzip.decompress(GENO.read_bytes())
    n_sites = text.count(b"\n") - 1
    assert timer.counters["sites"] == n_sites
    assert timer.counters["text_bytes"] == len(text) - len(
        text.split(b"\n", 1)[0]) - 1
    # one parse stage a chunk, one to start the reader, one to end it
    assert timer.counters["chunks"] == sum(
        s.name == "parse" for s in timer.spans) - 2 > 5


def test_stages_keep_their_names_and_sums(traced_run):
    timer = traced_run[0]
    assert set(timer.t) == STAGES
    assert engine.StageTimer.LANES == {
        "parse": "parse", "h2d": "dispatch", "replicate": "dispatch",
        "kernel": "dispatch", "d2h": "collect", "gather": "collect",
        "mirror": "collect", "dist_stats": "collect", "finalize": "collect",
        "write": "collect"}
    for name in STAGES:
        spans = [s for s in timer.spans if s.name == name]
        assert timer.t[name] == pytest.approx(
            sum(s.end - s.start for s in spans) / 1e9, rel=1e-9)


def test_traced_output_is_the_untraced_output(traced_run):
    _, traced, plain = traced_run
    assert traced == plain and traced.count(b"\n") > 10


def test_report_names_spans_and_counters(traced_run, capsys):
    timer = traced_run[0]
    timer.report()
    line = capsys.readouterr().err
    assert line.startswith("[profile] wall ")
    for part in ("parse.inflate=", "dispatch.pack=", "cli.setup=",
                 "windows=", "flushes=", "text_bytes="):
        assert part in line, part
