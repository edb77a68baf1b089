"""The mesh's own stages (engine.StageTimer under ``--profile``):
``replicate``, ``gather``, ``mirror`` and ``dist_stats``, and the counters
``mesh_slabs`` and ``gather_bytes``, on popgenWindows
runs of a small cohort of the benchmark's four-card configuration
(``kg3_superpops_node4`` cut to 22 people), with the cell
``kg3.popdist.mesh4``'s flags, on the CPU with ``cli.common.get_mesh``
patched to a mesh of four CPU shards.  On the mesh popDist popPairDist
takes the blocks route and hapStats the tri route, both on each shard's
window slab through the one slab function (pairdist._slab_dispatch); both
open the four stages.  The mesh's blocks run is held to the
benchmark's plain reference under the cell's limits and is byte-equal to
the one-card blocks run, as are the mesh's individual analyses and its
hapStats run to theirs; the one-card tri route (hapStats) and the blocks
route keep their stages; every route's CSV is the same with and without
``--profile``."""

import gzip
import shutil
import time

import pytest
import torch

from benchmark.harness import cell, compare, inputs, spec
from benchmark.tests.conftest import TINY_KG
from genomics_general_tpu_torch import engine
from genomics_general_tpu_torch.cli import common, popgen_windows
from genomics_general_tpu_torch.kernels import pairdist, transfer
from genomics_general_tpu_torch.parallel import mesh as port_mesh

CELL = "kg3.popdist.mesh4"
SEED = 2**31 + 23
N_DEV = 4
NEW = {"replicate", "gather", "mirror", "dist_stats"}


def _cut():
    work = {**spec.workload(CELL), "sites": TINY_KG["n_sites"]}
    cfg = {**spec.config(work["config"]), **TINY_KG}
    return cfg, work


def _flags(work, pops, analysis=None):
    flags = [f.replace("{pops}", str(pops)) for f in work["flags"]]
    if analysis is not None:
        at = flags.index("--analysis")
        flags[at + 1:at + 3] = analysis
    return flags


# route: (on the mesh, --analysis in place of the cell's, environment);
# "mesh" is the cell's popDist popPairDist on the mesh (the blocks route on
# each shard's window slab), "mesh_tri" hapStats on the mesh (the tri
# route), and the "_wire2" and "_raw" routes are both under GGT_WIRE=2
# and GGT_PACKED_TRANSFER=0 (the tri route's raw slabs)
WIRE2, RAW = {"GGT_WIRE": "2"}, {"GGT_PACKED_TRANSFER": "0"}
ROUTES = {"mesh": (True, None, {}), "mesh_tri": (True, ["hapStats"], {}),
          "tri": (False, ["hapStats"], {}), "blocks": (False, None, {}),
          "mesh_wire2": (True, None, WIRE2),
          "mesh_tri_wire2": (True, ["hapStats"], WIRE2),
          "mesh_raw": (True, None, RAW),
          "mesh_tri_raw": (True, ["hapStats"], RAW)}
MESH_ROUTES = ("mesh", "mesh_tri")
# the cell's -p populations, and so the blocks' P
N_POPS = len(TINY_KG["superpopulations"])


class _Recorder:
    """While in use: every StageTimer made, and the windows of each flush
    handed to the one slab function of the pair counts, on every route."""

    def __init__(self, mp):
        self.made, self.calls = [], []
        made, calls = self.made, self.calls

        class Recording(engine.StageTimer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        def spy(real):
            def call(alleles, first, *a, **kw):
                calls.append(first.shape[0])
                return real(alleles, first, *a, **kw)
            return call
        mp.setattr(engine, "StageTimer", Recording)
        mp.setattr(pairdist, "_slab_dispatch",
                   spy(pairdist._slab_dispatch))


def _run(tmp, work, name, analysis, mesh, traced):
    """One popgenWindows run of the cut cohort in ``tmp`` on ``mesh`` (None:
    one device): its CSV's bytes."""
    common.get_mesh = lambda: mesh
    csv = tmp / f"{name}-{int(traced)}.csv"
    argv = ["-g", str(tmp / "input.geno.gz"),
            *_flags(work, tmp / "pops.txt", analysis),
            "-o", str(csv)] + (["--profile"] if traced else [])
    assert popgen_windows.main(argv) == 0
    return csv.read_bytes()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The cut cohort's input, made once, with the runs' environment in
    force: (the runs' recorder, the input's directory, the cut config, the
    cut cell)."""
    tmp = tmp_path_factory.mktemp("mesh_stages")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("GGT_DEVICE", "cpu")
        mp.setenv("OMP_NUM_THREADS", "1")
        # small chunks and flushes: several flushes of 2 to 4 windows
        mp.setenv("GGT_CHUNK_BYTES", "20000")
        mp.setenv("GGT_FLUSH_WINDOWS", "8")
        mp.setattr(common, "get_mesh", common.get_mesh)
        rec = _Recorder(mp)
        cfg, work = _cut()
        inputs.make(tmp, cfg, work, SEED, torch.device("cpu"))
        yield rec, tmp, cfg, work
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(cohort):
    """Each route run with and without --profile: {(route, traced): (its
    timer, its CSV bytes, its wall s)}, and the windows of each flush of
    each traced mesh run, {("calls", route): [W, ...]}."""
    rec, tmp, cfg, work = cohort
    four = port_mesh.make_mesh(N_DEV)
    out = {}
    for route, (on_mesh, analysis, env) in ROUTES.items():
        for traced in (True, False):
            rec.calls.clear()
            t0 = time.perf_counter()
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                got = _run(tmp, work, route, analysis,
                           four if on_mesh else None, traced)
            out[route, traced] = (rec.made[-1], got,
                                  time.perf_counter() - t0)
            if on_mesh and traced:
                out["calls", route] = list(rec.calls)
    out["cfg"], out["work"] = cfg, work
    return out


def test_mesh_run_matches_the_plain_reference(runs, tmp_path):
    cfg, work = runs["cfg"], runs["work"]
    table, job = cell.expected(cfg, work, SEED, torch.device("cpu"),
                               torch.float64)
    assert job.windows.first.size == 6
    csv = tmp_path / "mesh.csv"
    csv.write_bytes(runs["mesh", False][1])
    got = compare.compare([csv], table, work["limits"])
    assert got["correct"], got["numbers"]
    assert got["attempted"] == 6 and got["failed"] == 0


def _slabs(calls) -> int:
    """The non-empty window slabs of flushes of ``calls`` windows."""
    return sum(hi > lo for W in calls for lo, hi in transfer.slabs(
        transfer.mesh_batch(W, N_DEV), N_DEV, W))


@pytest.mark.parametrize("route", MESH_ROUTES)
def test_mesh_run_opens_the_four_stages_and_counts_its_slabs(runs, route):
    timer, _, wall = runs[route, True]
    assert NEW <= set(timer.t) and "d2h" not in timer.t
    assert "h2d" not in timer.t and "finalize" not in timer.t
    lanes = {}
    for name, v in timer.t.items():
        lanes[timer.LANES[name]] = lanes.get(timer.LANES[name], 0.0) + v
    assert all(v <= wall for v in lanes.values()), (lanes, wall)
    calls = runs["calls", route]
    assert calls and sum(calls) == timer.counters["windows"]
    assert len(calls) == timer.counters["flushes"]
    assert timer.counters["mesh_slabs"] == _slabs(calls)
    if route == "mesh":
        # the blocks route: [W, 2, P, P] float64 back, not triangles
        assert timer.counters["gather_bytes"] == \
            sum(calls) * 2 * N_POPS * N_POPS * 8 > 0
        return
    H = 2 * TINY_KG["n_individuals"]
    # uint16 triangles: every window has fewer than 2^16 sites
    assert timer.counters["gather_bytes"] == sum(calls) * H * (H + 1) * 2 > 0


@pytest.mark.parametrize("route,one_card", [
    ("mesh", "blocks"), ("mesh_tri", "tri"), ("mesh_wire2", "blocks"),
    ("mesh_tri_wire2", "tri"), ("mesh_raw", "blocks"),
    ("mesh_tri_raw", "tri")])
def test_mesh_csv_is_the_one_card_csv(runs, route, one_card):
    assert runs[route, False][1] == runs[one_card, False][1]


@pytest.mark.parametrize("analysis", [["popDist", "indHet"],
                                      ["popDist", "popPairDist",
                                       "indPairDist"]])
def test_individual_blocks_on_the_mesh_match_one_card(cohort, analysis):
    """The blocks route's two individual paths (``pophet``: population
    blocks and each individual's own pair; ``indblocks``: a block an
    individual) on the mesh's window slabs: the four stages open, every
    slab runs on the blocks route, and the CSV is the one-card run's."""
    rec, tmp, _, work = cohort
    name = "_".join(analysis)
    one = _run(tmp, work, name, analysis, None, False)
    rec.calls.clear()
    on_mesh = _run(tmp, work, name, analysis, port_mesh.make_mesh(N_DEV),
                   True)
    timer = rec.made[-1]
    assert on_mesh == one and one.count(b"\n") > 1
    assert NEW <= set(timer.t) and not {"d2h", "finalize"} & set(timer.t)
    assert len(rec.calls) == timer.counters["flushes"]
    assert timer.counters["mesh_slabs"] == _slabs(rec.calls) > 0


@pytest.mark.parametrize("analysis", [None, ["hapStats"],
                                      ["popDist", "indHet"]])
def test_no_windows_on_the_mesh_write_the_one_card_csv(cohort, tmp_path,
                                                       analysis):
    """An input of its header alone plans no window: on the mesh as on
    one card the run writes the header and nothing else, and gathers no
    slab."""
    rec, tmp, _, work = cohort
    with gzip.open(tmp / "input.geno.gz", "rt") as f:
        header = f.readline()
    with gzip.open(tmp_path / "input.geno.gz", "wt") as f:
        f.write(header)
    shutil.copy(tmp / "pops.txt", tmp_path / "pops.txt")
    rec.calls.clear()
    on_mesh = _run(tmp_path, work, "empty", analysis,
                   port_mesh.make_mesh(N_DEV), True)
    assert rec.made[-1].counters["windows"] == 0
    assert "mesh_slabs" not in rec.made[-1].counters
    one = _run(tmp_path, work, "empty", analysis, None, False)
    assert on_mesh == one and one.count(b"\n") == 1


def test_one_card_tri_run_mirrors_without_a_gather(runs):
    timer = runs["tri", True][0]
    assert {"d2h", "mirror", "dist_stats"} <= set(timer.t)
    assert not {"gather", "replicate"} & set(timer.t)
    assert not {"mesh_slabs", "gather_bytes"} \
        & set(timer.counters)


def test_blocks_route_opens_none_of_the_four(runs):
    timer = runs["blocks", True][0]
    assert set(timer.t) == {"parse", "kernel", "d2h", "finalize", "write"}
    assert not {"mesh_slabs", "gather_bytes"} \
        & set(timer.counters)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_profile_keeps_the_csv(runs, route):
    traced, plain = runs[route, True][1], runs[route, False][1]
    assert traced == plain and plain.count(b"\n") > 1
    assert runs[route, False][0].t == {}
