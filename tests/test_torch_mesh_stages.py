"""The tri route's own stages (engine.StageTimer under ``--profile``):
``replicate``, ``gather``, ``mirror`` and ``dist_stats``, and the counters
``mesh_slabs`` and ``gather_bytes``, on popgenWindows runs of a small
cohort of the benchmark's four-card configuration (``kg3_superpops_node4``
cut to 22 people), with the cell ``kg3.popdist.mesh4``'s flags, on the CPU
with ``cli.common.get_mesh`` patched to a mesh of four CPU shards.  The
mesh run is held to the benchmark's plain reference under the cell's
limits; the one-card tri route (hapStats) and the blocks route keep their
stages; every route's CSV is the same with and without ``--profile``."""

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


# route: (on the mesh, --analysis in place of the cell's)
ROUTES = {"mesh": (True, None), "tri": (False, ["hapStats"]),
          "blocks": (False, None)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each route run with and without --profile: {(route, traced): (its
    timer, its CSV bytes, its wall s)}, and the windows of each call of
    the mesh's pair counts in the traced mesh run."""
    tmp = tmp_path_factory.mktemp("mesh_stages")
    mp = pytest.MonkeyPatch()
    made, mesh_calls = [], []

    class Recording(engine.StageTimer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    real = pairdist._mesh_pair_counts

    def spy(alleles, first, n_sites, mesh):
        mesh_calls.append(first.shape[0])
        return real(alleles, first, n_sites, mesh)
    out = {}
    try:
        mp.setenv("GGT_DEVICE", "cpu")
        mp.setenv("OMP_NUM_THREADS", "1")
        # small chunks and flushes: several flushes of 2 to 4 windows
        mp.setenv("GGT_CHUNK_BYTES", "20000")
        mp.setenv("GGT_FLUSH_WINDOWS", "8")
        mp.setattr(engine, "StageTimer", Recording)
        mp.setattr(pairdist, "_mesh_pair_counts", spy)
        cfg, work = _cut()
        inputs.make(tmp, cfg, work, SEED, torch.device("cpu"))
        four = port_mesh.make_mesh(N_DEV)
        for route, (on_mesh, analysis) in ROUTES.items():
            mp.setattr(common, "get_mesh", lambda m=four if on_mesh else None: m)
            for traced in (True, False):
                csv = tmp / f"{route}-{int(traced)}.csv"
                argv = ["-g", str(tmp / "input.geno.gz"),
                        *_flags(work, tmp / "pops.txt", analysis),
                        "-o", str(csv)] + (["--profile"] if traced else [])
                mesh_calls.clear()
                t0 = time.perf_counter()
                assert popgen_windows.main(argv) == 0
                out[route, traced] = (made[-1], csv.read_bytes(),
                                      time.perf_counter() - t0)
                if route == "mesh" and traced:
                    out["mesh_calls"] = list(mesh_calls)
    finally:
        mp.undo()
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


def test_mesh_run_opens_the_four_stages_and_counts_its_slabs(runs):
    timer, _, wall = runs["mesh", True]
    assert NEW <= set(timer.t) and "d2h" not in timer.t
    assert "h2d" not in timer.t and "finalize" not in timer.t
    lanes = {}
    for name, v in timer.t.items():
        lanes[timer.LANES[name]] = lanes.get(timer.LANES[name], 0.0) + v
    assert all(v <= wall for v in lanes.values()), (lanes, wall)
    calls = runs["mesh_calls"]
    assert calls and sum(calls) == timer.counters["windows"]
    assert len(calls) == timer.counters["flushes"]
    slabs = sum(hi > lo for W in calls for lo, hi in transfer.slabs(
        transfer.mesh_batch(W, N_DEV), N_DEV, W))
    assert timer.counters["mesh_slabs"] == slabs
    H = 2 * TINY_KG["n_individuals"]
    # uint16 triangles: every window has fewer than 2^16 sites
    assert timer.counters["gather_bytes"] == sum(calls) * H * (H + 1) * 2 > 0


def test_one_card_tri_run_mirrors_without_a_gather(runs):
    timer = runs["tri", True][0]
    assert {"d2h", "mirror", "dist_stats"} <= set(timer.t)
    assert not {"gather", "replicate"} & set(timer.t)
    assert not {"mesh_slabs", "gather_bytes"} & set(timer.counters)


def test_blocks_route_opens_none_of_the_four(runs):
    timer = runs["blocks", True][0]
    assert set(timer.t) == {"parse", "kernel", "d2h", "finalize", "write"}
    assert not {"mesh_slabs", "gather_bytes"} & set(timer.counters)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_profile_keeps_the_csv(runs, route):
    traced, plain = runs[route, True][1], runs[route, False][1]
    assert traced == plain and plain.count(b"\n") > 1
    assert runs[route, False][0].t == {}
