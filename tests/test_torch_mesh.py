"""The port's device mesh (parallel/mesh.py, the ``mesh=`` dispatches,
multihost.mesh_reduce_stacked, entry.dryrun_multichip) on CPU meshes:
``Mesh([cpu] * 8)`` and a 3-device mesh (so the padding is not a no-op),
against the JAX functions on the conftest's 8-device CPU mesh, on the same
numpy inputs.  Integers exactly, float64 sums to rtol 1e-12, CSVs byte for
byte.  tests/test_multichip.py's five cases come first."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import abba as jax_abba
from genomics_general_tpu.kernels import counts as jax_counts
from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.parallel import mesh as jax_mesh
from genomics_general_tpu.parallel import multihost as jax_multihost
from genomics_general_tpu_torch import entry as port_entry
from genomics_general_tpu_torch.kernels import abba as port_abba
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer
from genomics_general_tpu_torch.parallel import dispatch as port_dispatch
from genomics_general_tpu_torch.parallel import mesh as port_mesh
from genomics_general_tpu_torch.parallel import multihost as port_multihost

from .util import REPO, run_cli

CPU = torch.device("cpu")
MESHES = [8, 3]
D = REPO / "tests" / "data"


@pytest.fixture(autouse=True)
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("GGT_EXEC", "tpu")
    port_pair.reset_launches()
    port_counts.reset_launches()
    port_abba.reset_launches()
    yield
    # the wrappers take their plain versions on CPU tensors: no launch
    for mod in (port_pair, port_counts, port_abba):
        assert not any(mod.LAUNCHES.values())


def _mesh(n):
    return port_mesh.Mesh([CPU] * n)


@pytest.fixture(scope="module")
def jmesh():
    m = jax_mesh.make_mesh()
    assert m.devices.size == 8
    return m


@pytest.fixture(scope="module")
def data():
    """tests/test_multichip.py's data: H = 12, S = 3000, 10 % missing."""
    rng = np.random.default_rng(3)
    H, S = 12, 3000
    alleles = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    alleles[rng.random((H, S)) < 0.1] = -1
    pop_mask = np.zeros((2, H), np.float32)
    pop_mask[0, :6] = 1
    pop_mask[1, 6:] = 1
    return alleles, pop_mask


def tie_data(seed=11, S=4000):
    """Complete sites only, 3 populations of 4 haplotypes: sites split 6/6
    between two alleles (a tie of the totals, where numpy's argsort and
    jnp.argsort pick different targets), 7/5 splits, monomorphic sites,
    3-allele sites, and a few incomplete sites."""
    rng = np.random.default_rng(seed)
    H = 12
    a = np.empty((H, S), np.int8)
    for s in range(S):
        kind = s % 4
        x, y, z = rng.choice(4, size=3, replace=False)
        if kind == 0:
            col = np.where(rng.permutation(H) < 6, x, y)
        elif kind == 1:
            col = np.where(rng.permutation(H) < 7, x, y)
        elif kind == 2:
            col = np.full(H, x)
        else:
            col = np.where(rng.permutation(H) < 5, x,
                           np.where(rng.permutation(H) < 6, y, z))
        a[:, s] = col
    a[rng.integers(0, H, 60), rng.integers(0, S, 60)] = -1
    pm = np.zeros((3, H), np.float32)
    for p in range(3):
        pm[p, 4 * p:4 * p + 4] = 1
    return a, pm


# ------------------------------------------ tests/test_multichip.py's cases

@pytest.mark.parametrize("n_dev", MESHES)
def test_sharded_pair_counts_match_jax(data, jmesh, n_dev):
    alleles, _ = data
    first = np.array([0, 500, 1000, 1500, 2000, 2400], np.int32)
    n_s = np.array([500, 500, 500, 500, 400, 600], np.int32)
    got = port_mesh.sharded_window_pair_counts(alleles, first, n_s,
                                               _mesh(n_dev), s_max=1024)
    want = jax_mesh.sharded_window_pair_counts(alleles, first, n_s, jmesh,
                                               s_max=1024)
    one = port_pair.window_pair_counts(alleles, first, n_s)
    for g, w, o in zip(got, want, one):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("n_dev", MESHES)
def test_sharded_pair_counts_tp_match_jax(data, jmesh, n_dev):
    """The haplotype rows of the [W, H, H] counts over the mesh (K14's
    plain version on each row block; 12 rows pad to 15 on 3 devices and
    to 16 on 8, two of whose blocks are padding alone)."""
    alleles, _ = data
    first = np.array([0, 700, 1500, 2300], np.int32)
    n_s = np.array([700, 800, 800, 700], np.int32)
    got = port_mesh.sharded_pair_counts_tp(alleles, first, n_s, _mesh(n_dev),
                                           s_max=1024)
    want = jax_mesh.sharded_pair_counts_tp(alleles, first, n_s, jmesh,
                                           s_max=1024)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_dev", MESHES)
def test_sharded_site_counts_match_jax(data, jmesh, n_dev):
    alleles, pop_mask = data
    got = port_mesh.sharded_site_pop_counts(alleles, pop_mask, _mesh(n_dev))
    want = jax_mesh.sharded_site_pop_counts(alleles, pop_mask, jmesh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_counts.site_pop_counts_chunked(alleles, pop_mask))


def _sfs_oracle(alleles, pop_mask, n_hap):
    """tests/test_multichip.py's numpy oracle, with a stable argsort (the
    JAX function's order on tied totals)."""
    want = np.zeros(tuple(int(n) + 1 for n in n_hap), np.int64)
    for s in range(alleles.shape[1]):
        col = alleles[:, s]
        cnts = []
        for p in range(pop_mask.shape[0]):
            vals = col[np.flatnonzero(pop_mask[p])]
            vals = vals[vals >= 0]
            if vals.size != n_hap[p]:
                break
            cnts.append(np.bincount(vals, minlength=4))
        else:
            total = np.sum(cnts, axis=0)
            if 1 <= (total > 0).sum() <= 2:
                target = np.argsort(total, kind="stable")[2]
                want[tuple(int(c[target]) for c in cnts)] += 1
    return want


@pytest.mark.parametrize("n_dev", MESHES)
@pytest.mark.parametrize("kind", ["multichip", "ties"])
def test_sharded_global_sfs_match_jax(data, jmesh, n_dev, kind):
    """The global SFS (plain K15 per shard, plain K16 merge) equals the
    JAX function, the stable-argsort oracle, and, on the tie-heavy data,
    differs from the unstable numpy argsort that tests/test_multichip.py's
    oracle uses."""
    alleles, pop_mask = data if kind == "multichip" else tie_data()
    n_hap = pop_mask.sum(axis=1).astype(int)
    got = port_mesh.sharded_global_sfs(alleles, pop_mask, n_hap,
                                       _mesh(n_dev))
    want = jax_mesh.sharded_global_sfs(alleles, pop_mask, n_hap, jmesh)
    assert got.shape == want.shape == tuple(n_hap + 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _sfs_oracle(alleles, pop_mask, n_hap))
    if kind == "ties":
        assert got.sum() > 1000
        assert np.argsort(np.array([5, 5, 0, 0]))[2] != \
            np.argsort(np.array([5, 5, 0, 0]), kind="stable")[2]


@pytest.mark.parametrize("n_dev", MESHES)
def test_dryrun_multichip(n_dev):
    port_entry.dryrun_multichip(n_dev)


# ----------------------------------------------------- the mesh= dispatches

def messy_span(seed=5, H=21, S=2000):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    for s in rng.choice(S, size=S // 20, replace=False):
        a[rng.integers(0, H, 3), s] = rng.integers(2, 4)
    a[:, 100:150] = -1
    first = np.arange(0, S - 300, 97, dtype=np.int32)
    n = rng.integers(1, 300, size=first.size).astype(np.int32)
    n[2] = 0
    return a, first, n


@pytest.mark.parametrize("n_dev", MESHES)
@pytest.mark.parametrize("packed", ["1", "0"])
@pytest.mark.parametrize("source", ["host", "tensor", "replicated"])
def test_pair_counts_dispatch_mesh_matches_jax(jmesh, monkeypatch, n_dev,
                                               packed, source):
    """window_pair_counts_dispatch(mesh=): overlapping, empty and ragged
    windows over 19 windows (padded to 24 on 3 devices, 32 on 8), from a
    host span, a tensor and a replicated span, equal to the JAX mesh form
    and to the meshless port."""
    monkeypatch.setenv("GGT_PACKED_TRANSFER", packed)
    a, first, n = messy_span()
    mesh = _mesh(n_dev)
    src = {"host": a, "tensor": torch.from_numpy(a),
           "replicated": port_transfer.replicate(a, mesh)}[source]
    got = port_pair.window_pair_counts(src, first, n, mesh=mesh)
    want = jax_pair.window_pair_counts(a, first, n, mesh=jmesh)
    one = port_pair.window_pair_counts(a, first, n)
    for g, w, o in zip(got, want, one):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def _masks(H):
    part = np.zeros((3, H), np.float32)
    part[np.arange(H) % 3, np.arange(H)] = 1
    over = np.zeros((4, H), np.float32)
    over[0, :12] = over[1, 8:] = over[2, ::2] = 1
    return {"partition": part, "overlapping": over}


@pytest.mark.parametrize("n_dev", MESHES)
@pytest.mark.parametrize("packed", ["1", "0"])
@pytest.mark.parametrize("mask_kind", ["partition", "overlapping"])
def test_site_counts_dispatch_mesh_matches_jax(jmesh, monkeypatch, n_dev,
                                               packed, mask_kind):
    """site_pop_counts_dispatch(mesh=) in blocks of 264 sites (the last
    ragged; slabs that start off a byte of the span wire), on the span
    wire (K6) or the raw upload (K12), a partition or an overlapping mask
    (its classes), equal to the JAX mesh form."""
    monkeypatch.setenv("GGT_PACKED_TRANSFER", packed)
    a, _, _ = messy_span(seed=6)
    mask = _masks(a.shape[0])[mask_kind]
    got = port_counts.site_pop_counts_chunked(a, mask, block=264,
                                              mesh=_mesh(n_dev))
    want = jax_counts.site_pop_counts_chunked(a, mask, block=264,
                                              mesh=jmesh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, port_counts.site_pop_counts_chunked(a, mask))


@pytest.mark.parametrize("n_dev", MESHES)
@pytest.mark.parametrize("mode,full", [("minor", True), ("polarize", False),
                                       ("fixed", True)])
def test_abba_dispatch_mesh_matches_jax(jmesh, n_dev, mode, full):
    """window_abba_sums_dispatch(mesh=): the flush buffer replicated, every
    shard counts and terms all sites, K8 sums its window slab; equal to
    the meshless port bit for bit and to the JAX mesh form within rtol
    1e-12 (den_fh as tests/test_torch_abba.py compares it)."""
    from .test_torch_abba import DEN_FH, _alleles, _mask, _windows
    al = _alleles()
    mask, n_pops = _mask("overlap")
    first, n = _windows(al.shape[1])
    got = port_abba.window_abba_sums_dispatch(
        al, first, n, mask, n_pops, 0.0, mode, full,
        mesh=_mesh(n_dev)).collect()
    one = port_abba.window_abba_sums_dispatch(
        al, first, n, mask, n_pops, 0.0, mode, full).collect()
    np.testing.assert_array_equal(got, one)
    with jax.enable_x64(True):
        want = jax_abba.window_abba_sums_dispatch(
            al, first, n, mask, n_pops, 0.0, mode, full,
            mesh=jmesh).collect()
    got, want = got.copy(), want.copy()
    if full:
        fh = np.isnan(got[:, DEN_FH]) & ~np.isnan(want[:, DEN_FH])
        got[fh, DEN_FH] = want[fh, DEN_FH] = 0.0
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_dev", MESHES)
@pytest.mark.parametrize("op", ["sum", "min"])
def test_mesh_reduce_stacked_int64(jmesh, n_dev, op):
    """int64 values beyond 2^31 (the sfs merge's first-occurrence keys),
    24 stacked rows over the mesh: equal to the JAX reduce and numpy."""
    rng = np.random.default_rng(12)
    x = rng.integers(-(1 << 40), 1 << 40, size=(24, 5, 7), dtype=np.int64)
    x[:, 0, 0] = (1 << 62) - rng.integers(0, 1000, size=24)
    got = port_multihost.mesh_reduce_stacked(x, _mesh(n_dev), op)
    want = jax_multihost.mesh_reduce_stacked(x, jmesh, op)
    assert got.dtype == np.int64 and got.shape == (5, 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.sum(0) if op == "sum"
                                  else x.min(0))


def test_mesh_reduce_stacked_refuses_uneven_rows():
    with pytest.raises(ValueError, match="shard"):
        port_multihost.mesh_reduce_stacked(np.zeros((4, 2), np.int64),
                                           _mesh(3))


@pytest.mark.parametrize("rows", [(0, 5), (3, 17), (16, 21), (0, 21)])
def test_k14_plain_rows_equal_k9_rows(rows):
    """K14's plain version: row block r0 .. r1 - 1 of K9's counts, on
    blocks that cut K9's 64-row tiles' worth of small shapes, windows of 0
    and 1 site included."""
    a, first, n = messy_span(seed=8)
    n[0], n[1] = 0, 1
    at, f, k = (torch.from_numpy(x) for x in (a, first, n))
    r0, r1 = rows
    m, s = port_pair.pair_counts_4state_rows(at, f, k, r0, r1)
    mf, sf = port_pair.pair_counts_4state(at, f, k)
    np.testing.assert_array_equal(m.numpy(), mf.numpy()[:, r0:r1])
    np.testing.assert_array_equal(s.numpy(), sf.numpy()[:, r0:r1])


def test_k15_plain_follows_stable_order():
    """K15's plain version on hand-made tied counts: [3,3] splits target
    the lower code's partner as jnp.argsort orders them."""
    c = np.zeros((4, 2, 4), np.int32)
    c[0, :, 0], c[0, :, 1] = 3, 3            # 6/6 tie of codes 0 and 1
    c[1, :, 2], c[1, :, 3] = (2, 3), (4, 3)  # 5/7 split
    c[2, :, 1] = 6                           # monomorphic
    c[3, 0, :3] = 2                          # 3 alleles: skipped
    c[3, 1, 0] = 6
    got = port_counts.global_sfs_hist(torch.from_numpy(c), [6, 6]).numpy()
    want = np.zeros(49, np.int32)
    total = c.sum(axis=1)
    for s in range(3):
        t = np.argsort(total[s], kind="stable")[2]
        want[c[s, 0, t] * 7 + c[s, 1, t]] += 1
    np.testing.assert_array_equal(got, want)
    assert want[3 * 7 + 3] == 1 and want.sum() == 3


# ------------------------------------------------------------- the CLIs

RUN_A = ["--analysis", "popFreq", "popDist", "popPairDist", "indHet",
         "hapStats", "--fstMethod", "WC"]
POPS = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
        "--popsFile", str(D / "sim1.pops.txt")]
ABBA = ["-P1", "pop1", "-P2", "pop2", "-P3", "pop3", "-O", "pop4",
        "--popsFile", str(D / "sim1.pops.txt"), "--minData", "0.3",
        "--writeFailedWindows"]
CLIS = {
    "popgen": ("popgen_windows", ["-w", "50000", "-m", "100", *POPS,
                                  *RUN_A]),
    "popgen_raw": ("popgen_windows", ["-w", "50000", "-m", "100", *POPS,
                                      *RUN_A]),
    # the blocks route on the mesh's window slabs: overlapping windows,
    # empty ones written too
    "popgen_blocks": ("popgen_windows", [
        "-w", "50000", "-s", "20000", "-m", "50", *POPS, "--analysis",
        "popDist", "popPairDist", "indHet", "--writeFailedWindows"]),
    "abba": ("abba_windows", ["-w", "50000", "-s", "25000", "-m", "50",
                              *ABBA]),
    "fourpop": ("four_pop_windows", ["-w", "50000", "-m", "50", *ABBA]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_mesh_cli_bytes_equal_meshless_and_jax(tmp_path, monkeypatch, name):
    """popgenWindows (run A's analyses; again under GGT_PACKED_TRANSFER=0,
    one replicated raw upload per flush; popDist popPairDist indHet on
    the blocks route, each window slab its own wire), ABBABABAwindows and
    fourPopWindows on sim1 with cli.common.get_mesh patched to a 3-device
    CPU mesh: byte-equal to the meshless port and to the JAX CLI (which
    runs on its 8-device mesh)."""
    import importlib

    from genomics_general_tpu_torch.cli import common
    module, args = CLIS[name]
    if name.endswith("_raw"):
        monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    main = importlib.import_module(
        f"genomics_general_tpu_torch.cli.{module}").main
    args = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", *args]
    plain, meshed = tmp_path / "plain.csv", tmp_path / "mesh.csv"
    assert main(args + ["-o", str(plain)]) == 0
    seen = []
    real = port_pair.window_pair_counts_dispatch, \
        port_counts.site_pop_counts_dispatch, \
        port_abba.window_abba_sums_dispatch, \
        port_pair.window_pair_ind_blocks_dispatch

    def spy(real_fn):
        def call(*a, mesh=None, **kw):
            seen.append(mesh)
            return real_fn(*a, mesh=mesh, **kw)
        return call
    monkeypatch.setattr(port_pair, "window_pair_counts_dispatch",
                        spy(real[0]))
    monkeypatch.setattr(port_counts, "site_pop_counts_dispatch",
                        spy(real[1]))
    monkeypatch.setattr(port_abba, "window_abba_sums_dispatch", spy(real[2]))
    monkeypatch.setattr(port_pair, "window_pair_ind_blocks_dispatch",
                        spy(real[3]))
    mesh = _mesh(3)
    monkeypatch.setattr(common, "get_mesh", lambda: mesh)
    assert main(args + ["-o", str(meshed)]) == 0
    assert seen and all(m is mesh for m in seen)
    assert meshed.read_bytes() == plain.read_bytes()
    jax_out = tmp_path / "jax.csv"
    run_cli(f"genomics_general_tpu.cli.{module}", args + ["-o", str(jax_out)],
            env_extra={"GGT_PACKED_TRANSFER": "0"}
            if name.endswith("_raw") else None)
    assert meshed.read_bytes() == jax_out.read_bytes()


# ---------------------------------------------------- choosing the mesh

@pytest.mark.parametrize("env", [{"GGT_NO_MESH": "1"},
                                 {"GGT_DEVICE": "cpu"},
                                 {"GGT_NO_MESH": "1", "GGT_DEVICE": "cpu"}])
def test_default_mesh_none(monkeypatch, env):
    monkeypatch.delenv("GGT_DEVICE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_dispatch.default_mesh() is None


def test_make_mesh_on_the_cpu():
    m = port_mesh.make_mesh(3)
    assert m.size == 3 and m.devices == (CPU,) * 3
    assert m.axis_names == ("data",)
    assert port_mesh.make_mesh().size == 1
