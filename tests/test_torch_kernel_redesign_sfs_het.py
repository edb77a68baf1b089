"""K15 (global_sfs_hist) as redesigned for the card, and K5 (het_pairs)
at its launch floor, held on the CPU against the JAX package.

* K15: a numpy model of the kernel's schedule (tiles of sites staged at
  their offset mod 16, dealt to blocks in turn; each block's private
  corner histogram and its flush at the block's end; the lanes of a warp
  step grouped by bin, one add a group) against the port's plain version
  and the JAX ``mesh.sharded_global_sfs`` on the conftest's 8-device CPU
  mesh, and the port's ``sharded_global_sfs`` (plain K15 per shard, K16
  merge) on a 3-device CPU mesh, on the same numpy alleles: ties, P = 1
  and P = 5 (a population of no haplotypes), all-monomorphic input, and
  every corner edge k from 0 to the whole histogram.  int32 counts that
  are negative or sum past 2^31 go through the model and the plain
  version alone (the JAX function counts alleles).
* The corner's choice (``counts.sfs_corner``) and the staging's head,
  vectors and tail (the kernel's arithmetic, in numpy).
* K5: the wrapper refuses m or s that is not int32, or an s of another
  shape, before it looks at the device; on the CPU it equals the JAX
  ``blocks_het`` gather at its edges (one individual, a haploid pair,
  rows 0 and H - 1, one window).

Tolerances: every comparison is exact.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.parallel import mesh as jax_mesh
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.parallel import mesh as port_mesh
from chip_smoke import sfs_int32_extremes
from tests.test_torch_mesh import tie_data

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent
# the kernel's launch shapes the model runs: (sites a tile, blocks): the
# wrapper's, a ragged tile over 3 blocks (two warps with sites), and one
# site a tile (a warp of one valid lane); 256 threads a block, as the
# kernel's
SCHEDULES = [(1024, 8), (37, 3), (1, 2)]
THREADS = 256
CORNER_LEVELS = ["k=0", "k=1", "k=2", "k=half", "whole"]


@pytest.fixture(autouse=True)
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    port_counts.reset_launches()
    port_pair.reset_launches()
    yield
    assert not any(port_counts.LAUNCHES.values())
    assert not any(port_pair.LAUNCHES.values())


# ------------------------------------------------------ K15's schedule

def stage_plan(m0: int, e0: int, e1: int, V: int):
    """The kernel's staging of elements [e0, e1) of a tensor whose first
    element lies m0 elements past a 16-byte boundary (V elements a
    vector): (r, ea, eb) — element e goes to stage[e - e0 + r], [e0, ea)
    is the scalar head, [ea, eb) the aligned vectors, [eb, e1) the
    tail."""
    r = (m0 + e0) % V
    ea = min(e1, e0 + (V - r) % V)
    eb = max(ea, e1 - (m0 + e1) % V)
    return r, ea, eb


def site_terms(c: np.ndarray, n_hap, cdim):
    """Per site, the kernel's int64 arithmetic (wrapping as int64 does):
    (ok, flat bin, in the corner, corner index)."""
    n_hap = np.asarray(n_hap, np.int64)
    dims = n_hap + 1
    P = len(dims)
    stride = np.array([int(np.prod(dims[p + 1:], dtype=object))
                       for p in range(P)], np.int64)
    cstride = np.array([int(np.prod(cdim[p + 1:], dtype=object))
                        for p in range(P)], np.int64)
    tot = c.sum(axis=1)                                       # [S, 4]
    ok = (c.sum(axis=2) == n_hap).all(axis=1)
    na = (tot > 0).sum(axis=1)
    ok &= (na >= 1) & (na <= 2)
    i, j = np.arange(4)[:, None], np.arange(4)[None, :]
    less = tot[:, None, :] < tot[:, :, None]                  # [S, i, j]
    tie = (tot[:, None, :] == tot[:, :, None]) & (j < i)
    rank = (less | tie).sum(axis=2)                            # [S, 4]
    target = np.argmax(rank == 2, axis=1)
    x = np.take_along_axis(c, target[:, None, None].repeat(P, 1), 2)[:, :, 0]
    with np.errstate(over="ignore"):
        idx = (x * stride).sum(axis=1)
    in_corner = ((x >= 0) & (x < np.asarray(cdim))).all(axis=1)
    ci = np.where(in_corner, (np.where(in_corner[:, None], x, 0)
                              * cstride).sum(axis=1), 0)
    return ok, idx, in_corner, ci


def k15_model(counts: np.ndarray, n_hap, corner_bytes: int, tile: int,
              blocks: int, m0: int = 0):
    """K15's schedule in numpy: int64 [nbins] and the number of global
    atomics it makes.  Tile t goes to block t % blocks; a tile is staged
    (head, vectors, tail) and its sites taken THREADS at a time, each
    warp's passing lanes grouped by bin; a group in the corner adds to its
    block's private histogram, any other to the global one (when its bin
    is in range); each block flushes its non-zero corner entries at its
    end."""
    S, P, _ = counts.shape
    cdim = port_counts.sfs_corner(n_hap, corner_bytes)
    ncorner = int(np.prod(cdim, dtype=object))
    nbins = int(np.prod(np.asarray(n_hap, np.int64) + 1, dtype=object))
    dims = np.asarray(n_hap, np.int64) + 1
    stride = [int(np.prod(dims[p + 1:], dtype=object)) for p in range(P)]
    flat = counts.reshape(-1)
    per = 4 * P
    V = 8                             # uint16's elements a 16-byte vector
    staged = np.empty_like(counts)
    for t in range(-(-S // tile)):
        s0 = t * tile
        ns = min(tile, S - s0)
        e0, e1 = s0 * per, (s0 + ns) * per
        r, ea, eb = stage_plan(m0, e0, e1, V)
        stage = np.zeros(ns * per + V, counts.dtype)
        for lo, hi in ((e0, ea), (ea, eb), (eb, e1)):
            stage[lo - e0 + r:hi - e0 + r] = flat[lo:hi]
        staged[s0:s0 + ns] = stage[r:r + ns * per].reshape(ns, P, 4)
    ok, idx, in_corner, ci = site_terms(staged.astype(np.int64), n_hap,
                                        cdim)
    s = np.arange(S)
    t, j = s // tile, s % tile
    block = t % blocks
    steps = -(-tile // THREADS)
    warp = (t * steps + j // THREADS) * (THREADS // 32) + (j % THREADS) // 32
    hist = np.zeros(nbins, np.int64)
    corner = np.zeros((blocks, max(ncorner, 1)), np.int64)
    sel = np.flatnonzero(ok)
    keys, first, n = np.unique(np.stack([warp[sel], idx[sel]]), axis=1,
                               return_index=True, return_counts=True)
    lead = sel[first]                           # a group's first lane
    atomics = 0
    for site, cnt in zip(lead, n):
        if in_corner[site]:
            corner[block[site], ci[site]] += cnt
        elif 0 <= idx[site] < nbins:
            hist[idx[site]] += cnt
            atomics += 1
    for b in range(blocks):
        for q0 in np.flatnonzero(corner[b, :ncorner]):
            q, bin_ = int(q0), 0
            for p in range(P - 1, -1, -1):
                bin_ += (q % int(cdim[p])) * stride[p]
                q //= int(cdim[p])
            hist[bin_] += corner[b, q0]
            atomics += 1
    return hist, atomics


# ------------------------------------------------------------- data

def _alleles(n_hap, S: int, seed: int, mono: bool = False):
    """int8 [H, S] alleles of populations of ``n_hap`` haplotypes (rows in
    order) and their 0/1 mask: two alleles x, y a site with per-site
    frequencies from a U-shaped beta (many sites near the corner's edges),
    2 % of sites with a third allele in one haplotype, 1 % of calls
    missing; ``mono``: every site all x."""
    rng = np.random.default_rng(seed)
    H = int(sum(n_hap))
    xyz = np.argsort(rng.random((S, 4)), axis=1)[:, :3]
    f = rng.beta(0.3, 0.3, size=S)
    a = np.where(rng.random((H, S)) < (0 if mono else f), xyz[:, 1],
                 xyz[:, 0]).astype(np.int8)
    if not mono:
        third = np.flatnonzero(rng.random(S) < 0.02)
        a[rng.integers(0, H, third.size), third] = xyz[third, 2]
    a[rng.random((H, S)) < 0.01] = -1
    pm = np.zeros((len(n_hap), H), np.float32)
    lo = 0
    for p, n in enumerate(n_hap):
        pm[p, lo:lo + n] = 1
        lo += n
    return a, pm


def _counts(a, pm) -> np.ndarray:
    """uint16 [S, P, 4]: each population's calls of each allele."""
    onehot = (a[:, :, None] == np.arange(4)).astype(np.int64)  # [H, S, 4]
    return np.einsum("ph,hsa->spa", pm.astype(np.int64),
                     onehot).astype(np.uint16)


DATA = {
    "ties": lambda: tie_data(),
    "P=1": lambda: _alleles([40], 3000, 1),
    "P=5": lambda: _alleles([6, 4, 0, 10, 2], 3000, 2),
    "monomorphic": lambda: _alleles([8, 6, 4], 2000, 3, mono=True),
}


@pytest.fixture(scope="module")
def jmesh():
    m = jax_mesh.make_mesh()
    assert m.devices.size == 8
    return m


@pytest.fixture(scope="module")
def sfs_cases(jmesh):
    """Each data set's alleles, mask, n_hap, counts and the JAX function's
    spectrum (flat), computed once."""
    out = {}
    for name, make in DATA.items():
        a, pm = make()
        n_hap = pm.sum(axis=1).astype(np.int64)
        want = jax_mesh.sharded_global_sfs(a, pm, n_hap, jmesh).reshape(-1)
        out[name] = (a, pm, n_hap, _counts(a, pm), want)
    return out


def _corner_bytes(n_hap, level: str) -> int:
    n = np.asarray(n_hap, np.int64)
    k = {"k=0": 0, "k=1": 1, "k=2": 2, "k=half": int(n.max()) // 2,
         "whole": int(n.max())}[level]
    return 4 * int(np.prod(np.minimum(k + 1, n + 1), dtype=object))


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=[f"tile{t}-blocks{b}" for t, b in SCHEDULES])
@pytest.mark.parametrize("level", CORNER_LEVELS)
@pytest.mark.parametrize("name", list(DATA))
def test_k15_model_matches_jax(sfs_cases, name, level, schedule):
    """The schedule model == the plain version == the JAX function, at
    every corner edge; the corner really is the one asked for."""
    _, _, n_hap, c, want = sfs_cases[name]
    cb = _corner_bytes(n_hap, level)
    k = {"k=0": 0, "k=1": 1, "k=2": 2}.get(level)
    if k is not None:
        assert port_counts.sfs_corner(n_hap, cb).max() == k + 1
    got, _ = k15_model(c, n_hap, cb, *schedule)
    np.testing.assert_array_equal(got, want)
    plain = port_counts.global_sfs_hist(torch.from_numpy(c), n_hap)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("name", list(DATA))
def test_k15_sharded_route_matches_jax(sfs_cases, name):
    """The port's sharded_global_sfs (plain K15 per shard of a 3-device
    CPU mesh, K16 merge) == the JAX function on the 8-device mesh."""
    a, pm, n_hap, _, want = sfs_cases[name]
    got = port_mesh.sharded_global_sfs(a, pm, n_hap,
                                       port_mesh.Mesh([CPU] * 3))
    np.testing.assert_array_equal(got.reshape(-1), want)
    if name == "monomorphic":
        assert want[0] == want.sum() > 0


@pytest.mark.parametrize("m0", range(8))
def test_k15_model_any_offset(sfs_cases, m0):
    """A tensor m0 elements past a 16-byte boundary (c[1:] is 12
    elements past at P = 3) stages every tile the same: the model ==
    JAX."""
    _, _, n_hap, c, want = sfs_cases["ties"]
    got, _ = k15_model(c, n_hap, 2048, 37, 3, m0=m0)
    np.testing.assert_array_equal(got, want)


def test_k15_corner_takes_the_hot_bins(sfs_cases):
    """All-monomorphic input: every site in bin 0, which the corner holds,
    so the only global atomics are the blocks' flushes (one a block that
    saw a site), where one a site would be 1,000s."""
    _, _, n_hap, c, want = sfs_cases["monomorphic"]
    got, atomics = k15_model(c, n_hap, 2048, 1024, 8)
    np.testing.assert_array_equal(got, want)
    assert atomics <= 2
    got, atomics = k15_model(c, n_hap, 2048, 37, 3)
    assert atomics <= 3


@pytest.mark.parametrize("V, m0", [(8, m) for m in range(8)]
                         + [(4, m) for m in range(4)])
def test_k15_stage_plan(V, m0):
    """The staging's head, vectors and tail partition each tile's
    elements (uint16: 8 a vector, int32: 4), the vectors start on a
    16-byte boundary in device memory and in shared memory, and the head
    and tail are under one vector."""
    for e0 in range(0, 40):
        for n in range(0, 50):
            e1 = e0 + n
            r, ea, eb = stage_plan(m0, e0, e1, V)
            assert e0 <= ea <= eb <= e1
            assert ea - e0 < V and e1 - eb < V
            if eb > ea:
                assert (m0 + ea) % V == 0 and (eb - ea) % V == 0
                assert (ea - e0 + r) % V == 0
            assert r + (e1 - e0) <= n + V


@pytest.mark.parametrize("schedule", SCHEDULES,
                         ids=[f"tile{t}-blocks{b}" for t, b in SCHEDULES])
def test_k15_model_int32_extremes(schedule):
    """int32 counts that are negative or sum past 2^31 (chip_smoke's
    sfs_int32_extremes, which k15_edge_parity holds the kernel to): the
    model's int64 arithmetic == the plain version; in 32 bits a sum of
    2^32 + n would pass as n."""
    n_hap = [128, 0, 64]
    c = sfs_int32_extremes(n_hap, 500)
    got, _ = k15_model(c, n_hap, 2048, *schedule)
    want = port_counts.global_sfs_hist(
        torch.from_numpy(c.astype(np.int32)), n_hap).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 500
    sums32 = c.sum(axis=2).astype(np.int32)    # the wrap a 32-bit sum makes
    assert ((sums32 == np.array(n_hap)).all(axis=1)
            & ~(c.sum(axis=2) == np.array(n_hap)).all(axis=1)).any()


@pytest.mark.parametrize("n_hap, budget, want", [
    ([128, 128, 128], 16 << 10, [16, 16, 16]),
    ([128, 128, 128], 2 << 10, [8, 8, 8]),
    ([128, 0, 64], 2 << 10, [22, 1, 22]),
    ([10, 20, 0, 30, 8], 2 << 10, [4, 4, 1, 4, 4]),
    ([40], 2 << 10, [41]),
    ([46340, 46340], 2 << 10, [22, 22]),
    ([5], 0, [1]),
    ([0, -1], 2 << 10, [0, 0]),
])
def test_sfs_corner(n_hap, budget, want):
    """The largest k whose corner of int32 entries fits the budget (the
    whole histogram when it fits; none when an n_hap is negative)."""
    got = port_counts.sfs_corner(n_hap, budget)
    np.testing.assert_array_equal(got, want)
    n = np.asarray(n_hap)
    if (n >= 0).all() and (got < n + 1).any():
        k = int(got.max())                 # k + 1 would not fit
        assert np.prod(np.minimum(k + 1, n + 1)) > max(budget // 4, 1)


def test_sfs_bins_plain_is_the_histogram(sfs_cases):
    """The plain version's flat bins, counted, are its histogram."""
    _, _, n_hap, c, want = sfs_cases["P=5"]
    flat = port_counts.global_sfs_bins_plain(torch.from_numpy(c), n_hap)
    np.testing.assert_array_equal(
        np.bincount(flat.numpy(), minlength=want.size), want)


# ----------------------------------------------------------------- K5

def _het_case(H: int, nwin: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 1 << 20, size=(nwin, H, H), dtype=np.int32)
    s = rng.integers(0, 1 << 20, size=(nwin, H, H), dtype=np.int32)
    return m, s


@pytest.mark.parametrize("bad", ["m int64", "s int64", "s float32",
                                 "s another shape"])
def test_het_pairs_refuses(bad):
    """m and s must be int32 of one shape: anything else raises
    ValueError before the device is looked at (the kernel reads int32
    [nwin, h, h] through both pointers)."""
    m, s = (torch.from_numpy(x) for x in _het_case(6, 2))
    r = torch.tensor([0, 2], dtype=torch.int32)
    out = torch.empty((2, 2, 2), dtype=torch.float64)
    if bad == "m int64":
        m = m.long()
    elif bad == "s int64":
        s = s.long()
    elif bad == "s float32":
        s = s.float()
    else:
        s = s[:, :5, :5].contiguous()
    with pytest.raises(ValueError, match="int32 of one shape"):
        port_pair.het_pairs(m, s, r, r + 1, out)


@pytest.mark.parametrize("case", ["one individual", "haploid",
                                  "rows 0 and H - 1", "one window",
                                  "7 windows"])
def test_het_pairs_edges_match_jax(case):
    """K5's wrapper on the CPU (its plain version) == the JAX blocks_het
    gather, as float64, into a view of a larger output."""
    H, nwin = 9, 7
    rows = {"one individual": [(0, 1)], "haploid": [(4, 4)],
            "rows 0 and H - 1": [(0, H - 1), (H - 1, 0)],
            "one window": [(0, 1), (2, 3)],
            "7 windows": [(0, 1), (2, 3), (5, 5), (8, 6)]}[case]
    if case == "one window":
        nwin = 1
    m, s = _het_case(H, nwin)
    het_rows = np.array(rows, np.int32).T
    with jax.enable_x64():
        host = np.asarray(jax_pair._modes_tail(
            jnp.asarray(m), jnp.asarray(s), "blocks_het",
            jnp.ones((1, H), jnp.float32), jnp.int32(1), het_rows, nwin, H,
            False))
    want = host[:, 2:].reshape(nwin, len(rows), 2)
    flat = torch.full((nwin + 2, len(rows), 2), -1.0, dtype=torch.float64)
    port_pair.het_pairs(torch.from_numpy(m), torch.from_numpy(s),
                        torch.from_numpy(het_rows[0].copy()),
                        torch.from_numpy(het_rows[1].copy()), flat[2:])
    np.testing.assert_array_equal(flat[2:].numpy(), want)
    assert (flat[:2] == -1).all()


# ------------------------------------------------- the breakdown script

def test_k15_breakdown_needs_a_card_and_no_jax():
    """k15_breakdown.py (where K15's time goes, on one card) imports
    nothing of JAX and, without a CUDA card, exits non-zero having printed
    no result."""
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "OMP_NUM_THREADS": "1"}
    probe = ("import importlib, json, sys; importlib.import_module("
             "'k15_breakdown'); print(json.dumps(sorted(sys.modules)))")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = json.loads(r.stdout.strip().splitlines()[-1])
    assert "k15_breakdown" in mods
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "genomics_general_tpu")]
    r = subprocess.run([sys.executable, "k15_breakdown.py"],
                       capture_output=True, text=True,
                       env={**env, "CUDA_VISIBLE_DEVICES": ""}, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
