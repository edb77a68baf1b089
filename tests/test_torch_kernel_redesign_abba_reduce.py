"""K7 (abba_site_terms), K16 (stacked_reduce) and the kernels' launch path
as redesigned for the card, held on the CPU against the JAX package.

* K7: a numpy model of the kernel's schedule (integer gate and selection,
  at most two selected alleles a site in ascending order, slot 0's terms
  then slot 1's added to the site's row, zero rows for failed sites, the
  tile's rows stored from shared memory as 16-byte units) against the
  port's plain version, bit for bit with NaN positions equal, and both
  against the JAX ``_site_terms`` on the same numpy counts.
* K16: the plain version against the JAX ``mesh_reduce_stacked`` on a
  one-device CPU mesh.
* The launch path: no kernel library is built or loaded at import or on a
  CPU call, and the current stream's handle is read on every launch.

Tolerances: every comparison is exact unless its test says otherwise.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from genomics_general_tpu.kernels import abba as jax_abba
from genomics_general_tpu.parallel import multihost as jax_multihost
from genomics_general_tpu_torch.kernels import _build
from genomics_general_tpu_torch.kernels import abba as port_abba
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import pairdist as port_pairdist
from tests.test_torch_abba import _alleles, _mask, _port_site_terms

REPO = Path(__file__).resolve().parent.parent
MODES = ["polarize", "fixed", "minor"]
K7_TILE = 128                      # abba.cu kTile: sites a block
# classes P1, P2, P3 (each in the union), O outside the union, O in it,
# and P1 + P2: outgroup classes outside the union let polarize and fixed
# select two alleles a site
CODES = np.array([1 | 16, 2 | 16, 4 | 16, 8, 8 | 16, 3 | 16], np.int32)
N_POPS = (20, 20, 20, 20)


def _counts(S=3001, seed=5):
    """int64 [S, 6, 4] counts on CODES' classes: the union's classes
    count two alleles x < y of the site (each kept at 90 %), the others
    any allele; 40 % of counts zero, the rest 1..9; every 7th site has no
    outgroup call, so its outgroup frequencies are NaN; and the fixed
    sites of :func:`_fixed_sites`."""
    rng = np.random.default_rng(seed)
    C = CODES.size
    union = (CODES >> 4) & 1
    xy = np.sort(np.argsort(rng.random((S, 4)), axis=1)[:, :2], axis=1)
    allowed = np.zeros((S, C, 4), bool)
    allowed[:, union == 0, :] = True
    keep = rng.random((S, 2)) < 0.9
    for j in range(2):
        allowed[np.arange(S)[keep[:, j]], :, xy[keep[:, j], j]] |= \
            union[None, :] == 1
    c = rng.integers(1, 10, size=(S, C, 4)) * (rng.random((S, C, 4)) > 0.4)
    c = np.where(allowed, c, 0)
    c[::7, ((CODES >> 3) & 1) == 1, :] = 0
    _fixed_sites(c, CODES, xy, rng)
    return c


def _fixed_sites(c, codes, xy, rng):
    """Every 11th site from the 3rd: P1's and P3's own classes fixed for
    x, P2's for y, the outgroup outside the union fixed for a third
    allele, every other class empty: polarize and fixed both select x and
    y there."""
    sites = np.arange(3, c.shape[0], 11)
    z = np.array([min(set(range(4)) - set(p)) for p in xy[sites]],
                 np.int64)
    c[sites] = 0
    for k, code in enumerate(codes):
        allele = {1 | 16: xy[sites, 0], 2 | 16: xy[sites, 1],
                  4 | 16: xy[sites, 0], 8: z}.get(int(code))
        if allele is not None:
            c[sites, k, allele] = rng.integers(1, 10, size=sites.size)


def _max_np(a, b):
    return np.where((a >= b) | (a != a), a, b)


def _f4(p1, p2, p3, p4):
    return (1 - p1) * p2 * p3 * (1 - p4) - p1 * (1 - p2) * p3 * (1 - p4)


def _f4c(p1, p2, p3, p4):
    return _f4(p1, p2, p3, p4) + _f4(1 - p1, 1 - p2, 1 - p3, 1 - p4)


def _allele_terms(p1, p2, p3, p4, full, select=False):
    """abba.cu ``allele_terms``, expression for expression in float64: a
    boolean factor multiplies by 1.0 or 0.0 (numpy's NaN * 0 is NaN), or
    under ``select`` picks the value or 0.0, as XLA computes the JAX
    package's ``x * (condition)``."""
    def times(v, cond):
        return np.where(cond, v, 0.0) if select else v * cond.astype(float)
    q1, q2, q3, q4 = 1 - p1, 1 - p2, 1 - p3, 1 - p4
    abba = q1 * p2 * p3 * q4
    baba = p1 * q2 * p3 * q4
    pd = times(p2, p2 > p3) + times(p3, p3 >= p2)
    a, b, x = p3 > p1, p3 > p2, p1 > p2
    y = ~x
    pdm1 = times(p3, x & a) + times(p1, ~(x & a))
    pdm2 = times(p3, y & b) + times(p2, ~(y & b))
    pdm3 = times(-p3, x & a) + times(p3, y & b) - times(p1, x & ~a) \
        + times(p2, y & ~b)
    t = [abba - baba, abba + baba, _f4(p1, pd, pd, p4),
         _f4(pdm1, pdm2, pdm3, p4), abba, baba]
    if full:
        fdh = _max_np(_max_np(_f4c(p1, p3, p3, p4), _f4c(p4, p2, p3, p4)),
                      _max_np(_f4c(p3, p2, p3, p4), _f4c(p1, p4, p3, p4)))
        fdh2 = _max_np(fdh, _max_np(
            _max_np(_f4c(p1, p2, p2, p4), _f4c(p1, p2, p3, p1)),
            _max_np(_f4c(p1, p2, p1, p4), _f4c(p1, p2, p3, p2))))
        d1, d2 = np.abs(p1 - p2), np.abs(p3 - p4)
        dh = times(d1, d1 > d2) + times(d2, d2 >= d1)
        t += [_f4c(p1, p2, p3, p4), _f4(p1, p3, p3, p4),
              _f4c(p1, p3, p3, p4), _f4c(p1, pd, pd, p4),
              _f4c(pdm1, pdm2, pdm3, p4), fdh, fdh2, dh * dh,
              q1 * p2 * q3 * q4, p1 * q2 * q3 * q4]
    return np.stack(t, axis=1)


def _selection(c, nm, mode):
    """abba.cu's selection on the integer counts: bit a of each site's
    word is allele a selected (before the gate)."""
    if mode == "minor":
        key = np.zeros(c.shape[0], np.int64)
        for k, (i, j) in enumerate(((0, 1), (0, 2), (0, 3), (1, 2), (1, 3),
                                    (2, 3))):
            u, v = c[:, 4, i], c[:, 4, j]
            key += np.where(u < v, 0, np.where(u == v, 1, 2)) * 3 ** k
        return 1 << port_abba._ARGSORT2_LUT[key].astype(np.int64)
    on = (c[:, 4] > 0) & (c[:, 3] == 0) & (nm[:, 3:4] > 0)
    if mode == "fixed":
        for p in range(3):
            on &= (nm[:, p:p + 1] > 0) & ((c[:, p] == 0)
                                         | (c[:, p] == nm[:, p:p + 1]))
    return (on * (1 << np.arange(4))).sum(axis=1)


def _k7_rows(counts, codes, n_pops, min_data, mode, full, select=False):
    """The kernel's rows of one site a thread: the gate (one float64
    division a population), the selection, then at most two passes of
    the terms, slot 0 on every site with an allele and slot 1 on sites
    with two, each pass's terms written (slot 0) or added (slot 1) to the
    site's row (``select``: as :func:`_allele_terms`)."""
    K = len(port_abba.channels_of(full))
    bits = (codes[:, None].astype(np.int64) >> np.arange(5)) & 1
    c = np.einsum("sca,cp->spa", counts.astype(np.int64), bits)
    nm = c.sum(axis=2)
    good = (c[:, 4] > 0).sum(axis=1) == 2
    for p in range(4):
        good &= nm[:, p] / float(n_pops[p]) >= min_data
    sel = np.where(good, _selection(c, nm, mode), 0)
    used = np.array([bin(int(w)).count("1") for w in sel])
    assert used.max(initial=0) <= 2
    low = sel & -sel
    slots = [np.log2(np.maximum(low, 1)).astype(np.int64),
             np.log2(np.maximum(sel ^ low, 1)).astype(np.int64)]
    rows = np.zeros((c.shape[0], K))
    rows[:, 0] = good
    rows[:, 1] = used
    for j in (0, 1):
        lane = np.flatnonzero(used > j)
        a = slots[j][lane]
        with np.errstate(invalid="ignore", divide="ignore"):
            p = c[lane, :4, a] / nm[lane, :4]
        t = _allele_terms(*p.T, full, select)
        rows[lane, 2:] = t if j == 0 else rows[lane, 2:] + t
    return rows, used


def _tile_store(rows):
    """The tiles' rows as the kernel stores them: a tile's rows in shared
    memory at a stride of K + 1 doubles, then 16-byte units u of the
    tile's run of out (row 2u // K, column 2u % K and the next).  Every
    output cell must be written exactly once."""
    S, K = rows.shape
    out = np.zeros(S * K)
    writes = np.zeros(S * K, np.int64)
    for s0 in range(0, S, K7_TILE):
        ns = min(K7_TILE, S - s0)
        smem = np.zeros(K7_TILE * (K + 1))
        for t in range(ns):
            smem[t * (K + 1):t * (K + 1) + K] = rows[s0 + t]
        u = np.arange(ns * K // 2)
        r, k = 2 * u // K, 2 * u % K
        for half in (0, 1):
            cell = s0 * K + 2 * u + half
            out[cell] = smem[r * (K + 1) + k + half]
            np.add.at(writes, cell, 1)
    assert (writes == 1).all()
    return out.reshape(S, K)


def _bits_equal(got, want):
    """Bit for bit where not NaN, NaN positions equal."""
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.uint64),
                                  want[~nan].view(np.uint64))


def _jax_site_terms(counts, codes, n_pops, min_data, mode, full):
    """The JAX ``_site_terms`` on the same counts (float64 frequencies)."""
    bits = (codes[:, None].astype(np.int64) >> np.arange(5)) & 1
    c = np.einsum("sca,cp->spa", counts.astype(np.int64), bits).astype(
        np.float64)
    nonmiss = c.sum(axis=2)
    with np.errstate(invalid="ignore"):
        freqs = c / nonmiss[:, :, None]
    with jax.enable_x64(True):
        return np.asarray(jax_abba._site_terms(
            jnp.asarray(freqs[:, :4]), jnp.asarray(freqs[:, 4]),
            jnp.asarray(nonmiss), n_pops, min_data, mode, full))


def _against_jax(rows, counts, codes, n_pops, min_data, mode, full):
    """The JAX ``_site_terms`` equals the schedule computed with XLA's
    select for a boolean factor, exactly with NaN positions equal; that
    schedule equals numpy's wherever numpy's is not NaN.  (The two differ
    only where a NaN frequency of an empty population meets a boolean
    factor: ROADMAP queue 3 records it for den_fh.)"""
    sel_rows, _ = _k7_rows(counts, codes, n_pops, min_data, mode, full,
                           select=True)
    want = _jax_site_terms(counts, codes, n_pops, min_data, mode, full)
    np.testing.assert_array_equal(np.isnan(sel_rows), np.isnan(want))
    np.testing.assert_array_equal(sel_rows, want)
    ok = ~np.isnan(rows)
    np.testing.assert_array_equal(rows[ok], sel_rows[ok])
    return int((np.isnan(rows) & ~np.isnan(want)).sum())


K7_CASES = [(m, f, d, dt) for m in MODES for f in (False, True)
            for d in (0.3, 0.0) for dt in (np.uint16, np.int32)]
K7_IDS = [f"{m}-{'full' if f else 'classic'}-md{d}-{np.dtype(dt).name}"
          for m, f, d, dt in K7_CASES]


@pytest.mark.parametrize("mode,full,min_data,dtype", K7_CASES, ids=K7_IDS)
def test_k7_schedule_matches_plain_and_jax(mode, full, min_data, dtype):
    """The two-slot schedule equals the plain version bit for bit (NaN
    positions equal) and the JAX ``_site_terms`` exactly, on counts with
    0, 1 and 2 selected alleles a site and NaN outgroup frequencies."""
    counts = _counts().astype(dtype)
    rows, used = _k7_rows(counts, CODES, N_POPS, min_data, mode, full)
    plain = port_abba.abba_site_terms(
        torch.from_numpy(counts), torch.from_numpy(CODES), N_POPS, min_data,
        mode, full).numpy()
    _bits_equal(rows, plain)
    _bits_equal(_tile_store(rows), plain)
    folded = _against_jax(rows, counts, CODES, N_POPS, min_data, mode,
                          full)
    found = set(np.unique(used).tolist())
    assert found == ({0, 1} if mode == "minor" else {0, 1, 2})
    assert (rows[:, 0] == 0).any() and (rows[:, 0] == 1).any()
    assert (rows[rows[:, 0] == 0] == 0).all()          # failed: zero rows
    if min_data == 0.0 and mode != "fixed":   # fixed needs every pop called
        assert np.isnan(rows).any() and folded > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["disjoint", "overlap"])
def test_k7_schedule_on_cli_masks(mode, layout):
    """On the ABBA CLIs' masks (the union covers the outgroup, so at most
    one allele a site), K6's class counts through the schedule equal the
    plain version bit for bit, both panels, minData 0."""
    al = _alleles()
    mask, n_pops = _mask(layout)
    classes = port_counts.MaskClasses(mask, torch.device("cpu"))
    buf, sp = port_counts.transfer.pack_span(al)
    cc = port_counts.count_span(torch.from_numpy(buf), sp, al.shape[0],
                                al.shape[1], classes.groups).numpy()
    codes = classes.codes.numpy()
    for full in (False, True):
        rows, used = _k7_rows(cc, codes, n_pops, 0.0, mode, full)
        assert used.max() == 1
        _bits_equal(rows, _port_site_terms(al, mask, n_pops, 0.0, mode,
                                           full))


@pytest.mark.parametrize("S", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("full", [False, True])
def test_k7_tile_store_writes_every_cell_once(S, full):
    """The 16-byte store of tiles cut short writes each output cell once,
    with the value of its row and column."""
    K = len(port_abba.channels_of(full))
    rows = np.random.default_rng(S).random((S, K))
    _bits_equal(_tile_store(rows), rows)


K16_CASES = [(op, dt, k) for op in ("sum", "min")
             for dt in (np.int32, np.int64) for k in (1, 2, 3, 4)]


@pytest.mark.parametrize("op,dtype,k", K16_CASES,
                         ids=[f"{o}-{np.dtype(d).name}-k{k}"
                              for o, d, k in K16_CASES])
def test_k16_plain_matches_jax(op, dtype, k):
    """stacked_reduce_plain equals the JAX ``mesh_reduce_stacked`` on a
    one-device CPU mesh over an odd n (1,001 columns), with int32 sums
    wrapping past 2^31 and int64 values beyond 2^31.  JAX widens an int32
    sum to int64; the port keeps int32 and wraps, so its sum equals JAX's
    modulo 2^32."""
    rng = np.random.default_rng(k)
    lim = (1 << 31) - 1 if dtype == np.int32 else 1 << 40
    x = rng.integers(-lim, lim, size=(k, 1001), endpoint=True).astype(dtype)
    x[:, 0] = np.iinfo(dtype).max - np.arange(k)        # wraps when k > 1
    got = port_counts.stacked_reduce(torch.from_numpy(x), op).numpy()
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("x",))
    want = jax_multihost.mesh_reduce_stacked(x, mesh, op)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want.astype(dtype))
    if op == "sum" and dtype == np.int32 and k > 1:
        assert want[0] > np.iinfo(np.int32).max           # it wrapped


def test_no_kernel_builds_at_import_or_on_a_cpu_call():
    """In a fresh process with ``_build.build`` and ``ctypes.CDLL``
    refusing, importing every kernel module and the CLIs and running
    wrappers on CPU tensors resolves none of the 20 entry points and
    loads no library."""
    code = """
import ctypes, sys
import numpy as np, torch
from genomics_general_tpu_torch.kernels import _build
def refuse(*a, **k):
    raise AssertionError("a kernel library was built or loaded")
_build.build = refuse
ctypes.CDLL = refuse
from genomics_general_tpu_torch.kernels import (abba, counts, ld, pairdist,
                                                window_stats)
from genomics_general_tpu_torch.cli import abba_windows, popgen_windows
mods = (abba, counts, ld, pairdist, window_stats)
entries = [v for m in mods for v in vars(m).values()
           if isinstance(v, _build.Entry)]
x = torch.arange(12, dtype=torch.int32).view(3, 4)
counts.stacked_reduce(x, "sum")
c = torch.ones((5, 4, 4), dtype=torch.int32)
abba.abba_site_terms(c, torch.tensor([17, 18, 20, 24], dtype=torch.int32),
                     (4, 4, 4, 4), 0.0, "minor", True)
assert len(entries) == 20, len(entries)
assert all(e.fn is None for e in entries)
assert not _build._libs
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "GGT_DEVICE": "cpu",
                            "PYTHONPATH": str(REPO)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on the card, so a wrapper takes its
    launch path (its launcher replaced by a recorder)."""

    @property
    def is_cuda(self):
        return True


def _fake_launches(monkeypatch, entry: str):
    """Replace the current-stream getter with one returning a new handle
    each call and ``entry`` with a recorder; returns (handles handed out,
    (device index asked, stream received) per launch)."""
    handed, seen = [], []

    def raw_stream(index):
        handed.append(1000 + len(handed))
        seen.append([index])
        return handed[-1]

    def launcher(*args):
        seen[-1].append(args[-1])

    monkeypatch.setattr(port_pairdist, "_raw_stream", raw_stream)
    module = port_abba if "abba" in entry else port_counts
    monkeypatch.setattr(module, entry, launcher)
    return handed, seen


@pytest.mark.parametrize("kernel", ["stacked_reduce", "abba_site_terms"])
def test_stream_handle_read_on_every_launch(kernel, monkeypatch):
    """Two launches in a row read the current stream twice, and each
    launch receives the handle read for it (a handle kept from an earlier
    call would escape a CUDA graph's capture stream); the launch counter
    counts both."""
    module = port_counts if kernel == "stacked_reduce" else port_abba
    monkeypatch.setitem(module.LAUNCHES, kernel, 0)
    handed, seen = _fake_launches(monkeypatch, f"_ggt_{kernel}")
    for _ in range(2):
        if kernel == "stacked_reduce":
            x = torch.arange(10, dtype=torch.int32).view(2, 5)
            port_counts.stacked_reduce(x.as_subclass(_FakeCuda), "sum")
        else:
            c = torch.ones((3, 4, 4), dtype=torch.int32)
            codes = torch.tensor([17, 18, 20, 24], dtype=torch.int32)
            port_abba.abba_site_terms(c.as_subclass(_FakeCuda),
                                      codes.as_subclass(_FakeCuda),
                                      (4, 4, 4, 4), 0.0, "minor", False)
    assert handed == [1000, 1001]
    assert seen == [[-1, 1000], [-1, 1001]]     # CPU tensors: index -1
    assert module.LAUNCHES[kernel] == 2


def test_entry_raises_on_a_launch_error(monkeypatch):
    """A non-zero CUDA error code from a launch raises, naming the
    kernel; a zero code returns."""
    entry = _build.Entry("counts", "ggt_stacked_reduce")
    entry.fn = lambda *args: 0
    entry(1, 2)
    entry.fn = lambda *args: 700
    with pytest.raises(RuntimeError, match="stacked_reduce.*700"):
        entry(1, 2)
    with pytest.raises(KeyError):
        _build.Entry("counts", "ggt_no_such_kernel")
