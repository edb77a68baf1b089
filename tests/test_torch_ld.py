"""The port's LD layer against the JAX package on the same numpy inputs:
the joint allele tables (K17's plain version on the CPU) exactly, the LD
matrices of every statistic on both ``use_device`` routes, ``ld_pair``,
``joint_tables`` and ``max_ld_phase`` bit for bit, and the built-in NJ
trees string-equal."""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import ld as jax_kld
from genomics_general_tpu.stats import ld as jax_ld
from genomics_general_tpu.stats import nj as jax_nj
from genomics_general_tpu_torch.kernels import _build
from genomics_general_tpu_torch.kernels import ld as port_kld
from genomics_general_tpu_torch.stats import ld as port_ld
from genomics_general_tpu_torch.stats import nj as port_nj


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def messy(H: int, S: int, seed: int, lo: int = -7, hi: int = 5):
    """Codes lo..hi (missing -1, other negatives and codes above 3 count in
    no table), with an all-missing and a monomorphic column."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, size=(H, S)).astype(np.int8)
    hit = rng.random((H, S))
    a[hit < 0.15] = -1
    odd = hit > 0.95
    a[odd] = rng.integers(lo, hi + 1, size=int(odd.sum()))
    a[:, S // 2] = -1
    a[:, S - 1] = 1
    return a


def assert_same_floats(got, want):
    """Bit for bit: equal values and equal NaN positions."""
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("S", [1, 33, 200])
@pytest.mark.parametrize("H", [8, 77])
def test_pair_allele_tables_match_jax(port_cpu, H, S):
    """pair_allele_tables on a tensor and on a row-strided view, and the
    host wrapper window_pair_tables, == the JAX tables exactly."""
    a = messy(H, S, H * S)
    want = np.asarray(jax_kld.pair_allele_tables(a))
    got = port_kld.pair_allele_tables(torch.from_numpy(a))
    assert got.dtype == torch.int32 and got.shape == (S, S, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    wide = torch.from_numpy(np.concatenate([a, a], axis=1))
    np.testing.assert_array_equal(
        port_kld.pair_allele_tables(wide[:, :S]).numpy(), want)
    host = port_kld.window_pair_tables(a)
    assert host.dtype == np.int32
    np.testing.assert_array_equal(host, want)


@pytest.mark.parametrize("use_device", [False, True])
@pytest.mark.parametrize("stat", ["D", "Dprime", "r", "r2"])
def test_ld_matrix_matches_jax(port_cpu, stat, use_device):
    """ld_matrix on both routes == the JAX ld_matrix on the same route,
    bit for bit (NaN positions equal), on codes -1..3 with missing calls,
    multi-allelic and monomorphic sites."""
    a = messy(14, 40, 11, lo=-1, hi=3)
    want = jax_ld.ld_matrix(a, stat, use_device=use_device)
    got = port_ld.ld_matrix(a, stat, use_device=use_device)
    assert_same_floats(got, want)
    assert_same_floats(got, port_ld.ld_matrix(a, stat,
                                              use_device=not use_device))


def test_ld_matrix_device_route_needs_the_card(monkeypatch):
    """Under GGT_DEVICE=cuda without a card the device route raises, naming
    GGT_DEVICE, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the device route runs")
    monkeypatch.setenv("GGT_DEVICE", "cuda")
    a = messy(6, 5, 1)
    for call in (lambda: port_ld.ld_matrix(a, "r2", use_device=True),
                 lambda: port_kld.window_pair_tables(a)):
        with pytest.raises(RuntimeError, match="GGT_DEVICE"):
            call()


def test_ld_pair_and_joint_tables_match_jax():
    """ld_pair on random pairs (with and without a given ancestral allele)
    and joint_tables of one column against many, as in JAX."""
    rng = np.random.default_rng(5)
    for _ in range(40):
        x = rng.choice([0, 1, 2, -1], size=30, p=[.4, .4, .1, .1])
        y = rng.choice([0, 3, -1], size=30, p=[.5, .4, .1])
        want = jax_ld.ld_pair(x, y)
        got = port_ld.ld_pair(x, y)
        assert want.keys() == got.keys()
        for k in want:
            assert_same_floats(np.float64(got[k]).reshape(1),
                               np.float64(want[k]).reshape(1))
    x = np.array([0, 1, 0, 1, -1, 1], np.int8)
    y = np.array([3, 3, 0, 0, 0, -1], np.int8)
    for anc in ((1, 0), (0, 3)):
        want, got = jax_ld.ld_pair(x, y, *anc), port_ld.ld_pair(x, y, *anc)
        for k in want:
            assert_same_floats(np.float64(got[k]).reshape(1),
                               np.float64(want[k]).reshape(1))
    a = messy(20, 30, 2, lo=-1, hi=3)
    got = port_ld.joint_tables(a[:, 1:], a[:, 0])
    want = jax_ld.joint_tables(a[:, 1:], a[:, 0])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("stat", ["r2", "D"])
def test_max_ld_phase_matches_jax(seed, stat):
    """The greedy LD pseudo-phasing re-phases alike, on diploid samples
    with missing calls and a haploid sample."""
    rng = np.random.default_rng(seed)
    H, S = 12, 25
    a = rng.choice([0, 1], size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    names = [f"i{k // 2}" for k in range(H - 1)] + ["haploid"]
    want = jax_ld.max_ld_phase(a, names, stat)
    got = port_ld.max_ld_phase(a, names, stat)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    names_u, idx = port_ld.unique_indices(names, preserve_order=True)
    names_j, idx_j = jax_ld.unique_indices(names, preserve_order=True)
    np.testing.assert_array_equal(names_u, names_j)
    assert all(np.array_equal(x, y) for x, y in zip(idx, idx_j))


@pytest.mark.parametrize("n", [1, 2, 4, 9])
def test_nj_matches_jax(n):
    """neighbor_joining (with NaN distances) and jukes_cantor (with
    saturated distances) give the JAX trees as strings."""
    rng = np.random.default_rng(n)
    d = rng.random((n, n)) * 0.9
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    if n > 2:
        d[0, 2] = d[2, 0] = np.nan
    names = [f"t{k}" for k in range(n)]
    for dist in (d, port_nj.jukes_cantor(d)):
        assert port_nj.neighbor_joining(dist, names) == \
            jax_nj.neighbor_joining(dist, names)
    assert_same_floats(port_nj.jukes_cantor(d), jax_nj.jukes_cantor(d))


def _c_params(src: str, fn: str) -> list:
    """The ctypes types of the parameters of ``int fn(...)`` in a CUDA
    source: pointers void*, long long, double, int."""
    m = re.search(r"\bint\s+" + fn + r"\s*\(([^)]*)\)", src)
    assert m, f"{fn} has no C definition"
    types = []
    for p in (p for p in m.group(1).split(",") if p.strip()):
        types.append(ctypes.c_void_p if "*" in p else ctypes.c_longlong
                     if "long long" in p else ctypes.c_double
                     if "double" in p else ctypes.c_int)
    return types


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signatures_match_c_sources(name):
    """Every bound entry point exists in its source with the parameter
    types of its ctypes signature (a mismatch would only show on the
    card), and every exported entry point of the source is bound."""
    src = (Path(_build.__file__).parent / "csrc" / f"{name}.cu").read_text()
    sigs = _build._SIGNATURES[name]
    for fn, argtypes in sigs.items():
        assert _c_params(src, fn) == argtypes, fn
    exported = set(re.findall(r"^int\s+(ggt_\w+)\s*\(", src, re.M))
    assert exported == set(sigs)


def test_kernel_build_raises_without_nvcc():
    """A kernel whose source cannot be built raises; nothing falls back."""
    try:
        _build.nvcc_path()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.lib("ld")
