"""The port's pair-count kernels (plain PyTorch versions on the CPU) against
the JAX wire-v3 flush on the same wire bytes, in each of its three modes
(blocks, blocks_het, tri): counts exactly, float64 block sums at rtol 1e-12
(another summation order than XLA's einsum)."""

import os

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer

from .test_pair_v2 import make_windows, messy_alleles


def _large_h(rng):
    """H=160 cohort with one exception site (test_pair_v3.py:180)."""
    H, S = 160, 1500
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.08] = -1
    a[rng.integers(0, H, 5), 700] = 2
    first = np.array([0, 400, 900], np.int32)
    n = np.array([500, 500, 600], np.int32)
    return a, first, n


def _long_window(rng):
    """One window of more than 2^16 sites: the tri output is int32."""
    H, S = 5, 70000
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.05] = -1
    a[rng.integers(0, H, 40), rng.integers(0, S, 40)] = 3
    first = np.array([0, 1000], np.int32)
    n = np.array([66000, 5000], np.int32)
    return a, first, n


def _case(name):
    rng = np.random.default_rng(21)
    if name == "large_h":
        return _large_h(rng)
    if name == "long_window":
        return _long_window(rng)
    a = messy_alleles(rng, H=13, S=1000)
    first, n = make_windows(a.shape[1], rng, overlap=(name == "overlap"))
    return a, first, n


def _jax_flush(a, first, n, mode, pop_mask=None, min_sites=0,
               het_rows=None):
    buf, SpB, SpC, SpD, H, wp, sb, sc, sd, chunk, ep, u16 = \
        jax_pair._v3_flush_args(a, first, n)
    mask = jax_pair._NO_POPS if pop_mask is None else pop_mask
    rows = None if het_rows is None else jax_pair._dev_i32(het_rows)
    with jax.enable_x64():
        out = jax_pair._fused_flush_pair_v3(
            jax.device_put(buf), jax_pair._dev_mask_f64(mask),
            jax_pair._dev_i32(min_sites), SpB, SpC, SpD, H, wp, sb, sc, sd,
            chunk, ep, mode, u16, het_rows=rows)
    wire = port_transfer.from_jax_wire(buf, SpB, SpC, SpD, H, wp, ep)
    return np.asarray(out), wire


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
@pytest.mark.parametrize("chunk", [2, 8])
def test_plain_counts_match_jax_tri(name, chunk):
    """K1 + K2 plain, chunk by chunk, == the JAX "tri" counts."""
    a, first, n = _case(name)
    W, H = first.shape[0], a.shape[0]
    host, wire = _jax_flush(a, first, n, "tri")
    want_m, want_s = jax_pair._tri_unpack(host, W, H)
    for w0 in range(0, W, chunk):
        k = min(chunk, W - w0)
        m, s = port_pair.pair_counts_v3(wire, w0, k)
        port_pair.exception_patch(m, s, wire, w0)
        np.testing.assert_array_equal(m.numpy(), want_m[w0:w0 + k])
        np.testing.assert_array_equal(s.numpy(), want_s[w0:w0 + k])


def _pop_mask(H, P, rng):
    groups = rng.permutation(np.arange(H) % P)
    mask = np.zeros((P, H))
    mask[groups, np.arange(H)] = 1.0
    return mask


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
@pytest.mark.parametrize("min_sites", [0, 150])
def test_plain_blocks_match_jax_blocks(name, min_sites):
    """K1 + K2 + K3 plain == the JAX "blocks" mode."""
    a, first, n = _case(name)
    W, H = first.shape[0], a.shape[0]
    mask = _pop_mask(H, 3, np.random.default_rng(2))
    host, wire = _jax_flush(a, first, n, "blocks", mask, min_sites)
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    got = port_pair.flush_blocks(wire, W, 2, groups, min_sites).numpy()
    np.testing.assert_array_equal(got[:, 1], host[:W, 1])
    np.testing.assert_allclose(got[:, 0], host[:W, 0], rtol=1e-12,
                               atol=1e-15)


def test_blocks_tail_rejects_overlapping_groups():
    mask = np.array([[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]])
    with pytest.raises(ValueError):
        port_pair.PopGroups(mask, torch.device("cpu"))


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _dispatch_with(exec_, fn, *args):
    """``fn(*args).collect()`` under GGT_EXEC=exec_."""
    old = os.environ.get("GGT_EXEC")
    os.environ["GGT_EXEC"] = exec_
    try:
        return fn(*args).collect()
    finally:
        os.environ["GGT_EXEC"] = old or "tpu"


def _dispatch(mod, a, first, n, mask, min_sites, exec_):
    return _dispatch_with(exec_, mod.window_pair_block_stats_dispatch, a,
                          first, n, mask, min_sites)


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
def test_dispatch_matches_jax_and_host(port_cpu, name):
    """The whole flush: port dispatch on the CPU == the JAX dispatch on its
    jit path == the port's own host C executor."""
    a, first, n = _case(name)
    mask = _pop_mask(a.shape[0], 2, np.random.default_rng(8))
    s_jax, c_jax = _dispatch(jax_pair, a, first, n, mask, 40, "tpu")
    s_k, c_k = _dispatch(port_pair, a, first, n, mask, 40, "tpu")
    s_h, c_h = _dispatch(port_pair, a, first, n, mask, 40, "host")
    np.testing.assert_array_equal(c_k, c_jax)
    np.testing.assert_array_equal(c_h, c_jax)
    np.testing.assert_allclose(s_k, s_jax, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(s_h, s_jax, rtol=1e-12, atol=1e-15)


def test_dispatch_counts_no_launch_on_cpu(port_cpu):
    """CPU tensors take the plain versions: no kernel launch is counted,
    and the host executor counts its flushes separately."""
    a, first, n = _case("disjoint")
    mask = _pop_mask(a.shape[0], 2, np.random.default_rng(9))
    port_pair.reset_launches()
    _dispatch(port_pair, a, first, n, mask, 0, "tpu")
    assert sum(port_pair.LAUNCHES.values()) == 0
    assert port_pair.HOST_FLUSHES == 0
    _dispatch(port_pair, a, first, n, mask, 0, "host")
    assert port_pair.HOST_FLUSHES == 1


def test_wire_v2_not_ported(port_cpu, monkeypatch):
    """GGT_WIRE=2 runs the blocks route on wire v2 (K13): the v3 route's
    sums and counts (tests/test_torch_pair_v2.py holds it against JAX)."""
    a, first, n = _case("disjoint")
    mask = np.ones((1, a.shape[0]))
    want = _dispatch(port_pair, a, first, n, mask, 0, "tpu")
    monkeypatch.setenv("GGT_WIRE", "2")
    got = _dispatch(port_pair, a, first, n, mask, 0, "tpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h",
                                  "long_window"])
def test_plain_tri_matches_jax_tri(name):
    """K1 + K2 + K4 plain == the JAX "tri" output in value and dtype:
    uint16 while every window has fewer than 2^16 sites, else int32."""
    a, first, n = _case(name)
    W = first.shape[0]
    host, _ = _jax_flush(a, first, n, "tri")
    v3 = port_pair._v3_flush_args(a, first, n)
    assert v3.u16 == (host.dtype == np.uint16)
    assert v3.u16 == (name != "long_window")
    wire = v3.wire(torch.from_numpy(v3.buf))
    got = port_pair.flush_tri(wire, W, 2, v3.u16)
    assert got.numpy().dtype == host.dtype
    np.testing.assert_array_equal(got.numpy(), host[:W])
    m, s = port_pair.pair_counts_v3(wire, 0, W)
    port_pair.exception_patch(m, s, wire, 0)
    plain = port_pair.tri_pack_plain(m, s, v3.u16)
    np.testing.assert_array_equal(plain.numpy(), host[:W])
    um, us = port_pair._tri_unpack(plain.numpy(), W, a.shape[0])
    np.testing.assert_array_equal(um, m.numpy())
    np.testing.assert_array_equal(us, s.numpy())


def _ind_layout(H):
    """Individuals over H rows: row 0 haploid, then diploid pairs, and a
    trailing haploid row when one is left.  Returns (ind_mask [I, H],
    het_rows int32 [2, I]) as popgenWindows builds them (r1 == r2 == 0
    for the haploids)."""
    inds = [[0]] + [[r, r + 1] for r in range(1, H - 1, 2)]
    if sum(map(len, inds)) < H:
        inds.append([H - 1])
    mask = np.zeros((len(inds), H))
    rows = np.zeros((2, len(inds)), np.int32)
    for k, r in enumerate(inds):
        mask[k, r] = 1.0
        if len(r) == 2:
            rows[:, k] = r
    return mask, rows


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
@pytest.mark.parametrize("kind", ["pop_mask", "ind_mask"])
def test_plain_blocks_het_match_jax(name, kind):
    """K1 + K2 + K3 + K5 plain == the JAX "blocks_het" mode: blocks at
    rtol 1e-12, the own-pair counts exactly."""
    a, first, n = _case(name)
    W, H = first.shape[0], a.shape[0]
    ind_mask, het_rows = _ind_layout(H)
    mask = ind_mask if kind == "ind_mask" else \
        _pop_mask(H, 3, np.random.default_rng(4))
    host, wire = _jax_flush(a, first, n, "blocks_het", mask, 120, het_rows)
    P, n_ind = mask.shape[0], het_rows.shape[1]
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    rows = port_pair._het_rows(het_rows, H, torch.device("cpu"))
    flat = port_pair.flush_blocks_het(wire, W, 2, groups, rows, 120).numpy()
    blocks = flat[:W * 2 * P * P].reshape(W, 2, P, P)
    het = flat[W * 2 * P * P:].reshape(W, n_ind, 2)
    want_blocks = host[:W, :2 * P * P].reshape(W, 2, P, P)
    want_het = host[:W, 2 * P * P:].reshape(W, n_ind, 2)
    np.testing.assert_array_equal(blocks[:, 1], want_blocks[:, 1])
    np.testing.assert_allclose(blocks[:, 0], want_blocks[:, 0], rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(het, want_het)
    m, s = port_pair.pair_counts_v3(wire, 0, W)
    port_pair.exception_patch(m, s, wire, 0)
    plain = port_pair.het_pairs_plain(m, s, *rows)
    assert plain.dtype == torch.float64
    np.testing.assert_array_equal(plain.numpy(), want_het)


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
def test_counts_dispatch_matches_jax_and_host(port_cpu, name):
    """The tri route end to end: port window_pair_counts_dispatch on the
    CPU == the JAX dispatch (its v3 tri path) == the port's host executor,
    as int32 [W, H, H] in window order."""
    a, first, n = _case(name)
    want = _dispatch_with("tpu", jax_pair.window_pair_counts_dispatch, a,
                          first, n)
    port_pair.reset_launches()
    got = _dispatch_with("tpu", port_pair.window_pair_counts_dispatch, a,
                         first, n)
    assert port_pair.HOST_FLUSHES == 0
    host = _dispatch_with("host", port_pair.window_pair_counts_dispatch, a,
                          first, n)
    assert port_pair.HOST_FLUSHES == 1
    for g in (got, host):
        for x, y in zip(g, want):
            assert x.dtype == np.int32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
@pytest.mark.parametrize("kind", ["pop_mask", "ind_mask"])
def test_ind_blocks_dispatch_matches_jax_and_host(port_cpu, name, kind):
    """The blocks_het route end to end, with ms_gate 0 and 100: port
    dispatch on the CPU == the JAX dispatch == the port's host executor."""
    a, first, n = _case(name)
    H = a.shape[0]
    ind_mask, het_rows = _ind_layout(H)
    mask = ind_mask if kind == "ind_mask" else \
        _pop_mask(H, 2, np.random.default_rng(6))
    for gate in (0, 100):
        args = (a, first, n, mask, het_rows, gate)
        want = _dispatch_with("tpu", jax_pair.window_pair_ind_blocks_dispatch,
                              *args)
        got = _dispatch_with("tpu", port_pair.window_pair_ind_blocks_dispatch,
                             *args)
        host = _dispatch_with("host",
                              port_pair.window_pair_ind_blocks_dispatch,
                              *args)
        for g in (got, host):
            np.testing.assert_allclose(g[0], want[0], rtol=1e-12, atol=1e-15)
            np.testing.assert_array_equal(g[1], want[1])
            for x, y in zip(g[2:], want[2:]):
                assert x.dtype == np.int64
                np.testing.assert_array_equal(x, y)


def test_pair_counts_unported_routes_raise(port_cpu, monkeypatch):
    """The wire-v2 tri route (GGT_WIRE=2) gives the v3 route's integers;
    the device-array span and the raw upload run the general 4-state counts
    (tests/test_torch_pair4.py)."""
    a, first, n = _case("disjoint")
    want = port_pair.window_pair_counts(a, first, n)
    monkeypatch.setenv("GGT_WIRE", "2")
    for g, w in zip(port_pair.window_pair_counts(a, first, n), want):
        np.testing.assert_array_equal(g, w)


def test_het_rows_refuse_out_of_range():
    with pytest.raises(ValueError):
        port_pair._het_rows(np.array([[0, 5], [1, 2]]), 5, torch.device("cpu"))
