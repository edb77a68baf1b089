"""The port's wire-v2 pair route (GGT_WIRE=2; plain K13 on the CPU, then K2
and the K3/K4/K5 tails) against the JAX ``_fused_flush_pair_v2`` on the
same wire bytes in its tri, blocks and blocks_het modes: counts exactly,
float64 block sums at rtol 1e-12 (another summation order than XLA's
einsum); the copied packer gives the JAX bytes; and the popgen and distMat
goldens through the port's CLIs under GGT_WIRE=2."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer

from .test_torch_pairdist import _case, _dispatch_with, _ind_layout, \
    _pop_mask
from .test_torch_popgen_windows import GOLDENS, PORT
from .util import REPO, assert_csv_equal, assert_text_equal, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
CASES = ["disjoint", "overlap", "large_h", "long_window"]
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}


def _no_exceptions():
    a, first, n = _case("disjoint")
    return np.where(a > 1, 1, a).astype(np.int8), first, n


def _input(name):
    return _no_exceptions() if name == "no_exceptions" else _case(name)


def _jax_v2(a, first, n, mode, pop_mask=None, min_sites=0, het_rows=None):
    """The JAX wire-v2 flush on the CPU: (its output, the port's views of
    the same buffer)."""
    buf, Sp, H, wp, s_max, chunk, ep = jax_pair._v2_flush_args(a, first, n)
    mask = jax_pair._NO_POPS if pop_mask is None else pop_mask
    rows = None if het_rows is None else jax_pair._dev_i32(het_rows)
    with jax.enable_x64():
        out = jax_pair._fused_flush_pair_v2(
            jax.device_put(buf), jax_pair._dev_mask_f64(mask),
            jax_pair._dev_i32(min_sites), Sp, H, wp, s_max, chunk, ep, mode,
            het_rows=rows)
    return np.asarray(out), port_transfer.pair_wire_v2_views(buf, Sp, H, wp,
                                                              ep)


@pytest.mark.parametrize("name", CASES + ["no_exceptions"])
def test_pack_pair_wire_matches_jax_bytes(name):
    """The copied packer writes the JAX buffer, and the port's v2 flush
    args wrap exactly those bytes."""
    a, first, n = _input(name)
    wp = port_pair._next_pow2(first.shape[0], 8)
    got = port_transfer.pack_pair_wire(a, first, n, wp)
    want = jax_transfer.pack_pair_wire(a, first, n, wp)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])
    v2 = port_pair._v2_flush_args(a, first, n)
    np.testing.assert_array_equal(v2.buf, want[0])
    assert (v2.sp, v2.wp, v2.ep) == (want[1], wp, want[2])


@pytest.mark.parametrize("name", CASES)
def test_plain_unpack_matches_jax(name):
    a, first, n = _input(name)
    buf, Sp, H, wp, _, _, ep = jax_pair._v2_flush_args(a, first, n)
    wire = port_transfer.pair_wire_v2_views(buf, Sp, H, wp, ep)
    got = port_transfer.unpack_pair_wire(wire)
    want = jax_transfer.unpack_pair_wire(jax.device_put(buf), Sp, H, wp, ep)
    assert got[0].dtype == torch.int8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", CASES + ["no_exceptions"])
@pytest.mark.parametrize("chunk", [2, 8])
def test_plain_tri_matches_jax_v2(name, chunk):
    """K13 + K2 + K4 plain, chunk by chunk, == the JAX v2 "tri" output
    (compared as integers: the two pick uint16 by their own rules), and
    K13 + K2 == K1 + K2 on the wire-v3 buffer of the same flush."""
    a, first, n = _input(name)
    W, H = first.shape[0], a.shape[0]
    host, wire = _jax_v2(a, first, n, "tri")
    want_m, want_s = jax_pair._tri_unpack(host, W, H)
    v2 = port_pair._v2_flush_args(a, first, n)
    got = port_pair.flush_tri(wire, W, chunk, v2.u16).numpy()
    np.testing.assert_array_equal(got.astype(np.int64),
                                  host[:W].astype(np.int64))
    v3 = port_pair._v3_flush_args(a, first, n)
    wire3 = v3.wire(torch.from_numpy(v3.buf))
    for w0 in range(0, W, chunk):
        k = min(chunk, W - w0)
        m, s = port_pair.pair_counts_v2(wire, w0, k)
        port_pair.exception_patch(m, s, wire, w0)
        np.testing.assert_array_equal(m.numpy(), want_m[w0:w0 + k])
        np.testing.assert_array_equal(s.numpy(), want_s[w0:w0 + k])
        m3, s3 = port_pair.pair_counts_v3(wire3, w0, k)
        port_pair.exception_patch(m3, s3, wire3, w0)
        np.testing.assert_array_equal(m.numpy(), m3.numpy())
        np.testing.assert_array_equal(s.numpy(), s3.numpy())


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
@pytest.mark.parametrize("min_sites", [0, 150])
def test_plain_blocks_match_jax_v2(name, min_sites):
    """K13 + K2 + K3 plain == the JAX v2 "blocks" mode."""
    a, first, n = _input(name)
    W, H = first.shape[0], a.shape[0]
    mask = _pop_mask(H, 3, np.random.default_rng(2))
    host, wire = _jax_v2(a, first, n, "blocks", mask, min_sites)
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    got = port_pair.flush_blocks(wire, W, 2, groups, min_sites).numpy()
    np.testing.assert_array_equal(got[:, 1], host[:W, 1])
    np.testing.assert_allclose(got[:, 0], host[:W, 0], rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
@pytest.mark.parametrize("kind", ["pop_mask", "ind_mask"])
def test_plain_blocks_het_match_jax_v2(name, kind):
    """K13 + K2 + K3 + K5 plain == the JAX v2 "blocks_het" mode: blocks at
    rtol 1e-12, the own-pair counts exactly."""
    a, first, n = _input(name)
    W, H = first.shape[0], a.shape[0]
    ind_mask, het_rows = _ind_layout(H)
    mask = ind_mask if kind == "ind_mask" else \
        _pop_mask(H, 3, np.random.default_rng(4))
    host, wire = _jax_v2(a, first, n, "blocks_het", mask, 120, het_rows)
    P, n_ind = mask.shape[0], het_rows.shape[1]
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    rows = port_pair._het_rows(het_rows, H, torch.device("cpu"))
    flat = port_pair.flush_blocks_het(wire, W, 2, groups, rows, 120).numpy()
    blocks = flat[:W * 2 * P * P].reshape(W, 2, P, P)
    het = flat[W * 2 * P * P:].reshape(W, n_ind, 2)
    want_blocks = host[:W, :2 * P * P].reshape(W, 2, P, P)
    np.testing.assert_array_equal(blocks[:, 1], want_blocks[:, 1])
    np.testing.assert_allclose(blocks[:, 0], want_blocks[:, 0], rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_array_equal(
        het, host[:W, 2 * P * P:].reshape(W, n_ind, 2))


@pytest.fixture
def wire_v2(monkeypatch):
    for k, v in {**CPU, "GGT_WIRE": "2"}.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("name", ["disjoint", "overlap", "large_h"])
def test_dispatches_match_jax_v2(wire_v2, name):
    """The three fused dispatches under GGT_WIRE=2 on the CPU == the JAX
    dispatches under GGT_WIRE=2, with no kernel launch counted."""
    a, first, n = _input(name)
    H = a.shape[0]
    mask = _pop_mask(H, 2, np.random.default_rng(8))
    ind_mask, het_rows = _ind_layout(H)
    port_pair.reset_launches()
    for fn, args in (
            ("window_pair_counts_dispatch", (a, first, n)),
            ("window_pair_block_stats_dispatch", (a, first, n, mask, 40)),
            ("window_pair_ind_blocks_dispatch",
             (a, first, n, ind_mask, het_rows, 100))):
        want = _dispatch_with("tpu", getattr(jax_pair, fn), *args)
        got = _dispatch_with("tpu", getattr(port_pair, fn), *args)
        for g, w in zip(got, want):
            if g.dtype == np.float64 and fn != "window_pair_counts_dispatch":
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-15)
            else:
                np.testing.assert_array_equal(g, w)
    assert sum(port_pair.LAUNCHES.values()) == 0
    assert port_pair.HOST_FLUSHES == 0


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_popgen_golden_wire_v2(tmp_path, name):
    args, golden = GOLDENS[name]
    out = tmp_path / "o.csv"
    run_cli(PORT, args + ["--analysis", "popDist", "popPairDist",
                          "-o", str(out)],
            env_extra={**CPU, "GGT_WIRE": "2"})
    assert_csv_equal(G / golden, out)


def test_port_popgen_full_panel_wire_v2(tmp_path):
    """Every analysis under GGT_WIRE=2 (blocks_het and tri on wire v2):
    the popgen_coord.csv golden at tol 0."""
    out = tmp_path / "o.csv"
    run_cli(PORT, ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
                   "-w", "50000", "-s", "25000", "-m", "100",
                   "--minData", "0.3", "-p", "pop1", "-p", "pop2", "-p",
                   "pop3", "-p", "pop4", "--popsFile",
                   str(D / "sim1.pops.txt"), "--analysis", "popFreq",
                   "popDist", "popPairDist", "indPairDist", "indHet",
                   "hapStats", "--writeFailedWindows", "--addWindowID",
                   "-o", str(out)], env_extra={**CPU, "GGT_WIRE": "2"})
    assert_csv_equal(G / "popgen_coord.csv", out)


def test_port_distmat_golden_wire_v2(tmp_path):
    out, wdata = tmp_path / "o.phy", tmp_path / "w.tsv"
    run_cli("genomics_general_tpu_torch.cli.dist_mat",
            ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
             "-m", "50", "--outFormat", "phylip", "--windowDataOutFile",
             str(wdata), "-o", str(out)],
            env_extra={**CPU, "GGT_WIRE": "2"})
    assert_text_equal(G / "distmat_wind.phy", out)
    assert_text_equal(G / "distmat_wind.data.tsv", wdata)
