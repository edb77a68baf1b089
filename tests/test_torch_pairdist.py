"""The port's pair-count kernels (plain PyTorch versions on the CPU) against
the JAX wire-v3 flush on the same wire bytes: counts exactly, float64
block sums at rtol 1e-12 (another summation order than XLA's einsum)."""

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


def _case(name):
    rng = np.random.default_rng(21)
    if name == "large_h":
        return _large_h(rng)
    a = messy_alleles(rng, H=13, S=1000)
    first, n = make_windows(a.shape[1], rng, overlap=(name == "overlap"))
    return a, first, n


def _jax_flush(a, first, n, mode, pop_mask=None, min_sites=0):
    buf, SpB, SpC, SpD, H, wp, sb, sc, sd, chunk, ep, u16 = \
        jax_pair._v3_flush_args(a, first, n)
    mask = jax_pair._NO_POPS if pop_mask is None else pop_mask
    with jax.enable_x64():
        out = jax_pair._fused_flush_pair_v3(
            jax.device_put(buf), jax_pair._dev_mask_f64(mask),
            jax_pair._dev_i32(min_sites), SpB, SpC, SpD, H, wp, sb, sc, sd,
            chunk, ep, mode, u16)
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


def _dispatch(mod, a, first, n, mask, min_sites, exec_):
    old = os.environ.get("GGT_EXEC")
    os.environ["GGT_EXEC"] = exec_
    try:
        return mod.window_pair_block_stats_dispatch(
            a, first, n, mask, min_sites).collect()
    finally:
        os.environ["GGT_EXEC"] = old or "tpu"


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
    a, first, n = _case("disjoint")
    monkeypatch.setenv("GGT_WIRE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _dispatch(port_pair, a, first, n, np.ones((1, a.shape[0])), 0, "tpu")
