"""The port's per-site count path (kernels/counts.py, plain PyTorch K6 on the
CPU) against the JAX package on the same span-wire bytes: counts exactly,
for messy inputs and 1, 5 and 9 groups; and the copied span packers give
the JAX bytes."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import counts as jax_counts
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer

from .test_pair_v2 import messy_alleles


def _alleles(name):
    """Messy spans: S not a multiple of 8, all-missing and all-called
    columns, all four codes."""
    rng = np.random.default_rng(31)
    if name == "s_mod8":
        a = messy_alleles(rng, H=23, S=1003)
    elif name == "columns":
        a = messy_alleles(rng, H=17, S=517)
        a[:, 10:30] = -1                                  # all missing
        a[:, 40:60] = rng.integers(0, 4, size=(17, 20))   # all called
        a[:, 60:64] = np.arange(4, dtype=np.int8)         # one code a column
    elif name == "all_missing":
        a = np.full((6, 37), -1, np.int8)
    elif name == "one_site":
        a = np.array([[0], [3], [-1], [2], [3]], np.int8)
    return a


def _mask(H, P, seed=0):
    groups = np.random.default_rng(seed).permutation(np.arange(H) % P)
    mask = np.zeros((P, H), np.float32)
    mask[groups, np.arange(H)] = 1.0
    return mask


CASES = ["s_mod8", "columns", "all_missing", "one_site"]


@pytest.mark.parametrize("name", CASES)
def test_pack_span_matches_jax_bytes(name):
    a = _alleles(name)
    for min_bucket in (8, 1 << 16):
        got, sp = port_transfer.pack_span(a, min_bucket)
        want, sp_jax = jax_transfer.pack_span(a, min_bucket)
        assert sp == sp_jax
        np.testing.assert_array_equal(got, want)
    for g, w in zip(port_transfer.pack_alleles(a),
                    jax_transfer.pack_alleles(a)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", CASES)
def test_plain_unpack_span_matches_jax(name):
    a = _alleles(name)
    buf, sp = port_transfer.pack_span(a, 8)
    got = port_transfer.unpack_span(buf, sp, a.shape[0])
    want = np.asarray(jax_transfer.unpack_span(jax.device_put(buf), sp,
                                               a.shape[0]))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, :a.shape[1]], a)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("P", [1, 5, 9])
def test_plain_counts_match_jax(name, P):
    """site_pop_counts_plain on the span wire == JAX site_pop_counts on
    the alleles == JAX _site_pop_counts_u16 on the JAX unpack of the same
    bytes, and the wrapper (CPU tensors) in site blocks of 8 agrees."""
    a = _alleles(name)
    H, S = a.shape
    mask = _mask(H, P)
    buf, sp = port_transfer.pack_span(a)
    got = port_counts.site_pop_counts_plain(torch.from_numpy(buf), sp, H, 0,
                                            S, torch.from_numpy(mask))
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    u16 = np.asarray(jax_counts._site_pop_counts_u16(
        jax_transfer.unpack_span(jax.device_put(buf), sp, H), mask))
    np.testing.assert_array_equal(got.numpy(), u16[:S].astype(np.int32))

    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    out = torch.empty((S, P, 4), dtype=port_counts.count_dtype(H))
    for s0 in range(0, S, 8):
        s1 = min(s0 + 8, S)
        port_counts.site_pop_counts(torch.from_numpy(buf), sp, H, s0, s1,
                                    groups, out[s0:s1])
    np.testing.assert_array_equal(out.numpy().astype(np.int32), want)


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("P", [1, 5, 9])
def test_dispatch_matches_jax_and_host(port_cpu, monkeypatch, name, P):
    """The port's dispatch (kernel route, CPU tensors, several site blocks)
    == its host route (C counter for P <= 8, numpy above) == JAX."""
    a = _alleles(name)
    mask = _mask(a.shape[0], P, seed=P)
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    monkeypatch.setenv("GGT_EXEC", "tpu")
    port_counts.reset_launches()
    got = port_counts.site_pop_counts_chunked(a, mask, block=16)
    assert sum(port_counts.LAUNCHES.values()) == 0
    assert port_counts.HOST_FLUSHES == 0
    monkeypatch.setenv("GGT_EXEC", "host")
    host = port_counts.site_pop_counts_chunked(a, mask)
    assert port_counts.HOST_FLUSHES == 1
    for c in (got, host):
        assert c.dtype == np.int32
        np.testing.assert_array_equal(c, want)


def test_counts_refuse_overlapping_groups(port_cpu):
    """K6 takes a partition, so PopGroups refuses overlapping groups; the
    dispatch counts an overlapping mask on its membership-class partition
    instead (ABBA's P1..O and union), equal to the JAX counts."""
    a = _alleles("s_mod8")
    mask = _mask(a.shape[0], 3)
    mask[0, :] = 1.0
    with pytest.raises(ValueError):
        port_pair.PopGroups(mask, torch.device("cpu"))
    np.testing.assert_array_equal(
        port_counts.site_pop_counts_chunked(a, mask),
        np.asarray(jax_counts.site_pop_counts(a, mask)))


def test_counts_unported_routes_raise(port_cpu, monkeypatch):
    a = _alleles("s_mod8")
    mask = _mask(a.shape[0], 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_counts.site_pop_counts_dispatch(torch.from_numpy(a), mask)
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_counts.site_pop_counts_dispatch(a, mask)


def test_count_dtype_widens_past_uint16():
    """uint16 while H < 2^16; int32 from there on, so a count of 2^16
    never wraps (the JAX uint16 fetch would)."""
    assert port_counts.count_dtype((1 << 16) - 1) == torch.uint16
    assert port_counts.count_dtype(1 << 16) == torch.int32
