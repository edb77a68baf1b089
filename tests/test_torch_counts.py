"""The port's per-site count path (kernels/counts.py, plain PyTorch K6 and
K12 on the CPU) against the JAX package: K6 on the same span-wire bytes,
K12 on the same int8 matrix (raw uploads, device arrays, strided rows),
counts exactly, for messy inputs, 1 to 12 masks and any 0/1 mask; and the
copied span packers give the JAX bytes."""

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
    """A device-array span and the raw GGT_PACKED_TRANSFER=0 upload count
    through K12's (plain) path and give the JAX counts."""
    a = _alleles("s_mod8")
    mask = _mask(a.shape[0], 2)
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    np.testing.assert_array_equal(port_counts.site_pop_counts_chunked(
        torch.from_numpy(a), mask), want)
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    np.testing.assert_array_equal(
        port_counts.site_pop_counts_chunked(a, mask, block=16), want)


def _raw_alleles(seed, H, S):
    """Raw int8 spans with messy codes: -1 and other negatives (missing),
    codes above 3 (counted nowhere, as the JAX one-hot), all four alleles,
    and trailing -1 pad sites as transfer.upload_span writes them."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 4, size=(H, S)).astype(np.int8)
    hit = rng.random((H, S))
    a[hit < 0.02] = 5
    a[(hit >= 0.02) & (hit < 0.03)] = -7
    a[(hit >= 0.03) & (hit < 0.035)] = 127
    a[:, -9:] = -1
    return a


@pytest.mark.parametrize("H, S", [(13, 1003), (40, 257), (7, 5)])
@pytest.mark.parametrize("P", [1, 3, 9])
def test_plain_raw_counts_match_jax(H, S, P):
    """Plain K12 over site blocks that start anywhere (s0 not a multiple
    of 8, S not a multiple of 4) == the JAX site_pop_counts of the same
    int8 matrix, through the wrapper on CPU tensors, in uint16 out."""
    a = _raw_alleles(H + S, H, S)
    mask = _mask(H, P, seed=P)
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    at = torch.from_numpy(a)
    got = port_counts.site_pop_counts_raw_plain(at, 0, S,
                                                torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    out = torch.empty((S, P, 4), dtype=port_counts.count_dtype(H))
    bounds = [0, 3, 10, 11, S // 2 + 1, S]
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        if s0 <= s1 <= S:
            port_counts.site_pop_counts_raw(at, s0, s1, groups, out[s0:s1])
    assert out.dtype == torch.uint16
    np.testing.assert_array_equal(out.numpy().astype(np.int32), want)


def test_raw_counts_device_array_and_strided_rows(port_cpu, monkeypatch):
    """A tensor span is counted where it lies: a bucket-padded upload read
    through its [:, :S] view (strided rows), and a row-strided slice of a
    wider matrix, both equal to JAX on the contiguous alleles; the padded
    upload holds the bytes of the JAX raw upload_span (-1 pads to the
    site bucket)."""
    a = _raw_alleles(3, 21, 1001)
    H, S = a.shape
    mask = _mask(H, 4)
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    up = port_transfer.upload_span(a)
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    np.testing.assert_array_equal(up.numpy(),
                                  np.asarray(jax_transfer.upload_span(a)))
    monkeypatch.delenv("GGT_PACKED_TRANSFER")
    wide = torch.full((2 * H, S + 37), -1, dtype=torch.int8)
    wide[::2, 5:S + 5] = torch.from_numpy(a)
    for span in (up[:, :S], wide[::2, 5:S + 5]):
        assert not span.is_contiguous()
        got = port_counts.site_pop_counts_chunked(span, mask, block=128)
        np.testing.assert_array_equal(got, want)


def test_raw_counts_int32_past_uint16():
    """H >= 2^16: K12 writes int32 (a count of 2^16 would wrap a uint16),
    equal to the JAX counts."""
    H, S = 1 << 16, 6
    a = np.zeros((H, S), np.int8)
    a[:, 1] = 3
    a[:100, 2] = -1
    a[::2, 4] = 1
    mask = np.zeros((2, H), np.float32)
    mask[0] = 1.0
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    out = port_counts.count_raw(torch.from_numpy(a), S, groups, block=8)
    assert out.dtype == torch.int32 and int(out.max()) == 1 << 16
    np.testing.assert_array_equal(out.numpy(), want)


def test_mask_classes_any_mask_matches_jax(port_cpu, monkeypatch):
    """P = 12 overlapping mask rows (unions, a row of every haplotype, an
    empty row, rows in no mask): the class counts combined on the host ==
    the JAX one-hot matmul, on the packed (K6), raw (K12) and host routes;
    classes come in ascending code order."""
    a = _alleles("s_mod8")
    H = a.shape[0]
    rng = np.random.default_rng(12)
    mask = (rng.random((12, H)) < 0.3).astype(np.float32)
    mask[9] = mask[0] + mask[1] > 0
    mask[10] = 1.0
    mask[11] = 0.0
    mask[:, :2] = 0.0
    classes = port_counts.MaskClasses(mask, torch.device("cpu"))
    codes = (classes.bits << np.arange(12)).sum(axis=1)
    assert (np.diff(codes) > 0).all()
    np.testing.assert_array_equal(classes.codes.numpy(), codes)
    np.testing.assert_array_equal(
        classes.bits[classes.groups.mask.numpy().argmax(axis=0)],
        (mask.T > 0).astype(np.int64))
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    for env in ({}, {"GGT_PACKED_TRANSFER": "0"}, {"GGT_EXEC": "host"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = port_counts.site_pop_counts_chunked(a, mask, block=64)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        for k in env:
            monkeypatch.delenv(k)


def test_count_dtype_widens_past_uint16():
    """uint16 while H < 2^16; int32 from there on, so a count of 2^16
    never wraps (the JAX uint16 fetch would)."""
    assert port_counts.count_dtype((1 << 16) - 1) == torch.uint16
    assert port_counts.count_dtype(1 << 16) == torch.int32


# ------------------------- K18 site_nonmissing, K19 sample_base_counts

def _nonmissing_masks(H):
    """Disjoint rows (a partition), overlapping rows that leave haplotypes
    out, and one all-ones row."""
    rng = np.random.default_rng(H)
    over = (rng.random((5, H)) < 0.4).astype(np.float32)
    over[:, 0] = 0.0                                    # in no row
    over[1] = over[0]                                   # two equal rows
    return {"disjoint": _mask(H, 4, seed=H),
            "overlapping": over,
            "all_ones": np.ones((1, H), np.float32)}


def _jax_nonmissing(a, mask):
    """The JAX site_nonmissing one mask row at a time: this CPU backend's
    dot refuses bf16 x bf16 -> f32 for more than one row, and the rows of
    a matmul are independent."""
    return np.concatenate([np.asarray(jax_counts.site_nonmissing(
        a, mask[p:p + 1])) for p in range(mask.shape[0])], axis=1)


@pytest.mark.parametrize("H, S", [(13, 1003), (40, 257), (7, 5)])
@pytest.mark.parametrize("kind", ["disjoint", "overlapping", "all_ones"])
def test_site_nonmissing_matches_jax(H, S, kind):
    """site_nonmissing (CPU tensors: the plain K18) on codes -7..5 and
    a row-strided view == the JAX site_nonmissing, exactly, for a numpy
    or tensor mask."""
    a = _raw_alleles(H * S, H, S)
    mask = _nonmissing_masks(H)[kind]
    want = _jax_nonmissing(a, mask)
    at = torch.from_numpy(a)
    for m in (mask, torch.from_numpy(mask)):
        got = port_counts.site_nonmissing(at, m)
        assert got.dtype == torch.int32 and got.shape == (S, mask.shape[0])
        np.testing.assert_array_equal(got.numpy(), want)
    wide = torch.from_numpy(np.concatenate([a, a[:, :7]], axis=1))
    np.testing.assert_array_equal(
        port_counts.site_nonmissing(wide[:, :S], mask).numpy(), want)


@pytest.mark.parametrize("bad", [0.5, 2.0, -1.0])
def test_site_nonmissing_refuses_non_binary_mask(bad):
    """Every JAX caller builds 0/1 masks; any other value raises."""
    a = _raw_alleles(1, 9, 20)
    mask = np.ones((2, 9), np.float32)
    mask[1, 3] = bad
    with pytest.raises(ValueError, match="0 and 1"):
        port_counts.site_nonmissing(torch.from_numpy(a), mask)


@pytest.mark.parametrize("H, S", [(13, 1003), (40, 257), (7, 5), (3, 0)])
def test_sample_base_counts_matches_jax(H, S):
    """sample_base_counts (CPU tensors: the plain K19) on codes -7..5 and
    127 == the JAX one-hot, exactly, also through a row-strided view."""
    a = _raw_alleles(H + 2 * S, H, S) if S else np.zeros((H, 0), np.int8)
    want = np.asarray(jax_counts.sample_base_counts(a))
    got = port_counts.sample_base_counts(torch.from_numpy(a))
    assert got.dtype == torch.int32 and got.shape == (H, S, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    wide = torch.from_numpy(np.concatenate([a, a], axis=1))
    np.testing.assert_array_equal(
        port_counts.sample_base_counts(wide[:, :S]).numpy(), want)
