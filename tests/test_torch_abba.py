"""The port's ABBA path (kernels/abba.py: plain K7 site terms and K8 window
sums on the CPU, K6 on the membership-class partition) against the JAX
package on the same numpy inputs: per-site terms equal to the numpy host
executor's exactly, window sums within 1e-9 of the JAX device function,
overlapping-mask counts equal to the JAX counts, and the flush buffer
bytes equal to the JAX packer's."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import abba as jax_abba
from genomics_general_tpu.kernels import counts as jax_counts
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu_torch.kernels import abba as port_abba
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import transfer as port_transfer

CPU = torch.device("cpu")
MODES = ["polarize", "fixed", "minor"]
DEN_FH = port_abba.FULL_CHANNELS.index("den_fh")
NUM_F4C = port_abba.FULL_CHANNELS.index("num_f4c")


def _alleles(seed=3, H=40, S=3000):
    """Messy ABBA input (tests/test_abba_host_exec._messy) plus: P4's rows
    all missing on a block of sites, 50/50 tie sites (two alleles on
    exactly half the called haplotypes of the union), and sites where the
    populations' row blocks are fixed (so --fixed selects alleles)."""
    rng = np.random.default_rng(seed)
    f = rng.beta(0.4, 0.4, size=S)
    al = (rng.random((H, S)) < f).astype(np.int8) \
        * rng.integers(1, 4, size=S).astype(np.int8)
    al[rng.random((H, S)) < 0.1] = -1
    for s in rng.choice(S, size=S // 30, replace=False):
        al[rng.integers(0, H, 3), s] = rng.integers(0, 4)
    al[30:40, 200:400] = -1                    # P4 (the outgroup) uncalled
    for s in range(600, 900):                  # 50/50 ties in the union
        a, b = rng.choice(4, size=2, replace=False)
        al[:, s] = np.where(rng.permutation(H) < H // 2, a, b)
        if s % 3 == 0:
            al[rng.choice(H, size=2, replace=False), s] = -1
    for s in range(1000, 1200):                # fixed row blocks
        x, y = rng.choice(4, size=2, replace=False)
        al[:, s] = x
        al[20:30, s] = y
        if s % 2:
            al[10:20, s] = y
        if s % 5 == 0:
            al[rng.integers(0, H), s] = -1
    return al


def _mask(layout, H=40):
    """[5, H]: P1, P2, P3, O and their union; ``overlap`` lets P1 and P2
    share rows and leaves rows in no population."""
    mask = np.zeros((5, H), np.float32)
    spans = {"disjoint": [(0, 10), (10, 20), (20, 30), (30, 40)],
             "overlap": [(0, 12), (8, 20), (20, 28), (30, 40)]}[layout]
    for k, (a, b) in enumerate(spans):
        mask[k, a:b] = 1
    mask[4] = mask[:4].max(axis=0)
    return mask, [b - a for a, b in spans]


def _port_site_terms(al, mask, n_pops, min_data, mode, full):
    """Plain K6 on the class partition, then plain K7 (through the
    wrappers, on CPU tensors)."""
    H, S = al.shape
    classes = port_counts.MaskClasses(mask, CPU)
    buf, sp = port_transfer.pack_span(al)
    cc = port_counts.count_span(torch.from_numpy(buf), sp, H, S,
                                classes.groups)
    return port_abba.abba_site_terms(cc, classes.codes, n_pops, min_data,
                                     mode, full).numpy()


def _membership(mask):
    return port_counts.membership_bits(mask)


CASES = [(m, f, d, lay) for m in MODES for f in (False, True)
         for d in (0.3, 0.0) for lay in ("disjoint", "overlap")]
IDS = [f"{m}-{'full' if f else 'classic'}-md{d}-{lay}"
       for m, f, d, lay in CASES]


@pytest.mark.parametrize("mode,full,min_data,layout", CASES, ids=IDS)
def test_plain_site_terms_equal_host_executor(mode, full, min_data, layout):
    """Per-site channels equal the numpy host executor's exactly (NaN
    positions included): one window per site makes its sums the terms."""
    al = _alleles()
    mask, n_pops = _mask(layout)
    S = al.shape[1]
    got = _port_site_terms(al, mask, n_pops, min_data, mode, full)
    first = np.arange(S, dtype=np.int32)
    ones = np.ones(S, np.int32)
    want = jax_abba.host_window_abba_sums(al, first, ones, _membership(mask),
                                          n_pops, min_data, mode, full)
    np.testing.assert_array_equal(got, want)
    copy = port_abba.host_window_abba_sums(al, first, ones,
                                           _membership(mask), n_pops,
                                           min_data, mode, full)
    np.testing.assert_array_equal(copy, want)
    assert got[:, 0].sum() > 100 and got[:, 1].sum() > 50   # gated, used
    if min_data == 0.0 and full and mode == "minor":
        # the uncalled outgroup's NaN freqs reach the terms (polarize and
        # fixed select no allele where P4 is NaN)
        assert np.isnan(got[200:400, DEN_FH]).any()


def _windows(S):
    """Overlapping windows of 100 sites every 37, an empty one, one long
    one over the tie block."""
    first = np.arange(0, S - 100, 37, dtype=np.int32)
    n = np.full(first.size, 100, np.int32)
    n[5] = 0
    first = np.append(first, 550).astype(np.int32)
    n = np.append(n, 400).astype(np.int32)
    return first, n


@pytest.mark.parametrize("mode,full,min_data,layout", CASES, ids=IDS)
def test_window_sums_match_jax_device(mode, full, min_data, layout,
                                      monkeypatch):
    """The port's dispatch on the CPU (plain K6, K7, K8) against the JAX
    ``fused_abba_flush`` (GGT_EXEC=tpu, x64): within atol 1e-9, NaN
    positions equal, except den_fh: where an uncalled outgroup makes it
    NaN here (numpy's NaN * 0) JAX's select adds 0.0 for the site, and
    num_f4c is NaN in both, so no statistic differs."""
    al = _alleles()
    mask, n_pops = _mask(layout)
    first, n = _windows(al.shape[1])
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("GGT_EXEC", "tpu")
    got = port_abba.window_abba_sums_dispatch(
        al, first, n, mask, n_pops, min_data, mode, full).collect()
    with jax.enable_x64(True):
        want = jax_abba.window_abba_sums_dispatch(
            al, first, n, mask, n_pops, min_data, mode, full).collect()
    assert got.shape == want.shape == (first.size,
                                       len(port_abba.channels_of(full)))
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    if full:
        fh = nan_g[:, DEN_FH] & ~nan_w[:, DEN_FH]
        assert nan_g[fh, NUM_F4C].all() and nan_w[fh, NUM_F4C].all()
        nan_g[fh, DEN_FH] = False
        got, want = got.copy(), want.copy()
        got[fh, DEN_FH] = want[fh, DEN_FH] = 0.0
        if min_data == 0.0 and mode == "minor":
            assert fh.any()
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode,full", [("minor", True), ("polarize", False)])
def test_host_executor_route(mode, full, monkeypatch):
    """GGT_EXEC=host runs the copied host executor (counted in
    HOST_FLUSHES), equal to the JAX package's."""
    al = _alleles(seed=4)
    mask, n_pops = _mask("overlap")
    first, n = _windows(al.shape[1])
    monkeypatch.setenv("GGT_EXEC", "host")
    port_abba.reset_launches()
    got = port_abba.window_abba_sums_dispatch(
        al, first, n, mask, n_pops, 0.3, mode, full).collect()
    assert port_abba.HOST_FLUSHES == 1
    want = jax_abba.host_window_abba_sums(al, first, n, _membership(mask),
                                          n_pops, 0.3, mode, full)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["disjoint", "overlap"])
@pytest.mark.parametrize("exec_", ["tpu", "host"])
def test_overlapping_mask_counts_match_jax(layout, exec_, monkeypatch):
    """site_pop_counts_dispatch on the 5-row mask (rows overlap: the class
    partition route, or the C counter under GGT_EXEC=host) equals the JAX
    site_pop_counts exactly."""
    al = _alleles(seed=5)
    mask, _ = _mask(layout)
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("GGT_EXEC", exec_)
    got = port_counts.site_pop_counts_dispatch(al, mask).collect()
    want = np.asarray(jax_counts.site_pop_counts(al, mask))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_mask_classes():
    mask, _ = _mask("overlap")
    classes = port_counts.MaskClasses(mask, CPU)
    code = sum(mask[p].astype(np.int64) << p for p in range(5))
    np.testing.assert_array_equal(classes.codes.numpy(), np.unique(code))
    assert 0 in classes.codes.tolist()            # rows 28, 29: no pop
    assert port_counts.is_partition(classes.groups.mask.numpy())
    assert not port_counts.is_partition(mask)
    assert port_counts.is_partition(np.eye(4))
    rng = np.random.default_rng(0)
    cc = rng.integers(0, 50, size=(7, classes.codes.numel(), 4))
    want = np.stack([cc[:, (np.unique(code) >> p) & 1 == 1].sum(axis=1)
                     for p in range(5)], axis=1)
    np.testing.assert_array_equal(classes.combine(cc), want)
    with pytest.raises(ValueError):
        port_counts.MaskClasses(mask * 0.5, CPU)


@pytest.mark.parametrize("min_bucket", [8, 1 << 16])
def test_flush_buffer_matches_jax(min_bucket):
    """pack_flush_buffer gives the JAX bytes; the plain
    unpack_flush_buffer equals the JAX device unpack."""
    al = _alleles(seed=6, H=23, S=1203)
    first, n = _windows(al.shape[1])
    wp = 64
    got, sp = port_transfer.pack_flush_buffer(al, first, n, wp, min_bucket)
    want, sp_jax = jax_transfer.pack_flush_buffer(al, first, n, wp,
                                                  min_bucket)
    assert sp == sp_jax
    np.testing.assert_array_equal(got, want)
    a, f, nn = port_transfer.unpack_flush_buffer(got, sp, al.shape[0], wp)
    ja, jf, jn = jax_transfer.unpack_flush_buffer(jax.device_put(want), sp,
                                                  al.shape[0], wp)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(nn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(a.numpy()[:, :al.shape[1]], al)
    with pytest.raises(ValueError):
        port_transfer.flush_views(torch.from_numpy(got[:-1]), sp,
                                  al.shape[0], wp)


def test_plain_window_sums_match_numpy_loop():
    rng = np.random.default_rng(7)
    terms = rng.normal(size=(500, 18))
    terms[rng.random(terms.shape) < 0.01] = np.nan
    first = np.array([0, 10, 10, 499, 250, 0], np.int32)
    n = np.array([500, 5, 0, 1, 100, 0], np.int32)
    got = port_abba.abba_window_sums(torch.from_numpy(terms),
                                     torch.from_numpy(first),
                                     torch.from_numpy(n)).numpy()
    want = np.stack([terms[f:f + k].sum(axis=0) for f, k in zip(first, n)])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    assert (got[[2, 5]] == 0).all()
    with pytest.raises(ValueError):
        port_abba.abba_window_sums(torch.from_numpy(terms),
                                   torch.tensor([495], dtype=torch.int32),
                                   torch.tensor([10], dtype=torch.int32))


def test_wrappers_reject_bad_input(monkeypatch):
    cc = torch.zeros((4, 2, 4), dtype=torch.int32)
    codes = torch.tensor([1, 30], dtype=torch.int32)
    with pytest.raises(ValueError):
        port_abba.abba_site_terms(cc, codes, [1, 1, 1, 1], 0.1, "median",
                                  False)
    with pytest.raises(ValueError):
        port_abba.abba_site_terms(cc, codes[:1], [1, 1, 1, 1], 0.1, "minor",
                                  False)
    with pytest.raises(ValueError):
        port_abba.abba_window_sums(torch.zeros((4, 8), dtype=torch.float32),
                                   torch.zeros(1, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32))
    al = _alleles(seed=8, S=1300)
    mask, n_pops = _mask("disjoint")
    first = np.array([0], np.int32)
    with pytest.raises(ValueError):
        port_abba.window_abba_sums_dispatch(
            al, first, np.array([1301], np.int32), mask, n_pops, 0.3,
            "minor", True)
    # GGT_PACKED_TRANSFER=0 is no bad input: the kernel route ships the
    # flush buffer either way, as the JAX fused route does
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    args = (al, first, np.array([100], np.int32), mask, n_pops, 0.3, "minor",
            True)
    packed = port_abba.window_abba_sums_dispatch(*args).collect()
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    np.testing.assert_array_equal(
        port_abba.window_abba_sums_dispatch(*args).collect(), packed)


def test_empty_flush_gives_zero_rows(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    mask, n_pops = _mask("disjoint")
    h = port_abba.window_abba_sums_dispatch(
        np.zeros((40, 0), np.int8), np.zeros(0, np.int32),
        np.zeros(0, np.int32), mask, n_pops, 0.3, "minor", False)
    assert h.collect().shape == (0, 8)


def test_finalize_matches_jax():
    rng = np.random.default_rng(9)
    for full in (False, True):
        ch = port_abba.channels_of(full)
        sums = rng.normal(size=(6, len(ch)))
        sums[:, 1] = rng.integers(0, 30, size=6)
        sums[2, 0] = 0.0                              # no gated site
        got = port_abba.finalize_window_stats(sums, ch, full)
        want = jax_abba.finalize_window_stats(sums, ch, full)
        assert [list(g) for g in got] == [list(w) for w in want]
        np.testing.assert_array_equal(
            np.array([list(g.values()) for g in got], float),
            np.array([list(w.values()) for w in want], float))
