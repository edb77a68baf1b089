"""The port's fused window-statistics step (K9 + K10 + K11 plain versions
on the CPU) against the JAX ``window_stats_step`` on the same numpy
inputs: integers exactly, pi / dxy at rtol 1e-5, Fst at rtol 1e-4 / atol
1e-5 (float32 sums in another order than XLA's), NaN positions equal; and
against the float64 CSV-exact path as tests/test_transfer_and_faststep.py
holds the JAX step."""

import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels.window_stats import \
    window_stats_step as jax_step
from genomics_general_tpu_torch import entry as port_entry
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import window_stats as port_ws
from genomics_general_tpu_torch.stats import popgen as port_popgen


@pytest.fixture(autouse=True)
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def messy_step_input(seed=4):
    """Missing data, a population of one haplotype (no pairs: NaN pi),
    rows in no population, an empty window, a window of one site, a
    window where a few rows are all missing, windows ending at S."""
    rng = np.random.default_rng(seed)
    H, S = 23, 1500
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    a[:4, 300:420] = -1
    pm = np.zeros((3, H), np.float32)
    pm[0, :9] = 1
    pm[1, 9:20] = 1
    pm[2, 20] = 1
    first = np.array([0, 10, 300, 301, 700, 1400, 1499, 250], np.int32)
    n = np.array([0, 1, 120, 200, 513, 100, 1, 1250], np.int32)
    return a, first, n, pm


def _compare(got, want):
    for k in ("mismatch", "shared", "pop_counts"):
        g = got[k].numpy()
        assert g.dtype == np.int32, k
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
    for k, rtol, atol in (("pi", 1e-5, 0), ("dxy", 1e-5, 0),
                          ("fst", 1e-4, 1e-5)):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def test_entry_matches_jax_entry():
    """entry(): the JAX entry's example data (np.random.default_rng(0)),
    as tensors on the device, through the port's step == the JAX step."""
    fn, args = port_entry.entry()
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in args)
    a, first, n, pm = port_entry._example_data()
    for x, y in zip(args, (a, first, n, pm)):
        np.testing.assert_array_equal(x.numpy(), y)
    _compare(fn(*args), jax_step(a, first, n, pm, s_max=512))


def test_messy_input_matches_jax():
    a, first, n, pm = messy_step_input()
    got = port_ws.window_stats_step(a, first, n, pm)
    want = jax_step(a, first, n, pm, s_max=2048)
    _compare(got, want)
    pi = got["pi"].numpy()
    assert np.isnan(pi[0]).all() and np.isnan(pi[:, 2]).all()


def test_step_matches_exact_path():
    """The f32 step vs the float64 CSV-exact path (the port's pair counts
    and group_dist_stats) on complete data, at the JAX test's tolerance."""
    rng = np.random.default_rng(7)
    H, S = 12, 1024
    alleles = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    first = np.arange(0, S, 128, dtype=np.int32)
    n_s = np.full(first.shape, 128, dtype=np.int32)
    pop_mask = np.zeros((2, H), np.float32)
    pop_mask[0, :H // 2] = 1
    pop_mask[1, H // 2:] = 1
    fast = port_ws.window_stats_step(torch.from_numpy(alleles), first, n_s,
                                     pop_mask)
    mism, shar = port_pair.window_pair_counts(torch.from_numpy(alleles),
                                              first, n_s)
    exact = port_popgen.group_dist_stats(
        port_popgen.DistStatsContext(mism, shar),
        ["pop1"] * (H // 2) + ["pop2"] * (H // 2),
        do_pairs=True, min_sites=0, min_data=0.0)
    pi, dxy, fst = (fast[k].numpy() for k in ("pi", "dxy", "fst"))
    np.testing.assert_allclose(pi[:, 0], exact["pi_pop1"], rtol=2e-5)
    np.testing.assert_allclose(pi[:, 1], exact["pi_pop2"], rtol=2e-5)
    np.testing.assert_allclose(dxy[:, 0, 1], exact["dxy_pop1_pop2"],
                               rtol=2e-5)
    np.testing.assert_allclose(fst[:, 0, 1], exact["Fst_pop1_pop2"],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 5000])
def test_fixed_sum_order(n):
    """_fixed_sum is K10's order: lane p % 1024 adds its terms in order,
    then the lanes add as a binary tree (checked against a plain Python
    replay of that order in float32)."""
    rng = np.random.default_rng(n)
    x = rng.random((2, n)).astype(np.float32)
    got = port_ws._fixed_sum(torch.from_numpy(x)).numpy()
    for r in range(2):
        lanes = np.zeros(1024, np.float32)
        for p in range(n):
            lanes[p % 1024] = np.float32(lanes[p % 1024] + x[r, p])
        stride = 512
        while stride:
            lanes[:stride] = lanes[:stride] + lanes[stride:2 * stride]
            stride //= 2
        assert got[r] == lanes[0]
    np.testing.assert_allclose(got, x.astype(np.float64).sum(axis=1),
                               rtol=1e-5)


def test_tail_and_pop_counts_plain_entry_points():
    """The K10 and K11 wrappers take their plain versions on CPU tensors
    and count no launch; the block means equal a float64 recomputation to
    float32 rounding."""
    a, first, n, pm = messy_step_input(5)
    m, s = port_pair.pair_counts_4state(torch.from_numpy(a),
                                        torch.from_numpy(first),
                                        torch.from_numpy(n))
    port_ws.reset_launches()
    pi, dxy, _ = port_ws.window_stats_tail(m, s, torch.from_numpy(pm))
    counts = port_ws.window_pop_counts(
        torch.from_numpy(a), torch.from_numpy(first), torch.from_numpy(n),
        torch.from_numpy(pm))
    assert sum(port_ws.LAUNCHES.values()) == 0
    md, sd = m.numpy().astype(np.float64), s.numpy()
    valid = (sd > 0) & ~np.eye(a.shape[0], dtype=bool)[None]
    dist = np.where(valid, md / np.maximum(sd, 1), 0.0)
    for x in range(2):
        for y in range(2):
            sel = np.outer(pm[x], pm[y]).astype(bool)[None] & valid
            with np.errstate(invalid="ignore"):
                want = (dist * sel).sum(axis=(1, 2)) / sel.sum(axis=(1, 2))
            np.testing.assert_allclose(dxy.numpy()[:, x, y], want,
                                       rtol=1e-6)
    np.testing.assert_array_equal(np.diagonal(dxy.numpy(), axis1=1, axis2=2),
                                  pi.numpy())
    for w in range(first.shape[0]):
        sl = a[:, first[w]:first[w] + n[w]]
        for p in range(3):
            rows = sl[pm[p] > 0]
            np.testing.assert_array_equal(
                counts.numpy()[w, p], [(rows == c).sum() for c in range(4)])


def test_step_chunks_any_batch(monkeypatch):
    """window_stats_step runs STEP_CHUNK windows per launch and joins the
    chunks in window order: with chunks of 3, its 8 windows (3 + 3 + 2)
    equal the unchunked step and the JAX step."""
    a, first, n, pm = messy_step_input(6)
    whole = port_ws.window_stats_step(a, first, n, pm)
    monkeypatch.setattr(port_ws, "STEP_CHUNK", 3)
    calls = []
    real = port_pair.pair_counts_4state
    monkeypatch.setattr(port_pair, "pair_counts_4state",
                        lambda a, f, k, s=None: calls.append(f.shape[0])
                        or real(a, f, k, s))
    chunked = port_ws.window_stats_step(a, first, n, pm)
    assert calls == [3, 3, 2]
    for k, v in whole.items():
        assert chunked[k].shape == v.shape, k
        np.testing.assert_array_equal(chunked[k].numpy(), v.numpy(),
                                      err_msg=k)
    _compare(chunked, jax_step(a, first, n, pm, s_max=2048))


def test_step_refuses_a_fractional_mask():
    a, first, n, pm = messy_step_input()
    pm = pm * 0.5
    with pytest.raises(ValueError, match="0/1"):
        port_ws.window_stats_step(a, first, n, pm)
