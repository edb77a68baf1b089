"""The port's general 4-state pair counts (K9's plain version on the CPU)
against the JAX package's ``pairwise_counts`` / ``gather_window_batch`` /
``_gathered_pair_counts``, ``CatPairAccumulator`` and
``long_span_pair_counts`` on the same numpy inputs: counts exactly.  Also
the two ``tri`` routes that run K9 (a tensor span and the raw
``GGT_PACKED_TRANSFER=0`` upload) against the v3 route and JAX."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def messy(H: int, S: int, seed: int):
    """Codes 0..3 and -1, multi-allelic sites, an all-missing block and a
    fixed block; windows of 0 and 1 site, unaligned starts, overlapping
    windows and one ending exactly at S."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.12] = -1
    for s in rng.choice(S, size=S // 15, replace=False):
        a[rng.integers(0, H, 4), s] = rng.integers(2, 4)
    a[:, 40:60] = -1
    a[:, 60:90] = 3
    first = np.array([0, 7, 13, 101, 250, 251, 333, S - 97, 5],
                     dtype=np.int32)
    n = np.array([0, 1, 400, 299, 1, 600, 3, 97, S - 5], dtype=np.int32)
    return a, first, np.minimum(n, S - first).astype(np.int32)


CASES = {"h13": (13, 1000, 1), "h77": (77, 1203, 2), "h4": (4, 777, 3)}


def _jax_counts(a, first, n):
    s_max = max(int(n.max()), 1)
    wa, valid = jax_pair.gather_window_batch(jnp.asarray(a), first, n, s_max)
    m, s = jax_pair.pairwise_counts(wa, valid)
    return np.asarray(m), np.asarray(s)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_pairwise_counts(name):
    a, first, n = messy(*CASES[name])
    want_m, want_s = _jax_counts(a, first, n)
    m, s = port_pair.pair_counts_4state(torch.from_numpy(a),
                                        torch.from_numpy(first),
                                        torch.from_numpy(n))
    assert m.dtype == s.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_array_equal(s.numpy(), want_s)
    assert (m.numpy()[n == 0] == 0).all() and (s.numpy()[n == 0] == 0).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_slabs_match_jax_gathered_tri(name, monkeypatch):
    """Small site slabs in the plain K9 (many slabs per window) and the
    chunked K9 + K4 flush == the JAX ``_gathered_pair_counts`` triangles."""
    monkeypatch.setattr(port_pair, "_PLAIN_CELLS", 1)
    a, first, n = messy(*CASES[name])
    s_max = 1024 * -(-int(n.max()) // 1024)
    want = np.asarray(jax_pair._gathered_pair_counts(
        jnp.asarray(a), first, n, s_max))
    got = port_pair.flush_tri_4state(
        torch.from_numpy(a), torch.from_numpy(first), torch.from_numpy(n),
        2, port_pair._tri_u16(n), int(n.max()))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


def test_codes_outside_the_alphabet_count_as_called():
    """A code above 3 is called but matches no code, itself included, as
    in the JAX one-hot."""
    a = np.array([[0, 5, 5, -1], [0, 5, 4, 2]], np.int8)
    first, n = np.array([0], np.int32), np.array([4], np.int32)
    want_m, want_s = _jax_counts(a, first, n)
    m, s = port_pair.pair_counts_4state(torch.from_numpy(a),
                                        torch.from_numpy(first),
                                        torch.from_numpy(n))
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_array_equal(s.numpy(), want_s)


def test_strided_rows_and_no_launch_on_cpu():
    """K9 takes rows with a stride (a block of a larger staging buffer);
    CPU tensors take the plain version and count no launch."""
    a, first, n = messy(13, 1000, 4)
    big = torch.full((13, 1500), -1, dtype=torch.int8)
    big[:, :1000] = torch.from_numpy(a)
    port_pair.reset_launches()
    m, s = port_pair.pair_counts_4state(big[:, :1000],
                                        torch.from_numpy(first),
                                        torch.from_numpy(n))
    assert sum(port_pair.LAUNCHES.values()) == 0
    want_m, want_s = _jax_counts(a, first, n)
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_array_equal(s.numpy(), want_s)


@pytest.mark.parametrize("h, nwin, s_max, splits", [
    (512, 1, 262144, 33), (512, 1, 237856, 33), (512, 32, 700, 1),
    (40, 1, 7092, 3), (77, 1, 100, 1), (160, 128, 5003, 1)])
def test_k9_site_splits_cover_each_window(h, nwin, s_max, splits):
    """The split of K14's site axis (the first of two row shards, its
    rectangle of 128 x 128 tiles given to _k9_grid; a 132-SM card): whole
    128-site steps, ranges covering [0, s_max) with none empty."""
    r1 = -(-h // 2)
    tiles = -(-r1 // port_pair._K9_MMA_TILE) * -(-h // port_pair._K9_MMA_TILE)
    old = dict(port_pair._SM_COUNT)
    port_pair._SM_COUNT[0] = 132
    try:
        got_tiles, got, length = port_pair._k9_grid(
            h, nwin, s_max, torch.device("cuda", 0), tiles=tiles)
    finally:
        port_pair._SM_COUNT.clear()
        port_pair._SM_COUNT.update(old)
    assert got_tiles == tiles and got == splits
    if got == 1:
        assert length >= s_max
    else:
        assert length % port_pair._K9_MMA_STAGE == 0
        assert (got - 1) * length < s_max <= got * length


@pytest.mark.parametrize("exec_", ["tpu", "host"])
@pytest.mark.parametrize("block", [256, 1000])
def test_cat_accumulator_matches_jax(port_cpu, monkeypatch, exec_, block):
    """Chunks of uneven sizes cross the block boundaries; the tail block
    keeps its own length.  Under GGT_EXEC=host both classes run their host
    executors."""
    monkeypatch.setenv("GGT_EXEC", exec_)
    a, _, _ = messy(13, 2345, 5)
    chunks = [0, 100, 400, 407, 1200, 2345]
    port_pair.reset_launches()
    accs = (jax_pair.CatPairAccumulator(13, block),
            port_pair.CatPairAccumulator(13, block))
    for acc in accs:
        for lo, hi in zip(chunks[:-1], chunks[1:]):
            acc.add(a[:, lo:hi])
    (wm, ws), (gm, gs) = (acc.finish() for acc in accs)
    assert gm.dtype == gs.dtype == np.int64
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gs, ws)
    want_m, want_s = _jax_counts(a, np.array([0], np.int32),
                                 np.array([2345], np.int32))
    np.testing.assert_array_equal(gm, want_m[0])
    np.testing.assert_array_equal(gs, want_s[0])
    blocks = -(-2345 // block)
    assert port_pair.HOST_FLUSHES == (blocks if exec_ == "host" else 0)
    assert sum(port_pair.LAUNCHES.values()) == 0


@pytest.mark.parametrize("span", ["numpy", "tensor"])
def test_long_span_matches_jax(port_cpu, span):
    a, _, _ = messy(13, 2345, 6)
    want = jax_pair.long_span_pair_counts(a, 17, 2300, block=500)
    src = a if span == "numpy" else torch.from_numpy(a)
    got = port_pair.long_span_pair_counts(src, 17, 2300, block=500)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_long_span_host_executor(port_cpu, monkeypatch):
    monkeypatch.setenv("GGT_EXEC", "host")
    a, _, _ = messy(13, 2345, 7)
    port_pair.reset_launches()
    got = port_pair.long_span_pair_counts(a, 3, 2000)
    assert port_pair.HOST_FLUSHES == 1
    monkeypatch.setenv("GGT_EXEC", "tpu")
    want = jax_pair.long_span_pair_counts(a, 3, 2000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _collect(exec_, fn, *args):
    old = os.environ.get("GGT_EXEC")
    os.environ["GGT_EXEC"] = exec_
    try:
        return fn(*args).collect()
    finally:
        os.environ["GGT_EXEC"] = old or "tpu"


@pytest.mark.parametrize("name", sorted(CASES))
def test_tri_routes_of_k9_match_v3_and_jax(port_cpu, monkeypatch, name):
    """window_pair_counts_dispatch on a tensor span (the JAX device-array
    route) and under GGT_PACKED_TRANSFER=0 (the raw upload) == the port's
    v3 route == the JAX device-array route == the JAX host-span route."""
    a, first, n = messy(*CASES[name])
    jax_dev = jax_pair.window_pair_counts(jnp.asarray(a), first, n)
    jax_host = _collect("tpu", jax_pair.window_pair_counts_dispatch, a,
                        first, n)
    v3 = _collect("tpu", port_pair.window_pair_counts_dispatch, a, first, n)
    port_pair.reset_launches()
    tensor = port_pair.window_pair_counts(torch.from_numpy(a), first, n)
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    raw = _collect("tpu", port_pair.window_pair_counts_dispatch, a, first, n)
    assert port_pair.HOST_FLUSHES == 0
    for got in (v3, tensor, raw, jax_host):
        for g, w in zip(got, jax_dev):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_raw_route_long_window_is_int32(port_cpu, monkeypatch):
    """A window of more than 2^16 sites: the raw route's triangles are
    int32 (the JAX rule) and the counts still equal JAX's."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 4, size=(5, 70000)).astype(np.int8)
    a[rng.random(a.shape) < 0.05] = -1
    first, n = np.array([0, 1000], np.int32), np.array([66000, 5000],
                                                       np.int32)
    assert not port_pair._tri_u16(n)
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    got = _collect("tpu", port_pair.window_pair_counts_dispatch, a, first, n)
    want = _jax_counts(a, first, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_k9_routes_refuse_windows_outside_the_span(port_cpu, monkeypatch):
    a, first, n = messy(13, 1000, 9)
    n = n.copy()
    n[2] = 1000
    with pytest.raises(ValueError, match="span"):
        port_pair.window_pair_counts_dispatch(torch.from_numpy(a), first, n)
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    with pytest.raises(ValueError, match="span"):
        port_pair.window_pair_counts_dispatch(a, first, n)


def test_raw_span_buffer_round_trip():
    """pack_raw_span's views give back the matrix and the windows, with S
    not a multiple of 4 or 16 (rows padded to a 16-byte stride, the
    windows after them); a buffer of another width is refused, also one
    whose rows pad to the same stride."""
    a, first, n = messy(13, 1001, 10)
    buf = port_transfer.pack_raw_span(a[:, :999], first, n)
    al, f, k = port_transfer.raw_span_views(torch.from_numpy(buf), 13, 999,
                                            first.shape[0])
    assert al.stride(0) % 16 == 0
    np.testing.assert_array_equal(al.numpy(), a[:, :999])
    np.testing.assert_array_equal(f.numpy(), first)
    np.testing.assert_array_equal(k.numpy(), n)
    for s in (1000, 998, 1009):
        with pytest.raises(ValueError):
            port_transfer.raw_span_views(torch.from_numpy(buf), 13, s,
                                         first.shape[0])


def test_device_alleles_uploads_raw_bytes(port_cpu):
    a, _, _ = messy(7, 333, 11)
    got = port_transfer.device_alleles(a)
    assert got.dtype == torch.int8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), a)
    before = int(a[0, 0])
    a[0, 0] = 3 - max(before, 0)
    assert got[0, 0].item() == before        # a copy, not a view
