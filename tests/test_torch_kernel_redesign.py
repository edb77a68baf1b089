"""The redesigned K9 and K14 (pair4.cu, 4-state pair counts on the int8
tensor cores: the upper triangle and a rectangle of rows) and K12 and K18
(counts.cu, raw per-site counts and called counts on one row-slot loop)
on the CPU: their launch geometry (every window, tile and site range
once, within the grid limits, the card filled), numpy models of the
kernels' register decode, byte-lane counting, class fold and tile walk
against the plain versions and the JAX functions, and the plain versions
against JAX at the new tiles' edge shapes, exactly.  The kernels
themselves run only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import counts as jax_counts
from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.parallel import mesh as jax_mesh
from genomics_general_tpu_torch.kernels import counts as port_counts
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer

SM = 132                                  # the H100's SMs
GRID_YZ = 65535                           # CUDA's grid limit on y and z
LOW = np.uint32(0x01010101)


@pytest.fixture
def sms(monkeypatch):
    """Both helpers see a 132-SM card."""
    monkeypatch.setattr(port_pair, "_sm_count", lambda dev: SM)
    monkeypatch.setattr(port_counts, "_sm_count", lambda dev: SM)


# ------------------------------------------------------------ geometry

def _upper_tiles(x: int, tiles: int) -> tuple[int, int]:
    """The kernel's walk from blockIdx.x to its tile (ti <= tj)."""
    ti, rem = 0, x
    while rem >= tiles - ti:
        rem -= tiles - ti
        ti += 1
    return ti, ti + rem


@pytest.mark.parametrize("h, nwin, s_max", [
    (512, 1, 262144), (512, 1, 237856), (512, 32, 700), (40, 1, 7092),
    (77, 1, 100), (160, 128, 5003), (1000, 1, 4999), (1, 12, 4999),
    (17, 11, 1999), (512, 2, 66000), (129, 3, 2049), (1000, 65535, 9)])
def test_k9_grid_covers_each_block_once(sms, h, nwin, s_max):
    """Grid (tiles, splits, nwin): each window's upper-triangle tiles once,
    its sites [0, s_max) once in whole 128-site steps with no empty range,
    within CUDA's limits, and a split only while the tiles leave SMs idle,
    keeping the blocks within two waves."""
    tiles, splits, split_len = port_pair._k9_grid(h, nwin, s_max, None)
    t = -(-h // port_pair._K9_MMA_TILE)
    assert tiles == t * (t + 1) // 2
    seen = sorted(_upper_tiles(x, t) for x in range(tiles))
    assert seen == [(i, j) for i in range(t) for j in range(i, t)]
    assert 1 <= splits <= GRID_YZ and nwin <= GRID_YZ
    if splits == 1:
        assert split_len >= s_max
        return
    assert tiles * nwin < SM and tiles * nwin * splits <= 2 * SM
    assert split_len % port_pair._K9_MMA_STAGE == 0
    assert split_len >= port_pair._K9_MIN_SPLIT
    ranges = [(y * split_len, min(s_max, (y + 1) * split_len))
              for y in range(splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == s_max
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_k9_grid_run_e_block(sms):
    """Run E's block (H = 512, one window of 262,144 sites): 10 tiles cut
    into 26 site ranges, 260 blocks for two waves of 132."""
    assert port_pair._k9_grid(512, 1, 1 << 18, None) == (10, 26, 10112)


def _rect_tiles(h: int, r0: int, r1: int) -> int:
    t = port_pair._K9_MMA_TILE
    return -(-(r1 - r0) // t) * -(-h // t)


def _rect_walk(h: int, r0: int, r1: int) -> list[tuple[int, int]]:
    """pair4.cu's kRect walk: blockIdx.x over the 128-row tiles from r0
    times the 128-column tiles of [0, h), to each tile's (i0, j0)."""
    t = port_pair._K9_MMA_TILE
    col_tiles = -(-h // t)
    return [(r0 + (x // col_tiles) * t, (x % col_tiles) * t)
            for x in range(_rect_tiles(h, r0, r1))]


@pytest.mark.parametrize("h, nwin, s_max, r0, r1", [
    (512, 1, 262144, 0, 256), (512, 1, 237856, 100, 300), (512, 32, 700,
                                                            0, 256),
    (512, 2, 66000, 127, 129), (77, 1, 4999, 30, 77), (1, 12, 4999, 0, 1),
    (160, 11, 1999, 150, 160), (1000, 3, 70003, 999, 1000),
    (160, 1, 2047, 0, 160), (512, 65535, 9, 0, 512)])
def test_k14_grid_covers_each_block_once(sms, h, nwin, s_max, r0, r1):
    """_k9_grid with K14's rectangle of tiles: the tile count as given, and
    a split only while the tiles leave SMs idle, of whole 128-site steps
    and at least 16 of them a range, the ranges covering [0, s_max) with
    none empty, the blocks within two waves of 132."""
    tiles = _rect_tiles(h, r0, r1)
    got, splits, split_len = port_pair._k9_grid(h, nwin, s_max, None,
                                                tiles=tiles)
    assert got == tiles and 1 <= splits <= GRID_YZ and nwin <= GRID_YZ
    if splits == 1:
        assert split_len >= s_max
        return
    assert tiles * nwin < SM and tiles * nwin * splits <= 2 * SM
    assert split_len % port_pair._K9_MMA_STAGE == 0
    assert split_len >= port_pair._K9_MIN_SPLIT
    ranges = [(y * split_len, min(s_max, (y + 1) * split_len))
              for y in range(splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == s_max
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _k14_blocks(h: int):
    return sorted({b for b in ((0, h), (30, 97), (100, 300), (150, 160),
                               (h - 1, h)) if 0 <= b[0] < b[1] <= h})


@pytest.mark.parametrize("h, r0, r1", [
    (h, r0, r1) for h in (1, 77, 160, 512) for r0, r1 in _k14_blocks(h)])
def test_k14_tile_walk_writes_each_cell_once(h, r0, r1):
    """pair4.cu's kRect walk (:func:`_rect_walk`): each tile writes its
    rows below r1 at i - r0 and its columns below h, no mirror.  Every
    cell of [r0, r1) x [0, h) is written exactly once and nothing outside
    it, and a tile whose rows are its columns (staged once) lies on the
    diagonal."""
    t = port_pair._K9_MMA_TILE
    hits = np.zeros((r1 - r0, h), np.int64)
    for i0, j0 in _rect_walk(h, r0, r1):
        assert r0 <= i0 < r1 and 0 <= j0 < h
        rows = np.arange(i0, min(i0 + t, r1))
        cols = np.arange(j0, min(j0 + t, h))
        np.add.at(hits, (rows[:, None] - r0, cols[None, :]), 1)
        if i0 == j0:
            assert r0 % t == 0
    np.testing.assert_array_equal(hits, np.ones_like(hits))


@pytest.mark.parametrize("s0, s1, P", [
    (0, 16176, 9), (0, 16176, 1), (0, 1, 1), (3, 4, 2), (5, 1029, 33),
    (0, 16896, 1), (7, 70007, 1), (0, 262144, 4), (1, 33666, 1)])
def test_k12_lanes_fill_the_card_and_cover_each_site(sms, s0, s1, P):
    """K12's blocks of 4 * lanes sites of one group each: at least two a SM
    whenever 32-site blocks give them, 16 lanes whenever their blocks give
    four, and each site of [s0, s1) counted by one lane once."""
    n = s1 - s0
    lanes = port_counts._k12_lanes(n, P, None)
    assert lanes in (8, 16)
    blocks = -(-n // (4 * lanes)) * P
    if -(-n // 32) * P >= 2 * SM:
        assert blocks >= 2 * SM
    assert (lanes == 16) == (-(-n // 64) * P >= 4 * SM)
    sites = np.concatenate([
        s0 + b * 4 * lanes + 4 * np.arange(lanes)[:, None] + np.arange(4)
        for b in range(-(-n // (4 * lanes)))]).ravel()
    sites = sites[sites < s1]
    np.testing.assert_array_equal(np.sort(sites), np.arange(s0, s1))


def test_k12_lanes_run_h_span(sms):
    """Run H's span: 16,176 sites of 9 classes in 2,277 blocks of 64
    sites; one class alone in 506 blocks of 32."""
    assert port_counts._k12_lanes(16176, 9, None) == 16
    assert port_counts._k12_lanes(16176, 1, None) == 8


@pytest.mark.parametrize("h, w", [(1, 0), (1, 7), (13, 10), (512, 32)])
def test_raw_span_size_tells_the_width(h, w):
    """The raw upload's rows pad to a 16-byte stride, and its size still
    differs for every width, so raw_span_views refuses every other width
    without reading the buffer."""
    sizes = {}
    for s in range(1, 400):
        ld, size = port_transfer._raw_layout(h, s, w)
        assert ld % 16 == 0 and s <= ld < s + 16
        assert size not in sizes, (s, sizes.get(size))
        sizes[size] = s


# ------------------------------------------- numpy models of the kernels

def _words(codes: np.ndarray) -> np.ndarray:
    """int8 [..., 4k] -> uint32 [..., k], site 4q + b in byte b of word q
    (the little-endian fragment registers)."""
    return np.ascontiguousarray(codes).view(np.uint32)


def decode(x: np.ndarray):
    """pair4.cu k9::decode on uint32 words of 4 codes: the 4 one-hot planes
    and the called plane, each byte 0 or 1."""
    x = x.astype(np.uint32)
    called = ~(x >> 7) & LOW
    x1 = x >> 1
    t = (x1 & np.uint32(0x7E7E7E7E)) + np.uint32(0x7E7E7E7E)
    ia = ~(t >> 7) & LOW
    oh = [ia & ~x & ~x1, ia & x & ~x1, ia & ~x & x1, ia & x & x1]
    return oh, called


def _bytes(planes: np.ndarray) -> np.ndarray:
    return planes.view(np.uint8).astype(np.int64)


def k9_model(a: np.ndarray, first: np.ndarray, n: np.ndarray):
    """K9 as the kernel counts it: each window's sites padded with -1 to
    whole words, decoded in registers, and the five 0/1 Grams."""
    H = a.shape[0]
    m = np.zeros((len(first), H, H), np.int64)
    s = np.zeros_like(m)
    for w, (f, k) in enumerate(zip(first, n)):
        cols = np.full((H, -(-max(int(k), 1) // 32) * 32), -1, np.int8)
        cols[:, :k] = a[:, f:f + k]
        oh, called = decode(_words(cols))
        c = _bytes(called)
        s[w] = c @ c.T
        match = sum(_bytes(o) @ _bytes(o).T for o in oh)
        m[w] = s[w] - match
    return m, s


def k12_model(a: np.ndarray, s0: int, s1: int, mask: np.ndarray,
              slots: int = 32) -> np.ndarray:
    """K12 as the kernel counts it: each class's rows dealt over row slots,
    4 sites a word, the one-hot planes added as packed byte lanes and
    widened every 255 rows, the slots summed."""
    H = a.shape[0]
    n = s1 - s0
    cols = np.full((H, -(-n // 4) * 4), -1, np.int8)
    cols[:, :n] = a[:, s0:s1]
    words = _words(cols)                                  # [H, n/4]
    out = np.zeros((n, mask.shape[0], 4), np.int64)
    for p, row_mask in enumerate(mask):
        rows = np.flatnonzero(row_mask)
        for slot in range(slots):
            mine = rows[slot::slots]
            for c0 in range(0, len(mine), 255):
                acc = np.zeros((4, words.shape[1]), np.uint32)
                for r in mine[c0:c0 + 255]:
                    oh, _ = decode(words[r])
                    for code in range(4):
                        acc[code] += oh[code]
                lanes = acc.view(np.uint8).reshape(4, -1)[:, :n]
                out[:, p, :] += lanes.T.astype(np.int64)
    return out


def messy(H: int, S: int, seed: int) -> np.ndarray:
    """Codes 0..3, -1 missing, and -7, 5 and 127 (outside the alphabet:
    -7 missing, 5 and 127 called but matching nothing)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    hit = rng.random((H, S))
    a[hit < 0.1] = -1
    for k, code in enumerate((-7, 5, 127)):
        a[(hit >= 0.1 + 0.03 * k) & (hit < 0.13 + 0.03 * k)] = code
    return a


def test_decode_planes_of_every_code():
    """Every int8 code: one-hot c exactly for code c in 0..3, called for
    code >= 0; each byte decodes alone, whatever its neighbours hold."""
    codes = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    rng = np.random.default_rng(3)
    for shift in range(4):
        block = rng.integers(-128, 128, size=(256, 4)).astype(np.int8)
        block[:, shift] = codes
        oh, called = decode(_words(block).ravel())
        got = [_bytes(o).reshape(256, 4)[:, shift] for o in oh]
        for c in range(4):
            np.testing.assert_array_equal(got[c], (codes == c).astype(int))
        np.testing.assert_array_equal(
            _bytes(called).reshape(256, 4)[:, shift], (codes >= 0))


def _jax_pair(a, first, n):
    s_max = max(int(n.max()), 1)
    wa, valid = jax_pair.gather_window_batch(jnp.asarray(a), first, n, s_max)
    m, s = jax_pair.pairwise_counts(wa, valid)
    return np.asarray(m), np.asarray(s)


def _edge_windows(S: int, rng):
    n = np.minimum([0, 1, 31, 33, 95, S - 2], S - 2).astype(np.int32)
    first = (2 * rng.integers(0, (S - n) // 2) + 1).astype(np.int32)
    return first, n


@pytest.mark.parametrize("H, S", [(1, 101), (15, 203), (16, 77),
                                  (17, 98), (65, 131), (129, 67)])
def test_k9_model_and_plain_match_jax(H, S):
    """The register-decode model and the plain K9 against JAX
    ``pairwise_counts`` at the 128-row tile's edge shapes: windows at odd
    starts whose lengths are not multiples of 32, S not a multiple of 4,
    codes -7, -1, 5 and 127."""
    a = messy(H, S, H + S)
    first, n = _edge_windows(S, np.random.default_rng(H))
    want_m, want_s = _jax_pair(a, first, n)
    mm, ms = k9_model(a, first, n)
    np.testing.assert_array_equal(mm, want_m)
    np.testing.assert_array_equal(ms, want_s)
    m, s = port_pair.pair_counts_4state(torch.from_numpy(a),
                                        torch.from_numpy(first),
                                        torch.from_numpy(n))
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_array_equal(s.numpy(), want_s)


@pytest.mark.parametrize("H, S, s0, s1", [
    (77, 1003, 0, 1003), (77, 1003, 3, 18), (33, 517, 1, 2),
    (5, 1, 0, 1), (129, 131, 5, 131), (600, 37, 2, 35)])
def test_k12_model_and_plain_match_jax(H, S, s0, s1):
    """The byte-lane model and the plain K12 against JAX
    ``site_pop_counts`` on a partition with a 33-row class (when H allows),
    with s0 / s1 not multiples of 4 or 16, codes -7, -1, 5 and 127."""
    a = messy(H, S, 7 * H + S)
    rng = np.random.default_rng(H)
    cls = rng.integers(0, 4, H)
    cls[:min(33, H)] = 0
    mask = np.zeros((4, H), np.float32)
    mask[cls, np.arange(H)] = 1.0
    want = np.asarray(jax_counts.site_pop_counts(a[:, s0:s1], mask))
    np.testing.assert_array_equal(k12_model(a, s0, s1, mask), want)
    groups = port_pair.PopGroups(mask, torch.device("cpu"))
    for dt in (torch.uint16, torch.int32):
        out = torch.empty((s1 - s0, 4, 4), dtype=dt)
        port_counts.site_pop_counts_raw(torch.from_numpy(a), s0, s1, groups,
                                        out)
        np.testing.assert_array_equal(out.numpy().astype(np.int64), want)


def test_k12_model_widens_past_255_rows():
    """One class of 8,300 rows over 32 slots (259 rows each): the byte
    lanes widen before they wrap, as the plain K12 and JAX count."""
    a = messy(8300, 9, 5)
    mask = np.ones((1, 8300), np.float32)
    want = np.asarray(jax_counts.site_pop_counts(a, mask))
    assert -(-8300 // 32) > 255 and want.max() > 255
    np.testing.assert_array_equal(k12_model(a, 0, 9, mask), want)
    np.testing.assert_array_equal(
        port_counts.site_pop_counts_raw_plain(
            torch.from_numpy(a), 0, 9, torch.from_numpy(mask)).numpy(), want)


# ----------------------------------------- K18 on K12's row-slot loop

def k18_model(a: np.ndarray, mask: np.ndarray, lanes: int = 8,
              slots: int | None = None) -> np.ndarray:
    """K18 as the kernel counts it: the classes the wrapper builds (none in
    no mask row), a block's 4 * lanes sites, each class's rows dealt over
    the row slots, 4 rows at a time, the called plane added as packed byte
    lanes and widened once a slot has 252 rows in them, the slots summed;
    each class's counts folded into the block's mask rows, 64 at a time,
    where its bits say so."""
    H, S = a.shape
    P = mask.shape[0]
    slots = 256 // lanes if slots is None else slots
    perm, offs, C, bits = (x.numpy() if isinstance(x, torch.Tensor) else x
                           for x in port_counts._nonmissing_classes(
                               mask, torch.device("cpu")))
    bits = np.asarray(bits)
    assert C == bits.shape[0] and offs[-1] == perm.shape[0]
    cols = np.full((H, -(-S // (4 * lanes)) * 4 * lanes), -1, np.int8)
    cols[:, :S] = a
    words = _words(cols)                                  # [H, S/4]
    out = np.zeros((cols.shape[1], P), np.int64)
    for c in range(C):
        rows = perm[offs[c]:offs[c + 1]]
        cnt = np.zeros(words.shape[1] * 4, np.int64)
        for slot in range(slots):
            acc = np.zeros(words.shape[1], np.uint32)
            packed = 0
            mine = rows[slot::slots]
            for u0 in range(0, max(len(mine), 1), 4):
                for r in mine[u0:u0 + 4]:
                    acc += ~(words[r] >> np.uint32(7)) & LOW
                packed += 4
                if u0 + 4 >= len(mine) or packed > 255 - 4:
                    cnt += acc.view(np.uint8).astype(np.int64)
                    acc[:] = 0
                    packed = 0
        for p0 in range(0, P, 64):
            for p in range(p0, min(P, p0 + 64)):
                if bits[c, p]:
                    out[:, p] += cnt
    return out[:S]


def _k18_masks(H: int, rng) -> dict:
    """Masks K18 must fold: a partition, overlapping rows with rows in no
    mask and an all-zero mask row, one mask row of every row, and 70
    overlapping rows (two 64-row fold chunks)."""
    part = np.zeros((4, H))
    part[rng.integers(0, 4, H), np.arange(H)] = 1.0
    over = (rng.random((6, H)) < 0.4).astype(np.float64)
    over[2] = 0.0
    over[:, :min(5, H)] = 0.0
    wide = (rng.random((70, H)) < 0.2).astype(np.float64)
    return {"partition": part, "overlap, none, zero row": over,
            "one row": np.ones((1, H)), "70 rows": wide}


def _jax_nonmissing(a: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The JAX site_nonmissing a mask row at a time (XLA's CPU dot takes no
    bf16 x bf16 -> f32 product of several rows)."""
    return np.concatenate([np.asarray(jax_counts.site_nonmissing(
        a, mask[p:p + 1].astype(np.float32))) for p in range(mask.shape[0])],
        axis=1)


@pytest.mark.parametrize("H, S, lanes", [
    (77, 1003, 8), (77, 1003, 16), (600, 37, 8), (129, 131, 16),
    (5, 1, 8), (33, 517, 16)])
def test_k18_model_and_plain_match_jax(H, S, lanes):
    """The one-plane byte-lane model with the class fold, and the plain K18
    on an odd-stride view, against JAX ``site_nonmissing``: codes -7..127,
    S not a multiple of 4 * lanes, masks with overlapping rows, rows in no
    mask, an all-zero mask row and more than 64 rows; exact."""
    a = messy(H, S, 11 * H + S)
    rng = np.random.default_rng(H + S)
    big = torch.full((H, S + 8 + (S + 1) % 2), -1, dtype=torch.int8)
    big[:, 3:3 + S] = torch.from_numpy(a)
    view = big[:, 3:3 + S]
    assert view.stride(0) % 2 == 1
    for name, mask in _k18_masks(H, rng).items():
        want = _jax_nonmissing(a, mask)
        np.testing.assert_array_equal(k18_model(a, mask, lanes), want, name)
        np.testing.assert_array_equal(
            port_counts.site_nonmissing(view, mask).numpy(), want, name)


def test_k18_model_widens_past_255_rows():
    """One class of 600 rows: in one row slot its byte lanes pass 255 and
    must widen before they wrap (and over the kernel's 32 slots too)."""
    a = messy(600, 13, 6)
    mask = np.ones((1, 600))
    want = _jax_nonmissing(a, mask)
    assert want.max() > 255
    for slots in (1, 32):
        np.testing.assert_array_equal(k18_model(a, mask, slots=slots), want)


def test_k18_classes_leave_out_rows_in_no_mask():
    """The cached class build: rows in no mask row are not in perm, each
    class's bits are its rows' membership; a mask that is not 0/1 raises
    ValueError there and in the wrapper, as does one not [P, H]."""
    rng = np.random.default_rng(4)
    mask = (rng.random((3, 40)) < 0.3).astype(np.float64)
    mask[:, :7] = 0.0
    perm, offs, C, bits = port_counts._nonmissing_classes(
        mask, torch.device("cpu"))
    perm, offs, bits = perm.numpy(), offs.numpy(), bits.numpy()
    assert sorted(perm.tolist()) == np.flatnonzero(mask.any(axis=0)).tolist()
    assert bits.shape == (C, 3) and bits.any(axis=1).all()
    for c in range(C):
        for r in perm[offs[c]:offs[c + 1]]:
            np.testing.assert_array_equal(mask[:, r], bits[c])
    a = torch.zeros((40, 5), dtype=torch.int8)
    for bad in (mask * 2, mask[:, :39]):
        with pytest.raises(ValueError):
            port_counts.site_nonmissing(a, bad)
    with pytest.raises(ValueError):
        port_counts._nonmissing_classes(mask * 2, torch.device("cpu"))


# ----------------------------------- the plain K14 against the JAX mesh

@pytest.fixture(scope="module")
def jmesh():
    m = jax_mesh.make_mesh()
    assert m.devices.size == 8
    return m


@pytest.mark.parametrize("h", [1, 77, 160, 512])
def test_k14_model_and_plain_match_jax_tp(jmesh, h):
    """The plain K14 on an odd-stride view at every row block of
    :func:`_k14_blocks`, and the rectangle walk over the register-decode
    K9 model, against the JAX ``mesh.sharded_pair_counts_tp`` on the
    8-device CPU mesh (as tests/test_torch_mesh.py runs it): windows at
    odd starts of 0, 1, 31, 33 and 95 sites, codes -7..127; exact."""
    S = 101 if h == 512 else 203
    a = messy(h, S, 3 * h + 1)
    first, n = _edge_windows(S, np.random.default_rng(h))
    want_m, want_s = jax_mesh.sharded_pair_counts_tp(a, first, n, jmesh,
                                                     s_max=256)
    mm, ms = k9_model(a, first, n)
    big = torch.full((h, S + 10), -1, dtype=torch.int8)
    big[:, 5:5 + S] = torch.from_numpy(a)
    view = big[:, 5:5 + S]
    assert view.stride(0) % 2 == 1
    f, k = torch.from_numpy(first), torch.from_numpy(n)
    t = port_pair._K9_MMA_TILE
    for r0, r1 in _k14_blocks(h):
        m, s = port_pair.pair_counts_4state_rows(view, f, k, r0, r1)
        np.testing.assert_array_equal(m.numpy(), want_m[:, r0:r1])
        np.testing.assert_array_equal(s.numpy(), want_s[:, r0:r1])
        got = np.full((2, len(first), r1 - r0, h), -1, np.int64)
        for i0, j0 in _rect_walk(h, r0, r1):
            i1, j1 = min(i0 + t, r1), min(j0 + t, h)
            got[0, :, i0 - r0:i1 - r0, j0:j1] = mm[:, i0:i1, j0:j1]
            got[1, :, i0 - r0:i1 - r0, j0:j1] = ms[:, i0:i1, j0:j1]
        np.testing.assert_array_equal(got[0], want_m[:, r0:r1])
        np.testing.assert_array_equal(got[1], want_s[:, r0:r1])
