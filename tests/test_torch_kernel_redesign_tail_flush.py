"""The redesigned K20 (pair4.cu, the one-transfer flush pair counts) and
K10 (window_stats.cu, the window-stats tail) on the CPU: numpy models of
their arithmetic against the JAX functions on seeded numpy inputs.

K20: the span wire's words decoded into the called and one-hot bit planes
(the planes' own site order, sites outside the window masked in place),
the AND-only products of the 1-bit tensor-core step, and the tri-packed
store of the upper triangle's tiles (each row a run of j >= i, stored as
whole aligned 16-byte chunks and element by element at its two ends),
exactly, against the JAX
``_fused_flush_pair_counts`` and ``transfer.unpack_flush_buffer``.

K10: the mask's membership classes and the block means as class-pair
sums, against the JAX ``window_stats_step`` at the step tests' tolerances;
and the port's ``window_stats_tail_plain`` against a float32 replay of the
kernel's order, bit for bit.  The kernels themselves run only on the card
(chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu.kernels.window_stats import \
    window_stats_step as jax_step
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer
from genomics_general_tpu_torch.kernels import window_stats as port_ws

from .test_torch_kernel_redesign_pair_tiles import PAIR_TILE, tile_pair

STEP_WORDS, MMA_WORDS = 24, 8          # pair4.cu k20::kStepWords, kMmaWords
FLUSH_H = (1, 12, 63, 64, 65, 77, 160)
M55, MAA = np.uint32(0x55555555), np.uint32(0xAAAAAAAA)


# ------------------------------------------------------------ K20 model

def interleave_halves(x: np.ndarray) -> np.ndarray:
    """k20::interleave_halves: bit t (t < 16) to bit 2t, bit 16 + t to bit
    2t + 1."""
    x = x.astype(np.uint32)
    for sh, mask in ((8, 0x0000FF00), (4, 0x00F000F0), (2, 0x0C0C0C0C),
                     (1, 0x22222222)):
        t = (x ^ (x >> np.uint32(sh))) & np.uint32(mask)
        x = x ^ t ^ (t << np.uint32(sh))
    return x


def window_bits(q: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """k20::window_bits: the bits of words q inside sites [lo, hi)."""
    site = 32 * q[..., None].astype(np.int64) + np.arange(32)
    inside = (site >= lo) & (site < hi)
    return (inside.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(axis=-1).astype(np.uint32)


def decode_word(x0, x1, miss):
    """k20::decode_word: (oh_0..oh_3, c) of words with codes x0 (sites
    0..15), x1 (16..31) and miss bits (outside the window set)."""
    c = ~interleave_halves(miss)
    lo = (x0 & M55) | ((x1 & M55) << np.uint32(1))
    hi = ((x0 >> np.uint32(1)) & M55) | (x1 & MAA)
    return np.stack([c & ~hi & ~lo, c & ~hi & lo, c & hi & ~lo, c & hi & lo,
                     c])


def plane_site(q: int, bit: int) -> int:
    """The site of bit ``bit`` of a plane's word q (the planes' order)."""
    return 32 * q + (bit >> 1) + 16 * (bit & 1)


def flush_meta(buf: np.ndarray, sp: int, h: int, wp: int):
    base = h * (sp // 4 + sp // 8)
    meta = np.frombuffer(buf[base:base + 8 * wp].tobytes(), np.int32)
    return meta[:wp], meta[wp:]


def window_span(f: int, n: int, s_max: int, sp: int):
    """The kernel's [lo, hi) of a window and its words from q0 (even)."""
    n = min(n, s_max)
    lo, hi = max(f, 0), min(f + max(n, 0), sp)
    q0 = (lo >> 6) << 1
    words = -(-hi // 32) - q0 if hi > lo else 0
    return lo, hi, q0, words


def stage_window(buf: np.ndarray, sp: int, h: int, f: int, n: int,
                 s_max: int) -> np.ndarray:
    """The window's planes as the kernel stages them, steps of STEP_WORDS
    words laid end to end: uint32 [h, 5, steps * STEP_WORDS].  Each row's
    16 code bytes and 8 miss bytes of a word pair as stage_step loads them
    (bytes past the row's end: codes 0, miss set)."""
    c4, m8 = sp // 4, sp // 8
    lo, hi, q0, words = window_span(f, n, s_max, sp)
    steps = -(-words // STEP_WORDS)
    q = q0 + np.arange(steps * STEP_WORDS)
    codes = np.zeros((h, 8 * q.shape[0] + 8), np.uint8)
    miss = np.full((h, 4 * q.shape[0] + 4), 0xFF, np.uint8)
    cb = buf[:h * c4].reshape(h, c4)[:, 8 * q0:]
    mb = buf[h * c4:h * (c4 + m8)].reshape(h, m8)[:, 4 * q0:]
    codes[:, :cb.shape[1]] = cb[:, :codes.shape[1]]
    miss[:, :mb.shape[1]] = mb[:, :miss.shape[1]]
    cw = codes[:, :8 * q.shape[0]].view("<u4").reshape(h, -1, 2)
    mw = miss[:, :4 * q.shape[0]].view("<u4")
    mw = mw | ~window_bits(q, lo, hi)[None]
    return decode_word(cw[..., 0], cw[..., 1], mw).transpose(1, 0, 2)


def gram(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """G(x, y)[i, j] = popc(x_i & y_j) summed over words, as the
    m16n8k256 and.popc steps add it (8 words a step)."""
    both = x[:, None, :] & y[None, :, :]
    return np.unpackbits(both.view(np.uint8), axis=-1).sum(
        axis=-1, dtype=np.int64)


def tile_counts(planes: np.ndarray):
    """The AND-only forms: shared = G(c, c), mismatch = shared - sum_k
    G(oh_k, oh_k); int [h, h] each."""
    assert planes.shape[2] % MMA_WORDS == 0
    shared = gram(planes[:, 4], planes[:, 4])
    match = sum(gram(planes[:, k], planes[:, k]) for k in range(4))
    return shared - match, shared


def store_chunks(start: int, length: int, size: int):
    """k20::store_tile's tasks for a run of ``length`` elements of ``size``
    bytes at element ``start`` of a 16-byte aligned buffer: per 16-byte
    chunk q the run touches, (whole, element indices) — a whole chunk is
    one 16-byte store, the run's partial end chunks go element by
    element."""
    vec = 16 // size
    lead = (start * size) % 16 // size
    out = []
    for q in range(64 // vec + 1):
        e0 = q * vec - lead
        if e0 >= length:
            continue
        whole = e0 >= 0 and e0 + vec <= length
        out.append((whole, [start + e for e in range(max(0, e0),
                                                     min(e0 + vec, length))]))
    return out


def k20_model(buf: np.ndarray, sp: int, h: int, wp: int, s_max: int):
    """K20 over the whole flush, each block as the kernel runs it: the
    window's planes, the tile's counts, and the tri-packed store of each
    tile row's run in store_tile's chunks, into a sentinel-filled [wp, 2T]
    (every cell must be written exactly once)."""
    T = h * (h + 1) // 2
    size = 2 if s_max < (1 << 16) else 4
    out = np.full((wp, 2 * T), -1, np.int64)
    first, n = flush_meta(buf, sp, h, wp)
    tiles = -(-h // PAIR_TILE)
    for wl in range(wp):
        planes = stage_window(buf, sp, h, int(first[wl]), int(n[wl]), s_max)
        m, s = tile_counts(planes)
        for p in range(tiles * (tiles + 1) // 2):
            ti, tj = tile_pair(p, tiles)
            i0, j0 = ti * PAIR_TILE, tj * PAIR_TILE
            cols = min(PAIR_TILE, h - j0)
            for r in range(min(PAIR_TILE, h - i0)):
                i = i0 + r
                c0 = r if ti == tj else 0
                t0 = i * h - i * (i - 1) // 2 - i
                start = wl * 2 * T + t0 + j0 + c0
                for half, src in ((0, m), (T, s)):
                    for whole, elems in store_chunks(start + half,
                                                     cols - c0, size):
                        if whole:       # one aligned 16-byte store
                            assert len(elems) * size == 16
                            assert elems[0] * size % 16 == 0
                        for e in elems:
                            k = e - wl * 2 * T
                            assert out[wl, k] == -1, "a cell written twice"
                            out[wl, k] = src[i, j0 + c0 + e - start - half]
    assert (out >= 0).all(), "a cell no block writes"
    return out


def flush_input(H: int, S: int, seed: int, first, n, wp: int,
                min_bucket: int):
    """Codes 0..3 with 15 % missing and an all-missing block of sites."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.15] = -1
    a[:, 3:7] = -1
    first, n = np.asarray(first, np.int32), np.asarray(n, np.int32)
    buf, sp = port_transfer.pack_flush_buffer(a, first, n, wp, min_bucket)
    want, sp_jax = jax_transfer.pack_flush_buffer(a, first, n, wp,
                                                  min_bucket)
    assert sp == sp_jax
    np.testing.assert_array_equal(buf, want)
    return a, buf, sp


@pytest.mark.parametrize("off", range(32))
def test_k20_decode_matches_unpack(off):
    """The planes of a window starting at site offset ``off`` of a word
    (and of 64 + off, past the first word pair), with an s_max cut in the
    middle of a word: bit (q, b) of c is set exactly where site
    plane_site(q, b) lies in the window and is called, and of oh_k where
    its code is k; nothing outside the window, and every window site
    somewhere."""
    H, S, wp, s_max = 3, 700, 8, 333
    first = [off, 64 + off, off, 650 + off % 7]
    n = [600, 400, 7, 100]
    a, buf, sp = flush_input(H, S, off, first, n, wp, 8)
    al = port_transfer.unpack_flush_buffer(buf, sp, H, wp)[0].numpy()
    for f, k in zip(first, n):
        lo, hi, q0, words = window_span(f, k, s_max, sp)
        planes = stage_window(buf, sp, H, f, k, s_max)    # [H, 5, words]
        bits = (planes[..., None] >> np.arange(32, dtype=np.uint32)) & 1
        sites = plane_site(q0 + np.arange(planes.shape[2])[:, None],
                           np.arange(32)[None, :])         # [words, 32]
        inside = (sites >= lo) & (sites < hi)
        code = np.where(sites < sp, al[:, np.minimum(sites, sp - 1)], -1)
        called = inside[None] & (code >= 0)
        np.testing.assert_array_equal(bits[:, 4], called)
        for c in range(4):
            np.testing.assert_array_equal(bits[:, c], called & (code == c))
        np.testing.assert_array_equal(np.sort(sites[inside]),
                                      np.arange(lo, max(hi, lo)))


@pytest.mark.parametrize("H", FLUSH_H)
def test_k20_model_matches_jax_flush(H):
    """The decode, the AND-only forms and the tri-packed tile store over a
    whole flush equal the JAX one-transfer flush counts exactly: windows
    at odd starts, 0- and 1-site windows, one cut by s_max mid-word, one
    running to the last site, and pad windows (uint16; the int32 branch
    in the next test)."""
    S, wp, s_max = 1000, 16, 320
    first = [0, 5, 31, 33, 64, 100, 999, 600, 0, 7, 990]
    n = [320, 300, 1, 0, 250, 319, 1, 400, 1000, 64, 10]
    a, buf, sp = flush_input(H, S, H, first, n, wp, 8)
    want = np.asarray(jax_pair._fused_flush_pair_counts(
        jax.device_put(buf), sp, H, wp, s_max, 8))
    got = k20_model(buf, sp, H, wp, s_max)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    port = port_pair._fused_flush_pair_counts(torch.from_numpy(buf), sp, H,
                                              wp, s_max, 8)
    np.testing.assert_array_equal(port.numpy().astype(np.int64), got)


def test_k20_model_int32_branch():
    """s_max >= 2^16: int32 rows (4-byte elements in store_run), a window
    longer than one staging step (3 steps of 24 words)."""
    H, S, wp, s_max = 12, 3000, 8, 1 << 16
    first, n = [1, 40, 2999], [2000, 2960, 1]
    a, buf, sp = flush_input(H, S, 77, first, n, wp, 64)
    assert sp % 64 == 0             # the kernel's 16- and 8-byte loads
    want = np.asarray(jax_pair._fused_flush_pair_counts(
        jax.device_put(buf), sp, H, wp, s_max, 4))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(k20_model(buf, sp, H, wp, s_max), want)


# ------------------------------------------------------------- K10 model

def messy_masks(H: int, seed: int = 9):
    """Five populations over H rows (one of them a single haplotype that
    also lies in another, rows in none) and one of all rows."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 5, size=H)
    pm = np.zeros((5, H), np.float32)
    for p in range(4):
        pm[p, groups == p] = 1.0
    pm[4, 0] = 1.0
    return pm, np.ones((1, H), np.float32)


def k10_masks():
    """name -> (H, mask): the masks of chip_smoke's k10_edge_parity."""
    messy, everyone = messy_masks(40)
    rng = np.random.default_rng(77)
    frac = rng.choice(np.float32([0, 0.25, 0.5, 1, 0.3]), size=(3, 77))
    frac[:, :5] = 0.0                                   # rows in none
    frac[:, 5:9] = np.float32([0.5, 0.25, 1.0])[:, None]   # one class
    return {"messy": (40, messy), "one_population": (40, everyone),
            "every_row_its_own": (12, np.eye(12, dtype=np.float32)),
            "fractional": (77, frac.astype(np.float32))}


def step_input(H: int, seed: int):
    """Windows of 0, 1 and all-missing sites (no valid pair: NaN) beside
    ordinary ones, codes 0..3 with 10 % missing."""
    rng = np.random.default_rng(seed)
    S = 600
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    a[:, 100:140] = -1
    first = np.array([0, 10, 100, 150, 300, 599], np.int32)
    n = np.array([0, 1, 40, 200, 300, 1], np.int32)
    return a, first, n


def classes_of(pm: np.ndarray):
    """The membership classes, independently of TailClasses: per class
    its weight column and rows (ascending), classes in order of first
    row, the all-zero column dropped."""
    cols = [tuple(np.float32(x) + np.float32(0) for x in pm[:, i])
            for i in range(pm.shape[1])]
    order = []
    for c in cols:
        if any(x != 0 for x in c) and c not in order:
            order.append(c)
    rows = [[i for i, c in enumerate(cols) if c == k] for k in order]
    return [np.array(k, np.float32) for k in order], rows


def class_means(m, s, pm):
    """float64 block means from class-pair sums: [B, 2, P, P] (dxy,
    pooled) and Fst, in no particular order."""
    weights, rows = classes_of(pm)
    B, h, _ = m.shape
    P, C = pm.shape[0], len(rows)
    valid = (s > 0) & ~np.eye(h, dtype=bool)
    dist = np.where(valid, m / np.maximum(s, 1), 0.0)
    num = np.zeros((C, C, B))
    cnt = np.zeros((C, C, B))
    for ci, r in enumerate(rows):
        for cj, c in enumerate(rows):
            num[ci, cj] = dist[:, r][:, :, c].sum(axis=(1, 2))
            cnt[ci, cj] = valid[:, r][:, :, c].sum(axis=(1, 2))
    wt = np.array(weights, np.float32).reshape(C, P)
    out = np.zeros((B, 2, P, P))
    for a in range(P):
        for b in range(P):
            pooled = np.clip(wt[:, a] + wt[:, b], 0, 1)
            for kind, (u, v) in enumerate(((wt[:, a], wt[:, b]),
                                           (pooled, pooled))):
                uv = np.outer(u, v)
                keep = (uv > 0)[..., None]
                with np.errstate(invalid="ignore"):
                    out[:, kind, a, b] = (num * keep).sum(axis=(0, 1)) / \
                        (uv.astype(np.float64)[..., None] * cnt *
                         keep).sum(axis=(0, 1))
    n_pop = pm.astype(np.float64).sum(axis=1)
    w = n_pop[:, None] / (n_pop[:, None] + n_pop[None, :])
    pi = np.diagonal(out[:, 0], axis1=1, axis2=2)
    pi_s = w[None] * pi[:, :, None] + (1 - w[None]) * pi[:, None, :]
    return out, 1 - pi_s / out[:, 1]


def compare(got, want, rtol, atol=0.0, what=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", sorted(k10_masks()))
def test_k10_class_sums_match_jax_step(name):
    """The class decomposition (numpy, float64) and the port's K10 (its
    plain version on the CPU) against the JAX step's pi, dxy and Fst on
    the same counts: pi / dxy at rtol 1e-5, Fst at rtol 1e-4 / atol
    1e-5, NaN positions equal."""
    H, pm = k10_masks()[name]
    a, first, n = step_input(H, len(name))
    want = jax_step(a, first, n, pm, s_max=512)
    m, s = np.array(want["mismatch"]), np.array(want["shared"])
    means, fst = class_means(m, s, pm)
    with np.errstate(invalid="ignore"):
        compare(means[:, 0], want["dxy"], 1e-5, what="dxy (model)")
        compare(fst, want["fst"], 1e-4, 1e-5, what="fst (model)")
    pi, dxy, fst = port_ws.window_stats_tail(
        torch.from_numpy(m), torch.from_numpy(s), torch.from_numpy(pm))
    compare(pi.numpy(), want["pi"], 1e-5, what="pi")
    compare(dxy.numpy(), want["dxy"], 1e-5, what="dxy")
    compare(fst.numpy(), want["fst"], 1e-4, 1e-5, what="fst")
    assert np.isnan(dxy.numpy()[0]).all()          # the 0-site window


def test_tail_classes_layout():
    """TailClasses: classes in order of first row, rows ascending within
    a class, the all-zero column dropped, pos the inverse of members."""
    H, pm = k10_masks()["fractional"]
    weights, rows = classes_of(pm)
    cls = port_ws.TailClasses(pm, torch.device("cpu"))
    assert cls.C == len(rows)
    np.testing.assert_array_equal(cls.members, np.concatenate(rows))
    np.testing.assert_array_equal(np.diff(cls.starts),
                                  [len(r) for r in rows])
    np.testing.assert_array_equal(cls.weights, np.stack(weights))
    ints = cls.ints.numpy()
    pos = ints[cls.n_rows + cls.C + 1:]
    assert (pos[:5] == -1).all()
    np.testing.assert_array_equal(pos[cls.members], np.arange(cls.n_rows))
    np.testing.assert_array_equal(cls.n_pop, port_ws._fixed_sum(
        torch.from_numpy(pm)).numpy())


def f32_replay(m, s, pm):
    """window_stats.cu's order in numpy float32 scalars: each row (class
    order) over each column class, lane p % 32 adding term p, then the
    lanes' tree; each class's rows likewise; each block mean over its
    class pairs ci C + cj; population sizes over 1024 lanes."""
    f32 = np.float32

    def lanes_sum(terms, keep, n_lanes=32):
        x = np.where(keep, np.asarray(terms, f32), f32(0)).astype(f32)
        x = np.concatenate([x, np.zeros(-len(x) % n_lanes or
                                        (0 if len(x) else n_lanes), f32)])
        lanes = np.zeros(n_lanes, f32)
        for r in range(len(x) // n_lanes):
            lanes = lanes + x[r * n_lanes:(r + 1) * n_lanes]
        stride = n_lanes // 2
        while stride:
            lanes = lanes[:stride] + lanes[stride:2 * stride]
            stride //= 2
        return lanes[0]

    weights, rows = classes_of(pm)
    members = [i for r in rows for i in r]
    C, P, B, h = len(rows), pm.shape[0], m.shape[0], m.shape[1]
    pi = np.zeros((B, P), f32)
    dxy = np.zeros((B, P, P), f32)
    fst = np.zeros((B, P, P), f32)
    n_pop = [lanes_sum(pm[a], [True] * h, 1024) for a in range(P)]
    for w in range(B):
        part = {}
        for i in members:
            for cj, cols in enumerate(rows):
                ok = [j != i and s[w, i, j] > 0 for j in cols]
                d = [f32(m[w, i, j]) / f32(s[w, i, j]) if k else f32(0)
                     for j, k in zip(cols, ok)]
                part[i, cj] = (lanes_sum(d, ok), sum(ok))
        sn = [[lanes_sum([part[i, cj][0] for i in rows[ci]],
                         [True] * len(rows[ci])) for cj in range(C)]
              for ci in range(C)]
        sc = [[sum(part[i, cj][1] for i in rows[ci]) for cj in range(C)]
              for ci in range(C)]
        means = np.zeros((2, P, P), f32)
        for kind in range(2):
            for a in range(P):
                for b in range(P):
                    nums, dens, keep = [], [], []
                    for ci in range(C):
                        for cj in range(C):
                            if kind:
                                u = np.clip(f32(weights[ci][a] +
                                                weights[ci][b]), 0, 1)
                                v = np.clip(f32(weights[cj][a] +
                                                weights[cj][b]), 0, 1)
                            else:
                                u, v = weights[ci][a], weights[cj][b]
                            uv = f32(f32(u) * f32(v))
                            keep.append(uv > 0)
                            nums.append(sn[ci][cj])
                            dens.append(f32(uv * f32(sc[ci][cj])))
                    with np.errstate(invalid="ignore", divide="ignore"):
                        means[kind, a, b] = f32(lanes_sum(nums, keep) /
                                                lanes_sum(dens, keep))
        dxy[w] = means[0]
        pi[w] = np.diagonal(means[0])
        for a in range(P):
            for b in range(P):
                wt = f32(n_pop[a] / f32(n_pop[a] + n_pop[b]))
                ps = f32(f32(wt * means[0, a, a]) +
                         f32(f32(f32(1) - wt) * means[0, b, b]))
                with np.errstate(invalid="ignore", divide="ignore"):
                    fst[w, a, b] = f32(f32(1) - f32(ps / means[1, a, b]))
    return pi, dxy, fst


@pytest.mark.parametrize("name", sorted(k10_masks()))
def test_k10_plain_repeats_kernel_order(name):
    """window_stats_tail_plain equals the float32 replay of the kernel's
    order bit for bit (NaN positions equal), on the pair counts of the
    NaN window and two more."""
    H, pm = k10_masks()[name]
    a, first, n = step_input(H, 3 + len(name))
    m, s = (x.numpy() for x in port_pair.pair_counts_4state(
        torch.from_numpy(a), torch.from_numpy(first[2:5]),
        torch.from_numpy(n[2:5])))
    got = port_ws.window_stats_tail_plain(
        torch.from_numpy(m), torch.from_numpy(s), torch.from_numpy(pm))
    for g, w, what in zip(got, f32_replay(m, s, pm), ("pi", "dxy", "fst")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)


def test_k10_classes_built_once_per_mask():
    """A mask tensor is read back once while unchanged: the same
    TailClasses for the same tensor, new ones after an in-place edit."""
    H, pm = k10_masks()["messy"]
    t = torch.from_numpy(pm.copy())
    dev = torch.device("cpu")
    first = port_ws.tail_classes(t, dev)
    assert port_ws.tail_classes(t, dev) is first
    t[0, 1] = 1.0 - t[0, 1]
    again = port_ws.tail_classes(t, dev)
    assert again is not first
    np.testing.assert_array_equal(
        again.members, port_ws.TailClasses(t.numpy(), dev).members)
