"""The redesigned K1 (pair_v3.cu, wire-v3 pair counts) and K13 (wire-v2
pair counts) on the CPU: numpy models of their shared tile body — the
closed-form schedule of upper-triangle tile pairs with the mirrored store,
the staging of a window's segments (funnel-shift realignment, zeros past
each segment's end, steps of 32 words, each word split into the called
sites' reference and alternate bits), and the tensor-core inner step's
AND-only products — against the JAX functions on seeded numpy inputs,
exactly.  The kernels themselves run only on the card
(chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer

from .test_torch_pair_v2 import _jax_v2
from .test_torch_pairdist import _case, _jax_flush

PAIR_TILE, STAGE_WORDS, MMA_WORDS = 64, 32, 8
SCHEDULE_H = (1, 12, 40, 63, 64, 65, 77, 160, 512)


# ------------------------------------------------------------------ model

def tile_pair(p: int, T: int) -> tuple[int, int]:
    """pair_v3.cu tile_pair: pair p of the T (T + 1) / 2 tile pairs
    ti <= tj, row by row, from the closed form of its row counted from the
    last, corrected for rounding."""
    q = T * (T + 1) // 2 - 1 - p
    r = int((math.sqrt(8.0 * q + 1.0) - 1.0) * 0.5)
    while r * (r + 1) // 2 > q:
        r -= 1
    while (r + 1) * (r + 2) // 2 <= q:
        r += 1
    return T - 1 - r, T - 1 - (q - r * (r + 1) // 2)


def blocks(h: int, nwin: int):
    """(wl, i0, j0) of each block of K1's and K13's 1-D grid."""
    T = -(-h // PAIR_TILE)
    pairs = T * (T + 1) // 2
    for b in range(pairs * nwin):
        wl, p = divmod(b, pairs)
        ti, tj = tile_pair(p, T)
        yield wl, ti * PAIR_TILE, tj * PAIR_TILE


def padded_words(n: int) -> int:
    words = (n + 31) >> 5 if n > 0 else 0
    return -(-words // MMA_WORDS) * MMA_WORDS


class Segments:
    """A window's segments as pair_v3.cu's Segments: planes (uint32 [h,
    row words]; segment 2 has its partner plane), first bits, bit counts,
    and the staged word offsets of each."""

    def __init__(self, p0, p1, first, n):
        self.p0, self.p1 = p0, p1
        self.first, self.n = [int(x) for x in first], [int(x) for x in n]
        self.start = [0]
        for k in self.n:
            self.start.append(self.start[-1] + padded_words(k))


RAW_ROW = 60                    # staged words a row (pair_v3.cu kRawRow)


def step_runs(sg: Segments, v0: int):
    """step_run for each segment: (q4, n4, off, base) of its part of the
    step at v0 — n4 16-byte chunks of plane words from q4, at word off of a
    staged row, realigned word k at staged words base + k, base + k + 1."""
    runs, off = [], 0
    for s in range(3):
        n = sg.n[s]
        ka = max(v0, sg.start[s]) - sg.start[s]
        kr = min(min(v0 + STAGE_WORDS, sg.start[s + 1]) - sg.start[s],
                 (n + 31) >> 5 if n > 0 else 0)
        if kr <= ka:
            runs.append((0, 0, 0, 0))
            continue
        qa = (sg.first[s] >> 5) + ka
        qb = min(qa + kr - ka, (sg.first[s] + n - 1) >> 5)
        q4 = qa & ~3
        n4 = ((qb - q4) >> 2) + 1
        runs.append((q4, n4, off, off + qa - q4 - ka))
        off += 4 * n4
    assert off <= RAW_ROW
    return runs


def stage_step(sg: Segments, runs, rows, v3: bool, rng):
    """stage_step: the step's raw runs of ``rows`` (haplotypes past h are
    -1: not copied) as uint32 [2 planes, len(rows), RAW_ROW + 1], the rest
    of the stage random (shared memory is not cleared)."""
    rows = np.asarray(rows)
    live = rows >= 0
    raw = rng.integers(0, 1 << 32, size=(2, rows.size, RAW_ROW + 1),
                       dtype=np.uint64).astype(np.uint32)
    for s in range(3) if v3 else (2,):
        q4, n4, off, _ = runs[s]
        for plane, src in ((0, sg.p0[s]), (1, sg.p1 if s == 2 else None)):
            if src is None or not n4:
                continue
            raw[plane, live, off:off + 4 * n4] = \
                src[rows[live], q4:q4 + 4 * n4]
    return raw


def realigned(raw_rows, at: int, sh: int, rem: int) -> np.ndarray:
    """The kernel's realigned(): staged words at, at + 1 shifted down by
    sh, masked to the rem bits left in the segment (0 past its end)."""
    if rem <= 0:
        return np.zeros(raw_rows.shape[0], np.uint32)
    lo = raw_rows[:, at].astype(np.uint64)
    hi = raw_rows[:, at + 1].astype(np.uint64)
    w = ((lo | (hi << np.uint64(32))) >> np.uint64(sh)) & np.uint64(
        0xFFFFFFFF)
    return (w & np.uint64((1 << min(rem, 32)) - 1)).astype(np.uint32)


def ref_alt(raw, at: int, sh: int, rem: int, kind: int):
    """ref_alt: the called sites' reference bits R and alternate bits A of
    one realigned word of every staged row — kind 0 R = cB, A = 0; kind 1
    R = ~aC, A = aC; kind 2 R = cD & ~aD, A = aD."""
    w0 = realigned(raw[0], at, sh, rem)
    if kind == 0:
        return w0, np.zeros_like(w0)
    if kind == 1:
        keep = np.uint32((1 << min(max(rem, 0), 32)) - 1)
        return ~w0 & keep, w0
    a = realigned(raw[1], at, sh, rem)
    return w0 & ~a, a


def chunk_words(sg: Segments, runs, raw, v: int, kind: int):
    """R and A [rows, 8] of the 8 realigned words from axis position v (one
    m16n8k256 step, inside one segment)."""
    k0 = v - sg.start[kind]
    sh = sg.first[kind] & 31
    r = np.zeros((raw.shape[1], MMA_WORDS), np.uint32)
    a = np.zeros_like(r)
    for w in range(MMA_WORDS):
        k = k0 + w
        r[:, w], a[:, w] = ref_alt(raw, runs[kind][3] + k, sh,
                                   sg.n[kind] - 32 * k, kind)
    return r, a


def gram(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """m16n8k256 and.popc over words: popc(a_r & b_c) summed, int64."""
    return np.bitwise_count(a[:, None, :] & b[None, :, :]).sum(
        axis=2, dtype=np.int64)


def pair_tile(sg: Segments, h: int, i0: int, j0: int, nconst: int,
              v3: bool, rng):
    """pair_tile's arithmetic for one block: (m, s) of the 64 x 64 tile,
    step by step and 8-word product by product as the kernel sums them:
    s = nconst + G(C, C) over kinds 0 and 2 (C = R | A), m = G(A, R) +
    G(R, A) over kinds 1 and 2."""
    def rows_of(x0):
        r = np.arange(x0, x0 + PAIR_TILE)
        return np.where(r < h, r, -1)
    ri, rj = rows_of(i0), rows_of(j0)
    diag = i0 == j0
    m = np.zeros((PAIR_TILE, PAIR_TILE), np.int64)
    s = np.zeros_like(m)
    for v0 in range(0, sg.start[3], STAGE_WORDS):
        runs = step_runs(sg, v0)
        si = stage_step(sg, runs, ri, v3, rng)
        sj = si if diag else stage_step(sg, runs, rj, v3, rng)
        nk = min(STAGE_WORDS, sg.start[3] - v0)
        for c in range(0, nk, MMA_WORDS):
            v = v0 + c
            kind = (v >= sg.start[1]) + (v >= sg.start[2]) if v3 else 2
            r_i, a_i = chunk_words(sg, runs, si, v, kind)
            r_j, a_j = chunk_words(sg, runs, sj, v, kind)
            if kind != 1:
                s += gram(r_i | a_i, r_j | a_j)
            if kind != 0:
                m += gram(a_i, r_j) + gram(r_i, a_j)
    live = (ri >= 0)[:, None] & (rj >= 0)[None, :]
    return np.where(live, m, 0), np.where(live, nconst + s, 0)


def store(out_m, out_s, written, wl, i0, j0, m, s, h):
    """The epilogue's stores: the tile at rows i0.., and off the diagonal
    its transpose at rows j0.., each cell counted in ``written``."""
    ni, nj = min(PAIR_TILE, h - i0), min(PAIR_TILE, h - j0)
    out_m[wl, i0:i0 + ni, j0:j0 + nj] = m[:ni, :nj]
    out_s[wl, i0:i0 + ni, j0:j0 + nj] = s[:ni, :nj]
    written[wl, i0:i0 + ni, j0:j0 + nj] += 1
    if i0 != j0:
        out_m[wl, j0:j0 + nj, i0:i0 + ni] = m[:ni, :nj].T
        out_s[wl, j0:j0 + nj, i0:i0 + ni] = s[:ni, :nj].T
        written[wl, j0:j0 + nj, i0:i0 + ni] += 1


def words_of(plane: torch.Tensor) -> np.ndarray:
    return plane.numpy().view(np.uint32)


def v3_segments(wire, w: int) -> tuple[Segments, int]:
    meta = wire.meta.numpy()
    sg = Segments([words_of(wire.cB), words_of(wire.aC), words_of(wire.cD)],
                  words_of(wire.aD), meta[0:6:2, w], meta[1:6:2, w])
    return sg, int(meta[6, w])


def v2_segments(wire, w: int) -> tuple[Segments, int]:
    c = words_of(wire.called)
    return Segments([c, c, c], words_of(wire.alt),
                    [0, 0, int(wire.first[w])],
                    [0, 0, int(wire.n_sites[w])]), 0


def model_counts(wire, w0: int, nwin: int, v3: bool):
    """K1 (v3) or K13 over windows w0 .. w0 + nwin - 1: int32 [nwin, H, H]
    m and s, every cell written exactly once."""
    h = wire.h
    out_m = np.full((nwin, h, h), -1, np.int64)
    out_s = np.full((nwin, h, h), -1, np.int64)
    written = np.zeros((nwin, h, h), np.int64)
    segments = v3_segments if v3 else v2_segments
    rng = np.random.default_rng(w0)
    for wl, i0, j0 in blocks(h, nwin):
        sg, nconst = segments(wire, w0 + wl)
        m, s = pair_tile(sg, h, i0, j0, nconst, v3, rng)
        store(out_m, out_s, written, wl, i0, j0, m, s, h)
    assert (written == 1).all()
    return (torch.from_numpy(out_m.astype(np.int32)),
            torch.from_numpy(out_s.astype(np.int32)))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("h", SCHEDULE_H)
def test_tile_pairs_and_mirror_write_every_cell_once(h):
    """The 1-D grid's tile pairs are the upper triangle, row by row, each
    once, and the mirrored store writes every (w, i, j) exactly once."""
    nwin = 3
    T = -(-h // PAIR_TILE)
    got = [tile_pair(p, T) for p in range(T * (T + 1) // 2)]
    assert got == [(a, b) for a in range(T) for b in range(a, T)]
    written = np.zeros((nwin, h, h), np.int64)
    zero = np.zeros((PAIR_TILE, PAIR_TILE), np.int64)
    sink = np.zeros((nwin, h, h), np.int64)
    for wl, i0, j0 in blocks(h, nwin):
        store(sink, sink, written, wl, i0, j0, zero, zero, h)
    np.testing.assert_array_equal(written, 1)


def test_tile_pair_closed_form_at_large_t():
    """The float square root's rounding is corrected: every pair of a
    grid far past any real H maps back to its (ti, tj)."""
    T = 4_000
    for p in [0, 1, T - 1, T, 3 * T + 7] + list(
            range(T * (T + 1) // 2 - 50, T * (T + 1) // 2)):
        ti, tj = tile_pair(p, T)
        assert 0 <= ti <= tj < T
        assert ti * T - ti * (ti - 1) // 2 + (tj - ti) == p


LENGTHS = (0, 1, 31, 32, 33, 625, 1_100)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("word0", [0, 3])
def test_staging_realigns_each_segment_to_bit_0(n, word0):
    """Segments starting at every bit 0..31 (of word ``word0``) and of
    every length, behind short segments on wire v3: the raw runs of each
    32-word step fit a staged row, and the words realigned from them as
    fragments load are the ``_gather_bits`` gather of the unpacked planes
    split into reference and alternate bits, then zeros to the segment's
    padded end, whatever the rest of the stage holds."""
    rng = np.random.default_rng(n + 97 * word0)
    h, words = 5, word0 + 40 + (n >> 5)
    words += -words % 4                    # plane rows are 16-byte runs
    p0 = rng.integers(0, 1 << 32, size=(h, words), dtype=np.uint64).astype(
        np.uint32)
    p1 = p0 & rng.integers(0, 1 << 32, size=(h, words),
                           dtype=np.uint64).astype(np.uint32)
    bits0 = port_transfer._bits(torch.from_numpy(p0.view(np.int32)))
    bits1 = port_transfer._bits(torch.from_numpy(p1.view(np.int32)))
    for sh in range(32):
        first = 32 * word0 + sh
        for seg, v3 in ((0, True), (1, True), (2, True), (2, False)):
            fs, ns = [0, 0, 0], [0, 0, 0]
            fs[seg], ns[seg] = first, n
            if v3:                      # short segments before this one
                for s in range(seg):
                    fs[s], ns[s] = 5 + 37 * s, 40 + 200 * s
            sg = Segments([p0, p0, p0], p1, fs, ns)
            lo, hi = sg.start[seg], sg.start[seg + 1]
            assert hi - lo == padded_words(n)
            R = np.zeros((h, hi - lo), np.uint32)
            A = np.zeros_like(R)
            for v0 in range(0, sg.start[3], STAGE_WORDS):
                runs = step_runs(sg, v0)
                raw = stage_step(sg, runs, np.arange(h), v3, rng)
                for v in range(max(v0, lo), min(v0 + STAGE_WORDS, hi),
                               MMA_WORDS):
                    R[:, v - lo:v - lo + MMA_WORDS], \
                        A[:, v - lo:v - lo + MMA_WORDS] = chunk_words(
                            sg, runs, raw, v, seg)
            R, A = (np.unpackbits(x.view(np.uint8), axis=1,
                                  bitorder="little") for x in (R, A))
            assert not (R & A).any()
            assert not (R | A)[:, n:].any()
            g0, g1 = (port_pair._gather_bits(
                b, torch.tensor([first]), torch.tensor([n]))[0].numpy()
                [:, :n].astype(np.uint8) for b in (bits0, bits1))
            if seg == 0:                # R = cB, A = 0
                want_r, want_a = g0, np.zeros_like(g0)
            elif seg == 1:              # R = ~aC, A = aC
                want_r, want_a = 1 - g0, g0
            else:                       # R = cD & ~aD, A = aD (inside cD)
                want_r, want_a = g0 & (1 - g1), g1
            np.testing.assert_array_equal(R[:, :n], want_r)
            np.testing.assert_array_equal(A[:, :n], want_a)


def _messy(h: int, seed: int):
    """Every wire-v3 site class: multi-allelic exceptions, all-missing,
    monomorphic with and without missing calls, clean biallelic; windows
    that overlap, one empty, one all-monomorphic, long ones."""
    rng = np.random.default_rng(seed)
    S = 2_600
    a = rng.integers(0, 2, size=(h, S)).astype(np.int8)
    a[rng.random((h, S)) < 0.1] = -1
    for s in rng.choice(S, size=S // 30, replace=False):
        a[rng.integers(0, h, 3), s] = rng.integers(2, 4)
    a[:, 100:140] = -1
    a[:, 200:420] = 1                              # monomorphic, complete
    a[:, 420:500] = 0
    a[rng.integers(0, h, 80), np.arange(420, 500)] = -1
    a[:, 600:800] = rng.integers(0, 2, size=(h, 200))   # clean biallelic
    first = np.array([0, 7, 150, 205, 210, 333, 600, 601, 1000, 1200],
                     np.int32)
    n = np.array([1_200, 90, 0, 200, 1_300, 700, 200, 33, 1_600, 1_400],
                 np.int32)
    return a, first, np.minimum(n, S - first).astype(np.int32)


def _inputs(name: str):
    if name.startswith("messy"):
        return _messy(int(name[5:]), 17)
    return _case(name)


V3_CASES = [("messy77", 0, 10), ("messy77", 3, 5), ("messy65", 1, 8),
            ("large_h", 0, 3), ("overlap", 2, 4), ("disjoint", 0, 6)]


@pytest.mark.parametrize("name, w0, nwin", V3_CASES)
def test_k1_tile_model_matches_jax_v3(name, w0, nwin):
    """The K1 model (tile pairs, staged segments, Gram forms with rC), then
    K2, == the JAX ``_fused_flush_pair_v3`` counts, from window w0."""
    a, first, n = _inputs(name)
    W, H = first.shape[0], a.shape[0]
    host, wire = _jax_flush(a, first, n, "tri")
    want_m, want_s = jax_pair._tri_unpack(host, W, H)
    nwin = min(nwin, W - w0)
    m, s = model_counts(wire, w0, nwin, v3=True)
    port_pair.exception_patch(m, s, wire, w0)
    np.testing.assert_array_equal(m.numpy(), want_m[w0:w0 + nwin])
    np.testing.assert_array_equal(s.numpy(), want_s[w0:w0 + nwin])


@pytest.mark.parametrize("name, w0, nwin", V3_CASES)
def test_k13_tile_model_matches_jax_v2(name, w0, nwin):
    """The K13 model (segment 2 alone on the called / alt planes), then
    K2, == the JAX ``_fused_flush_pair_v2`` counts, from window w0."""
    a, first, n = _inputs(name)
    W, H = first.shape[0], a.shape[0]
    out, wire = _jax_v2(a, first, n, "tri")
    want_m, want_s = jax_pair._tri_unpack(out, W, H)
    nwin = min(nwin, W - w0)
    m, s = model_counts(wire, w0, nwin, v3=False)
    port_pair.exception_patch(m, s, wire, w0)
    np.testing.assert_array_equal(m.numpy(), want_m[w0:w0 + nwin])
    np.testing.assert_array_equal(s.numpy(), want_s[w0:w0 + nwin])


def test_and_only_products_equal_the_direct_counts():
    """The AND-only products of the tensor-core step equal the direct XOR
    counts on random planes with aD inside cD and aC fully called: with
    R = ~aC, G(aC, R) + G(R, aC) == popc(aC_i ^ aC_j) (kind 1); with R =
    cD & ~aD, G(aD, R) + G(R, aD) == popc((aD_i ^ aD_j) & cD_i & cD_j) and
    G(R | aD, R | aD) == popc(cD_i & cD_j) (kind 2).  The JAX Gram forms
    with the rC rank-1 term give the same counts."""
    rng = np.random.default_rng(5)

    def words(*shape):
        return rng.integers(0, 1 << 32, size=shape,
                            dtype=np.uint64).astype(np.uint32)
    aC, cD = words(40, 24), words(40, 24)
    aD = cD & words(40, 24)
    rC = np.bitwise_count(aC).sum(axis=1, dtype=np.int64)
    direct_c = np.bitwise_count(aC[:, None] ^ aC[None]).sum(
        axis=2, dtype=np.int64)
    np.testing.assert_array_equal(gram(aC, ~aC) + gram(~aC, aC), direct_c)
    np.testing.assert_array_equal(
        rC[:, None] + rC[None, :] - 2 * gram(aC, aC), direct_c)
    both = cD[:, None] & cD[None]
    direct_d = np.bitwise_count((aD[:, None] ^ aD[None]) & both).sum(
        axis=2, dtype=np.int64)
    rD = cD & ~aD
    np.testing.assert_array_equal(gram(aD, rD) + gram(rD, aD), direct_d)
    X = gram(aD, cD)
    np.testing.assert_array_equal(X + X.T - 2 * gram(aD, aD), direct_d)
    np.testing.assert_array_equal(gram(rD | aD, rD | aD), gram(cD, cD))


@pytest.mark.parametrize("v3", [True, False])
def test_empty_and_monomorphic_windows_write_only_nconst(v3):
    """A window with no staged words (empty, or on wire v3 all
    monomorphic and complete) writes m = 0 and s = nconst everywhere."""
    h = 70
    a = np.ones((h, 300), np.int8)
    a[:, 150:] = np.random.default_rng(1).integers(0, 2, size=(h, 150))
    first, n = np.array([0, 10, 150], np.int32), np.array([120, 0, 100],
                                                          np.int32)
    if v3:
        _, wire = _jax_flush(a, first, n, "tri")
    else:
        _, wire = _jax_v2(a, first, n, "tri")
    m, s = model_counts(wire, 0, 2, v3)
    assert not m.any()
    np.testing.assert_array_equal(s[0], 120)
    np.testing.assert_array_equal(s[1], 0)
