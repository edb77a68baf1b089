"""The redesigned K11 (window_stats.cu, the window pop counts) and K8
(abba.cu, the ABBA window sums) on the CPU: numpy models of their
schedules against the JAX functions on seeded numpy inputs.

K11: each row's window read as the aligned 16-byte vectors that cover it
(worked out from the row's own address, in a byte buffer standing for
device memory, so odd row strides and every start offset are covered),
the head and tail bytes forced to 0xff, the four-byte compares of
``count_word`` into byte-wise counters flushed every 60 vectors, the
block's (row, vector) items as its threads take them, and the sums by
membership class added to each class's populations, exactly, against the
JAX ``window_stats_step``'s ``pop_counts`` and the port's plain version.

K8: each lane on one fixed column pair (32 lanes of 8 rows at K = 8, 27
of 3 at K = 18), the lanes of a pair added in lane order and the
window's warps in warp order, from a 16-byte boundary and from 8 bytes
past one, within 1e-12 of each window's sum of |terms| of the JAX
``fused_abba_flush``'s sums and the port's plain version.  The kernels
themselves run only on the card (chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import abba as jax_abba
from genomics_general_tpu.kernels.window_stats import \
    window_stats_step as jax_step
from genomics_general_tpu_torch.kernels import abba as port_abba
from genomics_general_tpu_torch.kernels import window_stats as port_ws
from tests.test_torch_abba import _alleles, _mask, _port_site_terms

CPU = torch.device("cpu")
# window_stats.cu: kPopThreads, kPopAhead, kFlushVectors, kPopChunk
K11_THREADS, K11_AHEAD, K11_FLUSH, K11_CHUNK = 256, 4, 60, 1024
# abba.cu: kSumWarps
K8_BLOCK_WARPS = 8
RTOL = 1e-12
U32 = np.uint32


@pytest.fixture(autouse=True)
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# ------------------------------------------------------------ K11 model

def count_word(x: np.ndarray):
    """window_stats.cu count_word: the byte-wise increments (any, one,
    two, three) of uint32 words x."""
    t = (x & U32(0x7c7c7c7c)) + U32(0x7c7c7c7c)
    code = (~(t | x) & U32(0x80808080)) >> U32(7)
    x1 = x >> U32(1)
    return code, code & x & ~x1, code & ~x & x1, code & x & x1


def keep_bytes(head: np.ndarray, tail: np.ndarray, at: int) -> np.ndarray:
    """window_stats.cu keep_bytes: 0xff in the bytes of the word at byte
    ``at`` of a vector that lie in its bytes head .. tail - 1."""
    lo = np.clip(head.astype(np.int64) - at, 0, 4)
    hi = np.clip(tail.astype(np.int64) - at, 0, 4)
    return (((1 << (8 * hi)) - 1) & ~((1 << (8 * lo)) - 1)).astype(U32)


def byte_sum(x: np.ndarray) -> np.ndarray:
    return x.astype("<u4").view(np.uint8).reshape(*x.shape, 4).sum(
        axis=-1, dtype=np.int64)


def memory(a: np.ndarray, ld: int, col: int, fill: int = 2):
    """``a`` [H, S] in a byte buffer standing for device memory (index 0
    on a 16-byte boundary) at row stride ``ld``, ``col`` columns into
    each row and 16 bytes in; every other byte is ``fill`` (a code, which
    an unmasked read would count).  Returns (buffer, address of row 0)."""
    H, S = a.shape
    base = 16 + col
    mem = np.full(16 + H * ld + 48, fill, np.uint8)
    for h in range(H):
        mem[base + h * ld:base + h * ld + S] = a[h].view(np.uint8)
    return mem, base


def load_words(mem, addr):
    """The 16-byte vectors at ``addr`` as uint32 words [len(addr), 4]."""
    return np.stack([mem[addr + k] for k in range(16)],
                    axis=1).view("<u4").astype(U32)


def add_counts(acc, t, words):
    for i in range(4):
        for c, inc in enumerate(count_word(words[:, i])):
            acc[c, t] += inc.astype("<u4").view(np.uint8).reshape(-1, 4)


def k11_block(mem, spans, nk, vmax, r0, r1, seen):
    """One class's rows r0 .. r1 - 1 of a band, as the block's threads
    take their items: the rows' inner vectors (no mask), then each row's
    first and last vector (head and tail bytes forced to 0xff), a thread
    each.  Returns the block's four code counts (any, one, two, three).
    ``spans`` [nk, 4]: each row's first aligned vector's address, nv,
    head, tail; ``seen`` counts each (row, vector) loaded."""
    tid = np.arange(K11_THREADS)
    inner = vmax - 2
    acc = np.zeros((4, K11_THREADS, 4), np.int64)  # byte-wise counters
    tot = np.zeros((4, K11_THREADS), np.int64)
    if inner > 0:
        step_r, step_v = divmod(K11_THREADS, inner)
        row, v = r0 + tid // inner, tid % inner
    else:
        row, v = np.full(K11_THREADS, r1), np.zeros(K11_THREADS, np.int64)
    pending = 0
    while (row < r1).any():
        for _ in range(K11_AHEAD):
            rs = spans[np.minimum(row, nk - 1)]
            t = np.flatnonzero((row < r1) & (v < rs[:, 1] - 2))
            if t.size:
                np.add.at(seen, (row[t], 1 + v[t]), 1)
                add_counts(acc, t, load_words(mem, rs[t, 0] + 16 * (1 + v[t])))
            row, v = row + step_r, v + step_v
            wrap = v >= inner
            v[wrap] -= inner
            row[wrap] += 1
        assert acc.max(initial=0) <= 255      # no counter byte overflows
        pending += K11_AHEAD
        if pending >= K11_FLUSH:
            tot += acc.sum(axis=2)
            acc[:] = 0
            pending = 0
    tot += acc.sum(axis=2)
    acc[:] = 0
    for j0 in range(0, 2 * (r1 - r0), K11_THREADS):     # the edges
        j = np.arange(j0, min(j0 + K11_THREADS, 2 * (r1 - r0)))
        rs = spans[r0 + (j >> 1)]
        last = (j & 1) == 1
        go = ~(last & (rs[:, 1] == 1))
        j, rs, last = j[go], rs[go], last[go]
        vec = np.where(last, rs[:, 1] - 1, 0)
        np.add.at(seen, (r0 + (j >> 1), vec), 1)
        words = load_words(mem, rs[:, 0] + 16 * vec)
        head = np.where(last, 0, rs[:, 2])
        tail = np.where(last | (rs[:, 1] == 1), rs[:, 3], 16)
        for i in range(4):
            words[:, i] |= ~keep_bytes(head, tail, 4 * i)
        add_counts(acc, j % K11_THREADS, words)
    assert acc.max(initial=0) <= 255
    return (tot + acc.sum(axis=2)).sum(axis=1)


def k11_model(mem, base, ld, S, first, n, pm, rows=port_ws._K11_ROWS):
    """K11's schedule on ``mem``: int64 [B, P, 4], and the number of
    vectors loaded.  Checks that the block's threads load every vector
    of every row's window once."""
    classes = port_ws.TailClasses(pm, CPU)
    members, starts, wgt = classes.members, classes.starts, classes.weights
    P = pm.shape[0]
    out = np.zeros((len(first), P, 4), np.int64)
    loads = 0
    for w, (f, k) in enumerate(zip(first, n)):
        lo, hi = max(int(f), 0), min(int(f) + int(k), S)
        if hi <= lo:
            continue
        vmax = (hi - lo + 30) >> 4
        for k0 in range(0, classes.n_rows, rows):
            nk = min(classes.n_rows - k0, rows)
            a = base + members[k0:k0 + nk] * ld + lo
            b = a + (hi - lo)
            a16 = a & ~15
            nv = (b - a16 + 15) >> 4
            spans = np.stack([a16, nv, a - a16, b - a16 - 16 * (nv - 1)],
                             axis=1)
            assert (spans[:, 2] < 16).all() and (spans[:, 3] >= 1).all() \
                and (spans[:, 3] <= 16).all() and (nv <= vmax).all()
            seen = np.zeros((nk, vmax), np.int64)
            for p0 in range(0, P, K11_CHUNK):          # a launch each
                pc = min(K11_CHUNK, P - p0)
                sums = np.zeros((pc, 4), np.int64)
                c = int(np.searchsorted(starts, k0, side="right")) - 1
                while c < classes.C and starts[c] < k0 + nk:
                    r0 = max(int(starts[c]) - k0, 0)
                    r1 = min(int(starts[c + 1]) - k0, nk)
                    tot = k11_block(mem, spans, nk, vmax, r0, r1, seen)
                    n4 = np.array([tot[0] - tot[1] - tot[2] - tot[3],
                                   tot[1], tot[2], tot[3]])
                    sums[wgt[c, p0:p0 + pc] != 0] += n4
                    c += 1
                out[w, p0:p0 + pc] += sums               # the atomics
            loads += int(seen.sum())
            launches = -(-P // K11_CHUNK)
            np.testing.assert_array_equal(
                seen, (np.arange(vmax)[None] < nv[:, None]) * launches)
    return out, loads


def k11_input(H, S, seed, stray=True):
    rng = np.random.default_rng(seed)
    codes = np.array([-7, -1, 0, 1, 2, 3, 5, 127], np.int8) if stray \
        else np.array([-1, 0, 1, 2, 3], np.int8)
    p = [.03, .1, .3, .3, .12, .09, .03, .03] if stray \
        else [.1, .3, .3, .2, .1]
    return rng.choice(codes, p=p, size=(H, S))


def k11_windows(S, lengths=(0, 1, 15, 16, 17, 31, 33, 625)):
    """Windows of ``lengths`` sites at every start offset mod 16."""
    first = [16 * (3 * off + 2 * j) + off for off in range(16)
             for j in range(len(lengths))]
    n = [length for _ in range(16) for length in lengths]
    assert max(f + k for f, k in zip(first, n)) <= S
    return np.array(first, np.int32), np.array(n, np.int32)


def k11_masks(H, seed):
    """Five populations with rows in none and one a single row that also
    lies in another; one of all rows; every row its own population."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 5, size=H)
    pm = np.zeros((5, H), np.float32)
    for p in range(4):
        pm[p, groups == p] = 1
    pm[4, 0] = 1
    return {"messy5": pm, "all1": np.ones((1, H), np.float32),
            "each": np.eye(H, dtype=np.float32)}


LAYOUTS = {"stride 16k": (2016, 0), "contiguous odd": (2003, 0),
           "odd stride, 3 in": (2011, 3), "stride 16k, 5 in": (2016, 5)}


def direct_counts(a, first, n, pm):
    """int64 [B, P, 4] counted directly: each population's rows, each
    window's sites inside [0, S), each code."""
    S = a.shape[1]
    out = np.zeros((len(first), pm.shape[0], 4), np.int64)
    for w, (f, k) in enumerate(zip(first, n)):
        sl = a[:, max(f, 0):max(min(f + k, S), 0)]
        for p in range(pm.shape[0]):
            rows = sl[pm[p] != 0]
            out[w, p] = [(rows == c).sum() for c in range(4)]
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mask", ["messy5", "all1", "each"])
def test_k11_model_matches_jax_step(layout, mask):
    """Every start offset mod 16 and lengths 0..625 on four row layouts:
    the model == the port's plain version == a direct count == the JAX
    step's pop_counts (for the 5- and 1-population masks: the JAX step
    builds P^2 block means), exactly, stray codes -7, 5, 127 counting as
    nothing."""
    H, S = 23, 2003
    ld, col = LAYOUTS[layout]
    a = k11_input(H, S, 3 + len(layout))
    first, n = k11_windows(S)
    pm = k11_masks(H, 7)[mask]
    mem, base = memory(a, ld, col)
    got, loads = k11_model(mem, base, ld, S, first, n, pm)
    assert loads > 0
    want = direct_counts(a, first, n, pm)
    np.testing.assert_array_equal(got, want)
    plain = port_ws.window_pop_counts(torch.from_numpy(a),
                                      torch.from_numpy(first),
                                      torch.from_numpy(n),
                                      torch.from_numpy(pm))
    np.testing.assert_array_equal(plain.numpy(), want)
    if pm.shape[0] <= 5:
        jax_counts = jax_step(a, first, n, pm, s_max=640)["pop_counts"]
        np.testing.assert_array_equal(np.asarray(jax_counts), want)


@pytest.mark.parametrize("case", ["clipped", "long", "flush", "many pops"])
def test_k11_model_edges_match_plain(case):
    """The model == the port's plain version on windows clipped at 0 and
    S (and wholly outside), on windows of 4,066, 4,099 and 4,990 sites
    (254, 256 and 311 inner vectors a row: a thread's next item is rows
    and vectors on, a row on, or vectors on in the same row), on one class
    of 80 rows at 4,099 sites (past a flush of the byte counters), and on
    1,100 populations (two launches of 1,024)."""
    H, S, mask = 23, 5003, k11_masks(23, 8)["messy5"]
    first, n = np.array([-5, -40, S - 10, S + 5, S - 625, 0], np.int32), \
        np.array([40, 10, 40, 3, 625, 1], np.int32)
    if case == "long":
        first, n = np.array([0, 7, 13], np.int32), \
            np.array([4066, 4099, 4990], np.int32)
    elif case == "flush":
        H, mask = 80, np.ones((1, 80), np.float32)
        first, n = np.array([3], np.int32), np.array([4099], np.int32)
    elif case == "many pops":
        mask = (np.random.default_rng(9).random((1100, H)) < 0.3).astype(
            np.float32)
        first, n = first[:2].copy(), n[:2].copy()
        first[:] = [1, 500]
        n[:] = [33, 625]
    a = k11_input(H, S, 11)
    mem, base = memory(a, 5011, 1)
    got, _ = k11_model(mem, base, 5011, S, first, n, mask)
    plain = port_ws.window_pop_counts_plain(
        torch.from_numpy(a), torch.from_numpy(first), torch.from_numpy(n),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(got, plain.numpy())
    if case == "clipped":
        assert (got[[1, 3]] == 0).all() and got[[0, 2, 4]].sum() > 0


@pytest.mark.parametrize("x", [0x00010203, 0xff7f05f9, 0x03030303,
                               0x80fc0400, 0x7c7b7a79, 0x01ff02fe])
def test_k11_count_word_matches_byte_compares(x):
    """count_word == the four bytes compared one by one (codes 0..3
    count, every other byte value counts as nothing)."""
    b = np.frombuffer(np.uint32(x).tobytes(), np.uint8)
    got = [byte_sum(inc)[0] for inc in count_word(np.array([x], U32))]
    want = [int((b <= 3).sum()), int((b == 1).sum()), int((b == 2).sum()),
            int((b == 3).sum())]
    assert got == want


@pytest.mark.parametrize("head,tail", [(0, 16), (3, 16), (0, 1), (5, 9),
                                       (15, 16), (4, 12), (7, 8)])
def test_k11_keep_bytes(head, tail):
    """keep_bytes keeps exactly bytes head .. tail - 1 of a vector."""
    words = np.array([keep_bytes(np.array([head]), np.array([tail]), at)[0]
                      for at in (0, 4, 8, 12)], "<u4")
    kept = words.view(np.uint8)
    assert set(kept.tolist()) <= {0, 255}
    np.testing.assert_array_equal(np.flatnonzero(kept),
                                  np.arange(head, tail))


def test_step_refuses_a_fractional_tensor_mask():
    """window_stats_step refuses a tensor mask with fractional entries
    (read from its cached classes' weights), as it refuses a numpy one:
    K11 counts membership where the JAX step weights by the mask."""
    rng = np.random.default_rng(4)
    a = rng.integers(-1, 4, size=(12, 300)).astype(np.int8)
    first, n = np.array([0, 100], np.int32), np.array([100, 150], np.int32)
    pm = np.zeros((2, 12), np.float32)
    pm[0, :6] = 1
    pm[1, 6:] = 0.5
    with pytest.raises(ValueError, match="0/1"):
        port_ws.window_stats_step(torch.from_numpy(a), torch.from_numpy(first),
                                  torch.from_numpy(n), torch.from_numpy(pm))
    pm[1, 6:] = 1
    out = port_ws.window_stats_step(torch.from_numpy(a),
                                    torch.from_numpy(first),
                                    torch.from_numpy(n), torch.from_numpy(pm))
    assert out["pop_counts"].shape == (2, 2, 4)


# ------------------------------------------------------------- K8 model

def k8_model(terms: np.ndarray, first, n, warps: int, shift: int):
    """K8's order on float64 ``terms`` [S, K]: each window's rows as
    column pairs read from its ``shift``-th double (0: a 16-byte boundary,
    1: 8 bytes past one), lane l of a warp on pair l % kPairs adding its
    rows in order, the pair's lanes in lane order, the window's warps in
    warp order, then (shift 1) its first and last doubles."""
    S, K = terms.shape
    pairs, rows_step = K // 2, 32 // (K // 2)
    lanes = rows_step * pairs
    flat = terms.reshape(-1)
    out = np.zeros((len(first), K))
    cols = (2 * np.arange(pairs) + shift) % K
    for w, (f, k) in enumerate(zip(first, n)):
        lo = max(int(f), 0)
        k = max(min(int(f) + int(k), S) - lo, 0)
        part = np.zeros((warps, K))
        if k:
            steps = -(-k // rows_step)
            per = -(-steps // warps)
            q = np.arange(lanes) % pairs
            r_lane = np.arange(lanes) // pairs
            last = np.where((q == pairs - 1) & (shift == 1), k - 1, k)
            for g in range(warps):
                acc = np.zeros((lanes, 2))
                for s in range(g * per, min(steps, (g + 1) * per)):
                    r = s * rows_step + r_lane
                    ok = r < last
                    at = lo * K + shift + 2 * (r * pairs + q)
                    acc[ok, 0] += flat[at[ok]]
                    acc[ok, 1] += flat[at[ok] + 1]
                total = acc[:pairs].copy()
                for j in range(1, rows_step):
                    total += acc[j * pairs:(j + 1) * pairs]
                part[g, cols] = total[:, 0]
                part[g, (cols + 1) % K] = total[:, 1]
        s = part[0].copy()
        for g in range(1, warps):
            s += part[g]
        if shift and k:
            s[0] += flat[lo * K]
            s[K - 1] += flat[(lo + k) * K - 1]
        out[w] = s
    return out


def close(got, want, scale, what=""):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    ok = ~np.isnan(want)
    assert (np.abs(got - want)[ok] <= RTOL * scale[ok] + 1e-15).all(), what


def k8_windows(S, seed):
    """Windows of 0, 1, odd and long lengths, 2x and 3x overlap,
    shuffled."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 3, 7, 33, 101, 301, S]
    first = np.concatenate([rng.integers(0, S - k + 1, size=2)
                            for k in lengths] +
                           [np.arange(0, S - 120, 60),
                            np.arange(0, S - 120, 40)])
    n = np.concatenate([np.full(2, k) for k in lengths] +
                       [np.full(len(range(0, S - 120, 60)), 120),
                        np.full(len(range(0, S - 120, 40)), 120)])
    order = rng.permutation(first.size)
    return first[order].astype(np.int32), n[order].astype(np.int32)


@pytest.mark.parametrize("full", [False, True], ids=["K8", "K18"])
@pytest.mark.parametrize("mode", ["polarize", "minor"])
@pytest.mark.parametrize("shift", [0, 1])
def test_k8_model_matches_jax_flush(full, mode, shift, monkeypatch):
    """The model's sums (4 warps a window, as the wrapper launches) on the
    port's site terms == the JAX fused_abba_flush's window sums and the
    port's plain version, within 1e-12 of each window's sum of |terms|,
    NaN positions equal."""
    al = _alleles()
    mask, n_pops = _mask("overlap")
    terms = _port_site_terms(al, mask, n_pops, 0.3, mode, full)
    first, n = k8_windows(al.shape[1], 5)
    warps = port_abba._K8_WARPS
    got = k8_model(terms, first, n, warps, shift)
    scale = np.stack([np.nansum(np.abs(terms[f:f + k]), axis=0)
                      for f, k in zip(first, n)])
    monkeypatch.setenv("GGT_EXEC", "tpu")
    with jax.enable_x64(True):
        want = jax_abba.window_abba_sums_dispatch(
            al, first, n, mask, n_pops, 0.3, mode, full).collect()
    close(got, want, scale, "vs JAX")
    plain = port_abba.abba_window_sums(torch.from_numpy(terms),
                                       torch.from_numpy(first),
                                       torch.from_numpy(n)).numpy()
    close(got, plain, scale, "vs plain")


@pytest.mark.parametrize("K", [8, 18])
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_k8_model_order_is_the_windows_own(K, warps):
    """On NaN-speckled terms from both alignments, at every warps a
    window: the model == plain within 1e-12 of the sum of |terms|; each
    window's sums are the same bits alone as in the shuffled batch (the
    order is the window's own), and each double is read once."""
    rng = np.random.default_rng(K + warps)
    S = 997
    terms = rng.normal(size=(S, K)) * rng.choice([1e-3, 1.0, 1e3],
                                                 size=(S, 1))
    terms[rng.choice(S, size=3, replace=False), rng.integers(0, K)] = np.nan
    first, n = k8_windows(S, K)
    plain = port_abba.abba_window_sums_plain(
        torch.from_numpy(terms), torch.from_numpy(first),
        torch.from_numpy(n)).numpy()
    scale = port_abba.abba_window_sums_plain(
        torch.from_numpy(np.nan_to_num(np.abs(terms))),
        torch.from_numpy(first), torch.from_numpy(n)).numpy()
    for shift in (0, 1):
        got = k8_model(terms, first, n, warps, shift)
        close(got, plain, scale, f"shift {shift}")
        for i in range(0, first.size, 7):
            alone = k8_model(terms, first[i:i + 1], n[i:i + 1], warps, shift)
            np.testing.assert_array_equal(alone.view(np.int64),
                                          got[i:i + 1].view(np.int64))
    # exact sums of small integers: every double of a window added once
    ints = rng.integers(-50, 50, size=(S, K)).astype(np.float64)
    for shift in (0, 1):
        got = k8_model(ints, first, n, warps, shift)
        want = np.stack([ints[f:f + k].sum(axis=0) for f, k in zip(first, n)])
        np.testing.assert_array_equal(got, want)


def test_k8_block_packing():
    """A block of kSumWarps warps holds kSumWarps / warps windows, and a
    warp step reads whole rows: 32 lanes of 8 rows at K = 8, 27 of 3 at
    K = 18."""
    assert port_abba._K8_WARPS in (1, 2, 4, 8)
    assert K8_BLOCK_WARPS % port_abba._K8_WARPS == 0
    for K in (len(port_abba.CLASSIC_CHANNELS), len(port_abba.FULL_CHANNELS)):
        pairs = K // 2
        assert (32 // pairs) * pairs == {8: 32, 18: 27}[K]
