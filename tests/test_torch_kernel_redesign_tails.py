"""The redesigned K3 (pair_v3.cu, per-block float64 tails in two launch
shapes) and K2 (pair_v3.cu, the exception patch as one read-modify-write
per window tile of 32 x 128 pairs) on the CPU: numpy models of the
kernels' arithmetic — K3's narrow thread-per-cell walk and its wide
lane-strided walk with the shuffle tree, K2's per-window entry index and
tile walk — against the JAX functions on seeded inputs: counts exactly,
sums at rtol 1e-12 (another fixed summation order than XLA's einsum).  The
kernels themselves run only on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu_torch.kernels import pairdist as port_pair

CPU = torch.device("cpu")
WARPS = 8                      # K3's wide block: 256 threads
TILE, COLS, BATCH = 32, 128, 32  # K2: a block's rows, columns; entries

# ------------------------------------------------------------------ K3


def ind_layout(H: int) -> np.ndarray:
    """Individuals over H rows as popgenWindows builds them: row 0
    haploid, then diploid pairs, a trailing haploid row when one is left
    (chip_smoke.ind_layout's mask)."""
    inds = [[0]] + [[r, r + 1] for r in range(1, H - 1, 2)]
    if sum(map(len, inds)) < H:
        inds.append([H - 1])
    mask = np.zeros((len(inds), H))
    for k, r in enumerate(inds):
        mask[k, r] = 1.0
    return mask


def _mask_of(groups: np.ndarray, P: int) -> np.ndarray:
    mask = np.zeros((P, groups.size))
    mask[groups, np.arange(groups.size)] = 1.0
    return mask


def k3_masks() -> dict:
    rng = np.random.default_rng(31)
    uneven = np.repeat(np.arange(5), [1, 0, 7, 20, 3])
    return {
        "popdist_4x32": np.repeat(np.eye(4), 32, axis=1),
        "individuals": ind_layout(42),
        "interleaved_narrow": _mask_of(rng.permutation(np.arange(60) % 20),
                                       20),
        "interleaved_wide": _mask_of(rng.permutation(np.arange(60) % 3), 3),
        "one_row_and_empty": _mask_of(rng.permutation(uneven), 5),
    }


def k3_counts(H: int, nwin: int, seed: int):
    """int32 [nwin, H, H] counts: shared 0..300 (0 and below 150 often),
    mismatch 0..shared, not symmetric (the walk reads each cell once)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 301, size=(nwin, H, H)).astype(np.int32)
    s[rng.random(s.shape) < 0.1] = 0
    m = (rng.random(s.shape) * (s + 1)).astype(np.int32)
    return m, s


def _groups(mask):
    g = port_pair.PopGroups(mask, CPU)
    return g.perm.tolist(), g.offs.tolist()


def k3_narrow(m, s, mask, min_sites):
    """The narrow kernel's arithmetic: thread ``cell`` of the 1-D grid
    takes (wl, p, q), q fastest, sums each column (q's rows in perm order)
    over p's rows in perm order in f64, and adds the columns' sums in
    column order (the kernel walks row by row with 1 or 8 columns' sums
    in registers: the same additions)."""
    perm, offs = _groups(mask)
    nwin, h, _ = m.shape
    P = len(offs) - 1
    ms = max(min_sites, 1)
    ml, sl = m.tolist(), s.tolist()
    out = np.full((nwin, 2, P, P), np.nan)
    pq = P * P
    for cell in range(nwin * pq):
        wl = cell // pq
        pqi = cell - wl * pq
        p, q = divmod(pqi, P)
        total, cnt = 0.0, 0
        for b in range(offs[q], offs[q + 1]):
            j = perm[b]
            col = 0.0
            for a in range(offs[p], offs[p + 1]):
                i = perm[a]
                sv, mv = sl[wl][i][j], ml[wl][i][j]
                if i != j and sv >= ms:
                    col += mv / sv
                    cnt += 1
            total += col
        assert np.isnan(out[wl, 0, p, q])            # each cell once
        out[wl, 0, p, q], out[wl, 1, p, q] = total, cnt
    return out


def k3_wide(m, s, mask, min_sites):
    """The wide kernel: block (q, p, wl); thread t (lane t % 32, warp
    t // 32) takes columns b = lane, lane + 32, ... and, for each, rows
    a = warp, warp + 8, ...; then __shfl_down_sync by 16, 8, 4, 2, 1 (a
    source lane past 31 reads the lane's own value) and thread 0 adds the
    warps' lane 0 in warp order."""
    perm, offs = _groups(mask)
    nwin, h, _ = m.shape
    P = len(offs) - 1
    ms = max(min_sites, 1)
    ml, sl = m.tolist(), s.tolist()
    out = np.zeros((nwin, 2, P, P))
    for wl in range(nwin):
        for p in range(P):
            pa, pn = offs[p], offs[p + 1] - offs[p]
            for q in range(P):
                qa, qn = offs[q], offs[q + 1] - offs[q]
                sums = [[0.0] * 32 for _ in range(WARPS)]
                cnts = [[0] * 32 for _ in range(WARPS)]
                for t in range(32 * WARPS):
                    lane, warp = t % 32, t // 32
                    total, cnt = 0.0, 0
                    for b in range(lane, qn, 32):
                        j = perm[qa + b]
                        for a in range(warp, pn, WARPS):
                            i = perm[pa + a]
                            sv, mv = sl[wl][i][j], ml[wl][i][j]
                            if i != j and sv >= ms:
                                total += mv / sv
                                cnt += 1
                    sums[warp][lane], cnts[warp][lane] = total, cnt
                for off in (16, 8, 4, 2, 1):
                    for w in range(WARPS):
                        src = [l + off if l + off < 32 else l
                               for l in range(32)]
                        sums[w] = [sums[w][l] + sums[w][src[l]]
                                   for l in range(32)]
                        cnts[w] = [cnts[w][l] + cnts[w][src[l]]
                                   for l in range(32)]
                total, cnt = 0.0, 0
                for w in range(WARPS):
                    total += sums[w][0]
                    cnt += cnts[w][0]
                out[wl, 0, p, q], out[wl, 1, p, q] = total, cnt
    return out


def _jax_blocks(m, s, mask, min_sites):
    nwin, h, _ = m.shape
    with jax.enable_x64():
        out = jax_pair._modes_tail(
            jnp.asarray(m), jnp.asarray(s), "blocks", jnp.asarray(mask),
            jnp.asarray(min_sites, jnp.int32), None, nwin, h, True)
        return np.asarray(out)


def _hold(got, want):
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("min_sites", [0, 150])
@pytest.mark.parametrize("walk", ["narrow", "wide"])
@pytest.mark.parametrize("name", sorted(k3_masks()))
def test_k3_walks_match_jax_blocks(name, walk, min_sites):
    """Both launch shapes' walks, on every mask, == JAX _modes_tail
    "blocks" (and the plain K3): counts exactly, sums at rtol 1e-12."""
    mask = k3_masks()[name]
    m, s = k3_counts(mask.shape[1], 3, seed=len(name))
    model = k3_narrow if walk == "narrow" else k3_wide
    got = model(m, s, mask, min_sites)
    _hold(got, _jax_blocks(m, s, mask, min_sites))
    plain = port_pair.blocks_tail_plain(torch.from_numpy(m),
                                        torch.from_numpy(s),
                                        torch.from_numpy(mask), min_sites)
    _hold(got, plain.numpy())


@pytest.mark.parametrize("H", [42, 77])
def test_k3_narrow_equals_host_executor_on_individual_masks(H):
    """On groups of at most 2 rows the narrow walk adds as the host
    executor's ``pm @ d0 @ pm.T``: its sums bit for bit, so a CLI's
    individual blocks agree with GGT_EXEC=host to the last bit."""
    mask = ind_layout(H)
    m, s = k3_counts(H, 3, seed=H)
    for min_sites in (0, 150):
        got = k3_narrow(m, s, mask, min_sites)
        sums, cnts = port_pair._blocks_from_counts(m, s, mask, min_sites)
        np.testing.assert_array_equal(got[:, 0], sums)
        np.testing.assert_array_equal(got[:, 1], cnts)


def test_k3_empty_group_and_one_row_group_are_zero():
    """A group of one row has no pair with itself; an empty group none at
    all: their cells sum to 0 over 0 pairs in both walks."""
    mask = k3_masks()["one_row_and_empty"]
    m, s = k3_counts(mask.shape[1], 2, seed=4)
    one = int(np.flatnonzero(mask.sum(axis=1) == 1)[0])
    empty = int(np.flatnonzero(mask.sum(axis=1) == 0)[0])
    for model in (k3_narrow, k3_wide):
        got = model(m, s, mask, 0)
        assert not got[:, :, one, one].any()
        assert not got[:, :, empty, :].any()
        assert not got[:, :, :, empty].any()


@pytest.mark.parametrize("H", [1, 2, 3, 42, 77, 512, 513])
def test_k3_picks_narrow_for_individual_masks(H):
    """Every individual mask (groups of 1 and 2 rows) takes the narrow
    shape: a thread per cell."""
    groups = port_pair.PopGroups(ind_layout(H), CPU)
    assert groups.max_rows == (2 if H > 2 else 1)
    assert not port_pair.blocks_tail_wide(groups)


def test_k3_picks_narrow_for_run_b_and_wide_for_popdist():
    """Run B's individual mask (256 diploids: groups of 2) is narrow;
    popDist's 4 x 128 and the 4 x 32 test mask are wide; the shape
    changes past _K3_NARROW_ROWS rows."""
    run_b = np.repeat(np.eye(256), 2, axis=1)
    assert not port_pair.blocks_tail_wide(port_pair.PopGroups(run_b, CPU))
    for rows in (32, 128):
        g = port_pair.PopGroups(np.repeat(np.eye(4), rows, axis=1), CPU)
        assert g.max_rows == rows and port_pair.blocks_tail_wide(g)
    edge = port_pair._K3_NARROW_ROWS
    at = port_pair.PopGroups(_mask_of(np.repeat([0, 1], [edge, 3]), 2), CPU)
    past = port_pair.PopGroups(_mask_of(np.repeat([0, 1], [edge + 1, 3]), 2),
                               CPU)
    assert not port_pair.blocks_tail_wide(at)
    assert port_pair.blocks_tail_wide(past)


# ------------------------------------------------------------------ K2


def k2_flush(kind: str):
    """A wire-v3 flush with exception entries: (alleles, first, n, wire).
    ``overlap`` steps windows by half their length (ex_w unsorted);
    ``heavy`` makes 30 % of sites multi-allelic (entries > windows x 8, more
    than one staging batch a window); every flush has a window with no
    exception site and padding entries."""
    rng = np.random.default_rng({"plain": 1, "overlap": 2, "heavy": 3}[kind])
    H, S = 70, 1500
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    rate = 0.3 if kind == "heavy" else 0.02
    sites = np.flatnonzero(rng.random(S) < rate)
    sites = sites[(sites < 300) | (sites >= 450)]      # one clean window
    for x in sites:
        a[rng.integers(0, H, 5), x] = rng.integers(2, 5)
    step = 75 if kind == "overlap" else 150
    first = np.arange(0, S - 149, step, dtype=np.int32)
    n = np.full(first.shape, 150, np.int32)
    v3 = port_pair._v3_flush_args(a, first, n)
    wire = v3.wire(torch.from_numpy(v3.buf))
    return a, first, n, wire


def k2_model(m, s, wire, w0, index):
    """The kernel: block (jc, ti, wl) takes the tile's counts of m and s,
    stages, BATCH entries at a time, the codes of its 32 rows and 128
    columns (-1 past h) of window w0 + wl's entries order[starts[w] ..
    starts[w + 1]), adds both-called and unequal pairs to the counts in
    int registers, then writes the tile back once."""
    m, s = m.copy(), s.copy()
    nwin, h, _ = m.shape
    order, starts = index.order.numpy(), index.starts.numpy()
    codes = wire.ex_codes.numpy()
    tiles = -(-h // TILE)
    written = np.zeros(m.shape, np.int64)
    for wl in range(nwin):
        e0, e1 = starts[w0 + wl], starts[w0 + wl + 1]
        if e0 >= e1:
            continue
        for i0 in range(0, tiles * TILE, TILE):
            for j0 in range(0, -(-tiles * TILE // COLS) * COLS, COLS):
                ri, rj = max(min(TILE, h - i0), 0), max(min(COLS, h - j0), 0)
                acc_m = np.zeros((TILE, COLS), np.int64)
                acc_s = np.zeros((TILE, COLS), np.int64)
                acc_m[:ri, :rj] = m[wl, i0:i0 + ri, j0:j0 + rj]
                acc_s[:ri, :rj] = s[wl, i0:i0 + ri, j0:j0 + rj]
                for eb in range(e0, e1, BATCH):
                    nb = min(BATCH, e1 - eb)
                    ci = np.full((nb, TILE), -1, np.int64)
                    cj = np.full((nb, COLS), -1, np.int64)
                    for k in range(nb):
                        row = codes[order[eb + k]]
                        ci[k, :ri] = row[i0:i0 + ri]
                        cj[k, :rj] = row[j0:j0 + rj]
                    ci, cj = ci[:, :, None], cj[:, None, :]
                    both = (ci >= 0) & (cj >= 0)
                    acc_s += both.sum(axis=0)
                    acc_m += (both & (ci != cj)).sum(axis=0)
                m[wl, i0:i0 + ri, j0:j0 + rj] = acc_m[:ri, :rj]
                s[wl, i0:i0 + ri, j0:j0 + rj] = acc_s[:ri, :rj]
                written[wl, i0:i0 + ri, j0:j0 + rj] += 1
        assert (written[wl] == 1).all()              # each pair once
    return m, s


def _jax_patch(m, s, wire):
    with jax.enable_x64():
        got = jax_pair._exception_patch(
            jnp.asarray(m), jnp.asarray(s), jnp.asarray(wire.ex_w.numpy()),
            jnp.asarray(wire.ex_codes.numpy()), wire.wp)
        return tuple(np.asarray(x) for x in got)


@pytest.mark.parametrize("kind, w0, nwin", [
    ("plain", 0, 9), ("plain", 3, 5), ("overlap", 0, 19),
    ("overlap", 5, 8), ("heavy", 0, 9), ("heavy", 2, 6)])
def test_k2_tile_walk_matches_jax(kind, w0, nwin):
    """The per-window index and tile walk on windows w0 .. w0 + nwin - 1
    == JAX _exception_patch on the same base counts, exactly (and the
    plain K2)."""
    a, first, n, wire = k2_flush(kind)
    W, H, wp = first.shape[0], a.shape[0], wire.wp
    nwin = min(nwin, W - w0)
    ex_w = wire.ex_w.numpy()
    assert (ex_w == wp).any()                        # padding entries
    rng = np.random.default_rng(w0)
    base_m = rng.integers(0, 50, size=(wp, H, H)).astype(np.int32)
    base_s = base_m + rng.integers(0, 50, size=(wp, H, H)).astype(np.int32)
    index = port_pair.exception_index(wire)
    starts = index.starts.numpy()
    assert (starts[1:W + 1] == starts[:W]).any()     # a window with none
    if kind == "overlap":
        assert (np.diff(ex_w[ex_w < wp]) < 0).any()  # not sorted by window
    if kind == "heavy":
        assert (ex_w < wp).sum() > 8 * W
        assert (np.diff(starts[:W + 1]) > BATCH).any()
    sl = slice(w0, w0 + nwin)
    got_m, got_s = k2_model(base_m[sl], base_s[sl], wire, w0, index)
    want_m, want_s = _jax_patch(base_m, base_s, wire)
    np.testing.assert_array_equal(got_m, want_m[sl])
    np.testing.assert_array_equal(got_s, want_s[sl])
    pm, ps = torch.from_numpy(base_m[sl].copy()), \
        torch.from_numpy(base_s[sl].copy())
    port_pair.exception_patch(pm, ps, wire, w0, index)
    np.testing.assert_array_equal(pm.numpy(), want_m[sl])
    np.testing.assert_array_equal(ps.numpy(), want_s[sl])


@pytest.mark.parametrize("kind", ["plain", "overlap", "heavy"])
def test_exception_index_sorts_entries_by_window(kind):
    """exception_index on CPU tensors: a stable sort of ex_w, window w's
    entries at order[starts[w]:starts[w + 1]], padding entries after
    starts[wp]."""
    _, first, _, wire = k2_flush(kind)
    ex_w = wire.ex_w.numpy()
    wp = wire.wp
    index = port_pair.exception_index(wire)
    assert index.order.dtype == index.starts.dtype == torch.int32
    order, starts = index.order.numpy(), index.starts.numpy()
    np.testing.assert_array_equal(order, np.argsort(ex_w, kind="stable"))
    assert starts.shape == (wp + 1,) and starts[0] == 0
    for w in range(wp):
        np.testing.assert_array_equal(
            order[starts[w]:starts[w + 1]], np.flatnonzero(ex_w == w))
    np.testing.assert_array_equal(np.sort(order[starts[wp]:]),
                                  np.flatnonzero(ex_w == wp))


def test_exception_index_of_a_flush_without_exceptions():
    """No exception site: an empty order and all-zero starts."""
    a = np.random.default_rng(5).integers(0, 2, size=(9, 300)).astype(np.int8)
    v3 = port_pair._v3_flush_args(a, np.array([0, 150], np.int32),
                                  np.array([150, 150], np.int32))
    index = port_pair.exception_index(v3.wire(torch.from_numpy(v3.buf)))
    assert index.order.numel() == 0
    assert not index.starts.any()
