#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genomics_general_tpu_torch) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA card, the CUDA toolkit (nvcc) and g++; it builds every
kernel from the sources in the checkout (one nvcc per source, started
together), imports nothing of JAX or of the JAX package, and exits non-zero
if any phase fails (there is no card, the port is missing, a kernel does
not build, launch or agree, or an output is wrong):

1. the card (nvidia-smi name and power limit) and the build times;
2a. kernel parity on messy inputs (H=160, and H=77 for ragged tiles): each
   CUDA kernel against its plain PyTorch version on the same CUDA tensors —
   integers exactly, float64 sums at rtol 1e-12 / atol 1e-15 — and the
   count kernels against the host C executor: K1-K3 as in the popDist path;
   K4 tri_pack on its uint16 and (one window of 66,000 sites) int32
   branches; K5 het_pairs and K3 on a population mask and on an individual
   mask with haploid (r1 == r2) individuals; K6 site_pop_counts with 1 and
   5 groups, against the C site counter too; on ABBA inputs (an uncalled
   outgroup block, 50/50 tie sites, fixed sites) in every mode, panel and
   minData 0.3 / 0, on disjoint and overlapping populations: K6 on the
   membership-class partition against the C site counter, K7
   abba_site_terms against its plain version and the host executor's
   per-site terms exactly (NaN positions equal), K8 abba_window_sums
   against its plain version within rtol 1e-12 of the window's sum of
   |terms|;
3. five runs end to end through the port's CLIs at H = 512 (256 diploid
   individuals in 4 populations of 64), 50 kb windows: popgenWindows
   popDist popPairDist (500,000 sites: K1, K2, K3); run A, popFreq popDist
   popPairDist indHet hapStats --fstMethod WC (500,000 sites: K1, K2, K4,
   K6); run B, popDist popPairDist indPairDist indHet (100,000 sites: K1,
   K2, K3, K5); run C, ABBABABAwindows --minData 0.3 (500,000 sites: K6,
   K7, K8); run D, fourPopWindows -s 25000 --minData 0.3 (500,000 sites,
   overlapping windows: K6, K7, K8).  Each run resets the launch counts
   just before and fails unless every kernel of its path launched; then
   the host executor (GGT_EXEC=host) must give the same rows, integer
   columns exactly and float cells within one rounding quantum (runs C
   and D also under GGT_ABBA_HOST=1 on the card); then a traced run gives
   the device busy time;
2b. parity and times at the runs' largest flushes: each kernel's, its
   plain version's and its library yardstick's time from CUDA events,
   beside the bound computed from these inputs;
4. the popDist goldens and the full-panel popgen_coord.csv golden of
   tests/golden through the port's CLI on the card, the fused
   individual-blocks route against GGT_HOST_DIST_FINALIZE=1 on four
   analysis sets, within one rounding quantum, and the three ABBA goldens
   within one quantum (at tol 0 under GGT_ABBA_HOST=1).

The line before the last is one JSON object with each kernel's launches,
error, times and bound; the last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CSRC = "genomics_general_tpu_torch/kernels/csrc/"
# kernel -> (source, the JAX function it replaces)
KERNELS = {
    "pair_counts_v3": ("pair_v3.cu",
                       "genomics_general_tpu/kernels/pairdist.py:379"),
    "exception_patch": ("pair_v3.cu",
                        "genomics_general_tpu/kernels/pairdist.py:263"),
    "blocks_tail": ("pair_v3.cu",
                    "genomics_general_tpu/kernels/pairdist.py:328"),
    "tri_pack": ("pair_v3.cu",
                 "genomics_general_tpu/kernels/pairdist.py:331"),
    "het_pairs": ("pair_v3.cu",
                  "genomics_general_tpu/kernels/pairdist.py:347"),
    "site_pop_counts": ("counts.cu",
                        "genomics_general_tpu/kernels/counts.py:36"),
    "abba_site_terms": ("abba.cu",
                        "genomics_general_tpu/kernels/abba.py:94"),
    "abba_window_sums": ("abba.cu",
                         "genomics_general_tpu/kernels/abba.py:175"),
}
SOURCES = ("pair_v3", "counts", "abba")
# H100 SXM data-sheet rates (the bound's denominators); a card set below
# its 700 W limit runs slower than these
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 34e12
# results per clock per SM for compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
POPC_PER_CLK_SM = 16
INT32_PER_CLK_SM = 64
SECTOR = 32                           # bytes per device-memory sector
RTOL, ATOL = 1e-12, 1e-15
# the full-width cohort: 4 pops x 64 diploid individuals (H = 512)
N_SITES, INDS_PER_POP = 500_000, 64
N_SITES_B = 100_000                   # run B's depth (32,896 d_ columns)
QUANTUM = 1e-4                        # one --roundTo 4 rounding step
POPS4 = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4"]
ABBA_POPS = ["-P1", "pop1", "-P2", "pop2", "-P3", "pop3", "-O", "pop4"]
ABBA_KERNELS = ("site_pop_counts", "abba_site_terms", "abba_window_sums")
RUNS = {
    # name: (CLI, its window and analysis arguments, the kernels of its
    # path, the kernel modules whose host executor GGT_EXEC=host runs)
    "popDist": ("popgen", ["-w", "50000", "-m", "100", *POPS4, "--analysis",
                           "popDist", "popPairDist"],
                ("pair_counts_v3", "exception_patch", "blocks_tail"),
                ("pairdist",)),
    "run_A": ("popgen", ["-w", "50000", "-m", "100", *POPS4, "--analysis",
                         "popFreq", "popDist", "popPairDist", "indHet",
                         "hapStats", "--fstMethod", "WC"],
              ("pair_counts_v3", "exception_patch", "tri_pack",
               "site_pop_counts"), ("pairdist", "counts")),
    "run_B": ("popgen", ["-w", "50000", "-m", "100", *POPS4, "--analysis",
                         "popDist", "popPairDist", "indPairDist", "indHet"],
              ("pair_counts_v3", "exception_patch", "blocks_tail",
               "het_pairs"), ("pairdist",)),
    "run_C": ("abba", ["-w", "50000", "-m", "100", "--minData", "0.3",
                       *ABBA_POPS], ABBA_KERNELS, ("abba",)),
    "run_D": ("fourpop", ["-w", "50000", "-s", "25000", "-m", "100",
                          "--minData", "0.3", *ABBA_POPS], ABBA_KERNELS,
              ("abba",)),
}
# f64 operations of K7 (kernels/csrc/abba.cu): the gate of every site (4
# divisions, 4 comparisons), the freqs of a gated site (20 divisions), the
# terms of one selected (site, allele) pair (classic 56, full 414: f4 is
# 11 operations, f4c 27)
K7_SITE_OPS, K7_GATED_OPS = 8, 20
K7_PAIR_OPS = {8: 56, 18: 414}
# the three ABBA goldens (tests/test_abba_windows.py CONFIGS)
ABBA_GOLDENS = {
    "abba_coord": ("abba", ["-w", "50000", "-s", "25000", "-m", "50",
                            "--minData", "0.3", "--writeFailedWindows"]),
    "abba_sites": ("abba", ["--windType", "sites", "-w", "100", "-m", "20"]),
    "fourpop_coord": ("fourpop", ["-w", "50000", "-s", "50000", "-m", "50",
                                  "--minData", "0.3",
                                  "--writeFailedWindows"]),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- timing

def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, ops: float = 0.0, rate: float = 1.0):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and operations over their peak rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
    return (1e3 * max(tb, to), "operations" if to > tb else "bytes")


# -------------------------------------------------------------- parity

def messy_input(H: int, seed: int = 5):
    """Alleles with every site class of wire v3: multi-allelic exceptions,
    all-missing and all-monomorphic columns, mono with missing, clean
    biallelic; S not a multiple of 8; overlapping and empty windows."""
    rng = np.random.default_rng(seed)
    S = 5003
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    for s in rng.choice(S, size=S // 30, replace=False):
        a[rng.integers(0, H, 4), s] = rng.integers(2, 4)
    a[:, 100:140] = -1
    a[:, 200:400] = 1
    a[:, 400:500] = 0
    a[rng.integers(0, H, 100), np.arange(400, 500)] = -1
    a[:, 600:800] = rng.integers(0, 2, size=(H, 200))
    a[:, 900:904] = np.arange(4, dtype=np.int8)          # codes 0..3
    first = np.arange(0, S - 1200, 150, dtype=np.int32)
    n = rng.integers(1, 1400, size=first.shape[0]).astype(np.int32)
    n[3] = 0
    n = np.minimum(n, S - first).astype(np.int32)
    groups = rng.integers(0, 5, size=H)
    mask = np.zeros((5, H))
    mask[groups, np.arange(H)] = 1.0
    return a, first, n, mask


def long_window_input(seed: int = 6):
    """K4's int32 branch: a small H with one window of 66,000 sites."""
    rng = np.random.default_rng(seed)
    H, S = 24, 70_000
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.05] = -1
    a[rng.integers(0, H, 60), rng.integers(0, S, 60)] = 3
    return a, np.array([0, 1000], np.int32), np.array([66_000, 5000],
                                                      np.int32)


def ind_layout(H: int):
    """Individuals over H rows as popgenWindows builds them: row 0
    haploid, then diploid pairs, a trailing haploid row when one is left.
    Returns (ind_mask [I, H], het_rows int32 [2, I]; r1 == r2 == 0 for the
    haploids)."""
    inds = [[0]] + [[r, r + 1] for r in range(1, H - 1, 2)]
    if sum(map(len, inds)) < H:
        inds.append([H - 1])
    mask = np.zeros((len(inds), H))
    rows = np.zeros((2, len(inds)), np.int32)
    for k, r in enumerate(inds):
        mask[k, r] = 1.0
        if len(r) == 2:
            rows[:, k] = r
    return mask, rows


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def check_equal(name: str, got, want) -> float:
    """Integers exactly (compared on the host, so uint16 works too)."""
    g = got.cpu().numpy().astype(np.int64)
    w = want.cpu().numpy().astype(np.int64)
    if g.shape != w.shape or not np.array_equal(g, w):
        err = np.abs(g - w).max() if g.shape == w.shape else "shape"
        raise AssertionError(f"{name}: kernel != reference (max abs err "
                             f"{err})")
    return 0.0


def check_close(name: str, got, want) -> float:
    import torch
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: kernel vs plain beyond rtol {RTOL} "
                             f"(max abs err {max_err(got, want)})")
    return max_err(got, want)


def flush_counts(pair, transfer, a, first, n, dev, nwin=None):
    """K1 + K2 of windows [0, nwin) of one flush on the card.  Returns
    (v3 flush args, wire, m, s, nwin)."""
    import torch
    v3 = pair._v3_flush_args(a, first, n)
    nwin = min(nwin or v3.chunk, first.shape[0])
    wire = v3.wire(torch.from_numpy(v3.buf).to(dev))
    m, s = pair.pair_counts_v3(wire, 0, nwin)
    pair.exception_patch(m, s, wire, 0)
    return v3, wire, m, s, nwin


def parity(pair, transfer, a, first, n, mask, min_sites, dev, chunk=None,
           time_it=False):
    """Run K1, K2, K3 and their plain versions on the same CUDA tensors for
    windows [0, chunk) of one flush, and hold K1 + K2 against the host C
    executor too; return per-kernel errors and times."""
    import torch
    v3 = pair._v3_flush_args(a, first, n)
    H, ep = v3.h, v3.ep
    W = first.shape[0]
    nwin = min(chunk or v3.chunk, W)
    wire = v3.wire(torch.from_numpy(v3.buf).to(dev))
    groups = pair.PopGroups(mask, dev)
    mask_dev = groups.mask.to(dev)
    res = {}

    m, s = pair.pair_counts_v3(wire, 0, nwin)
    mp, sp = pair.pair_counts_v3_plain(wire, 0, nwin)
    res["pair_counts_v3"] = {"max_abs_err": max(
        check_equal("pair_counts_v3 m", m, mp),
        check_equal("pair_counts_v3 s", s, sp))}
    # a chunk that starts inside the flush
    if W > 2:
        m1, s1 = pair.pair_counts_v3(wire, 1, min(nwin, W - 1))
        m1p, s1p = pair.pair_counts_v3_plain(wire, 1, min(nwin, W - 1))
        check_equal("pair_counts_v3 m (w0=1)", m1, m1p)
        check_equal("pair_counts_v3 s (w0=1)", s1, s1p)

    mk, sk = m.clone(), s.clone()
    pair.exception_patch(mk, sk, wire, 0)
    pair.exception_patch_plain(mp, sp, wire, 0)
    res["exception_patch"] = {"max_abs_err": max(
        check_equal("exception_patch m", mk, mp),
        check_equal("exception_patch s", sk, sp))}
    hm, hs = pair._host_flush_counts(a, first[:nwin], n[:nwin])
    check_equal("K1 + K2 m vs host executor", mk, torch.from_numpy(hm))
    check_equal("K1 + K2 s vs host executor", sk, torch.from_numpy(hs))
    del hm, hs

    out = torch.empty((nwin, 2, groups.P, groups.P), dtype=torch.float64,
                      device=dev)
    pair.blocks_tail(mk, sk, groups, min_sites, out)
    outp = pair.blocks_tail_plain(mk, sk, mask_dev, min_sites)
    check_equal("blocks_tail counts", out[:, 1], outp[:, 1])
    res["blocks_tail"] = {"max_abs_err": check_close(
        "blocks_tail sums", out[:, 0], outp[:, 0])}
    torch.cuda.synchronize()

    if not time_it:
        return res, None
    res["pair_counts_v3"]["ms"] = cuda_ms(
        lambda: pair.pair_counts_v3(wire, 0, nwin), 20)
    res["pair_counts_v3"]["plain_ms"] = cuda_ms(
        lambda: pair.pair_counts_v3_plain(wire, 0, nwin), 3, 1)
    mt, st = m.clone(), s.clone()
    res["exception_patch"]["ms"] = cuda_ms(
        lambda: pair.exception_patch(mt, st, wire, 0), 20)
    res["exception_patch"]["plain_ms"] = cuda_ms(
        lambda: pair.exception_patch_plain(mt, st, wire, 0), 3, 1)
    res["blocks_tail"]["ms"] = cuda_ms(
        lambda: pair.blocks_tail(mk, sk, groups, min_sites, out), 20)
    res["blocks_tail"]["plain_ms"] = cuda_ms(
        lambda: pair.blocks_tail_plain(mk, sk, mask_dev, min_sites), 5)

    # yardstick for K1: the class-D bf16 Gram products at the same shapes
    _, _, cD, aD, _, _, _, _, fD, nD, _, _, _ = \
        transfer.unpack_pair_wire_v3(wire)
    dc = pair._gather_bits(cD, fD[:nwin], nD[:nwin]).to(torch.bfloat16)
    da = pair._gather_bits(aD, fD[:nwin], nD[:nwin]).to(torch.bfloat16)

    def grams():
        torch.matmul(dc, dc.transpose(1, 2))
        torch.matmul(da, da.transpose(1, 2))
        torch.matmul(da, dc.transpose(1, 2))
    res["pair_counts_v3"]["library_ms"] = cuda_ms(grams, 20)
    res["exception_patch"]["library_ms"] = None
    res["blocks_tail"]["library_ms"] = None
    shapes = {"H": H, "nwin": nwin, "P": groups.P, "ep": ep,
              "meta": wire.meta.cpu().numpy(),
              "ex_w": wire.ex_w.cpu().numpy(),
              "ex_bytes": ep * (4 + H)}
    return res, shapes


def bounds(shapes, sm_count: int, clk_hz: float) -> dict:
    """Least time the card could take for K1-K3's work on these inputs:
    max(bytes / HBM rate, operations / peak rate of their type)."""
    H, nwin, P = shapes["H"], shapes["nwin"], shapes["P"]
    meta = shapes["meta"].astype(np.int64)
    pairs_tri = H * (H + 1) // 2
    words_read = 0
    popc = 0
    for cls, planes in ((0, 1), (1, 1), (2, 2)):
        f, n = meta[2 * cls, :nwin], meta[2 * cls + 1, :nwin]
        has = n > 0
        nw = np.where(has, ((f + n - 1) >> 5) - (f >> 5) + 1, 0)
        popc += int(nw.sum()) * planes * pairs_tri
        if has.any():
            lo = int((f[has] >> 5).min())
            hi = int(((f[has] + n[has] - 1) >> 5).max())
            words_read += (hi - lo + 1) * planes * H
    k1_bytes = 4 * words_read + 28 * nwin + 8 * nwin * H * H
    ex_w = shapes["ex_w"]
    active = ex_w[(ex_w >= 0) & (ex_w < nwin)]
    touched = np.unique(active).size
    k2_bytes = shapes["ex_bytes"] + 2 * 2 * 4 * touched * H * H
    k3_bytes = 8 * nwin * H * H + 16 * nwin * P * P + 4 * (2 * H + P + 1)
    return {
        "pair_counts_v3": bound(k1_bytes, popc,
                                POPC_PER_CLK_SM * sm_count * clk_hz),
        "exception_patch": bound(k2_bytes, 3 * active.size * H * H,
                                 INT32_PER_CLK_SM * sm_count * clk_hz),
        "blocks_tail": bound(k3_bytes, 3 * nwin * H * (H - 1), FP64_PER_S),
    }


def epilogue_parity(pair, transfer, a, first, n, pop_mask, min_sites, dev):
    """K4 and K5 (with K3 on the same masks) against their plain versions
    and the host C executor's integers, for windows [0, chunk) of one
    flush: K4 on the flush's own dtype branch, K5 and K3 on a population
    mask and on an individual mask with haploid individuals."""
    import torch
    v3, _, m, s, nwin = flush_counts(pair, transfer, a, first, n, dev)
    H, u16 = v3.h, v3.u16
    hm, hs = (torch.from_numpy(x) for x in
              pair._host_flush_counts(a, first[:nwin], n[:nwin]))
    T = H * (H + 1) // 2
    out = torch.empty((nwin, 2 * T), device=dev,
                      dtype=torch.uint16 if u16 else torch.int32)
    pair.tri_pack(m, s, out)
    check_equal("tri_pack vs plain", out, pair.tri_pack_plain(m, s, u16))
    check_equal("tri_pack vs host executor", out,
                pair.tri_pack_plain(hm, hs, u16))
    err = 0.0
    ind_mask, het_rows = ind_layout(H)
    for kind, mask in (("pop", pop_mask), ("ind", ind_mask)):
        groups = pair.PopGroups(mask, dev)
        r1, r2 = pair._het_rows(het_rows, H, dev)
        het = torch.empty((nwin, r1.shape[0], 2), dtype=torch.float64,
                          device=dev)
        pair.het_pairs(m, s, r1, r2, het)
        check_equal(f"het_pairs ({kind} mask) vs plain", het,
                    pair.het_pairs_plain(m, s, r1, r2))
        check_equal(f"het_pairs ({kind} mask) vs host executor", het,
                    pair.het_pairs_plain(hm, hs, r1.cpu(), r2.cpu()))
        blk = torch.empty((nwin, 2, groups.P, groups.P), dtype=torch.float64,
                          device=dev)
        pair.blocks_tail(m, s, groups, min_sites, blk)
        want = pair.blocks_tail_plain(m, s, groups.mask.to(dev), min_sites)
        check_equal(f"blocks_tail ({kind} mask) counts", blk[:, 1],
                    want[:, 1])
        err = max(err, check_close(f"blocks_tail ({kind} mask) sums",
                                   blk[:, 0], want[:, 0]))
    torch.cuda.synchronize()
    return u16, nwin, err


def counts_parity(counts, transfer, native, a, mask, dev, block=1024):
    """K6 in site blocks against its plain version and the C site
    counter."""
    import torch
    H, S = a.shape
    P = mask.shape[0]
    buf, Sp = transfer.pack_span(a)
    dbuf = torch.from_numpy(buf).to(dev)
    groups = counts.PopGroups(mask, dev)
    out = torch.empty((S, P, 4), dtype=counts.count_dtype(H), device=dev)
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        counts.site_pop_counts(dbuf, Sp, H, s0, s1, groups, out[s0:s1])
    check_equal(f"site_pop_counts P={P} vs plain", out,
                counts.site_pop_counts_plain(dbuf, Sp, H, 0, S, groups.mask))
    membership = np.zeros(H, dtype=np.uint8)
    for p in range(P):
        membership[mask[p] > 0] |= 1 << p
    host = native.site_pop_counts_host_native(a, membership)
    if host is None:
        raise AssertionError("the C site counter did not load")
    full = np.zeros((S, P, 4), np.int64)
    full[:, :host.shape[1]] = host
    check_equal(f"site_pop_counts P={P} vs C counter", out,
                torch.from_numpy(full))
    torch.cuda.synchronize()


def abba_input(H: int = 160, S: int = 5003, seed: int = 7):
    """ABBA alleles: beta-distributed allele frequencies, 10 % missing, a
    few multi-allelic sites; the outgroup's rows (the last quarter) all
    missing on a block of sites; 50/50 tie sites in the union; sites where
    the populations' row blocks are fixed.  Overlapping windows of 100
    sites every 37, an empty one and one long one."""
    rng = np.random.default_rng(seed)
    q = H // 4
    f = rng.beta(0.4, 0.4, size=S)
    a = (rng.random((H, S)) < f).astype(np.int8) \
        * rng.integers(1, 4, size=S).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    for s in rng.choice(S, size=S // 30, replace=False):
        a[rng.integers(0, H, 3), s] = rng.integers(0, 4)
    a[3 * q:, 200:400] = -1
    for s in range(600, 900):
        x, y = rng.choice(4, size=2, replace=False)
        a[:, s] = np.where(rng.permutation(H) < H // 2, x, y)
    for s in range(1000, 1200):
        x, y = rng.choice(4, size=2, replace=False)
        a[:, s] = x
        a[2 * q:3 * q, s] = y
        if s % 2:
            a[q:2 * q, s] = y
    first = np.arange(0, S - 100, 37, dtype=np.int32)
    n = np.full(first.size, 100, np.int32)
    n[5] = 0
    first = np.append(first, 550).astype(np.int32)
    n = np.append(n, 1400).astype(np.int32)
    return a, first, n


def abba_mask(H: int, overlap: bool):
    """[5, H] P1, P2, P3, O and their union; ``overlap`` makes P1 and P2
    share rows and leaves rows in no population."""
    q = H // 4
    spans = ([(0, q + 2), (q - 2, 2 * q), (2 * q, 3 * q - 2), (3 * q, H)]
             if overlap else [(0, q), (q, 2 * q), (2 * q, 3 * q), (3 * q, H)])
    mask = np.zeros((5, H), np.float32)
    for k, (lo, hi) in enumerate(spans):
        mask[k, lo:hi] = 1
    mask[4] = mask[:4].max(axis=0)
    return mask, [hi - lo for lo, hi in spans]


def check_same(name: str, got, want) -> float:
    """float64 results equal exactly, NaN positions included."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not np.array_equal(g, w, equal_nan=True):
        nan = np.isnan(g) | np.isnan(w)
        raise AssertionError(f"{name}: not equal (NaN positions equal: "
                             f"{np.array_equal(np.isnan(g), np.isnan(w))}, "
                             f"max abs err {np.abs(g - w)[~nan].max()})")
    return 0.0


def check_sums(abba, name: str, got, terms, first, n) -> float:
    """K8 against its plain version: NaN positions equal, each sum within
    RTOL of the window's sum of |terms| (the scale of its rounding)."""
    import torch
    want = abba.abba_window_sums_plain(terms, first, n).cpu().numpy()
    scale = abba.abba_window_sums_plain(torch.nan_to_num(terms.abs()),
                                        first, n).cpu().numpy()
    g = got.cpu().numpy()
    if not np.array_equal(np.isnan(g), np.isnan(want)):
        raise AssertionError(f"{name}: NaN positions differ")
    ok = ~np.isnan(g)
    err = np.abs(g - want)[ok]
    if (err > RTOL * scale[ok] + ATOL).any():
        raise AssertionError(f"{name}: beyond rtol {RTOL} of the sum of "
                             f"|terms| (max abs err {err.max()})")
    return float(err.max()) if err.size else 0.0


def abba_parity(abba, counts, transfer, native, dev) -> dict:
    """K6 on the class partition, K7 and K8 on the ABBA messy input in
    every mode, panel and minData, on disjoint and overlapping
    populations.  Returns the largest error of K7 and K8."""
    import torch
    a, first, n = abba_input()
    H, S = a.shape
    buf, Sp = transfer.pack_span(a)
    dbuf = torch.from_numpy(buf).to(dev)
    f_d = torch.from_numpy(first).to(dev)
    n_d = torch.from_numpy(n).to(dev)
    ones = np.ones(S, np.int32)
    err = {"abba_site_terms": 0.0, "abba_window_sums": 0.0}
    for overlap in (False, True):
        mask, n_pops = abba_mask(H, overlap)
        classes = counts.MaskClasses(mask, dev)
        cc = counts.count_span(dbuf, Sp, H, S, classes.groups, block=1024)
        membership = counts.membership_bits(mask)
        host = native.site_pop_counts_host_native(a, membership)
        if host is None:
            raise AssertionError("the C site counter did not load")
        check_equal(f"class counts (overlap={overlap}) vs C counter",
                    torch.from_numpy(classes.combine(cc.cpu().numpy())),
                    torch.from_numpy(host.astype(np.int64)))
        for mode in abba.MODES:
            for full in (False, True):
                for md in (0.3, 0.0):
                    what = f"{mode} full={full} minData={md} " \
                           f"overlap={overlap}"
                    t = abba.abba_site_terms(cc, classes.codes, n_pops, md,
                                             mode, full)
                    check_same(f"abba_site_terms {what} vs plain", t,
                               abba.abba_site_terms_plain(
                                   cc, classes.codes, n_pops, md, mode,
                                   full))
                    check_same(f"abba_site_terms {what} vs host executor",
                               t, torch.from_numpy(abba.host_window_abba_sums(
                                   a, np.arange(S, dtype=np.int32), ones,
                                   membership, n_pops, md, mode, full)))
                    s = abba.abba_window_sums(t, f_d, n_d)
                    err["abba_window_sums"] = max(
                        err["abba_window_sums"],
                        check_sums(abba, f"abba_window_sums {what}", s, t,
                                   f_d, n_d))
    torch.cuda.synchronize()
    return err


# ------------------------------------------- times at the runs' flushes

def time_tri(pair, transfer, flush, dev):
    """K4 at run A's largest flush (its first chunk)."""
    import torch
    a, first, n = flush
    v3, _, m, s, nwin = flush_counts(pair, transfer, a, first, n, dev)
    H, u16 = v3.h, v3.u16
    T = H * (H + 1) // 2
    out = torch.empty((nwin, 2 * T), device=dev,
                      dtype=torch.uint16 if u16 else torch.int32)
    pair.tri_pack(m, s, out)
    err = check_equal("tri_pack (run A flush)", out,
                      pair.tri_pack_plain(m, s, u16))
    iu, ju = (torch.from_numpy(x).to(dev) for x in np.triu_indices(H))
    res = {"max_abs_err": err,
           "ms": cuda_ms(lambda: pair.tri_pack(m, s, out), 20),
           "plain_ms": cuda_ms(lambda: pair.tri_pack_plain(m, s, u16), 5),
           "library_ms": cuda_ms(lambda: (m[:, iu, ju], s[:, iu, ju]), 20)}
    # the function reads the upper triangles of m and s (the lower halves
    # are never needed) and writes 2T counts per window
    res["bound"] = bound(8 * nwin * T + 2 * T * (2 if u16 else 4) * nwin)
    res["shape"] = f"{nwin} windows, H={H}, {'uint16' if u16 else 'int32'}"
    return res


def time_het(pair, transfer, flush, dev):
    """K5 at run B's largest flush (its first chunk), and K3 on that
    flush's individual mask."""
    import torch
    a, first, n, ind_mask, het_rows, gate = flush
    _, _, m, s, nwin = flush_counts(pair, transfer, a, first, n, dev)
    H = a.shape[0]
    r1, r2 = pair._het_rows(het_rows, H, dev)
    n_ind = r1.shape[0]
    out = torch.empty((nwin, n_ind, 2), dtype=torch.float64, device=dev)
    pair.het_pairs(m, s, r1, r2, out)
    err = check_equal("het_pairs (run B flush)", out,
                      pair.het_pairs_plain(m, s, r1, r2))
    r1l, r2l = r1.long(), r2.long()
    res = {"max_abs_err": err,
           "ms": cuda_ms(lambda: pair.het_pairs(m, s, r1, r2, out), 20),
           "plain_ms": cuda_ms(lambda: pair.het_pairs_plain(m, s, r1, r2),
                               20),
           "library_ms": cuda_ms(lambda: (m[:, r1l, r2l], s[:, r1l, r2l]),
                                 20)}
    # each (window, individual) reads one sector of m and one of s
    res["bound"] = bound(nwin * n_ind * (2 * SECTOR + 16))
    res["shape"] = f"{nwin} windows, H={H}, I={n_ind}"
    groups = pair.PopGroups(ind_mask, dev)
    blk = torch.empty((nwin, 2, groups.P, groups.P), dtype=torch.float64,
                      device=dev)
    pair.blocks_tail(m, s, groups, gate, blk)
    want = pair.blocks_tail_plain(m, s, groups.mask.to(dev), gate)
    check_equal("blocks_tail (run B individual mask) counts", blk[:, 1],
                want[:, 1])
    k3_err = check_close("blocks_tail (run B individual mask) sums",
                         blk[:, 0], want[:, 0])
    k3_ms = cuda_ms(lambda: pair.blocks_tail(m, s, groups, gate, blk), 5)
    log(f"[kernel] blocks_tail on run B's individual mask (P={groups.P}, "
        f"{nwin} windows): kernel {k3_ms:.4f} ms, max abs err {k3_err}")
    return res


def time_counts(counts, transfer, flush, dev):
    """K6 over the first launch block of run A's largest count span."""
    import torch
    a, mask = flush
    H, S = a.shape
    buf, Sp = transfer.pack_span(a)
    dbuf = torch.from_numpy(buf).to(dev)
    groups = counts.PopGroups(mask, dev)
    s1 = min(S, counts.DEFAULT_SITE_BLOCK)
    P = groups.P
    dt = counts.count_dtype(H)
    out = torch.empty((s1, P, 4), dtype=dt, device=dev)
    counts.site_pop_counts(dbuf, Sp, H, 0, s1, groups, out)
    err = check_equal("site_pop_counts (run A span)", out,
                      counts.site_pop_counts_plain(dbuf, Sp, H, 0, s1,
                                                   groups.mask))
    al = transfer.unpack_span(dbuf, Sp, H)[:, :s1]
    onehot = (al[:, :, None] == torch.arange(4, device=dev, dtype=torch.int8)
              ).to(torch.bfloat16).reshape(H, s1 * 4)
    mask_bf = groups.mask.to(dev, torch.bfloat16)
    res = {"max_abs_err": err,
           "ms": cuda_ms(lambda: counts.site_pop_counts(
               dbuf, Sp, H, 0, s1, groups, out), 20),
           "plain_ms": cuda_ms(lambda: counts.site_pop_counts_plain(
               dbuf, Sp, H, 0, s1, groups.mask), 3, 1),
           "library_ms": cuda_ms(lambda: torch.matmul(mask_bf, onehot), 20)}
    out_bytes = 2 if dt == torch.uint16 else 4
    res["bound"] = bound(H * s1 * 3 / 8 + 4 * out_bytes * s1 * P)
    res["shape"] = f"{s1} sites, H={H}, P={P}"
    return res


def time_abba(abba, counts, transfer, flush, dev) -> dict:
    """K7 and K8 at one ABBA run's largest flush (its class counts from
    K6), checked against their plain versions there.  K8's yardstick is
    ``torch.segment_reduce`` when the windows tile their sites."""
    import torch
    a, first, n, mask, n_pops, md, mode, full = flush
    H, S = a.shape
    W = first.shape[0]
    wp = 8
    while wp < W:
        wp *= 2
    buf, Sp = transfer.pack_flush_buffer(a, first, n, wp)
    dbuf = torch.from_numpy(buf).to(dev)
    span, f_all, n_all = transfer.flush_views(dbuf, Sp, H, wp)
    f_d, n_d = f_all[:W], n_all[:W]
    classes = counts.MaskClasses(mask, dev)
    cc = counts.count_span(span, Sp, H, S, classes.groups)
    codes = classes.codes
    t = abba.abba_site_terms(cc, codes, n_pops, md, mode, full)
    k7_err = check_same("abba_site_terms (run flush) vs plain", t,
                        abba.abba_site_terms_plain(cc, codes, n_pops, md,
                                                   mode, full))
    sums = abba.abba_window_sums(t, f_d, n_d)
    k8_err = check_sums(abba, "abba_window_sums (run flush)", sums, t, f_d,
                        n_d)
    K = t.shape[1]
    k7 = {"max_abs_err": k7_err, "library_ms": None,
          "ms": cuda_ms(lambda: abba.abba_site_terms(
              cc, codes, n_pops, md, mode, full), 20),
          "plain_ms": cuda_ms(lambda: abba.abba_site_terms_plain(
              cc, codes, n_pops, md, mode, full), 3, 1)}
    k8 = {"max_abs_err": k8_err,
          "ms": cuda_ms(lambda: abba.abba_window_sums(t, f_d, n_d), 20),
          "plain_ms": cuda_ms(lambda: abba.abba_window_sums_plain(
              t, f_d, n_d), 3, 1), "library_ms": None}
    tiles = bool((first[1:] == first[:-1] + n[:-1]).all())
    if tiles:
        lo, hi = int(first[0]), int(first[-1] + n[-1])
        lengths = torch.from_numpy(n.astype(np.int64)).to(dev)
        seg = torch.segment_reduce(t[lo:hi], "sum", lengths=lengths)
        check_sums(abba, "segment_reduce yardstick", seg, t, f_d, n_d)
        k8["library_ms"] = cuda_ms(lambda: torch.segment_reduce(
            t[lo:hi], "sum", lengths=lengths), 20)
    # bounds from this flush: K7 reads the class counts and writes [S, K];
    # its operations follow the gated sites and selected pairs it found
    host = t.cpu().numpy()
    gated, pairs = float(host[:, 0].sum()), float(host[:, 1].sum())
    k7["bound"] = bound(cc.numel() * cc.element_size() + 4 * codes.numel()
                        + 729 + 8 * S * K,
                        K7_SITE_OPS * S + K7_GATED_OPS * gated
                        + (K7_PAIR_OPS[K] + K - 2) * pairs, FP64_PER_S)
    # K8 reads each site that some window covers once, writes [W, K], and
    # adds every window's rows
    covered = np.zeros(S + 1, np.int64)
    np.add.at(covered, first[n > 0], 1)
    np.add.at(covered, (first + n)[n > 0], -1)
    n_cov = int((np.cumsum(covered)[:S] > 0).sum())
    k8["bound"] = bound(8 * n_cov * K + 8 * W + 8 * W * K,
                        float(n.astype(np.int64).sum()) * K, FP64_PER_S)
    shape = (f"{S} sites, {W} windows, H={H}, C={codes.numel()} classes, "
             f"K={K}, {mode}, {int(gated)} gated sites, {int(pairs)} pairs"
             f"{', tiling' if tiles else ', overlapping'}")
    k7["shape"] = k8["shape"] = shape
    return {"abba_site_terms": k7, "abba_window_sums": k8}


# ------------------------------------------------------------ the CLI

def csv_mismatches(ref_path, ours_path, tol: float) -> int:
    """Per-column comparison keyed on header name (tests/util.py
    assert_csv_equal); raises on a different row count or column set,
    returns the number of cells that differ by more than ``tol``."""
    with open(ref_path) as f:
        ref = list(csv.DictReader(f))
    with open(ours_path) as f:
        ours = list(csv.DictReader(f))
    if len(ref) != len(ours):
        raise AssertionError(f"row count {len(ref)} != {len(ours)}")
    if ref and set(ref[0]) != set(ours[0]):
        raise AssertionError(f"columns differ: {set(ref[0]) ^ set(ours[0])}")
    bad = 0
    for r, o in zip(ref, ours):
        for c in r:
            if r[c] == o[c]:
                continue
            try:
                if tol and abs(float(r[c]) - float(o[c])) <= tol:
                    continue
            except ValueError:
                pass
            bad += 1
    return bad


def rows_within_quantum(path_a, path_b, what: str) -> int:
    """Same header and rows; the row keys and the integer columns (sites,
    sitesUsed, l_, S_) exactly, float cells within one quantum.  Returns
    the number of cells that moved."""
    rows_a = list(csv.reader(open(path_a)))
    rows_b = list(csv.reader(open(path_b)))
    if len(rows_a) < 2:
        raise AssertionError(f"{what}: no window rows")
    if len(rows_a) != len(rows_b) or rows_a[0] != rows_b[0]:
        raise AssertionError(f"{what}: rows or header differ")
    header = rows_a[0]
    exact = {i for i, c in enumerate(header)
             if c in ("scaffold", "start", "end", "mid", "sites", "sitesUsed",
                      "windowID")
             or c.startswith(("l_", "S_"))}
    moved = 0
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        for i, (x, y) in enumerate(zip(ra, rb)):
            if x == y:
                continue
            if i in exact:
                raise AssertionError(f"{what}: {header[i]} {x} != {y}")
            moved += 1
            if not abs(float(x) - float(y)) <= QUANTUM + 1e-12:
                raise AssertionError(f"{what}: {header[i]} {x} vs {y} beyond "
                                     f"{QUANTUM}")
    return moved


def run_cli(main, argv, env=None) -> tuple[float, str]:
    err = io.StringIO()
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = main(argv)
        wall = time.perf_counter() - t0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}: {err.getvalue()}")
    return wall, err.getvalue()


def profile_line(err: str) -> str:
    return next((ln for ln in err.splitlines() if ln.startswith("[profile]")),
                "")


def reset(mods):
    for mod in mods:
        mod.reset_launches()


def launches_of(mods) -> dict:
    out = {}
    for mod in mods:
        out.update(mod.LAUNCHES)
    return out


def make_cohort(testing, work: Path, name: str, n_sites: int,
                scaffold_len: int):
    t0 = time.perf_counter()
    # multiallelic=0.01 (a third allele on ~10 % of a site's haplotypes) is
    # a rate chosen so that K2 runs on the path, not one taken from a
    # cohort: K2's time and share of device time follow from it
    geno = work / f"{name}.geno.gz"
    inds = testing.write_geno(str(geno), n_pops=4,
                              inds_per_pop=INDS_PER_POP, n_sites=n_sites,
                              scaffold_len=scaffold_len, n_scaffolds=4,
                              missing=0.05, seed=2026, multiallelic=0.01)
    pops = work / f"{name}.pops.txt"
    testing.write_pops_file(str(pops), inds)
    log(f"[e2e] data {name}: {len(inds)} individuals (H={2 * len(inds)}), "
        f"{n_sites} sites, {geno.stat().st_size} gz bytes, made in "
        f"{time.perf_counter() - t0:.1f}s")
    return geno, pops


def short(mod) -> str:
    return mod.__name__.rsplit(".", 1)[-1]


def drive(name, mods, clis, native, geno, pops, n_sites, work, record):
    """Phase 3 for one run: the kernel path with the launch counts reset
    just before and read just after, the host executor (and for the ABBA
    CLIs the per-site count route, GGT_ABBA_HOST=1), a traced run.
    ``record`` names the dispatch functions whose largest call to keep
    (module, attribute, size of a call).  Returns (launches, kept calls,
    report)."""
    cli, tail, need, host_mods = RUNS[name]
    main = clis[cli]
    args = ["-g", str(geno), "-f", "phased", *tail, "--popsFile", str(pops),
            "--profile"]
    kept = {}
    originals = []
    for mod, attr, size in record:
        real = getattr(mod, attr)
        originals.append((mod, attr, real))

        def recording(*a, _real=real, _attr=attr, _size=size):
            if _attr not in kept or _size(a) > _size(kept[_attr]):
                # copies: a span is a view of the engine's reused buffer
                kept[_attr] = tuple(x.copy() if isinstance(x, np.ndarray)
                                    else x for x in a)
            return _real(*a)
        setattr(mod, attr, recording)
    try:
        reset(mods)
        wall, err = run_cli(main,
                            args + ["-o", str(work / f"{name}.gpu.csv")],
                            {"GGT_EXEC": "device"})
        launches = launches_of(mods)
        host_flushes = sum(m.HOST_FLUSHES for m in mods)
    finally:
        for mod, attr, real in originals:
            setattr(mod, attr, real)
    log(f"[e2e] {name} kernel path: wall {wall:.3f}s, "
        f"{n_sites / wall:.0f} sites/s, launches {launches}")
    log(f"[e2e] {name} {profile_line(err)}")
    if native.get_lib() is None or "C tokenizer unavailable" in err:
        raise AssertionError("the native C tokenizer did not load")
    if host_flushes:
        raise AssertionError(f"{name}: the host executor ran on the kernel "
                             "path")
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched on its "
                                 "path")

    reset(mods)
    wall_h, err_h = run_cli(main,
                            args + ["-o", str(work / f"{name}.host.csv")],
                            {"GGT_EXEC": "host"})
    if any(launches_of(mods).values()) or \
            any(m.HOST_FLUSHES == 0 for m in mods if short(m) in host_mods):
        raise AssertionError(f"{name}: GGT_EXEC=host did not run the host "
                             "executor alone")
    moved = rows_within_quantum(work / f"{name}.gpu.csv",
                                work / f"{name}.host.csv",
                                f"{name} kernel vs host")
    n_rows = sum(1 for _ in open(work / f"{name}.gpu.csv")) - 1
    log(f"[e2e] {name} host executor: wall {wall_h:.3f}s, "
        f"{n_sites / wall_h:.0f} sites/s; kernel vs host: {n_rows} rows, "
        f"{moved} float cells moved (each within {QUANTUM})")
    report = {"wall_s": wall, "sites_per_s": n_sites / wall,
              "host_wall_s": wall_h, "rows": n_rows,
              "cells_moved_vs_host": moved, "profile": profile_line(err)}
    if cli != "popgen":
        reset(mods)
        wall_c, _ = run_cli(main,
                            args + ["-o", str(work / f"{name}.counts.csv")],
                            {"GGT_EXEC": "device", "GGT_ABBA_HOST": "1"})
        lc = launches_of(mods)
        if lc["site_pop_counts"] <= 0 or lc["abba_site_terms"] or \
                lc["abba_window_sums"]:
            raise AssertionError(f"{name}: GGT_ABBA_HOST=1 did not count "
                                 f"with K6 alone ({lc})")
        moved_c = rows_within_quantum(work / f"{name}.counts.csv",
                                      work / f"{name}.host.csv",
                                      f"{name} GGT_ABBA_HOST=1 vs host")
        log(f"[e2e] {name} GGT_ABBA_HOST=1 on the card: wall {wall_c:.3f}s, "
            f"K6 launches {lc['site_pop_counts']}; vs host executor "
            f"{moved_c} float cells moved (each within {QUANTUM})")
        report.update(counts_route_wall_s=wall_c,
                      counts_route_cells_moved_vs_host=moved_c)
    report.update(device_busy(cli, args, work, name))
    return launches, kept, report


def device_busy(cli: str, args, work: Path, name: str) -> dict:
    """One more kernel-path run under torch.profiler, in a fresh process
    (:func:`traced_child`): the device time of every kernel and copy it
    traced, against the run's wall time (the profiler's own cost is in
    that wall).  Within one long process, profiling sessions after the
    first few were seen to lose whole flushes, so the run's launch counts
    are also held against the kernel events the trace kept: an incomplete
    trace's busy time is a lower bound."""
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.traced_child(sys.argv[1:]))", cli, *args,
         "-o", str(work / "traced.csv")], cwd=REPO, capture_output=True,
        text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"{name} traced run failed: {r.stderr[-3000:]}")
    t = json.loads(r.stdout.strip().splitlines()[-1])
    complete = t["traced"] == t["counted"]
    log(f"[e2e] {name} traced run: wall {t['wall_s']:.3f}s, device busy "
        f"{t['busy_s']:.4f}s ({100 * t['busy_s'] / t['wall_s']:.2f}% of "
        f"wall); kernel launches traced {t['traced']} of {t['counted']}"
        + ("" if complete else " (incomplete trace: busy is a lower bound)")
        + "; top device events: " + t["top"])
    return {"traced_wall_s": t["wall_s"], "device_busy_s": t["busy_s"],
            "trace_complete": complete}


def traced_child(argv) -> int:
    """The traced run of :func:`device_busy`: CLI ``argv[0]`` with the
    arguments ``argv[1:]`` on the kernel path under torch.profiler; prints
    one JSON line (wall, device busy, launches counted and traced, the top
    device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from genomics_general_tpu_torch.kernels import abba, counts, pairdist
    os.environ["GGT_DEVICE"] = "cuda"
    mods = (pairdist, counts, abba)
    reset(mods)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        wall, _ = run_cli(port_clis()[argv[0]], argv[1:],
                          {"GGT_EXEC": "device"})
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    counted = {k: v for k, v in launches_of(mods).items() if v}

    def us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    top = sorted(dev, key=us, reverse=True)[:8]
    print(json.dumps({
        "wall_s": wall, "busy_s": sum(us(e) for e in dev) / 1e6,
        "counted": counted,
        "traced": {k: sum(e.count for e in dev if k in e.key)
                   for k in counted},
        "top": "; ".join(f"{e.key[:48]} x{e.count} {us(e) / 1e3:.2f} ms"
                         for e in top)}))
    return 0


def port_clis() -> dict:
    """The port's CLI entry points by the names RUNS uses."""
    from genomics_general_tpu_torch.cli import abba_windows
    from genomics_general_tpu_torch.cli import four_pop_windows
    from genomics_general_tpu_torch.cli import popgen_windows
    return {"popgen": popgen_windows.main, "abba": abba_windows.main,
            "fourpop": four_pop_windows.main}


def goldens(popgen_windows, work: Path):
    D = REPO / "tests" / "data"
    G = REPO / "tests" / "golden"
    pops = [*POPS4, "--popsFile", str(D / "sim1.pops.txt")]
    dist = ["--analysis", "popDist", "popPairDist"]
    cases = {
        "sites_windows": (
            ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
             "--windType", "sites", "-w", "250", "-O", "50", "-D", "50000",
             "-m", "100", *pops, *dist], "popgen_sites.csv"),
        "predefined_windows": (
            ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
             "--windType", "predefined",
             "--windCoords", str(D / "sim1.windCoords.txt"), "-m", "50",
             *pops, "--writeFailedWindows", "--addWindowID", *dist],
            "popgen_predef.csv"),
        "haploid_mix": (
            ["-g", str(D / "sim_hap.geno.gz"), "-f", "phased", "-w", "50000",
             "-m", "50", "-p", "pop1", "-p", "pop2",
             "--popsFile", str(D / "sim_hap.pops.txt"),
             "--haploid", "pop1_ind1", *dist], "popgen_hap.csv"),
        "diplo_format": (
            ["-g", str(D / "sim_diplo.geno.gz"), "-f", "diplo",
             "-w", "50000", "-m", "50", "-p", "pop1", "-p", "pop2",
             "--popsFile", str(D / "sim_diplo.pops.txt"), *dist],
            "popgen_diplo.csv"),
        "coordinate_full_panel": (
            ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
             "-s", "25000", "-m", "100", "--minData", "0.3", *pops,
             "--analysis", "popFreq", "popDist", "popPairDist",
             "indPairDist", "indHet", "hapStats", "--writeFailedWindows",
             "--addWindowID"], "popgen_coord.csv"),
    }
    for name, (args, golden) in cases.items():
        out = work / f"{name}.csv"
        run_cli(popgen_windows.main, args + ["-o", str(out)],
                {"GGT_EXEC": "device"})
        exact = csv_mismatches(G / golden, out, 0.0)
        beyond = csv_mismatches(G / golden, out, QUANTUM + 1e-12)
        log(f"[golden] {name}: {exact} cells differ at tol 0, "
            f"{beyond} beyond one quantum")
        if beyond:
            raise AssertionError(f"golden {name}: {beyond} cells beyond "
                                 f"{QUANTUM}")

    # the fused individual-blocks route against the general route
    # (tests/test_popgen_windows.py:124-157)
    base = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
            *pops, "--writeFailedWindows"]
    sets = {
        "all_four": ["-s", "25000", "-m", "100", "--minData", "0.3",
                     "--analysis", "popDist", "popPairDist", "indPairDist",
                     "indHet"],
        "indHet": ["-m", "50", "--analysis", "indHet"],
        "indPairDist": ["-m", "50", "--analysis", "indPairDist"],
        "indHet_indPairDist": ["-m", "50", "--analysis", "indHet",
                               "indPairDist"],
    }
    for name, extra in sets.items():
        fast, host = work / f"fast_{name}.csv", work / f"fin_{name}.csv"
        run_cli(popgen_windows.main, base + extra + ["-o", str(fast)],
                {"GGT_EXEC": "device"})
        run_cli(popgen_windows.main, base + extra + ["-o", str(host)],
                {"GGT_EXEC": "device", "GGT_HOST_DIST_FINALIZE": "1"})
        moved = rows_within_quantum(fast, host, f"fast vs finalize {name}")
        log(f"[golden] fused route vs GGT_HOST_DIST_FINALIZE=1, {name}: "
            f"{moved} cells moved (each within {QUANTUM})")


def abba_goldens(clis, mods, work: Path):
    """The three ABBA goldens through the port's CLIs on the card: the
    kernel route within one quantum (its window sums add in another order
    than numpy), GGT_ABBA_HOST=1 at tol 0."""
    D = REPO / "tests" / "data"
    G = REPO / "tests" / "golden"
    base = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "--popsFile",
            str(D / "sim1.pops.txt"), *ABBA_POPS]
    for name, (cli, extra) in ABBA_GOLDENS.items():
        for route, env, tol in (
                ("kernel", {"GGT_EXEC": "device"}, QUANTUM + 1e-12),
                ("GGT_ABBA_HOST=1", {"GGT_EXEC": "device",
                                     "GGT_ABBA_HOST": "1"}, 0.0)):
            out = work / f"{name}.{route}.csv"
            reset(mods)
            run_cli(clis[cli], base + extra + ["-o", str(out)], env)
            if launches_of(mods)["site_pop_counts"] <= 0:
                raise AssertionError(f"golden {name} ({route}): K6 never "
                                     "launched")
            exact = csv_mismatches(G / f"{name}.csv", out, 0.0)
            beyond = csv_mismatches(G / f"{name}.csv", out, tol)
            log(f"[golden] {name} ({route}): {exact} cells differ at tol 0, "
                f"{beyond} beyond {tol}")
            if beyond:
                raise AssertionError(f"golden {name} ({route}): {beyond} "
                                     f"cells beyond {tol}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from genomics_general_tpu_torch import testing
        from genomics_general_tpu_torch.cli import popgen_windows
        from genomics_general_tpu_torch.io import native
        from genomics_general_tpu_torch.kernels import _build
        from genomics_general_tpu_torch.kernels import abba
        from genomics_general_tpu_torch.kernels import counts
        from genomics_general_tpu_torch.kernels import pairdist as pair
        from genomics_general_tpu_torch.kernels import transfer
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    os.environ["GGT_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    mods = (pair, counts, abba)
    clis = port_clis()
    t_start = time.perf_counter()

    # ---- phase 1: the card and the builds (one nvcc per source, and g++,
    # all started together)
    card = nvidia_smi("name,power.limit")
    log(card)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] {torch.cuda.get_device_name(0)}, {sm_count} SMs, max SM "
        f"clock {clk_mhz:.0f} MHz, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0
    with ThreadPoolExecutor(len(SOURCES) + 1) as ex:
        futs = {name: ex.submit(timed, _build.build, name)
                for name in SOURCES}
        gxx = ex.submit(timed, native.get_lib)
        built = {name: f.result() for name, f in futs.items()}
        lib, t_gxx = gxx.result()
    if lib is None:
        raise AssertionError("the native C tokenizer did not build")
    log("[build] " + ", ".join(f"nvcc {k}.cu {t:.1f}s"
                               for k, (_, t) in built.items())
        + f", g++ geno_parser.cpp {t_gxx:.1f}s (in parallel)")
    for so, _ in built.values():
        ptxas = so.with_suffix(".log").read_text()
        log("[build] " + ptxas.strip().replace("\n", "\n[build] "))

    # ---- phase 2a: parity on messy inputs (H=77: ragged pair tiles)
    errs = {k: 0.0 for k in KERNELS}
    for H in (160, 77):
        a, first, n, mask = messy_input(H)
        for chunk in (8, first.shape[0]):
            res, _ = parity(pair, transfer, a, first, n, mask, 40, dev, chunk)
            for k, v in res.items():
                errs[k] = max(errs[k], v["max_abs_err"])
        u16, nwin, k3_err = epilogue_parity(pair, transfer, a, first, n,
                                            mask, 40, dev)
        errs["blocks_tail"] = max(errs["blocks_tail"], k3_err)
        if not u16:
            raise AssertionError("the messy input should take K4's uint16 "
                                 "branch")
        for P, pmask in ((1, np.ones((1, H))), (5, mask)):
            counts_parity(counts, transfer, native, a, pmask, dev)
        log(f"[parity] messy H={H}: K1-K6 == plain; K1 + K2, K4, K5 == host "
            f"executor; K6 == C site counter (P=1, P=5); max abs err "
            f"{errs}")
    a, first, n = long_window_input()
    u16, nwin, _ = epilogue_parity(pair, transfer, a, first, n,
                                   np.ones((1, a.shape[0])), 0, dev)
    if u16:
        raise AssertionError("a 66,000-site window should take K4's int32 "
                             "branch")
    log(f"[parity] K4 int32 branch (one window of {n[0]} sites, "
        f"H={a.shape[0]}): tri_pack == plain == host executor")
    for k, v in abba_parity(abba, counts, transfer, native, dev).items():
        errs[k] = max(errs[k], v)
    log("[parity] ABBA messy input (3 modes x 2 panels x minData 0.3/0 x "
        "disjoint/overlapping pops): K6 class counts == C counter; K7 == "
        "plain == host executor (NaN positions equal); K8 within rtol "
        f"{RTOL} of plain; max abs err K8 {errs['abba_window_sums']}")
    log(f"[time] phase 2a done at {time.perf_counter() - t_start:.1f}s")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke-",
                                 dir=REPO / "build"))
    try:
        # ---- phase 3: the three paths end to end at H = 512
        geno, pops = make_cohort(testing, work, "cohort", N_SITES,
                                 10_000_000)
        geno_b, pops_b = make_cohort(testing, work, "cohort_b", N_SITES_B,
                                     2_000_000)
        runs = {}
        runs["popDist"] = drive(
            "popDist", mods, clis, native, geno, pops, N_SITES,
            work, [(pair, "window_pair_block_stats_dispatch",
                    lambda a: a[1].shape[0])])
        runs["run_A"] = drive(
            "run_A", mods, clis, native, geno, pops, N_SITES,
            work, [(pair, "window_pair_counts_dispatch",
                    lambda a: a[1].shape[0]),
                   (counts, "site_pop_counts_dispatch",
                    lambda a: a[0].shape[1])])
        runs["run_B"] = drive(
            "run_B", mods, clis, native, geno_b, pops_b,
            N_SITES_B, work, [(pair, "window_pair_ind_blocks_dispatch",
                               lambda a: a[1].shape[0])])
        for name in ("run_C", "run_D"):
            runs[name] = drive(
                name, mods, clis, native, geno, pops, N_SITES, work,
                [(abba, "window_abba_sums_dispatch",
                  lambda a: a[0].shape[1])])
        log(f"[time] phase 3 done at {time.perf_counter() - t_start:.1f}s")

        # ---- phase 2b: parity and times at the runs' flush shapes
        flush = runs["popDist"][1]["window_pair_block_stats_dispatch"]
        res, shapes = parity(pair, transfer, *flush, dev, time_it=True)
        bnd = bounds(shapes, sm_count, clk_mhz * 1e6)
        log(f"[parity] popDist flush: W={flush[1].shape[0]} windows, "
            f"chunk {shapes['nwin']}, H={shapes['H']}, P={shapes['P']}, "
            f"ep={shapes['ep']}")
        res["tri_pack"] = time_tri(
            pair, transfer,
            runs["run_A"][1]["window_pair_counts_dispatch"], dev)
        res["site_pop_counts"] = time_counts(
            counts, transfer, runs["run_A"][1]["site_pop_counts_dispatch"],
            dev)
        res["het_pairs"] = time_het(
            pair, transfer,
            runs["run_B"][1]["window_pair_ind_blocks_dispatch"], dev)
        res.update(time_abba(
            abba, counts, transfer,
            runs["run_C"][1]["window_abba_sums_dispatch"], dev))
        for k, r in time_abba(
                abba, counts, transfer,
                runs["run_D"][1]["window_abba_sums_dispatch"], dev).items():
            log(f"[kernel] {k} at run D's flush ({r['shape']}): kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]}), max abs err {r['max_abs_err']}")
        for k in ("tri_pack", "site_pop_counts", "het_pairs",
                  "abba_site_terms", "abba_window_sums"):
            bnd[k] = res[k]["bound"]
            log(f"[parity] {k} at {res[k]['shape']}")
        owner = {"pair_counts_v3": "popDist", "exception_patch": "popDist",
                 "blocks_tail": "popDist", "tri_pack": "run_A",
                 "site_pop_counts": "run_A", "het_pairs": "run_B",
                 "abba_site_terms": "run_C", "abba_window_sums": "run_C"}
        launches = {k: runs[owner[k]][0][k] for k in KERNELS}
        for k in KERNELS:
            r = res[k]
            r["max_abs_err"] = max(r["max_abs_err"], errs[k])
            log(f"[kernel] {k}: launches {launches[k]} ({owner[k]}), kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {bnd[k][0]:.4f} ms "
                f"({bnd[k][1]}), max abs err {r['max_abs_err']}")
        log(f"[time] phase 2b done at {time.perf_counter() - t_start:.1f}s")

        # ---- phase 4: goldens on the card
        goldens(popgen_windows, work)
        abba_goldens(clis, mods, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{"name": k, "route": "cuda", "source": CSRC + src,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
                "plain_ms": res[k]["plain_ms"], "bound_ms": bnd[k][0],
                "bound_by": bnd[k][1], "library_ms": res[k]["library_ms"]}
               for k, (src, replaces) in KERNELS.items()]
    e2e = {name: r[2] for name, r in runs.items()}
    log(f"[done] {time.perf_counter() - t_start:.1f}s; e2e {json.dumps(e2e)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
