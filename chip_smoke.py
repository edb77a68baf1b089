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
   5 groups, against the C site counter too;
3. popgenWindows end to end through the port's CLI at H = 512 (256 diploid
   individuals in 4 populations of 64), 50 kb windows, on three analysis
   sets: popDist popPairDist (500,000 sites: K1, K2, K3); run A, popFreq
   popDist popPairDist indHet hapStats --fstMethod WC (500,000 sites: K1,
   K2, K4, K6); run B, popDist popPairDist indPairDist indHet (100,000
   sites: K1, K2, K3, K5).  Each run resets the launch counts just before
   and fails unless every kernel of its path launched; then the host C
   executor (GGT_EXEC=host) must give the same rows, integer columns
   exactly and float cells within one rounding quantum; then a traced run
   gives the device busy time;
2b. parity and times at the runs' largest flushes: each kernel's, its
   plain version's and its library yardstick's time from CUDA events,
   beside the bound computed from these inputs;
4. the popDist goldens and the full-panel popgen_coord.csv golden of
   tests/golden through the port's CLI on the card, and the fused
   individual-blocks route against GGT_HOST_DIST_FINALIZE=1 on four
   analysis sets, within one rounding quantum.

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
}
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
RUNS = {
    # name: (--analysis arguments, the kernels of its path)
    "popDist": (["popDist", "popPairDist"],
                ("pair_counts_v3", "exception_patch", "blocks_tail")),
    "run_A": (["popFreq", "popDist", "popPairDist", "indHet", "hapStats",
               "--fstMethod", "WC"],
              ("pair_counts_v3", "exception_patch", "tri_pack",
               "site_pop_counts")),
    "run_B": (["popDist", "popPairDist", "indPairDist", "indHet"],
              ("pair_counts_v3", "exception_patch", "blocks_tail",
               "het_pairs")),
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
    l_, S_) exactly, float cells within one quantum.  Returns the number
    of cells that moved."""
    rows_a = list(csv.reader(open(path_a)))
    rows_b = list(csv.reader(open(path_b)))
    if len(rows_a) < 2:
        raise AssertionError(f"{what}: no window rows")
    if len(rows_a) != len(rows_b) or rows_a[0] != rows_b[0]:
        raise AssertionError(f"{what}: rows or header differ")
    header = rows_a[0]
    exact = {i for i, c in enumerate(header)
             if c in ("scaffold", "start", "end", "mid", "sites", "windowID")
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
        raise AssertionError(f"popgenWindows exited {rc}: {err.getvalue()}")
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


def drive(name, mods, popgen_windows, native, geno, pops, n_sites, work,
          record):
    """Phase 3 for one analysis set: the kernel path with the launch counts
    reset just before and read just after, the host executor, a traced
    run.  ``record`` names the dispatch functions whose largest call to
    keep (module, attribute, size of a call).  Returns (launches, kept
    calls, report)."""
    pair = mods[0]
    analysis, need = RUNS[name]
    args = ["-g", str(geno), "-f", "phased", "-w", "50000", "-m", "100",
            *POPS4, "--popsFile", str(pops), "--analysis", *analysis,
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
        wall, err = run_cli(popgen_windows.main,
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
    wall_h, err_h = run_cli(popgen_windows.main,
                            args + ["-o", str(work / f"{name}.host.csv")],
                            {"GGT_EXEC": "host"})
    if any(launches_of(mods).values()) or \
            any(m.HOST_FLUSHES == 0 for m in mods
                if any(k in need for k in m.LAUNCHES)):
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
    report.update(device_busy(popgen_windows, args, work, name))
    return launches, kept, report


def device_busy(popgen_windows, args, work: Path, name: str) -> dict:
    """One more kernel-path run under torch.profiler: the device time of
    every kernel and copy it traced, against the run's wall time (the
    profiler's own cost is in that wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = run_cli(popgen_windows.main,
                          args + ["-o", str(work / "traced.csv")],
                          {"GGT_EXEC": "device"})
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy = sum(us(e) for e in dev) / 1e6
    top = sorted(dev, key=us, reverse=True)[:8]
    log(f"[e2e] {name} traced run: wall {wall:.3f}s, device busy "
        f"{busy:.4f}s ({100 * busy / wall:.2f}% of wall); top device "
        "events: " + "; ".join(f"{e.key[:48]} x{e.count} "
                               f"{us(e) / 1e3:.2f} ms" for e in top))
    return {"traced_wall_s": wall, "device_busy_s": busy}


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
        from genomics_general_tpu_torch.kernels import counts
        from genomics_general_tpu_torch.kernels import pairdist as pair
        from genomics_general_tpu_torch.kernels import transfer
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    os.environ["GGT_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    mods = (pair, counts)
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
    with ThreadPoolExecutor(3) as ex:
        futs = {name: ex.submit(timed, _build.build, name)
                for name in ("pair_v3", "counts")}
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
            "popDist", mods, popgen_windows, native, geno, pops, N_SITES,
            work, [(pair, "window_pair_block_stats_dispatch",
                    lambda a: a[1].shape[0])])
        runs["run_A"] = drive(
            "run_A", mods, popgen_windows, native, geno, pops, N_SITES,
            work, [(pair, "window_pair_counts_dispatch",
                    lambda a: a[1].shape[0]),
                   (counts, "site_pop_counts_dispatch",
                    lambda a: a[0].shape[1])])
        runs["run_B"] = drive(
            "run_B", mods, popgen_windows, native, geno_b, pops_b,
            N_SITES_B, work, [(pair, "window_pair_ind_blocks_dispatch",
                               lambda a: a[1].shape[0])])
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
        for k in ("tri_pack", "site_pop_counts", "het_pairs"):
            bnd[k] = res[k]["bound"]
            log(f"[parity] {k} at {res[k]['shape']}")
        owner = {"pair_counts_v3": "popDist", "exception_patch": "popDist",
                 "blocks_tail": "popDist", "tri_pack": "run_A",
                 "site_pop_counts": "run_A", "het_pairs": "run_B"}
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
