#!/usr/bin/env python3
"""Time the port's K1, K2, K3, K6, K7, K8, K9, K10, K11, K12, K13, K14,
K16, K17, K18 and K20 kernels of two checkouts on one NVIDIA GPU, in one
process, on the same inputs:

    python3 kernel_ab.py --base DIR [--only TEXT ...] [--sweep] [--out FILE]

DIR is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive <commit> | tar -x -C DIR``).
Each checkout's port is imported under a package name of its own and
builds its ``pair_v3.cu``, ``pair4.cu``, ``counts.cu``, ``abba.cu``,
``ld.cu`` and ``window_stats.cu`` into its own ``build/``; each
kernel is called through that checkout's wrapper (its launch geometry,
its output allocation), on inputs made here from a seed at the shapes of
``chip_smoke.py``'s timings (H = 512):

* K1 ``pair_counts_v3``: the popDist chunk (128 windows of 625 sites,
  1 % of sites with a third allele in a few rows) of a wire-v3 flush,
  run A's windows (32 of about 625 sites) and 4 windows of 32,000 sites
  (about a block an SM, each window 63 staging steps), both with the
  popDist chunk's allele mix;
* K13 ``pair_counts_v2``: the popDist chunk as wire v2;
* K2 ``exception_patch``: the popDist chunk's wire-v3 flush, with the
  entry index built once where the checkout has one;
* K3 ``blocks_tail``: 128 windows of counts on popDist's mask (4 groups
  of 128 rows) and on run B's individual mask (256 groups of 2), min
  sites 100;
* K6 ``site_pop_counts``: the span wire of run A's largest span (32,647
  sites) on its 4 populations of 128 rows;
* K7 ``abba_site_terms``: run C's largest flush (274,671 sites, the
  classic panel, polarize) and run D's (257,986 sites, the full panel,
  minor), uint16 counts of 4 classes of 128 haplotypes (the populations
  P1, P2, P3, O) made from a seed: 5 % missing, per-site frequencies from
  a U-shaped beta, 1 % of sites with a third allele, minData 0.3;
* K8 ``abba_window_sums``: the head's K7 terms of those two flushes, run
  C's tiled by windows of 585 to 664 sites, run D's by windows of as many
  sites every 312 (each site in two windows);
* K9 ``pair_counts_4state``: run E's block (one window of 262,144 sites,
  a contiguous matrix) and run A's largest flush (32 windows of about 625
  sites, in the raw upload's layout);
* K10 ``window_stats_tail``: run G's shape, K3's 128 windows of counts on
  popDist's mask (4 populations of 128 rows);
* K11 ``window_pop_counts``: run G's shape, 128 windows of 625 sites of
  an [H, 80,000] matrix, popDist's mask;
* K12 ``site_pop_counts_raw``: run H's span (16,176 sites, rows read
  through the bucket-padded upload's stride), with the 256 individuals in
  9 populations as 9 classes and with all 512 rows as one class;
* K14 ``pair_counts_4state_rows``: rows 0..255 of run A's flush;
* K16 ``stacked_reduce``: the sum of a [2, 2,146,689] int32 stack (the dry
  run's SFS merge of two shards' 129^3 bins);
* K17 ``pair_allele_tables``: run P's first window (596 sites) and 2,048
  sites;
* K18 ``site_nonmissing``: run A's largest span (32,647 sites, a
  contiguous matrix, so an odd row stride) on its 4 populations of 128
  rows, and on one population of all 512;
* K20 ``flush_pair_counts``: run A's flush as a one-transfer buffer.

``--only`` times just the cases whose name holds one of the TEXTs (for
example ``K12``; ``"K1 "`` for K1 alone).  The two outputs of each kernel
must be equal (K7's float64 terms bit for bit; K3's float64 sums, taken
in another fixed order by another design, within rtol 1e-12, its counts
exactly; K8's float64 sums, likewise, within rtol 1e-12 of each window's
sum of |terms| with NaN positions equal; K10's float32 means, summed by
class pairs where earlier checkouts summed pair lists, within rtol 1e-5 /
atol 1e-6 with NaN positions equal, the cells not bit-equal counted).
``--sweep`` also times the head's K11 at other rows a block and its K8 at
other warps a window (the wrappers' ``_K11_ROWS`` and ``_K8_WARPS``), in
a CUDA graph, each variant's outputs held to the default's as above.
Times are CUDA events over repeated warm calls of each wrapper, taken
base, head, head, base: once as the calls come (host launch overhead
included, which sets the pace of a kernel shorter than it) and once with
the calls captured in a CUDA graph and replayed (the device's time); the
script prints the card's name and power limit and, as its last line, one
JSON object with every time.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from chip_smoke import cuda_ms, graph_ms, log

HEAD = Path(__file__).resolve().parent
PKG = "genomics_general_tpu_torch"
H = 512
S_E = 1 << 18
W_A, N_A = 32, 625
S_H = 16_176
S_R = 32_647                      # run A's largest count span (K6, K18)
S_P = (596, 2048)                 # run P's first window; K17's 2,048 sites
W_K, N_K = 128, 625               # the popDist chunk (K2, K3)
W_L, N_L = 4, 32_000              # K1's long windows
S_G, W_G, N_G = 80_000, 128, 625  # run G: the entry() step's batch
D_STEP = 312                      # run D: -w 50000 -s 25000 in sites
K11_ROWS = (16, 32, 64, 128, 256)  # --sweep: K11's rows a block
K8_WARPS = (1, 2, 4, 8)            # --sweep: K8's warps a window
H_POPS = (56,) * 8 + (64,)        # run H: 8 x 28 + 32 individuals, diploid
S_C, S_D = 274_671, 257_986       # runs C and D: the largest flush's sites
N_K16 = 129 ** 3                  # the dry run's SFS bins (3 x 128 haps)


def load_port(root: Path, alias: str) -> dict:
    """The kernel modules of the port in checkout ``root``, imported as
    package ``alias`` (so two checkouts live in one process); each builds
    its kernels from its own sources into its own ``build/``."""
    spec = importlib.util.spec_from_file_location(
        alias, root / PKG / "__init__.py",
        submodule_search_locations=[str(root / PKG)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"{alias}.kernels.{name}")
            for name in ("_build", "pairdist", "counts", "transfer", "ld",
                         "window_stats", "abba")}


def same(name: str, x, y, scale=None) -> int:
    """Integers and K3's counts exactly, K7's float64 terms bit for bit
    (NaN positions included); K3's float64 sums within rtol
    1e-12, K8's within rtol 1e-12 of ``scale`` (each window's sum of
    |terms|) and K10's float32 results within rtol 1e-5 / atol 1e-6 (Fst
    is a difference near 0), NaN positions equal
    (the two checkouts may add them in other orders).  Returns the number
    of cells not bit-equal."""
    import torch
    if x.dtype == torch.float64 and name.startswith("K8"):
        nan = torch.isnan(x)
        if torch.equal(nan, torch.isnan(y)) and bool(
                ((x - y).abs()[~nan] <= 1e-12 * scale[~nan] + 1e-15).all()):
            return int((x.view(torch.int64) != y.view(torch.int64)).sum())
    elif x.dtype == torch.float32 and name.startswith("K10"):
        nan = torch.isnan(x)
        if torch.equal(nan, torch.isnan(y)) and torch.allclose(
                x[~nan], y[~nan], rtol=1e-5, atol=1e-6):
            return int((x[~nan] != y[~nan]).sum())
    elif x.dtype == torch.float64 and name.startswith("K3"):
        if torch.equal(x[:, 1], y[:, 1]) and torch.allclose(
                x[:, 0], y[:, 0], rtol=1e-12, atol=1e-15):
            return int((x != y).sum())
    elif x.dtype == torch.float64 and name.startswith("K7"):
        if torch.equal(x.view(torch.int64), y.view(torch.int64)):
            return 0
    elif torch.equal(x, y):
        return 0
    raise AssertionError(f"{name}: base and head differ")


def codes(rng, h: int, s: int) -> np.ndarray:
    """Mostly biallelic codes, 5 % missing, 1 % third or fourth alleles."""
    a = rng.integers(0, 2, size=(h, s)).astype(np.int8)
    r = rng.random((h, s))
    a[r < 0.05] = -1
    a[(r >= 0.05) & (r < 0.06)] = rng.integers(2, 4)
    return a


def biallelic(rng, h: int, s: int) -> np.ndarray:
    """The popDist chunk's mix: biallelic codes, 5 % missing, a third
    allele in 4 rows at 1 % of sites (codes() makes nearly every site
    multi-allelic, which wire v3 ships as exceptions, not planes)."""
    a = rng.integers(0, 2, size=(h, s)).astype(np.int8)
    a[rng.random(a.shape) < 0.05] = -1
    for x in np.flatnonzero(rng.random(s) < 0.01):
        a[rng.integers(0, h, 4), x] = 2
    return a


def abba_counts(rng, S: int):
    """uint16 [S, 4, 4] counts of 4 classes of 128 haplotypes (P1, P2, P3,
    O; codes: the class's population bit and the union's) and their int32
    codes: 5 % missing calls, per-site frequencies from a U-shaped beta
    drifting a little between populations, alleles 0 and 1 (at 10 % of
    sites 2 and 3), 1 % of sites with a third allele."""
    called = 128 - rng.binomial(128, 0.05, size=(S, 4))
    p = np.clip(rng.beta(0.3, 0.3, size=(S, 1))
                + rng.normal(0, 0.05, size=(S, 4)), 0, 1)
    alt = rng.binomial(called, p)
    c = np.zeros((S, 4, 4), np.int64)
    swap = rng.random(S) < 0.1
    c[~swap, :, 0], c[~swap, :, 1] = (called - alt)[~swap], alt[~swap]
    c[swap, :, 2], c[swap, :, 3] = (called - alt)[swap], alt[swap]
    third = np.flatnonzero(rng.random(S) < 0.01)
    c[third, 0, 3 - 3 * swap[third]] += 1
    codes = np.array([1 | 16, 2 | 16, 4 | 16, 8 | 16], np.int32)
    return c.astype(np.uint16), codes


def sweep(port, k8_in, g_in) -> dict:
    """The head's K11 at each of K11_ROWS rows a block (run G) and its K8
    at each of K8_WARPS warps a window (runs C and D, also with the L2
    cold): graph ms each, every variant's outputs held to the default's.
    Restores the defaults."""
    import torch
    from chip_smoke import cold_graph_ms
    ws, abba = port["window_stats"], port["abba"]
    out = {"K11 run G": {}, "K8 run C flush": {}, "K8 run D flush": {}}
    rows0 = ws._K11_ROWS
    want = ws.window_pop_counts(*g_in)
    for rows in K11_ROWS:
        ws._K11_ROWS = rows
        call = lambda: ws.window_pop_counts(*g_in)  # noqa: E731
        same("K11 sweep", call(), want)
        out["K11 run G"][rows] = graph_ms(call, 20)
        log(f"[sweep] K11 run G, {rows} rows a block: "
            f"{out['K11 run G'][rows]:.4f} ms in a CUDA graph")
    ws._K11_ROWS = rows0
    warps0 = abba._K8_WARPS
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for run in ("C", "D"):
        terms, f8_t, n8_t, scale = k8_in[run]
        want = abba.abba_window_sums(terms, f8_t, n8_t)
        name = f"K8 run {run} flush"
        for warps in K8_WARPS:
            abba._K8_WARPS = warps
            call = lambda: abba.abba_window_sums(  # noqa: E731
                terms, f8_t, n8_t)
            same(name, call(), want, scale)
            out[name][warps] = (graph_ms(call, 20),
                                cold_graph_ms(call, 20, scratch))
            log(f"[sweep] {name}, {warps} warps a window: "
                f"{out[name][warps][0]:.4f} ms in a CUDA graph, "
                f"{out[name][warps][1]:.4f} with the L2 cold")
        abba._K8_WARPS = warps0
    del scratch
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--only", nargs="+", default=[""])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    ports = {"base": load_port(args.base.resolve(), "ggt_ab_base"),
             "head": load_port(HEAD, "ggt_ab_head")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    with ThreadPoolExecutor(4) as ex:
        futs = {(tag, name): ex.submit(port["_build"].build, name)
                for tag, port in ports.items()
                for name in ("pair_v3", "pair4", "counts", "abba", "ld",
                             "window_stats")}
        for (tag, name), fut in futs.items():
            so = fut.result()
            log(f"[build] {tag} {name}.cu: " + so.with_suffix(".log")
                .read_text().strip().replace("\n", f"\n[build] {tag} "))
    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    transfer = ports["head"]["transfer"]

    # ---- inputs, the same tensors for both checkouts
    a_e = torch.from_numpy(codes(rng, H, S_E)).to(dev)
    f_e = torch.tensor([0], dtype=torch.int32, device=dev)
    n_e = torch.tensor([S_E], dtype=torch.int32, device=dev)
    n_a = rng.integers(N_A - 40, N_A + 40, size=W_A).astype(np.int32)
    f_a = np.concatenate([[0], np.cumsum(n_a)[:-1]]).astype(np.int32)
    s_a = int(n_a.sum()) + 3
    a_a_np = codes(rng, H, s_a)
    buf_a = torch.from_numpy(transfer.pack_raw_span(a_a_np, f_a, n_a)).to(dev)
    a_a, f_a_t, n_a_t = transfer.raw_span_views(buf_a, H, s_a, W_A)
    smax_a = int(n_a.max())
    a_h = transfer.upload_span(codes(rng, H, S_H), dev)[:, :S_H]
    pop_mask = np.repeat(np.eye(len(H_POPS)), H_POPS, axis=1)
    one_class = np.ones((1, H))
    a_r = torch.from_numpy(codes(rng, H, S_R)).to(dev)
    pops_r = np.repeat(np.eye(4), H // 4, axis=1)
    wp = W_A
    fbuf_np, sp = transfer.pack_flush_buffer(a_a_np, f_a, n_a, wp)
    fbuf = torch.from_numpy(fbuf_np).to(dev)
    span_r, sp_r = transfer.pack_span(codes(rng, H, S_R))
    span_r = torch.from_numpy(span_r).to(dev)
    a_p = {s: torch.from_numpy(codes(rng, H, s)).to(dev) for s in S_P}
    # the popDist chunk: K3's counts, and K2's wire with a third allele
    # at 1 % of sites (about 6 a window)
    s_k = rng.integers(0, N_K, size=(W_K, H, H), dtype=np.int32)
    m_k = torch.from_numpy((rng.random(s_k.shape) * (s_k + 1)).astype(
        np.int32)).to(dev)
    s_k = torch.from_numpy(s_k).to(dev)
    pm_k = torch.from_numpy(np.repeat(np.eye(4, dtype=np.float32), H // 4,
                                      axis=1)).to(dev)
    a_k = biallelic(rng, H, W_K * N_K)
    f_k = np.arange(0, W_K * N_K, N_K, dtype=np.int32)
    v3_k = ports["head"]["pairdist"]._v3_flush_args(
        a_k, f_k, np.full(W_K, N_K, np.int32))
    wire_k = v3_k.wire(torch.from_numpy(v3_k.buf).to(dev))
    v2_k = ports["head"]["pairdist"]._v2_flush_args(
        a_k, f_k, np.full(W_K, N_K, np.int32))
    wire2_k = v2_k.wire(torch.from_numpy(v2_k.buf).to(dev))
    v3_a = ports["head"]["pairdist"]._v3_flush_args(
        biallelic(rng, H, s_a), f_a, n_a)
    wire_a = v3_a.wire(torch.from_numpy(v3_a.buf).to(dev))
    v3_l = ports["head"]["pairdist"]._v3_flush_args(
        biallelic(rng, H, W_L * N_L),
        np.arange(0, W_L * N_L, N_L, dtype=np.int32),
        np.full(W_L, N_L, np.int32))
    wire_l = v3_l.wire(torch.from_numpy(v3_l.buf).to(dev))
    k7_in = {}
    for run, S, mode, full in (("C", S_C, "polarize", False),
                               ("D", S_D, "minor", True)):
        cc, cd = abba_counts(rng, S)
        k7_in[run] = (torch.from_numpy(cc).to(dev),
                      torch.from_numpy(cd).to(dev), mode, full)
    stack_k16 = torch.from_numpy(rng.integers(
        -(1 << 30), 1 << 30, size=(2, N_K16), dtype=np.int32)).to(dev)
    # K8: the head's K7 terms of runs C and D; run C's windows tile the
    # flush, run D's start every D_STEP sites
    k8_in = {}
    for run in ("C", "D"):
        cc, cd, mode, full = k7_in[run]
        terms = ports["head"]["abba"].abba_site_terms(cc, cd, (128,) * 4,
                                                      0.3, mode, full)
        S = terms.shape[0]
        n8 = rng.integers(N_K - 40, N_K + 40,
                          size=S // (N_K if run == "C" else D_STEP) + 1)
        f8 = np.concatenate([[0], np.cumsum(n8)[:-1]]) if run == "C" \
            else np.arange(n8.size) * D_STEP
        keep = f8 < S
        f8, n8 = f8[keep], np.minimum(n8[keep], S - f8[keep])
        f8_t, n8_t = (torch.from_numpy(x.astype(np.int32)).to(dev)
                      for x in (f8, n8))
        scale = ports["head"]["abba"].abba_window_sums_plain(
            torch.nan_to_num(terms.abs()), f8_t, n8_t)
        k8_in[run] = (terms, f8_t, n8_t, scale)
    # K11: run G's windows of an [H, S_G] matrix on popDist's mask
    a_g = torch.from_numpy(codes(rng, H, S_G)).to(dev)
    f_g = torch.arange(0, W_G * N_G, N_G, dtype=torch.int32, device=dev)
    n_g = torch.full((W_G,), N_G, dtype=torch.int32, device=dev)
    log(f"[inputs] E: [{H}, {S_E}], one window; A: [{H}, {s_a}] (row "
        f"stride {a_a.stride(0)}), {W_A} windows, longest {smax_a}; H: "
        f"[{H}, {S_H}] (row stride {a_h.stride(0)}), {len(H_POPS)} classes; "
        f"R: [{H}, {S_R}], 4 populations (K6: its span wire, {sp_r} "
        f"sites); P: [{H}, S] for S in {S_P}; popDist chunk: {W_K} "
        f"windows of {N_K} sites, "
        f"{int((wire_k.ex_w < wire_k.wp).sum())} exception entries")

    def k12(mask):
        def make(port):
            groups = port["pairdist"].PopGroups(mask, dev)
            out = torch.empty((S_H, groups.P, 4), dtype=torch.uint16,
                              device=dev)
            return lambda: port["counts"].site_pop_counts_raw(
                a_h, 0, S_H, groups, out) or out
        return make

    def k6(port):
        groups = port["pairdist"].PopGroups(pops_r, dev)
        out = torch.empty((S_R, 4, 4), dtype=torch.uint16, device=dev)
        return lambda: port["counts"].site_pop_counts(
            span_r, sp_r, H, 0, S_R, groups, out) or out

    def k7(run):
        cc, cd, mode, full = k7_in[run]
        return lambda p: lambda: p["abba"].abba_site_terms(
            cc, cd, (128,) * 4, 0.3, mode, full)

    def k8(run):
        terms, f8_t, n8_t, _ = k8_in[run]
        return lambda p: lambda: p["abba"].abba_window_sums(terms, f8_t,
                                                            n8_t)

    def k17(s):
        return lambda p: lambda: p["ld"].pair_allele_tables(a_p[s])

    def k2(port):
        pd = port["pairdist"]
        mt, st = m_k.clone(), s_k.clone()
        if hasattr(pd, "exception_index"):     # built once per flush
            index = pd.exception_index(wire_k)
            return lambda: pd.exception_patch(
                mt, st, wire_k, 0, index) or (mt, st)
        return lambda: pd.exception_patch(mt, st, wire_k, 0) or (mt, st)

    def k3(mask):
        def make(port):
            groups = port["pairdist"].PopGroups(mask, dev)
            out = torch.empty((W_K, 2, groups.P, groups.P),
                              dtype=torch.float64, device=dev)
            return lambda: port["pairdist"].blocks_tail(
                m_k, s_k, groups, 100, out) or out
        return make

    cases = {
        "K1 popDist chunk": (lambda p: lambda: p["pairdist"].pair_counts_v3(
            wire_k, 0, W_K), 20),
        "K1 run A flush": (lambda p: lambda: p["pairdist"].pair_counts_v3(
            wire_a, 0, W_A), 20),
        "K1 long windows": (lambda p: lambda: p["pairdist"].pair_counts_v3(
            wire_l, 0, W_L), 20),
        "K13 popDist chunk": (
            lambda p: lambda: p["pairdist"].pair_counts_v2(wire2_k, 0, W_K),
            20),
        "K2 popDist chunk": (k2, 20),
        "K3 popDist chunk, popDist mask": (
            k3(np.repeat(np.eye(4), H // 4, axis=1)), 20),
        "K3 popDist chunk, run B individual mask": (
            k3(np.repeat(np.eye(H // 2), 2, axis=1)), 5),
        "K6 run A span": (k6, 50),
        "K7 run C flush": (k7("C"), 20),
        "K7 run D flush": (k7("D"), 20),
        "K8 run C flush": (k8("C"), 20),
        "K8 run D flush": (k8("D"), 20),
        "K9 run E block": (lambda p: lambda: p["pairdist"].pair_counts_4state(
            a_e, f_e, n_e, S_E), 5),
        "K9 run A flush": (lambda p: lambda: p["pairdist"].pair_counts_4state(
            a_a, f_a_t, n_a_t, smax_a), 20),
        "K10 run G": (lambda p: lambda: p["window_stats"].window_stats_tail(
            m_k, s_k, pm_k), 20),
        "K11 run G": (lambda p: lambda: p["window_stats"].window_pop_counts(
            a_g, f_g, n_g, pm_k), 20),
        "K12 run H span": (k12(pop_mask), 50),
        "K12 run H span, one class": (k12(one_class), 50),
        "K14 run A flush rows 0..255": (
            lambda p: lambda: p["pairdist"].pair_counts_4state_rows(
                a_a, f_a_t, n_a_t, 0, H // 2, smax_a), 20),
        "K16 stacked reduce": (
            lambda p: lambda: p["counts"].stacked_reduce(stack_k16, "sum"),
            50),
        "K17 run P window": (k17(S_P[0]), 20),
        "K17 2,048 sites": (k17(S_P[1]), 10),
        "K18 run A span": (lambda p: lambda: p["counts"].site_nonmissing(
            a_r, pops_r), 50),
        "K18 run A span, one population": (
            lambda p: lambda: p["counts"].site_nonmissing(a_r, one_class),
            50),
        "K20 run A flush": (
            lambda p: lambda: p["pairdist"]._fused_flush_pair_counts(
                fbuf, sp, H, wp, smax_a, wp), 20),
    }
    report = {"card": card, "kernels": {}}
    for name, (make, reps) in cases.items():
        if not any(text in name for text in args.only):
            continue
        runs = {tag: make(port) for tag, port in ports.items()}
        got = {}
        for tag, run in runs.items():
            out = run()
            got[tag] = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        scale = k8_in[name.split()[2]][3] if name.startswith("K8") \
            else None
        unequal = sum(same(name, x, y, scale)
                      for x, y in zip(got["base"], got["head"]))
        del got
        times = {"base": [], "head": [], "base_graph": [], "head_graph": []}
        for tag in ("base", "head", "head", "base"):
            times[tag].append(cuda_ms(runs[tag], reps))
        for tag in ("base", "head", "head", "base"):
            times[tag + "_graph"].append(graph_ms(runs[tag], reps))
        times["cells_not_bit_equal"] = unequal
        report["kernels"][name] = times
        log(f"[ab] {name}: base {times['base'][0]:.4f} / "
            f"{times['base'][1]:.4f} ms, head {times['head'][0]:.4f} / "
            f"{times['head'][1]:.4f} ms; in a CUDA graph base "
            f"{times['base_graph'][0]:.4f} / {times['base_graph'][1]:.4f}, "
            f"head {times['head_graph'][0]:.4f} / "
            f"{times['head_graph'][1]:.4f} ms; outputs equal"
            + (f" ({unequal} cells not bit-equal)" if unequal else ""))
        del runs
        torch.cuda.empty_cache()
    if args.sweep:
        report["sweep"] = sweep(ports["head"], k8_in, (a_g, f_g, n_g, pm_k))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    log(card)
    log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
