#!/usr/bin/env python3
"""Time the port's K2, K3, K6, K9, K12, K14, K17, K18 and K20 kernels of
two checkouts on one NVIDIA GPU, in one process, on the same inputs:

    python3 kernel_ab.py --base DIR [--only TEXT] [--out FILE]

DIR is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive <commit> | tar -x -C DIR``).
Each checkout's port is imported under a package name of its own and
builds its ``pair_v3.cu``, ``pair4.cu``, ``counts.cu`` and ``ld.cu``
into its own ``build/``; each
kernel is called through that checkout's wrapper (its launch geometry,
its output allocation), on inputs made here from a seed at the shapes of
``chip_smoke.py``'s timings (H = 512):

* K2 ``exception_patch``: the popDist chunk (128 windows of about 625
  sites, 1 % of sites with a third allele in a few rows) of a wire-v3
  flush, with the entry index built once where the checkout has one;
* K3 ``blocks_tail``: 128 windows of counts on popDist's mask (4 groups
  of 128 rows) and on run B's individual mask (256 groups of 2), min
  sites 100;
* K6 ``site_pop_counts``: the span wire of run A's largest span (32,647
  sites) on its 4 populations of 128 rows;
* K9 ``pair_counts_4state``: run E's block (one window of 262,144 sites,
  a contiguous matrix) and run A's largest flush (32 windows of about 625
  sites, in the raw upload's layout);
* K12 ``site_pop_counts_raw``: run H's span (16,176 sites, rows read
  through the bucket-padded upload's stride), with the 256 individuals in
  9 populations as 9 classes and with all 512 rows as one class;
* K14 ``pair_counts_4state_rows``: rows 0..255 of run A's flush;
* K17 ``pair_allele_tables``: run P's first window (596 sites) and 2,048
  sites;
* K18 ``site_nonmissing``: run A's largest span (32,647 sites, a
  contiguous matrix, so an odd row stride) on its 4 populations of 128
  rows, and on one population of all 512;
* K20 ``flush_pair_counts``: run A's flush as a one-transfer buffer.

``--only`` times just the cases whose name holds TEXT (for example
``K12``).  The two outputs of each kernel must be equal (K3's sums, taken
in another fixed order by another design, within rtol 1e-12, its counts
exactly).  Times are CUDA events over
repeated warm calls of each wrapper, taken base, head, head, base: once
as the calls come (host launch overhead included, which sets the pace of
a kernel shorter than it) and once with the calls captured in a CUDA
graph and replayed (the device's time); the script prints
the card's name and power limit and, as its last line, one JSON object
with every time.
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
H_POPS = (56,) * 8 + (64,)        # run H: 8 x 28 + 32 individuals, diploid


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
            for name in ("_build", "pairdist", "counts", "transfer", "ld")}


def same(name: str, x, y) -> None:
    """Integers and K3's counts exactly; K3's float64 sums within rtol
    1e-12 (the two checkouts may add them in other orders)."""
    import torch
    if x.dtype == torch.float64 and name.startswith("K3"):
        if torch.equal(x[:, 1], y[:, 1]) and torch.allclose(
                x[:, 0], y[:, 0], rtol=1e-12, atol=1e-15):
            return
    elif torch.equal(x, y):
        return
    raise AssertionError(f"{name}: base and head differ")


def codes(rng, h: int, s: int) -> np.ndarray:
    """Mostly biallelic codes, 5 % missing, 1 % third or fourth alleles."""
    a = rng.integers(0, 2, size=(h, s)).astype(np.int8)
    r = rng.random((h, s))
    a[r < 0.05] = -1
    a[(r >= 0.05) & (r < 0.06)] = rng.integers(2, 4)
    return a


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--only", default="")
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
                for name in ("pair_v3", "pair4", "counts", "ld")}
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
    a_k = rng.integers(0, 2, size=(H, W_K * N_K)).astype(np.int8)
    a_k[rng.random(a_k.shape) < 0.05] = -1
    for x in np.flatnonzero(rng.random(a_k.shape[1]) < 0.01):
        a_k[rng.integers(0, H, 4), x] = 2
    f_k = np.arange(0, W_K * N_K, N_K, dtype=np.int32)
    v3_k = ports["head"]["pairdist"]._v3_flush_args(
        a_k, f_k, np.full(W_K, N_K, np.int32))
    wire_k = v3_k.wire(torch.from_numpy(v3_k.buf).to(dev))
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
        "K2 popDist chunk": (k2, 20),
        "K3 popDist chunk, popDist mask": (
            k3(np.repeat(np.eye(4), H // 4, axis=1)), 20),
        "K3 popDist chunk, run B individual mask": (
            k3(np.repeat(np.eye(H // 2), 2, axis=1)), 5),
        "K6 run A span": (k6, 50),
        "K9 run E block": (lambda p: lambda: p["pairdist"].pair_counts_4state(
            a_e, f_e, n_e, S_E), 5),
        "K9 run A flush": (lambda p: lambda: p["pairdist"].pair_counts_4state(
            a_a, f_a_t, n_a_t, smax_a), 20),
        "K12 run H span": (k12(pop_mask), 50),
        "K12 run H span, one class": (k12(one_class), 50),
        "K14 run A flush rows 0..255": (
            lambda p: lambda: p["pairdist"].pair_counts_4state_rows(
                a_a, f_a_t, n_a_t, 0, H // 2, smax_a), 20),
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
        if args.only not in name:
            continue
        runs = {tag: make(port) for tag, port in ports.items()}
        got = {}
        for tag, run in runs.items():
            out = run()
            got[tag] = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        for x, y in zip(got["base"], got["head"]):
            same(name, x, y)
        del got
        times = {"base": [], "head": [], "base_graph": [], "head_graph": []}
        for tag in ("base", "head", "head", "base"):
            times[tag].append(cuda_ms(runs[tag], reps))
        for tag in ("base", "head", "head", "base"):
            times[tag + "_graph"].append(graph_ms(runs[tag], reps))
        report["kernels"][name] = times
        log(f"[ab] {name}: base {times['base'][0]:.4f} / "
            f"{times['base'][1]:.4f} ms, head {times['head'][0]:.4f} / "
            f"{times['head'][1]:.4f} ms; in a CUDA graph base "
            f"{times['base_graph'][0]:.4f} / {times['base_graph'][1]:.4f}, "
            f"head {times['head_graph'][0]:.4f} / "
            f"{times['head_graph'][1]:.4f} ms; outputs equal")
        del runs
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    log(card)
    log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
