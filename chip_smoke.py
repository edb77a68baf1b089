#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genomics_general_tpu_torch) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs a CUDA card, the CUDA toolkit (nvcc) and g++; it builds every
kernel from the sources in the checkout, imports nothing of JAX or of the
JAX package, and exits non-zero if any phase fails (there is no card, the
port is missing, a kernel does not build, launch or agree, or an output is
wrong):

1. the card (nvidia-smi name and power limit) and the build times;
2. kernel parity: each CUDA kernel against its plain PyTorch version on the
   same CUDA tensors — integers exactly, float64 sums at rtol 1e-12 /
   atol 1e-15 — on messy inputs (H=160, and H=77 for ragged tiles) and at
   the main path's flush shapes, with the kernel's, the plain version's and
   (K1) the bf16 Gram matmuls' times from CUDA events;
3. the main path end to end at a real size: popgenWindows --analysis
   popDist popPairDist over 50 kb windows, 256 diploid individuals
   (H = 512) in 4 populations, 500,000 sites on 4 scaffolds of 10 Mb, through
   the port's CLI; every kernel of the path must have launched during that
   run.  Then the same run on the host C executor (GGT_EXEC=host) must
   give the same rows and integers, and float cells within one rounding
   quantum;
4. the four popDist/popPairDist goldens of tests/golden through the port's
   CLI on the card, within one rounding quantum.

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
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SOURCE = "genomics_general_tpu_torch/kernels/csrc/pair_v3.cu"
REPLACES = {
    "pair_counts_v3": "genomics_general_tpu/kernels/pairdist.py:379",
    "exception_patch": "genomics_general_tpu/kernels/pairdist.py:263",
    "blocks_tail": "genomics_general_tpu/kernels/pairdist.py:328",
}
# H100 SXM data-sheet rates (the bound's denominators); a card set below
# its 700 W limit runs slower than these
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 34e12
# results per clock per SM for compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
POPC_PER_CLK_SM = 16
INT32_PER_CLK_SM = 64
RTOL, ATOL = 1e-12, 1e-15
# the main path's cohort: 4 pops x 64 diploid individuals (H = 512)
N_SITES, INDS_PER_POP = 500_000, 64
QUANTUM = 1e-4                       # one --roundTo 4 rounding step


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
    first = np.arange(0, S - 1200, 150, dtype=np.int32)
    n = rng.integers(1, 1400, size=first.shape[0]).astype(np.int32)
    n[3] = 0
    n = np.minimum(n, S - first).astype(np.int32)
    groups = rng.integers(0, 5, size=H)
    mask = np.zeros((5, H))
    mask[groups, np.arange(H)] = 1.0
    return a, first, n, mask


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def check_equal(name: str, got, want) -> float:
    import torch
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain "
                             f"(max abs err {max_err(got, want)})")
    return 0.0


def check_close(name: str, got, want) -> float:
    import torch
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: kernel vs plain beyond rtol {RTOL} "
                             f"(max abs err {max_err(got, want)})")
    return max_err(got, want)


def parity(pair, transfer, a, first, n, mask, min_sites, dev, chunk=None,
           time_it=False):
    """Run K1, K2, K3 and their plain versions on the same CUDA tensors for
    windows [0, chunk) of one flush, and hold K1 + K2 against the host C
    executor too; return per-kernel errors and times."""
    import torch
    buf, SpB, SpC, SpD, H, wp, auto_chunk, ep = pair._v3_flush_args(
        a, first, n)
    W = first.shape[0]
    nwin = min(chunk or auto_chunk, W)
    wire = transfer.from_jax_wire(torch.from_numpy(buf).to(dev), SpB, SpC,
                                  SpD, H, wp, ep)
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
    check_equal("K1 + K2 m vs host executor", mk.cpu(), torch.from_numpy(hm))
    check_equal("K1 + K2 s vs host executor", sk.cpu(), torch.from_numpy(hs))
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
    """Least time the card could take for each kernel's work on these
    inputs: max(bytes / HBM rate, operations / peak rate of their type)."""
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
    popc_rate = POPC_PER_CLK_SM * sm_count * clk_hz
    k1 = max(k1_bytes / HBM_BYTES_PER_S, popc / popc_rate)

    ex_w = shapes["ex_w"]
    active = ex_w[(ex_w >= 0) & (ex_w < nwin)]
    touched = np.unique(active).size
    k2_bytes = shapes["ex_bytes"] + 2 * 2 * 4 * touched * H * H
    k2_ops = 3 * active.size * H * H
    int_rate = INT32_PER_CLK_SM * sm_count * clk_hz
    k2 = max(k2_bytes / HBM_BYTES_PER_S, k2_ops / int_rate)

    k3_bytes = 8 * nwin * H * H + 16 * nwin * P * P + 4 * (2 * H + P + 1)
    k3_ops = 3 * nwin * H * (H - 1)
    k3 = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP64_PER_S)
    return {
        "pair_counts_v3": (1e3 * k1, "operations"
                           if popc / popc_rate > k1_bytes / HBM_BYTES_PER_S
                           else "bytes"),
        "exception_patch": (1e3 * k2, "operations"
                            if k2_ops / int_rate > k2_bytes / HBM_BYTES_PER_S
                            else "bytes"),
        "blocks_tail": (1e3 * k3, "operations"
                        if k3_ops / FP64_PER_S > k3_bytes / HBM_BYTES_PER_S
                        else "bytes"),
    }


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


def run_cli(main, argv) -> tuple[float, str]:
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"popgenWindows exited {rc}: {err.getvalue()}")
    return wall, err.getvalue()


def end_to_end(pair, native, popgen_windows, testing, work: Path):
    """Phase 3: returns (launches, kernel-shape flush, report dict)."""
    t0 = time.perf_counter()
    # multiallelic=0.01 (a third allele on ~10 % of a site's haplotypes) is
    # a rate chosen so that K2 runs on the main path, not one taken from a
    # cohort: K2's time and share of device time follow from it
    geno = work / "cohort.geno.gz"
    inds = testing.write_geno(str(geno), n_pops=4,
                              inds_per_pop=INDS_PER_POP,
                              n_sites=N_SITES, scaffold_len=10_000_000,
                              n_scaffolds=4, missing=0.05, seed=2026,
                              multiallelic=0.01)
    pops = work / "pops.txt"
    testing.write_pops_file(str(pops), inds)
    log(f"[e2e] data: {len(inds)} individuals (H={2 * len(inds)}), "
        f"{N_SITES} sites, {geno.stat().st_size} gz bytes, made in "
        f"{time.perf_counter() - t0:.1f}s")
    args = ["-g", str(geno), "-f", "phased", "-w", "50000", "-m", "100",
            "-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
            "--popsFile", str(pops), "--analysis", "popDist", "popPairDist",
            "--profile"]

    # keep the largest flush's inputs: phase 2 times the kernels on it
    flushes = []
    dispatch = pair.window_pair_block_stats_dispatch

    def recording_dispatch(alleles, first, n_sites, pop_mask, min_sites):
        if not flushes or first.shape[0] > flushes[0][1].shape[0]:
            flushes[:] = [(alleles, first, n_sites, pop_mask, min_sites)]
        return dispatch(alleles, first, n_sites, pop_mask, min_sites)

    pair.window_pair_block_stats_dispatch = recording_dispatch
    try:
        os.environ.pop("GGT_EXEC", None)
        pair.reset_launches()
        wall, err = run_cli(popgen_windows.main,
                            args + ["-o", str(work / "gpu.csv")])
        launches = dict(pair.LAUNCHES)
        host_flushes = pair.HOST_FLUSHES
    finally:
        pair.window_pair_block_stats_dispatch = dispatch
    log(f"[e2e] kernel path: wall {wall:.3f}s, {N_SITES / wall:.0f} sites/s, "
        f"launches {launches}, host flushes {host_flushes}")
    log("[e2e] " + err.strip().replace("\n", "\n[e2e] "))
    if native.get_lib() is None or "C tokenizer unavailable" in err:
        raise AssertionError("the native C tokenizer did not load")
    if host_flushes:
        raise AssertionError("the host executor ran on the kernel path")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main path")

    os.environ["GGT_EXEC"] = "host"
    try:
        pair.reset_launches()
        wall_h, err_h = run_cli(popgen_windows.main,
                                args + ["-o", str(work / "host.csv")])
    finally:
        os.environ.pop("GGT_EXEC", None)
    if pair.HOST_FLUSHES == 0 or any(pair.LAUNCHES.values()):
        raise AssertionError("GGT_EXEC=host did not run the host executor")
    log(f"[e2e] host executor: wall {wall_h:.3f}s, "
        f"{N_SITES / wall_h:.0f} sites/s")
    rows_g = list(csv.reader(open(work / "gpu.csv")))
    rows_h = list(csv.reader(open(work / "host.csv")))
    if len(rows_g) < 2:
        raise AssertionError("the main path wrote no window rows")
    if len(rows_g) != len(rows_h) or rows_g[0] != rows_h[0]:
        raise AssertionError("kernel and host CSVs differ in rows or header")
    differ = 0
    for rg, rh in zip(rows_g[1:], rows_h[1:]):
        if rg[:5] != rh[:5]:
            raise AssertionError(f"row keys differ: {rg[:5]} vs {rh[:5]}")
        for x, y in zip(rg[5:], rh[5:]):
            if x != y:
                differ += 1
                if not abs(float(x) - float(y)) <= QUANTUM + 1e-12:
                    raise AssertionError(f"cell {x} vs {y} beyond {QUANTUM}")
    log(f"[e2e] kernel vs host: {len(rows_g) - 1} rows, "
        f"{differ} float cells differ (each within {QUANTUM})")
    report = {"wall_s": wall, "sites_per_s": N_SITES / wall,
              "host_wall_s": wall_h, "rows": len(rows_g) - 1,
              "cells_differ_vs_host": differ}
    report.update(device_busy(popgen_windows, args, work))
    return launches, flushes[0], report


def device_busy(popgen_windows, args, work: Path) -> dict:
    """One more kernel-path run under torch.profiler: the device time of
    every kernel and copy it traced, against the run's wall time (the
    profiler's own cost is in that wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = run_cli(popgen_windows.main,
                          args + ["-o", str(work / "traced.csv")])
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy = sum(us(e) for e in dev) / 1e6
    top = sorted(dev, key=us, reverse=True)[:6]
    log(f"[e2e] traced run: wall {wall:.3f}s, device busy {busy:.4f}s "
        f"({100 * busy / wall:.2f}% of wall); top device events: "
        + "; ".join(f"{e.key[:48]} x{e.count} {us(e) / 1e3:.2f} ms"
                    for e in top))
    return {"traced_wall_s": wall, "device_busy_s": busy}


def goldens(popgen_windows, work: Path):
    D = REPO / "tests" / "data"
    G = REPO / "tests" / "golden"
    pops = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
            "--popsFile", str(D / "sim1.pops.txt")]
    cases = {
        "sites_windows": (
            ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
             "--windType", "sites", "-w", "250", "-O", "50", "-D", "50000",
             "-m", "100", *pops], "popgen_sites.csv"),
        "predefined_windows": (
            ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
             "--windType", "predefined",
             "--windCoords", str(D / "sim1.windCoords.txt"), "-m", "50",
             *pops, "--writeFailedWindows", "--addWindowID"],
            "popgen_predef.csv"),
        "haploid_mix": (
            ["-g", str(D / "sim_hap.geno.gz"), "-f", "phased", "-w", "50000",
             "-m", "50", "-p", "pop1", "-p", "pop2",
             "--popsFile", str(D / "sim_hap.pops.txt"),
             "--haploid", "pop1_ind1"], "popgen_hap.csv"),
        "diplo_format": (
            ["-g", str(D / "sim_diplo.geno.gz"), "-f", "diplo",
             "-w", "50000", "-m", "50", "-p", "pop1", "-p", "pop2",
             "--popsFile", str(D / "sim_diplo.pops.txt")],
            "popgen_diplo.csv"),
    }
    for name, (args, golden) in cases.items():
        out = work / f"{name}.csv"
        run_cli(popgen_windows.main,
                args + ["--analysis", "popDist", "popPairDist",
                        "-o", str(out)])
        exact = csv_mismatches(G / golden, out, 0.0)
        beyond = csv_mismatches(G / golden, out, QUANTUM + 1e-12)
        log(f"[golden] {name}: {exact} cells differ at tol 0, "
            f"{beyond} beyond one quantum")
        if beyond:
            raise AssertionError(f"golden {name}: {beyond} cells beyond "
                                 f"{QUANTUM}")


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
        from genomics_general_tpu_torch.kernels import pairdist as pair
        from genomics_general_tpu_torch.kernels import transfer
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    os.environ["GGT_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- phase 1: the card and the builds
    card = nvidia_smi("name,power.limit")
    log(card)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] {torch.cuda.get_device_name(0)}, {sm_count} SMs, max SM "
        f"clock {clk_mhz:.0f} MHz, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    so = _build.build("pair_v3")
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the native C tokenizer did not build")
    t_gxx = time.perf_counter() - t0
    log(f"[build] nvcc pair_v3.cu {t_nvcc:.1f}s, g++ geno_parser.cpp "
        f"{t_gxx:.1f}s")
    ptxas = so.with_suffix(".log").read_text()
    log("[build] " + ptxas.strip().replace("\n", "\n[build] "))

    # ---- phase 2a: parity on messy inputs (H=77: ragged pair tiles)
    for H in (160, 77):
        a, first, n, mask = messy_input(H)
        for chunk in (8, first.shape[0]):
            res, _ = parity(pair, transfer, a, first, n, mask, 40, dev, chunk)
            log(f"[parity] messy H={H}, {chunk} windows: kernels == plain == "
                f"host executor; max abs err "
                f"{ {k: v['max_abs_err'] for k, v in res.items()} }")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke-",
                                 dir=REPO / "build"))
    try:
        # ---- phase 3: the main path end to end
        launches, flush, e2e = end_to_end(pair, native, popgen_windows,
                                          testing, work)

        # ---- phase 2b: parity and times at the main path's flush shapes
        res, shapes = parity(pair, transfer, *flush, dev, time_it=True)
        bnd = bounds(shapes, sm_count, clk_mhz * 1e6)
        log(f"[parity] main-path flush: W={flush[1].shape[0]} windows, "
            f"chunk {shapes['nwin']}, H={shapes['H']}, P={shapes['P']}, "
            f"ep={shapes['ep']}")
        for k in REPLACES:
            r = res[k]
            log(f"[kernel] {k}: launches {launches[k]}, kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {bnd[k][0]:.4f} ms "
                f"({bnd[k][1]}), max abs err {r['max_abs_err']}")

        # ---- phase 4: goldens on the card
        goldens(popgen_windows, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
                "plain_ms": res[k]["plain_ms"], "bound_ms": bnd[k][0],
                "bound_by": bnd[k][1], "library_ms": res[k]["library_ms"]}
               for k in REPLACES]
    log(f"[done] {time.perf_counter() - t_start:.1f}s; e2e {json.dumps(e2e)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
