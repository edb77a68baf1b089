#!/usr/bin/env python3
"""Where K15's time goes at full width, on one NVIDIA GPU:

    python3 k15_breakdown.py [--out FILE]

K15 (``counts.global_sfs_hist``, the dry run's global SFS) bins each
complete site with 1 or 2 alleles at its populations' counts of the
second-commonest allele.  This script takes chip_smoke.py's full-width
input (the popDist cohort's first three populations, 3 x 128 haplotypes,
500,000 sites, each missing call filled with its site's largest code,
129^3 bins) and reports:

* the input's shape: sites binned, bin 0's share, the non-zero bins,
  distinct bins in 32 consecutive passing sites, and the share of sites
  in each low corner (every population's target count at most k);
* device times in a CUDA graph, each read twice in turns: the
  histogram's ``torch.zeros`` alone; the one-thread-a-site kernel K15 was
  before its redesign (built here from the source below: one global atomic
  a passing site), as it was, without its atomics and without bin 0's;
  a kernel making only the global atomics of the sites outside the port's
  corner, one a site; a kernel only reading the counts as 16-byte vectors;
  and the port's K15 (its wrapper: ``torch.zeros``, then the kernel);
* both kernels on two one-bin inputs of 500,000 sites: every site
  monomorphic (bin 0, inside the corner) and every site in one bin
  outside it.

The outputs of every kernel that bins are held equal to the plain
version.  The script imports nothing of JAX, needs a card (it exits
non-zero and prints no result without one) and builds its kernels with
nvcc into ``build/k15_breakdown/``; it prints the card's name and power
limit and, as its last line, one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from chip_smoke import (N_SITES, SFS_POPS, graph_ms, log, make_cohort,
                        nvidia_smi)

REPO = Path(__file__).resolve().parent
# the one-thread-a-site K15 (mode 0) and two variants: mode 1 skips the
# atomics (a store no site makes keeps the work), mode 2 the atomics of
# bin 0; beside it a kernel making only global atomics and one only
# reading 16-byte vectors
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256)
one_thread_a_site(const uint16_t* __restrict__ counts, int S, int P,
                  const int32_t* __restrict__ n_hap, long long nbins,
                  int32_t* __restrict__ hist, int mode) {
  const int s = blockIdx.x * 256 + threadIdx.x;
  if (s >= S) return;
  const uint16_t* c = counts + (size_t)s * P * 4;
  long long tot[4] = {0, 0, 0, 0};
  for (int p = 0; p < P; ++p) {
    long long sum = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const long long v = c[4 * p + a];
      sum += v;
      tot[a] += v;
    }
    if (sum != n_hap[p]) return;
  }
  int n_alleles = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) n_alleles += tot[a] > 0;
  if (n_alleles < 1 || n_alleles > 2) return;
  int target = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      rank += tot[j] < tot[i] || (j < i && tot[j] == tot[i]);
    if (rank == 2) target = i;
  }
  long long idx = 0, stride = 1;
  for (int p = P - 1; p >= 0; --p) {
    idx += (long long)c[4 * p + target] * stride;
    stride *= n_hap[p] + 1;
  }
  if (mode == 1) {
    if (idx == -1) hist[0] = 1;
    return;
  }
  if (mode == 2 && idx == 0) return;
  if (idx >= 0 && idx < nbins) atomicAdd(&hist[idx], 1);
}
__global__ void atomics_only(const int64_t* __restrict__ bins, int n,
                             int32_t* __restrict__ hist) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    atomicAdd(&hist[bins[i]], 1);
}
__global__ void reads_only(const uint4* __restrict__ x, long long n,
                           int32_t* __restrict__ out) {
  unsigned acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 v = __ldcs(x + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678u) out[0] = 1;
}
extern "C" int k15_one_thread_a_site(const void* counts, int S, int P,
                                     const void* n_hap, long long nbins,
                                     void* hist, int mode, void* stream) {
  one_thread_a_site<<<(S + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)counts, S, P, (const int32_t*)n_hap, nbins,
      (int32_t*)hist, mode);
  return (int)cudaGetLastError();
}
extern "C" int k15_atomics_only(const void* bins, int n, void* hist,
                                int blocks, void* stream) {
  atomics_only<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)bins, n, (int32_t*)hist);
  return (int)cudaGetLastError();
}
extern "C" int k15_reads_only(const void* x, long long n16, void* out,
                              int blocks, void* stream) {
  reads_only<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, n16, (int32_t*)out);
  return (int)cudaGetLastError();
}
"""
CORNER_K = (0, 1, 3, 7, 15, 31)


def build(nvcc: str):
    """The kernels above as a ctypes library, typed."""
    out = REPO / "build" / "k15_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "k15_breakdown.cu", out / "k15_breakdown.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(so), str(src)], check=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k15_one_thread_a_site.argtypes = [P_, I_, I_, P_, L_, P_, I_, P_]
    lib.k15_atomics_only.argtypes = [P_, I_, P_, I_, P_]
    lib.k15_reads_only.argtypes = [P_, L_, P_, I_, P_]
    for f in (lib.k15_one_thread_a_site, lib.k15_atomics_only,
              lib.k15_reads_only):
        f.restype = ctypes.c_int
    return lib


def cohort_counts(counts, work: Path, dev):
    """chip_smoke.py's full-width K15 input: uint16 [500,000, 3, 4]."""
    import torch
    from genomics_general_tpu_torch import testing
    from genomics_general_tpu_torch.io import geno as geno_io
    from genomics_general_tpu_torch.samples import SampleData
    geno, pops = make_cohort(testing, work, "cohort", N_SITES, 10_000_000)
    sd = SampleData.from_pop_args(population_args=[[x] for x in SFS_POPS],
                                  pops_file=str(pops), geno_format="phased")
    reader = geno_io.GenoReader(str(geno), sample_data=sd,
                                geno_format="phased")
    a = reader.read_all().alleles
    a = np.ascontiguousarray(np.where(a < 0, a.max(axis=0)[None, :], a))
    pm = reader.model.pop_mask(SFS_POPS)
    at = torch.from_numpy(a).to(dev)
    c = counts.count_raw(at, a.shape[1], counts.PopGroups(pm, dev))
    return c, pm.sum(axis=1).astype(np.int64)


def turns(fns: dict) -> dict:
    """Each function's graph ms, read twice in turns (a, b, ..., b, a)."""
    order = list(fns) + list(fns)[::-1]
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(graph_ms(fns[k], 20))
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k15_breakdown: torch.cuda.is_available() is False; this "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from genomics_general_tpu_torch.kernels import _build, counts
    card = nvidia_smi("name,power.limit")
    log(card)
    dev = torch.device("cuda")
    lib = build(_build.nvcc_path())
    with tempfile.TemporaryDirectory(dir=REPO / "build") as work:
        c, n_hap = cohort_counts(counts, Path(work), dev)
    S, P, _ = c.shape
    nbins = int(np.prod(n_hap + 1))
    nh32 = torch.from_numpy(n_hap.astype(np.int32)).to(dev)
    scratch = torch.zeros(nbins, dtype=torch.int32, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def before(x, mode, zero=True):
        def fn():
            h = torch.zeros(nbins, dtype=torch.int32, device=dev) if zero \
                else scratch
            _build.check(lib.k15_one_thread_a_site(
                x.data_ptr(), S, P, nh32.data_ptr(), nbins, h.data_ptr(),
                mode, stream()), "k15_one_thread_a_site")
            return h
        return fn

    def port(x):
        return lambda: counts.global_sfs_hist(x, n_hap)

    want = counts.global_sfs_hist_plain(c, n_hap)
    for name, fn in (("the kernel before", before(c, 0)),
                     ("the port's K15", port(c))):
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name} != the plain version")
    # the input's shape
    bins = counts.global_sfs_bins_plain(c, n_hap)
    dims = np.asarray(n_hap) + 1
    b = bins.cpu().numpy()
    digits = np.stack([(b // int(np.prod(dims[p + 1:]))) % dims[p]
                       for p in range(P)], axis=1)
    runs = b[:len(b) // 32 * 32].reshape(-1, 32)
    cdim = counts.sfs_corner(n_hap, counts._K15_CORNER_BYTES)
    stats = {"sites": S, "binned": int(b.size), "bin0": int(want[0]),
             "bin0_share": float(want[0]) / S,
             "nonzero_bins": int((want > 0).sum()),
             "distinct_bins_in_32": float(np.mean(
                 [len(np.unique(r)) for r in runs])),
             "corner_k": int(cdim.max()) - 1,
             **{f"share_k{k}": float((digits <= k).all(axis=1).sum()) / S
                for k in CORNER_K}}
    log("[shape] " + json.dumps(stats))
    outside = bins[~torch.from_numpy((digits < cdim).all(axis=1)).to(dev)]
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    n16 = c.numel() * c.element_size() // 16
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    times = turns({
        "zeros": lambda: torch.zeros(nbins, dtype=torch.int32, device=dev),
        "before": before(c, 0),
        "before_alone": before(c, 0, zero=False),
        "before_no_atomics_alone": before(c, 1, zero=False),
        "before_no_bin0_atomics_alone": before(c, 2, zero=False),
        "atomics_outside_corner_alone": lambda: _build.check(
            lib.k15_atomics_only(outside.data_ptr(), outside.numel(),
                                 scratch.data_ptr(), blocks, stream()),
            "k15_atomics_only"),
        "reads_alone": lambda: _build.check(
            lib.k15_reads_only(c.data_ptr(), n16, out.data_ptr(), blocks,
                               stream()), "k15_reads_only"),
        "port": port(c),
    })
    for k, v in times.items():
        log(f"[time] {k}: {v[0]:.4f} / {v[1]:.4f} ms in a CUDA graph")
    # one bin for every site: inside the corner (bin 0) and outside it
    one_bin = {}
    rows = {"all monomorphic": [[128, 0, 0, 0]] * P,
            "all in one bin outside the corner": [[0, 128, 0, 0]]
            + [[128, 0, 0, 0]] * (P - 1)}
    for name, row in rows.items():
        x = torch.tensor(row, dtype=torch.uint16, device=dev)[None].expand(
            S, P, 4).contiguous()
        w = counts.global_sfs_hist_plain(x, n_hap)
        fns = {"before": before(x, 0), "port": port(x)}
        for k, fn in fns.items():
            if not torch.equal(fn(), w):
                raise AssertionError(f"{k} on {name} != the plain version")
        one_bin[name] = turns(fns)
        log(f"[time] {name}: the kernel before "
            f"{one_bin[name]['before'][0]:.4f} / "
            f"{one_bin[name]['before'][1]:.4f} ms, the port's K15 "
            f"{one_bin[name]['port'][0]:.4f} / "
            f"{one_bin[name]['port'][1]:.4f} ms in a CUDA graph")
    report = {"card": card, "shape": stats, "graph_ms": times,
              "one_bin_graph_ms": one_bin,
              "atomics_outside_corner": int(outside.numel())}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    log(card)
    log(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
