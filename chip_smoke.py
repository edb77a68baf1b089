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
   5 groups, against the C site counter too, and at the edges of its
   row-slot loop (blocks from s0 = 0 and nonzero multiples of 8 ending
   mid-word, 8 and 16 lanes, a 33-row group, 8,300 rows in one group, a
   10-row overlapping mask's classes; uint16 and int32); on ABBA inputs (an uncalled
   outgroup block, 50/50 tie sites, fixed sites) in every mode, panel and
   minData 0.3 / 0, on disjoint and overlapping populations: K6 on the
   membership-class partition against the C site counter, K7
   abba_site_terms against its plain version and the host executor's
   per-site terms exactly (NaN positions equal), K8 abba_window_sums
   against its plain version within rtol 1e-12 of the window's sum of
   |terms|, also at its edges (K = 8 and 18; windows of 0, 1 and odd
   lengths, 2x and 3x overlap, shuffled; NaN terms; terms 8 bytes past a
   16-byte boundary), two launches bit-equal and windows launched alone
   bit-equal to the batch; K9 pair_counts_4state on messy inputs (H = 160
   and 77, S = 70,003, windows of 0 and 1 site, unaligned starts, one of
   66,000 sites)
   against its plain version and the host executor exactly, on its split
   (atomic) and unsplit paths and on row-strided input, and at the edges
   of its 128 x 128 tensor-core tiles (H = 1, 17, 77, 160, 512, 1000;
   codes -7, 5 and 127; windows at odd starts of lengths that are not
   multiples of 32; split on and off; its cp.async staging on strides
   that are multiples of 16, shifted or not, and its register staging on
   odd strides); K10
   window_stats_tail against its plain version (rtol 1e-6, NaN positions
   equal) and K11 window_pop_counts exactly, with 5 and 1 populations,
   also at the edges of its 16-byte vectors and classes (row strides
   70,016, S and 70,011 from 3 columns in; windows of 0..625 sites at
   every start mod 16, clipped at 0 and S, and of 66,001 sites; codes -7,
   5, 127; P = 5 with rows in none, 1, 77 and 1,100); K12
   site_pop_counts_raw (H = 77, S = 5,003, codes -7..5, strided rows,
   blocks starting anywhere, uint16 and int32, 10 groups and a 10-row
   overlapping mask's classes) against its plain version, and equal to K6
   on the same alleles, and at its block edges (1-site and unaligned
   blocks at an odd row stride, run H's 10 mask rows as 9 classes, a
   33-row class, 33 rows as 33 classes, 8,300 rows in one class); K13
   pair_counts_v2 + K2 against their plain versions and against K1 + K2
   on the same flushes, with K3 (bit for bit), K4 and K5 on both; K1 and
   K13 at the edges of their 64 x 64 upper-triangle tiles (H = 1 to 1,000
   around the tile size, from w0 = 0, 1, 3 and in one-window chunks, class
   ranges starting at every bit offset 0..31, empty, all-monomorphic and
   one-class windows, one of 66,000 sites) exactly against their plain
   versions with every (w, i, j) cell written, and K13 + K2 == K1 + K2; K14
   pair_counts_4state_rows on row blocks that cut K9's tiles against K9's
   rows and its plain version (the split path too), also at K9's tile
   edges (rows 100..300 and 127..129 at H = 512, 999..1000 at H = 1000; on
   K9's four layouts, so both staging paths; split on and off), and the
   mesh's data- and tensor-parallel pair counts on two shards of the card
   against K9 (two-window shards on K9's split path);
   K15 global_sfs_hist on counts built to tie against its plain version
   (uint16 and int32); K16 stacked_reduce (sum, min; int64 beyond 2^31,
   int32) against torch.sum / torch.amin, also at the edges of its 16-byte
   vectors (k = 1..4, n = 1 to 4,099 and not a multiple of the vector,
   stacks starting one element past a 16-byte boundary, sums wrapping);
   K7 at the edges of its tile and selection (S = 1, 129, 5,003; outgroup
   classes outside the union, so sites select 0, 1 or 2 alleles; NaN
   outgroups; counts staged, read in place and staged off a 16-byte
   boundary) against its plain version bit for bit; window_stats_step
   over 66,000 windows (past the 65,535 a K9 or K11 launch takes) equal
   to its chunks run one at a time; K17 pair_allele_tables (H = 160 and
   77, S = 0, 1, 33, 517, codes -7..5, strided rows; at its tile edges,
   H = 1, 77, 160,
   512 with S = 1, 31, 33, 597, 2,048, and S = 597 on strided rows), K18 site_nonmissing (1 and 5
   populations, a 10-row overlapping mask; at an odd row stride, spans
   ending inside a block at 16 and 8 lanes, one population of 600 rows,
   an all-zero mask row, rows in no population, 70 mask rows) and K19
   sample_base_counts
   exactly; K20 flush_pair_counts on flushes with 0- and 1-site, pad and
   s_max-cut windows, unaligned metadata and the int32 branch, equal to
   its plain version and to K9 + K4 on the unpacked flush, and at the
   edges of its 64 x 64 tiles, words and loads (H = 1 to 1,000, windows
   starting at every site offset 0..31, 16-byte and byte loads, the int32
   branch) exactly with every output cell written; K10 bit for bit
   against its plain version on messy, one-population, one-row-a-class
   and fractional masks, NaN windows and run G's shape;
3. the runs end to end through the port's CLIs at H = 512 (256 diploid
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
   the device busy time.  Then three more: run E, distMat --windType cat
   on the 500,000-site cohort (K9), byte-equal to GGT_EXEC=host, with a
   traced run; run F, windowed distMat with --windowDataOutFile (K1, K2,
   K4), byte-equal under GGT_PACKED_TRANSFER=0 (K9, K4) and GGT_EXEC=host;
   run G, the port's entry() step at H = 512, P = 4 over 128 windows of
   the cohort's first 80,000 sites made complete (K9, K10, K11), its counts
   against the wire-v3 route's (K1 + K2 + K4) exactly and its statistics
   against the float64 CSV-exact path at the JAX test's tolerance.  Then
   the count CLIs, each on its span-wire (K6), raw-upload (K12) and host
   routes, byte-identical and launching exactly its route's kernels: run H,
   freq --target derived --minData 0.5 with the 256 individuals in 9
   populations (10 overlapping mask rows), with a traced run; run I, sfs
   -p pop1 -p pop2 -p pop3 --doPairs on a 200,000-site cohort with 0.5 %
   missing genotypes; run J, filterGenotypes -of coded on the cohort's
   first 4,000 sites.  Run K reruns popDist, A and B under GGT_WIRE=2
   (K13 in place of K1), run L reruns A (K9 + K4 + K12 from one raw upload
   per flush) and C (kernel route K6-K8; GGT_ABBA_HOST=1 through K12)
   under GGT_PACKED_TRANSFER=0: each byte-identical to its first run.
   Runs M and N rerun A and C with cli.common.get_mesh patched to a mesh
   of two shards of the card (M: K9 + K4 on each window slab and K6 on
   each site slab, no K1; N: K6 + K7 on each replica, K8 on each window
   slab), every launch inside a shard's call and every shard launching,
   each byte-identical to its meshless run; run O reruns popDist on that
   mesh, which takes it off the blocks route (K9 + K4, the host's tri
   finalize), within one rounding quantum of its blocks run; then the
   port's dryrun_multichip over every card (K14, K15, K16 launched).
   Run P: stats.ld.ld_matrix(r2, use_device=True) over the popDist
   cohort's first 32 windows (K17 once a window), each window's tables
   equal to the plain version's and the first two matrices bit-equal to
   use_device=False; run R: the library entry points no CLI calls, once
   each at full width (K18 over run A's largest count span, K19 over
   65,536 sites, K20 on run A's largest flush), equal to K6, K12 and K9 +
   K4; run Q: phymlSlidingWindows (builtin NJ, --maxLDphase, one
   bootstrap, -T 4) on run F's first scaffold and raxmlSlidingWindows on
   run F's cohort, one tree ending in ';' a window;
2b. parity and times at the runs' largest flushes: each kernel's, its
   plain version's and its library yardstick's time from CUDA events over
   calls as they come (every kernel's, K7's and K8's also at run D's
   flush, and the yardsticks of K6, K9, K12, K14, K16, K17, K18 and K20, also
   over calls replayed from a CUDA graph, logged beside: the device's time
   without the wrappers' host overhead; K16 also in a graph with a 64 MB
   write before each call, the L2 cold, and its wrapper's host time step
   by step),
   beside the bound computed from these inputs (K9 at run E's block and
   at run F's and run A's largest flushes, where the K9 + K4 and K1 + K2 +
   K4 routes are timed side by side; K10 and K11 at run G's shape; K12 at
   run H's span beside K6, K13 at the popDist chunk beside K1 (both also
   in a CUDA graph) and K1 beside K9 at run A's flush, and K13 + K2 +
   tails against K1 + K2 + tails on run A's and run B's flushes;
   K14 at run A's largest flush on two row shards; K15 and K16 over the
   500,000-site cohort's first three populations made complete, 129^3
   bins, against the mesh's sharded_global_sfs on two shards; K17 at run
   P's first window and at 2,048 sites beside the bf16 one-hot Gram and
   torch._int_mm of the int8 one-hot, K18,
   K19 and K20 at run R's inputs, K20 beside K9 + K4 and K9's two bf16
   one-hot Grams; K11 beside one torch.einsum of the mask with per-window
   code counts); K2 and K3 at the
   popDist chunk also in a CUDA graph (K2 with its per-window entry index
   built once, as each flush builds it, and that index's time); K3 on the
   popDist chunk's counts with popDist's mask, ind_layout(512)'s and two
   masks of uneven groups (an empty group, a one-row group; one in each
   launch shape), and on run B's individual mask, each against its plain
   version and bit-equal across two launches (the individual masks also
   to the host executor's blocks), and its two launch shapes (a thread or a block per
   cell) timed side by side on groups of 2 to 128 rows; K2 exactly against
   its plain version on a chunk at w0 = 3 and on a half-step overlapping
   flush (entries not sorted by window); K16 also in a CUDA graph beside
   torch.sum;
4. the popDist goldens and the full-panel popgen_coord.csv golden of
   tests/golden through the port's CLI on the card, the fused
   individual-blocks route against GGT_HOST_DIST_FINALIZE=1 on four
   analysis sets, within one rounding quantum, the three ABBA goldens
   within one quantum (at tol 0 under GGT_ABBA_HOST=1), the five
   distMat / distPaint goldens at tol 0, the popgen goldens again under
   GGT_WIRE=2 (byte-identical), and the freq (2), sfs (9) and
   filterGenotypes (5) goldens at tol 0.

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
    "pair_counts_4state": ("pair4.cu",
                           "genomics_general_tpu/kernels/pairdist.py:46"),
    "window_stats_tail": ("window_stats.cu",
                          "genomics_general_tpu/kernels/window_stats.py:49"),
    "window_pop_counts": ("window_stats.cu",
                          "genomics_general_tpu/kernels/window_stats.py:83"),
    "site_pop_counts_raw": ("counts.cu",
                            "genomics_general_tpu/kernels/counts.py:36"),
    "pair_counts_v2": ("pair_v3.cu",
                       "genomics_general_tpu/kernels/pairdist.py:288"),
    "pair_counts_4state_rows": ("pair4.cu",
                                "genomics_general_tpu/parallel/mesh.py:74"),
    "global_sfs_hist": ("counts.cu",
                        "genomics_general_tpu/parallel/mesh.py:134"),
    "stacked_reduce": ("counts.cu",
                       "genomics_general_tpu/parallel/multihost.py:161"),
    "pair_allele_tables": ("ld.cu", "genomics_general_tpu/kernels/ld.py:25"),
    "site_nonmissing": ("counts.cu",
                        "genomics_general_tpu/kernels/counts.py:55"),
    "sample_base_counts": ("counts.cu",
                           "genomics_general_tpu/kernels/counts.py:178"),
    "flush_pair_counts": ("pair4.cu",
                          "genomics_general_tpu/kernels/pairdist.py:552"),
}
SOURCES = ("pair_v3", "counts", "abba", "pair4", "window_stats", "ld")
# H100 SXM data-sheet rates (the bound's denominators); a card set below
# its 700 W limit runs slower than these
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 34e12
INT8_OPS_PER_S = 1979e12              # dense int8 tensor rate (K9's bound)
# results per clock per SM for compute capability 9.0 (CUDA C++
# Programming Guide, throughput of native arithmetic instructions)
INT32_PER_CLK_SM = 64
SECTOR = 32                           # bytes per device-memory sector
RTOL, ATOL = 1e-12, 1e-15
# the full-width cohort: 4 pops x 64 diploid individuals (H = 512)
N_SITES, INDS_PER_POP = 500_000, 64
N_SITES_B = 100_000                   # run B's depth (32,896 d_ columns)
# run F: run B's density (12.5 sites per kb) cut to 8 windows of 50 kb —
# distMat's finalize walks 256^2 individual blocks per window on the host
N_SITES_F, SCAFFOLD_F = 5_000, 100_000
N_SITES_G, WINDOWS_G = 80_000, 128     # run G: the entry() step's batch
# run I: sfs needs complete sites, so its cohort has 0.5 % missing
# genotypes (5 % leaves no site complete in 384 haplotypes); cut to 200,000
# sites on 4 x 4 Mb (the popDist density) to bound the second cohort's
# generation
N_SITES_I, SCAFFOLD_I, MISSING_I = 200_000, 4_000_000, 0.005
# run J: the popDist cohort's first 4,000 sites — filterGenotypes
# assembles ~256 output columns per site in Python (~2 ms a site at H = 512)
N_SITES_J = 4_000
K10_RTOL = 1e-6                       # K10 vs its plain version (float32)
G_RTOL, G_FST_RTOL, G_FST_ATOL = 2e-5, 2e-4, 2e-5  # run G vs float64
QUANTUM = 1e-4                        # one --roundTo 4 rounding step
# runs M and N: the device mesh as two shards of one card (the chip has
# one); the K15 phase: the popDist cohort's first three populations (128
# haplotypes each: 129^3 bins), missing calls filled as in run G
MESH_SHARDS = 2
SFS_POPS = ["pop1", "pop2", "pop3"]
# K9's tile-edge checks: haplotype counts around its 128-row tiles
K9_EDGE_H, K9_EDGE_S = (1, 17, 77, 160, 512, 1000), 5_003
# K14's row blocks at those edges: blocks that cut K9's 128-row tiles
K14_EDGE_BLOCKS = {512: [(100, 300), (127, 129), (0, 256), (256, 512)],
                   1000: [(100, 300), (999, 1000)]}
# K17's edges: its 128 x 128 Gram tiles are 32 x 32 sites, its K steps 32
# haplotypes; K6's: site blocks from s0 (a multiple of 8) ending mid-word,
# a group past 255 rows a slot, a mask's classes, 16 lanes a row
K17_EDGE_H, K17_EDGE_S = (1, 77, 160, 512), (1, 31, 33, 597, 2048)
# K16's edges: stacks of 1..4 rows, n below, at and past its 16-byte
# vectors, and n not a multiple of them
K16_EDGE_K, K16_EDGE_N = (1, 2, 3, 4), (1, 3, 4, 5, 1001, 4099)
K6_EDGE = ((77, 1003, 0, 1003), (77, 1003, 8, 1003), (33, 517, 24, 517),
           (129, 131, 0, 129), (5, 9, 8, 9), (600, 37, 16, 35),
           (8300, 13, 8, 13), (77, 70003, 8, 70001))
# K1's and K13's tile edges: haplotype counts around their 64 x 64 pair
# tiles; a cell no launch writes keeps SENTINEL
K1_EDGE_H = (1, 12, 40, 63, 64, 65, 77, 160, 512, 1000)
SENTINEL = -(1 << 30)
# K11's edges: rows at an odd stride and at 16-byte multiples, windows of
# these lengths at every start offset mod 16 (and one past 66,000 sites)
K11_EDGE_H, K11_EDGE_S = 77, 70_003
K11_EDGE_LEN = (0, 1, 15, 16, 17, 31, 33, 625)
# K8's edges: window lengths (S: the whole span) and the windows each
# launched alone
K8_EDGE_S, K8_EDGE_LEN, K8_EDGE_ALONE = 5_003, (0, 1, 3, 7, 33, 625, 1251), 24
# window_stats_step past K9's and K11's 65,535-window grid axis
STEP_WINDOWS, STEP_H, STEP_SITES = 66_000, 8, 70_000
# run P: ld_matrix over the popDist cohort's first 32 windows of 50 kb,
# the first 2 also through numpy's int64 Gram (seconds a window at H = 512);
# run R's sample_base_counts block (16 bytes out a call: 537 MB at H = 512)
LD_WINDOWS, LD_EXACT_WINDOWS, K19_SITES = 32, 2, 65_536
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
DISTMAT_ARGS = {
    "run_E": ["--windType", "cat", "--outFormat", "phylip"],
    "run_F": ["-w", "50000", "-m", "100", "--outFormat", "phylip"],
}
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


def graph_ms(fn, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so no host launch overhead lies between the kernels (it sets
    the pace of :func:`cuda_ms` for a kernel shorter than its wrapper's
    Python)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / (3 * reps)


def cold_graph_ms(fn, reps: int, scratch) -> float:
    """Device time per call with the 50 MB L2 cache cold: each captured
    call follows a write of ``scratch`` (64 MB), and the time of a graph of
    those writes alone is taken off."""
    def after_write():
        scratch.zero_()
        fn()
    return graph_ms(after_write, reps) - graph_ms(scratch.zero_, reps)


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
    k1 = lambda: pair.pair_counts_v3(wire, 0, nwin)  # noqa: E731
    res["pair_counts_v3"]["ms"] = cuda_ms(k1, 20)
    res["pair_counts_v3"]["graph_ms"] = graph_ms(k1, 20)
    res["pair_counts_v3"]["plain_ms"] = cuda_ms(
        lambda: pair.pair_counts_v3_plain(wire, 0, nwin), 3, 1)
    mt, st = m.clone(), s.clone()
    # the main path builds K2's entry index once per flush
    index = pair.exception_index(wire)
    k2 = lambda: pair.exception_patch(mt, st, wire, 0, index)  # noqa: E731
    res["exception_patch"]["ms"] = cuda_ms(k2, 20)
    res["exception_patch"]["graph_ms"] = graph_ms(k2, 20)
    res["exception_patch"]["index_ms"] = cuda_ms(
        lambda: pair.exception_index(wire), 20)
    res["exception_patch"]["plain_ms"] = cuda_ms(
        lambda: pair.exception_patch_plain(mt, st, wire, 0), 3, 1)
    k3 = lambda: pair.blocks_tail(  # noqa: E731
        mk, sk, groups, min_sites, out)
    res["blocks_tail"]["ms"] = cuda_ms(k3, 20)
    res["blocks_tail"]["graph_ms"] = graph_ms(k3, 20)
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
    max(bytes / HBM rate, operations / peak rate of their type).  K1's
    1-bit tensor-core products have no data-sheet rate, so its bound is
    its bytes: the covered words of each class plane read once, the
    metadata, m and s written."""
    H, nwin, P = shapes["H"], shapes["nwin"], shapes["P"]
    meta = shapes["meta"].astype(np.int64)
    words_read = 0
    for cls, planes in ((0, 1), (1, 1), (2, 2)):
        f, n = meta[2 * cls, :nwin], meta[2 * cls + 1, :nwin]
        has = n > 0
        if has.any():
            lo = int((f[has] >> 5).min())
            hi = int(((f[has] + n[has] - 1) >> 5).max())
            words_read += (hi - lo + 1) * planes * H
    k1_bytes = 4 * words_read + 28 * nwin + 8 * nwin * H * H
    ex_w = shapes["ex_w"]
    active = ex_w[(ex_w >= 0) & (ex_w < nwin)]
    touched = np.unique(active).size
    k2_bytes = shapes["ex_bytes"] + 2 * 2 * 4 * touched * H * H
    return {
        "pair_counts_v3": bound(k1_bytes),
        "exception_patch": bound(k2_bytes, 3 * active.size * H * H,
                                 INT32_PER_CLK_SM * sm_count * clk_hz),
        "blocks_tail": blocks_tail_bound(nwin, H, P),
    }


def blocks_tail_bound(nwin: int, H: int, P: int):
    """K3: the [nwin, H, H] counts once, the perm / offs, [nwin, 2, P, P]
    written; 3 f64 operations per off-diagonal pair."""
    return bound(8 * nwin * H * H + 16 * nwin * P * P + 4 * (2 * H + P + 1),
                 3 * nwin * H * (H - 1), FP64_PER_S)


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
        err = max(err, hold_blocks_tail(pair, m, s, groups, min_sites,
                                        f"{kind} mask", kind == "ind"))
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


def raw_counts_parity(counts, transfer, pair, dev):
    """K12 against its plain version on a messy input: H = 77, S = 5,003
    (not a multiple of 4), codes outside 0..3 and below -1, rows read
    through a stride (an offset view of a wider matrix), blocks that start
    anywhere, uint16 and int32 out, 10 groups and the classes of a 10-row
    overlapping mask; and K12 equal to K6 on the same alleles."""
    import torch
    rng = np.random.default_rng(12)
    H, S, P = 77, 5003, 10
    a = rng.integers(-1, 4, size=(H, S)).astype(np.int8)
    hit = rng.random((H, S))
    a[hit < 0.02] = 5
    a[(hit >= 0.02) & (hit < 0.03)] = -7
    wide = torch.full((H, S + 13), -1, dtype=torch.int8, device=dev)
    wide[:, 3:S + 3] = torch.from_numpy(a).to(dev)
    al = wide[:, 3:S + 3]
    part = np.zeros((P, H))
    part[rng.integers(0, P, size=H), np.arange(H)] = 1.0
    over = (rng.random((P, H)) < 0.3).astype(np.float64)
    over[P - 1] = 1.0
    classes = counts.MaskClasses(over, dev)
    bounds_ = [0, 3, 1000, 1001, 4096, S]
    for kind, groups in (("groups", pair.PopGroups(part, dev)),
                         ("classes", classes.groups)):
        want = counts.site_pop_counts_raw_plain(al, 0, S, groups.mask)
        for dt in (torch.uint16, torch.int32):
            out = torch.empty((S, groups.P, 4), dtype=dt, device=dev)
            for s0, s1 in zip(bounds_[:-1], bounds_[1:]):
                counts.site_pop_counts_raw(al, s0, s1, groups, out[s0:s1])
            check_equal(f"site_pop_counts_raw ({kind}, {dt}) vs plain", out,
                        want)
    check_equal("site_pop_counts_raw classes combined vs the mask's plain",
                torch.from_numpy(classes.combine(out.cpu().numpy())),
                counts.site_pop_counts_raw_plain(al, 0, S,
                                                 torch.from_numpy(over)))
    b = np.where((a < 0) | (a > 3), -1, a).astype(np.int8)
    buf, Sp = transfer.pack_span(b)
    groups = pair.PopGroups(part, dev)
    check_equal("site_pop_counts_raw vs site_pop_counts (raw vs packed)",
                counts.count_raw(torch.from_numpy(b).to(dev), S, groups,
                                 block=1000),
                counts.count_span(torch.from_numpy(buf).to(dev), Sp, H, S,
                                  groups, block=1000))
    torch.cuda.synchronize()


def k12_edge_parity(counts, transfer, pair, dev) -> int:
    """K12 at the edges of its blocks against its plain version, uint16 and
    int32 out: H = 77 with codes -7..5 and 127 at an odd row stride, site
    blocks of 1, 1, 1, 15, 1,011, 973 and 1 sites from s0 = 0, 1, 2, 3,
    18, 1,029, 2,002 (none past 0 a multiple of 4 or 16), on a partition
    with a 33-row class and on a 10-row overlapping mask's classes (8
    lanes a row), and 2,001 sites from s0 = 1 on 77 one-row classes (16
    lanes); run
    H's layout (H = 512, its 9 populations and their union: 10 overlapping
    rows as 9 classes), equal to K6 too; 33 rows as one class and as 33;
    and 8,300 rows as one class (each row slot's byte counters widen past
    255 rows).  Returns the number of comparisons."""
    import torch
    rng = np.random.default_rng(21)
    checks = 0

    def hold(name, al, groups, bounds_, mask):
        nonlocal checks
        S = bounds_[-1]
        want = counts.site_pop_counts_raw_plain(al, 0, S, mask)
        for dt in (torch.uint16, torch.int32):
            out = torch.empty((S, groups.P, 4), dtype=dt, device=dev)
            for s0, s1 in zip(bounds_[:-1], bounds_[1:]):
                counts.site_pop_counts_raw(al, s0, s1, groups, out[s0:s1])
            check_equal(f"site_pop_counts_raw {name} ({dt}) vs plain", out,
                        want)
            checks += 1
        return out

    H, S = 77, 2003
    a = rng.integers(-1, 4, size=(H, S)).astype(np.int8)
    hit = rng.random((H, S))
    for k, code in enumerate((5, -7, 127)):
        a[(hit >= 0.01 * k) & (hit < 0.01 * (k + 1))] = code
    wide = torch.full((H, S + 16), -1, dtype=torch.int8, device=dev)
    wide[:, 3:S + 3] = torch.from_numpy(a).to(dev)
    al = wide[:, 3:S + 3]                       # row stride 2,019
    part = np.zeros((4, H))
    cls = np.concatenate([np.zeros(33, int), rng.integers(1, 4, H - 33)])
    part[cls, np.arange(H)] = 1.0
    over = (rng.random((10, H)) < 0.3).astype(np.float64)
    over[9] = 1.0
    classes = counts.MaskClasses(over, dev)
    edges = [0, 1, 2, 3, 18, 1029, 2002, S]
    hold("H=77, odd stride, a 33-row class", al,
         pair.PopGroups(part, dev), edges, torch.from_numpy(part))
    hold("H=77, odd stride, 10-row mask classes", al, classes.groups,
         edges, classes.groups.mask)
    # a class a row: 2,001 sites from s0 = 1 take 16 lanes a row, the
    # blocks above 8
    solo = np.eye(H)
    if counts._k12_lanes(2001, H, dev) != 16:
        raise AssertionError("77 one-row classes should take 16 lanes")
    hold("H=77, odd stride, 77 one-row classes", al,
         pair.PopGroups(solo, dev), [0, 1, 2002, S], torch.from_numpy(solo))

    H, S = 512, 3001
    b = rng.integers(-1, 4, size=(H, S)).astype(np.int8)
    pops = np.minimum(np.arange(H // 2) // 28, 8).repeat(2)
    mask = np.zeros((10, H))
    mask[pops, np.arange(H)] = 1.0
    mask[9] = 1.0
    classes = counts.MaskClasses(mask, dev)
    if classes.groups.P != 9:
        raise AssertionError("run H's 10 mask rows should make 9 classes")
    bt = torch.from_numpy(b).to(dev)
    out = hold("run H's layout, 9 classes", bt, classes.groups,
               [0, 5, 1029, S], classes.groups.mask)
    buf, Sp = transfer.pack_span(b)
    check_equal("site_pop_counts_raw vs site_pop_counts (run H's layout)",
                out, counts.count_span(torch.from_numpy(buf).to(dev), Sp, H,
                                       S, classes.groups))
    checks += 1

    c = torch.from_numpy(a[:33, :517].copy()).to(dev)
    for P in (1, 33):
        m = np.zeros((P, 33))
        m[np.arange(33) % P, np.arange(33)] = 1.0
        hold(f"33 rows as {P} class(es)", c, pair.PopGroups(m, dev),
             [0, 7, 517], torch.from_numpy(m))
    tall = torch.from_numpy(
        rng.integers(-1, 4, size=(8300, 37)).astype(np.int8)).to(dev)
    one = np.ones((1, 8300))
    hold("8,300 rows as one class", tall, pair.PopGroups(one, dev), [0, 37],
         torch.from_numpy(one))
    torch.cuda.synchronize()
    return checks


def v2_parity(pair, a, first, n, dev, masks, min_sites, het_rows=None,
              nwin=None):
    """K13 + K2 and the tails on wire v2 for windows [0, nwin) of one flush
    (default: its first chunk): K13 equal to its plain version (also from
    window 1), K13 + K2 equal to plain K13 + plain K2 and to K1 + K2 on the
    wire-v3 buffer of the same flush, and K4, K3 on each mask and K5 on
    ``het_rows`` equal on the two wires (K3's f64 blocks bit for bit).
    Returns (wire, nwin, u16) of the v2 flush."""
    import torch
    v2 = pair._v2_flush_args(a, first, n)
    v3 = pair._v3_flush_args(a, first, n)
    W, H = first.shape[0], a.shape[0]
    nwin = min(nwin or v2.chunk, W)
    w2 = v2.wire(torch.from_numpy(v2.buf).to(dev))
    w3 = v3.wire(torch.from_numpy(v3.buf).to(dev))
    m, s = pair.pair_counts_v2(w2, 0, nwin)
    mp, sp = pair.pair_counts_v2_plain(w2, 0, nwin)
    check_equal("pair_counts_v2 m vs plain", m, mp)
    check_equal("pair_counts_v2 s vs plain", s, sp)
    if W > 2:
        k = min(nwin, W - 1)
        m1, s1 = pair.pair_counts_v2(w2, 1, k)
        m1p, s1p = pair.pair_counts_v2_plain(w2, 1, k)
        check_equal("pair_counts_v2 m (w0=1) vs plain", m1, m1p)
        check_equal("pair_counts_v2 s (w0=1) vs plain", s1, s1p)
        del m1, s1, m1p, s1p
    pair.exception_patch(m, s, w2, 0)
    pair.exception_patch_plain(mp, sp, w2, 0)
    check_equal("K13 + K2 m vs plain", m, mp)
    check_equal("K13 + K2 s vs plain", s, sp)
    del mp, sp
    m3, s3 = pair.pair_counts_v3(w3, 0, nwin)
    pair.exception_patch(m3, s3, w3, 0)
    check_equal("K13 + K2 m vs K1 + K2", m, m3)
    check_equal("K13 + K2 s vs K1 + K2", s, s3)
    T = H * (H + 1) // 2
    dt = torch.uint16 if v2.u16 else torch.int32
    tri2 = torch.empty((nwin, 2 * T), dtype=dt, device=dev)
    tri3 = torch.empty_like(tri2)
    pair.tri_pack(m, s, tri2)
    pair.tri_pack(m3, s3, tri3)
    check_equal("tri_pack on K13 vs on K1 counts", tri2, tri3)
    for mask in masks:
        groups = pair.PopGroups(mask, dev)
        b2 = torch.empty((nwin, 2, groups.P, groups.P), dtype=torch.float64,
                         device=dev)
        b3 = torch.empty_like(b2)
        pair.blocks_tail(m, s, groups, min_sites, b2)
        pair.blocks_tail(m3, s3, groups, min_sites, b3)
        check_same(f"blocks_tail (P={groups.P}) on K13 vs on K1 counts", b2,
                   b3)
    if het_rows is not None:
        r1, r2 = pair._het_rows(het_rows, H, dev)
        h2 = torch.empty((nwin, r1.shape[0], 2), dtype=torch.float64,
                         device=dev)
        h3 = torch.empty_like(h2)
        pair.het_pairs(m, s, r1, r2, h2)
        pair.het_pairs(m3, s3, r1, r2, h3)
        check_equal("het_pairs on K13 vs on K1 counts", h2, h3)
    torch.cuda.synchronize()
    return w2, nwin, v2.u16


def class_input(H: int, cls: str, seed: int):
    """Alleles whose sites are all of one wire-v3 class — "B" monomorphic
    with missing calls, "C" clean biallelic, "D" biallelic with missing
    calls — so each window's class range starts where the window does: 32
    windows at sites 33 k (every bit offset 0..31 of a word) of 1 to 699
    sites.  H >= 3."""
    rng = np.random.default_rng(seed)
    S = 33 * 32 + 700
    a = np.ones((H, S), np.int8)
    if cls != "B":
        a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
        a[0], a[1] = 0, 1
    if cls != "C":
        a[2 + rng.integers(0, H - 2, S), np.arange(S)] = -1
    k = np.arange(32)
    return a, (33 * k).astype(np.int32), (1 + 97 * k % 699).astype(np.int32)


def pair_counts_filled(pair, wire, w0: int, nwin: int):
    """K1 (wire v3) or K13 (wire v2) launched as its wrapper launches it,
    but into m and s filled with SENTINEL first (a test-only allocation:
    the wrappers allocate with torch.empty), so a cell no block writes
    shows.  Not counted in LAUNCHES."""
    import torch
    h = wire.h
    m = torch.full((nwin, h, h), SENTINEL, dtype=torch.int32,
                   device=wire.buf.device)
    s = torch.full_like(m, SENTINEL)
    lib = pair._build.lib("pair_v3")
    stream = torch.cuda.current_stream(m.device).cuda_stream
    if hasattr(wire, "called"):
        code = lib.ggt_pair_counts_v2(
            wire.called.data_ptr(), wire.alt.data_ptr(),
            wire.first.data_ptr(), wire.n_sites.data_ptr(), h,
            wire.called.shape[1], w0, nwin, m.data_ptr(), s.data_ptr(),
            stream)
    else:
        code = lib.ggt_pair_counts_v3(
            wire.cB.data_ptr(), wire.meta.data_ptr(), h, wire.cB.shape[1],
            wire.aC.shape[1], wire.cD.shape[1], wire.wp, w0, nwin,
            m.data_ptr(), s.data_ptr(), stream)
    pair._build.check(code, "pair counts (sentinel-filled)")
    return m, s


def hold_pair_counts(pair, wires, w0: int, nwin: int, what: str) -> int:
    """K1 on the wire-v3 and K13 on the wire-v2 buffer of one flush,
    windows w0 .. w0 + nwin - 1: each exactly its plain version, every
    (w, i, j) cell written (SENTINEL-filled launch), and K13 + K2 == K1 +
    K2.  Returns the number of comparisons."""
    import torch
    w3, w2 = wires
    patched = []
    for name, wire, kernel, plain in (
            ("K1", w3, pair.pair_counts_v3, pair.pair_counts_v3_plain),
            ("K13", w2, pair.pair_counts_v2, pair.pair_counts_v2_plain)):
        m, s = kernel(wire, w0, nwin)
        mp, sp = plain(wire, w0, nwin)
        mf, sf = pair_counts_filled(pair, wire, w0, nwin)
        torch.cuda.synchronize()
        unwritten = int((mf == SENTINEL).sum() + (sf == SENTINEL).sum())
        if unwritten:
            raise AssertionError(f"{name} ({what}): {unwritten} cells of m "
                                 "and s never written")
        for tag, got in (("", (m, s)), (", sentinel-filled", (mf, sf))):
            check_equal(f"{name} m{tag} ({what})", got[0], mp)
            check_equal(f"{name} s{tag} ({what})", got[1], sp)
        pair.exception_patch(m, s, wire, w0)
        patched.append((m, s))
        del mp, sp, mf, sf
    check_equal(f"K13 + K2 m vs K1 + K2 ({what})", patched[1][0],
                patched[0][0])
    check_equal(f"K13 + K2 s vs K1 + K2 ({what})", patched[1][1],
                patched[0][1])
    return 6


def k1_k13_edge_parity(pair, dev) -> int:
    """K1 and K13 at the edges of their 64 x 64 upper-triangle tiles:
    messy_input at every H of K1_EDGE_H with four more windows (all
    monomorphic and complete: nconst only; clean biallelic: classes B and
    D empty; empty; 3 sites at the end), from w0 = 0, 1, 3, the last four
    windows and the last window alone (a chunk of one); class_input's
    windows, whose B, C and D ranges start at every bit offset 0..31, at H
    = 77 and 512; and long_window_input's 66,000-site window.  Returns the
    number of comparisons."""
    import torch

    def wires(a, first, n):
        v3 = pair._v3_flush_args(a, first, n)
        v2 = pair._v2_flush_args(a, first, n)
        return (v3.wire(torch.from_numpy(v3.buf).to(dev)),
                v2.wire(torch.from_numpy(v2.buf).to(dev))), v3.chunk
    done = 0
    for H in K1_EDGE_H:
        a, first, n, _ = messy_input(H)
        first = np.concatenate([first, [200, 600, 0, 5000]]).astype(np.int32)
        n = np.concatenate([n, [200, 200, 0, 3]]).astype(np.int32)
        ws, chunk = wires(a, first, n)
        W = first.shape[0]
        for w0, k in ((0, chunk), (1, chunk), (3, chunk), (W - 4, 4),
                      (W - 1, 1)):
            done += hold_pair_counts(pair, ws, w0, min(k, W - w0),
                                     f"messy H={H}, w0={w0}")
        del ws
    for H in (77, 512):
        for row, cls in ((0, "B"), (2, "C"), (4, "D")):
            a, first, n = class_input(H, cls, 40 + row)
            ws, chunk = wires(a, first, n)
            meta = ws[0].meta.cpu().numpy()
            starts = meta[row, :32][meta[row + 1, :32] > 0] & 31
            if np.unique(starts).size != 32 or meta[row + 1, :32].sum() \
                    != meta[1:6:2, :32].sum():
                raise AssertionError(f"class_input {cls}: its ranges do not "
                                     "start at every bit offset")
            done += hold_pair_counts(pair, ws, 0, min(chunk, 32),
                                     f"class {cls} ranges, H={H}")
    a, first, n = long_window_input()
    ws, _ = wires(a, first, n)
    done += hold_pair_counts(pair, ws, 0, 2, "a 66,000-site window")
    torch.cuda.empty_cache()
    return done


def k20_flush_input(H: int, S: int, seed: int):
    """Codes -1..3 (15 % missing, an all-missing block of sites) and K20's
    edge windows over S sites: 32 windows starting at every site offset
    0..31 of a word (1 to 699 sites, or to the span's end), an empty and a
    1-site window, and one running to the last site."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.15] = -1
    a[:, 3:7] = -1
    k = np.arange(32)
    step = max(1, (S - 40) // 32)
    first = (step - step % 32) * k + k if step >= 32 else k
    n = np.minimum(1 + 97 * k % 699, S - first)
    first = np.concatenate([first, [S // 2, 7, S - 5]]).astype(np.int32)
    n = np.concatenate([n, [0, 1, 5]]).astype(np.int32)
    return a, first, n


def flush_filled(pair, dbuf, sp: int, H: int, wp: int, s_max: int):
    """K20 launched as its wrapper launches it, into an output filled with
    a sentinel first (a test-only allocation: the wrapper allocates with
    torch.empty), so a cell no block writes shows.  Not counted in
    LAUNCHES."""
    import torch
    T = H * (H + 1) // 2
    u16 = s_max < (1 << 16)
    out = (torch.full((wp, 2 * T), -1, dtype=torch.int16,
                      device=dbuf.device).view(torch.uint16) if u16 else
           torch.full((wp, 2 * T), SENTINEL, dtype=torch.int32,
                      device=dbuf.device))
    code = pair._build.lib("pair4").ggt_flush_pair_counts(
        dbuf.data_ptr(), H, sp, wp, 0, wp, s_max, int(u16), out.data_ptr(),
        torch.cuda.current_stream(dbuf.device).cuda_stream)
    pair._build.check(code, "flush_pair_counts (sentinel-filled)")
    return out


def k20_edge_parity(pair, transfer, dev) -> int:
    """K20 at the edges of its tiles, words and loads, against its plain
    version exactly, every output cell written (a sentinel-filled launch):
    at every H of K1_EDGE_H, the windows of k20_flush_input over 2,800
    sites in the default bucket (sp = 65,536: 16- and 8-byte loads) with
    s_max 333 (a cut inside a word) and over 100 sites in a bucket of 112
    (rows of their own alignment: byte loads), each with pad windows past
    W; and the int32 branch (s_max 2^16) at H = 12 and 40.  Returns the
    number of comparisons."""
    import torch
    done = 0
    for H in K1_EDGE_H:
        cases = [("aligned", 2_800, 1 << 16, 333),
                 ("unaligned rows", 100, 8, 333)]
        if H in (12, 40):
            cases.append(("int32 branch", 2_800, 1 << 16, 1 << 16))
        for what, S, bucket, s_max in cases:
            a, first, n = k20_flush_input(H, S, H + S)
            wp = pair._next_pow2(first.shape[0] + 1, 8)
            buf, sp = transfer.pack_flush_buffer(a, first, n, wp, bucket)
            if (sp % 64 == 0) != (what != "unaligned rows"):
                raise AssertionError(f"K20 edge flush ({what}): sp={sp}")
            dbuf = torch.from_numpy(buf).to(dev)
            name = f"flush_pair_counts H={H} ({what}, sp={sp}, s_max={s_max})"
            want = pair._fused_flush_pair_counts_plain(dbuf, sp, H, wp, s_max,
                                                       wp)
            got = pair._fused_flush_pair_counts(dbuf, sp, H, wp, s_max, wp)
            filled = flush_filled(pair, dbuf, sp, H, wp, s_max)
            torch.cuda.synchronize()
            sentinel = -1 if got.dtype == torch.uint16 else SENTINEL
            raw = filled.view(torch.int16) if got.dtype == torch.uint16 \
                else filled
            if int((raw == sentinel).sum()):
                raise AssertionError(f"{name}: cells never written")
            if (got.dtype == torch.int32) != (s_max >= (1 << 16)):
                raise AssertionError(f"{name}: {got.dtype}")
            check_equal(name + " vs plain", got, want)
            check_equal(name + ", sentinel-filled, vs plain", filled, want)
            done += 2
            del want, got, filled, dbuf
        torch.cuda.empty_cache()
    return done


def k10_edge_input(H: int, seed: int):
    """Codes 0..3 with 10 % missing and windows of 625 sites, a 0-site
    window and one of all-missing sites (no valid pair: NaN means)."""
    rng = np.random.default_rng(seed)
    S = 5_000
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    a[:, 700:760] = -1
    first = np.array([0, 10, 700, 1200, 2400, 4375], np.int32)
    n = np.array([625, 0, 60, 625, 625, 625], np.int32)
    return a, first, n


def check_bits(name: str, got, want) -> int:
    """float32 results bit for bit (NaN positions equal).  Returns the
    number of cells compared."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if g.shape != w.shape or not np.array_equal(g, w, equal_nan=True):
        bad = int((~((g == w) | (np.isnan(g) & np.isnan(w)))).sum()) \
            if g.shape == w.shape else "shape"
        raise AssertionError(f"{name}: kernel != plain bit for bit ({bad} "
                             "cells)")
    return g.size


def k10_edge_parity(pair, ws, dev) -> int:
    """K10 against its plain version bit for bit (NaN positions equal) on
    K9's counts of k10_edge_input's windows: messy_masks at H = 160 and
    512 (overlapping populations, rows in none, classes scattered at
    random) and their one population of all rows; every row its own
    population at H = 12 (12 classes); fractional weights at H = 77; and
    run G's shape (128 windows of 625 sites, H = 512, 4 populations of
    128).  Returns the number of comparisons."""
    import torch
    rng = np.random.default_rng(10)
    frac = rng.choice(np.float32([0, 0.25, 0.5, 1, 0.3]), size=(3, 77))
    frac[:, :5] = 0.0
    sets = {160: messy_masks(160), 512: messy_masks(512),
            12: (np.eye(12, dtype=np.float32),),
            77: (frac.astype(np.float32),)}
    inputs = {H: k10_edge_input(H, 100 + H) for H in sets}
    size = N_SITES_G // WINDOWS_G
    g_first = np.arange(0, WINDOWS_G * size, size, dtype=np.int32)
    inputs["run G"] = (np.random.default_rng(11).integers(
        0, 4, size=(512, N_SITES_G)).astype(np.int8), g_first,
        np.full(WINDOWS_G, size, np.int32))
    sets["run G"] = (np.repeat(np.eye(4, dtype=np.float32), 128, axis=1),)
    done = 0
    for key, masks in sets.items():
        a, first, n = inputs[key]
        m, s = pair.pair_counts_4state(torch.from_numpy(a).to(dev),
                                       torch.from_numpy(first).to(dev),
                                       torch.from_numpy(n).to(dev))
        for mask in masks:
            pm = torch.from_numpy(mask).to(dev)
            got = ws.window_stats_tail(m, s, pm)
            want = ws.window_stats_tail_plain(m, s, pm)
            C = ws.tail_classes(pm, dev).C
            for what, g, w in zip(("pi", "dxy", "fst"), got, want):
                check_bits(f"window_stats_tail {what} ({key}, P="
                           f"{mask.shape[0]}, C={C})", g, w)
                done += 1
            if key != "run G" and not torch.isnan(got[1][1]).all():
                raise AssertionError("window_stats_tail: the 0-site window "
                                     "should give NaN means")
        del m, s
    torch.cuda.synchronize()
    return done


def k11_edge_layouts(a: np.ndarray, dev):
    """``a`` on the card as three row layouts: a stride that is a multiple
    of 16, a contiguous matrix (stride S, odd) and a view 3 columns into
    rows of an odd stride.  The bytes around each view hold code 2, which
    a read that is not masked would count."""
    import torch
    H, S = a.shape
    out = {}
    for name, ld, col in (("stride 70,016", 70_016, 0),
                          ("contiguous, stride S", S, 0),
                          ("odd stride 70,011, 3 columns in", 70_011, 3)):
        buf = torch.full((H * ld + 32,), 2, dtype=torch.int8, device=dev)
        view = buf[16:16 + H * ld].view(H, ld)[:, col:col + S]
        view.copy_(torch.from_numpy(a))
        out[name] = view
    return out


def k11_edge_parity(ws, dev) -> int:
    """K11 against its plain version exactly at the edges of its 16-byte
    vectors and classes: codes -7, 5, 127 beside -1 and 0..3; rows in
    three layouts (k11_edge_layouts); windows of K11_EDGE_LEN sites at
    every start offset mod 16, windows clipped at 0 and at S (one wholly
    outside each), and, launched apart, windows of 66,001 sites; the
    masks messy_masks (5 populations with rows in none, and 1 of all
    rows), every row its own population (77) and 1,100 random 0/1 rows
    (more than a launch's 1,024 populations).  Returns the number of
    comparisons."""
    import torch
    rng = np.random.default_rng(17)
    H, S = K11_EDGE_H, K11_EDGE_S
    codes = np.array([-7, -1, 0, 1, 2, 3, 5, 127], np.int8)
    a = rng.choice(codes, p=[.02, .08, .3, .3, .15, .1, .03, .02],
                   size=(H, S))
    first = [16 * (97 * off + 11 * j) + off for off in range(16)
             for j in range(len(K11_EDGE_LEN))]
    n = [length for _ in range(16) for length in K11_EDGE_LEN]
    first += [-5, -20, S - 10, S + 5, S - 625]
    n += [40, 10, 40, 3, 625]
    batches = {"short": (first, n),
               "66,001 sites": ([100, 1, S - 66_001], [66_001] * 3)}
    masks = [*messy_masks(H), np.eye(H, dtype=np.float32),
             (rng.random((1_100, H)) < 0.3).astype(np.float32)]
    masks = [torch.from_numpy(m).to(dev) for m in masks]
    done = 0
    for layout, at in k11_edge_layouts(a, dev).items():
        for what, (f, k) in batches.items():
            f_d = torch.tensor(f, dtype=torch.int32, device=dev)
            k_d = torch.tensor(k, dtype=torch.int32, device=dev)
            for pm in masks:
                check_equal(f"window_pop_counts {layout}, {what} windows, "
                            f"P={pm.shape[0]}",
                            ws.window_pop_counts(at, f_d, k_d, pm),
                            ws.window_pop_counts_plain(at, f_d, k_d, pm))
                done += 1
    torch.cuda.synchronize()
    return done


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


def k7_edge_input(S: int, codes, seed: int) -> np.ndarray:
    """int64 [S, C, 4] class counts for K7's edges, where ``codes`` may
    leave classes of the outgroup outside the union: a site's union
    classes count two alleles x < y (or only one, or none), the other
    classes any allele; 40 % of counts zero, the rest 1..9; every 7th site
    has no outgroup call (NaN frequencies); every 11th site has fixed
    populations.  So polarize and fixed select 0, 1 or 2 alleles a site."""
    rng = np.random.default_rng(seed)
    C = len(codes)
    union = (np.asarray(codes) >> 4) & 1
    xy = np.sort(np.argsort(rng.random((S, 4)), axis=1)[:, :2], axis=1)
    allowed = np.zeros((S, C, 4), bool)
    allowed[:, union == 0, :] = True
    pick = rng.random((S, 2)) < 0.9
    for j in range(2):
        allowed[np.arange(S)[pick[:, j]], :, xy[pick[:, j], j]] |= \
            union[None, :] == 1
    c = rng.integers(1, 10, size=(S, C, 4)) * (rng.random((S, C, 4)) > 0.4)
    c = np.where(allowed, c, 0)
    outgroup = ((np.asarray(codes) >> 3) & 1) == 1
    c[::7, outgroup, :] = 0
    # every 11th site from the 3rd: P1's and P3's own classes fixed for x,
    # P2's for y, the outgroup outside the union for a third allele, every
    # other class empty (polarize and fixed select x and y)
    sites = np.arange(3, S, 11)
    z = np.array([min(set(range(4)) - set(p)) for p in xy[sites]],
                 np.int64)
    c[sites] = 0
    for k, code in enumerate(codes):
        allele = {1 | 16: xy[sites, 0], 2 | 16: xy[sites, 1],
                  4 | 16: xy[sites, 0], 8: z}.get(int(code))
        if allele is not None:
            c[sites, k, allele] = rng.integers(1, 10, size=sites.size)
    return c


def k7_edge_parity(abba, dev) -> dict:
    """K7 at the edges of its tile and selection: tiles cut short (S = 1,
    129, 5,003), codes that let polarize and fixed select two alleles a
    site (outgroup classes outside the union), outgroups with no call
    (NaN), uint16 and int32 counts, counts staged through shared memory,
    read in place (40 classes of int32, past the staging's 48 KB) and
    staged from a start off a 16-byte boundary; every mode, panel and
    minData 0.3 / 0, against the plain version bit for bit, NaN positions
    equal.  Returns the sites found with 0, 1 and 2 selected alleles."""
    import torch
    codes6 = np.array([1 | 16, 2 | 16, 4 | 16, 8, 8 | 16, 3 | 16], np.int32)
    codes40 = np.resize(codes6, 40).astype(np.int32)
    cases = []
    for S in (1, 129, 5003):
        for dt in (torch.uint16, torch.int32):
            cases.append((f"S={S} {dt}", torch.from_numpy(
                k7_edge_input(S, codes6, S)).to(dev, dt), codes6))
    flat = torch.from_numpy(k7_edge_input(5003, codes6, 1).reshape(-1)).to(
        dev, torch.uint16)
    cases.append(("S=5002 uint16 off a 16-byte boundary",
                  flat[1:1 + 5002 * 24].view(5002, 6, 4), codes6))
    cases.append(("S=5003 int32, 40 classes in place", torch.from_numpy(
        k7_edge_input(5003, codes40, 2)).to(dev, torch.int32), codes40))
    used = np.zeros(3, np.int64)
    for what, cc, codes in cases:
        cd = torch.from_numpy(codes).to(dev)
        for mode in abba.MODES:
            for full in (False, True):
                for md in (0.3, 0.0):
                    t = abba.abba_site_terms(cc, cd, (20, 20, 20, 20), md,
                                             mode, full)
                    want = abba.abba_site_terms_plain(cc, cd, (20,) * 4, md,
                                                      mode, full)
                    name = f"abba_site_terms {what} {mode} full={full} " \
                           f"minData={md}"
                    check_same(name, t, want)
                    nan = torch.isnan(t)
                    if not torch.equal(t.view(torch.int64)[~nan],
                                       want.view(torch.int64)[~nan]):
                        raise AssertionError(f"{name}: not bit-equal")
                    if mode != "minor":
                        u = t[:, 1].long().cpu().numpy()
                        used += np.bincount(u, minlength=3)[:3]
    if (used == 0).any():
        raise AssertionError(f"K7 edges: sites with 0, 1, 2 selected "
                             f"alleles {used.tolist()}")
    torch.cuda.synchronize()
    return {"used": used.tolist(), "cases": len(cases)}


def bits_equal(name: str, got, want) -> None:
    """float64 results bit for bit (NaN positions included)."""
    import torch
    if got.shape != want.shape or not torch.equal(got.view(torch.int64),
                                                  want.view(torch.int64)):
        raise AssertionError(f"{name}: not bit-equal")


def k8_edge_parity(abba, dev) -> dict:
    """K8 at the edges of its column pairs and its fixed order, for K = 8
    and 18: windows of K8_EDGE_LEN sites and of the whole span, windows at
    2x and 3x overlap, the window list shuffled; a few rows of NaN terms;
    terms starting on a 16-byte boundary and 8 bytes past one.  Against
    its plain version within RTOL of each window's sum of |terms| (NaN
    positions equal), two launches bit-equal, and K8_EDGE_ALONE windows
    each launched alone bit-equal to the batch.  Returns the counts."""
    import torch
    rng = np.random.default_rng(18)
    S = K8_EDGE_S
    lengths = np.array([*K8_EDGE_LEN, S])
    first = [rng.integers(0, S - k + 1, size=3) for k in lengths]
    n = [np.full(3, k) for k in lengths]
    for step in (300, 200):                         # 2x and 3x overlap
        f = np.arange(0, S - 600, step)
        first.append(f)
        n.append(np.full(f.size, 600))
    first, n = np.concatenate(first), np.concatenate(n)
    order = rng.permutation(first.size)
    f_d = torch.from_numpy(first[order].astype(np.int32)).to(dev)
    n_d = torch.from_numpy(n[order].astype(np.int32)).to(dev)
    alone = rng.choice(first.size, size=K8_EDGE_ALONE, replace=False)
    done = {"windows": int(first.size), "launches": 0}
    for K in (8, 18):
        t = rng.normal(size=(S, K)) * rng.choice([1e-3, 1.0, 1e3],
                                                 size=(S, 1))
        t[rng.choice(S, size=4, replace=False), rng.integers(0, K)] = np.nan
        aligned = torch.from_numpy(t).to(dev)
        flat = torch.empty(S * K + 1, dtype=torch.float64, device=dev)
        shifted = flat[1:].view(S, K)
        shifted.copy_(aligned)
        if aligned.data_ptr() % 16 or shifted.data_ptr() % 16 != 8:
            raise AssertionError("K8 edges: the terms' alignment")
        for where, terms in (("16-byte aligned", aligned),
                             ("8 bytes past 16", shifted)):
            name = f"abba_window_sums K={K}, terms {where}"
            got = abba.abba_window_sums(terms, f_d, n_d)
            check_sums(abba, name, got, terms, f_d, n_d)
            bits_equal(f"{name}: two launches", got,
                       abba.abba_window_sums(terms, f_d, n_d))
            for i in alone:
                bits_equal(f"{name}: window {i} alone", got[i:i + 1],
                           abba.abba_window_sums(terms, f_d[i:i + 1],
                                                 n_d[i:i + 1]))
            done["launches"] += 2 + len(alone)
    torch.cuda.synchronize()
    return done


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
           "graph_ms": graph_ms(lambda: pair.tri_pack(m, s, out), 20),
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
           "graph_ms": graph_ms(lambda: pair.het_pairs(m, s, r1, r2, out),
                                20),
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
    k3_err = hold_blocks_tail(pair, m, s, groups, gate,
                              "run B individual mask", host=True)
    k3 = lambda: pair.blocks_tail(m, s, groups, gate, blk)  # noqa: E731
    k3_ms, k3_graph = cuda_ms(k3, 20), graph_ms(k3, 20)
    P = groups.P
    k3_bound = blocks_tail_bound(nwin, H, P)
    log(f"[kernel] blocks_tail on run B's individual mask (P={P}, largest "
        f"group {groups.max_rows}, {nwin} windows, "
        f"{'wide' if pair.blocks_tail_wide(groups) else 'narrow'}): kernel "
        f"{k3_ms:.4f} ms ({k3_graph:.4f} ms in a CUDA graph), bound "
        f"{k3_bound[0]:.4f} ms ({k3_bound[1]}), max abs err {k3_err}; two "
        "launches and the host executor's blocks bit-equal")
    return res


def hold_blocks_tail(pair, m, s, groups, min_sites, what: str,
                     host: bool = False) -> float:
    """K3 on ``groups`` against its plain version (counts exactly, sums at
    RTOL) and against a second launch (bit for bit); with ``host``, groups
    of at most 2 rows, also against the host executor's blocks bit for
    bit (the narrow walk adds in its order)."""
    import torch
    nwin, P = m.shape[0], groups.P
    blk = torch.empty((nwin, 2, P, P), dtype=torch.float64, device=m.device)
    again = torch.empty_like(blk)
    pair.blocks_tail(m, s, groups, min_sites, blk)
    pair.blocks_tail(m, s, groups, min_sites, again)
    want = pair.blocks_tail_plain(m, s, groups.mask.to(m.device), min_sites)
    check_equal(f"blocks_tail ({what}) counts", blk[:, 1], want[:, 1])
    err = check_close(f"blocks_tail ({what}) sums", blk[:, 0], want[:, 0])
    if not torch.equal(blk, again):
        raise AssertionError(f"blocks_tail ({what}): two launches differ")
    if host:
        sums, cnts = pair._blocks_from_counts(
            m.cpu().numpy(), s.cpu().numpy(), groups.mask.numpy(), min_sites)
        if not torch.equal(blk.cpu(), torch.from_numpy(
                np.stack([sums, cnts], axis=1))):
            raise AssertionError(f"blocks_tail ({what}) != the host "
                                 "executor's blocks bit for bit")
    return err


# K3's launch-shape sweep: groups of g rows over the popDist chunk's
# counts, each shape timed in a CUDA graph (pair._K3_NARROW_ROWS comes
# from it)
K3_SWEEP_ROWS = (2, 4, 8, 16, 32, 128)


def uneven_groups(H: int, cap: int, seed: int = 11) -> np.ndarray:
    """A mask of uneven interleaved groups over H rows: one of 1 row, an
    empty one, one of 3, then groups of ``cap`` rows (the last shorter)."""
    rng = np.random.default_rng(seed)
    rest = H - 4
    sizes = [1, 0, 3] + [cap] * (rest // cap) + [rest % cap]
    groups = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    mask = np.zeros((len(sizes), H))
    mask[groups, np.arange(H)] = 1.0
    return mask


def half_step_windows(first: np.ndarray, n: np.ndarray):
    """Overlapping windows from a flush's windows: each window, then one
    from its middle to the next one's middle (a -s half the window)."""
    mid = first + n // 2
    f2 = np.empty(2 * first.size - 1, np.int32)
    n2 = np.empty_like(f2)
    f2[0::2], n2[0::2] = first, n
    f2[1::2] = mid[:-1]
    n2[1::2] = mid[1:] - mid[:-1]
    return f2, n2


def tails_phase(pair, transfer, flush, dev) -> None:
    """K3 and K2 at full width on the popDist flush: K3 on popDist's mask,
    ind_layout(512) and a mask of uneven groups (an empty group, a 1-row
    group), each against its plain version and a second launch; both
    launch shapes timed over K3_SWEEP_ROWS; K2 against its plain version
    exactly on a chunk at w0 > 0 and on a half-step overlapping flush
    (ex_w unsorted), timed per call and in a CUDA graph."""
    import torch
    a, first, n, mask, min_sites = flush
    v3, wire, m, s, nwin = flush_counts(pair, transfer, a, first, n, dev)
    H = v3.h
    for what, msk in (("popDist mask", mask),
                      (f"ind_layout({H})", ind_layout(H)[0]),
                      ("uneven groups up to 13 rows", uneven_groups(H, 13)),
                      ("uneven groups up to 300 rows",
                       uneven_groups(H, 300))):
        groups = pair.PopGroups(msk, dev)
        pairs = groups.max_rows <= 2
        err = hold_blocks_tail(pair, m, s, groups, min_sites, what, pairs)
        shape = "wide" if pair.blocks_tail_wide(groups) else "narrow"
        log(f"[parity] blocks_tail on the popDist chunk's counts, {what} "
            f"(P={groups.P}, largest group {groups.max_rows}, {shape}): == "
            f"plain (max abs err {err}); two launches"
            + (" and the host executor's blocks" if pairs else "")
            + " bit-equal")
    for g in K3_SWEEP_ROWS:
        groups = pair.PopGroups(np.repeat(np.eye(H // g), g, axis=1), dev)
        outs, times = [], []
        for wide in (False, True):
            out = torch.empty((nwin, 2, groups.P, groups.P),
                              dtype=torch.float64, device=dev)
            fn = lambda: pair._blocks_tail_launch(  # noqa: E731
                m, s, groups, min_sites, out, wide)
            fn()
            outs.append(out)
            times.append(graph_ms(fn, 3))
        check_equal(f"blocks_tail narrow vs wide counts (groups of {g})",
                    outs[0][:, 1], outs[1][:, 1])
        check_close(f"blocks_tail narrow vs wide sums (groups of {g})",
                    outs[0][:, 0], outs[1][:, 0])
        log(f"[kernel] blocks_tail launch shapes, groups of {g} (P="
            f"{groups.P}, {nwin} windows): narrow {times[0]:.4f} ms, wide "
            f"{times[1]:.4f} ms in a CUDA graph, bound "
            f"{blocks_tail_bound(nwin, H, groups.P)[0]:.4f} ms; narrow == "
            "wide")
        del outs
    torch.cuda.empty_cache()
    # K2 on a chunk inside the flush and on an overlapping flush
    W = first.shape[0]
    w0 = min(3, W - 1)
    k = min(nwin, W - w0)
    m1, s1 = pair.pair_counts_v3(wire, w0, k)
    m1p, s1p = m1.clone(), s1.clone()
    pair.exception_patch(m1, s1, wire, w0, pair.exception_index(wire))
    pair.exception_patch_plain(m1p, s1p, wire, w0)
    check_equal(f"exception_patch m (w0={w0})", m1, m1p)
    check_equal(f"exception_patch s (w0={w0})", s1, s1p)
    del m1, s1, m1p, s1p
    f2, n2 = half_step_windows(first, n)
    v3o = pair._v3_flush_args(a, f2, n2)
    wo = v3o.wire(torch.from_numpy(v3o.buf).to(dev))
    ex_w = wo.ex_w.cpu().numpy()
    if not (np.diff(ex_w[ex_w < wo.wp]) < 0).any():
        raise AssertionError("the half-step flush's entries should "
                             "interleave windows")
    index = pair.exception_index(wo)
    for w0 in range(0, f2.shape[0], v3o.chunk):
        k = min(v3o.chunk, f2.shape[0] - w0)
        mo, so = pair.pair_counts_v3(wo, w0, k)
        mop, sop = mo.clone(), so.clone()
        pair.exception_patch(mo, so, wo, w0, index)
        pair.exception_patch_plain(mop, sop, wo, w0)
        check_equal(f"exception_patch m (half-step flush, w0={w0})", mo, mop)
        check_equal(f"exception_patch s (half-step flush, w0={w0})", so, sop)
    del mo, so, mop, sop
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[parity] exception_patch == plain on the popDist flush at w0=3 "
        f"and on its half-step overlapping flush ({f2.shape[0]} windows, "
        f"{int((ex_w < wo.wp).sum())} entries, ex_w unsorted)")


def time_counts(counts, transfer, flush, dev):
    """K6 over the first launch block of run A's largest count span, per
    call and in a CUDA graph, beside a bf16 ``torch.matmul`` of the mask
    with a one-hot and K12 on the same alleles in a CUDA graph (the
    row-slot loop on int8 rows)."""
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
    k12_out = torch.empty_like(out)
    k6 = lambda: counts.site_pop_counts(  # noqa: E731
        dbuf, Sp, H, 0, s1, groups, out)
    k12 = lambda: counts.site_pop_counts_raw(  # noqa: E731
        al, 0, s1, groups, k12_out)
    lib = lambda: torch.matmul(mask_bf, onehot)  # noqa: E731
    k12()
    check_equal("site_pop_counts_raw vs site_pop_counts (run A span)",
                k12_out, out)
    res = {"max_abs_err": err, "ms": cuda_ms(k6, 20),
           "graph_ms": graph_ms(k6, 20),
           "plain_ms": cuda_ms(lambda: counts.site_pop_counts_plain(
               dbuf, Sp, H, 0, s1, groups.mask), 3, 1),
           "library_ms": cuda_ms(lib, 20),
           "library_graph_ms": graph_ms(lib, 20),
           "k12_graph_ms": graph_ms(k12, 20)}
    out_bytes = 2 if dt == torch.uint16 else 4
    res["bound"] = bound(H * s1 * 3 / 8 + 4 * out_bytes * s1 * P)
    res["shape"] = f"{s1} sites, H={H}, P={P}"
    del onehot
    torch.cuda.empty_cache()
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
    k7_call = lambda: abba.abba_site_terms(  # noqa: E731
        cc, codes, n_pops, md, mode, full)
    k8_call = lambda: abba.abba_window_sums(t, f_d, n_d)  # noqa: E731
    k7 = {"max_abs_err": k7_err, "library_ms": None,
          "ms": cuda_ms(k7_call, 20), "graph_ms": graph_ms(k7_call, 20),
          "plain_ms": cuda_ms(lambda: abba.abba_site_terms_plain(
              cc, codes, n_pops, md, mode, full), 3, 1)}
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    k8 = {"max_abs_err": k8_err,
          "ms": cuda_ms(k8_call, 20), "graph_ms": graph_ms(k8_call, 20),
          "cold_graph_ms": cold_graph_ms(k8_call, 20, scratch),
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
    del scratch
    return {"abba_site_terms": k7, "abba_window_sums": k8}


# ------------------------------------------- K9, K10, K11 parity and times

def k9_input(H: int, seed: int = 8):
    """K9's messy input: mostly biallelic codes, 10 % missing, 1 % of sites
    with a third or fourth allele, an all-missing block and a block where
    the rows cycle through all four codes; S = 70,003 (not a multiple of
    4); 60 windows at unaligned starts: one of 0 sites, one of 1 site, one
    ending exactly at S and one of 66,000 sites (more than 2^16)."""
    rng = np.random.default_rng(seed)
    S = 70_003
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.1] = -1
    for s in rng.choice(S, size=S // 100, replace=False):
        a[rng.integers(0, H, 4), s] = rng.integers(2, 4)
    a[:, 1000:1100] = -1
    a[:, 2000:2100] = (np.arange(H)[:, None] + np.arange(100)[None, :]) % 4
    first = rng.integers(0, S - 1500, size=60).astype(np.int32)
    n = rng.integers(2, 1500, size=60).astype(np.int32)
    first[:4] = (5, 11, S - 777, 3)
    n[:4] = (0, 1, 777, 66_000)
    return a, first, n


def k9_parity(pair, a, first, n, dev):
    """K9 on all windows in one launch (unsplit at H = 160, split at
    H = 77), one window per launch (split: int32 atomics), and on
    row-strided input, against its plain version and the host executor
    exactly.  Returns the device tensors and counts for K10 / K11."""
    import torch
    H, S = a.shape
    at = torch.from_numpy(a).to(dev)
    f = torch.from_numpy(first).to(dev)
    k = torch.from_numpy(n).to(dev)
    s_max = int(n.max())
    m, s = pair.pair_counts_4state(at, f, k, s_max)
    mp, sp = pair.pair_counts_4state_plain(at, f, k)
    check_equal(f"pair_counts_4state m H={H} vs plain", m, mp)
    check_equal(f"pair_counts_4state s H={H} vs plain", s, sp)
    del mp, sp
    hm, hs = pair._host_flush_counts(a, first, n)
    check_equal(f"pair_counts_4state m H={H} vs host executor", m,
                torch.from_numpy(hm))
    check_equal(f"pair_counts_4state s H={H} vs host executor", s,
                torch.from_numpy(hs))
    del hm, hs
    for w in range(4):
        m1, s1 = pair.pair_counts_4state(at, f[w:w + 1], k[w:w + 1],
                                         int(n[w]))
        check_equal(f"pair_counts_4state m H={H} window {w} alone", m1,
                    m[w:w + 1])
        check_equal(f"pair_counts_4state s H={H} window {w} alone", s1,
                    s[w:w + 1])
    wide = torch.full((H, S + 61), -1, dtype=torch.int8, device=dev)
    wide[:, :S] = at
    m2, s2 = pair.pair_counts_4state(wide[:, :S], f, k, s_max)
    check_equal(f"pair_counts_4state m H={H} strided rows", m2, m)
    check_equal(f"pair_counts_4state s H={H} strided rows", s2, s)
    torch.cuda.synchronize()
    return at, f, k, m, s


def k9_edge_input(H: int, seed: int):
    """K9's tile-edge input: S = K9_EDGE_S (odd); mostly biallelic codes
    with 10 % missing, a third or fourth allele on 1 % of sites (as
    :func:`k9_input`, so the host executor's multi-allelic patch stays
    small), and codes -7, 5 and 127 on 0.5 % of cells each (-7 missing, 5
    and 127 called but matching nothing); 12 windows at odd starts, of 0,
    1, 31, 33, 95, 97, 129, 257, 511, 1,023 and 1,999 sites (none a
    multiple of 32 but 0) and one of 4,999 sites."""
    rng = np.random.default_rng(seed)
    S = K9_EDGE_S
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    for site in rng.choice(S, size=S // 100, replace=False):
        a[rng.integers(0, H, 4), site] = rng.integers(2, 4)
    hit = rng.random((H, S))
    a[hit < 0.1] = -1
    for k, code in enumerate((-7, 5, 127)):
        a[(hit >= 0.1 + 0.005 * k) & (hit < 0.105 + 0.005 * k)] = code
    n = np.array([0, 1, 31, 33, 95, 97, 129, 257, 511, 1023, 1999, 4999],
                 np.int32)
    first = (2 * rng.integers(0, (S - n) // 2) + 1).astype(np.int32)
    return a, first, n


def k9_edge_parity(pair, dev) -> int:
    """K9 at the edges of its 128 x 128 tiles, H in K9_EDGE_H, each on four
    layouts of the same codes (contiguous rows of odd length; a row stride
    that is a multiple of 16 with rows starting 5 bytes in, which takes the
    cp.async staging with a shifted origin; an odd stride; an aligned
    stride, the raw upload's): all 12 windows of :func:`k9_edge_input` in
    one launch, the 11 short ones (the site split off) and the long one
    alone (split on), against the plain version exactly; on the codes cut
    to -1..3, against the host executor too.  K14 on the row blocks of
    K14_EDGE_BLOCKS, on the same layouts and windows (both staging paths,
    the split on and off), against K9's rows and its plain version
    exactly.  Returns the number of comparisons."""
    import torch
    checks = 0
    for H in K9_EDGE_H:
        a, first, n = k9_edge_input(H, 20 + H)
        S = a.shape[1]
        at = torch.from_numpy(a).to(dev)
        layouts = {"contiguous": at}
        for name, width, off in (
                ("stride%16, offset 5", -(-(S + 5) // 16) * 16, 5),
                ("odd stride", S + 64, 3),
                ("aligned stride", -(-S // 16) * 16, 0)):
            wide = torch.full((H, width), -1, dtype=torch.int8, device=dev)
            wide[:, off:off + S] = at
            layouts[name] = wide[:, off:off + S]
        f = torch.from_numpy(first).to(dev)
        k = torch.from_numpy(n).to(dev)
        for sname, sl in (("all", slice(None)), ("short", slice(0, 11)),
                          ("long", slice(11, 12))):
            fs, ks, s_max = f[sl], k[sl], int(n[sl].max())
            splits = pair._k9_grid(H, fs.shape[0], s_max, dev)[1]
            if (sname == "short" and splits != 1) or \
                    (sname == "long" and splits < 2):
                raise AssertionError(f"K9 H={H} {sname} windows: {splits} "
                                     "site splits, against the case's aim")
            mp, sp = pair.pair_counts_4state_plain(at, fs, ks)
            for lname, al in layouts.items():
                m, s = pair.pair_counts_4state(al, fs, ks, s_max)
                tag = f"pair_counts_4state H={H} {sname} windows, {lname}"
                check_equal(f"{tag} m vs plain", m, mp)
                check_equal(f"{tag} s vs plain", s, sp)
                checks += 2
            for r0, r1 in K14_EDGE_BLOCKS.get(H, ()):
                t = pair._K9_MMA_TILE
                tiles = -(-(r1 - r0) // t) * -(-H // t)
                splits = pair._k9_grid(H, fs.shape[0], s_max, dev, tiles)[1]
                if (sname == "short" and splits != 1) or \
                        (sname == "long" and splits < 2):
                    raise AssertionError(
                        f"K14 H={H} rows {r0}..{r1} {sname} windows: "
                        f"{splits} site splits, against the case's aim")
                mpr, spr = pair.pair_counts_4state_plain(at, fs, ks, r0, r1)
                check_equal(f"K14 plain H={H} rows {r0}..{r1} vs K9 plain",
                            torch.stack([mpr, spr]),
                            torch.stack([mp, sp])[:, :, r0:r1])
                for lname, al in layouts.items():
                    m, s = pair.pair_counts_4state_rows(al, fs, ks, r0, r1,
                                                        s_max)
                    tag = (f"pair_counts_4state_rows H={H} rows {r0}..{r1} "
                           f"{sname} windows, {lname}")
                    check_equal(f"{tag} m vs plain", m, mpr)
                    check_equal(f"{tag} s vs plain", s, spr)
                    checks += 2
                del mpr, spr
            del mp, sp
        b = np.where((a < 0) | (a > 3), -1, a).astype(np.int8)
        m, s = pair.pair_counts_4state(torch.from_numpy(b).to(dev), f, k,
                                       int(n.max()))
        hm, hs = pair._host_flush_counts(b, first, n)
        check_equal(f"pair_counts_4state H={H} m vs host executor", m,
                    torch.from_numpy(hm))
        check_equal(f"pair_counts_4state H={H} s vs host executor", s,
                    torch.from_numpy(hs))
        checks += 2
        del at, layouts, m, s
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return checks


def check_f32(name: str, got, want, atol: float = 0.0):
    """float32 results: NaN positions equal, the rest within K10_RTOL (and
    ``atol``).  Returns (max abs err, cells not bit-equal)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    nan = np.isnan(g)
    if g.shape != w.shape or not np.array_equal(nan, np.isnan(w)):
        raise AssertionError(f"{name}: shape or NaN positions differ")
    err = np.abs(g[~nan].astype(np.float64) - w[~nan])
    if (err > K10_RTOL * np.abs(w[~nan]) + atol).any():
        raise AssertionError(f"{name}: beyond rtol {K10_RTOL} (max abs err "
                             f"{err.max()})")
    return (float(err.max()) if err.size else 0.0,
            int((g[~nan] != w[~nan]).sum()))


def stats_parity(ws, at, f, k, m, s, dev, masks) -> tuple[float, int]:
    """K10 against its plain version and K11 exactly, for each mask.
    Returns K10's max abs err and its number of cells not bit-equal."""
    import torch
    err, diff = 0.0, 0
    for mask in masks:
        pm = torch.from_numpy(mask).to(dev)
        got = ws.window_stats_tail(m, s, pm)
        want = ws.window_stats_tail_plain(m, s, pm)
        for name, g, w in zip(("pi", "dxy", "fst"), got, want):
            e, d = check_f32(f"window_stats_tail {name} P={mask.shape[0]}",
                             g, w, atol=K10_RTOL if name == "fst" else 0.0)
            err, diff = max(err, e), diff + d
        check_equal(f"window_pop_counts P={mask.shape[0]} vs plain",
                    ws.window_pop_counts(at, f, k, pm),
                    ws.window_pop_counts_plain(at, f, k, pm))
    torch.cuda.synchronize()
    return err, diff


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


def k9_bound(H: int, in_bytes: float, sites: float, nwin: int):
    """K9's least time: the larger of the input read once plus both count
    matrices written, over the HBM rate, and the one-hot Gram's work over
    the upper triangle (2 T 5 sites: the called Gram and the 4-code Gram)
    at the dense int8 tensor rate."""
    T = H * (H + 1) // 2
    return bound(in_bytes + 8 * nwin * H * H, 2 * T * 5 * sites,
                 INT8_OPS_PER_S)


def gram_yardstick(wa, valid, rows=slice(None)):
    """The library yardstick of K9 (and, on a row block ``rows``, of K14):
    the two bf16 one-hot torch.matmul Grams of the JAX kernel over gathered
    windows [B, H, s], the left factors cut to ``rows``.  torch returns
    them in bf16 (JAX asks XLA for float32), which rounds counts above
    256, so the yardstick is timed, not compared.  Returns a callable."""
    import torch
    keep = valid[:, None, :]
    called = ((wa >= 0) & keep).to(torch.bfloat16)
    codes = torch.arange(4, device=wa.device, dtype=torch.int8)
    oh = ((wa[..., None] == codes) & keep[..., None]).to(torch.bfloat16)
    oh = oh.reshape(wa.shape[0], wa.shape[1], -1)
    called_r, oh_r = called[:, rows], oh[:, rows]

    def grams():
        return (torch.matmul(called_r, called.transpose(1, 2)),
                torch.matmul(oh_r, oh.transpose(1, 2)))
    return grams


def time_k9_block(pair, call, dev):
    """K9 at run E's largest block (one window over the staging block)."""
    import torch
    at, f, k, s_max = call
    H = at.shape[0]
    m, s = pair.pair_counts_4state(at, f, k, s_max)
    mp, sp = pair.pair_counts_4state_plain(at, f, k)
    err = max(check_equal("pair_counts_4state (run E block) m", m, mp),
              check_equal("pair_counts_4state (run E block) s", s, sp))
    del mp, sp
    wa = at[None, :, :s_max]
    grams = gram_yardstick(
        wa, torch.ones((1, s_max), dtype=torch.bool, device=dev))
    k9 = lambda: pair.pair_counts_4state(at, f, k, s_max)  # noqa: E731
    res = {"max_abs_err": err, "ms": cuda_ms(k9, 5),
           "graph_ms": graph_ms(k9, 5),
           "plain_ms": cuda_ms(lambda: pair.pair_counts_4state_plain(
               at, f, k), 2, 1),
           "library_ms": cuda_ms(grams, 3),
           "library_graph_ms": graph_ms(grams, 3)}
    res["bound"] = k9_bound(H, H * s_max, s_max, 1)
    res["shape"] = f"1 window of {s_max} sites, H={H}"
    del wa, grams
    torch.cuda.empty_cache()
    return res


def time_k9_flush(pair, transfer, flush, dev, name: str) -> dict:
    """K9 over the first chunk of one windowed flush, from the raw upload:
    equal to K1 + K2 on the same windows; the K9 + K4 and the K1 + K2 + K4
    routes over the whole flush timed side by side."""
    import torch
    a, first, n = flush
    H, S = a.shape
    W = first.shape[0]
    b = torch.from_numpy(transfer.pack_raw_span(a, first, n)).to(dev)
    al, f, k = transfer.raw_span_views(b, H, S, W)
    s_max, u16 = int(n.max()), pair._tri_u16(n)
    chunk = pair._window_chunk(W, H)
    nw = min(chunk, W)
    m, s = pair.pair_counts_4state(al, f[:nw], k[:nw], s_max)
    v3 = pair._v3_flush_args(a, first, n)
    wire = v3.wire(torch.from_numpy(v3.buf).to(dev))
    m3, s3 = pair.pair_counts_v3(wire, 0, nw)
    pair.exception_patch(m3, s3, wire, 0)
    check_equal(f"pair_counts_4state ({name} flush) m vs K1 + K2", m, m3)
    check_equal(f"pair_counts_4state ({name} flush) s vs K1 + K2", s, s3)
    check_equal(f"K9 + K4 vs K1 + K2 + K4 ({name} flush)",
                pair.flush_tri_4state(al, f, k, chunk, u16, s_max),
                pair.flush_tri(wire, W, v3.chunk, v3.u16))
    offs = torch.arange(s_max, device=dev)
    idx = f[:nw, None].long() + offs[None, :]
    valid = offs[None, :] < k[:nw, None]
    wa = al[:, torch.where(valid, idx, torch.zeros_like(idx))] \
        .permute(1, 0, 2)
    grams = gram_yardstick(wa, valid)
    k9 = lambda: pair.pair_counts_4state(al, f[:nw], k[:nw],  # noqa: E731
                                         s_max)
    k1 = lambda: pair.pair_counts_v3(wire, 0, nw)  # noqa: E731
    res = {
        "ms": cuda_ms(k9, 10), "graph_ms": graph_ms(k9, 10),
        "k1_ms": cuda_ms(k1, 10), "k1_graph_ms": graph_ms(k1, 10),
        "plain_ms": cuda_ms(lambda: pair.pair_counts_4state_plain(
            al, f[:nw], k[:nw]), 2, 1),
        "library_ms": cuda_ms(grams, 5),
        "library_graph_ms": graph_ms(grams, 5),
        "route_k9_k4_ms": cuda_ms(lambda: pair.flush_tri_4state(
            al, f, k, chunk, u16, s_max), 10),
        "route_k1_k2_k4_ms": cuda_ms(lambda: pair.flush_tri(
            wire, W, v3.chunk, v3.u16), 10)}
    covered = int((first[:nw] + n[:nw]).max() - first[:nw].min())
    res["bound"] = k9_bound(H, H * min(covered, S),
                            float(n[:nw].astype(np.int64).sum()), nw)
    log(f"[kernel] pair_counts_4state at {name}'s largest flush ({nw} of "
        f"{W} windows, H={H}, longest {s_max} sites): kernel "
        f"{res['ms']:.4f} ms ({res['graph_ms']:.4f} ms in a CUDA graph), "
        f"plain {res['plain_ms']:.4f} ms, library {res['library_ms']:.4f} "
        f"ms ({res['library_graph_ms']:.4f} in a CUDA graph), bound {res['bound'][0]:.4f} ms "
        f"({res['bound'][1]}); K1 on the same windows {res['k1_ms']:.4f} "
        f"ms ({res['k1_graph_ms']:.4f} in a CUDA graph); whole flush: K9 + K4 "
        f"{res['route_k9_k4_ms']:.4f} ms, K1 + K2 + K4 "
        f"{res['route_k1_k2_k4_ms']:.4f} ms; K9 == K1 + K2")
    del wa, grams
    torch.cuda.empty_cache()
    return res


def time_stats(ws, g_inputs, g_out, dev) -> dict:
    """K10 and K11 at run G's shape, against their plain versions; K11
    beside the PyTorch calls that compute its function (the windows'
    gather and per-row code counts, then one torch.einsum with the
    mask)."""
    import torch
    at, f, k, pm = g_inputs
    m, s = g_out["mismatch"], g_out["shared"]
    B, H, _ = m.shape
    P = pm.shape[0]
    want = ws.window_stats_tail_plain(m, s, pm)
    err, diff = 0.0, 0
    for name, g, w in zip(("pi", "dxy", "fst"), (g_out["pi"], g_out["dxy"],
                                                 g_out["fst"]), want):
        e, d = check_f32(f"window_stats_tail {name} (run G)", g, w,
                         atol=K10_RTOL if name == "fst" else 0.0)
        err, diff = max(err, e), diff + d
    check_equal("window_pop_counts (run G) vs plain", g_out["pop_counts"],
                ws.window_pop_counts_plain(at, f, k, pm))
    k10 = {"max_abs_err": err, "cells_not_bit_equal": diff,
           "library_ms": None,
           "ms": cuda_ms(lambda: ws.window_stats_tail(m, s, pm), 20),
           "graph_ms": graph_ms(lambda: ws.window_stats_tail(m, s, pm), 20),
           "plain_ms": cuda_ms(lambda: ws.window_stats_tail_plain(m, s, pm),
                               2, 1),
           # the counts once, the mask, pi / dxy / fst written
           "bound": bound(8 * B * H * H + 4 * P * H + 4 * B * (P + 2 * P * P))}
    sites = int(k.sum())
    # K11's yardstick: no one PyTorch call counts codes per window and
    # population, so the sum of the calls that do: the windows' gather
    # with each row's code counts [H, B, 4], then one einsum of the
    # population mask with them
    s_max = int(k.max())
    offs = torch.arange(s_max, device=at.device)
    idx = f.long()[:, None] + offs[None, :]
    valid = offs[None, :] < k.long()[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))

    def code_counts():
        wa = at[:, idx]
        return torch.stack([((wa == c) & valid[None]).sum(dim=2)
                            for c in range(4)], dim=-1).float()
    per_row = code_counts()
    member = (pm != 0).float()
    lib11 = lambda: torch.einsum(  # noqa: E731
        "ph,hbc->bpc", member, per_row)
    k11 = {"max_abs_err": 0.0,
           "library_ms": cuda_ms(code_counts, 20) + cuda_ms(lib11, 20),
           "ms": cuda_ms(lambda: ws.window_pop_counts(at, f, k, pm), 20),
           "graph_ms": graph_ms(lambda: ws.window_pop_counts(at, f, k, pm),
                                20),
           "plain_ms": cuda_ms(lambda: ws.window_pop_counts_plain(
               at, f, k, pm), 3, 1),
           # every row's window sites read once, the mask, [B, P, 4] written
           "bound": bound(H * sites + 4 * P * H + 16 * B * P)}
    k10["shape"] = k11["shape"] = f"{B} windows, H={H}, P={P}"
    return {"window_stats_tail": k10, "window_pop_counts": k11}


def time_k12(counts, transfer, flush, dev):
    """K12 over the first launch block of run H's largest span, from its
    raw upload (the bucket-padded int8 matrix read through its [:, :S]
    view), on the 10-row mask's classes: equal to its plain version and to
    K6 on the same alleles; a bf16 ``torch.matmul`` of the mask with a
    one-hot beside it."""
    import torch
    a, mask = flush[:2]
    H, S = a.shape
    al = transfer.upload_span(a, dev)[:, :S]
    classes = counts.MaskClasses(mask, dev)
    groups = classes.groups
    s1 = min(S, counts.DEFAULT_SITE_BLOCK)
    C = groups.P
    dt = counts.count_dtype(H)
    out = torch.empty((s1, C, 4), dtype=dt, device=dev)
    counts.site_pop_counts_raw(al, 0, s1, groups, out)
    err = check_equal("site_pop_counts_raw (run H span) vs plain", out,
                      counts.site_pop_counts_raw_plain(al, 0, s1,
                                                       groups.mask))
    buf, Sp = transfer.pack_span(a)
    dbuf = torch.from_numpy(buf).to(dev)
    k6_out = torch.empty_like(out)
    counts.site_pop_counts(dbuf, Sp, H, 0, s1, groups, k6_out)
    check_equal("site_pop_counts_raw vs site_pop_counts (run H span)", out,
                k6_out)
    onehot = (al[:, :s1, None] == torch.arange(4, device=dev,
                                               dtype=torch.int8)
              ).to(torch.bfloat16).reshape(H, s1 * 4)
    mask_bf = torch.from_numpy(np.asarray(mask, np.float32)).to(
        dev, torch.bfloat16)
    k12 = lambda: counts.site_pop_counts_raw(  # noqa: E731
        al, 0, s1, groups, out)
    k6 = lambda: counts.site_pop_counts(  # noqa: E731
        dbuf, Sp, H, 0, s1, groups, k6_out)
    res = {"max_abs_err": err, "ms": cuda_ms(k12, 20),
           "graph_ms": graph_ms(k12, 20),
           "plain_ms": cuda_ms(lambda: counts.site_pop_counts_raw_plain(
               al, 0, s1, groups.mask), 3, 1),
           "k6_ms": graph_ms(k6, 20),
           "library_ms": cuda_ms(lambda: torch.matmul(mask_bf, onehot), 20),
           "library_graph_ms": graph_ms(
               lambda: torch.matmul(mask_bf, onehot), 20)}
    # each row's block read once, the class counts written
    res["bound"] = bound(H * s1 + 4 * out.element_size() * s1 * C)
    res["shape"] = (f"{s1} sites, H={H}, {mask.shape[0]} mask rows as C={C} "
                    "classes")
    del onehot
    torch.cuda.empty_cache()
    return res


def time_k13(pair, transfer, flush, dev):
    """K13 at the popDist run's largest chunk (its wire-v2 flush), after
    :func:`v2_parity` there, per call and in a CUDA graph; K1 on the same
    chunk's wire-v3 flush and three bf16 Gram ``torch.matmul``s of the
    gathered called / alt factors beside it."""
    import torch
    a, first, n, mask, min_sites = flush
    w2, nwin, _ = v2_parity(pair, a, first, n, dev, [mask], min_sites)
    H = a.shape[0]
    v3 = pair._v3_flush_args(a, first, n)
    w3 = v3.wire(torch.from_numpy(v3.buf).to(dev))
    code2, fi, ns, _, _ = transfer.unpack_pair_wire(w2)
    c = pair._gather_bits(code2 & 1, fi[:nwin], ns[:nwin]).to(torch.bfloat16)
    ca = pair._gather_bits(code2 >> 1, fi[:nwin], ns[:nwin]).to(
        torch.bfloat16)
    del code2

    def grams():
        torch.matmul(c, c.transpose(1, 2))
        torch.matmul(ca, ca.transpose(1, 2))
        torch.matmul(ca, c.transpose(1, 2))
    k13 = lambda: pair.pair_counts_v2(w2, 0, nwin)  # noqa: E731
    k1 = lambda: pair.pair_counts_v3(w3, 0, nwin)  # noqa: E731
    res = {"max_abs_err": 0.0,
           "ms": cuda_ms(k13, 20), "graph_ms": graph_ms(k13, 20),
           "plain_ms": cuda_ms(lambda: pair.pair_counts_v2_plain(
               w2, 0, nwin), 3, 1),
           "k1_ms": cuda_ms(k1, 20), "k1_graph_ms": graph_ms(k1, 20),
           "library_ms": cuda_ms(grams, 20)}
    # bytes (the 1-bit tensor-core products have no data-sheet rate): the
    # covered words of both planes read once, first / n_sites, m and s
    # written
    f = first[:nwin].astype(np.int64)
    k = n[:nwin].astype(np.int64)
    has = k > 0
    words = np.where(has, ((f + k - 1) >> 5) - (f >> 5) + 1, 0)
    covered = int(((f[has] + k[has] - 1) >> 5).max() - (f[has] >> 5).min()
                  + 1) if has.any() else 0
    res["bound"] = bound(2 * 4 * H * covered + 8 * nwin
                         + 8 * nwin * H * H)
    res["shape"] = (f"{nwin} windows, H={H}, {int(words.sum())} window "
                    "words")
    del c, ca
    torch.cuda.empty_cache()
    return res


# ------------------------------------- K14, K15, K16 and the mesh routes

K14_BLOCKS = {160: [(0, 160), (30, 97), (64, 128), (150, 160)],
              77: [(0, 77), (5, 70), (63, 65)]}


def shard_mesh(pmesh, dev):
    """The mesh of the mesh checks: MESH_SHARDS shards of one card."""
    import torch
    return pmesh.Mesh([torch.device(dev.type, dev.index or 0)] * MESH_SHARDS)


def mesh_parity(pair, pmesh, mesh, a, first, n, m, s) -> None:
    """The mesh's pair counts on ``mesh`` against K9's counts ``m``, ``s``
    of the same windows: data-parallel over the first four windows (0, 1,
    777 and 66,000 sites: on two shards each shard's two windows take K9's
    split, atomic path) and over all of them, and tensor-parallel (K14 on
    each row shard) over all of them."""
    import torch
    s_max = int(n.max())
    if pair._k9_grid(a.shape[0], 2, s_max, mesh.devices[0])[1] <= 1:
        raise AssertionError("two-window shards should split K9's sites")
    want = torch.stack([m, s]).cpu()
    for w in (4, first.shape[0]):
        got = pmesh.sharded_window_pair_counts(a, first[:w], n[:w], mesh,
                                               s_max=s_max)
        check_equal(f"sharded_window_pair_counts ({w} windows) vs K9",
                    torch.from_numpy(np.stack(got)), want[:, :w])
    got = pmesh.sharded_pair_counts_tp(a, first, n, mesh, s_max=s_max)
    check_equal("sharded_pair_counts_tp vs K9",
                torch.from_numpy(np.stack(got)), want)
    torch.cuda.synchronize()


def k14_parity(pair, at, f, k, m, s, s_max) -> None:
    """K14 on ragged row blocks of H = 160 and 77 (K14_BLOCKS) against
    the rows of K9's counts ``m``, ``s`` of the same windows (0, 1 and
    66,000 sites among them), one block against its plain version, and
    the first four windows alone (the split, atomic path)."""
    import torch
    H = at.shape[0]
    for r0, r1 in K14_BLOCKS[H]:
        mr, sr = pair.pair_counts_4state_rows(at, f, k, r0, r1, s_max)
        check_equal(f"pair_counts_4state_rows m H={H} rows {r0}..{r1} vs "
                    "K9", mr, m[:, r0:r1])
        check_equal(f"pair_counts_4state_rows s H={H} rows {r0}..{r1} vs "
                    "K9", sr, s[:, r0:r1])
    r0, r1 = K14_BLOCKS[H][1]
    mr, sr = pair.pair_counts_4state_rows(at, f, k, r0, r1, s_max)
    mp, sp = pair.pair_counts_4state_plain(at, f, k, r0, r1)
    check_equal(f"pair_counts_4state_rows m H={H} vs plain", mr, mp)
    check_equal(f"pair_counts_4state_rows s H={H} vs plain", sr, sp)
    for w in range(4):
        m1, s1 = pair.pair_counts_4state_rows(at, f[w:w + 1], k[w:w + 1], r0,
                                              r1, int(k[w]))
        check_equal(f"pair_counts_4state_rows H={H} window {w} alone",
                    torch.stack([m1, s1]), torch.stack([m, s])[:, w:w + 1,
                                                               r0:r1])
    torch.cuda.synchronize()


def sfs_parity(counts, dev) -> None:
    """K15 against its plain version on counts built to tie (complete
    sites split 8/8 between two alleles, where numpy's argsort and the
    stable order pick different targets), 9/7 splits, monomorphic sites,
    8/5/3 three-allele sites and 9/7 sites with a missing call, as uint16
    and int32; K16 against torch.sum / torch.amin over stacks of 1, 2 and
    5 rows, int64 beyond 2^31 and int32."""
    import torch
    rng = np.random.default_rng(15)
    n_hap = np.array([6, 6, 4])
    H, S = int(n_hap.sum()), 20_000
    a = np.empty((S, H), np.int8)
    kind = np.arange(S) % 5
    xyz = np.argsort(rng.random((S, 4)), axis=1)[:, :3].astype(np.int8)
    order = np.argsort(rng.random((S, H)), axis=1)
    split = np.array([H // 2, H // 2 + 1, H, H // 2, H // 2 + 1])[kind]
    a[:] = np.where(order < split[:, None], xyz[:, :1], xyz[:, 1:2])
    third = (kind == 3)[:, None] & (order >= H - 3)
    a[third] = np.broadcast_to(xyz[:, 2:3], a.shape)[third]
    a[(kind == 4)[:, None] & (order == 0)] = -1
    onehot = (a[:, :, None] == np.arange(4)).astype(np.int32)   # [S, H, 4]
    c = np.add.reduceat(onehot, np.r_[0, np.cumsum(n_hap)[:-1]], axis=1)
    for dt in (torch.uint16, torch.int32):
        ct = torch.from_numpy(c).to(dev, dt)
        got = counts.global_sfs_hist(ct, n_hap)
        want = counts.global_sfs_hist_plain(ct, n_hap)
        check_equal(f"global_sfs_hist ({dt}) vs plain", got, want)
        if int(got.sum()) != int((kind < 3).sum()):
            raise AssertionError(f"global_sfs_hist: {int(got.sum())} sites "
                                 f"binned, {(kind < 3).sum()} pass")
    for dt, lim in ((torch.int64, 1 << 58), (torch.int32, 1 << 28)):
        for kk in (1, 2, 5):
            x = torch.from_numpy(rng.integers(-lim, lim, size=(kk, 1001))).to(
                dev, dt)
            x[:, 0] = lim - 1 - torch.arange(kk, device=dev, dtype=dt)
            for op, ref in (("sum", lambda t: t.sum(dim=0, dtype=dt)),
                            ("min", lambda t: t.amin(dim=0))):
                check_equal(f"stacked_reduce {op} {dt} k={kk}",
                            counts.stacked_reduce(x, op), ref(x))
    n_k16 = k16_edge_parity(counts, rng, dev)
    log(f"[parity] K16 vector edges ({n_k16} comparisons: k = "
        f"{K16_EDGE_K}, n = {K16_EDGE_N}, stacks starting 0 and 1 element "
        "past a 16-byte boundary, int32 and int64 sums wrapping past "
        "2^31 and 2^63, sum and min) == torch.sum / torch.amin")
    torch.cuda.synchronize()


def k16_edge_parity(counts, rng, dev) -> int:
    """K16 at the edges of its 16-byte vectors: k = 1..4 rows, n not a
    multiple of the vector (the scalar tail) and n below one vector, and
    each stack also a view starting one element past a 16-byte boundary
    (every row read through the shifted path); int32 and int64 values whose
    sums wrap, sum and min, against torch.sum / torch.amin exactly."""
    import torch
    n_checks = 0
    for dt, lim in ((torch.int32, 1 << 30), (torch.int64, 1 << 62)):
        for kk in K16_EDGE_K:
            for nn in K16_EDGE_N:
                for off in (0, 1):
                    flat = torch.from_numpy(rng.integers(
                        -lim, lim, size=kk * nn + off)).to(dev, dt)
                    x = flat[off:].view(kk, nn)
                    for op, ref in (("sum", x.sum(dim=0, dtype=dt)),
                                    ("min", x.amin(dim=0))):
                        check_equal(f"stacked_reduce {op} {dt} k={kk} "
                                    f"n={nn} offset {off}",
                                    counts.stacked_reduce(x, op), ref)
                        n_checks += 1
    return n_checks


def step_past_grid(pair, ws, dev) -> dict:
    """window_stats_step over STEP_WINDOWS windows (more than the 65,535 a
    K9 or K11 launch takes, which K9 refuses): its K9, K10 and K11
    launches come in STEP_CHUNK chunks, and every output equals the
    chunks run one at a time (float32 bit for bit)."""
    import torch
    rng = np.random.default_rng(16)
    a = rng.integers(0, 4, size=(STEP_H, STEP_SITES)).astype(np.int8)
    a[rng.random(a.shape) < 0.05] = -1
    first = rng.integers(0, STEP_SITES - 8, size=STEP_WINDOWS).astype(
        np.int32)
    n = rng.integers(0, 9, size=STEP_WINDOWS).astype(np.int32)
    pm = np.zeros((2, STEP_H), np.float32)
    pm[0, :STEP_H // 2] = pm[1, STEP_H // 2:] = 1
    at, f, k, pmt = (torch.from_numpy(x).to(dev) for x in (a, first, n, pm))
    try:
        pair.pair_counts_4state(at, f, k, 8)
    except ValueError:
        pass
    else:
        raise AssertionError(f"K9 took {STEP_WINDOWS} windows in one launch")
    reset((pair, ws))
    whole = ws.window_stats_step(at, f, k, pmt)
    launches = {x: v for x, v in launches_of((pair, ws)).items() if v}
    c = ws.STEP_CHUNK
    if launches != {kern: -(-STEP_WINDOWS // c) for kern in (
            "pair_counts_4state", "window_stats_tail", "window_pop_counts")}:
        raise AssertionError(f"window_stats_step launches {launches}")
    parts = [ws.window_stats_step(at, f[w0:w0 + c], k[w0:w0 + c], pmt)
             for w0 in range(0, STEP_WINDOWS, c)]
    for key, v in whole.items():
        joined = torch.cat([p[key] for p in parts])
        if v.dtype == torch.float32:
            check_same(f"window_stats_step {key} vs its chunks", v, joined)
        else:
            check_equal(f"window_stats_step {key} vs its chunks", v, joined)
    torch.cuda.synchronize()
    return launches


def k14_bound(R: int, H: int, in_bytes: float, sites: float, nwin: int):
    """K14's least time, K9's over the rectangle of R rows and H columns:
    the input read once and both [nwin, R, H] count blocks written, over
    the HBM rate, and the one-hot Gram's work (2 R H 5 sites) at the dense
    int8 tensor rate."""
    return bound(in_bytes + 8 * nwin * R * H, 2 * R * H * 5 * sites,
                 INT8_OPS_PER_S)


def time_k14(pair, transfer, flush, dev) -> dict:
    """K14 at run A's largest flush (all its windows in one launch, from
    the padded raw upload) on MESH_SHARDS row shards and on row blocks
    that cut K9's 128-row tiles: each equal to K9's rows; the first
    shard's launch timed beside its plain version, the bf16 one-hot Grams
    of its row block and K9 on the whole flush, per call and (logged
    beside) in a CUDA graph."""
    import torch
    a, first, n = flush
    H, S = a.shape
    W = first.shape[0]
    b = torch.from_numpy(transfer.pack_raw_span(a, first, n)).to(dev)
    al, f, k = transfer.raw_span_views(b, H, S, W)
    s_max = int(n.max())
    m, s = pair.pair_counts_4state(al, f, k, s_max)
    q = -(-H // MESH_SHARDS)
    shards = [(r, min(r + q, H)) for r in range(0, H, q)]
    for r0, r1 in shards + [(100, 300), (127, 129)]:
        mr, sr = pair.pair_counts_4state_rows(al, f, k, r0, r1, s_max)
        check_equal(f"pair_counts_4state_rows (run A flush, rows {r0}..{r1})"
                    " m vs K9", mr, m[:, r0:r1])
        check_equal(f"pair_counts_4state_rows (run A flush, rows {r0}..{r1})"
                    " s vs K9", sr, s[:, r0:r1])
    r0, r1 = shards[0]
    mr, sr = pair.pair_counts_4state_rows(al, f, k, r0, r1, s_max)
    mp, sp = pair.pair_counts_4state_plain(al, f, k, r0, r1)
    err = max(check_equal("pair_counts_4state_rows (run A flush) m vs plain",
                          mr, mp),
              check_equal("pair_counts_4state_rows (run A flush) s vs plain",
                          sr, sp))
    del mr, sr, mp, sp
    offs = torch.arange(s_max, device=dev)
    idx = f[:, None].long() + offs[None, :]
    valid = offs[None, :] < k[:, None]
    wa = al[:, torch.where(valid, idx, torch.zeros_like(idx))] \
        .permute(1, 0, 2)
    grams = gram_yardstick(wa, valid, slice(r0, r1))
    k14 = lambda: pair.pair_counts_4state_rows(  # noqa: E731
        al, f, k, r0, r1, s_max)
    k9 = lambda: pair.pair_counts_4state(al, f, k, s_max)  # noqa: E731
    res = {"max_abs_err": err,
           "ms": cuda_ms(k14, 10), "graph_ms": graph_ms(k14, 10),
           "plain_ms": cuda_ms(lambda: pair.pair_counts_4state_plain(
               al, f, k, r0, r1), 2, 1),
           "library_ms": cuda_ms(grams, 5),
           "library_graph_ms": graph_ms(grams, 5),
           "k9_ms": cuda_ms(k9, 10), "k9_graph_ms": graph_ms(k9, 10)}
    covered = int((first + n).max() - first.min())
    res["bound"] = k14_bound(r1 - r0, H, H * min(covered, S),
                             float(n.astype(np.int64).sum()), W)
    res["shape"] = (f"{W} windows, rows {r0}..{r1} of H={H} "
                    f"({len(shards)} row shards), longest {s_max} sites")
    del wa, grams
    torch.cuda.empty_cache()
    return res


def sfs_full_width(counts, pmesh, mesh, geno, pops, dev) -> dict:
    """K15 and K16 at full width: the popDist cohort's SFS_POPS (3 x 128
    haplotypes, 129^3 = 2,146,689 bins) over its 500,000 sites, each
    missing call filled with an allele of its own site (complete data, as
    run G).  K15 over all sites equals its plain version, K16's sum of K15
    over MESH_SHARDS site shards (K12 counts per shard; K16 equal to its
    plain version on that stack) and the mesh's sharded_global_sfs on
    ``mesh``; K15's time beside
    ``torch.bincount`` of the passing sites' precomputed flat indices,
    K16's beside ``torch.sum``."""
    import torch
    from genomics_general_tpu_torch.io import geno as geno_io
    from genomics_general_tpu_torch.samples import SampleData
    sd = SampleData.from_pop_args(population_args=[[x] for x in SFS_POPS],
                                  pops_file=str(pops), geno_format="phased")
    reader = geno_io.GenoReader(str(geno), sample_data=sd,
                                geno_format="phased")
    a = reader.read_all().alleles
    a = np.ascontiguousarray(np.where(a < 0, a.max(axis=0)[None, :], a))
    pm = reader.model.pop_mask(SFS_POPS)
    n_hap = pm.sum(axis=1).astype(np.int64)
    H, S = a.shape
    groups = counts.PopGroups(pm, dev)
    at = torch.from_numpy(a).to(dev)
    c = counts.count_raw(at, S, groups)
    hist = counts.global_sfs_hist(c, n_hap)
    err = check_equal("global_sfs_hist (full width) vs plain", hist,
                      counts.global_sfs_hist_plain(c, n_hap))
    parts = []
    for r0, r1 in [(r, min(r + -(-S // MESH_SHARDS), S))
                   for r in range(0, S, -(-S // MESH_SHARDS))]:
        cs = counts.count_raw(at[:, r0:r1].contiguous(), r1 - r0, groups)
        parts.append(counts.global_sfs_hist(cs, n_hap))
    stack = torch.stack(parts)
    k16_err = check_equal("stacked_reduce (full width) vs plain",
                          counts.stacked_reduce(stack, "sum"),
                          counts.stacked_reduce_plain(stack, "sum"))
    check_equal("stacked_reduce of the shards' K15 vs K15 over all sites",
                counts.stacked_reduce(stack, "sum"), hist)
    check_equal(f"sharded_global_sfs on {mesh} vs K15 over all sites",
                torch.from_numpy(pmesh.sharded_global_sfs(a, pm, n_hap, mesh)
                                 .reshape(-1)), hist)
    binned = int(hist.sum())
    # the passing sites' flat bin indices, as the plain version makes them
    cl = c.to(torch.int64)
    total = cl.sum(dim=1)
    nh = torch.from_numpy(n_hap).to(dev)
    ok = (cl.sum(dim=2) == nh).all(dim=1) & ((total > 0).sum(dim=1) <= 2)
    tgt = torch.gather(cl, 2, torch.argsort(total, dim=1, stable=True)[
        :, 2, None, None].expand(-1, cl.shape[1], 1))[:, :, 0]
    dims = counts.sfs_dims(n_hap)
    stride = torch.tensor([int(np.prod(dims[p + 1:])) for p in
                           range(len(dims))], device=dev)
    flat = (tgt * stride).sum(dim=1)[ok]
    nbins = int(np.prod(dims))
    check_equal("torch.bincount yardstick vs K15",
                torch.bincount(flat, minlength=nbins), hist)
    del cl, total, tgt
    k15 = {"max_abs_err": err,
           "ms": cuda_ms(lambda: counts.global_sfs_hist(c, n_hap), 20),
           "graph_ms": graph_ms(lambda: counts.global_sfs_hist(c, n_hap),
                                20),
           "plain_ms": cuda_ms(lambda: counts.global_sfs_hist_plain(
               c, n_hap), 3, 1),
           "library_ms": cuda_ms(lambda: torch.bincount(
               flat, minlength=nbins), 20),
           # the counts read once, n_hap, the histogram written
           "bound": bound(c.numel() * c.element_size() + 4 * len(n_hap)
                          + 4 * nbins),
           "shape": (f"{S} sites, P={len(n_hap)}, {nbins} bins, {binned} "
                     "sites binned")}
    k16_call = lambda: counts.stacked_reduce(stack, "sum")  # noqa: E731
    lib16 = lambda: torch.sum(stack, dim=0, dtype=stack.dtype)  # noqa: E731
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # a K16 call and a torch.sum call are both tens of µs, where the host's
    # noise is as large as their difference: 200 calls each, in turns
    # (K16, sum, sum, K16), the lesser reading of each
    calls = {k16_call: [], lib16: []}
    for fn in (k16_call, lib16, lib16, k16_call):
        calls[fn].append(cuda_ms(fn, 200))
    k16 = {"max_abs_err": k16_err,
           "ms": min(calls[k16_call]),
           "plain_ms": cuda_ms(lambda: counts.stacked_reduce_plain(
               stack, "sum"), 20),
           "library_ms": min(calls[lib16]),
           "graph_ms": graph_ms(k16_call, 20),
           "library_graph_ms": graph_ms(lib16, 20),
           "cold_graph_ms": cold_graph_ms(k16_call, 20, scratch),
           "library_cold_graph_ms": cold_graph_ms(lib16, 20, scratch),
           # the stack read once, one row written
           "bound": bound(stack.numel() * stack.element_size()
                          + nbins * stack.element_size()),
           "shape": f"[{stack.shape[0]}, {nbins}] int32, sum"}
    del scratch
    log(f"[kernel] global_sfs_hist at full width ({k15['shape']}): K15 == "
        f"plain == {MESH_SHARDS} shards + K16 (== plain) == "
        f"sharded_global_sfs on {mesh} == torch.bincount")
    log(f"[kernel] stacked_reduce at {k16['shape']}: K16 {k16['ms']:.4f} ms "
        f"(readings {calls[k16_call]}; "
        f"{k16['graph_ms']:.4f} ms in a CUDA graph, "
        f"{k16['cold_graph_ms']:.4f} with the L2 cold), torch.sum "
        f"{k16['library_ms']:.4f} ms (readings {calls[lib16]}; "
        f"{k16['library_graph_ms']:.4f} in a "
        f"CUDA graph, {k16['library_cold_graph_ms']:.4f} with the L2 cold); "
        f"bound {k16['bound'][0]:.4f} ms ({k16['bound'][1]})")
    k16["call_us"] = k16_call_breakdown(counts, stack)
    log("[kernel] stacked_reduce, host µs a call (time.perf_counter_ns, "
        "each step alone): " + ", ".join(
            f"{k} {v:.2f}" for k, v in k16["call_us"].items()))
    del at, c, flat, stack, parts
    torch.cuda.empty_cache()
    return {"global_sfs_hist": k15, "stacked_reduce": k16}


def k16_call_breakdown(counts, stack, reps: int = 500) -> dict:
    """Where a K16 call's host time goes: the wrapper's steps, each alone
    in a loop of ``reps`` calls timed with time.perf_counter_ns (µs a
    call), beside the whole wrapper, the public stream handle it no longer
    reads, and one torch.sum."""
    import torch
    from genomics_general_tpu_torch.kernels import pairdist
    out = counts.stacked_reduce(stack, "sum")
    dev = stack.device
    entry = counts._ggt_stacked_reduce
    steps = {
        "checks": lambda: (stack.shape, stack.is_cuda,
                           stack.dtype is torch.int32,
                           stack.is_contiguous()),
        "torch.empty": lambda: torch.empty(stack.shape[1:],
                                           dtype=stack.dtype, device=dev),
        "data_ptr and numel": lambda: (stack.data_ptr(), out.data_ptr(),
                                       out.numel()),
        "stream handle": lambda: pairdist._stream_ptr(out),
        "public stream handle": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "entry call (ctypes, launch)": lambda: entry(
            stack.data_ptr(), False, stack.shape[0], out.numel(), False,
            out.data_ptr(), pairdist._stream_ptr(out)),
        "whole wrapper": lambda: counts.stacked_reduce(stack, "sum"),
        "torch.sum": lambda: torch.sum(stack, dim=0, dtype=stack.dtype),
    }
    got = {}
    for name, fn in steps.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        got[name] = (time.perf_counter_ns() - t0) / reps / 1e3
        torch.cuda.synchronize()
    return got


@contextlib.contextmanager
def shard_calls(transfer, mods, dispatches):
    """While open, each call of a dispatch in ``dispatches`` (module,
    attribute) opens a group in the list yielded, and each per-shard call
    of the mesh routes (transfer.fetch_on, transfer.run_on_device; one a
    shard, in device order) adds to the open group its device and the
    launches it made."""
    import torch
    groups, depth, saved = [], [0], []

    def shard(real):
        def call(*a, **kw):
            depth[0] += 1
            before = launches_of(mods)
            try:
                return real(*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0 and groups:
                    after = launches_of(mods)
                    d = next(x for x in a if isinstance(x, torch.device))
                    groups[-1].append((str(d), {
                        x: after[x] - before[x] for x in after
                        if after[x] != before[x]}))
        return call

    def dispatch(real):
        def call(*a, **kw):
            groups.append([])
            return real(*a, **kw)
        return call
    for mod, attr, wrap in [(transfer, "fetch_on", shard),
                            (transfer, "run_on_device", shard)] + \
            [(m, at, dispatch) for m, at in dispatches]:
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr)))
    try:
        yield groups
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


def mesh_runs(mods, clis, transfer, mesh, geno, pops, n_sites, work):
    """Runs M, N and O: run A's, run C's and popDist's CLI flags with
    cli.common.get_mesh patched to ``mesh``.  Each resets the launch
    counts just before and reads them just after; it must launch exactly
    its mesh route's kernels (runs M and O: K9 + K4 on each window slab,
    M also K6 on each site slab, no K1; run N: K6 + K7 on each replica and
    K8 on each window slab), every launch inside a shard's call, every
    shard's call launching, a dispatch split over the mesh, every device
    of the mesh called, and write the bytes of its meshless run
    (``{base}.gpu.csv`` in ``work``); run O, where the mesh takes
    popDist off the blocks route, its rows within one rounding quantum.
    Returns ({run: launches}, report)."""
    from genomics_general_tpu_torch.cli import common
    pair, counts, abba = mods
    cases = (("run_M", "run_A", ("pair_counts_4state", "tri_pack",
                                 "site_pop_counts"),
              [(pair, "window_pair_counts_dispatch"),
               (counts, "site_pop_counts_dispatch")]),
             ("run_N", "run_C", ABBA_KERNELS,
              [(abba, "window_abba_sums_dispatch")]),
             ("run_O", "popDist", ("pair_counts_4state", "tri_pack"),
              [(pair, "window_pair_counts_dispatch")]))
    launches, report = {}, {}
    real_mesh = common.get_mesh
    common.get_mesh = lambda: mesh
    try:
        for name, base, need, dispatches in cases:
            cli, tail, _, _ = RUNS[base]
            out = work / f"{name}.csv"
            with shard_calls(transfer, mods, dispatches) as groups:
                reset(mods)
                wall, err = run_cli(clis[cli], [
                    "-g", str(geno), "-f", "phased", *tail, "--popsFile",
                    str(pops), "--profile", "-o", str(out)],
                    {"GGT_EXEC": "device"})
                got = launches_of(mods)
            ran = {k for k, v in got.items() if v}
            if ran != set(need):
                raise AssertionError(f"{name}: launched {sorted(ran)}, "
                                     f"expected {sorted(need)}")
            calls = [c for g in groups for c in g]
            in_calls = {k: sum(c[1].get(k, 0) for c in calls) for k in need}
            per_device = {str(d): sum(c[0] == str(d) for c in calls)
                          for d in dict.fromkeys(mesh.devices)}
            split = sum(len(g) >= min(mesh.size, 2) for g in groups)
            if in_calls != {k: got[k] for k in need} or \
                    not all(c[1] for c in calls) or not split or \
                    not all(per_device.values()):
                raise AssertionError(
                    f"{name}: shard calls {len(calls)} over {len(groups)} "
                    f"dispatches launched {in_calls} of {got}, calls per "
                    f"device {per_device}: a shard call without a launch, a "
                    "launch outside the shards, no dispatch split or a "
                    "device never called")
            if base == "popDist":
                # its blocks route against the mesh's tri route: one
                # rounding quantum, as against the host executor
                moved = rows_within_quantum(work / f"{base}.gpu.csv", out,
                                            f"{name} on the mesh vs {base}")
                same = f"within {QUANTUM} of {base} ({moved} cells moved)"
            else:
                same_bytes([work / f"{base}.gpu.csv", out],
                           f"{name} on the mesh vs {base}")
                moved, same = 0, f"byte-identical to {base}"
            launches[name] = got
            report[name] = {"wall_s": wall, "sites_per_s": n_sites / wall,
                            "mesh": str(mesh), "dispatches": len(groups),
                            "shard_calls": len(calls),
                            "calls_per_device": per_device,
                            "dispatches_split": split,
                            "cells_moved_vs_meshless": moved,
                            "profile": profile_line(err)}
            log(f"[e2e] {name} ({base}'s flags on {mesh}): wall {wall:.3f}s, "
                f"{n_sites / wall:.0f} sites/s, launches "
                f"{ {k: v for k, v in got.items() if v} }; {len(calls)} "
                f"shard calls over {len(groups)} dispatches ({split} split), "
                f"calls per device {per_device}, each launching; {same}")
            log(f"[e2e] {name} {profile_line(err)}")
    finally:
        common.get_mesh = real_mesh
    return launches, report


def dry_run(mods, entry) -> tuple[dict, dict]:
    """The port's dryrun_multichip over every card (a one-device mesh on
    one card), the launch counts reset just before and read just after:
    it must launch K14, K15 and K16 (and the data-parallel and
    sequence-parallel kernels) and raise on no difference."""
    import torch
    n = torch.cuda.device_count()
    reset(mods)
    t0 = time.perf_counter()
    entry.dryrun_multichip(n)
    wall = time.perf_counter() - t0
    got = launches_of(mods)
    need = ("pair_counts_4state", "pair_counts_4state_rows",
            "site_pop_counts_raw", "global_sfs_hist", "stacked_reduce",
            "tri_pack", "site_pop_counts", *ABBA_KERNELS)
    missing = [k for k in need if got[k] <= 0]
    if missing:
        raise AssertionError(f"dryrun_multichip: {missing} never launched "
                             f"({got})")
    log(f"[e2e] dryrun_multichip({n}): wall {wall:.3f}s, launches "
        f"{ {k: v for k, v in got.items() if v} }; every mesh route equal to "
        "its meshless route")
    return got, {"wall_s": wall, "n_devices": n}


# --------------------- K17-K20: LD tables, called counts, one-hot, flush

def k18_edge_parity(counts, dev) -> int:
    """K18 at the edges of its blocks, on odd-stride views of codes -7..5:
    spans that end inside a block at both row widths (H = 160, 40,003
    sites at 16 lanes and 517 at 8), one population of H = 600 rows (a
    class of more than 255), and masks with an all-zero row, rows in no
    population and 70 overlapping rows (two fold chunks), against the
    plain version exactly.  Returns the number of comparisons."""
    import torch
    rng = np.random.default_rng(18)
    checks = 0
    widths = set()
    for H, S in ((160, 40_003), (160, 517), (600, 1_001)):
        wide = torch.from_numpy(rng.integers(-7, 6, size=(H, S + 8)).astype(
            np.int8)).to(dev)
        a = wide[:, 3:3 + S]
        over = (rng.random((6, H)) < 0.4).astype(np.float64)
        over[2] = 0.0
        over[:, :5] = 0.0
        masks = {"1 pop": np.ones((1, H)),
                 "an all-zero row, rows in no pop": over,
                 "70 overlapping rows": (rng.random((70, H)) < 0.2).astype(
                     np.float64)}
        for name, mask in masks.items():
            widths.add(counts._k12_lanes(
                S, -(-mask.shape[0] // counts._K18_FOLD_ROWS), dev))
            check_equal(f"site_nonmissing H={H} S={S} {name} vs plain",
                        counts.site_nonmissing(a, mask),
                        counts.site_nonmissing_plain(
                            a, torch.from_numpy(mask)))
            checks += 1
    if widths != {8, 16}:
        raise AssertionError(f"K18's edge checks ran at lanes {widths}")
    torch.cuda.synchronize()
    return checks


def k17_k20_parity(ldk, counts, pair, transfer, dev) -> None:
    """K17-K20 against their plain versions on the same CUDA tensors,
    exactly, on messy inputs: codes -7..5 read through a row stride; K17 at
    H = 160 and 77 with S = 0, 1, 33, 517 (ragged against its 16-site
    tiles); K18 with 1 and 5 disjoint populations and a 10-row overlapping
    mask, and at its block edges (:func:`k18_edge_parity`); K19; K20 on
    flushes with 0- and 1-site windows, pad windows, a window running to
    the last site of an unaligned-metadata span, a cut at s_max, and the
    int32 branch (one window of 66,000 sites), each also equal to K9 + K4
    on the unpacked flush."""
    import torch
    rng = np.random.default_rng(17)
    for H in (160, 77):
        wide = torch.from_numpy(rng.integers(-7, 6, size=(H, 530)).astype(
            np.int8)).to(dev)
        for S in (0, 1, 33, 517):
            a = wide[:, 3:3 + S]
            check_equal(f"pair_allele_tables H={H} S={S} vs plain",
                        ldk.pair_allele_tables(a),
                        ldk.pair_allele_tables_plain(a))
        a = wide[:, 5:522]
        part = np.zeros((5, H))
        part[rng.integers(0, 5, size=H), np.arange(H)] = 1.0
        over = (rng.random((10, H)) < 0.3).astype(np.float64)
        over[9] = 1.0
        over[:, 0] = 0.0
        for name, mask in (("1 pop", np.ones((1, H))), ("5 pops", part),
                           ("10-row overlapping mask", over)):
            check_equal(f"site_nonmissing H={H} {name} vs plain",
                        counts.site_nonmissing(a, mask),
                        counts.site_nonmissing_plain(
                            a, torch.from_numpy(mask)))
        check_equal(f"sample_base_counts H={H} vs plain",
                    counts.sample_base_counts(a),
                    counts.sample_base_counts_plain(a))
    k18_edge_parity(counts, dev)
    a, first, n, _ = messy_input(160)
    first = np.concatenate([first, [17]]).astype(np.int32)
    n = np.concatenate([n, [1]]).astype(np.int32)
    flushes = {"messy H=160": (a, first, n, 1 << 16, None)}
    b = np.random.default_rng(18).integers(-1, 4, size=(77, 40)).astype(
        np.int8)
    flushes["unaligned H=77"] = (b, np.array([0, 30, 5, 39], np.int32),
                                 np.array([40, 10, 0, 1], np.int32), 8, None)
    flushes["s_max cut H=77"] = (b, np.array([0, 2], np.int32),
                                 np.array([40, 33], np.int32), 8, 32)
    a, first, n = long_window_input()
    flushes["int32 branch H=24"] = (a, first, n, 1 << 16, None)
    for name, (a, first, n, min_bucket, s_max) in flushes.items():
        H, W = a.shape[0], first.shape[0]
        wp = pair._next_pow2(W, 8)
        buf, sp = transfer.pack_flush_buffer(a, first, n, wp, min_bucket)
        if name.startswith("unaligned"):
            assert (H * (sp // 4 + sp // 8)) % 4 and sp == a.shape[1]
        dbuf = torch.from_numpy(buf).to(dev)
        s_max = s_max or pair._next_pow2(int(n.max()), 256)
        got = pair._fused_flush_pair_counts(dbuf, sp, H, wp, s_max, 4)
        check_equal(f"flush_pair_counts ({name}) vs plain", got,
                    pair._fused_flush_pair_counts_plain(dbuf, sp, H, wp,
                                                        s_max, 4))
        al, f, k = transfer.unpack_flush_buffer(dbuf, sp, H, wp)
        check_equal(f"flush_pair_counts ({name}) vs K9 + K4", got,
                    pair.flush_tri_4state(al, f, k.clamp(max=s_max), wp,
                                          s_max < (1 << 16), s_max))
        if name.startswith("int32") != (got.dtype == torch.int32):
            raise AssertionError(f"flush_pair_counts ({name}): {got.dtype}")
        zero = np.flatnonzero(n == 0).tolist() + list(range(W, wp))
        if got.cpu().numpy()[zero].any():
            raise AssertionError(f"flush_pair_counts ({name}): pad or "
                                 "empty windows not zero")
    torch.cuda.synchronize()


def edge_codes(H: int, S: int, seed: int) -> np.ndarray:
    """Codes 0..3 with 10 % missing and codes -7, 5 and 127 on 3 % of cells
    each (-7 missing, 5 and 127 called but matching nothing)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(H, S)).astype(np.int8)
    hit = rng.random((H, S))
    a[hit < 0.1] = -1
    for k, code in enumerate((-7, 5, 127)):
        a[(hit >= 0.1 + 0.03 * k) & (hit < 0.13 + 0.03 * k)] = code
    return a


def k17_edge_parity(ldk, dev) -> int:
    """K17 at the edges of its 32-site tiles and 32-haplotype steps: every
    H of K17_EDGE_H with every S of K17_EDGE_S on contiguous rows, and S =
    597 on rows read through an odd stride, against the plain version
    exactly (codes from :func:`edge_codes`).  Returns the number of
    comparisons."""
    import torch
    checks = 0
    for H in K17_EDGE_H:
        wide = torch.from_numpy(edge_codes(H, max(K17_EDGE_S) + 5,
                                           170 + H)).to(dev)
        for S in K17_EDGE_S:
            a = wide[:, :S].contiguous()
            check_equal(f"pair_allele_tables H={H} S={S} vs plain",
                        ldk.pair_allele_tables(a),
                        ldk.pair_allele_tables_plain(a))
            checks += 1
        a = wide[:, 3:600]
        check_equal(f"pair_allele_tables H={H} S=597 strided vs plain",
                    ldk.pair_allele_tables(a),
                    ldk.pair_allele_tables_plain(a))
        checks += 1
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return checks


def k6_edge_parity(counts, transfer, pair, dev) -> int:
    """K6 at the edges of its row-slot loop on span wires, uint16 and int32
    out, against its plain version exactly: each (H, S, s0, s1) of K6_EDGE
    (s0 = 0 and nonzero multiples of 8, s1 not a multiple of 4, and one
    block of 70,000 sites, which takes 16 lanes a row) on a partition of
    four groups with a 33-row group, or at H = 8,300 on one group, whose
    byte lanes widen past 255 rows a slot; and a 10-row overlapping mask
    with rows in no mask as its classes at H = 77; codes from
    :func:`edge_codes` cut to the wire's -1..3.  Returns the number of
    comparisons."""
    import torch
    checks = 0
    widths = set()
    for H, S, s0, s1 in K6_EDGE:
        a = edge_codes(H, S, 60 + H + S)
        a = np.where((a < 0) | (a > 3), -1, a).astype(np.int8)
        buf, sp = transfer.pack_span(a)
        dbuf = torch.from_numpy(buf).to(dev)
        rng = np.random.default_rng(H + S)
        cls = rng.integers(0, 4, H)
        cls[:min(33, H)] = 0
        part = np.zeros((4, H))
        part[cls, np.arange(H)] = 1.0
        masks = {"4 groups": pair.PopGroups(part, dev)}
        if H > 255 * 32:
            masks = {"one group": pair.PopGroups(np.ones((1, H)), dev)}
        if H == 77:
            over = (rng.random((10, H)) < 0.3).astype(np.float64)
            over[9] = 1.0
            over[:, :5] = 0.0
            masks["10-row mask's classes"] = counts.MaskClasses(
                over, dev).groups
        for name, groups in masks.items():
            widths.add(counts._k12_lanes(s1 - s0, groups.P, dev))
            want = counts.site_pop_counts_plain(dbuf, sp, H, s0, s1,
                                                groups.mask)
            for dt in (torch.uint16, torch.int32):
                out = torch.empty((s1 - s0, groups.P, 4), dtype=dt,
                                  device=dev)
                counts.site_pop_counts(dbuf, sp, H, s0, s1, groups, out)
                check_equal(f"site_pop_counts H={H} {s0}..{s1} {name} "
                            f"{dt} vs plain", out, want)
                checks += 1
    if widths != {8, 16}:
        raise AssertionError(f"K6's edge checks ran at lanes {widths}")
    torch.cuda.synchronize()
    return checks


def cohort_windows(geno, pops, n_windows: int, size: int = 50_000):
    """The cohort's first ``n_windows`` coordinate windows of ``size`` bp
    on its first scaffold, as int8 [H, S] arrays (the port's reader)."""
    from genomics_general_tpu_torch.io import geno as geno_io
    from genomics_general_tpu_torch.samples import SampleData
    sd = SampleData.from_pop_args(
        population_args=[[f"pop{p}"] for p in range(1, 5)],
        pops_file=str(pops), geno_format="phased")
    reader = geno_io.GenoReader(str(geno), sample_data=sd,
                                geno_format="phased")
    end = n_windows * size
    parts, pos = [], []
    for c in reader.iter_chunks(threads=1):
        keep = (c.scaffold_ids == 0) & (c.positions <= end)
        parts.append(c.alleles[:, keep])
        pos.append(c.positions[keep])
        if not keep.all():
            break
    a, pos = np.concatenate(parts, axis=1), np.concatenate(pos)
    win = (pos - 1) // size
    return [np.ascontiguousarray(a[:, win == w]) for w in range(n_windows)]


def run_p(ldk, stats_ld, geno, pops, dev):
    """Run P: stats.ld.ld_matrix(a, "r2", use_device=True) through the port
    over the popDist cohort's first 32 windows (H = 512), the launch count
    reset just before: K17 must launch once a window; each window's tables
    must equal the plain version's, and the first two windows' matrices
    the numpy route's (use_device=False) bit for bit, NaN positions equal.
    Returns (launches, the first four windows, report)."""
    import torch
    wins = cohort_windows(geno, pops, LD_WINDOWS)
    real = ldk.window_pair_tables
    tables, t_dev = [], [0.0]

    def timed(a):
        t0 = time.perf_counter()
        out = real(a)
        t_dev[0] += time.perf_counter() - t0
        tables.append(out)
        return out
    ldk.window_pair_tables = timed
    try:
        ldk.reset_launches()
        t0 = time.perf_counter()
        mats = [stats_ld.ld_matrix(a, "r2", use_device=True) for a in wins]
        wall = time.perf_counter() - t0
        launches = dict(ldk.LAUNCHES)
    finally:
        ldk.window_pair_tables = real
    if launches["pair_allele_tables"] != len(wins):
        raise AssertionError(f"run_P: K17 launched "
                             f"{launches['pair_allele_tables']} times for "
                             f"{len(wins)} windows")
    for w, (a, t) in enumerate(zip(wins, tables)):
        check_equal(f"run_P window {w} tables vs plain", torch.from_numpy(t),
                    ldk.pair_allele_tables_plain(torch.from_numpy(a).to(dev)))
    for w in range(LD_EXACT_WINDOWS):
        want = stats_ld.ld_matrix(wins[w], "r2", use_device=False)
        got = mats[w]
        if got.shape != want.shape or \
                not np.array_equal(np.isnan(got), np.isnan(want)) or \
                not np.array_equal(got.view(np.int64), want.view(np.int64)):
            raise AssertionError(f"run_P window {w}: the device route's r2 "
                                 "differs from use_device=False")
    finite = sum(int(np.isfinite(m).sum()) for m in mats)
    if not finite or any(np.nanmax(m) > 1.0 + 1e-12 or np.nanmin(m) < 0.0
                         for m in mats):
        raise AssertionError("run_P: r2 outside [0, 1] or never finite")
    sites = [a.shape[1] for a in wins]
    report = {"wall_s": wall, "tables_s": t_dev[0],
              "host_finalize_s": wall - t_dev[0], "windows": len(wins),
              "sites": int(sum(sites)), "finite_cells": finite}
    log(f"[e2e] run_P ld_matrix(r2, use_device=True): {len(wins)} windows "
        f"of {min(sites)}-{max(sites)} sites, H={wins[0].shape[0]}: wall "
        f"{wall:.3f}s (tables on the card + fetch {t_dev[0]:.3f}s, host "
        f"finalize {wall - t_dev[0]:.3f}s), launches {launches}; tables == "
        f"plain; windows 0-{LD_EXACT_WINDOWS - 1} bit-equal to "
        "use_device=False")
    return launches, wins[:4], report


def run_r(mods, counts, pair, transfer, span, flush, block, dev):
    """Run R: the three library entry points no CLI calls, once each at
    full width as a caller would, the launch counts reset just before:
    counts.site_nonmissing over run A's largest count span, with its mask;
    counts.sample_base_counts over 65,536 sites of run E's block; and
    pairdist._fused_flush_pair_counts on run A's largest flush.  Each is
    then held against another route: K18 against the called sum of K6's
    counts, K19 summed over haplotypes against K12's one-population counts,
    K20 against K9 + K4.  Returns (launches, the inputs, report)."""
    import torch
    a, mask = span
    H, S = a.shape
    at = torch.from_numpy(a).to(dev)
    e_block = block[0][:, :K19_SITES]
    fa, ff, fn = flush[:3]
    wp = pair._next_pow2(ff.shape[0], 8)
    buf, sp = transfer.pack_flush_buffer(fa, ff, fn, wp)
    dbuf = torch.from_numpy(buf).to(dev)
    s_max = pair._next_pow2(int(fn.max()), 256)
    torch.cuda.synchronize()
    reset(mods)
    t0 = time.perf_counter()
    called = counts.site_nonmissing(at, mask)
    onehot = counts.sample_base_counts(e_block)
    tri = pair._fused_flush_pair_counts(dbuf, sp, fa.shape[0], wp, s_max, wp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(mods)
    for k in ("site_nonmissing", "sample_base_counts", "flush_pair_counts"):
        if launches[k] != 1:
            raise AssertionError(f"run_R: kernel {k} launched "
                                 f"{launches[k]} times (1 expected)")
    c6 = counts.site_pop_counts_chunked(a, mask)
    check_equal("run_R site_nonmissing vs K6's called counts", called,
                torch.from_numpy(c6.sum(axis=2)))
    groups = pair.PopGroups(np.ones((1, H)), dev)
    c12 = counts.count_raw(e_block, e_block.shape[1], groups)
    check_equal("run_R sample_base_counts summed vs K12",
                onehot.sum(dim=0), c12[:, 0])
    al, f, k = transfer.unpack_flush_buffer(dbuf, sp, fa.shape[0], wp)
    check_equal("run_R flush_pair_counts vs K9 + K4", tri,
                pair.flush_tri_4state(al, f, k, wp, s_max < (1 << 16),
                                      s_max))
    report = {"wall_s": wall, "span_sites": S, "onehot_sites": K19_SITES,
              "flush_windows": int(ff.shape[0])}
    log(f"[e2e] run_R library entry points at H={H}: site_nonmissing over "
        f"{S} sites, P={mask.shape[0]}; sample_base_counts over "
        f"{K19_SITES} sites; _fused_flush_pair_counts over {ff.shape[0]} "
        f"windows (wp={wp}, s_max={s_max}): wall {wall:.3f}s, launches "
        f"{ {k: launches[k] for k in KERNELS if launches.get(k)} }; == K6, "
        "K12, K9 + K4")
    return launches, (at, mask, e_block, (dbuf, sp, fa, ff, fn, wp, s_max)), \
        report


def run_q(clis, geno_f, work):
    """Run Q: phymlSlidingWindows (builtin NJ, --njCorrect --maxLDphase
    --bootstraps 1 --seed 7 -T 4) on run F's cohort's first scaffold and
    raxmlSlidingWindows (builtin NJ) on all of it, through the port under
    the default GGT_DEVICE=cuda: one row and one tree a window, every tree
    ends in ';'.  No kernel runs (--maxLDphase is numpy, as in JAX)."""
    import gzip
    with gzip.open(geno_f, "rt") as fh:
        fh.readline()
        scaf = fh.readline().split("\t", 1)[0]
    report = {}
    for name, argv, boot in (
            ("phyml", ["--phyml", "builtin-nj", "--njCorrect",
                       "--maxLDphase", "--bootstraps", "1", "--seed", "7",
                       "-T", "4", "--include", scaf], 1),
            ("raxml", ["--raxml", "builtin-nj"], 0)):
        prefix = str(work / f"run_Q.{name}")
        wall, _ = run_cli(clis[name], ["-g", str(geno_f), "-w", "50000",
                                       "-M", "100", *argv, "-p", prefix])
        rows = Path(prefix + ".data.tsv").read_text().splitlines()[1:]
        for suffix in ["trees.gz"] + [f"BS{b}.trees.gz" for b in range(boot)]:
            trees = gzip.open(f"{prefix}.{suffix}", "rt").read().splitlines()
            if len(trees) != len(rows) or not rows or \
                    not all(t.endswith(";") for t in trees):
                raise AssertionError(f"run_Q {name}: {len(rows)} rows, "
                                     f"{suffix} {trees[:2]}")
        report[f"{name}_wall_s"] = wall
        report[f"{name}_windows"] = len(rows)
        log(f"[e2e] run_Q {name}_sliding_windows {' '.join(argv)}: "
            f"{len(rows)} windows, wall {wall:.3f}s; every tree ends in ';'")
    return None, None, report


def time_k17(ldk, wins, dev):
    """K17 at run P's first window (~625 sites) and at its first 2,048
    sites, per call and in a CUDA graph, beside its plain version, the
    bf16 one-hot torch.matmul Gram (bf16 output rounds counts above 256, so
    it is timed, not compared) and torch._int_mm of the int8 one-hot (an
    exact int32 [4S, 4S] Gram, the same output bytes; its operands' sides
    padded with zeros to multiples of 8 as it requires, the second one
    column-major).  Bound: the alleles read and the tables written once,
    and the one-hot Gram's 2 (4 S)^2 H operations at the dense int8 tensor
    rate."""
    import torch
    out = {}
    span = np.concatenate(wins, axis=1)
    first = wins[0].shape[1]
    for S in (first, 2048):
        a = torch.from_numpy(np.ascontiguousarray(span[:, :S])).to(dev)
        H = a.shape[0]
        got = ldk.pair_allele_tables(a)
        err = check_equal(f"pair_allele_tables ({S} sites) vs plain", got,
                          ldk.pair_allele_tables_plain(a))
        del got
        flat = (a[:, :, None] == torch.arange(4, device=dev, dtype=torch.int8)
                ).to(torch.bfloat16).reshape(H, 4 * S)
        oh8 = torch.zeros((-(-4 * S // 8) * 8, -(-H // 8) * 8),
                          dtype=torch.int8, device=dev)
        oh8[:4 * S, :H] = flat.T.to(torch.int8)
        k17 = lambda: ldk.pair_allele_tables(a)  # noqa: E731
        gram = lambda: torch.matmul(flat.T, flat)  # noqa: E731
        int_mm = lambda: torch._int_mm(oh8, oh8.T)  # noqa: E731
        r = {"max_abs_err": err, "ms": cuda_ms(k17, 10),
             "graph_ms": graph_ms(k17, 10),
             "plain_ms": cuda_ms(lambda: ldk.pair_allele_tables_plain(a),
                                 3, 1),
             "library_ms": cuda_ms(gram, 10),
             "library_graph_ms": graph_ms(gram, 10),
             "int_mm_ms": cuda_ms(int_mm, 10),
             "int_mm_graph_ms": graph_ms(int_mm, 10),
             "bound": bound(H * S + 64 * S * S, 2 * 16 * S * S * H,
                            INT8_OPS_PER_S),
             "shape": f"{S} sites, H={H}"}
        out[S] = r
        log(f"[kernel] pair_allele_tables at {r['shape']}: kernel "
            f"{r['ms']:.4f} ms ({r['graph_ms']:.4f} in a CUDA graph), plain "
            f"{r['plain_ms']:.4f} ms, bf16 Gram {r['library_ms']:.4f} ms "
            f"({r['library_graph_ms']:.4f} in a CUDA graph), int8 _int_mm "
            f"{r['int_mm_ms']:.4f} ms ({r['int_mm_graph_ms']:.4f} in a CUDA "
            f"graph), bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
        del flat, oh8
        torch.cuda.empty_cache()
    res = dict(out[first])
    res["at_2048"] = {k: v for k, v in out[2048].items()
                      if k not in ("max_abs_err", "shape")}
    return res


def time_k18_k20(counts, pair, transfer, inputs, dev,
                 int32_rate: float) -> dict:
    """K18 over run A's largest count span, K19 over 65,536 sites of run
    E's block, K20 on run A's largest flush (beside K9 + K4 on the same
    flush, the unpack included): each with its plain version, its bound
    and, for K18 and K19, one PyTorch call (a bf16 torch.matmul of the
    mask with the called matrix; torch.eq against the four codes)."""
    import torch
    at, mask, e_block, (dbuf, sp, fa, ff, fn, wp, s_max) = inputs
    H, S = at.shape
    P = mask.shape[0]
    res = {}
    called = (at >= 0).to(torch.bfloat16)
    mask_bf = torch.from_numpy(np.asarray(mask, np.float32)).to(
        dev, torch.bfloat16)
    pm = torch.from_numpy(np.asarray(mask, np.float64))
    k18 = lambda: counts.site_nonmissing(at, mask)  # noqa: E731
    lib18 = lambda: torch.matmul(mask_bf, called)  # noqa: E731
    res["site_nonmissing"] = {
        "max_abs_err": check_equal(
            "site_nonmissing (run A span) vs plain", k18(),
            counts.site_nonmissing_plain(at, pm)),
        "ms": cuda_ms(k18, 20), "graph_ms": graph_ms(k18, 20),
        "plain_ms": cuda_ms(lambda: counts.site_nonmissing_plain(at, pm),
                            5, 1),
        "library_ms": cuda_ms(lib18, 20),
        "library_graph_ms": graph_ms(lib18, 20),
        "bound": bound(H * S + 4 * S * P, H * S, int32_rate),
        "shape": f"{S} sites, H={H}, P={P}"}
    del called
    Hb, Sb = e_block.shape
    codes = torch.arange(4, device=dev, dtype=torch.int8)
    res["sample_base_counts"] = {
        "max_abs_err": check_equal(
            "sample_base_counts (run E block) vs plain",
            counts.sample_base_counts(e_block),
            counts.sample_base_counts_plain(e_block)),
        "ms": cuda_ms(lambda: counts.sample_base_counts(e_block), 10),
        "graph_ms": graph_ms(lambda: counts.sample_base_counts(e_block), 10),
        "plain_ms": cuda_ms(lambda: counts.sample_base_counts_plain(
            e_block), 3, 1),
        "library_ms": cuda_ms(lambda: torch.eq(
            e_block[..., None], codes).to(torch.int32), 10),
        "bound": bound(Hb * Sb + 16 * Hb * Sb),
        "shape": f"{Sb} sites, H={Hb} ({16 * Hb * Sb / 1e6:.0f} MB out)"}
    torch.cuda.empty_cache()
    H, W = fa.shape[0], ff.shape[0]
    u16 = s_max < (1 << 16)
    tri = pair._fused_flush_pair_counts(dbuf, sp, H, wp, s_max, wp)
    # K20's bound: the windows' sites of the buffer (3 bits a site and
    # haplotype) and the metadata read once, the tri rows written once
    need = np.zeros(sp, bool)
    for f0, k0 in zip(ff, np.minimum(fn, s_max)):
        need[max(int(f0), 0):max(min(int(f0) + int(k0), sp), 0)] = True
    in_bytes = H * int(need.sum()) * 3 / 8 + 8 * wp
    # K20's yardstick: K9's, the two bf16 one-hot Grams of the gathered
    # windows (each cut to s_max sites, as K20 counts them)
    al, f20, n20 = transfer.unpack_flush_buffer(dbuf, sp, H, wp)
    offs = torch.arange(s_max, device=dev)
    idx = f20[:W, None].long() + offs[None, :]
    valid = offs[None, :] < n20[:W, None]
    grams = gram_yardstick(
        al[:, torch.where(valid, idx, torch.zeros_like(idx))]
        .permute(1, 0, 2), valid)
    k20 = lambda: pair._fused_flush_pair_counts(  # noqa: E731
        dbuf, sp, H, wp, s_max, wp)
    res["flush_pair_counts"] = {
        "max_abs_err": check_equal(
            "flush_pair_counts (run A flush) vs plain", tri,
            pair._fused_flush_pair_counts_plain(dbuf, sp, H, wp, s_max, wp)),
        "ms": cuda_ms(k20, 10), "graph_ms": graph_ms(k20, 10),
        "plain_ms": cuda_ms(lambda: pair._fused_flush_pair_counts_plain(
            dbuf, sp, H, wp, s_max, wp), 2, 1),
        "library_ms": cuda_ms(grams, 10),
        "library_graph_ms": graph_ms(grams, 10),
        "k9_k4_ms": cuda_ms(lambda: pair.flush_tri_4state(
            *transfer.unpack_flush_buffer(dbuf, sp, H, wp), wp, u16, s_max),
            10),
        "bound": bound(in_bytes + tri.numel() * tri.element_size()),
        "shape": f"{W} windows (wp={wp}, s_max={s_max}), H={H}"}
    for k, r in res.items():
        log(f"[kernel] {k} at {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})"
            + (f"; K9 + K4 (with the unpack) {r['k9_k4_ms']:.4f} ms"
               if "k9_k4_ms" in r else ""))
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
                scaffold_len: int, missing: float = 0.05):
    t0 = time.perf_counter()
    # multiallelic=0.01 (a third allele on ~10 % of a site's haplotypes) is
    # a rate chosen so that K2 runs on the path, not one taken from a
    # cohort: K2's time and share of device time follow from it
    geno = work / f"{name}.geno.gz"
    inds = testing.write_geno(str(geno), n_pops=4,
                              inds_per_pop=INDS_PER_POP, n_sites=n_sites,
                              scaffold_len=scaffold_len, n_scaffolds=4,
                              missing=missing, seed=2026, multiallelic=0.01)
    pops = work / f"{name}.pops.txt"
    testing.write_pops_file(str(pops), inds)
    log(f"[e2e] data {name}: {len(inds)} individuals (H={2 * len(inds)}), "
        f"{n_sites} sites, {geno.stat().st_size} gz bytes, made in "
        f"{time.perf_counter() - t0:.1f}s")
    return geno, pops


def short(mod) -> str:
    return mod.__name__.rsplit(".", 1)[-1]


@contextlib.contextmanager
def keeping(record, kept: dict):
    """While open, each dispatch named in ``record`` (module, attribute,
    size of a call) keeps in ``kept[attribute]`` a copy of its largest
    call's arguments (a span is a view of the engine's reused buffer)."""
    originals = []
    for mod, attr, size in record:
        real = getattr(mod, attr)
        originals.append((mod, attr, real))

        def recording(*a, _real=real, _attr=attr, _size=size, **kw):
            if _attr not in kept or _size(a) > _size(kept[_attr]):
                kept[_attr] = tuple(x.copy() if isinstance(x, np.ndarray)
                                    else x for x in a)
            return _real(*a, **kw)
        setattr(mod, attr, recording)
    try:
        yield kept
    finally:
        for mod, attr, real in originals:
            setattr(mod, attr, real)


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
    with keeping(record, kept):
        reset(mods)
        wall, err = run_cli(main,
                            args + ["-o", str(work / f"{name}.gpu.csv")],
                            {"GGT_EXEC": "device"})
        launches = launches_of(mods)
        host_flushes = sum(m.HOST_FLUSHES for m in mods)
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
    from genomics_general_tpu_torch.cli import dist_mat
    from genomics_general_tpu_torch.cli import dist_paint
    from genomics_general_tpu_torch.cli import filter_genotypes
    from genomics_general_tpu_torch.cli import four_pop_windows
    from genomics_general_tpu_torch.cli import freq
    from genomics_general_tpu_torch.cli import popgen_windows
    from genomics_general_tpu_torch.cli import phyml_sliding_windows
    from genomics_general_tpu_torch.cli import raxml_sliding_windows
    from genomics_general_tpu_torch.cli import sfs
    return {"popgen": popgen_windows.main, "abba": abba_windows.main,
            "fourpop": four_pop_windows.main, "distmat": dist_mat.main,
            "distpaint": dist_paint.main, "freq": freq.main, "sfs": sfs.main,
            "filter": filter_genotypes.main,
            "phyml": phyml_sliding_windows.main,
            "raxml": raxml_sliding_windows.main}


def same_bytes(paths, what: str) -> None:
    first = Path(paths[0]).read_bytes()
    if not first:
        raise AssertionError(f"{what}: empty output")
    for other in paths[1:]:
        if Path(other).read_bytes() != first:
            raise AssertionError(f"{what}: {other} differs from {paths[0]}")


def run_e(pair, mods, clis, geno, work):
    """Run E: distMat --windType cat at H = 512 on the 500,000-site cohort
    (K9 on each 262,144-site block), byte-equal to GGT_EXEC=host, then a
    traced run.  Returns (launches, the largest K9 call, report)."""
    args = ["-g", str(geno), "-f", "phased", *DISTMAT_ARGS["run_E"],
            "--profile"]
    kept = {}
    real = pair.pair_counts_4state

    def recording(*a):
        if "k9" not in kept or a[3] > kept["k9"][3]:
            kept["k9"] = a
        return real(*a)
    pair.pair_counts_4state = recording
    try:
        reset(mods)
        wall, err = run_cli(clis["distmat"],
                            args + ["-o", str(work / "run_E.gpu.phy")],
                            {"GGT_EXEC": "device"})
        launches = launches_of(mods)
        host_flushes = pair.HOST_FLUSHES
    finally:
        pair.pair_counts_4state = real
    log(f"[e2e] run_E kernel path: wall {wall:.3f}s, "
        f"{N_SITES / wall:.0f} sites/s, launches {launches}")
    log(f"[e2e] run_E {profile_line(err)}")
    if launches["pair_counts_4state"] <= 0 or launches["pair_counts_v3"] \
            or host_flushes:
        raise AssertionError(f"run_E: K9 alone should count the cat blocks "
                             f"({launches}, host flushes {host_flushes})")
    reset(mods)
    wall_h, _ = run_cli(clis["distmat"],
                        args + ["-o", str(work / "run_E.host.phy")],
                        {"GGT_EXEC": "host"})
    if any(launches_of(mods).values()) or pair.HOST_FLUSHES == 0:
        raise AssertionError("run_E: GGT_EXEC=host did not run the host "
                             "executor alone")
    same_bytes([work / "run_E.gpu.phy", work / "run_E.host.phy"],
               "run_E kernel vs host")
    log(f"[e2e] run_E host executor: wall {wall_h:.3f}s; kernel vs host: "
        "byte-identical")
    report = {"wall_s": wall, "sites_per_s": N_SITES / wall,
              "host_wall_s": wall_h, "bytes_equal_host": True,
              "profile": profile_line(err)}
    report.update(device_busy("distmat", args, work, "run_E"))
    return launches, kept["k9"], report


def routes_run(name, main, argv_for, routes, mods, record=()):
    """One CLI once per route, the launch counts reset just before each run
    and read just after: a route (name, environment, kernels) must launch
    exactly its kernels and run the host executor exactly when it is
    GGT_EXEC=host, and every route's output files must be byte-identical
    to the first route's.  ``argv_for(route)`` gives (argv, output paths);
    ``record`` keeps the first route's largest calls (:func:`keeping`).
    Returns ({route: launches}, kept calls, {route_wall_s: ...})."""
    launches, kept, report, outputs = {}, {}, {}, {}
    for i, (route, env, need) in enumerate(routes):
        argv, outputs[route] = argv_for(route)
        with keeping(record if i == 0 else (), kept):
            reset(mods)
            wall, err = run_cli(main, argv, env)
            got = launches_of(mods)
            host = sum(m.HOST_FLUSHES for m in mods)
        ran = {k for k, v in got.items() if v}
        if ran != set(need) or (env.get("GGT_EXEC") == "host") != (host > 0):
            raise AssertionError(f"{name} {route}: launched {sorted(ran)}, "
                                 f"expected {sorted(need)}; host flushes "
                                 f"{host}")
        launches[route] = got
        report[f"{route}_wall_s"] = wall
        log(f"[e2e] {name} {route} ({env}): wall {wall:.3f}s, launches "
            f"{ {k: v for k, v in got.items() if v} } {profile_line(err)}")
    first = outputs[routes[0][0]]
    for k in range(len(first)):
        same_bytes([outputs[r][k] for r in outputs],
                   f"{name} {Path(first[k]).name} across {list(outputs)}")
    return launches, kept, report


def run_f(pair, mods, clis, geno, work):
    """Run F: windowed distMat with --windowDataOutFile at H = 512 on the
    wire-v3 route (K1, K2, K4), again under GGT_PACKED_TRANSFER=0 (K9, K4)
    and GGT_EXEC=host: both files byte-identical across the three.
    Returns (launches of the v3 run, its largest flush, report)."""
    args = ["-g", str(geno), "-f", "phased", *DISTMAT_ARGS["run_F"],
            "--profile"]

    def argv_for(route):
        out, data = work / f"run_F.{route}.phy", work / f"run_F.{route}.tsv"
        return args + ["--windowDataOutFile", str(data), "-o", str(out)], \
            [out, data]
    launches, kept, report = routes_run(
        "run_F", clis["distmat"], argv_for,
        (("v3", {"GGT_EXEC": "device"},
          ("pair_counts_v3", "exception_patch", "tri_pack")),
         ("raw", {"GGT_EXEC": "device", "GGT_PACKED_TRANSFER": "0"},
          ("pair_counts_4state", "tri_pack")),
         ("host", {"GGT_EXEC": "host"}, ())), mods,
        [(pair, "window_pair_counts_dispatch", lambda a: a[1].shape[0])])
    report["rows"] = (work / "run_F.v3.tsv").read_text().count("\n")
    log(f"[e2e] run_F: {report['rows']} windows; matrices and window data "
        "byte-identical on the v3, GGT_PACKED_TRANSFER=0 and host routes")
    return launches["v3"], kept["window_pair_counts_dispatch"], report


def run_g(pair, ws, geno, pops, dev):
    """Run G: the port's entry() step at full width (H = 512, P = 4, 128
    windows of the cohort's first 80,000 sites, each missing call filled
    with an allele of its own site so the data are complete, as the JAX
    test compares).  Its counts must equal the wire-v3 route's (K1 + K2 +
    K4); pi / dxy / Fst must meet the float64 CSV-exact path on those
    counts at the JAX test's tolerance.  Returns (launches, (inputs,
    outputs), report)."""
    import torch
    from genomics_general_tpu_torch.entry import entry
    from genomics_general_tpu_torch.io import geno as geno_io
    from genomics_general_tpu_torch.samples import SampleData
    from genomics_general_tpu_torch.stats import popgen
    names = ["pop1", "pop2", "pop3", "pop4"]
    sd = SampleData.from_pop_args(population_args=[[x] for x in names],
                                  pops_file=str(pops), geno_format="phased")
    reader = geno_io.GenoReader(str(geno), sample_data=sd,
                                geno_format="phased")
    parts, got = [], 0
    for c in reader.iter_chunks(threads=1):
        parts.append(c.alleles[:, :N_SITES_G - got].copy())
        got += parts[-1].shape[1]
        if got >= N_SITES_G:
            break
    a = np.concatenate(parts, axis=1)
    a = np.ascontiguousarray(np.where(a < 0, a.max(axis=0)[None, :], a))
    pm = reader.model.pop_mask(names)
    size = N_SITES_G // WINDOWS_G
    first = np.arange(0, WINDOWS_G * size, size, dtype=np.int32)
    n = np.full(WINDOWS_G, size, np.int32)
    fn, _ = entry()
    inputs = tuple(torch.from_numpy(x).to(dev) for x in (a, first, n, pm))
    mods = (pair, ws)
    reset(mods)
    t0 = time.perf_counter()
    out = fn(*inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(mods)
    for k in ("pair_counts_4state", "window_stats_tail", "window_pop_counts"):
        if launches[k] <= 0:
            raise AssertionError(f"run_G: kernel {k} never launched")
    reset(mods)
    vm, vs = pair.window_pair_counts(a, first, n)
    if pair.LAUNCHES["pair_counts_v3"] <= 0:
        raise AssertionError("run_G: the wire-v3 route did not run")
    check_equal("run_G mismatch vs K1 + K2 + K4", out["mismatch"],
                torch.from_numpy(vm))
    check_equal("run_G shared vs K1 + K2 + K4", out["shared"],
                torch.from_numpy(vs))
    exact = popgen.group_dist_stats(popgen.DistStatsContext(vm, vs),
                                    reader.model.row_group, do_pairs=True,
                                    min_sites=0, min_data=0.0)
    del vm, vs
    pi, dxy, fst = (out[k].cpu().numpy() for k in ("pi", "dxy", "fst"))
    rel = {"pi": 0.0, "dxy": 0.0, "fst": 0.0}

    def hold(name, g, w, rtol, atol=0.0):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"run_G {name} vs float64")
        rel[name] = max(rel[name], float(np.max(
            np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
    for x, px in enumerate(names):
        hold("pi", pi[:, x], exact["pi_" + px], G_RTOL)
        for y in range(x + 1, len(names)):
            key = px + "_" + names[y]
            hold("dxy", dxy[:, x, y], exact["dxy_" + key], G_RTOL)
            hold("fst", fst[:, x, y], exact["Fst_" + key], G_FST_RTOL,
                 G_FST_ATOL)
    log(f"[e2e] run_G entry() step: {WINDOWS_G} windows of {size} sites, "
        f"H={a.shape[0]}, P={pm.shape[0]}: wall {wall:.3f}s, launches "
        f"{ {k: v for k, v in launches.items() if v} }; counts == K1 + K2 "
        f"+ K4; max relative error vs float64 {rel} (limits pi/dxy "
        f"{G_RTOL}, Fst {G_FST_RTOL} / atol {G_FST_ATOL})")
    return launches, (inputs, out), {"wall_s": wall,
                                     "max_rel_err_vs_f64": rel}


def count_routes(route_kernel: str):
    """The three routes of a count CLI: the span wire (K6), the raw upload
    (K12) and the host counter."""
    return (("default", {"GGT_EXEC": "device"}, (route_kernel,)),
            ("raw", {"GGT_EXEC": "device", "GGT_PACKED_TRANSFER": "0"},
             ("site_pop_counts_raw",)),
            ("host", {"GGT_EXEC": "host"}, ()))


def run_h(counts, mods, clis, geno, work):
    """Run H: freq --target derived --minData 0.5 on the popDist cohort
    with its 256 individuals in 9 populations (eight of 28, one of 32):
    the 9 masks and the ingroup union, 10 overlapping rows counted on their
    classes.  Default (K6), raw (K12) and host routes byte-identical, then
    a traced run.  Returns (launches of the raw route, its largest count
    span, report)."""
    inds = [f"pop{p}_ind{j}" for p in range(1, 5)
            for j in range(1, INDS_PER_POP + 1)]
    pops9 = work / "cohort.pops9.txt"
    pops9.write_text("".join(f"{ind}\tq{min(k // 28, 8) + 1}\n"
                             for k, ind in enumerate(inds)))
    args = ["-g", str(geno), "-f", "phased",
            *[x for k in range(1, 10) for x in ("-p", f"q{k}")],
            "--popsFile", str(pops9), "--target", "derived", "--minData",
            "0.5", "--profile"]

    def argv_for(route):
        out = work / f"run_H.{route}.tsv"
        return args + ["-o", str(out)], [out]
    launches, kept, report = routes_run(
        "run_H", clis["freq"], argv_for, count_routes("site_pop_counts"),
        mods, [(counts, "site_pop_counts_dispatch",
                lambda a: a[0].shape[1])])
    report["rows"] = (work / "run_H.default.tsv").read_text().count("\n") - 1
    report["sites_per_s"] = N_SITES / report["default_wall_s"]
    log(f"[e2e] run_H: {report['rows']} rows byte-identical on the K6, K12 "
        f"and host routes; {report['sites_per_s']:.0f} sites/s")
    report.update(device_busy("freq", args, work, "run_H"))
    return launches["raw"], kept["site_pop_counts_dispatch"], report


def run_i(mods, clis, geno, pops, work):
    """Run I: sfs --inputType genotypes -p pop1 -p pop2 -p pop3 --doPairs
    (folded) on the 0.5 %-missing cohort: the six spectra byte-identical
    on the K6, K12 and host routes, and not empty."""
    args = ["-i", str(geno), "--inputType", "genotypes", "-p", "pop1",
            "-p", "pop2", "-p", "pop3", "--popsFile", str(pops), "--doPairs",
            "--profile"]
    names = ["pop1", "pop2", "pop3", "pop1_pop2", "pop1_pop3", "pop2_pop3"]

    def argv_for(route):
        pref = f"{work}/run_I.{route}."
        return args + ["--pref", pref, "--suff", ".sfs"], \
            [Path(f"{pref}{n}.sfs") for n in names]
    launches, _, report = routes_run("run_I", clis["sfs"], argv_for,
                                     count_routes("site_pop_counts"), mods)
    sites = sum(int(ln.split()[-1]) for ln in
                (work / "run_I.default.pop1.sfs").read_text().splitlines()
                if ln.strip())
    if sites <= 0:
        raise AssertionError("run_I: the pop1 spectrum is empty")
    report.update(complete_sites=sites,
                  sites_per_s=N_SITES_I / report["default_wall_s"])
    log(f"[e2e] run_I: 6 spectra byte-identical on the K6, K12 and host "
        f"routes; {sites} complete sites in the pop1 spectrum")
    return launches["raw"], None, report


def run_j(mods, clis, geno, pops, work):
    """Run J: filterGenotypes -of coded -p pop1..pop4 --minCalls 200
    --minAlleles 2 --maxAlleles 2 --minPopCalls 20 on the popDist cohort's
    first N_SITES_J sites: byte-identical on the K6, K12 and host routes."""
    import gzip
    geno_j = work / "cohort_j.geno.gz"
    with gzip.open(geno, "rt") as src, \
            gzip.open(geno_j, "wt", compresslevel=1) as dst:
        for k, line in enumerate(src):
            if k > N_SITES_J:
                break
            dst.write(line)
    args = ["-i", str(geno_j), "-if", "phased", "-of", "coded", *POPS4,
            "--popsFile", str(pops), "--minCalls", "200", "--minAlleles", "2",
            "--maxAlleles", "2", "--minPopCalls", "20"]

    def argv_for(route):
        out = work / f"run_J.{route}.geno"
        return args + ["-o", str(out)], [out]
    launches, _, report = routes_run("run_J", clis["filter"], argv_for,
                                     count_routes("site_pop_counts"), mods)
    report["rows"] = (work / "run_J.default.geno").read_text().count("\n") - 1
    report["sites_per_s"] = N_SITES_J / report["default_wall_s"]
    log(f"[e2e] run_J: {report['rows']} of {N_SITES_J} sites kept, "
        "byte-identical on the K6, K12 and host routes")
    return launches["raw"], None, report


def run_k(mods, clis, cohorts, work):
    """Run K: the popDist, A and B runs again under GGT_WIRE=2: each must
    launch its path's kernels with K13 in place of K1, and nothing else,
    and write the bytes of its wire-v3 run.  Returns (launches of the
    popDist rerun, None, report)."""
    report, first = {}, None
    for name in ("popDist", "run_A", "run_B"):
        geno, pops = cohorts[name]
        _, tail, need, _ = RUNS[name]
        out = work / f"{name}.wire2.csv"
        reset(mods)
        wall, _ = run_cli(clis["popgen"], ["-g", str(geno), "-f", "phased",
                                           *tail, "--popsFile", str(pops),
                                           "-o", str(out)],
                          {"GGT_EXEC": "device", "GGT_WIRE": "2"})
        got = launches_of(mods)
        want = {"pair_counts_v2" if k == "pair_counts_v3" else k
                for k in need}
        ran = {k for k, v in got.items() if v}
        if ran != want:
            raise AssertionError(f"run_K {name}: launched {sorted(ran)}, "
                                 f"expected {sorted(want)}")
        same_bytes([work / f"{name}.gpu.csv", out],
                   f"run_K {name} GGT_WIRE=2 vs wire v3")
        first = first or got
        report[f"{name}_wall_s"] = wall
        log(f"[e2e] run_K {name} under GGT_WIRE=2: wall {wall:.3f}s, "
            f"launches { {k: v for k, v in got.items() if v} }; "
            "byte-identical to its wire-v3 run")
    return first, None, report


def run_l(counts, transfer, mods, clis, geno, pops, work):
    """Run L: GGT_PACKED_TRANSFER=0 reruns, each byte-identical to its
    packed run: run A (K9 + K4 for the pair counts and K12 for the site
    counts, from one raw upload per flush), run C on its kernel route (the
    flush buffer: K6, K7, K8) and run C under GGT_ABBA_HOST=1 (K12)."""
    raw = {"GGT_EXEC": "device", "GGT_PACKED_TRANSFER": "0"}
    cases = (("run_A", "gpu", {}, ("pair_counts_4state", "tri_pack",
                                   "site_pop_counts_raw")),
             ("run_C", "gpu", {}, ABBA_KERNELS),
             ("run_C", "counts", {"GGT_ABBA_HOST": "1"},
              ("site_pop_counts_raw",)))
    report = {}
    uploads, tensors = [], []
    real_up, real_counts = transfer.upload_span, counts.site_pop_counts_dispatch

    def up(span, *a, **kw):
        uploads.append(span.shape)
        return real_up(span, *a, **kw)

    def count(alleles, *a, **kw):
        tensors.append(not isinstance(alleles, np.ndarray))
        return real_counts(alleles, *a, **kw)
    for name, ref, env, need in cases:
        cli, tail, _, _ = RUNS[name]
        out = work / f"{name}.{ref}.raw.csv"
        uploads.clear()
        tensors.clear()
        transfer.upload_span, counts.site_pop_counts_dispatch = up, count
        try:
            reset(mods)
            wall, _ = run_cli(clis[cli], ["-g", str(geno), "-f", "phased",
                                          *tail, "--popsFile", str(pops),
                                          "-o", str(out)], {**raw, **env})
            got = launches_of(mods)
        finally:
            transfer.upload_span = real_up
            counts.site_pop_counts_dispatch = real_counts
        ran = {k for k, v in got.items() if v}
        if ran != set(need):
            raise AssertionError(f"run_L {name} {env}: launched "
                                 f"{sorted(ran)}, expected {sorted(need)}")
        if name == "run_A" and not (uploads and all(tensors)
                                    and len(tensors) == len(uploads)):
            raise AssertionError(f"run_L run_A: {len(uploads)} raw uploads "
                                 f"for {len(tensors)} count dispatches, not "
                                 "one shared upload per flush")
        same_bytes([work / f"{name}.{ref}.csv", out],
                   f"run_L {name} {env} raw vs packed")
        key = f"{name}{'_abba_host' if env else ''}_wall_s"
        report[key] = wall
        log(f"[e2e] run_L {name} {env} under GGT_PACKED_TRANSFER=0: wall "
            f"{wall:.3f}s, launches { {k: v for k, v in got.items() if v} }"
            f"{f', {len(uploads)} shared raw uploads' if uploads else ''}; "
            "byte-identical to the packed run")
    return report


def goldens(popgen_windows, pair, work: Path):
    """The popgen goldens through the port's CLI on the card within one
    quantum, each again under GGT_WIRE=2 (K13 in place of K1) byte-equal
    to its wire-v3 run; then the fused individual-blocks route against
    GGT_HOST_DIST_FINALIZE=1."""
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
        out, out2 = work / f"{name}.csv", work / f"{name}.wire2.csv"
        run_cli(popgen_windows.main, args + ["-o", str(out)],
                {"GGT_EXEC": "device"})
        exact = csv_mismatches(G / golden, out, 0.0)
        beyond = csv_mismatches(G / golden, out, QUANTUM + 1e-12)
        pair.reset_launches()
        run_cli(popgen_windows.main, args + ["-o", str(out2)],
                {"GGT_EXEC": "device", "GGT_WIRE": "2"})
        if pair.LAUNCHES["pair_counts_v2"] <= 0 or \
                pair.LAUNCHES["pair_counts_v3"]:
            raise AssertionError(f"golden {name} under GGT_WIRE=2: "
                                 f"launches {pair.LAUNCHES}")
        same_bytes([out, out2], f"golden {name} GGT_WIRE=2 vs wire v3")
        log(f"[golden] {name}: {exact} cells differ at tol 0, "
            f"{beyond} beyond one quantum; GGT_WIRE=2 byte-identical")
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


def dist_goldens(clis, pair, work: Path):
    """The five distMat / distPaint goldens through the port's CLIs on the
    card at tol 0 (distmat_cat.phy at H = 40 through K9)."""
    D = REPO / "tests" / "data"
    G = REPO / "tests" / "golden"
    sim1 = ["-g", str(D / "sim1.geno.gz"), "-f", "phased"]
    paint = ["-g", str(D / "sim_paint.geno.gz"), "-p", "pop1", "-p", "pop2",
             "-p", "pop3", "--popsFile", str(D / "sim_paint.pops.txt")]
    wdata = work / "distmat_wind.data.tsv"
    cases = [
        ("distmat", sim1 + ["-w", "50000", "-m", "50", "--outFormat",
                            "phylip", "--windowDataOutFile", str(wdata)],
         ["distmat_wind.phy", "distmat_wind.data.tsv"], "pair_counts_v3"),
        ("distmat", sim1 + ["--windType", "cat", "--outFormat", "phylip"],
         ["distmat_cat.phy"], "pair_counts_4state"),
        ("distpaint", paint + ["-w", "50000", "-s", "25000", "-m", "50",
                               "--writeFailedWindows"],
         ["distpaint_test.tsv"], "pair_counts_v3"),
        ("distpaint", paint + ["--windType", "sites", "-w", "200", "-m",
                               "100", "--delta_threshold", "0.02",
                               "--addWindowID"],
         ["distpaint_delta.tsv"], "pair_counts_v3"),
    ]
    for cli, args, goldens_, kernel in cases:
        out = work / goldens_[0]
        pair.reset_launches()
        run_cli(clis[cli], args + ["-o", str(out)], {"GGT_EXEC": "device"})
        if pair.LAUNCHES[kernel] <= 0:
            raise AssertionError(f"golden {goldens_[0]}: {kernel} never "
                                 "launched")
        for g in goldens_:
            if (work / g).read_text() != (G / g).read_text():
                raise AssertionError(f"golden {g}: differs at tol 0")
            log(f"[golden] {g}: equal at tol 0 ({kernel} launches "
                f"{pair.LAUNCHES[kernel]})")


def count_goldens(clis, counts, work: Path):
    """The freq (2), sfs (9) and filterGenotypes (5) goldens through the
    port's CLIs on the card at tol 0.  Each run but freq's default counts
    mode (the C row formatter, as in the JAX CLI) must launch K6; that one
    again under GGT_HOST_FREQ_ROWS=0 does."""
    D = REPO / "tests" / "data"
    G = REPO / "tests" / "golden"
    sim1_pops = ["--popsFile", str(D / "sim1.pops.txt")]
    freq = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", *POPS4,
            *sim1_pops]
    sfs = ["-i", str(D / "sim1.geno.gz"), "--inputType", "genotypes",
           "--genoFormat", "phased", *sim1_pops, "-p", "pop1", "-p", "pop2"]
    cases = [
        ("freq", freq, {}, ["freq_counts.tsv"], False),
        ("freq", freq, {"GGT_HOST_FREQ_ROWS": "0"}, ["freq_counts.tsv"],
         True),
        ("freq", freq + ["--target", "derived", "--minData", "2"], {},
         ["freq_derived.tsv"], True),
    ]
    for tag, extra in (("folded", ["--doPairs"]),
                       ("pol", ["-p", "pop4", "--polarized"]),
                       ("sub", ["--subsample", "6", "--seed", "42"]),
                       ("reg", ["--regions", "scaf1:1-400000",
                                "scaf1:400001-900000", "scaf2:1-500000"])):
        names = ["pop1", "pop2"] + (["pop1_pop2"] if tag == "folded" else [])
        cases.append(("sfs", sfs + extra, {},
                      [f"sfs_{tag}_{n}.sfs" for n in names], True))
    filt = {
        "basic": ["--minCalls", "15", "--minAlleles", "2", "--maxAlleles",
                  "2"],
        "diplo": ["-of", "diplo", "--maxHet", "0.6", "--minFreq", "0.1"],
        "coded": ["-of", "coded", "-p", "pop1", "-p", "pop2", *sim1_pops,
                  "--minPopCalls", "4", "--nearlyFixedDiff", "0.5"],
        "thin": ["--thinDist", "500", "--minAlleles", "2"],
        "count": ["-of", "count", "--minAlleles", "2", "--maxAlleles", "2"],
    }
    for name, extra in filt.items():
        cases.append(("filter", ["-i", str(D / "sim1.geno.gz"), "-if",
                                 "phased", *extra], {},
                      [f"filter_{name}.geno"], True))
    n_files = 0
    for k, (cli, args, env, files, k6) in enumerate(cases):
        if cli == "sfs":        # sfs writes {pref}{pops}.sfs per spectrum
            out = ["--pref", str(work / f"g{k}.")]
            got = [work / f"g{k}.{f.split('_', 2)[2]}" for f in files]
        else:
            got = [work / f"g{k}.{files[0]}"]
            out = ["-o", str(got[0])]
        counts.reset_launches()
        run_cli(clis[cli], args + out, {"GGT_EXEC": "device", **env})
        if (counts.LAUNCHES["site_pop_counts"] > 0) != k6:
            raise AssertionError(f"golden {files[0]} {env}: K6 launches "
                                 f"{counts.LAUNCHES}")
        for g, f in zip(got, files):
            if g.read_text() != (G / f).read_text():
                raise AssertionError(f"golden {f} {env}: differs at tol 0")
            n_files += 1
        log(f"[golden] {', '.join(files)} {env}: equal at tol 0 (K6 "
            f"launches {counts.LAUNCHES['site_pop_counts']})")
    return n_files


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from genomics_general_tpu_torch import entry as port_entry
        from genomics_general_tpu_torch import testing
        from genomics_general_tpu_torch.cli import popgen_windows
        from genomics_general_tpu_torch.io import native
        from genomics_general_tpu_torch.kernels import _build
        from genomics_general_tpu_torch.kernels import abba
        from genomics_general_tpu_torch.kernels import counts
        from genomics_general_tpu_torch.kernels import ld as ldk
        from genomics_general_tpu_torch.kernels import pairdist as pair
        from genomics_general_tpu_torch.kernels import transfer
        from genomics_general_tpu_torch.kernels import window_stats as ws
        from genomics_general_tpu_torch.parallel import mesh as pmesh
        from genomics_general_tpu_torch.stats import ld as stats_ld
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
        ind_mask, het_rows = ind_layout(H)
        v2_parity(pair, a, first, n, dev, [mask, ind_mask], 40, het_rows,
                  first.shape[0])
        log(f"[parity] messy H={H}: K1-K6, K13 == plain; K1 + K2, K4, K5 == "
            f"host executor; K6 == C site counter (P=1, P=5); K13 + K2 == "
            f"K1 + K2, and K3 (bit for bit), K4, K5 on them; max abs err "
            f"{errs}")
    a, first, n = long_window_input()
    u16, nwin, _ = epilogue_parity(pair, transfer, a, first, n,
                                   np.ones((1, a.shape[0])), 0, dev)
    if u16:
        raise AssertionError("a 66,000-site window should take K4's int32 "
                             "branch")
    log(f"[parity] K4 int32 branch (one window of {n[0]} sites, "
        f"H={a.shape[0]}): tri_pack == plain == host executor")
    raw_counts_parity(counts, transfer, pair, dev)
    log("[parity] K12 messy input (H=77, S=5,003, codes -7..5, strided "
        "rows, unaligned blocks, uint16 and int32, 10 groups and a 10-row "
        "overlapping mask's classes) == plain; K12 == K6 on the same "
        "alleles")
    n_k12 = k12_edge_parity(counts, transfer, pair, dev)
    log(f"[parity] K12 block edges ({n_k12} comparisons: 1-site and "
        "unaligned blocks at an odd row stride, codes -7..5 and 127, a "
        "33-row class, run H's 10 mask rows as 9 classes, 33 rows as 1 and "
        "33 classes, 8,300 rows in one class) == plain; run H's layout == "
        "K6")
    for k, v in abba_parity(abba, counts, transfer, native, dev).items():
        errs[k] = max(errs[k], v)
    log("[parity] ABBA messy input (3 modes x 2 panels x minData 0.3/0 x "
        "disjoint/overlapping pops): K6 class counts == C counter; K7 == "
        "plain == host executor (NaN positions equal); K8 within rtol "
        f"{RTOL} of plain; max abs err K8 {errs['abba_window_sums']}")
    k7e = k7_edge_parity(abba, dev)
    log(f"[parity] K7 edges ({k7e['cases']} inputs x 3 modes x 2 panels x "
        "minData 0.3/0: S = 1, 129, 5,003; uint16 and int32; outgroup "
        "classes outside the union; staged, in place (40 classes) and off a "
        "16-byte boundary) == plain bit for bit, NaN positions equal; "
        "polarize and fixed sites with 0 / 1 / 2 selected alleles "
        f"{k7e['used']}")
    k8e = k8_edge_parity(abba, dev)
    log(f"[parity] K8 edges (K = 8 and 18, {k8e['windows']} windows: "
        f"{K8_EDGE_LEN} sites and the whole span of {K8_EDGE_S}, 2x and 3x "
        "overlap, shuffled; NaN terms; terms 16-byte aligned and 8 bytes "
        f"past; {k8e['launches']} launches) within rtol {RTOL} of plain "
        "(NaN positions equal); two launches bit-equal; "
        f"{K8_EDGE_ALONE} windows launched alone bit-equal to the batch")
    not_bit_equal = 0
    for H in (160, 77):
        a, first, n = k9_input(H)
        at, f, k, m, s = k9_parity(pair, a, first, n, dev)
        k14_parity(pair, at, f, k, m, s, int(n.max()))
        mesh_parity(pair, pmesh, shard_mesh(pmesh, dev), a, first, n, m, s)
        e, d = stats_parity(ws, at, f, k, m, s, dev, messy_masks(H))
        errs["window_stats_tail"] = max(errs["window_stats_tail"], e)
        not_bit_equal += d
        del at, f, k, m, s
    log("[parity] K9 messy input (H=160, 77; S=70,003; 60 windows incl. "
        "0, 1 and 66,000 sites; unsplit, split and strided): == plain == "
        f"host executor; K10 within rtol {K10_RTOL} of plain (NaN positions "
        f"equal, {not_bit_equal} cells not bit-equal, max abs err "
        f"{errs['window_stats_tail']}); K11 == plain (P=5, P=1); K14 on row "
        f"blocks {K14_BLOCKS} == K9's rows, == plain, split path too; the "
        f"data- and tensor-parallel pair counts on {MESH_SHARDS} shards == "
        "K9 (two-window shards on K9's split path)")
    t_edge = time.perf_counter()
    n_k9 = k9_edge_parity(pair, dev)
    log(f"[parity] K9 tile edges in {time.perf_counter() - t_edge:.1f}s "
        f"({n_k9} comparisons: H={K9_EDGE_H}, S="
        f"{K9_EDGE_S}, codes -7, 5, 127, 12 windows at odd starts, s_max "
        "not a multiple of 32, the site split on and off, contiguous, "
        "stride%16 offset 5, odd-stride and aligned rows) == plain; == host "
        f"executor on codes -1..3; K14 on rows {K14_EDGE_BLOCKS} of the "
        "same layouts and windows == plain == K9's rows")
    t_edge = time.perf_counter()
    n_k1 = k1_k13_edge_parity(pair, dev)
    log(f"[parity] K1/K13 tile edges in {time.perf_counter() - t_edge:.1f}s "
        f"({n_k1} comparisons: messy input at H={K1_EDGE_H} from w0 = 0, "
        "1, 3, the last four windows and the last alone, with an "
        "all-monomorphic, a B/D-empty, an empty and a 3-site window; class "
        "B, C and D ranges starting at every bit offset 0..31 at H = 77 and "
        "512; one 66,000-site window) == plain, every cell written; K13 + "
        "K2 == K1 + K2")
    sfs_parity(counts, dev)
    log("[parity] K15 on tie-built counts (8/8, 9/7, monomorphic, 3-allele, "
        "incomplete; uint16 and int32) == plain; K16 sum / min (int64 beyond "
        "2^31, int32; k = 1, 2, 5) == torch.sum / torch.amin")
    step = step_past_grid(pair, ws, dev)
    log(f"[parity] window_stats_step over {STEP_WINDOWS} windows (H="
        f"{STEP_H}): K9 alone refuses them; the step launches {step} and "
        "equals its chunks run one at a time")
    k17_k20_parity(ldk, counts, pair, transfer, dev)
    t_edge = time.perf_counter()
    n_k20 = k20_edge_parity(pair, transfer, dev)
    log(f"[parity] K20 edges in {time.perf_counter() - t_edge:.1f}s ({n_k20} "
        f"comparisons: H={K1_EDGE_H}, windows starting at every site offset "
        "0..31, 0- and 1-site, pad and s_max-cut (333) windows, 16-byte "
        "and byte loads (sp 65,536 and 112), the int32 branch at H = 12 and "
        "40) == plain, every cell written")
    t_edge = time.perf_counter()
    n_k10 = k10_edge_parity(pair, ws, dev)
    log(f"[parity] K10 edges in {time.perf_counter() - t_edge:.1f}s ({n_k10} "
        "comparisons: messy masks at H = 160 and 512 and one population of "
        "all rows, every row its own population at H = 12, fractional "
        "weights at H = 77, 0-site and all-missing windows, run G's shape) "
        "== plain bit for bit")
    t_edge = time.perf_counter()
    n_k11 = k11_edge_parity(ws, dev)
    log(f"[parity] K11 edges in {time.perf_counter() - t_edge:.1f}s ({n_k11} "
        f"comparisons: H = {K11_EDGE_H}, S = {K11_EDGE_S}, codes -7, 5, 127 "
        "beside -1..3; strides 70,016, S and 70,011 (3 columns in); "
        f"windows of {K11_EDGE_LEN} sites at every start mod 16, clipped at "
        "0 and S, and of 66,001 sites; P = 5 (rows in none), 1, 77 and "
        "1,100) == plain")
    n_k17 = k17_edge_parity(ldk, dev)
    n_k6 = k6_edge_parity(counts, transfer, pair, dev)
    log(f"[parity] K17 tile edges ({n_k17} comparisons: H={K17_EDGE_H}, "
        f"S={K17_EDGE_S}, codes -7, 5, 127, contiguous and strided rows) "
        f"== plain; K6 loop edges ({n_k6} comparisons: (H, S, s0, s1) in "
        f"{K6_EDGE}, 4 groups and a 10-row mask's classes, uint16 and "
        "int32, 8 and 16 lanes) == plain")
    log("[parity] K17 (H=160, 77; S=0, 1, 33, 517; codes -7..5; strided "
        "rows), K18 (1 and 5 pops, a 10-row overlapping mask; spans ending "
        "mid-block at 16 and 8 lanes, one 600-row population, an all-zero "
        "mask row, rows in no pop, 70 mask rows), K19 == "
        "plain; K20 on flushes with 0- and 1-site, pad and s_max-cut "
        "windows, unaligned metadata and the int32 branch == plain == K9 + "
        "K4")
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
        runs["run_E"] = run_e(pair, mods, clis, geno, work)
        geno_f, _ = make_cohort(testing, work, "cohort_f", N_SITES_F,
                                SCAFFOLD_F)
        runs["run_F"] = run_f(pair, mods, clis, geno_f, work)
        runs["run_G"] = run_g(pair, ws, geno, pops, dev)
        runs["run_H"] = run_h(counts, mods, clis, geno, work)
        geno_i, pops_i = make_cohort(testing, work, "cohort_i", N_SITES_I,
                                     SCAFFOLD_I, MISSING_I)
        runs["run_I"] = run_i(mods, clis, geno_i, pops_i, work)
        runs["run_J"] = run_j(mods, clis, geno, pops, work)
        runs["run_K"] = run_k(mods, clis, {"popDist": (geno, pops),
                                           "run_A": (geno, pops),
                                           "run_B": (geno_b, pops_b)}, work)
        runs["run_L"] = (None, None, run_l(counts, transfer, mods, clis,
                                           geno, pops, work))
        mesh_launches, mesh_report = mesh_runs(
            mods, clis, transfer, shard_mesh(pmesh, dev), geno, pops,
            N_SITES, work)
        for name in ("run_M", "run_N", "run_O"):
            runs[name] = (mesh_launches[name], None, mesh_report[name])
        got, rep = dry_run(mods, port_entry)
        runs["dryrun"] = (got, None, rep)
        runs["run_P"] = run_p(ldk, stats_ld, geno, pops, dev)
        runs["run_R"] = run_r(
            mods, counts, pair, transfer,
            runs["run_A"][1]["site_pop_counts_dispatch"],
            runs["run_A"][1]["window_pair_counts_dispatch"],
            runs["run_E"][1], dev)
        runs["run_Q"] = run_q(clis, geno_f, work)
        log(f"[time] phase 3 done at {time.perf_counter() - t_start:.1f}s")

        # ---- phase 2b: parity and times at the runs' flush shapes
        flush = runs["popDist"][1]["window_pair_block_stats_dispatch"]
        res, shapes = parity(pair, transfer, *flush, dev, time_it=True)
        bnd = bounds(shapes, sm_count, clk_mhz * 1e6)
        log(f"[parity] popDist flush: W={flush[1].shape[0]} windows, "
            f"chunk {shapes['nwin']}, H={shapes['H']}, P={shapes['P']}, "
            f"ep={shapes['ep']}")
        for k in ("pair_counts_v3", "exception_patch", "blocks_tail"):
            r = res[k]
            log(f"[kernel] {k} at the popDist chunk: {r['ms']:.4f} ms"
                + (f" ({r['graph_ms']:.4f} ms in a CUDA graph)"
                   if "graph_ms" in r else "")
                + f", bound {bnd[k][0]:.4f} ms ({bnd[k][1]})")
        log(f"[kernel] exception_index (once per flush) "
            f"{res['exception_patch']['index_ms']:.4f} ms")
        tails_phase(pair, transfer, flush, dev)
        res["tri_pack"] = time_tri(
            pair, transfer,
            runs["run_A"][1]["window_pair_counts_dispatch"], dev)
        res["site_pop_counts"] = time_counts(
            counts, transfer, runs["run_A"][1]["site_pop_counts_dispatch"],
            dev)
        r = res["site_pop_counts"]
        log(f"[kernel] site_pop_counts at run A's span: K6 {r['ms']:.4f} ms "
            f"({r['graph_ms']:.4f} ms in a CUDA graph), bf16 matmul "
            f"{r['library_ms']:.4f} ms ({r['library_graph_ms']:.4f} in a "
            f"CUDA graph), K12 on the same alleles {r['k12_graph_ms']:.4f} "
            "ms in a CUDA graph; K12 == K6")
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
                f"{r['ms']:.4f} ms ({r['graph_ms']:.4f} ms in a CUDA graph"
                + (f", {r['cold_graph_ms']:.4f} with the L2 cold"
                   if "cold_graph_ms" in r else "") + "), "
                f"plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {r['bound'][0]:.4f} ms "
                f"({r['bound'][1]}), max abs err {r['max_abs_err']}")
        res["pair_counts_4state"] = time_k9_block(pair, runs["run_E"][1],
                                                  dev)
        r = res["pair_counts_4state"]
        log(f"[kernel] pair_counts_4state at run E's block: K9 "
            f"{r['ms']:.4f} ms ({r['graph_ms']:.4f} ms in a CUDA graph), "
            f"two bf16 Grams {r['library_ms']:.4f} ms "
            f"({r['library_graph_ms']:.4f} in a CUDA graph)")
        runs["run_F"][2]["k9_flush"] = time_k9_flush(
            pair, transfer, runs["run_F"][1], dev, "run_F")
        runs["run_A"][2]["k9_flush"] = time_k9_flush(
            pair, transfer, runs["run_A"][1]["window_pair_counts_dispatch"],
            dev, "run_A")
        res.update(time_stats(ws, *runs["run_G"][1], dev))
        res["site_pop_counts_raw"] = time_k12(counts, transfer,
                                              runs["run_H"][1], dev)
        r = res["site_pop_counts_raw"]
        log(f"[kernel] site_pop_counts_raw at run H's span: K12 "
            f"{r['ms']:.4f} ms ({r['graph_ms']:.4f} ms in a CUDA graph), "
            f"bf16 matmul {r['library_ms']:.4f} ms "
            f"({r['library_graph_ms']:.4f} in a CUDA graph), K6 on the same "
            f"block {r['k6_ms']:.4f} ms in a CUDA graph; K12 == K6")
        res["pair_counts_v2"] = time_k13(pair, transfer, flush, dev)
        r = res["pair_counts_v2"]
        log(f"[kernel] pair_counts_v2 at the popDist chunk: K13 "
            f"{r['ms']:.4f} ms ({r['graph_ms']:.4f} ms in a CUDA graph), K1 "
            f"on the same chunk {r['k1_ms']:.4f} ms ({r['k1_graph_ms']:.4f} "
            "ms in a CUDA graph); K13 + K2 + K3 == K1 + K2 + K3")
        v2_parity(pair, *runs["run_A"][1]["window_pair_counts_dispatch"],
                  dev, [], 0)
        a_b, f_b, n_b, ind_b, het_b, gate_b = \
            runs["run_B"][1]["window_pair_ind_blocks_dispatch"]
        v2_parity(pair, a_b, f_b, n_b, dev, [ind_b], gate_b, het_b)
        log("[parity] K13 + K2 + tails == plain == K1 + K2 + tails on run "
            "A's flush (K4) and run B's individual mask (K3 bit for bit, "
            "K5)")
        res["pair_counts_4state_rows"] = time_k14(
            pair, transfer, runs["run_A"][1]["window_pair_counts_dispatch"],
            dev)
        r = res["pair_counts_4state_rows"]
        log(f"[kernel] pair_counts_4state_rows at run A's flush: K14 "
            f"{r['ms']:.4f} ms on one row shard ({r['graph_ms']:.4f} ms in "
            f"a CUDA graph), two bf16 Grams of its rows {r['library_ms']:.4f}"
            f" ms ({r['library_graph_ms']:.4f} in a CUDA graph), K9 on the "
            f"whole flush {r['k9_ms']:.4f} ms ({r['k9_graph_ms']:.4f} in a "
            "CUDA graph); each shard and rows 100..300, 127..129 == K9's "
            "rows")
        res.update(sfs_full_width(counts, pmesh, shard_mesh(pmesh, dev),
                                  geno, pops, dev))
        res["pair_allele_tables"] = time_k17(ldk, runs["run_P"][1], dev)
        res.update(time_k18_k20(counts, pair, transfer, runs["run_R"][1],
                                dev, INT32_PER_CLK_SM * sm_count
                                * clk_mhz * 1e6))
        r = res["site_nonmissing"]
        log(f"[kernel] site_nonmissing at run A's span: K18 {r['ms']:.4f} "
            f"ms ({r['graph_ms']:.4f} ms in a CUDA graph), bf16 matmul "
            f"{r['library_ms']:.4f} ms ({r['library_graph_ms']:.4f} in a "
            "CUDA graph)")
        for k in ("tri_pack", "site_pop_counts", "het_pairs",
                  "abba_site_terms", "abba_window_sums",
                  "pair_counts_4state", "window_stats_tail",
                  "window_pop_counts", "site_pop_counts_raw",
                  "pair_counts_v2", "pair_counts_4state_rows",
                  "global_sfs_hist", "stacked_reduce",
                  "pair_allele_tables", "site_nonmissing",
                  "sample_base_counts", "flush_pair_counts"):
            bnd[k] = res[k]["bound"]
            log(f"[parity] {k} at {res[k]['shape']}")
        owner = {"pair_counts_v3": "popDist", "exception_patch": "popDist",
                 "blocks_tail": "popDist", "tri_pack": "run_A",
                 "site_pop_counts": "run_A", "het_pairs": "run_B",
                 "abba_site_terms": "run_C", "abba_window_sums": "run_C",
                 "pair_counts_4state": "run_E", "window_stats_tail": "run_G",
                 "window_pop_counts": "run_G",
                 "site_pop_counts_raw": "run_H", "pair_counts_v2": "run_K",
                 "pair_counts_4state_rows": "dryrun",
                 "global_sfs_hist": "dryrun", "stacked_reduce": "dryrun",
                 "pair_allele_tables": "run_P", "site_nonmissing": "run_R",
                 "sample_base_counts": "run_R",
                 "flush_pair_counts": "run_R"}
        launches = {k: runs[owner[k]][0][k] for k in KERNELS}
        for k in KERNELS:
            r = res[k]
            r["max_abs_err"] = max(r["max_abs_err"], errs[k])
            log(f"[kernel] {k}: launches {launches[k]} ({owner[k]}), kernel "
                f"{r['ms']:.4f} ms"
                + (f" ({r['graph_ms']:.4f} ms in a CUDA graph)"
                   if "graph_ms" in r else "")
                + (f" ({r['cold_graph_ms']:.4f} ms with the L2 cold)"
                   if "cold_graph_ms" in r else "")
                + f", plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']}, bound {bnd[k][0]:.4f} ms "
                f"({bnd[k][1]}), max abs err {r['max_abs_err']}")
        log(f"[time] phase 2b done at {time.perf_counter() - t_start:.1f}s")

        # ---- phase 4: goldens on the card
        goldens(popgen_windows, pair, work)
        abba_goldens(clis, mods, work)
        dist_goldens(clis, pair, work)
        n_files = count_goldens(clis, counts, work)
        log(f"[golden] freq, sfs and filterGenotypes: {n_files} goldens "
            "equal at tol 0")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{"name": k, "route": "cuda", "source": CSRC + src,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": res[k]["max_abs_err"], "ms": res[k]["ms"],
                **{key: res[k][key] for key in ("graph_ms", "cold_graph_ms")
                   if key in res[k]},
                "plain_ms": res[k]["plain_ms"], "bound_ms": bnd[k][0],
                "bound_by": bnd[k][1], "library_ms": res[k]["library_ms"]}
               for k, (src, replaces) in KERNELS.items()]
    e2e = {name: r[2] for name, r in runs.items()}
    del runs
    log(f"[done] {time.perf_counter() - t_start:.1f}s; e2e {json.dumps(e2e)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
