"""Per-window ancestry painting (distPaint) on the GPU.

The port of genomics_general_tpu/cli/dist_paint.py, with the same flags and
output bytes, in one process or, sharded by scaffold, in several
(``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` / ``GGT_PROC_ID``,
parallel/multihost).  Mirror of distPaint.py: for every individual and
window, compute masked-Hamming distances to each reference-population member
(haploid genotypes only, distPaint.py:65), then assign the individual to the
population with the lowest mean distance, gated either by one-sided Wilcoxon
rank-sum tests against every other population (which_lowest_test,
distPaint.py:26-34) or by a mean-delta threshold (which_lowest_delta,
:36-44).  Pair distances with fewer than minSites shared sites are NaN
(:74-76).

The per-window pairwise mismatch/shared counts come from the pair counts'
``tri`` route (kernels/pairdist.window_pair_counts_dispatch: K1, K2 and K4
on the wire-v3 buffer, the same route as distMat's windows); only the tiny
selection step runs on host.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
from scipy.stats import ranksums

from .. import engine
from ..device import get_device
from ..io import geno as geno_io
from ..io import writers
from ..kernels import pairdist as pair_k
from ..samples import SampleData
from . import common


def which_lowest_test(list_of_arrays, p_threshold=0.05, noresult=-1):
    n = len(list_of_arrays)
    with np.errstate(all="ignore"):
        i = np.argmin([np.nanmean(a) for a in list_of_arrays])
    for j in range(n):
        if i != j:
            result = ranksums(list_of_arrays[i], list_of_arrays[j],
                              alternative="less")
            # NaN p-values (all-NaN pops) intentionally pass this gate,
            # matching the reference comparison (distPaint.py:32)
            if result.pvalue > p_threshold:
                return noresult
    return i


def which_lowest_delta(list_of_arrays, delta_threshold=0, noresult=-1):
    with np.errstate(all="ignore"):
        means = [np.nanmean(a) for a in list_of_arrays]
    i = np.argmin(means)
    sorted_means = sorted(means)
    if sorted_means[1] - sorted_means[0] < delta_threshold:
        return noresult
    return i


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distPaint")
    common.add_window_args(p)
    p.add_argument("--minData", type=float, action="store", default=0.01)
    p.add_argument("--p_threshold", type=float, default=0.05)
    p.add_argument("--delta_threshold", type=float, default=None)
    common.add_pop_args(p)
    p.add_argument("--samples", action="store")
    p.add_argument("--noresult", type=int, default=-1)
    p.add_argument("-g", "--genoFile", required=True)
    p.add_argument("-o", "--outFile", required=False)
    p.add_argument("--exclude", required=False)
    p.add_argument("--include", required=False)
    p.add_argument("--header", action="store")
    p.add_argument("-T", "--threads", type=int, default=1)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--addWindowID", action="store_true")
    p.add_argument("--writeFailedWindows", action="store_true")
    return p


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    get_device()                     # fail fast when the card is missing
    wind = common.resolve_window_args(args)
    min_sites = wind["minSites"]

    with geno_io.open_maybe_gz(args.genoFile, "rb") as gf:
        all_inds = [c.decode() for c in gf.readline().split()[2:]]

    pop_names = []
    ref_pop_indices: dict[str, list[int]] = {}
    for p in args.population:
        pop_names.append(p[0])
        ref_pop_indices[p[0]] = []
        if len(p) > 1:
            for ind in p[1].split(","):
                ref_pop_indices[p[0]].append(all_inds.index(ind))
    if args.popsFile:
        with open(args.popsFile, "rt") as pf:
            pop_dict = dict(ln.split() for ln in pf)
        for ind in pop_dict:
            if pop_dict[ind] in ref_pop_indices:
                ref_pop_indices[pop_dict[ind]].append(all_inds.index(ind))
    for pop in pop_names:
        assert len(ref_pop_indices[pop]) >= 1, \
            f"Reference population {pop} appears to have no individuals."

    # haploid-only analysis (distPaint.py:257-259)
    sd = SampleData(ind_names=all_inds, ploidy={s: 1 for s in all_inds})
    head = ["scaffold", "start", "end", "mid", "sites"]
    if args.addWindowID:
        head = ["windowID"] + head
    header_line = "\t".join(head) + "\t" + "\t".join(all_inds) + "\n"
    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # scaffold-sharded painting (same pattern as popgen/abba/dist_mat)
        assert not args.addWindowID, \
            "--addWindowID numbering is per-host in sharded runs"
        assert wind["windType"] != "predefined", \
            "predefined window lists are not supported in multi-host " \
            "distPaint runs (absent-scaffold rows have no owner)"
        mh_writer = multihost.MultiHostWriter()
        out = None
    else:
        mh_writer = None
        out = writers.open_out(args.outFile)
        out.write(header_line)
    reader, shard_pred = common.sharded_reader(
        args.genoFile, shard_pred, sample_data=sd, geno_format="haplo",
        header=args.header)

    n_ind = len(all_inds)

    def finalize(batch, handle):
        plan = batch.plan
        sites = plan.n_sites
        mid = plan.mid(batch.positions)
        mism, shar = handle.collect()
        for w in range(plan.n_windows):
            is_good = bool(sites[w] >= min_sites)
            if is_good:
                with np.errstate(invalid="ignore", divide="ignore"):
                    dist = mism[w] / shar[w]
                best_match = []
                for i in range(n_ind):
                    all_pop_dists = []
                    for pop in pop_names:
                        pop_dists = [dist[i, j] if shar[w][i, j] >= min_sites
                                     else np.nan
                                     for j in ref_pop_indices[pop]]
                        all_pop_dists.append(pop_dists)
                    if args.delta_threshold is not None:
                        best_match.append(which_lowest_delta(
                            all_pop_dists, args.delta_threshold, args.noresult))
                    else:
                        best_match.append(which_lowest_test(
                            all_pop_dists, args.p_threshold, args.noresult))
            else:
                best_match = [np.nan] * n_ind
            if is_good or args.writeFailedWindows:
                if wind["windType"] in ("coordinate", "predefined"):
                    start, end = int(plan.start[w]), int(plan.end[w])
                else:
                    f, l = int(plan.first[w]), int(plan.last[w])
                    start = int(batch.positions[f])
                    end = int(batch.positions[l - 1])
                row = [] if not args.addWindowID else [plan.ids[w]]
                scaf = batch.scaffold_names[int(plan.scaffold_id[w])] \
                    if plan.scaffold_id[w] >= 0 else "None"
                row += [scaf, start, end,
                        writers.fmt_int_or_nan(mid[w]), int(sites[w])]
                row += best_match
                text = "\t".join(str(x) for x in row) + "\n"
                if mh_writer is not None:
                    mh_writer.write_row(scaf, text)
                else:
                    out.write(text)

    # stream flush batches (O(flush) memory; the old path materialized the
    # genome like the reference's whole-file read, distPaint.py)
    def dispatch(batch):
        handle = pair_k.window_pair_counts_dispatch(
            batch.alleles[:, :batch.needed_end],
            batch.plan.first.astype(np.int32),
            batch.plan.n_sites.astype(np.int32))
        return batch, handle

    # finalize materializes int32 [W, H, H] matrices on host; cap
    # the flush window count by a W*H^2 byte budget (large cohorts)
    import os as _os
    _whh_cap = max(8, int(_os.environ.get('GGT_WHH_BUDGET', 1 << 28))
                   // (32 * reader.model.n_rows * reader.model.n_rows))
    engine.run_pipeline(
        engine.stream_windows(
            reader, wind,
            include=common.read_scaffold_list(args.include),
            exclude=common.read_scaffold_list(args.exclude),
            scaffold_pred=shard_pred,
            max_flush_windows=_whh_cap),
        dispatch, finalize,
        skip=lambda b: b.plan.n_windows == 0)

    if mh_writer is not None:
        out = writers.open_out(args.outFile) \
            if multihost.process_index() == 0 else None
        mh_writer.finish(out, header_line, reader.scaffold_names)
    if out is not None and out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
