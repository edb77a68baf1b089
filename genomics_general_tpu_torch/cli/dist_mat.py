"""distMat on the GPU: per-window or whole-file pairwise distance matrices.

The port of genomics_general_tpu/cli/dist_mat.py, with the same flags and
output bytes.  Mirrors distMat.py (wrapper :28-60): per window, individual
pair distances are haplotype-block nanmeans of the masked-Hamming distance
matrix (indPairDists, genomics.py:934-954), in the input individual order;
output raw / phylip / nexus (genomics.py:2288-2306).  Windowed runs take
the pair counts' ``tri`` route (kernels/pairdist.window_pair_counts_
dispatch: K1, K2, K4 on the wire-v3 buffer, or K9 and K4 under
``GGT_PACKED_TRANSFER=0``).  ``--windType cat`` streams the whole file
through the accumulating 4-state pair-count kernel K9 instead of
materializing it (fixing the reference's RAM cliff, README.md:214).

Multi-process runs (``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` /
``GGT_PROC_ID``, parallel/multihost) shard the input by scaffold: windowed
matrices and window rows gather to process 0 in one-process order; cat
mode sums the processes' pair counts with one collective.

Reference quirk kept: with --windowDataOutFile, the header is comma-separated
with a trailing comma and no newline, while data rows are tab-separated
(distMat.py:238-239, 58).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import engine
from .. import windows as W
from ..device import get_device
from ..io import geno as geno_io
from ..io import writers
from ..kernels import pairdist as pair_k
from ..samples import SampleData
from ..stats import popgen
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="distMat")
    common.add_window_args(p, choices=("sites", "coordinate", "predefined", "cat"))
    p.add_argument("-Mi", "--minPerInd", type=int, action="store", required=False)
    p.add_argument("--samples", nargs="+", action="store")
    p.add_argument("--includeSameWithSame", action="store_true")
    common.add_ploidy_args(p)
    p.add_argument("-g", "--genoFile", required=False)
    p.add_argument("-o", "--outFile", required=False)
    p.add_argument("--windowDataOutFile", required=False)
    p.add_argument("-f", "--genoFormat", action="store",
                   choices=("phased", "pairs", "haplo", "diplo"), required=True)
    p.add_argument("--outFormat", action="store",
                   choices=("raw", "phylip", "nexus"), default="phylip")
    p.add_argument("--headers", nargs="+", action="store")
    p.add_argument("--roundTo", type=int, action="store", default=4)
    p.add_argument("--exclude", required=False)
    p.add_argument("--include", required=False)
    p.add_argument("-T", "--threads", type=int, default=1, required=False,
                   help="accepted for reference CLI compatibility; the "
                        "engine runs on the device and ignores it")
    p.add_argument("--verbose", action="store_true",
                   help="periodic progress counters on stderr")
    p.add_argument("--addWindowID", action="store_true")
    p.add_argument("--writeFailedWindows", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="report per-stage wall-clock timing on stderr")
    return p


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    get_device()                     # fail fast when the card is missing
    if args.windType == "cat":
        wind = {"windType": "cat", "minSites": 1}
    else:
        wind = common.resolve_window_args(args)
    min_sites = wind["minSites"]

    n_procs = multihost.process_count()
    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # scaffold-sharded multi-process run.  Windowed modes gather matrix
        # blocks to a process-0 ordered writer; cat mode sums the
        # genome-wide pair-count accumulators across processes.
        assert args.windType != "predefined", \
            "predefined window lists are not supported in multi-host " \
            "distMat runs (absent-scaffold rows have no owner)"

    # samples (distMat.py:199-206)
    if args.samples:
        samples = args.samples
    elif args.headers:
        samples = args.headers[2:]
    else:
        assert args.genoFile, \
            "If piping from stdin, you need to specify either --samples or --headers"
        with geno_io.open_maybe_gz(args.genoFile, "rb") as gf:
            samples = [c.decode() for c in gf.readline().split()[2:]]

    if args.ploidy is not None:
        pl = args.ploidy if len(args.ploidy) != 1 else args.ploidy * len(samples)
        assert len(pl) == len(samples)
        ploidy = dict(zip(samples, pl))
    elif args.ploidyFile is not None:
        with open(args.ploidyFile, "rt") as pf:
            ploidy = {s[0]: int(s[1]) for s in (l.split() for l in pf) if s}
    else:
        d = 1 if args.genoFormat == "haplo" else 2
        ploidy = {s: d for s in samples}
        for s in (args.haploid or []):
            ploidy[s] = 1

    sd = SampleData(ind_names=list(samples), ploidy=ploidy)
    header = "\t".join(args.headers) if args.headers else None
    reader, shard_pred = common.sharded_reader(
        args.genoFile, shard_pred, sample_data=sd,
        geno_format=args.genoFormat, header=header)
    model = reader.model
    n_ind = len(samples)
    progress = engine.Progress(args.verbose)
    timer = engine.StageTimer(args.profile)

    winmeta_head = ("windowID," if args.addWindowID else "") \
        + "scaffold,start,end,mid,sites,"
    outs = {}
    mh_main = mh_meta = None
    if n_procs > 1:
        # cat mode's one matrix is written by process 0 after the merge
        if wind["windType"] != "cat":
            mh_main = multihost.MultiHostWriter()
            mh_meta = multihost.MultiHostWriter() \
                if args.windowDataOutFile else None
    else:
        outs["main"] = writers.open_out(args.outFile)
        if args.windowDataOutFile:
            outs["windows"] = writers.open_out(args.windowDataOutFile)
            outs["windows"].write(winmeta_head)

    def emit(plan, mism, shar, batch, w, mid, ind_called=None):
        """Write one window's matrix (+ optional window metadata row).
        ``ind_called``: precomputed per-haplotype called-site counts (the
        cat mode's, instead of slicing the batch's alleles)."""
        sites = plan.n_sites
        is_good = bool(sites[w] >= min_sites)
        dist_out = np.full((n_ind, n_ind), np.nan)
        if is_good:
            f, l = int(plan.first[w]), int(plan.last[w])
            if ind_called is None and args.minPerInd is not None:
                ind_called = (batch_alleles(batch)[:, f:l] >= 0).sum(axis=1)
            if args.minPerInd and int(ind_called.min()) < args.minPerInd:
                is_good = False
            else:
                ctx = popgen.DistStatsContext(mism[w:w + 1], shar[w:w + 1])
                pd = popgen.ind_pair_dists(
                    ctx, model.sample_names, model.sample_rows,
                    include_same_with_same=args.includeSameWithSame)
                for i in range(n_ind):
                    for j in range(i, n_ind):
                        v = pd[samples[i]][samples[j]][0]
                        dist_out[i, j] = dist_out[j, i] = v
        if not is_good:
            dist_out = np.full((n_ind, n_ind), np.nan)
        if not (is_good or args.writeFailedWindows):
            return 0
        if args.outFormat == "nexus":
            s_ = writers.dist_mat_nexus_string(dist_out, samples, args.roundTo)
        elif args.outFormat == "phylip":
            s_ = writers.dist_mat_phylip_string(dist_out, samples, args.roundTo)
        else:
            s_ = writers.dist_mat_string(dist_out, args.roundTo) + "\n"
        scaf = scaffold_name(batch, plan, w)
        if mh_main is not None:
            mh_main.write_row(scaf, s_)
        else:
            outs["main"].write(s_)
        if args.windowDataOutFile:
            row = [] if not args.addWindowID else [plan.ids[w]]
            row += [scaf,
                    int(plan.start[w]), int(plan.end[w]),
                    writers.fmt_int_or_nan(mid[w]), int(sites[w])]
            text = "\t".join(str(x) for x in row) + "\n"
            if mh_meta is not None:
                mh_meta.write_row(scaf, text)
            else:
                outs["windows"].write(text)
        return 1

    def batch_alleles(batch):
        return batch.alleles

    def scaffold_name(batch, plan, w):
        return batch.scaffold_names[plan.scaffold_id[w]] \
            if plan.scaffold_id[w] >= 0 else "None"

    if wind["windType"] == "cat":
        # cat: the reference reads everything into RAM (distMat.py:316-319,
        # README.md:214 RAM warning); here site blocks stream through the
        # device accumulator and only the [H, H] counts stay on host —
        # O(chunk) memory, no genome-resident matrix at all.  Positions are
        # retained (10 B/site) only when --windowDataOutFile needs the cat
        # window's midpoint.
        include_l = common.read_scaffold_list(args.include)
        exclude_l = common.read_scaffold_list(args.exclude)
        inc = set(include_l) if include_l is not None else None
        exc = set(exclude_l) if exclude_l is not None else None
        H = model.n_rows
        acc = pair_k.CatPairAccumulator(H)
        called = np.zeros(H, dtype=np.int64)
        total_sites = 0
        first_sid, first_pos, last_pos = 0, 0, 0
        keep_positions = bool(args.windowDataOutFile)
        pos_parts: list[np.ndarray] = []
        def _timed_chunks():
            with timer.stage("parse"):
                it = iter(reader.iter_chunks())
            while True:
                with timer.stage("parse"):
                    try:
                        c = next(it)
                    except StopIteration:
                        return
                yield c

        for chunk in engine._prefetched(_timed_chunks()):
            a, p, sids = chunk.alleles, chunk.positions, chunk.scaffold_ids
            if inc is not None or exc is not None or shard_pred is not None:
                names = reader.scaffold_names
                ok = np.array([(inc is None or n in inc)
                               and (exc is None or n not in exc)
                               and (shard_pred is None or shard_pred(n))
                               for n in names])
                km = ok[sids]
                if not km.all():
                    a, p, sids = a[:, km], p[km], sids[km]
            if p.size == 0:
                continue
            if total_sites == 0:
                first_sid, first_pos = int(sids[0]), int(p[0])
            last_pos = int(p[-1])
            total_sites += p.size
            called += (a >= 0).sum(axis=1)
            if keep_positions:
                pos_parts.append(p.copy())
            with timer.stage("kernel"):
                acc.add(a)
            progress.update(sites=p.size)
        with timer.stage("d2h"):
            m0, s0 = acc.finish()
        if n_procs > 1:
            # genome-wide accumulator merge: each process counts its
            # scaffolds, the [H,H] mismatch/shared matrices + per-haplotype
            # called counts + site total sum across processes with one
            # collective; process 0 writes the matrix
            assert not args.windowDataOutFile, \
                "--windowDataOutFile is not supported for multi-host cat " \
                "mode (window metadata is host-local)"
            packed = np.concatenate(
                [m0.ravel(), s0.ravel(), called, [np.int64(total_sites)]])
            merged = multihost.collective_reduce(packed, "sum")
            if multihost.process_index() != 0:
                progress.close()
                return 0
            m0 = merged[:H * H].reshape(H, H)
            s0 = merged[H * H:2 * H * H].reshape(H, H)
            called = merged[2 * H * H:2 * H * H + H]
            total_sites = int(merged[-1])
            outs["main"] = writers.open_out(args.outFile)
        plan = W.WindowPlan(np.array([first_sid], np.int32),
                            np.array([first_pos], np.int64),
                            np.array([last_pos], np.int64),
                            np.array([0], np.int64),
                            np.array([total_sites], np.int64), "cat")
        plan.ids = [1]
        mism, shar = m0[None], s0[None]
        if keep_positions and pos_parts:
            mid = plan.mid(np.concatenate(pos_parts))
        else:
            mid = np.array([np.nan])

        class _CatBatch:
            scaffold_names = reader.scaffold_names
        emit(plan, mism, shar, _CatBatch, 0, mid, ind_called=called)
    else:
        # windowed: stream flush batches (O(flush) memory, like popgen)
        def dispatch(batch):
            with timer.stage("kernel"):
                handle = pair_k.window_pair_counts_dispatch(
                    batch.alleles[:, :batch.needed_end],
                    batch.plan.first.astype(np.int32),
                    batch.plan.n_sites.astype(np.int32))
            return batch, handle

        def finalize(batch, handle):
            plan = batch.plan
            with timer.stage("d2h"):
                mism, shar = handle.collect()
            with timer.stage("write"):
                mid = plan.mid(batch.positions)
                rows = 0
                for w in range(plan.n_windows):
                    rows += emit(plan, mism, shar, batch, w, mid)
            progress.update(rows=rows)

        # finalize materializes int32 [W, H, H] matrices on host; cap
        # the flush window count by a W*H^2 byte budget (large cohorts)
        import os as _os
        _whh_cap = max(8, int(_os.environ.get('GGT_WHH_BUDGET', 1 << 28))
                       // (32 * model.n_rows * model.n_rows))
        engine.run_pipeline(
            engine.stream_windows(
                reader, wind,
                include=common.read_scaffold_list(args.include),
                exclude=common.read_scaffold_list(args.exclude),
                progress=progress, timer=timer, scaffold_pred=shard_pred,
                max_flush_windows=_whh_cap),
            dispatch, finalize,
            skip=lambda b: b.plan.n_windows == 0)
        if mh_main is not None:
            rank0 = multihost.process_index() == 0
            out0 = writers.open_out(args.outFile) if rank0 else None
            mh_main.finish(out0, "", reader.scaffold_names)
            if out0 is not None:
                outs["main"] = out0
            if mh_meta is not None:
                outm = writers.open_out(args.windowDataOutFile) \
                    if rank0 else None
                mh_meta.finish(outm, winmeta_head, reader.scaffold_names)
                if outm is not None:
                    outs["windows"] = outm

    for o in outs.values():
        if o is not sys.stdout:
            o.close()
    progress.close()
    timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
