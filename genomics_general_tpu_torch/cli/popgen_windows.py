"""popgenWindows on the GPU: sliding-window pi / dxy / Fst (+ Tajima panel,
per-individual het & distances, H1/H12/H2).

The port of genomics_general_tpu/cli/popgen_windows.py, with the same flags
and output bytes.  CLI mirrors popgenWindows.py (flags :170-210, CSV
assembly :319-354, per-window wrapper :28-75).  The pipeline replaces the
reference's process pool with the streaming engine: prefetch-threaded chunk
parse -> incremental window plan -> pair-count and allele-count CUDA
kernels -> float64 host finalize -> ordered CSV.  Memory is O(flush batch),
not O(genome).

Every ``--analysis`` and ``--fstMethod`` runs, in one process, with the
JAX package's wire options (``GGT_WIRE=2``, ``GGT_PACKED_TRANSFER=0``), on
one device or, with more than one local card, data-parallel over the
device mesh (cli.common.get_mesh; ``GGT_NO_MESH=1`` keeps one device).
Multi-process runs (``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` /
``GGT_PROC_ID``, parallel/multihost) shard the input by scaffold, each
process on its own scaffolds and card(s), and process 0 writes the rows in
one-process order.

Extension beyond the reference: ``--fstMethod WC`` adds Weir-Cockerham Fst
columns (the reference only has 1 - pi_s/pi_t, genomics.py:987-993).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np

from .. import engine
from ..io import geno as geno_io
from ..io import native
from ..io import writers
from ..device import get_device
from ..kernels import counts as counts_k
from ..kernels import pairdist as pair_k
from ..kernels import transfer
from ..stats import popgen
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="popgenWindows")
    common.add_window_args(p)
    p.add_argument("--minData", type=float, action="store", default=0.01)
    common.add_pop_args(p)
    p.add_argument("--samples", action="store", metavar="sample names")
    common.add_ploidy_args(p)
    p.add_argument("--analysis", action="store", nargs="+",
                   choices=("popFreq", "popDist", "popPairDist", "indPairDist",
                            "indHet", "hapStats"),
                   default=("popDist", "popPairDist"))
    p.add_argument("--fstMethod", action="store",
                   choices=("ref", "WC", "Hudson"), default="ref",
                   help="Fst estimator: 'ref' = 1 - pi_s/pi_t like the "
                        "reference; 'WC' adds Weir-Cockerham (1984) columns; "
                        "'Hudson' adds Hudson/Bhatia 1 - Hw/Hb columns "
                        "(engine extensions).")
    p.add_argument("--hapDist", type=float, default=0)
    p.add_argument("--roundTo", type=int, default=4)
    common.add_io_args(p)
    p.add_argument("--addWindowID", action="store_true")
    p.add_argument("--writeFailedWindows", action="store_true")
    common.add_runtime_args(p)
    return p


def main(argv=None) -> int:
    t_entry = time.perf_counter_ns()        # cli.setup's start (--profile)
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    get_device()                     # fail fast when the card is missing
    wind = common.resolve_window_args(args)
    analysis = args.analysis

    extra = args.samples.split(",") if args.samples else []
    sd = common.sample_data_from_args(args, extra_inds=extra)
    if not sd.ind_names:
        # no pops/samples given: take all from the file header
        with geno_io.open_maybe_gz(args.genoFile, "rb") as gf:
            header = gf.readline()
        all_inds = [c.decode() for c in header.split()[2:]]
        sd.ind_names = all_inds
        for ind in all_inds:
            sd.ploidy.setdefault(ind, 1 if args.genoFormat == "haplo" else 2)
        if any(a in analysis for a in ("popFreq", "popDist", "popPairDist", "hapStats")) \
                and not sd.pop_names:
            sd.pop_names = ["all"]
            sd.pop_inds = {"all": all_inds}
    pop_names = sd.pop_names
    all_inds = sd.ind_names
    min_sites = wind["minSites"]

    # ---- stats column list (popgenWindows.py:326-354)
    stats: list[str] = []
    if "popFreq" in analysis:
        for prefix in ("l_", "S_", "thetaPi_", "thetaW_", "TajD_"):
            stats += [prefix + n for n in pop_names]
    if "popDist" in analysis:
        stats += ["pi_" + n for n in pop_names]
    if "popPairDist" in analysis:
        stats += ["dxy_" + x + "_" + y for x, y in itertools.combinations(pop_names, 2)]
        stats += ["Fst_" + x + "_" + y for x, y in itertools.combinations(pop_names, 2)]
        if args.fstMethod == "WC":
            stats += ["FstWC_" + x + "_" + y
                      for x, y in itertools.combinations(pop_names, 2)]
        if args.fstMethod == "Hudson":
            stats += ["FstHud_" + x + "_" + y
                      for x, y in itertools.combinations(pop_names, 2)]
    if "indPairDist" in analysis:
        stats += ["_".join(["d", i, j])
                  for i, j in itertools.combinations_with_replacement(sorted(all_inds), 2)]
    if "indHet" in analysis:
        stats += ["het_" + n for n in all_inds]
    if "hapStats" in analysis:
        for prefix in ("H1_", "H12_", "H2_"):
            stats += [prefix + n for n in pop_names]
    int_stats = {s for s in stats if s.startswith(("l_",))}

    need_dist = any(a in analysis for a in
                    ("popDist", "popPairDist", "indPairDist", "indHet", "hapStats"))
    need_freq = "popFreq" in analysis
    need_wc = need_dist and args.fstMethod == "WC" and "popPairDist" in analysis
    need_hud = args.fstMethod == "Hudson" and "popPairDist" in analysis

    # ---- runtime setup
    mesh = common.get_mesh()
    timer = engine.StageTimer(args.profile, start_ns=t_entry)
    progress = engine.Progress(args.verbose)

    head = "windowID,scaffold,start,end,mid,sites," if args.addWindowID \
        else "scaffold,start,end,mid,sites,"
    header_line = head + ",".join(stats) + "\n"

    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # per-process scaffold sharding; rows gathered to an ordered
        # process-0 writer at the end (parallel/multihost.py)
        assert not args.resume, "--resume is not supported in multi-host runs"
        assert not (args.addWindowID and wind["windType"] != "predefined"), \
            "--addWindowID numbering is per-host in sharded runs; use " \
            "predefined windows (IDs from the file) instead"
        wc_order_keys = common.own_window_coords(wind, shard_pred)
        mh_writer = multihost.MultiHostWriter()
        out, skip_windows, cursor = None, 0, None
    else:
        mh_writer = None
        out, skip_windows, cursor = common.open_resumable_out(
            args, header_line)
    reader, shard_pred = common.sharded_reader(
        args.genoFile, shard_pred, sample_data=sd,
        geno_format=args.genoFormat, header=args.header)
    model = reader.model

    # one-process non-resume runs emit rows via the C formatter over the
    # binary buffer (one write channel; the text wrapper only carried the
    # header, flushed before any raw write)
    use_c_csv = (mh_writer is None and cursor is None
                 and not args.addWindowID
                 and os.environ.get("GGT_HOST_CSV") != "0")
    c_out = getattr(out, "buffer", None) if use_c_csv else None
    if c_out is not None:
        out.flush()

    # popDist/popPairDist/indPairDist/indHet runs use the fused device
    # paths: pair counts AND the per-block float64 reductions stay on the
    # device, so only [W, 2, P, P] floats (plus each individual's own-pair
    # counts) come back (kernels/pairdist.window_pair_block_stats_dispatch,
    # window_pair_ind_blocks_dispatch; on a device mesh each card runs them
    # on its slab of the windows).  hapStats, popFreq and WC use the
    # general path: the packed [W, H, H] counts (window_pair_counts_dispatch)
    # and the per-site counts kernel.
    fast_dist = ("popDist", "popPairDist", "indPairDist", "indHet")
    use_blocks = (need_dist
                  and not (need_freq or need_wc)
                  and all(a in fast_dist for a in analysis)
                  and os.environ.get("GGT_HOST_DIST_FINALIZE") != "1")
    # per-individual block granularity ONLY when indPairDist needs the full
    # [I, I] matrices; indHet alone rides the pop-blocks kernel (each
    # individual's raw own-pair counts are fetched either way)
    need_ind_blocks = use_blocks and "indPairDist" in analysis
    need_het = use_blocks and "indHet" in analysis
    blocks_ind = need_ind_blocks
    if use_blocks:
        dist_groups_arr = np.array(
            ["" if g is None else g for g in model.row_group])
        dist_pops = [str(p) for p in np.unique(dist_groups_arr)]
        dist_sizes = [int((dist_groups_arr == g).sum()) for g in dist_pops]
        # min_sites mutates the shared distance context only when the
        # wrapper's popDist/popPairDist step runs first (popgenWindows.py:
        # 51-64); individual-stat-only runs see the unmutated matrix
        ms_gate = min_sites if ("popDist" in analysis
                                or "popPairDist" in analysis) else 0
        if need_ind_blocks or need_het:
            ind_names_sorted = model.sample_names
            n_i = len(ind_names_sorted)
            het_rows = np.zeros((2, n_i), dtype=np.int32)
            diploid = np.zeros(n_i, dtype=bool)
            for k, rows in enumerate(model.sample_rows):
                if rows.size == 2:
                    diploid[k] = True
                    het_rows[0, k], het_rows[1, k] = int(rows[0]), int(rows[1])
        if blocks_ind:
            ind_mask = np.zeros((n_i, model.n_rows), dtype=np.float64)
            # every row belongs to exactly one individual (HaplotypeModel
            # builds the rows from the individuals, --samples and
            # --haploid included), as the per-block kernel requires
            for k, rows in enumerate(model.sample_rows):
                ind_mask[k, rows] = 1.0
            # individual -> pop aggregation one-hot [P, I]
            ind_group = np.array(
                ["" if model.row_group[int(r[0])] is None
                 else model.row_group[int(r[0])]
                 for r in model.sample_rows])
            pop_agg = np.zeros((len(dist_pops), n_i), dtype=np.float64)
            for gi, g in enumerate(dist_pops):
                pop_agg[gi, ind_group == g] = 1.0
        else:
            dist_mask = np.zeros((len(dist_pops), model.n_rows),
                                 dtype=np.float64)
            for gi, g in enumerate(dist_pops):
                dist_mask[gi, dist_groups_arr == g] = 1.0

    # popFreq: one combined mask over the row groups (incl. ungrouped rows)
    if need_freq or need_wc:
        groups_arr = np.array(["" if g is None else g for g in model.row_group])
        freq_groups = list(np.unique(groups_arr))
        fmask = np.zeros((len(freq_groups), model.n_rows), dtype=np.float32)
        fsizes = {}
        for gi, g in enumerate(freq_groups):
            rows = np.flatnonzero(groups_arr == g)
            fmask[gi, rows] = 1.0
            fsizes[g] = rows.size

    rt = args.roundTo

    # under GGT_PACKED_TRANSFER=0 a run with both pair counts (the tri
    # route) and site counts uploads the raw span once and hands that
    # device array to both dispatches, as the JAX CLI does
    share_upload = (need_dist and not use_blocks and (need_freq or need_wc)
                    and not transfer.packed_enabled()
                    and pair_k._exec_choice() != "host")
    # the stages of the pair counts (engine.StageTimer), decided here
    # alone.  On a mesh each card gets its input in ``replicate`` before
    # ``kernel``: its slabs (pairdist.upload_slabs), or the shared upload;
    # the wait for every card is ``gather`` (counting ``mesh_slabs`` and
    # ``gather_bytes``), and ``mirror`` and ``dist_stats`` are the host's.
    # On one card the upload is part of ``kernel`` (``h2d`` when shared)
    # and the wait is ``d2h``; the blocks route keeps its split in
    # ``d2h`` and its host stats in ``finalize``.
    one_card_blocks = mesh is None and use_blocks
    stats_stage = "finalize" if one_card_blocks else "dist_stats"

    def dispatch(batch):
        """Pack the flush span and launch all device work asynchronously;
        results are fetched in finalize() — one batch later, so batch k's
        host finalize overlaps batch k+1's wire+compute.  On the packed
        routes each dispatch ships its own wire (wire v3 or v2 for the pair
        counts, the 2-bit span wire for the site counts); under
        ``GGT_PACKED_TRANSFER=0`` one raw upload serves both (K9 and
        K12)."""
        plan = batch.plan
        span = batch.alleles[:, :batch.needed_end]
        first = plan.first.astype(np.int32)
        n_sites = plan.n_sites.astype(np.int32)
        handles = {}
        src = span
        if share_upload and span.shape[1]:
            with timer.stage("h2d" if mesh is None else "replicate",
                             flush=batch.flush):
                src = transfer.upload_span(span, mesh=mesh)
        elif mesh is not None and need_dist:
            with timer.stage("replicate", flush=batch.flush):
                src = pair_k.upload_slabs(span, first, n_sites, mesh,
                                          not use_blocks, timer=timer)
        with timer.stage("kernel", flush=batch.flush):
            if use_blocks and blocks_ind:
                handles["indblocks"] = pair_k.window_pair_ind_blocks_dispatch(
                    src, first, n_sites, ind_mask, het_rows, ms_gate,
                    timer=timer, mesh=mesh)
            elif use_blocks and need_het:
                # pop-level blocks + per-individual own-pair raw counts in
                # one fetch; no [W, I, I] matrices come back
                handles["pophet"] = pair_k.window_pair_ind_blocks_dispatch(
                    src, first, n_sites, dist_mask, het_rows, ms_gate,
                    timer=timer, mesh=mesh)
            elif use_blocks:
                handles["pairblocks"] = pair_k.window_pair_block_stats_dispatch(
                    src, first, n_sites, dist_mask, min_sites, timer=timer,
                    mesh=mesh)
            elif need_dist:
                handles["pair"] = pair_k.window_pair_counts_dispatch(
                    src, first, n_sites, mesh=mesh)
            if (need_freq or need_wc) and span.shape[1]:
                handles["counts"] = counts_k.site_pop_counts_dispatch(
                    src[:, :span.shape[1]] if share_upload else span,
                    fmask, mesh=mesh)
        return batch, handles

    def finalize(batch, handles):
        plan = batch.plan
        n_w = plan.n_windows
        sites = plan.n_sites
        good = sites >= min_sites
        mid = plan.mid(batch.positions)
        values: dict[str, np.ndarray] = {}

        def fetch(name):
            """A pair handle's results, in the stages said above."""
            handle = handles[name]
            if one_card_blocks:
                with timer.stage("d2h", flush=batch.flush):
                    return handle.collect()
            with timer.stage("d2h" if mesh is None else "gather",
                             flush=batch.flush):
                host = handle.wait()
            if mesh is not None:
                timer.count("mesh_slabs", handle.n_parts)
                timer.count("gather_bytes", host.nbytes)
            with timer.stage("mirror", flush=batch.flush):
                return handle.split(host)

        if use_blocks and blocks_ind:
            isums, icnts, het_m, het_s = fetch("indblocks")
            with timer.stage(stats_stage, flush=batch.flush):
                if "popDist" in analysis or "popPairDist" in analysis:
                    psums = np.einsum("pi,wij,qj->wpq", pop_agg, isums,
                                      pop_agg)
                    pcnts = np.einsum("pi,wij,qj->wpq", pop_agg, icnts,
                                      pop_agg)
                    values.update(popgen.group_dist_stats_from_blocks(
                        psums, pcnts, dist_pops, dist_sizes,
                        do_pairs="popPairDist" in analysis,
                        min_data=args.minData))
                if "indPairDist" in analysis:
                    pd = popgen.ind_pair_dists_from_blocks(
                        isums, icnts, ind_names_sorted)
                    for i, j in itertools.combinations_with_replacement(
                            sorted(pd.keys()), 2):
                        values["_".join(["d", i, j])] = pd[i][j]
                if "indHet" in analysis:
                    het = popgen.sample_het_from_pairs(
                        het_m, het_s, ind_names_sorted, diploid, ms_gate)
                    for key, v in het.items():
                        values["het_" + key] = v
        elif use_blocks and need_het:
            psums, pcnts, het_m, het_s = fetch("pophet")
            with timer.stage(stats_stage, flush=batch.flush):
                if "popDist" in analysis or "popPairDist" in analysis:
                    values.update(popgen.group_dist_stats_from_blocks(
                        psums, pcnts, dist_pops, dist_sizes,
                        do_pairs="popPairDist" in analysis,
                        min_data=args.minData))
                het = popgen.sample_het_from_pairs(
                    het_m, het_s, ind_names_sorted, diploid, ms_gate)
                for key, v in het.items():
                    values["het_" + key] = v
        elif use_blocks:
            bsums, bcnts = fetch("pairblocks")
            with timer.stage(stats_stage, flush=batch.flush):
                values.update(popgen.group_dist_stats_from_blocks(
                    bsums, bcnts, dist_pops, dist_sizes,
                    do_pairs="popPairDist" in analysis,
                    min_data=args.minData))
        elif need_dist:
            mism, shar = fetch("pair")
            with timer.stage(stats_stage, flush=batch.flush):
                ctx = popgen.DistStatsContext(mism, shar)
                # analysis order matters: the reference mutates the cached
                # matrix (popgenWindows.py:51-64)
                if "popDist" in analysis or "popPairDist" in analysis:
                    values.update(popgen.group_dist_stats(
                        ctx, model.row_group, do_pairs="popPairDist" in analysis,
                        min_sites=min_sites, min_data=args.minData))
                if "indPairDist" in analysis:
                    pd = popgen.ind_pair_dists(ctx, model.sample_names,
                                               model.sample_rows)
                    for i, j in itertools.combinations_with_replacement(
                            sorted(pd.keys()), 2):
                        values["_".join(["d", i, j])] = pd[i][j]
                if "indHet" in analysis:
                    het = popgen.sample_het(ctx, model.sample_names,
                                            model.sample_rows)
                    for key, v in het.items():
                        values["het_" + key] = v
                if "hapStats" in analysis:
                    values.update(popgen.h12_stats(ctx, model.row_group,
                                                   args.hapDist))

        if need_hud:
            values.update(popgen.hudson_fst_from_stats(values, pop_names))

        if need_freq or need_wc:
            needed = batch.needed_end
            with timer.stage("d2h", flush=batch.flush):
                counts = handles["counts"].collect() if "counts" in handles \
                    else np.zeros((0, len(freq_groups), 4), np.int32)  # [S, G, 4]
            with timer.stage("finalize", flush=batch.flush):
                if need_freq:
                    complete = (batch.alleles[:, :needed] >= 0).all(axis=0)
                    group_counts = {g: counts[:, gi, :]
                                    for gi, g in enumerate(freq_groups)}
                    values.update(popgen.group_freq_stats(
                        group_counts, fsizes, complete,
                        zip(plan.first, plan.last)))
                if need_wc:
                    gidx = {g: i for i, g in enumerate(freq_groups)}
                    for x, y in itertools.combinations(pop_names, 2):
                        values["FstWC_" + x + "_" + y] = popgen.wc_fst_windows(
                            counts[:, gidx[x], :], counts[:, gidx[y], :],
                            zip(plan.first, plan.last))

        with timer.stage("write", flush=batch.flush):
            if c_out is not None and n_w:
                # whole-batch C row emitter (io/native.format_window_csv):
                # replaces ~n_w * n_stats round()+str() Python calls with one
                # C pass producing the identical bytes
                emit = np.ones(n_w, dtype=bool) if args.writeFailedWindows \
                    else good.astype(bool)
                names_b = [n.encode() for n in batch.scaffold_names] + [b"None"]
                scaf_idx = np.where(plan.scaffold_id >= 0, plan.scaffold_id,
                                    len(names_b) - 1).astype(np.int32)
                cols = [np.asarray(values[s], dtype=np.float64) if s in values
                        else np.full(n_w, np.nan) for s in stats]
                vals_mat = np.column_stack(cols) if stats \
                    else np.zeros((n_w, 0), dtype=np.float64)
                kind = np.array([1 if (s in int_stats or s.startswith("S_"))
                                 else 0 for s in stats], dtype=np.uint8)
                if native.format_window_csv(
                        names_b, scaf_idx, plan.start, plan.end,
                        np.asarray(mid, dtype=np.float64), sites, vals_mat,
                        kind, rt, emit, good.astype(bool), c_out.write):
                    progress.update(rows=int(emit.sum()))
                    return
            rows_written = 0
            for w in range(n_w):
                if batch.window_offset + w < skip_windows:
                    continue
                is_good = bool(good[w])
                if not (is_good or args.writeFailedWindows):
                    continue
                row = []
                if args.addWindowID:
                    row.append(str(plan.ids[w]))
                scaf_name = batch.scaffold_names[plan.scaffold_id[w]] \
                    if plan.scaffold_id[w] >= 0 else "None"
                row.append(scaf_name)
                row.append(str(int(plan.start[w])))
                row.append(str(int(plan.end[w])))
                row.append(writers.fmt_int_or_nan(mid[w]))
                row.append(str(int(sites[w])))
                for s in stats:
                    if not is_good:
                        row.append("nan")
                    elif s in int_stats:
                        row.append(writers.fmt_int_or_nan(values[s][w]))
                    elif s.startswith("S_"):
                        v = values[s][w]
                        row.append(writers.fmt_int_or_nan(v) if v == v else "nan")
                    else:
                        row.append(writers.fmt_float(values[s][w], rt))
                text = ",".join(row) + "\n"
                if mh_writer is not None:
                    key = wc_order_keys[batch.window_offset + w] \
                        if wc_order_keys is not None else None
                    mh_writer.write_row(scaf_name, text, order_key=key)
                elif c_out is not None:
                    c_out.write(text.encode())   # same channel as the C path
                else:
                    out.write(text)
                rows_written += 1
            progress.update(rows=rows_written)
            if cursor is not None:
                out.flush()
                cursor.save(batch.window_offset + plan.n_windows, out.tell())

    # the general distance path (hapStats, GGT_HOST_DIST_FINALIZE=1, or
    # sharing a run with popFreq/WC) materializes TWO int32 [W, H, H]
    # matrices per flush on the host; cap the flush window count by a
    # W*H^2 byte budget so large cohorts stay bounded (the fused blocks
    # paths never materialize them)
    whh_cap = None
    if need_dist and not use_blocks:
        budget = int(os.environ.get("GGT_WHH_BUDGET", 1 << 28))
        whh_cap = max(8, budget // (32 * model.n_rows * model.n_rows))

    engine.run_pipeline(
        engine.stream_windows(
            reader, wind,
            include=common.read_scaffold_list(args.include),
            exclude=common.read_scaffold_list(args.exclude),
            progress=progress, timer=timer, scaffold_pred=shard_pred,
            max_flush_windows=whh_cap),
        dispatch, finalize,
        # resume: skip batches already fully written
        skip=lambda b: (b.plan.n_windows == 0
                        or b.window_offset + b.plan.n_windows <= skip_windows),
        timer=timer)

    with timer.span("cli.close"):
        if mh_writer is not None:
            out = writers.open_out(args.outFile) \
                if multihost.process_index() == 0 else None
            mh_writer.finish(out, header_line, reader.scaffold_names)
        elif cursor is not None:
            cursor.clear()
        if args.outFile and out is not None:
            out.close()
        progress.close()
    timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
