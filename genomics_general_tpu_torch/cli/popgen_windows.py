"""popgenWindows on the GPU: sliding-window pi / dxy / Fst.

The port of genomics_general_tpu/cli/popgen_windows.py, with the same flags
and output bytes.  CLI mirrors popgenWindows.py (flags :170-210, CSV
assembly :319-354, per-window wrapper :28-75).  The pipeline replaces the
reference's process pool with the streaming engine: prefetch-threaded chunk
parse -> incremental window plan -> fused pair-count + pop-block CUDA
kernels -> float64 host finalize -> ordered CSV.  Memory is O(flush batch),
not O(genome).

This slice of the port runs ``--analysis popDist popPairDist`` (with the
``--fstMethod Hudson`` columns, host arithmetic on pi/dxy) in one process.
The other analyses and options raise ``NotImplementedError`` naming the
ROADMAP item that brings them (:func:`_check_slice`).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

from .. import engine
from ..io import geno as geno_io
from ..io import native
from ..io import writers
from ..device import get_device
from ..kernels import pairdist as pair_k
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


_SLICE_ANALYSES = ("popDist", "popPairDist")
_NOT_PORTED = {
    "indPairDist": "the tri and blocks_het epilogues",
    "indHet": "the tri and blocks_het epilogues",
    "popFreq": "kernels/counts.py",
    "hapStats": "the general 4-state pair counts",
}


def _check_slice(args, analysis) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    run yet, naming the ROADMAP queue-1 item that brings it."""
    for a in analysis:
        if a not in _SLICE_ANALYSES:
            raise NotImplementedError(
                f"--analysis {a} is not ported yet (ROADMAP queue 1: "
                f"{_NOT_PORTED[a]})")
    if args.fstMethod == "WC":
        raise NotImplementedError(
            "--fstMethod WC is not ported yet (ROADMAP queue 1: "
            "kernels/counts.py)")
    if os.environ.get("GGT_HOST_DIST_FINALIZE") == "1":
        raise NotImplementedError(
            "GGT_HOST_DIST_FINALIZE=1 is not ported yet (ROADMAP queue 1: "
            "the tri and blocks_het epilogues)")


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    get_device()                     # fail fast when the card is missing
    wind = common.resolve_window_args(args)
    analysis = args.analysis
    _check_slice(args, analysis)

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
        if not sd.pop_names:
            sd.pop_names = ["all"]
            sd.pop_inds = {"all": all_inds}
    pop_names = sd.pop_names
    min_sites = wind["minSites"]

    # ---- stats column list (popgenWindows.py:326-354)
    stats: list[str] = []
    if "popDist" in analysis:
        stats += ["pi_" + n for n in pop_names]
    if "popPairDist" in analysis:
        stats += ["dxy_" + x + "_" + y for x, y in itertools.combinations(pop_names, 2)]
        stats += ["Fst_" + x + "_" + y for x, y in itertools.combinations(pop_names, 2)]
        if args.fstMethod == "Hudson":
            stats += ["FstHud_" + x + "_" + y
                      for x, y in itertools.combinations(pop_names, 2)]
    need_hud = args.fstMethod == "Hudson" and "popPairDist" in analysis

    # ---- runtime setup
    timer = engine.StageTimer(args.profile)
    progress = engine.Progress(args.verbose)

    head = "windowID,scaffold,start,end,mid,sites," if args.addWindowID \
        else "scaffold,start,end,mid,sites,"
    header_line = head + ",".join(stats) + "\n"
    out, skip_windows, cursor = common.open_resumable_out(args, header_line)
    reader = geno_io.GenoReader(
        args.genoFile if args.genoFile else sys.stdin,
        sample_data=sd, geno_format=args.genoFormat, header=args.header)
    model = reader.model

    # non-resume runs emit rows via the C formatter over the binary buffer
    # (one write channel; the text wrapper only carried the header, flushed
    # before any raw write)
    use_c_csv = (cursor is None and not args.addWindowID
                 and os.environ.get("GGT_HOST_CSV") != "0")
    c_out = getattr(out, "buffer", None) if use_c_csv else None
    if c_out is not None:
        out.flush()

    # popDist/popPairDist use the fully-fused device path: pair counts AND
    # the per-pop-block float64 reductions stay on the device, so only
    # [W, 2, P, P] floats come back (kernels/pairdist.
    # window_pair_block_stats_dispatch).  Every haplotype row is in exactly
    # one group, the ungrouped rows in the "" group.
    dist_groups_arr = np.array(
        ["" if g is None else g for g in model.row_group])
    dist_pops = [str(p) for p in np.unique(dist_groups_arr)]
    dist_sizes = [int((dist_groups_arr == g).sum()) for g in dist_pops]
    dist_mask = np.zeros((len(dist_pops), model.n_rows), dtype=np.float64)
    for gi, g in enumerate(dist_pops):
        dist_mask[gi, dist_groups_arr == g] = 1.0

    rt = args.roundTo

    def dispatch(batch):
        """Pack the flush span into one wire buffer and launch all device
        work asynchronously; results are fetched in finalize() — one batch
        later, so batch k's host finalize overlaps batch k+1's wire+compute."""
        plan = batch.plan
        span = batch.alleles[:, :batch.needed_end]
        with timer.stage("kernel"):
            handle = pair_k.window_pair_block_stats_dispatch(
                span, plan.first.astype(np.int32),
                plan.n_sites.astype(np.int32), dist_mask, min_sites)
        return batch, handle

    def finalize(batch, handle):
        plan = batch.plan
        n_w = plan.n_windows
        sites = plan.n_sites
        good = sites >= min_sites
        mid = plan.mid(batch.positions)
        values: dict[str, np.ndarray] = {}

        with timer.stage("d2h"):
            bsums, bcnts = handle.collect()
        with timer.stage("finalize"):
            values.update(popgen.group_dist_stats_from_blocks(
                bsums, bcnts, dist_pops, dist_sizes,
                do_pairs="popPairDist" in analysis,
                min_data=args.minData))

        if need_hud:
            values.update(popgen.hudson_fst_from_stats(values, pop_names))

        with timer.stage("write"):
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
                kind = np.zeros(len(stats), dtype=np.uint8)   # all floats
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
                    else:
                        row.append(writers.fmt_float(values[s][w], rt))
                text = ",".join(row) + "\n"
                if c_out is not None:
                    c_out.write(text.encode())   # same channel as the C path
                else:
                    out.write(text)
                rows_written += 1
            progress.update(rows=rows_written)
            if cursor is not None:
                out.flush()
                cursor.save(batch.window_offset + plan.n_windows, out.tell())

    engine.run_pipeline(
        engine.stream_windows(
            reader, wind,
            include=common.read_scaffold_list(args.include),
            exclude=common.read_scaffold_list(args.exclude),
            progress=progress, timer=timer),
        dispatch, finalize,
        # resume: skip batches already fully written
        skip=lambda b: (b.plan.n_windows == 0
                        or b.window_offset + b.plan.n_windows <= skip_windows))

    if cursor is not None:
        cursor.clear()
    if args.outFile:
        out.close()
    progress.close()
    timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
