"""ABBABABAwindows / fourPopWindows on the GPU: windowed four-taxon
statistics.

The port of genomics_general_tpu/cli/abba_windows.py, with the same flags
and output bytes.  Mirrors ABBABABAwindows.py (wrapper :27-52, header
:244-245) and fourPopWindows.py (wrapper :28-54, stats list :252).  Each
flush goes through the fused window reduction of kernels/abba.py (per-site
counts, site terms and window sums on the device; [W, K] float64 sums
back); the float64 ratio-of-sums finalize matches the reference.
``GGT_ABBA_HOST=1`` fetches the per-site counts instead and finalizes
every window on the host (stats/abbababa.py), byte-identical to the
reference.

One process drives one device: multi-process runs (``GGT_NUM_PROCS>1``)
raise in parallel/multihost, and the unported raw upload
(``GGT_PACKED_TRANSFER=0``) raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import engine
from ..device import get_device
from ..io import geno as geno_io
from ..io import writers
from ..kernels import abba as abba_k
from ..kernels import counts as counts_k
from ..samples import HaplotypeModel, SampleData
from ..stats import abbababa
from . import common


def build_parser(full_panel: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fourPopWindows" if full_panel else "ABBABABAwindows")
    common.add_window_args(p, overlap_short=False)
    p.add_argument("--minData", type=float, action="store", required=False,
                   default=0.01, metavar="proportion")
    p.add_argument("-P1", "--pop1", required=True, action="store", nargs="+")
    p.add_argument("-P2", "--pop2", required=True, action="store", nargs="+")
    p.add_argument("-P3", "--pop3", required=True, action="store", nargs="+")
    p.add_argument("-O", "--outgroup", required=True, action="store", nargs="+")
    p.add_argument("--popsFile", action="store", required=False)
    common.add_ploidy_args(p)
    if full_panel:
        p.add_argument("--polarize", action="store_true")
        p.add_argument("--fixed", action="store_true")
    p.add_argument("-g", "--genoFile", required=False)
    p.add_argument("-o", "--outFile", required=False)
    p.add_argument("--exclude", required=False)
    p.add_argument("--include", required=False)
    p.add_argument("-f", "--genoFormat", action="store",
                   choices=("phased", "pairs", "haplo", "diplo"), required=True)
    p.add_argument("--header", action="store")
    p.add_argument("-T", "--Threads", type=int, default=1, required=False)
    p.add_argument("--jackknife", type=int, default=None, metavar="blockSize",
                   help="genome-wide D/fd/fdM +- SE by delete-one-block "
                        "jackknife over blockSize-bp blocks of good windows "
                        "(jackknife.R semantics; blocks never span "
                        "scaffolds); written to --jackknifeFile")
    p.add_argument("--jackknifeFile", default=None, metavar="path",
                   help="output for --jackknife (default: outFile + "
                        "'.jackknife.tsv', or stderr with no outFile)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--addWindowID", action="store_true")
    p.add_argument("--writeFailedWindows", action="store_true")
    common.add_runtime_args(p)
    return p


def main(argv=None, full_panel: bool = False) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    use_device = os.environ.get("GGT_ABBA_HOST") != "1"
    args = build_parser(full_panel).parse_args(argv)
    if os.environ.get("GGT_PACKED_TRANSFER") == "0":
        raise NotImplementedError(
            "GGT_PACKED_TRANSFER=0 (the raw int8 upload) is not ported yet: "
            "ROADMAP queue 2, row 7")
    get_device()                     # fail fast when the card is missing
    wind = common.resolve_window_args(args, wind_coord_cols=4)
    min_sites = wind["minSites"]
    min_data = args.minData
    assert 0 <= min_data <= 1, "minimum data per site must be between 0 and 1."

    pop_args = [args.pop1, args.pop2, args.pop3, args.outgroup]
    sd = SampleData.from_pop_args(
        population_args=pop_args, pops_file=args.popsFile,
        ploidy_list=args.ploidy, ploidy_file=args.ploidyFile,
        haploid=args.haploid.split(",") if args.haploid else None,
        geno_format=args.genoFormat)
    pop_names = sd.pop_names

    # device: counts for P1..P4 and their union in one dispatch (the row
    # model depends only on SampleData, not on the input stream)
    model = HaplotypeModel.build(sd)
    pop_rows = [model.pop_row_indices[p] for p in pop_names]
    union_rows = np.unique(np.concatenate(pop_rows))
    mask = np.zeros((5, model.n_rows), dtype=np.float32)
    for k, rows in enumerate(pop_rows):
        mask[k, rows] = 1.0
    mask[4, union_rows] = 1.0
    n_pops = [rows.size for rows in pop_rows]

    if full_panel:
        stats = ["ABBA", "BABA", "ABAA", "BAAA", 'D', 'fd', "fd'", 'fdm',
                 "fdm'", 'fdh', 'fdh2', 'fh']
        polarize = args.polarize
        fixed = args.fixed
    else:
        stats = ["ABBA", "BABA", "D", "fd", "fdM"]
        polarize, fixed = True, False

    head = "scaffold,start,end,mid,sites,sitesUsed," + ",".join(stats)
    if args.addWindowID:
        head = "windowID," + head

    jackknife_bs = args.jackknife
    if jackknife_bs is not None:
        assert jackknife_bs > 0, "--jackknife block size must be positive"
        assert not args.resume, \
            "--jackknife needs every window's sums; --resume is not supported"
        # per-good-window ratio components, accumulated by the finalize
        # consumer thread (single consumer -> no locking needed)
        jk_rows: list[tuple[str, int, float, float, float, float]] = []

    out, skip_windows, cursor = common.open_resumable_out(args, head + "\n")
    reader = geno_io.GenoReader(
        args.genoFile if args.genoFile else sys.stdin,
        sample_data=sd, geno_format=args.genoFormat, header=args.header)

    timer = engine.StageTimer(args.profile)
    progress = engine.Progress(args.verbose)

    mode = "polarize" if polarize else ("fixed" if fixed else "minor")
    channels = abba_k.channels_of(full_panel)
    jk_idx = {c: k for k, c in enumerate(channels)}

    def dispatch(batch):
        plan = batch.plan
        span = batch.alleles[:, :batch.needed_end]
        with timer.stage("kernel"):
            if not span.shape[1]:
                handle = None
            elif use_device:
                handle = abba_k.window_abba_sums_dispatch(
                    span, plan.first.astype(np.int32),
                    plan.n_sites.astype(np.int32), mask, n_pops,
                    min_data, mode, full_panel)
            else:
                handle = counts_k.site_pop_counts_dispatch(span, mask)
        return batch, handle

    def finalize(batch, handle):
        plan = batch.plan
        n_w = plan.n_windows
        sites = plan.n_sites
        mid = plan.mid(batch.positions)
        if use_device:
            with timer.stage("d2h"):
                sums = handle.collect() if handle is not None \
                    else np.zeros((0, 1))
            res_all = abba_k.finalize_window_stats(
                sums, channels, full_panel) if handle is not None else []
        else:
            with timer.stage("d2h"):
                counts = handle.collect() if handle is not None \
                    else np.zeros((0, 5, 4), np.int32)             # [S,5,4]
            counts_pops = [counts[:, k, :] for k in range(4)]
            counts_union = counts[:, 4, :]

        with timer.stage("finalize"):
            rows_written = 0
            for w in range(n_w):
                if batch.window_offset + w < skip_windows:
                    continue
                n_sites_w = int(sites[w])
                sites_used: object = np.nan
                if n_sites_w >= min_sites:
                    if use_device:
                        res = res_all[w]
                    else:
                        f, l = int(plan.first[w]), int(plan.last[w])
                        res = abbababa.window_four_pop_panel(
                            [c[f:l] for c in counts_pops], counts_union[f:l],
                            n_pops, min_data, polarize, fixed, full_panel,
                            with_sums=jackknife_bs is not None)
                    sites_used = res["sitesUsed"]
                    if sites_used >= min_sites:
                        is_good = True
                        values = [writers.fmt_float(res[s], 4) for s in stats]
                    else:
                        is_good = False
                        values = ["nan"] * len(stats)
                else:
                    is_good = False
                    values = ["nan"] * len(stats)
                if not (is_good or args.writeFailedWindows):
                    continue
                row = []
                if args.addWindowID:
                    row.append(str(plan.ids[w]))
                scaf_name = batch.scaffold_names[plan.scaffold_id[w]] \
                    if plan.scaffold_id[w] >= 0 else "None"
                if jackknife_bs is not None and is_good \
                        and mid[w] == mid[w]:
                    if use_device:
                        s_w = sums[w]
                        jk_rows.append((scaf_name, int(mid[w]),
                                        float(s_w[jk_idx["num_f4"]]),
                                        float(s_w[jk_idx["den_D"]]),
                                        float(s_w[jk_idx["den_fd"]]),
                                        float(s_w[jk_idx["den_fdm"]])))
                    else:
                        jk_rows.append((scaf_name, int(mid[w]),
                                        res["_num_f4"], res["_den_D"],
                                        res["_den_fd"], res["_den_fdm"]))
                row += [scaf_name,
                        str(int(plan.start[w])), str(int(plan.end[w])),
                        writers.fmt_int_or_nan(mid[w]), str(n_sites_w),
                        str(sites_used) if sites_used == sites_used else "nan"]
                row += values
                out.write(",".join(row) + "\n")
                rows_written += 1
            progress.update(rows=rows_written)
            if cursor is not None:
                out.flush()
                cursor.save(batch.window_offset + n_w, out.tell())

    engine.run_pipeline(
        engine.stream_windows(
            reader, wind,
            include=common.read_scaffold_list(args.include),
            exclude=common.read_scaffold_list(args.exclude),
            progress=progress, timer=timer),
        dispatch, finalize,
        skip=lambda b: (b.plan.n_windows == 0
                        or b.window_offset + b.plan.n_windows <= skip_windows))

    if cursor is not None:
        cursor.clear()
    if args.outFile:
        out.close()
    if jackknife_bs is not None:
        _write_jackknife(jk_rows, jackknife_bs, reader.scaffold_names, args)
    progress.close()
    timer.report()
    return 0


def _write_jackknife(jk_rows, block_size: int, scaffold_order, args) -> None:
    """Genome-wide D/fd/fdM +- SE from per-window ratio components.

    Blocks follow jackknife.R's get.block.indices (jackknife.R:5-36):
    per-scaffold blocks of ``block_size`` bp anchored at the scaffold's
    first good-window midpoint; delete-one-block pseudovalues via the
    O(blocks) ratio jackknife (stats/jackknife.ratio_jackknife), which
    equals block.jackknife (jackknife.R:41-61) with FUN = ratio-of-sums
    over the per-window num/den columns."""
    from ..stats import jackknife as J
    order = {n: i for i, n in enumerate(scaffold_order)}
    jk_rows = sorted(jk_rows,
                     key=lambda r: (order.get(r[0], len(order)), r[1]))
    if args.jackknifeFile:
        out = writers.open_out(args.jackknifeFile)
    elif args.outFile:
        out = writers.open_out(args.outFile + ".jackknife.tsv")
    else:
        out = sys.stderr
    out.write("\t".join(["stat", "overall", "jackknife_mean", "variance",
                         "standard_deviation", "standard_error", "Z",
                         "n_blocks"]) + "\n")
    if jk_rows:
        chroms = np.array([r[0] for r in jk_rows])
        mids = np.array([r[1] for r in jk_rows], dtype=np.int64)
        vals = np.array([r[2:] for r in jk_rows], dtype=np.float64)
        indices = J.block_indices(block_size, mids, chroms)
    else:
        indices = []
    for col, name in ((1, "D"), (2, "fd"), (3, "fdM")):
        if not indices:
            out.write(name + "\tnan" * 6 + "\t0\n")
            continue
        num, den = vals[:, 0], vals[:, col]
        nb = np.array([num[ix].sum() for ix in indices])
        db = np.array([den[ix].sum() for ix in indices])
        res = J.ratio_jackknife(nb, db)
        overall = num.sum() / den.sum()
        z = overall / res["standard_error"] \
            if res["standard_error"] > 0 else np.nan
        out.write("\t".join([name, str(overall), str(res["mean"]),
                             str(res["variance"]),
                             str(res["standard_deviation"]),
                             str(res["standard_error"]), str(z),
                             str(len(indices))]) + "\n")
    if out is not sys.stderr:
        out.close()


if __name__ == "__main__":
    sys.exit(main())
