"""sfs on the GPU: 1D/2D/3D/4D site-frequency spectra.

The port of genomics_general_tpu/cli/sfs.py, with the same flags and output
bytes.  Mirrors the reference sfs.py: genotypes / baseCounts / targetCounts
inputs, folded (minor-allele) or polarized (outgroup = last population)
spectra, haplotype/individual downsampling with the reference's seeded RNG
stream, per-region spectra via Intervals, sparse output in nested
first-insertion order (see stats/sfs.py for the replicated semantics).

Vectorization: the per-site per-pop base counts of a genotypes input come
from the count kernels (kernels/counts.py: K6 on the span wire, K12 on the
raw upload, the host counter under ``GGT_EXEC=host``); completeness gates
and target selection are vectorized on host; only qualifying SNPs enter the
(insertion-ordered) accumulation loop.  With --subsample the whole site
loop runs on host to consume np.random in the reference's exact order.  The
table inputs (baseCounts / targetCounts) run on the host only.
Multi-process runs of a genotypes input (``GGT_COORDINATOR`` /
``GGT_NUM_PROCS`` / ``GGT_PROC_ID``, parallel/multihost) shard it by
scaffold and merge the spectra with int64 collectives (sum of counts, min
of first-occurrence keys); process 0 writes them.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np

from ..device import get_device
from ..io import geno as geno_io
from ..kernels import counts as counts_k
from ..regions import Intervals
from ..samples import SampleData
from ..stats.sfs import SparseFS, down_sample_base_counts, get_target_counts
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sfs")
    p.add_argument("-i", "--inputFile", action="store")
    p.add_argument("--inputType", action="store",
                   choices=("genotypes", "baseCounts", "targetCounts"),
                   default="targetCounts")
    p.add_argument("--scafCol", action="store", type=int, default=0)
    p.add_argument("--posCol", action="store", type=int, default=1)
    p.add_argument("--firstSampleCol", action="store", type=int, default=2)
    p.add_argument("--header", action="store")
    p.add_argument("--genoFormat", action="store",
                   choices=("phased", "diplo", "alleles"), default="phased")
    p.add_argument("-p", "--pop", action="append", nargs="+")
    p.add_argument("--popsFile", action="store", required=False)
    p.add_argument("--ploidy", action="store", type=int, nargs="+")
    p.add_argument("--ploidyFile", action="store")
    p.add_argument("--FSpops", action="append", type=str, nargs="+")
    p.add_argument("--doPairs", action="store_true")
    p.add_argument("--doTrios", action="store_true")
    p.add_argument("--doQuartets", action="store_true")
    p.add_argument("--subsample", action="store", required=False, nargs="+", type=int)
    p.add_argument("--subsampleIndividuals", action="store_true")
    p.add_argument("--pref", action="store", required=False, default="")
    p.add_argument("--suff", action="store", required=False, default=".sfs")
    p.add_argument("--pipe", action="store_true")
    p.add_argument("--polarized", action="store_true")
    p.add_argument("--outgroup", action="store", required=False)
    p.add_argument("--regions", nargs="+", action="store")
    p.add_argument("--regionsFile", action="store")
    p.add_argument("--include", nargs="+", action="store")
    p.add_argument("--includeFile", action="store")
    p.add_argument("--exclude", nargs="+", action="store")
    p.add_argument("--excludeFile", action="store")
    p.add_argument("-R", "--report", action="store", required=False, default=100000)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--seed", action="store", type=int, default=42)
    p.add_argument("--profile", action="store_true",
                   help="report per-stage wall-clock timing on stderr")
    return p


def _read_table_header(path_or_stdin, header, first_sample_col):
    """Read the table header + raw body bytes (parse deferred until the
    selected columns are known, so the fused C path can skip materializing
    the full numeric matrix)."""
    f = geno_io.open_maybe_gz(path_or_stdin, "rb") if isinstance(path_or_stdin, str) \
        else path_or_stdin
    if header is not None:
        names = header.split()[first_sample_col:]
    else:
        names = f.readline().split()[first_sample_col:]
        names = [n.decode() if isinstance(n, bytes) else n for n in names]
    body = f.read()
    if isinstance(body, str):
        body = body.encode()
    return names, body


def _parse_table_body(body, names, first_sample_col, parse,
                      vals_per_col=None):
    """Parse a baseCounts/targetCounts table body.

    Returns (scafs, positions, rows); ``rows`` is either a numeric matrix
    ([S, n_cols, vals_per_col] float64 for baseCounts, [S, n_cols] int64 for
    targetCounts) from the C tokenizer — per-line Python parsing dominated
    genome-scale freq->sfs runs — or the per-line Python list fallback with
    the same ``rows[s][col]`` indexing."""
    if vals_per_col is not None and first_sample_col == 2:
        try:
            from ..io import native
            res = native.parse_name_table(
                body, 1 + len(names) * vals_per_col)
        except Exception:
            res = None
        if res is not None:
            vals, bnames, bounds = res
            S = vals.shape[0]
            positions = vals[:, 0].astype(np.int64)
            vbody = vals[:, 1:]
            if vals_per_col == 1:
                rows = vbody.reshape(S, len(names)).astype(np.int64)
            else:
                rows = vbody.reshape(S, len(names), vals_per_col)
            scafs = np.empty(S, dtype=object)
            for k in range(len(bnames)):
                scafs[bounds[k]:bounds[k + 1]] = bnames[k].decode()
            return scafs, positions, rows

    scafs, positions, rows = [], [], []
    for line in body.split(b"\n"):
        if not line.strip() or line.startswith(b"#"):
            continue
        parts = line.split()
        scafs.append(parts[0].decode())
        positions.append(int(parts[1]))
        rows.append([parse(x) for x in parts[first_sample_col:]])
    return scafs, positions, rows


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    if args.inputType == "genotypes":
        get_device()                 # fail fast when the card is missing

    include = list(args.include) if args.include else []
    exclude = list(args.exclude) if args.exclude else []
    if args.includeFile:
        include += open(args.includeFile, "rt").read().split()
    if args.excludeFile:
        exclude += open(args.excludeFile, "rt").read().split()
    include = set(include) if include else None
    exclude = set(exclude) if exclude else None

    np.random.seed(args.seed)
    return _run(args, include, exclude, 1)


def _run(args, include, exclude, n_intervals):
    from ..engine import StageTimer
    timer = StageTimer(getattr(args, "profile", False))
    intervals = None
    if getattr(args, "regions", None):
        intervals = Intervals(regions=args.regions)
    elif getattr(args, "regionsFile", None):
        with open(args.regionsFile, "rt") as fh:
            intervals = Intervals(tuples=[line.split() for line in fh if line.split()])
    if intervals is not None:
        n_intervals = intervals.l

    input_type = args.inputType

    # ---------------- population bookkeeping (sfs.py:281-362)
    pop_names: list[str] = []
    if args.pop:
        for pop in args.pop:
            pop_names.append(pop[0])
    if args.FSpops:
        for pop in (p for pops in args.FSpops for p in pops):
            if pop not in pop_names:
                pop_names.append(pop)

    if input_type == "genotypes":
        pop_dict = {}
        if args.pop or args.FSpops:
            for pop in (args.pop or []):
                pop_dict[pop[0]] = [] if len(pop) == 1 else pop[1].split(",")
            for pop in pop_names:
                pop_dict.setdefault(pop, [])
            if args.popsFile:
                with open(args.popsFile, "r") as pf:
                    for line in pf:
                        parts = line.split()
                        if len(parts) >= 2 and parts[1] in pop_dict \
                                and parts[0] not in pop_dict[parts[1]]:
                            pop_dict[parts[1]].append(parts[0])
        else:
            pop_names = ["all"]
            pop_dict = None  # resolved after header read
        sample_names_known = pop_dict is not None
        if sample_names_known:
            for pop in pop_names:
                assert len(pop_dict[pop]) >= 1, f"Population {pop} has no samples"
            all_samples = [s for p in pop_dict for s in pop_dict[p]]
        else:
            all_samples = None
    else:
        if not pop_names:
            pop_names = None  # take from header

    # ---------------- read input
    if input_type == "genotypes":
        assert args.scafCol == 0 and args.posCol == 1 and args.firstSampleCol == 2, \
            "non-default column layouts are not supported yet"
        probe = geno_io.GenoReader(
            args.inputFile if args.inputFile else sys.stdin.buffer,
            sample_data=None, geno_format=args.genoFormat, header=args.header)
        header_inds = probe.file_ind_names
        if not sample_names_known:
            pop_dict = {"all": list(header_inds)}
            all_samples = list(header_inds)

        if args.ploidy is not None:
            pl = args.ploidy if len(args.ploidy) != 1 else args.ploidy * len(all_samples)
            assert len(pl) == len(all_samples)
            ploidy_dict = dict(zip(all_samples, pl))
        elif args.ploidyFile is not None:
            with open(args.ploidyFile, "r") as pf:
                ploidy_dict = {s[0]: int(s[1]) for s in (l.split() for l in pf) if s}
        else:
            ploidy_dict = {s: 2 for s in all_samples}

        n_hap = {p: sum(ploidy_dict[s] for s in pop_dict[p]) for p in pop_names}

        sd = SampleData(ind_names=list(all_samples), pop_names=list(pop_names),
                        pop_inds=pop_dict, ploidy=ploidy_dict)
        reader = geno_io.rebind_reader(probe, sd)
        S = None                         # streamed; never materialized
    else:
        with timer.stage("read"):
            names, table_body = _read_table_header(
                args.inputFile if args.inputFile else sys.stdin.buffer,
                args.header, args.firstSampleCol)
        if pop_names is None:
            pop_names = names
        col_of = {n: i for i, n in enumerate(names)}
        S = None                         # body parsed lazily below

    # outgroup (sfs.py:369-377)
    if input_type in ("genotypes", "baseCounts") and (args.polarized or args.outgroup):
        outgroup = args.outgroup if args.outgroup else pop_names[-1]
        in_pop_names = [p for p in pop_names if p != outgroup]
    else:
        in_pop_names = list(pop_names)
        outgroup = None

    # subsampling setup (sfs.py:380-403)
    subsample = args.subsample
    if subsample is not None:
        if len(subsample) == 1:
            subsample = subsample * len(in_pop_names)
        assert len(subsample) == len(in_pop_names)
        subsample_dict = dict(zip(in_pop_names, subsample))
        if input_type == "genotypes":
            if not args.subsampleIndividuals:
                for p in in_pop_names:
                    assert n_hap[p] >= subsample_dict[p]
                n_hap = dict(n_hap, **subsample_dict)
            else:
                gp = {ploidy_dict[i] for p in in_pop_names for i in pop_dict[p]}
                assert len(gp) == 1, "Subsampling by individuals not possible with variable ploidy"
                g = gp.pop()
                nh = {p: s * g for p, s in subsample_dict.items()}
                for p in in_pop_names:
                    assert n_hap[p] >= nh[p]
                n_hap = dict(n_hap, **nh)
    else:
        subsample_dict = None

    # FS groups (sfs.py:410-419)
    if args.FSpops:
        fs_pops = args.FSpops
    else:
        fs_pops = [[p] for p in in_pop_names]
        if args.doPairs:
            fs_pops += [list(c) for c in itertools.combinations(in_pop_names, 2)]
        if args.doTrios:
            fs_pops += [list(c) for c in itertools.combinations(in_pop_names, 3)]
        if args.doQuartets:
            fs_pops += [list(c) for c in itertools.combinations(in_pop_names, 4)]
    fss = [SparseFS(len(g), n_intervals) for g in fs_pops]

    # ---------------- site filtering + counts
    if input_type == "genotypes":
        from ..parallel import multihost
        shard_pred = common.shard_predicate()
        if shard_pred is not None:
            assert subsample_dict is None, \
                "--subsample consumes a single RNG stream and cannot be " \
                "scaffold-sharded; run multi-host sfs without it"
        emitters = _stream_genotypes(
            args, reader, pop_names, in_pop_names, outgroup, n_hap,
            pop_dict, subsample_dict, fs_pops, fss, include, exclude,
            intervals, n_intervals, shard_pred)
        if shard_pred is not None:
            # merge the per-process dense accumulators (sum of counts, min
            # of first-occurrence keys reproduces the one-process nested
            # insertion order)
            for acc in emitters:
                acc.counts = multihost.collective_reduce(acc.counts, "sum")
                acc.first = multihost.collective_reduce(acc.first, "min")
            if multihost.process_index() != 0:
                return 0
        return _write_output(args, emitters, fs_pops)

    # ---------------- table inputs (baseCounts / targetCounts)
    fast_table = (input_type == "baseCounts" and subsample_dict is None
                  and intervals is None)
    if fast_table and args.firstSampleCol == 2:
        # fused C path: one pass parses the table AND selects per-pop
        # target-allele counts (io/native.parse_base_counts_targets); only
        # argsort-tie-ambiguous folded lines are re-resolved here with
        # np.argsort so the nondeterministic-tie behavior matches numpy's
        from ..io import native
        from ..stats.sfs_accum import DenseFS, ScaffoldKeyTracker
        with timer.stage("parse"):
            res = native.parse_base_counts_targets(
                table_body, len(names), [col_of[p] for p in in_pop_names],
                col_of[outgroup] if outgroup else -1)
        if res is not None:
            positions, tgt, ok, flag_idx, flag_counts, nhap_max, bnames, \
                bounds = res
            n_in = len(in_pop_names)
            if flag_idx.size:
                tot = flag_counts[:, :n_in, :].sum(axis=1)
                t2 = np.argsort(tot, axis=1)[:, -2]
                tgt[flag_idx] = flag_counts[
                    np.arange(flag_idx.size)[:, None],
                    np.arange(n_in)[None, :], t2[:, None]]
            run_sizes = np.diff(bounds)
            sel_mask = ok.astype(bool)
            if include is not None or exclude is not None:
                run_keep = np.array(
                    [(include is None or nm.decode() in include)
                     and (exclude is None or nm.decode() not in exclude)
                     for nm in bnames], dtype=bool)
                sel_mask &= np.repeat(run_keep, run_sizes)
            sids = np.repeat(np.arange(len(bnames)), run_sizes)
            with timer.stage("accumulate"):
                keys = ScaffoldKeyTracker().keys_for(sids)
                tgt_ok, keys_ok = tgt[sel_mask], keys[sel_mask]
                emitters = []
                for g in fs_pops:
                    gp = [in_pop_names.index(p) for p in g]
                    acc = DenseFS(tuple(int(nhap_max[j]) + 1 for j in gp),
                                  n_intervals)
                    acc.add_batch(acc.flat_index(tgt_ok[:, gp]), keys_ok)
                    emitters.append(acc)
            with timer.stage("write"):
                ret = _write_output(args, emitters, fs_pops)
            timer.report()
            return ret

    scafs, positions_l, rows = _parse_table_body(
        table_body, names, args.firstSampleCol,
        (lambda x: np.array(str(x if not isinstance(x, bytes) else x.decode()).split(","), dtype=float).astype(int))
        if input_type == "baseCounts" else (lambda x: int(x)),
        vals_per_col=4 if input_type == "baseCounts" else 1)
    scaf_of_site = np.array(scafs, dtype=object)
    positions = np.array(positions_l, dtype=int)
    S = len(rows)

    keep = np.ones(S, dtype=bool) if S else np.zeros(0, dtype=bool)
    if S:
        if include is not None:
            keep &= np.array([s in include for s in scaf_of_site])
        if exclude is not None:
            keep &= np.array([s not in exclude for s in scaf_of_site])

    if fast_table:
        # vectorized: bincount into dense spectra, insertion order recovered
        # from first-occurrence keys (stats/sfs_accum.py)
        from ..stats.sfs_accum import DenseFS, ScaffoldKeyTracker, \
            vector_targets
        sel_cols = [col_of[p] for p in in_pop_names]
        if S and isinstance(rows, np.ndarray):
            arrs = rows[:, sel_cols, :].astype(np.int64)
        elif S:
            arrs = np.array([[rows[s][c] for c in sel_cols]
                             for s in range(S)], dtype=np.int64)
        else:
            arrs = np.zeros((0, len(in_pop_names), 4), np.int64)
        out_col = col_of[outgroup] if outgroup else None
        if outgroup and S:
            if isinstance(rows, np.ndarray):
                out_counts = rows[:, out_col, :].astype(np.int64)
            else:
                out_counts = np.array(
                    [np.asarray(rows[s][out_col]) for s in range(S)],
                    dtype=np.int64)
        else:
            out_counts = None
        sids = np.zeros(S, dtype=np.int64)
        if S > 1:
            change = scaf_of_site[1:] != scaf_of_site[:-1]
            sids = np.concatenate([[0], np.cumsum(change)])
        keys = ScaffoldKeyTracker().keys_for(sids)
        sel = np.flatnonzero(keep)
        ok, tgt = vector_targets(arrs[sel],
                                 out_counts[sel] if outgroup else None)
        tgt, keys_ok = tgt[ok], keys[sel][ok]
        n_hap_tab = arrs.sum(axis=2).max(axis=0) if S else \
            np.zeros(len(in_pop_names), np.int64)
        emitters = []
        for g in fs_pops:
            gp = [in_pop_names.index(p) for p in g]
            acc = DenseFS(tuple(int(n_hap_tab[j]) + 1 for j in gp),
                          n_intervals)
            acc.add_batch(acc.flat_index(tgt[:, gp]), keys_ok)
            emitters.append(acc)
        return _write_output(args, emitters, fs_pops)

    if input_type == "baseCounts":
        out_col = col_of[outgroup] if outgroup else None
        for s in np.flatnonzero(keep):
            add_value = 1
            if intervals is not None:
                add_value = intervals.contains_point(
                    pos=positions[s], chrom=scaf_of_site[s])
                if add_value.sum() == 0:
                    continue
            arr = np.array([rows[s][col_of[p]] for p in in_pop_names],
                           dtype=np.int64)
            if subsample_dict:
                try:
                    arr = np.array([down_sample_base_counts(
                        arr[i, :], subsample_dict[in_pop_names[i]])
                        for i in range(len(in_pop_names))])
                except ValueError:
                    continue
            out_c = np.asarray(rows[s][out_col]) if outgroup else None
            tc = get_target_counts(arr, out_c)
            if tc is None:
                continue
            d = dict(zip(in_pop_names, tc))
            for i, g in enumerate(fs_pops):
                fss[i].add([d[p] for p in g], add_value)
    else:
        for s in np.flatnonzero(keep):
            add_value = 1
            if intervals is not None:
                add_value = intervals.contains_point(
                    pos=positions[s], chrom=scaf_of_site[s])
                if add_value.sum() == 0:
                    continue
            d = {p: rows[s][col_of[p]] for p in in_pop_names}
            for i, g in enumerate(fs_pops):
                fss[i].add([d[p] for p in g], add_value)

    return _write_output(args, fss, fs_pops)


def _write_output(args, emitters, fs_pops) -> int:
    """Emit one spectrum per FS group (sfs.py:499-505)."""
    if args.pipe:
        for fs in emitters:
            sys.stdout.write(fs.as_text())
    else:
        for i, fs in enumerate(emitters):
            with open(args.pref + "_".join(fs_pops[i]) + args.suff, "w") as out:
                out.write(fs.as_text())
    return 0


def _stream_genotypes(args, reader, pop_names, in_pop_names, outgroup, n_hap,
                      pop_dict, subsample_dict, fs_pops, fss, include,
                      exclude, intervals, n_intervals, shard_pred):
    """Streaming accumulation over geno chunks: the count kernels with
    dispatch/collect overlap (chunk k + 1 is dispatched before chunk k is
    collected), O(chunk) host memory (the reference streams site-by-site,
    sfs.py:428-496).  Returns the list of per-group emitters (DenseFS on
    the fast path, the SparseFS list under --subsample)."""
    from .. import engine as _engine
    from ..stats.sfs_accum import DenseFS, ScaffoldKeyTracker, vector_targets

    model = reader.model
    P = len(pop_names)
    mask = np.zeros((P, model.n_rows), dtype=np.float32)
    for k, p in enumerate(pop_names):
        mask[k, model.pop_row_indices[p]] = 1.0
    in_k = [pop_names.index(p) for p in in_pop_names]
    out_k = pop_names.index(outgroup) if outgroup else None
    n_hap_arr = np.array([n_hap[p] for p in in_pop_names])
    fast = subsample_dict is None
    if fast:
        accs = [DenseFS(tuple(n_hap[p] + 1 for p in g), n_intervals)
                for g in fs_pops]
        g_pos = [[in_pop_names.index(p) for p in g] for g in fs_pops]
    tracker = ScaffoldKeyTracker()

    def keep_mask(sids):
        if include is None and exclude is None and shard_pred is None:
            return None
        names = reader.scaffold_names
        ok = np.array([(include is None or n in include)
                       and (exclude is None or n not in exclude)
                       and (shard_pred is None or shard_pred(n))
                       for n in names])
        return ok[sids]

    def kept(chunks):
        """Each chunk cut to the sites of included, not excluded and owned
        scaffolds before its upload, so that each process counts only its
        own scaffolds on the card."""
        for chunk in chunks:
            km = keep_mask(chunk.scaffold_ids)
            if km is not None and not km.all():
                if not km.any():
                    continue
                chunk = geno_io.GenoChunk(chunk.alleles[:, km],
                                          chunk.positions[km],
                                          chunk.scaffold_ids[km])
            yield chunk

    def process(chunk, counts):
        sids, pos = chunk.scaffold_ids, chunk.positions
        alleles = chunk.alleles
        keys = tracker.keys_for(sids)
        if fast:
            in_counts = counts[:, in_k, :].astype(np.int64)
            complete = (in_counts.sum(axis=2) == n_hap_arr[None, :]).all(axis=1)
            cand = np.flatnonzero(complete)
            if cand.size == 0:
                return
            out_counts = counts[cand][:, out_k, :].astype(np.int64) \
                if out_k is not None else None
            ok, tgt = vector_targets(in_counts[cand], out_counts)
            sel = cand[ok]
            tgt, keys_ok = tgt[ok], keys[sel]
            values = None
            if intervals is not None:
                vals = np.zeros((sel.size, n_intervals), dtype=np.int64)
                good = np.ones(sel.size, dtype=bool)
                for j, s in enumerate(sel):
                    av = intervals.contains_point(
                        pos=pos[s], chrom=reader.scaffold_names[sids[s]])
                    if av.sum() == 0:
                        good[j] = False
                    else:
                        vals[j] = av
                tgt, keys_ok, values = tgt[good], keys_ok[good], vals[good]
            for acc, gp in zip(accs, g_pos):
                acc.add_batch(acc.flat_index(tgt[:, gp]), keys_ok, values)
            return
        # --subsample: per-site host loop consuming the reference's exact
        # np.random / random stream order (sfs.py:23-24, 44-49)
        for s in range(pos.size):
            add_value = 1
            if intervals is not None:
                add_value = intervals.contains_point(
                    pos=pos[s], chrom=reader.scaffold_names[sids[s]])
                if add_value.sum() == 0:
                    continue
            if not args.subsampleIndividuals:
                try:
                    arr = np.array([
                        down_sample_base_counts(
                            counts[s, pop_names.index(p), :],
                            subsample_dict[p])
                        for p in in_pop_names])
                except ValueError:
                    continue
            else:
                arr = _subsample_individuals(
                    alleles, model, pop_dict, in_pop_names,
                    subsample_dict, s)
                if arr is None:
                    continue
            if not np.all(arr.sum(axis=1) == n_hap_arr):
                continue
            out_c = counts[s, out_k, :] if out_k is not None else None
            tc = get_target_counts(arr, out_c)
            if tc is None:
                continue
            d = dict(zip(in_pop_names, tc))
            for i, g in enumerate(fs_pops):
                fss[i].add([d[p] for p in g], add_value)

    prev = None
    for chunk in _engine._prefetched(kept(reader.iter_chunks())):
        handle = counts_k.site_pop_counts_dispatch(chunk.alleles, mask)
        if prev is not None:
            pc, ph = prev
            process(pc, ph.collect())
        prev = (chunk, handle)
    if prev is not None:
        pc, ph = prev
        process(pc, ph.collect())
    return accs if fast else fss


def _subsample_individuals(alleles, model, pop_dict, in_pop_names,
                           subsample_dict, s):
    """Per-individual subsampling (sfs.py:44-49), preserving RNG semantics
    (random.sample over good individual indices)."""
    import random
    out = []
    for p in in_pop_names:
        # per-individual base counts at site s
        arr = []
        for ind in pop_dict[p]:
            ridx = [i for i, sn in enumerate(model.row_sample) if sn == ind]
            vals = alleles[ridx, s]
            vals = vals[vals >= 0]
            arr.append(np.bincount(vals, minlength=4))
        arr = np.array(arr)
        good = np.where(arr.sum(axis=1) != 0)[0]
        try:
            chosen = random.sample(list(good), subsample_dict[p])
        except ValueError:
            return None
        out.append(arr[chosen, :].sum(axis=0))
    return np.array(out)


if __name__ == "__main__":
    sys.exit(main())
