"""Sliding-window phylogenies (phyml orchestration + built-in NJ).

The port of genomics_general_tpu/cli/phyml_sliding_windows.py, with the
same flags and output bytes, in one process or, sharded by scaffold, in
several (``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` / ``GGT_PROC_ID``,
parallel/multihost); it launches no kernel (--maxLDphase runs
stats/ld.max_ld_phase's numpy tables, as the JAX CLI does).  Mirror of
phylo/phyml_sliding_windows.py: per window an
alignment is built from split haplotypes, filtered on minSites / minPerInd
/ minSNPs, and a tree + lnL are produced; outputs are ``<prefix>.data.tsv``
plus gzipped Newick tracks (main + one per bootstrap)
(phyml_sliding_windows.py:105-151, 309-320).

Backends:
* ``--phyml <path>`` — shell out to a phyml binary with the reference's
  exact command line (phyml_sliding_windows.py:25-58).
* ``--phyml builtin-nj`` — no external binary: neighbor-joining over the
  window's masked-Hamming distance matrix (optionally JC-corrected with
  --njCorrect); lnL is reported as NA.

Reference defects not carried over: the outgroup "*"-suffix loop is a
no-op there (it rebinds the loop variable, :117-119) and stays a no-op
here for parity; --crossVal crashes there on undefined names (:136-138)
but works here; bootstrap resampling accepts --seed.
"""

from __future__ import annotations

import argparse
import gzip
import os
import subprocess
import sys
import tempfile

import numpy as np

from ..io import geno as geno_io
from ..io.writers import make_aln_string
from ..samples import SampleData
from ..stats.ld import max_ld_phase
from ..stats.nj import jukes_cantor, neighbor_joining
from . import common

CHARS = np.array(list("ACGT"))


def codes_to_rows(alleles: np.ndarray) -> list[str]:
    """int8 [H, S] -> list of sequence strings (N for missing)."""
    out = np.where(alleles >= 0, CHARS[np.maximum(alleles, 0)], "N")
    return ["".join(row) for row in out]


def phyml_tree(seqs, names, model, opt, phyml, prefix="", tmp_dir=None,
               test=False, log="/dev/null"):
    """Run phyml on one alignment; returns (tree, lnL)
    (phyml_sliding_windows.py:25-58)."""
    tmp = tempfile.NamedTemporaryFile(mode="w", prefix=prefix, suffix=".phy",
                                      dir=tmp_dir, delete=False)
    local = tmp.name.rsplit("/", 1)[1]
    with tmp as t:
        t.write(make_aln_string(names, seqs, out_format="phylip"))
    cmd = " ".join([phyml, "--input", tmp.name, "--model", model, "-o", opt,
                    "-b 0 --quiet", ">>", log])
    if test:
        sys.stderr.write("phyml command:\n" + cmd + "\n")
    subprocess.call(cmd, shell=True)
    tree, lnl = "NA", "NA"
    for suffix in ("_phyml_tree.txt", "_phyml_tree"):
        try:
            with open(tmp.name + suffix, "rt") as f:
                tree = f.readline().strip()
            break
        except OSError:
            continue
    for suffix in ("_phyml_stats.txt", "_phyml_stats"):
        try:
            with open(tmp.name + suffix, "rt") as f:
                stats = f.read().split()
                lnl = stats[stats.index("Log-likelihood:") + 1]
            break
        except (OSError, ValueError):
            continue
    if not test:
        for f in (f for f in os.listdir(tmp_dir) if local in f):
            os.remove(tmp_dir + "/" + f)
    return tree, lnl


def phyml_cross_val(seqs0, seqs1, names, model, opt, phyml, prefix="",
                    tmp_dir=None, test=False, log="/dev/null"):
    """Two-way cross-validation lnL (phyml_sliding_windows.py:62-100)."""
    total = 0.0
    for train, val in ((seqs0, seqs1), (seqs1, seqs0)):
        t_train = tempfile.NamedTemporaryFile(
            mode="w", prefix=prefix, suffix=".t.phy", dir=tmp_dir,
            delete=False)
        t_val = tempfile.NamedTemporaryFile(
            mode="w", prefix=prefix, suffix=".v.phy", dir=tmp_dir,
            delete=False)
        with t_train as f:
            f.write(make_aln_string(names, train, out_format="phylip"))
        with t_val as f:
            f.write(make_aln_string(names, val, out_format="phylip"))
        subprocess.call(" ".join([phyml, "--input", t_train.name, "--model",
                                  model, "-o", opt, ">>", log]), shell=True)
        subprocess.call(" ".join([phyml, "--input", t_val.name, "--model",
                                  model, "-o", "n", "-u",
                                  t_train.name + "_phyml_tree.txt", ">>",
                                  log]), shell=True)
        try:
            with open(t_val.name + "_phyml_stats.txt", "rt") as f:
                stats = f.read().split()
                total += float(stats[stats.index("Log-likelihood:") + 1])
        except (OSError, ValueError):
            total += np.nan
        if not test:
            for name in (t_train.name, t_val.name):
                local = name.rsplit("/", 1)[1]
                for f in (f for f in os.listdir(tmp_dir) if local in f):
                    os.remove(tmp_dir + "/" + f)
    return str(total)


def nj_window_tree(alleles: np.ndarray, names, correct=False) -> str:
    """Built-in backend: NJ over the window's masked-Hamming distances."""
    valid = (alleles >= 0)
    H = alleles.shape[0]
    shared = (valid.astype(np.int32) @ valid.T.astype(np.int32))
    eq = np.zeros((H, H), np.int32)
    for b in range(4):
        m = (alleles == b).astype(np.int32)
        eq += m @ m.T
    with np.errstate(invalid="ignore", divide="ignore"):
        dist = (shared - eq) / shared
    if correct:
        dist = jukes_cantor(dist)
    return neighbor_joining(dist, list(names))


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    p = argparse.ArgumentParser(prog="phyml_sliding_windows")
    p.add_argument("--windType", action="store",
                   choices=("sites", "coordinate", "predefined"),
                   default="coordinate")
    p.add_argument("-w", "--windSize", type=int, action="store")
    p.add_argument("-M", "--minSites", type=int, action="store")
    p.add_argument("-Mi", "--minPerInd", type=int, action="store")
    p.add_argument("-Ms", "--minSNPs", type=int, action="store")
    p.add_argument("-S", "--stepSize", type=int, action="store")
    p.add_argument("-O", "--overlap", type=int, action="store")
    p.add_argument("-D", "--maxDist", type=int, action="store")
    p.add_argument("--windCoords", required=False)
    p.add_argument("-g", "--genoFile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("--exclude", required=False)
    p.add_argument("--include", required=False)
    p.add_argument("--excludeFile", required=False)
    p.add_argument("--includeFile", required=False)
    p.add_argument("--individuals", action="store")
    p.add_argument("--indFile", action="store")
    p.add_argument("--maxLDphase", action="store_true")
    p.add_argument("--outgroup", action="store")
    p.add_argument("--phyml", action="store", default="phyml",
                   help="path to phyml, or 'builtin-nj' for the built-in "
                        "neighbor-joining backend")
    p.add_argument("--njCorrect", action="store_true",
                   help="Jukes-Cantor correct distances (builtin-nj only)")
    p.add_argument("--model", action="store", default="GTR")
    p.add_argument("--optimise", action="store",
                   choices=("tlr", "tl", "tr", "lr", "t", "l", "r", "n"),
                   default="n")
    p.add_argument("--bootstraps", type=int, action="store", default=0)
    p.add_argument("--crossVal", action="store_true")
    p.add_argument("--seed", type=int, action="store")
    p.add_argument("--tmp", action="store")
    p.add_argument("--log", action="store", default="/dev/null")
    p.add_argument("-T", "--threads", type=int, default=1)
    p.add_argument("--test", action="store_true")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    wind = {"windType": args.windType}
    if args.windType == "coordinate":
        assert args.windSize, "Window size must be provided."
        wind.update(windSize=args.windSize,
                    stepSize=args.stepSize or args.windSize)
        assert not args.overlap and not args.maxDist
    elif args.windType == "sites":
        assert args.windSize, "Window size (number of sites) must be provided."
        wind.update(windSize=args.windSize, overlap=args.overlap or 0,
                    maxDist=args.maxDist or np.inf)
        assert not args.stepSize
    else:
        assert args.windCoords
        with open(args.windCoords, "rt") as wc:
            wind["windCoords"] = [line.split()[:3] for line in wc
                                  if line.strip()]
    min_sites = args.minSites or args.windSize
    wind["minSites"] = min_sites
    min_per_ind = args.minPerInd if args.minPerInd else min_sites

    if args.individuals:
        ind_names = args.individuals.split(",")
    elif args.indFile:
        with open(args.indFile, "rt") as f:
            ind_names = [n.strip() for n in f.readlines()]
    else:
        ind_names = None
    outgroup = args.outgroup.split(",") if args.outgroup else []

    include = args.include.split(",") if args.include else \
        common.read_scaffold_list(args.includeFile)
    exclude = args.exclude.split(",") if args.exclude else \
        common.read_scaffold_list(args.excludeFile)

    src = args.genoFile if args.genoFile else sys.stdin
    probe = geno_io.GenoReader(src, geno_format="phased")
    names = ind_names if ind_names else list(probe.file_ind_names)
    sd = SampleData(ind_names=names, ploidy={n: 2 for n in names})
    reader = geno_io.rebind_reader(probe, sd)
    model = reader.model
    hap_names = model.row_names
    row_samples = model.row_sample       # individual name per haplotype row
    non_out_rows = np.array([i for i, s in enumerate(row_samples)
                             if s not in outgroup], dtype=np.int64)

    heads = ["scaffold", "start", "end", "mid", "sites", "lnL"]
    if args.crossVal:
        heads.append("cv_lnL")
    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # scaffold-sharded tree inference: each process runs phyml/NJ on
        # the windows of the scaffolds it owns; rows for every output file
        # gather to process-0 writers (all files share the same
        # per-scaffold ordering, so data/tree line alignment is preserved).
        # Bootstrap column resampling draws come from each process's own
        # seeded stream, so bootstrap trees differ from a one-process run
        # (the point estimates and data rows are identical).
        assert not args.test, "--test stops after a global window count " \
            "and is not supported in multi-host runs"
        mh_data = multihost.MultiHostWriter()
        mh_trees = multihost.MultiHostWriter()
        mh_bs = [multihost.MultiHostWriter() for _ in range(args.bootstraps)]
        data_file = trees_file = None
        bs_files = [None] * args.bootstraps
    else:
        mh_data = mh_trees = None
        mh_bs = []
        data_file = open(args.prefix + ".data.tsv", "wt")
        data_file.write("\t".join(heads) + "\n")
        trees_file = gzip.open(args.prefix + ".trees.gz", "wt")
        bs_files = [gzip.open(f"{args.prefix}.BS{b}.trees.gz", "wt")
                    for b in range(args.bootstraps)]

    use_builtin = args.phyml == "builtin-nj"
    tmp_dir = None
    if not use_builtin:
        tmp_dir = tempfile.mkdtemp(prefix="phyml_tmp", dir=args.tmp)
    rng = np.random.default_rng(args.seed)

    def compute_window(aln, n_sites, prefix, bs_cols):
        """Tree inference for one passing window (runs on a pool worker;
        bootstrap column draws were taken from the seeded stream on the
        main thread so the draw ORDER is identical at any -T)."""
        trees = ["NA"] * (1 + args.bootstraps)
        lnl = cvlnl = "NA"
        if args.maxLDphase:
            aln = max_ld_phase(aln, row_samples)
        if use_builtin:
            trees[0] = nj_window_tree(aln, hap_names, correct=args.njCorrect)
            for b in range(args.bootstraps):
                trees[1 + b] = nj_window_tree(aln[:, bs_cols[b]], hap_names,
                                              correct=args.njCorrect)
        else:
            seqs = codes_to_rows(aln)
            trees[0], lnl = phyml_tree(
                seqs, hap_names, args.model, args.optimise,
                args.phyml, prefix, tmp_dir=tmp_dir,
                test=args.test, log=args.log)
            for b in range(args.bootstraps):
                trees[1 + b], _ = phyml_tree(
                    codes_to_rows(aln[:, bs_cols[b]]), hap_names,
                    args.model, args.optimise, args.phyml,
                    prefix + str(b) + "_", tmp_dir=tmp_dir,
                    test=args.test, log=args.log)
            if args.crossVal:
                half = int(round(n_sites / 2))
                cvlnl = phyml_cross_val(
                    codes_to_rows(aln[:, :half]),
                    codes_to_rows(aln[:, half:]), hap_names,
                    args.model, args.optimise, args.phyml,
                    prefix, tmp_dir=tmp_dir, test=args.test,
                    log=args.log)
        return trees, lnl, cvlnl

    def write_result(scaf, start, end, mid, n_sites, result):
        trees, lnl, cvlnl = result
        row = [scaf, str(start), str(end), mid, str(n_sites), str(lnl)]
        if args.crossVal:
            row.append(str(cvlnl))
        if mh_data is not None:
            mh_data.write_row(scaf, "\t".join(row) + "\n")
            mh_trees.write_row(scaf, trees[0] + "\n")
            for b, mw in enumerate(mh_bs):
                mw.write_row(scaf, trees[1 + b] + "\n")
        else:
            data_file.write("\t".join(row) + "\n")
            trees_file.write(trees[0] + "\n")
            for b, bf in enumerate(bs_files):
                bf.write(trees[1 + b] + "\n")

    # -T worker pool: N windows infer concurrently (threads — the work is
    # an external C binary, or GIL-releasing numpy for builtin-nj) with an
    # ordered bounded reorder queue, the engine analog of the reference's
    # backpressured worker pool + sorter (phyml_sliding_windows.py:396-421).
    from ..parallel.hostpool import OrderedPool
    pool = OrderedPool(max(1, args.threads),
                       lambda meta, res: write_result(*meta, res))

    _NA = (["NA"] * (1 + args.bootstraps), "NA", "NA")
    windows_done = 0
    stop = False
    # stream flush batches: O(flush) memory with subprocess work per window
    from .. import engine
    for batch in engine.stream_windows(reader, wind, include=include,
                                       exclude=exclude,
                                       scaffold_pred=shard_pred):
        if stop:
            break
        plan = batch.plan
        mids = plan.mid(batch.positions)
        for w in range(plan.n_windows):
            f, l = int(plan.first[w]), int(plan.last[w])
            n_sites = l - f
            scaf = batch.scaffold_names[int(plan.scaffold_id[w])]
            if wind["windType"] in ("coordinate", "predefined"):
                start, end = int(plan.start[w]), int(plan.end[w])
            else:
                start = int(batch.positions[f])
                end = int(batch.positions[l - 1])
            mid = "nan" if np.isnan(mids[w]) else str(int(mids[w]))
            prefix = f"{scaf}_{start}_{end}_"
            passing = False
            if n_sites >= min_sites:
                aln = batch.alleles[:, f:l]
                sites_per_ind = (aln >= 0).sum(axis=1)
                n_snps = None
                if args.minSNPs is not None:
                    # variable-site count vs each column's first called base
                    sub = aln[non_out_rows]
                    called = sub >= 0
                    has = called.any(axis=0)
                    ref = sub[np.argmax(called, axis=0),
                              np.arange(n_sites)]
                    n_snps = int((((sub != ref[None, :]) & called).any(axis=0)
                                  & has).sum())
                passing = sites_per_ind.min() >= min_per_ind and \
                    (n_snps is None or n_snps >= args.minSNPs)
            meta = (scaf, start, end, mid, n_sites)
            if passing:
                # bootstrap draws come off the seeded stream HERE (in window
                # order), not on the worker, so -T never changes them
                bs_cols = [rng.integers(0, n_sites, n_sites)
                           for _ in range(args.bootstraps)]
                pool.submit(meta, compute_window, aln, n_sites, prefix,
                            bs_cols)
            else:
                pool.submit(meta, None, _NA)
            windows_done += 1
            if args.test and windows_done == 10:
                stop = True
                break
    pool.close()
    if mh_data is not None:
        rank0 = multihost.process_index() == 0
        data_file = open(args.prefix + ".data.tsv", "wt") if rank0 else None
        mh_data.finish(data_file, "\t".join(heads) + "\n",
                       reader.scaffold_names)
        trees_file = gzip.open(args.prefix + ".trees.gz", "wt") \
            if rank0 else None
        mh_trees.finish(trees_file, "", reader.scaffold_names)
        for b, mw in enumerate(mh_bs):
            bs_files[b] = gzip.open(f"{args.prefix}.BS{b}.trees.gz", "wt") \
                if rank0 else None
            mw.finish(bs_files[b], "", reader.scaffold_names)
    for f in (data_file, trees_file, *bs_files):
        if f is not None:
            f.close()
    if tmp_dir and not args.test:
        os.rmdir(tmp_dir)
    sys.stderr.write(f"{windows_done} windows were tested.\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
