"""Sliding-window ML trees via RAxML (+ built-in NJ backend).

The port of genomics_general_tpu/cli/raxml_sliding_windows.py, with the
same flags and output bytes, in one process or, sharded by scaffold, in
several (``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` / ``GGT_PROC_ID``,
parallel/multihost); it launches no kernel.  Mirror of
phylo/raxml_sliding_windows.py (which is
Python-2-only there; ``print >>`` statements make it unrunnable under
Python 3): per window an alignment is built from split haplotypes,
filtered on minSites / minPerInd / minSNPs, and RAxML is invoked with the
reference's command line (raxml_sliding_windows.py:18-42); outputs are
``<prefix>.data.tsv`` and ``<prefix>.trees.gz``.

``--raxml builtin-nj`` uses the dependency-free neighbor-joining backend
instead of an external binary.
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
from . import common
from .phyml_sliding_windows import codes_to_rows, nj_window_tree


def rax_tree(seqs, names, model, raxml, outgroup=None, prefix="",
             tmp_dir=".", test=False, log="/dev/null"):
    tmp = tempfile.NamedTemporaryFile(mode="w", prefix=prefix, suffix=".phy",
                                      dir=tmp_dir, delete=False)
    local = tmp.name.rsplit("/", 1)[1]
    with tmp as t:
        t.write(make_aln_string(names, seqs, out_format="phylip"))
    og = " -o " + ",".join(outgroup) if outgroup else ""
    cmd = (raxml + " -s " + tmp.name + " -n " + local + " -m " + model + og +
           " -V -f d -p 12345 --silent >>" + log)
    if test:
        sys.stderr.write("raxml command:\n" + cmd + "\n")
    subprocess.call(cmd, shell=True, cwd=tmp_dir)
    try:
        with open(os.path.join(tmp_dir, "RAxML_bestTree." + local),
                  "rt") as f:
            tree = f.readline()
    except OSError:
        tree = "NA\n"
    if not test:
        for f in (f for f in os.listdir(tmp_dir) if local in f):
            os.remove(os.path.join(tmp_dir, f))
    return tree


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raxml_sliding_windows")
    p.add_argument("--windType", action="store",
                   choices=("sites", "coordinate"), default="coordinate")
    p.add_argument("-w", "--windSize", type=int, action="store",
                   required=True)
    p.add_argument("-M", "--minSites", type=int, action="store")
    p.add_argument("-Mi", "--minPerInd", type=int, action="store")
    p.add_argument("-Ms", "--minSNPs", type=int, action="store")
    p.add_argument("-S", "--stepSize", type=int, action="store")
    p.add_argument("-O", "--overlap", type=int, action="store")
    p.add_argument("-D", "--maxDist", type=int, action="store")
    p.add_argument("-g", "--genoFile")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("--exclude", required=False)
    p.add_argument("--include", required=False)
    p.add_argument("--individuals", action="store")
    p.add_argument("--outgroup", action="store")
    p.add_argument("--raxml", action="store", default="raxml",
                   help="path to raxml, or 'builtin-nj'")
    p.add_argument("--njCorrect", action="store_true")
    p.add_argument("--model", action="store", default="GTRCAT")
    p.add_argument("--log", action="store", default="/dev/null")
    p.add_argument("--tmp", action="store")
    p.add_argument("-T", "--threads", type=int, default=1)
    p.add_argument("--test", action="store_true")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    wind = {"windType": args.windType}
    if args.windType == "coordinate":
        wind.update(windSize=args.windSize,
                    stepSize=args.stepSize or args.windSize)
    else:
        wind.update(windSize=args.windSize, overlap=args.overlap or 0,
                    maxDist=args.maxDist or np.inf)
    min_sites = args.minSites or args.windSize
    wind["minSites"] = min_sites
    min_per_ind = args.minPerInd if args.minPerInd else min_sites
    outgroup = args.outgroup.split(",") if args.outgroup else []

    from ..parallel import multihost
    multihost.maybe_initialize()

    src = args.genoFile if args.genoFile else sys.stdin
    probe = geno_io.GenoReader(src, geno_format="phased")
    names = args.individuals.split(",") if args.individuals \
        else list(probe.file_ind_names)
    sd = SampleData(ind_names=names, ploidy={n: 2 for n in names})
    reader = geno_io.rebind_reader(probe, sd)
    model = reader.model
    hap_names = model.row_names
    non_out_rows = np.array([i for i, s in enumerate(model.row_sample)
                             if s not in outgroup], dtype=np.int64)

    heads = ["scaffold", "start", "end", "mid", "sites"]
    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # scaffold-sharded tree inference (same layout as phyml): each
        # process infers the windows of the scaffolds it owns; data and
        # tree rows gather to process-0 writers in matching per-scaffold
        # order
        mh_data = multihost.MultiHostWriter()
        mh_trees = multihost.MultiHostWriter()
        data_file = trees_file = None
    else:
        mh_data = mh_trees = None
        data_file = open(args.prefix + ".data.tsv", "wt")
        data_file.write("\t".join(heads) + "\n")
        trees_file = gzip.open(args.prefix + ".trees.gz", "wt")
    use_builtin = args.raxml == "builtin-nj"
    tmp_dir = args.tmp or "."

    def compute_window(aln, scaf, start, end):
        if use_builtin:
            return nj_window_tree(aln, hap_names,
                                  correct=args.njCorrect) + "\n"
        prefix = f"{scaf}_{start}_{end}_"
        return rax_tree(codes_to_rows(aln), hap_names, args.model,
                        args.raxml, outgroup or None, prefix,
                        tmp_dir=tmp_dir, test=args.test, log=args.log)

    def write_result(scaf, start, end, mid, n_sites, tree):
        row = "\t".join([scaf, str(start), str(end), mid,
                         str(n_sites)]) + "\n"
        tree = tree if tree.endswith("\n") else tree + "\n"
        if mh_data is not None:
            mh_data.write_row(scaf, row)
            mh_trees.write_row(scaf, tree)
        else:
            data_file.write(row)
            trees_file.write(tree)

    # -T worker pool with an ordered bounded reorder queue (the reference's
    # raxml script has the same worker/sorter architecture,
    # raxml_sliding_windows.py:47-65)
    from ..parallel.hostpool import OrderedPool
    pool = OrderedPool(max(1, args.threads),
                       lambda meta, res: write_result(*meta, res))

    # stream flush batches (O(flush) memory; subprocess work per window)
    from .. import engine
    for batch in engine.stream_windows(
            reader, wind,
            include=common.read_scaffold_list(args.include),
            exclude=common.read_scaffold_list(args.exclude),
            scaffold_pred=shard_pred):
        plan = batch.plan
        mids = plan.mid(batch.positions)
        for w in range(plan.n_windows):
            f, l = int(plan.first[w]), int(plan.last[w])
            n_sites = l - f
            scaf = batch.scaffold_names[int(plan.scaffold_id[w])]
            if wind["windType"] == "coordinate":
                start, end = int(plan.start[w]), int(plan.end[w])
            else:
                start = int(batch.positions[f])
                end = int(batch.positions[l - 1])
            mid = "nan" if np.isnan(mids[w]) else str(int(mids[w]))
            ok = False
            if n_sites >= min_sites:
                aln = batch.alleles[:, f:l]
                sites_per_ind = (aln >= 0).sum(axis=1)
                ok = sites_per_ind.min() >= min_per_ind
                if ok and args.minSNPs is not None:
                    sub = aln[non_out_rows]
                    called = sub >= 0
                    has = called.any(axis=0)
                    ref = sub[np.argmax(called, axis=0),
                              np.arange(n_sites)]
                    var = int((((sub != ref[None, :]) & called).any(axis=0)
                               & has).sum())
                    ok = var >= args.minSNPs
            meta = (scaf, start, end, mid, n_sites)
            if ok:
                pool.submit(meta, compute_window, aln, scaf, start, end)
            else:
                pool.submit(meta, None, "NA\n")
    pool.close()
    if mh_data is not None:
        rank0 = multihost.process_index() == 0
        data_file = open(args.prefix + ".data.tsv", "wt") if rank0 else None
        mh_data.finish(data_file, "\t".join(heads) + "\n",
                       reader.scaffold_names)
        trees_file = gzip.open(args.prefix + ".trees.gz", "wt") \
            if rank0 else None
        mh_trees.finish(trees_file, "", reader.scaffold_names)
    if data_file is not None:
        data_file.close()
        trees_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
