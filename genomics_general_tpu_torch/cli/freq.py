"""freq on the GPU: per-site per-population base counts / allele frequencies.

The port of genomics_general_tpu/cli/freq.py, with the same flags and output
bytes.  Mirrors the reference freq.py (worker :32-113): default mode emits
4-base counts per population per site ("a,c,g,t"); ``--target derived``
emits the derived-allele frequency polarized on the LAST population
(freq.py:64-66, derivedAllele genomics.py:636-661); ``--target minor`` uses
the minor allele with the reference's random tie-break (genomics.py:663-668
— unseeded np.random, so ties are inherently nondeterministic; the draws
come in the JAX CLI's order).

Reference forcing rules (freq.py:303-305): without a target, asCounts=True,
keepNanLines=True, minData=0.  With a target, --minData is an absolute
non-missing-haplotype COUNT per population (freq.py:83).

The counts mode formats rows in one C pass over each parsed chunk
(io/native.freq_counts_rows), as the JAX CLI does; ``GGT_HOST_FREQ_ROWS=0``
and every ``--target`` count through kernels/counts.py (K6 on the span
wire, K12 on the raw upload, the host counter under ``GGT_EXEC=host``).
Multi-process runs (``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` /
``GGT_PROC_ID``, parallel/multihost) shard the input by scaffold and gather
the rows to process 0 every ``GGT_GATHER_SCAFS`` scaffolds (default 8; 0
gathers once at the end).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import engine as _engine
from ..device import get_device
from ..io import geno as geno_io
from ..io import native
from ..io import writers
from ..kernels import counts as counts_k
from ..samples import SampleData
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="freq")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("-f", "--genoFormat", action="store",
                   choices=("phased", "diplo", "alleles"), default="phased")
    p.add_argument("-p", "--population", required=False, action="append",
                   nargs="+", metavar=("popName", "[samples]"))
    p.add_argument("--popsFile", action="store", required=False)
    p.add_argument("--indFreqs", action="store_true")
    p.add_argument("--target", choices=("minor", "derived"), action="store",
                   default=None)
    p.add_argument("--asCounts", action="store_true")
    p.add_argument("--ploidy", action="store", type=int, nargs="+")
    p.add_argument("--ploidyFile", action="store")
    p.add_argument("--haploid", action="store", nargs="+")
    p.add_argument("--minData", type=float, action="store", default=0)
    p.add_argument("--threshold", type=float, action="store")
    p.add_argument("--keepNanLines", action="store_true")
    p.add_argument("-t", "--threads", type=int, action="store", default=1)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--test", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="report per-stage wall-clock timing on stderr")
    return p


def derived_allele_codes(in_counts: np.ndarray, out_counts: np.ndarray) -> np.ndarray:
    """Vectorized reference derivedAllele (genomics.py:636-661) with
    maxOneDerivedAllele=True, numeric=True: requires exactly 1 outgroup
    allele, exactly 2 ingroup alleles, outgroup allele among them; returns
    the other ingroup allele code, else NaN."""
    in_present = in_counts > 0
    out_present = out_counts > 0
    n_in = in_present.sum(axis=1)
    n_out = out_present.sum(axis=1)
    anc = np.argmax(out_present, axis=1)
    rows = np.arange(in_counts.shape[0])
    ok = (n_out == 1) & (n_in == 2) & in_present[rows, anc]
    # the "other" ingroup allele: mask out anc, take argmax of remaining
    masked = in_present.copy()
    masked[rows, anc] = False
    der = np.argmax(masked, axis=1)
    out = np.where(ok, der.astype(np.float64), np.nan)
    return out


def minor_allele_codes(counts: np.ndarray) -> np.ndarray:
    """Reference minorAllele (genomics.py:663-668): for biallelic sites,
    the less-common allele; frequency ties broken by np.random.choice."""
    present = counts > 0
    n_all = present.sum(axis=1)
    out = np.full(counts.shape[0], np.nan)
    for s in np.flatnonzero(n_all == 2):
        alleles = np.flatnonzero(present[s])
        cnts = counts[s, alleles]
        mins = alleles[cnts == cnts.min()]
        out[s] = np.random.choice(mins)
    return out


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    get_device()                     # fail fast when the card is missing

    # ---- populations (freq.py:243-274); the header must be read first to
    # resolve default populations
    pop_names: list[str] = []
    pop_inds: dict[str, list[str]] = {}
    tmp_reader = geno_io.GenoReader(
        args.genoFile if args.genoFile else sys.stdin.buffer,
        sample_data=None, geno_format=args.genoFormat)
    header_inds = tmp_reader.file_ind_names

    if not args.indFreqs and not args.population:
        if args.target == "derived":
            print("\nNo populations specified. Assuming the final individual "
                  "is the outgroup for polarising.", file=sys.stderr)
            pop_names = ["ingroup", "outgroup"]
            pop_inds = {"ingroup": header_inds[:-1],
                        "outgroup": [header_inds[-1]]}
        else:
            pop_names = ["all"]
            pop_inds = {"all": list(header_inds)}
    elif args.indFreqs:
        pop_names = list(header_inds)
        pop_inds = {ind: [ind] for ind in header_inds}
    else:
        for p in args.population:
            pop_names.append(p[0])
            pop_inds[p[0]] = p[1].split(",") if len(p) > 1 else []
        if args.popsFile:
            with open(args.popsFile, "rt") as pf:
                for ln in pf:
                    parts = ln.split()
                    if len(parts) >= 2 and parts[1] in pop_inds \
                            and parts[0] not in pop_inds[parts[1]]:
                        pop_inds[parts[1]].append(parts[0])
        for n in pop_names:
            assert len(pop_inds[n]) >= 1, \
                "All populations must be represented by at least one sample."

    all_inds = []
    seen = set()
    for n in pop_names:
        for i in pop_inds[n]:
            if i not in seen:
                seen.add(i)
                all_inds.append(i)

    if args.ploidy is not None:
        pl = args.ploidy if len(args.ploidy) != 1 else args.ploidy * len(all_inds)
        assert len(pl) == len(all_inds), "Incorrect number of ploidy values supplied."
        ploidy = dict(zip(all_inds, pl))
    elif args.ploidyFile is not None:
        with open(args.ploidyFile, "rt") as pf:
            ploidy = {s[0]: int(s[1]) for s in (l.split() for l in pf) if s}
    else:
        ploidy = {i: 2 for i in all_inds}
    for ind in (args.haploid or []):
        ploidy[ind] = 1

    sd = SampleData(ind_names=all_inds, pop_names=pop_names,
                    pop_inds=pop_inds, ploidy=ploidy)
    reader = geno_io.rebind_reader(tmp_reader, sd)

    as_counts = args.asCounts if args.target else True
    keep_nan_lines = args.keepNanLines if args.target else True
    min_data = args.minData if args.target else 0

    head = "scaffold\tposition\t" + "\t".join(pop_names) + "\n"
    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # scaffold-sharded parse + process-0 ordered writer: the analog of
        # the reference's fileSlicer -T pool (freq.py:23-27, 315-350);
        # per-site rows buffer per scaffold (zlib segments) and gather in
        # rounds
        # incremental gather (default every 8 scaffolds): process 0 writes
        # while the others still stream — peak buffered memory is
        # O(scaffold group), not O(output), which matters for this per-site
        # output.  GGT_GATHER_SCAFS=0 restores the single end-of-run gather.
        inc_every = int(os.environ.get("GGT_GATHER_SCAFS", "8"))
        mh_writer = multihost.MultiHostWriter(
            incremental_every=inc_every if inc_every > 0 else None,
            open_out=lambda: writers.open_out(args.outFile), header=head)
        out = None
    else:
        mh_writer = None
        out = writers.open_out(args.outFile)
        out.write(head)
    reader, shard_pred = common.sharded_reader(
        args.genoFile, shard_pred, reader, sample_data=sd,
        geno_format=args.genoFormat)
    model = reader.model

    # ---- device counts: one mask per pop (+ingroup union for derived,
    # +all-rows union for multi-pop minor)
    P = len(pop_names)
    minor_all_rows = (args.target == "minor" and not args.indFreqs
                      and len(pop_names) >= 2)
    n_masks = P + (1 if args.target == "derived" else 0) \
        + (1 if minor_all_rows else 0)
    mask = np.zeros((n_masks, model.n_rows), dtype=np.float32)
    for k, n in enumerate(pop_names):
        mask[k, model.pop_row_indices[n]] = 1.0
    if args.target == "derived":
        in_rows = np.unique(np.concatenate(
            [model.pop_row_indices[n] for n in pop_names[:-1]]))
        mask[P, in_rows] = 1.0
    if minor_all_rows:
        # reference uses aln = ALL rows; sum of pop counts would count
        # shared individuals twice
        mask[-1, :] = 1.0

    progress = _engine.Progress(args.verbose)

    def emit(row_sids, lines):
        """Write formatted lines: directly (one process) or buffered per
        scaffold run for the process-0 gather (multi-process)."""
        if not lines:
            return
        if mh_writer is None:
            out.write("".join(lines))
            return
        row_sids = np.asarray(row_sids)
        bounds = np.concatenate(
            [[0], np.flatnonzero(row_sids[1:] != row_sids[:-1]) + 1,
             [len(lines)]])
        for a, b in zip(bounds[:-1], bounds[1:]):
            mh_writer.write_row(reader.scaffold_names[row_sids[a]],
                                "".join(lines[a:b]))

    # counts mode, one process: fused C count+format (io/native.
    # freq_counts_rows), as the JAX CLI does.  The per-site counts ARE the
    # output here, and the C pass over the parsed chunk replaces both the
    # count fetch and the per-row Python string assembly.  Binary writes
    # bypass the text wrapper.
    use_c_rows = (not args.target and mh_writer is None
                  and os.environ.get("GGT_HOST_FREQ_ROWS") != "0")
    c_out = getattr(out, "buffer", None) if use_c_rows else None
    if c_out is not None:
        out.flush()          # the header must precede the raw binary writes
    pop_row_lists = [model.pop_row_indices[n] for n in pop_names] \
        if use_c_rows else None

    def c_process_block(alleles, scaffold_ids, positions):
        S = positions.shape[0]
        bnd = np.concatenate(
            [[0], np.flatnonzero(scaffold_ids[1:] != scaffold_ids[:-1]) + 1,
             [S]])
        run_names = [reader.scaffold_names[scaffold_ids[a]].encode()
                     for a in bnd[:-1]]
        writer = c_out.write if c_out is not None \
            else (lambda b: out.write(b.decode("ascii")))
        if not native.freq_counts_rows(alleles, pop_row_lists, positions,
                                       run_names, bnd, writer):
            return None
        return S

    def process_block(alleles, scaffold_ids, positions):
        """Per-site processing of one parsed chunk (everything here is
        sitewise, so streaming chunk-by-chunk preserves output exactly)."""
        if use_c_rows:
            done = c_process_block(alleles, scaffold_ids, positions)
            if done is not None:
                return done
        counts = counts_k.site_pop_counts_chunked(alleles, mask)  # [S,n_masks,4]
        S = counts.shape[0]
        scaf_names = np.array(reader.scaffold_names, dtype=object)
        scafs = scaf_names[scaffold_ids].tolist() if S else []
        pos_strs = [str(p) for p in positions.tolist()]

        if not args.target:
            # counts mode: "a,c,g,t" per pop (freq.py:52-60).  Formatting is
            # the hot loop at genome scale: pack the 4 counts into one u32,
            # format only the unique packings, and fancy-index the strings
            # back (typically 10-100x fewer formats than sites x pops).
            c4 = counts[:, :P, :]
            if c4.size and int(c4.max()) <= 255:
                packed = (c4[:, :, 0].astype(np.uint32) << 24
                          | c4[:, :, 1].astype(np.uint32) << 16
                          | c4[:, :, 2].astype(np.uint32) << 8
                          | c4[:, :, 3].astype(np.uint32))
                uniq, inv = np.unique(packed, return_inverse=True)
                fmt = np.array(
                    [f"{u >> 24},{(u >> 16) & 255},{(u >> 8) & 255},{u & 255}"
                     for u in uniq], dtype=object)
                cmat = fmt[inv.reshape(S, P)]
                cols = [cmat[:, k] for k in range(P)]
            else:
                cols = []
                for k in range(P):
                    c = c4[:, k, :].astype(str)
                    cols.append([",".join(r) for r in c])
            lines = ["\t".join(t) + "\n"
                     for t in zip(scafs, pos_strs, *cols)]
            emit(scaffold_ids, lines)
            return S

        if args.target == "derived":
            base_col = derived_allele_codes(counts[:, P, :],
                                            counts[:, P - 1, :])
        else:
            total = counts[:, -1, :] if minor_all_rows \
                else counts[:, :P, :].sum(axis=1)
            base_col = minor_allele_codes(total)
        good_sites_mask = ~np.isnan(base_col)

        pop_vals = np.zeros((S, P)) if as_counts else np.full((S, P), np.nan)
        if as_counts:
            pop_vals = pop_vals.astype(int)
        for k in range(P):
            c = counts[:, k, :]
            nm = c.sum(axis=1)
            good = good_sites_mask & (nm >= min_data)
            idx = np.flatnonzero(good)
            if idx.size:
                tgt = base_col[idx].astype(int)
                if as_counts:
                    pop_vals[idx, k] = c[idx, tgt]
                else:
                    with np.errstate(invalid="ignore", divide="ignore"):
                        freqs = c[idx].astype(np.float64) / nm[idx, None]
                        freqs[nm[idx] == 0] = np.nan
                    pop_vals[idx, k] = np.around(freqs[np.arange(idx.size), tgt], 4)
        if args.threshold and not as_counts:
            pop_vals[pop_vals >= args.threshold] = 1
            pop_vals[pop_vals < args.threshold] = 0

        if not keep_nan_lines:
            if not as_counts:
                rows_out = np.flatnonzero(~np.all(np.isnan(pop_vals), axis=1))
            else:
                rows_out = np.flatnonzero(~np.all(pop_vals == 0, axis=1))
        else:
            rows_out = np.arange(S)
        sel = pop_vals[rows_out]
        if sel.dtype.kind == "f" and sel.size:
            # unique-on-bits: format each distinct float64 once (freqs round
            # to 4 dp, so there are at most ~10k distinct values); exact,
            # NaN-safe (single propagated bit pattern)
            bits = np.ascontiguousarray(sel).view(np.uint64)
            uq, inv = np.unique(bits, return_inverse=True)
            fm = np.array([str(x) for x in uq.view(np.float64)], dtype=object)
            vals_str = fm[inv.reshape(sel.shape)]
        elif sel.size:
            lut = np.array([str(i) for i in range(int(sel.max()) + 1)],
                           dtype=object)
            vals_str = lut[sel]
        else:
            vals_str = sel.astype(str)
        lines = ["\t".join(t) + "\n"
                 for t in zip((scafs[s] for s in rows_out),
                              (pos_strs[s] for s in rows_out),
                              *vals_str.T)]
        emit(scaffold_ids[rows_out], lines)
        return S

    # --test mirrors the reference's 10-slice smoke run (freq.py:222,
    # 361-365: 10 x 1 MB fileSlicer slices)
    test_sites_left = (10 * 1_000_000) // max(reader.model.n_rows * 2, 1) \
        if args.test else None
    timer = _engine.StageTimer(args.profile)

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

    for chunk in _engine._prefetched(_timed_chunks()):
        a, sids, pos = chunk.alleles, chunk.scaffold_ids, chunk.positions
        # global stream frontier BEFORE shard filtering: every process
        # observes the same scaffold sequence, so incremental gather rounds
        # trigger identically everywhere
        frontier = int(sids[-1]) if sids.size else None
        if test_sites_left is not None:
            if test_sites_left <= 0:
                break
            a = a[:, :test_sites_left]
            sids = sids[:test_sites_left]
            pos = pos[:test_sites_left]
            test_sites_left -= pos.size
        if shard_pred is not None:
            owned = np.array([shard_pred(n)
                              for n in reader.scaffold_names], dtype=bool)
            keep = owned[sids]
            if not keep.all():
                a, sids, pos = a[:, keep], sids[keep], pos[keep]
        if pos.size:
            with timer.stage("rows"):
                done = process_block(a, sids, pos)
            progress.update(sites=done, rows=done)
        if mh_writer is not None and frontier is not None:
            mh_writer.maybe_gather(frontier, reader.scaffold_names)

    if mh_writer is not None:
        # flush all remaining incremental rounds BEFORE finish: with
        # indexed (subset) input streams processes end at different
        # frontiers, and the collective call counts must match everywhere
        mh_writer.maybe_gather(len(reader.scaffold_names),
                               reader.scaffold_names)
        if multihost.process_index() == 0 and not mh_writer.incr:
            out = writers.open_out(args.outFile)
        out = mh_writer.finish(out, head, reader.scaffold_names)
        if os.environ.get("GGT_GATHER_DEBUG"):
            sys.stderr.write(
                f"[gather] rank {multihost.process_index()} peak buffered "
                f"{mh_writer.peak_buffered} B\n")
    if args.outFile and out is not None:
        out.close()
    progress.close()
    timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
