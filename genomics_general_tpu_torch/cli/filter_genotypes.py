"""filterGenotypes on the GPU: geno -> geno filtering and transcoding.

The port of genomics_general_tpu/cli/filter_genotypes.py, with the same
flags and output bytes.  Mirrors the reference filterGenotypes.py: all
siteTest filters (minCalls, alleles, variant count/frequency, het
proportion, HWE, per-population calls/alleles, fixed and nearly-fixed
differences), thinning, sample subsetting and 7 output genotype formats
(GenomeSite.asList modes, genomics.py:500-541).

Replicated quirks:
* thinning state resets at every --podSize lines AND drops the first site of
  each scaffold (filterGenotypes.py:32,41-47);
* 'alleles' output without --alleleOrder prints python tuples (the reference
  str()s the tuple returned by asList);
* byFreq allele order breaks count ties by DESCENDING allele index
  (np.argsort ascending then [::-1], genomics.py:549-557).

Deviation: with mixed phase separators inside one genotype ("A|T/G") the
reference rewrites all separators to the second character; we do the same
per-sample using the first data line's separator.  Sites where the reference
would crash (partial genotypes under 'diplo'/HWE) are emitted as missing.

Each chunk makes two count calls (kernels/counts.py: K6 on the span wire,
K12 on the raw upload, the host counter under ``GGT_EXEC=host``): all rows,
then the populations.  The --HWE test runs per site on the host.
Multi-process runs (``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` /
``GGT_PROC_ID``, parallel/multihost) shard the input by scaffold and gather
the rows to process 0 every ``GGT_GATHER_SCAFS`` scaffolds, as freq does.
"""

from __future__ import annotations

import argparse
import os
import random
import string as _string
import sys

import numpy as np

from ..device import get_device
from ..io import geno as geno_io
from ..io import writers
from ..samples import SampleData
from ..stats import filters as F
from . import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="filterGenotypes")
    p.add_argument("-i", "--infile", action="store", required=False)
    p.add_argument("-o", "--outfile", action="store")
    p.add_argument("-t", "--threads", type=int, action="store", default=1)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("-if", "--inputGenoFormat", action="store",
                   choices=["phased", "diplo", "alleles"], default="phased")
    p.add_argument("-of", "--outputGenoFormat", action="store", default="phased",
                   choices=("phased", "diplo", "bases", "alleles",
                            "randomAllele", "coded", "count"))
    p.add_argument("--alleleOrder", action="store", default=None, choices=("freq",))
    p.add_argument("-s", "--samples", action="store")
    p.add_argument("--excludeSamples", action="store")
    p.add_argument("-p", "--pop", action="append", nargs="+")
    p.add_argument("--popsFile", action="store", required=False)
    p.add_argument("--keepAllSamples", action="store_true")
    p.add_argument("--ploidy", action="store", type=int, nargs="+")
    p.add_argument("--ploidyFile", action="store")
    p.add_argument("--forcePloidy", action="store_true")
    p.add_argument("--partialToMissing", action="store_true")
    p.add_argument("--include", nargs="+", action="store")
    p.add_argument("--includeFile", action="store")
    p.add_argument("--exclude", nargs="+", action="store")
    p.add_argument("--excludeFile", action="store")
    p.add_argument("--minCalls", type=int, action="store", default=1)
    p.add_argument("--minAlleles", type=int, action="store", default=1)
    p.add_argument("--maxAlleles", type=float, action="store", default=float("inf"))
    p.add_argument("--minVarCount", type=int, action="store", default=None)
    p.add_argument("--maxHet", type=float, action="store", default=None)
    p.add_argument("--minFreq", type=float, action="store", default=None)
    p.add_argument("--maxFreq", type=float, action="store", default=None)
    p.add_argument("--HWE", action="store", nargs=2)
    p.add_argument("--minPopCalls", nargs="+", action="store", type=int)
    p.add_argument("--minPopAlleles", nargs="+", action="store", type=int)
    p.add_argument("--maxPopAlleles", nargs="+", action="store", type=int)
    p.add_argument("--fixedDiffs", action="store_true")
    p.add_argument("--nearlyFixedDiff", action="store", type=float)
    p.add_argument("--thinDist", type=int, action="store")
    p.add_argument("--podSize", type=int, action="store", default=10000)
    p.add_argument("--noPrecomp", action="store_true")
    p.add_argument("--noTest", action="store_true")
    return p


BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
DIPLO_TABLE = {}
for _d, _p in zip(("A", "C", "G", "K", "M", "N", "S", "R", "T", "W", "Y"),
                  ("AA", "CC", "GG", "GT", "AC", "NN", "CG", "AG", "TT", "AT", "CT")):
    DIPLO_TABLE[_p] = _d


def _code_char(c: int) -> str:
    return "ACGT"[c] if c >= 0 else "N"


def byfreq_order(counts: np.ndarray) -> np.ndarray:
    """Per-site allele ranking (genomics.py:549-557), exact tie semantics.
    Returns [S, 4] of allele codes, -1 padding after the present ones."""
    from ..encoding import byfreq_allele_order
    return byfreq_allele_order(counts)


def main(argv=None) -> int:
    from ..parallel import multihost
    multihost.maybe_initialize()
    args = build_parser().parse_args(argv)
    get_device()                     # fail fast when the card is missing

    include = list(args.include) if args.include else []
    exclude = list(args.exclude) if args.exclude else []
    if args.includeFile:
        include += open(args.includeFile).read().split()
    if args.excludeFile:
        exclude += open(args.excludeFile).read().split()
    include = set(include) if include else None
    exclude = set(exclude) if exclude else None

    hwe_p = hwe_side = None
    if args.HWE:
        hwe_p = float(args.HWE[0])
        hwe_side = args.HWE[1]

    pop_dict: dict[str, list[str]] = {}
    pop_names: list[str] = []
    if args.pop:
        for pop in args.pop:
            pop_names.append(pop[0])
            pop_dict[pop[0]] = [] if len(pop) == 1 else pop[1].split(",")
        if args.popsFile:
            with open(args.popsFile, "rt") as pf:
                for line in pf:
                    parts = line.split()
                    if len(parts) >= 2 and parts[1] in pop_dict \
                            and parts[0] not in pop_dict[parts[1]]:
                        pop_dict[parts[1]].append(parts[0])

    def expand(vals, default):
        if not vals:
            return None
        v = list(vals)
        if len(v) == 1:
            v = v * len(pop_names)
        assert len(v) == len(pop_names)
        return dict(zip(pop_names, v))

    min_pop_calls = expand(args.minPopCalls, None)
    min_pop_alleles = expand(args.minPopAlleles, 0)
    max_pop_alleles = expand(args.maxPopAlleles, 4)

    # ---- header / sample selection (filterGenotypes.py:289-316)
    probe = geno_io.GenoReader(args.infile if args.infile else sys.stdin.buffer,
                               sample_data=None, geno_format=args.inputGenoFormat)
    all_samples = probe.file_ind_names
    samples = args.samples.split(",") if args.samples else None
    ex_samples = args.excludeSamples.split(",") if args.excludeSamples else []
    if samples is not None:
        for s in samples:
            assert s in all_samples, "Sample name not in header: " + s
    elif args.pop and not args.keepAllSamples:
        samples = [i for j in pop_dict.values() for i in j]
        assert len(set(samples)) == len(samples), \
            "Populations cannot share the same sample"
    else:
        samples = list(all_samples)
    samples = [s for s in samples if s not in ex_samples]
    if args.minCalls:
        assert args.minCalls <= len(samples), \
            "Minimum calls is greater than number of specified samples."
    for pn in pop_names:
        pop_dict[pn] = [s for s in pop_dict[pn] if s not in ex_samples]

    # ---- ploidy: default inferred from the first data line's field widths
    if args.ploidy is not None:
        pl = args.ploidy if len(args.ploidy) != 1 else args.ploidy * len(samples)
        assert len(pl) == len(samples)
        ploidy = dict(zip(samples, pl))
    elif args.ploidyFile is not None:
        with open(args.ploidyFile, "rt") as pf:
            ploidy = {s[0]: int(s[1]) for s in (l.split() for l in pf) if s}
    else:
        ploidy = {}

    sd = SampleData(ind_names=list(samples), pop_names=pop_names,
                    pop_inds=pop_dict, ploidy=dict(ploidy))
    if not ploidy:
        # infer from field widths after layout established: peek first chunk
        pass
    reader = geno_io.rebind_reader(probe, sd)
    first_chunk = None
    # infer ploidy from field widths if needed (reference infers per genotype
    # when no --ploidy is given; widths are uniform in well-formed files)
    if not ploidy:
        blob = reader._read_chunk_lines()
        if blob is not None:
            ln = geno_io.first_data_line(blob)
            if ln is not None:
                gts = ln.split()[2:]
                widths = {n: len(gts[k]) for k, n in enumerate(all_samples)}
                fmt = args.inputGenoFormat
                for s in samples:
                    w = widths[s]
                    sd.ploidy[s] = (w + 1) // 2 if fmt == "phased" else \
                        (2 if fmt == "diplo" else w)
            if reader._whole is not None:
                # whole-buffer (gz) input: restart the parse from the
                # probe's offset; nothing was physically consumed
                reader = geno_io.rebind_reader(probe, sd)
            else:
                # streamed input: rebind from the PEEKED reader (its
                # _tail/_eof reflect the consumed bytes — the probe's stale
                # _tail would re-parse the blob twice) and re-feed the blob
                peeked = reader
                reader = geno_io.rebind_reader(peeked, sd)
                first_chunk = reader.parse_chunk(blob)

    model = reader.model

    out_fmt = args.outputGenoFormat
    header_cols = ["#CHROM", "POS"]
    if out_fmt != "bases":
        head = "\t".join(header_cols + samples) + "\n"
    else:
        assert args.ploidy is not None or args.ploidyFile, "Ploidy must be specified."
        out_samples = [s + "_" + letter for s in samples
                       for letter in _string.ascii_uppercase[:sd.ploidy[s]]]
        head = "\t".join(header_cols + out_samples) + "\n"

    shard_pred = common.shard_predicate()
    if shard_pred is not None:
        # scaffold-sharded multi-process run: the analog of the reference's
        # line-pod -T pool (filterGenotypes.py:387-412).  Thinning state is
        # per-scaffold (lastScaf resets on scaffold change), so sharding by
        # scaffold preserves one-process output exactly.  randomAllele
        # draws come from each process's own RNG stream (the reference's
        # -T pods are equally nondeterministic there).
        assert not args.thinDist, \
            "--thinDist pod resets are absolute-line-indexed; thinning is " \
            "not supported in scaffold-sharded multi-host runs"
        # incremental gather (default every 8 scaffolds): process 0 writes
        # while the others still stream — peak buffered memory is
        # O(scaffold group), not O(output) (same wiring as freq).
        # GGT_GATHER_SCAFS=0 restores the single end-of-run gather.
        inc_every = int(os.environ.get("GGT_GATHER_SCAFS", "8"))
        mh_writer = multihost.MultiHostWriter(
            incremental_every=inc_every if inc_every > 0 else None,
            open_out=lambda: writers.open_out(args.outfile), header=head)
        out = None
    else:
        mh_writer = None
        out = writers.open_out(args.outfile)
        out.write(head)
    whole = reader
    reader, shard_pred = common.sharded_reader(
        args.infile, shard_pred, reader, sample_data=sd,
        geno_format=args.inputGenoFormat)
    if reader is not whole:
        # the indexed stream serves everything from the start: the ploidy
        # peek above already derived what it needed, and its first chunk
        # is dropped
        model = reader.model
        first_chunk = None

    # ---- per-chunk streaming filter (O(chunk) memory; everything below is
    # sitewise except thinning, whose (lastScaf, lastPos, absolute line
    # index) state carries across chunks — pod resets are absolute)
    from ..kernels import counts as counts_k
    n_ind = len(samples)
    ind_rows = [model.ind_order[j] for j in range(n_ind)]

    # per-sample phase separators; phased input keeps each genotype's
    # separator in the reference (geno[1]) — we use the first data line's
    # separator per sample (uniform-separator files are identical)
    phase = {s: ("|" if args.inputGenoFormat == "phased" and sd.ploidy[s] > 1
                 else "/") for s in samples}
    if pop_names:
        pm = np.zeros((len(pop_names), model.n_rows), np.float32)
        for k, pn in enumerate(pop_names):
            pm[k, model.pop_row_indices[pn]] = 1.0
        sample_idx = {s: j for j, s in enumerate(samples)}

    thin_state = {"abs": 0, "last_scaf": -1, "last_pos": None}

    def process_chunk(alleles, positions, scaffold_ids):
        S = positions.shape[0]
        scaf_names = np.array(reader.scaffold_names, dtype=object)

        keep_ie = np.ones(S, dtype=bool)
        if include is not None:
            keep_ie &= np.isin(scaf_names[scaffold_ids], list(include))
        if exclude is not None:
            keep_ie &= ~np.isin(scaf_names[scaffold_ids], list(exclude))
        keep = keep_ie.copy()

        full_mask = np.ones((1, model.n_rows), np.float32)
        counts_all = counts_k.site_pop_counts_chunked(alleles, full_mask)[:, 0, :]

        ind_nonmissing = np.ones((S, n_ind), dtype=bool)
        ind_het = np.zeros((S, n_ind), dtype=bool)
        for j in range(n_ind):
            rows = ind_rows[j]
            sub = alleles[rows, :]
            ind_nonmissing[:, j] = (sub >= 0).all(axis=0)
            if rows.size > 1:
                ind_het[:, j] = (sub != sub[0:1, :]).any(axis=0)

        pop_counts = None
        pop_ind_nm = None
        if pop_names:
            pc = counts_k.site_pop_counts_chunked(alleles, pm)
            pop_counts = {pn: pc[:, k, :] for k, pn in enumerate(pop_names)}
            pop_ind_nm = {pn: ind_nonmissing[:, [sample_idx[s] for s in pop_dict[pn]]]
                          for pn in pop_names}

        if not args.noTest:
            keep &= F.site_test_masks(
                counts_all, ind_nonmissing, ind_het, pop_counts, pop_ind_nm,
                min_calls=args.minCalls, min_pop_calls=min_pop_calls,
                min_alleles=args.minAlleles, max_alleles=args.maxAlleles,
                min_pop_alleles=min_pop_alleles, max_pop_alleles=max_pop_alleles,
                min_var_count=args.minVarCount, max_het=args.maxHet,
                min_freq=args.minFreq, max_freq=args.maxFreq,
                fixed=args.fixedDiffs, nearly_fixed_diff=args.nearlyFixedDiff)

            # HWE: the reference's `site.pops is not {}` is always True, so
            # the filter only ever checks named pops and is a NO-OP without
            # -p (siteTest, genomics.py:763-769)
            if hwe_p is not None and pop_names:
                n_alleles = (counts_all > 0).sum(axis=1)
                for s in np.flatnonzero(keep & (n_alleles > 1)):
                    ok = True
                    for g in pop_names:
                        idx = [samples.index(x) for x in pop_dict[g]]
                        codes = np.stack([alleles[ind_rows[j], s] for j in idx])
                        if codes.shape[1] != 2:
                            continue
                        if not F.in_hwe_site(codes, hwe_p, hwe_side):
                            ok = False
                            break
                    if not ok:
                        keep[s] = False

        # ---- thinning (sequential; pod-reset quirk replicated).  Reference
        # order per line: scaffold-change always updates lastScaf/lastPos; a
        # site advances lastPos only when it passes BOTH thinning and
        # siteTest (filterGenotypes.py:41-55).
        if args.thinDist:
            thin_keep = np.zeros(S, dtype=bool)
            pod = args.podSize
            abs0 = thin_state["abs"]
            last_scaf = thin_state["last_scaf"]
            last_pos = thin_state["last_pos"]
            for s in range(S):
                if (abs0 + s) % pod == 0:
                    last_scaf = -1
                if not keep_ie[s]:
                    continue
                if scaffold_ids[s] != last_scaf:
                    last_pos = positions[s]
                    last_scaf = scaffold_ids[s]
                    continue
                if positions[s] - last_pos < args.thinDist:
                    continue
                if keep[s]:
                    thin_keep[s] = True
                    last_pos = positions[s]
            thin_state["abs"] = abs0 + S
            thin_state["last_scaf"] = last_scaf
            thin_state["last_pos"] = last_pos
            keep &= thin_keep

        kept = np.flatnonzero(keep)

        # ---- output assembly
        ranked = None
        if args.alleleOrder == "freq" or out_fmt in ("coded", "count"):
            ranked = byfreq_order(counts_all)

        def fields_for_site(s: int) -> list[str]:
            outf = []
            if out_fmt in ("coded", "count"):
                ralleles = [int(a) for a in ranked[s] if a >= 0]
            for j, name in enumerate(samples):
                codes = alleles[ind_rows[j], s]
                chars = [_code_char(int(c)) for c in codes]
                if out_fmt == "phased":
                    outf.append(phase[name].join(chars))
                elif out_fmt == "diplo":
                    pair = "".join(sorted(chars))
                    outf.append(DIPLO_TABLE.get(pair, "N"))
                elif out_fmt == "bases":
                    if args.alleleOrder == "freq":
                        order = {int(a): k for k, a in enumerate(ranked[s]) if a >= 0}
                        order[-1] = 99
                        chars = [c for _, c in sorted(
                            zip([order.get(int(x), 99) for x in codes], chars),
                            key=lambda t: t[0])]
                    outf.extend(chars)
                elif out_fmt == "alleles":
                    if args.alleleOrder == "freq":
                        order = {int(a): k for k, a in enumerate(ranked[s]) if a >= 0}
                        order[-1] = 99
                        outf.append("".join(c for _, c in sorted(
                            zip([order.get(int(x), 99) for x in codes], chars),
                            key=lambda t: t[0])))
                    else:
                        outf.append(str(tuple(chars)))
                elif out_fmt == "randomAllele":
                    outf.append(chars[0] if len(chars) == 1
                                else random.sample(chars, 1)[0])
                elif out_fmt == "coded":
                    code = {a: str(k) for k, a in enumerate(ralleles)}
                    if any(int(c) < 0 for c in codes):
                        outf.append(phase[name].join(["."] * len(codes)))
                    else:
                        outf.append(phase[name].join(code[int(c)] for c in codes))
                elif out_fmt == "count":
                    if not ralleles:
                        outf.append("-1")
                    elif any(int(c) < 0 for c in codes):
                        outf.append("-1")
                    else:
                        ca = ralleles[-1]
                        outf.append(str(int((codes == ca).sum())))
            return outf

        scafs_of = scaf_names[scaffold_ids]

        def flush(buf, buf_sids):
            if not buf:
                return
            if mh_writer is None:
                out.write("".join(buf))
                return
            sids_arr = np.asarray(buf_sids)
            bounds = np.concatenate(
                [[0], np.flatnonzero(sids_arr[1:] != sids_arr[:-1]) + 1,
                 [len(buf)]])
            for a, b in zip(bounds[:-1], bounds[1:]):
                mh_writer.write_row(reader.scaffold_names[sids_arr[a]],
                                    "".join(buf[a:b]))

        buf = []
        buf_sids = []
        for s in kept:
            buf.append(scafs_of[s] + "\t" + str(int(positions[s])) + "\t"
                       + "\t".join(fields_for_site(int(s))) + "\n")
            buf_sids.append(scaffold_ids[s])
            if len(buf) >= 10000:
                flush(buf, buf_sids)
                buf, buf_sids = [], []
        flush(buf, buf_sids)

    from .. import engine as _engine
    progress = _engine.Progress(args.verbose)

    def all_chunks():
        if first_chunk is not None:
            yield first_chunk
        yield from reader.iter_chunks()

    for chunk in _engine._prefetched(all_chunks()):
        a, pos, sids = chunk.alleles, chunk.positions, chunk.scaffold_ids
        # global stream frontier BEFORE shard filtering: every process
        # observes the same scaffold sequence, so incremental gather rounds
        # trigger identically everywhere
        frontier = int(sids[-1]) if sids.size else None
        if shard_pred is not None:
            owned = np.array([shard_pred(n)
                              for n in reader.scaffold_names], dtype=bool)
            keep = owned[sids]
            if not keep.all():
                a, pos, sids = a[:, keep], pos[keep], sids[keep]
        if pos.size:
            process_chunk(a, pos, sids)
            progress.update(sites=pos.shape[0])
        if mh_writer is not None and frontier is not None:
            mh_writer.maybe_gather(frontier, reader.scaffold_names)

    if mh_writer is not None:
        # flush all remaining incremental rounds BEFORE finish: with
        # indexed (subset) input streams processes end at different
        # frontiers (a process owning nothing never saw a chunk), and the
        # collective call counts must match everywhere
        mh_writer.maybe_gather(len(reader.scaffold_names),
                               reader.scaffold_names)
        if multihost.process_index() == 0 and not mh_writer.incr:
            out = writers.open_out(args.outfile)
        out = mh_writer.finish(out, head, reader.scaffold_names)
        if os.environ.get("GGT_GATHER_DEBUG"):
            sys.stderr.write(
                f"[gather] rank {multihost.process_index()} peak buffered "
                f"{mh_writer.peak_buffered} B\n")
    if args.outfile and out is not None:
        out.close()
    progress.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
