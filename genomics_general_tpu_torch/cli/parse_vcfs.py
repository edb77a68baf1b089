"""Multi-VCF -> geno conversion with positional merging.

The port of genomics_general_tpu/cli/parse_vcfs.py, with the same flags and
output bytes; it launches no kernel.

Mirror of VCF_processing/parseVCFs.py: walks each scaffold
(from --fai or the first VCF's ##contig headers) position by position and
merges sites across input VCFs with all/union/intersect methods, filling
per-sample "N/N"-style missing genotypes for absent files
(parseVCFs.py:37-89, 292-305).

Differences (all of them fixes for reference defects, noted per item):

* region extraction does not shell out to ``tabix``; inputs are streamed
  once in sorted order (the reference re-extracts every 100 kb chunk per
  file, parseVCFs.py:27-46).  Positions with no data are skipped directly
  for union/intersect instead of iterating every genome position.
* a site that fails --minQual, or a duplicated position, advances the
  stream; in the reference the stalled head blocks all later sites of that
  file's chunk (parseVCFs.py:66-79), silently dropping them.
* --maxREFlen and --field crash the reference here (undefined ``vcfSite``,
  parseVCFs.py:69-71); both work in this implementation.

Single-file ``--method union`` output is byte-identical to reference
``parseVCF.py --excludeDuplicates`` output (see tests/test_parse_vcfs.py).
"""

from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from ..io import vcf as V
from ..io.geno import open_maybe_gz
from ..io.writers import open_gz_out, open_out
from .parse_vcf import add_args, parse_include_exclude

INF = float("inf")


def _fast_single(args, head_data, samples_per_file, ploidy_dict, gt_filters,
                 include, exclude, scafs, scaf_lens) -> bool:
    """Single-file fast path: the C line converter + ``-t`` chunk pool
    (io/vcf_fast).  A one-file union/intersect walk is exactly parseVCF with
    the stale-drop semantics (duplicate and backwards positions dropped,
    QUAL/REFlen failures skip the row), plus the contig-list gates: rows of
    scaffolds absent from the contig list, past the declared length, or of
    finished (re-appearing) scaffolds are dropped."""
    import os

    from ..io import vcf_fast

    if len(args.inFile) != 1 or args.method == "all" or args.test:
        return False
    if os.environ.get("GGT_HOST_VCF") == "0":
        return False
    reason = vcf_fast.ineligible_reason(args, gt_filters, 0)
    if reason is not None:
        vcf_fast.notice_fallback("parseVCFs", reason)
        return False
    head = head_data[0]
    samples = samples_per_file[0]
    if head["nSamples"] > 1024:
        vcf_fast.notice_fallback(
            "parseVCFs", f"{head['nSamples']} samples > 1024")
        return False

    opts = vcf_fast.make_opts(args, gt_filters, head["sampleNames"],
                              samples, ploidy_dict)
    opts.sorted_drop = True
    opts.drop_dups = False

    if args.outFile:
        out_bin = open_gz_out(args.outFile, "wb") \
            if args.outFile.endswith(".gz") else open(args.outFile, "wb")
    else:
        out_bin = sys.stdout.buffer
    out_bin.write((args.outSep.join(["#CHROM", "POS"] + samples)
                   + "\n").encode())

    contig_idx = {s: i for i, s in enumerate(scafs)}
    state = {"cur": -1}
    sep = opts.out_sep

    def emit_run(name, data):
        nm = name.decode()
        if nm not in contig_idx:
            return
        if (exclude and nm in exclude) or (include and nm not in include):
            return
        i = contig_idx[nm]
        if i < state["cur"]:
            return                       # finished scaffold re-appeared
        state["cur"] = i
        length = scaf_lens.get(nm)
        if length is not None:
            last = data.rstrip(b"\n").rsplit(b"\n", 1)[-1]
            if int(last.split(sep, 2)[1]) > length:
                keep = []
                for r in data.split(b"\n"):
                    if not r:
                        continue
                    if int(r.split(sep, 2)[1]) > length:
                        break            # rows are strictly increasing
                    keep.append(r)
                if not keep:
                    return
                data = b"\n".join(keep) + b"\n"
        out_bin.write(data)

    headers = head["mainHeaders"]

    def slow_line(line, prev_name, prev_pos, prev_ptext=None):
        # the positional walk compares POS as integers (the merge iterates
        # genome positions), so no raw-text carry is needed here
        elements = line.decode().split()
        chrom, pos = elements[0], int(elements[1])
        name_b = chrom.encode()
        if prev_name == name_b and pos <= prev_pos:
            return None, prev_name, prev_pos, None   # stale/duplicate
        site = V.VcfSite(elements=elements, headers=headers)
        if args.minQual and V.can_float(site.QUAL) and \
                float(site.QUAL) < args.minQual:
            return None, name_b, pos, None
        if args.maxREFlen and len(site.REF) > args.maxREFlen:
            return None, name_b, pos, None
        output = site.getGenotypes(
            gt_filters, asList=True, withPhase=True, samples=samples,
            missing=args.missing, mustMatchREFlen=args.skipIndels,
            keepPartial=args.keepPartial, ploidyDict=ploidy_dict,
            ploidyMismatchToMissing=args.ploidyMismatchToMissing)
        row = (args.outSep.join([chrom, str(site.POS)] + output)
               + "\n").encode()
        return row, name_b, pos, None

    vcf_fast.convert_stream(vcf_fast.text_chunks(args.inFile[0]), opts,
                            slow_line, emit_run,
                            threads=max(1, args.threads))
    if out_bin is not sys.stdout.buffer:
        out_bin.close()
    return True


def _fast_multi(args, head_data, samples_per_file, ploidy_dict, gt_filters,
                include, exclude, scafs, scaf_lens, all_missing) -> bool:
    """Multi-file fast path: each input VCF converts through the C line
    converter on its own thread (with a per-file ``-t`` chunk pool), and
    the *converted* row runs k-way merge positionally in C — replacing the
    reference's per-line Python merge walk
    (VCF_processing/parseVCFs.py:60-87) while keeping its
    union/intersect semantics exactly.  An incremental per-scaffold
    frontier (the smallest last-complete position among files still
    producing that scaffold) keeps memory O(buffered runs), not
    O(scaffold).  Returns False to fall back to the serial Python walk."""
    import os
    import queue as _q
    import threading

    from ..io import native, vcf_fast

    if args.method == "all" or args.test:
        return False
    if os.environ.get("GGT_HOST_VCF") == "0":
        return False
    reason = vcf_fast.ineligible_reason(args, gt_filters, 0)
    if reason is not None:
        vcf_fast.notice_fallback("parseVCFs", reason)
        return False
    n = len(args.inFile)
    if n > 64:
        vcf_fast.notice_fallback("parseVCFs", f"{n} input files > 64")
        return False
    for head in head_data:
        if head["nSamples"] > 1024:
            vcf_fast.notice_fallback(
                "parseVCFs", f"{head['nSamples']} samples > 1024")
            return False
    if native.get_lib() is None or \
            not hasattr(native.get_lib(), "merge_geno_blocks"):
        return False

    INTERSECT = args.method == "intersect"
    sep = args.outSep.encode()
    miss_fill = [args.outSep.join(all_missing[x]).encode() for x in range(n)]
    contig_idx = {s: i for i, s in enumerate(scafs)}

    opts = []
    for x in range(n):
        o = vcf_fast.make_opts(args, gt_filters, head_data[x]["sampleNames"],
                               samples_per_file[x], ploidy_dict)
        o.sorted_drop = True
        o.drop_dups = False
        opts.append(o)

    def make_slow_line(x):
        headers = head_data[x]["mainHeaders"]
        samples = samples_per_file[x]

        def slow_line(line, prev_name, prev_pos, prev_ptext=None):
            elements = line.decode().split()
            chrom, pos = elements[0], int(elements[1])
            name_b = chrom.encode()
            if prev_name == name_b and pos <= prev_pos:
                return None, prev_name, prev_pos, None   # stale/duplicate
            site = V.VcfSite(elements=elements, headers=headers)
            if args.minQual and V.can_float(site.QUAL) and \
                    float(site.QUAL) < args.minQual:
                return None, name_b, pos, None
            if args.maxREFlen and len(site.REF) > args.maxREFlen:
                return None, name_b, pos, None
            output = site.getGenotypes(
                gt_filters, asList=True, withPhase=True, samples=samples,
                missing=args.missing, mustMatchREFlen=args.skipIndels,
                keepPartial=args.keepPartial, ploidyDict=ploidy_dict,
                ploidyMismatchToMissing=args.ploidyMismatchToMissing)
            row = (args.outSep.join([chrom, str(site.POS)] + output)
                   + "\n").encode()
            return row, name_b, pos, None
        return slow_line

    DONE = object()
    qs = [_q.Queue(maxsize=4) for _ in range(n)]
    # ONE shared converter pool across files: -t bounds the TOTAL C worker
    # count (per-file pools would oversubscribe the host n-fold and make
    # -t meaningless as a resource knob)
    from concurrent.futures import ThreadPoolExecutor
    shared_pool = ThreadPoolExecutor(max_workers=max(1, args.threads))

    def run_file(x):
        cur = {"i": -1}

        def emit_run(name, data):
            nm = name.decode()
            i = contig_idx.get(nm)
            if i is None or i < cur["i"]:
                return               # unknown or re-appearing scaffold
            cur["i"] = i
            if (exclude and nm in exclude) or (include and nm not in include):
                return
            qs[x].put((i, bytes(data)))
        try:
            vcf_fast.convert_stream(
                vcf_fast.text_chunks(args.inFile[x]), opts[x],
                make_slow_line(x), emit_run,
                threads=max(1, -(-args.threads // n)), pool=shared_pool)
            qs[x].put(DONE)
        except BaseException as e:  # noqa: BLE001 - re-raised by the merge
            qs[x].put(e)

    workers = [threading.Thread(target=run_file, args=(x,), daemon=True)
               for x in range(n)]

    if args.outFile:
        out_bin = open_gz_out(args.outFile, "wb") \
            if args.outFile.endswith(".gz") else open(args.outFile, "wb")
    else:
        out_bin = sys.stdout.buffer
    out_bin.write((args.outSep.join(
        ["#CHROM", "POS"] + [s for ss in samples_per_file for s in ss])
        + "\n").encode())

    for w in workers:
        w.start()

    # ---- per-file scaffold-grouped stream views
    def scaffold_stream(x):
        """Yield (scaf_i, data, final) with final=True marking the last
        piece of that scaffold (data may be empty)."""
        cur_i = None
        while True:
            item = qs[x].get()
            if isinstance(item, BaseException):
                raise item
            if item is DONE:
                if cur_i is not None:
                    yield (cur_i, b"", True)
                return
            i, data = item
            if cur_i is not None and i != cur_i:
                yield (cur_i, b"", True)
            cur_i = i
            yield (i, data, False)

    its = [scaffold_stream(x) for x in range(n)]
    # parts: list of byte chunks (joined once per merge call — repeated
    # bytes += would re-copy the whole buffer per 16 MB run)
    view = [{"i": None, "parts": [], "fin": False} for _ in range(n)]
    stash: list = [None] * n
    alive = [True] * n

    def pump(x):
        if stash[x] is not None:
            i, data, final = stash[x]
            stash[x] = None
        else:
            try:
                i, data, final = next(its[x])
            except StopIteration:
                alive[x] = False
                view[x]["fin"] = True
                return
        v = view[x]
        if v["i"] is None:
            v["i"] = i
            v["fin"] = False
        if i != v["i"]:
            stash[x] = (i, data, final)      # belongs to the next scaffold
            v["fin"] = True
            return
        if data:
            v["parts"].append(data)
        if final:
            v["fin"] = True

    def joined(x) -> bytes:
        p = view[x]["parts"]
        if len(p) != 1:
            view[x]["parts"] = p = [b"".join(p)]
        return p[0]

    def last_row_pos(x) -> int:
        last = view[x]["parts"][-1].rstrip(b"\n").rsplit(b"\n", 1)[-1]
        return int(last.split(sep, 2)[1])

    INT64_MAX = (1 << 63) - 1
    while True:
        for x in range(n):
            while alive[x] and view[x]["i"] is None:
                pump(x)
        current = [x for x in range(n) if view[x]["i"] is not None]
        if not current:
            break
        S = min(view[x]["i"] for x in current)
        length = scaf_lens.get(scafs[S]) if scaf_lens else None
        max_pos = INT64_MAX if length is None else int(length)
        while True:
            act = [x for x in range(n) if view[x]["i"] == S]
            for x in act:
                while alive[x] and view[x]["i"] == S and \
                        not view[x]["fin"] and not view[x]["parts"]:
                    pump(x)
            act = [x for x in range(n) if view[x]["i"] == S]
            open_files = [x for x in act if not view[x]["fin"]]
            if open_files:
                with_data = [x for x in open_files if view[x]["parts"]]
                limit = min(last_row_pos(x) for x in with_data) \
                    if len(with_data) == len(open_files) else 0
            else:
                limit = INT64_MAX
            if limit > 0:
                blocks = [joined(x) if view[x]["i"] == S else b""
                          for x in range(n)]
                res = native.merge_geno_blocks_native(
                    blocks, sep[0], limit, max_pos, INTERSECT, miss_fill)
                if res is None:
                    # cannot fall back mid-run: the header and earlier rows
                    # were already written (the eligibility gate makes this
                    # unreachable; fail loudly rather than corrupt output)
                    raise RuntimeError(
                        "native merge became unavailable mid-run")
                out_data, consumed = res
                if out_data:
                    out_bin.write(out_data)
                for x in range(n):
                    if view[x]["i"] == S and consumed[x]:
                        rest = blocks[x][int(consumed[x]):]
                        view[x]["parts"] = [rest] if rest else []
            if not open_files:
                for x in act:
                    view[x]["i"] = None
                    view[x]["parts"] = []
                    view[x]["fin"] = False
                break
            for x in open_files:
                if not view[x]["parts"] and alive[x] and view[x]["i"] == S \
                        and not view[x]["fin"]:
                    pump(x)

    for w in workers:
        w.join()
    shared_pool.shutdown()
    if out_bin is not sys.stdout.buffer:
        out_bin.close()
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="parseVCFs")
    add_args(parser)
    parser.add_argument("-i", "--inFile", action="append", required=True)
    parser.add_argument("-f", "--fai", action="store")
    parser.add_argument("-M", "--method", action="store",
                        choices=("all", "intersect", "union"),
                        default="union")
    parser.add_argument("-t", "--threads", type=int, action="store",
                        default=1)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--windSize", type=int, action="store",
                        default=100000)
    parser.add_argument("--test", action="store_true")
    args = parser.parse_args(argv)

    if args.expandMulti:
        raise ValueError("Option --expandMulti is not currently suppoted by "
                         "this multi-threaded script. Use parseVCF.py instead\n")
    if args.addRefTrack:
        raise ValueError("Option --addRefTrack is not currently suppoted by "
                         "this multi-threaded script. Use parseVCF.py instead\n")

    include, exclude = parse_include_exclude(args)
    gt_filters = [V.parse_genotype_filter_arg(g) for g in args.gtf] \
        if args.gtf else []

    head_data = [V.get_head_data(f) for f in args.inFile]
    samples_per_file = [h["sampleNames"] for h in head_data]
    if args.samples:
        requested = args.samples.split(",")
        all_samples = [s for ss in samples_per_file for s in ss]
        for s in requested:
            assert s in all_samples, f"Sample {s} not in VCF header\n"
        samples_per_file = [[s for s in ss if s in requested]
                            for ss in samples_per_file]

    ploidy_dict = defaultdict(lambda: args.ploidy)
    if args.ploidyFile:
        with open(args.ploidyFile, "rt") as pf:
            ploidy_dict.update({s[0]: int(s[1])
                                for s in (l.split() for l in pf)})

    if args.field:
        missing = args.missing if args.missing else "."
        all_missing = [[missing] * len(ss) for ss in samples_per_file]
    else:
        missing = args.missing if args.missing else "N"
        all_missing = [["/".join([missing] * ploidy_dict[s]) for s in ss]
                       for ss in samples_per_file]

    if args.fai:
        with open(args.fai, "rt") as fai:
            scaf_lens = [(s, int(l)) for s, l in
                         (ln.split()[:2] for ln in fai if ln.strip())]
        scafs = [x[0] for x in scaf_lens]
        scaf_lens = dict(scaf_lens)
    else:
        scafs = head_data[0]["contigs"]
        scaf_lens = head_data[0]["contigLengths"]

    if _fast_single(args, head_data, samples_per_file, ploidy_dict,
                    gt_filters, include, exclude, scafs, scaf_lens):
        return 0
    if len(args.inFile) > 1 and not args.field and \
            _fast_multi(args, head_data, samples_per_file, ploidy_dict,
                        gt_filters, include, exclude, scafs, scaf_lens,
                        all_missing):
        return 0

    out = open_out(args.outFile)

    n = len(args.inFile)
    streams = [open_maybe_gz(f, "rt") for f in args.inFile]
    for st in streams:
        V.parse_header_lines(st)     # skip to data
    gens = [V.parse_vcf_sites(streams[x], head_data[x]["mainHeaders"],
                              excludeDuplicates=args.excludeDuplicates,
                              simplifyALT=args.simplifyALT)
            for x in range(n)]
    heads: list = []
    for g in gens:
        try:
            heads.append(next(g))
        except StopIteration:
            heads.append(None)

    def advance(x):
        try:
            heads[x] = next(gens[x])
        except StopIteration:
            heads[x] = None

    out.write(args.outSep.join(
        ["#CHROM", "POS"] + [s for ss in samples_per_file for s in ss]) + "\n")

    max_windows = 10 if args.test else None
    windows_done = 0
    finished_scafs: set[str] = set()

    def drop_stale(x, scaf, pos):
        """Advance past consumed scaffolds and already-walked positions so a
        stale head never blocks the stream (the reference's stalled-head bug,
        parseVCFs.py:66-79)."""
        h = heads[x]
        while h is not None and (h.CHROM in finished_scafs or
                                 (h.CHROM == scaf and h.POS < pos)):
            advance(x)
            h = heads[x]

    for scaf in scafs:
        if (exclude and scaf in exclude) or (include and scaf not in include):
            continue
        length = scaf_lens.get(scaf)
        if length is None:
            length = INF if args.method != "all" else 0
        if max_windows is not None:
            remaining = max_windows - windows_done
            if remaining <= 0:
                break
            length = min(length, remaining * args.windSize)
            windows_done += -(-length // args.windSize)
        pos = 1
        while pos <= length:
            if args.method != "all":
                nxt = INF
                for x in range(n):
                    drop_stale(x, scaf, pos)
                    h = heads[x]
                    if h is not None and h.CHROM == scaf and h.POS < nxt:
                        nxt = h.POS
                if nxt == INF or nxt > length:
                    break
                pos = nxt
            else:
                for x in range(n):
                    drop_stale(x, scaf, pos)
            files_represented = 0
            out_objects = [scaf, str(pos)]
            for x in range(n):
                h = heads[x]
                present = False
                if h is not None and h.CHROM == scaf and h.POS == pos:
                    present = True
                    if args.minQual and V.can_float(h.QUAL) and \
                            float(h.QUAL) < args.minQual:
                        present = False
                    if present and args.maxREFlen and \
                            len(h.REF) > args.maxREFlen:
                        present = False
                    if args.field:
                        output = h.getGenoField(args.field,
                                                samples=samples_per_file[x],
                                                missing=missing)
                    else:
                        output = h.getGenotypes(
                            gt_filters, asList=True, withPhase=True,
                            samples=samples_per_file[x], missing=missing,
                            mustMatchREFlen=args.skipIndels,
                            keepPartial=args.keepPartial,
                            ploidyDict=ploidy_dict,
                            ploidyMismatchToMissing=args.ploidyMismatchToMissing)
                    if not present:
                        output = all_missing[x]
                    else:
                        files_represented += 1
                    advance(x)
                else:
                    output = all_missing[x]
                out_objects += output
            if args.method == "all" or \
                    (args.method == "union" and files_represented >= 1) or \
                    (args.method == "intersect" and files_represented == n):
                out.write(args.outSep.join(out_objects) + "\n")
            pos += 1
        finished_scafs.add(scaf)

    for st in streams:
        st.close()
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
