"""VCF -> .geno converter CLI.

The port of genomics_general_tpu/cli/parse_vcf.py, with the same flags and
output bytes; it launches no kernel.

Host-side driver with the same flag surface and output as the reference
``VCF_processing/parseVCF.py`` (see parseVCF.py:257-391): streams a VCF,
applies QUAL / REF-length / contig filters and the genotype-filter DSL,
and writes a tab-separated .geno table (optionally a FORMAT field table).
"""

from __future__ import annotations

import argparse
import gzip
import sys
from collections import defaultdict

from ..io import vcf as V


def add_args(parser: argparse.ArgumentParser):
    parser.add_argument("-o", "--outFile", action="store")
    parser.add_argument("-s", "--samples", action="store",
                        help="sample names (separated by commas)")
    parser.add_argument("--include", action="store")
    parser.add_argument("--includeFile", action="store")
    parser.add_argument("--exclude", action="store")
    parser.add_argument("--excludeFile", action="store")
    parser.add_argument("--minQual", type=int, action="store")
    parser.add_argument("--gtf", action="append", nargs="+",
                        help="Genotype filter: flag=X min=X max=X "
                             "siteTypes=X,X.. gtTypes=X,X.. samples=X,X..")
    parser.add_argument("--skipIndels", action="store_true")
    parser.add_argument("--excludeDuplicates", action="store_true")
    parser.add_argument("--simplifyALT", action="store_true")
    parser.add_argument("--expandMulti", action="store_true")
    parser.add_argument("--maxREFlen", action="store", type=int)
    parser.add_argument("--ploidy", action="store", type=int, default=2)
    parser.add_argument("--ploidyFile", action="store")
    parser.add_argument("--ploidyMismatchToMissing", action="store_true")
    parser.add_argument("--keepPartial", action="store_true")
    parser.add_argument("--addRefTrack", action="store_true")
    parser.add_argument("--noHeader", action="store_true")
    parser.add_argument("--field", action="store")
    parser.add_argument("--missing", action="store")
    parser.add_argument("--outSep", action="store", default="\t")


def parse_include_exclude(args):
    include, exclude = [], []
    if args.include:
        include += args.include.split(",")
    if args.exclude:
        exclude += args.exclude.split(",")
    if args.includeFile:
        with open(args.includeFile, "rt") as f:
            include += [c.strip() for c in f.read().split("\n")]
    if args.excludeFile:
        with open(args.excludeFile, "rt") as f:
            exclude += [c.strip() for c in f.read().split("\n")]
    if include:
        include = set(include)
        sys.stderr.write(f"{len(include)} contigs will be included.")
    if exclude:
        exclude = set(exclude)
        sys.stderr.write(f"{len(exclude)} contigs will be excluded.")
    return include, exclude


def _fast_path(args, samples, include, exclude, gt_filters) -> bool:
    """C-converter fast path (io/vcf_fast): chunked one-pass conversion with
    an optional -t thread pool.  Returns False when the configuration needs
    the Python VcfSite pipeline (caller falls back) — stdin input falls back
    too unless the header fits the first chunks."""
    import os

    from ..io import vcf_fast

    if os.environ.get("GGT_HOST_VCF") == "0":
        return False
    reason = vcf_fast.ineligible_reason(args, gt_filters, 0)
    if reason is not None:
        vcf_fast.notice_fallback("parseVCF", reason)
        return False
    if args.inFile:
        head_data = V.get_head_data(args.inFile)
        chunks = vcf_fast.text_chunks(args.inFile)
    else:
        head_data, chunks = vcf_fast.stdin_header_chunks(sys.stdin.buffer)
        if head_data is None:
            vcf_fast.notice_fallback(
                "parseVCF", "no #CHROM line in the first 64 MB of stdin")
            return False
    if head_data["nSamples"] > 1024:
        vcf_fast.notice_fallback(
            "parseVCF", f"{head_data['nSamples']} samples > 1024")
        return False
    if samples:
        for s in samples:
            assert s in head_data["sampleNames"], \
                f"Sample {s} not in VCF header\n"
    else:
        samples = head_data["sampleNames"]
    ploidy_dict = defaultdict(lambda: args.ploidy)
    if args.ploidyFile:
        with open(args.ploidyFile, "rt") as pf:
            ploidy_dict.update({s[0]: int(s[1])
                                for s in (l.split() for l in pf)})
    opts = vcf_fast.make_opts(args, gt_filters, head_data["sampleNames"],
                              samples, ploidy_dict)

    if args.outFile:
        out_bin = gzip.open(args.outFile, "wb") \
            if args.outFile.endswith(".gz") else open(args.outFile, "wb")
    else:
        out_bin = sys.stdout.buffer
    if not args.noHeader:
        first = ["#CHROM", "POS"]
        if args.addRefTrack:
            first.append("REF")
        out_bin.write((args.outSep.join(first + samples) + "\n").encode())

    headers = head_data["mainHeaders"]

    def slow_line(line, prev_name, prev_pos, prev_ptext=None):
        elements = line.decode().split()
        chrom, pos_text = elements[0], elements[1]
        pos = int(pos_text)
        name_b = chrom.encode()
        ptext_b = pos_text.encode()
        if args.excludeDuplicates and prev_name is not None \
                and name_b == prev_name:
            # the reference compares POS as raw TEXT (parseVCF.py
            # parseVcfSites: elements[1] == lastPos): '0100' after '100'
            # is NOT a duplicate
            prev_text = prev_ptext if prev_ptext is not None \
                else str(prev_pos).encode()
            if ptext_b == prev_text:
                return None, prev_name, prev_pos, prev_ptext
        site = V.VcfSite(elements=elements, headers=headers)
        if args.minQual and V.can_float(site.QUAL) and \
                float(site.QUAL) < args.minQual:
            return None, name_b, pos, ptext_b
        if args.maxREFlen and len(site.REF) > args.maxREFlen:
            return None, name_b, pos, ptext_b
        output = site.getGenotypes(
            gt_filters, asList=True, withPhase=True, samples=samples,
            missing=args.missing, mustMatchREFlen=args.skipIndels,
            keepPartial=args.keepPartial, ploidyDict=ploidy_dict,
            ploidyMismatchToMissing=args.ploidyMismatchToMissing)
        first = [chrom, str(site.POS)]
        if args.addRefTrack:
            first.append(site.REF)
        row = (args.outSep.join(first + output) + "\n").encode()
        return row, name_b, pos, ptext_b

    def emit_run(name, data):
        nm = name.decode()
        if (exclude and nm in exclude) or (include and nm not in include):
            return
        out_bin.write(data)

    vcf_fast.convert_stream(chunks, opts, slow_line, emit_run,
                            threads=max(1, args.threads))
    if out_bin is not sys.stdout.buffer:
        out_bin.close()
    return True


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_args(parser)
    parser.add_argument("-i", "--inFile", action="store")
    parser.add_argument("-t", "--threads", type=int, action="store",
                        default=1,
                        help="engine extension: convert text chunks on a "
                             "thread pool (the reference parseVCF is single-"
                             "threaded by design)")
    args = parser.parse_args(argv)

    samples = args.samples.split(",") if args.samples else None
    include, exclude = parse_include_exclude(args)
    gt_filters = [V.parse_genotype_filter_arg(g) for g in args.gtf] \
        if args.gtf else []
    simplify = args.simplifyALT or args.expandMulti

    if _fast_path(args, samples, include, exclude, gt_filters):
        return

    if args.inFile:
        in_file = gzip.open(args.inFile, "rt") if args.inFile.endswith(".gz") \
            else open(args.inFile, "rt")
    else:
        in_file = sys.stdin
    if args.outFile:
        out_file = gzip.open(args.outFile, "wt") if args.outFile.endswith(".gz") \
            else open(args.outFile, "wt")
    else:
        out_file = sys.stdout

    head_data = V.parse_header_lines(in_file)
    if samples:
        for s in samples:
            assert s in head_data["sampleNames"], \
                f"Sample {s} not in VCF header\n"
    else:
        samples = head_data["sampleNames"]

    ploidy_dict = defaultdict(lambda: args.ploidy)
    if args.ploidyFile:
        with open(args.ploidyFile, "rt") as pf:
            ploidy_dict.update({s[0]: int(s[1])
                                for s in (l.split() for l in pf)})

    if not args.noHeader:
        first = ["#CHROM", "POS"]
        if args.addRefTrack:
            first.append("REF")
        out_file.write(args.outSep.join(first + samples) + "\n")

    for site in V.parse_vcf_sites(in_file, head_data["mainHeaders"],
                                  excludeDuplicates=args.excludeDuplicates,
                                  simplifyALT=simplify):
        if (exclude and site.CHROM in exclude) or \
                (include and site.CHROM not in include):
            continue
        if args.minQual and V.can_float(site.QUAL) and \
                float(site.QUAL) < args.minQual:
            continue
        if args.maxREFlen and len(site.REF) > args.maxREFlen:
            continue
        if args.field is not None:
            output = site.getGenoField(args.field, samples=samples,
                                       missing=args.missing)
        else:
            output = site.getGenotypes(
                gt_filters, asList=True, withPhase=True, samples=samples,
                missing=args.missing, mustMatchREFlen=args.skipIndels,
                keepPartial=args.keepPartial, ploidyDict=ploidy_dict,
                ploidyMismatchToMissing=args.ploidyMismatchToMissing,
                expandMulti=args.expandMulti)
        if args.expandMulti:
            for x in range(site.REFlen):
                first = [site.CHROM, str(site.POS + x)]
                if args.addRefTrack:
                    first.append(site.REF[x])
                out_file.write(args.outSep.join(
                    first + [o[x] for o in output]) + "\n")
            continue
        first = [site.CHROM, str(site.POS)]
        if args.addRefTrack:
            first.append(site.REF)
        out_file.write(args.outSep.join(first + output) + "\n")

    out_file.close()


if __name__ == "__main__":
    main()
