"""geno -> sequence alignment (fasta/phylip) converter.

The port of genomics_general_tpu/cli/geno_to_seq.py, with the same flags and
output bytes; it launches no kernel.

Mirror of genoToSeq.py: cat / windows / contigs output
modes, optional phased-haplotype splitting, N-to-gap translation and the
seqNameFormat naming options.  Differences from the reference, which are
crash fixes only: empty coordinate windows are skipped (the reference
raises on min() of an empty position list, genoToSeq.py:88), and -S sample
selection works in windows/contigs mode (the reference passes the samples
string as headerLine, genoToSeq.py:81-84).
"""

from __future__ import annotations

import argparse
import gzip
import sys

import numpy as np

from .. import windows as W
from ..io import seqio
from ..io.geno import open_maybe_gz
from ..io.writers import make_aln_string


def read_geno_strings(fileobj, samples=None, split_phased=False, ploidy=(2,)):
    """Parse a geno stream into per-sequence genotype-string lists plus
    scaffold/position arrays (host-side text path; the numeric encoder is
    not used because arbitrary genotype text must round-trip)."""
    header = fileobj.readline()
    if isinstance(header, bytes):
        header = header.decode()
    file_names = header.split()[2:]
    names = list(samples) if samples else file_names
    cols = [file_names.index(n) + 2 for n in names]
    if split_phased:
        out_names = seqio.make_haploid_names(names, list(ploidy))
    else:
        out_names = names
    scafs, poss, seqs = [], [], [[] for _ in out_names]
    for line in fileobj:
        if isinstance(line, bytes):
            line = line.decode()
        if not line.strip() or line[0] == "#":
            continue
        parts = line.split()
        scafs.append(parts[0])
        poss.append(int(parts[1]))
        if split_phased:
            k = 0
            for c in cols:
                for a in parts[c][::2]:
                    seqs[k].append(a)
                    k += 1
        else:
            for k, c in enumerate(cols):
                seqs[k].append(parts[c])
    scaffold_names: list[str] = []
    sid_of: dict[str, int] = {}
    sids = np.empty(len(scafs), np.int32)
    for i, s in enumerate(scafs):
        if s not in sid_of:
            sid_of[s] = len(scaffold_names)
            scaffold_names.append(s)
        sids[i] = sid_of[s]
    return out_names, scaffold_names, sids, np.asarray(poss, np.int64), seqs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="genoToSeq")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("-s", "--seqFile", action="store")
    p.add_argument("-f", "--format", action="store",
                   choices=("phylip", "fasta"), default="fasta")
    p.add_argument("-M", "--mode", action="store",
                   choices=("cat", "windows", "contigs"), default="cat")
    p.add_argument("-S", "--samples", action="store")
    p.add_argument("--NtoGap", action="store_true")
    p.add_argument("--seqNameFormat", action="store",
                   choices=("sample", "contig", "sample_contig",
                            "contig_position", "sample_contig_position"),
                   default="sample")
    p.add_argument("--splitPhased", action="store_true")
    p.add_argument("--ploidy", action="store", nargs="+", type=int,
                   default=[2])
    p.add_argument("--separateFiles", action="store_true")
    p.add_argument("--gzip", action="store_true")
    p.add_argument("--windType", action="store",
                   choices=("sites", "coordinate"), default="sites")
    p.add_argument("--windSize", type=int, action="store")
    p.add_argument("--minSites", type=int, action="store")
    p.add_argument("--stepSize", type=int, action="store")
    p.add_argument("--overlap", type=int, action="store")
    p.add_argument("--maxDist", type=int, action="store")
    args = p.parse_args(argv)

    geno_file = open_maybe_gz(args.genoFile, "rt") if args.genoFile \
        else sys.stdin
    samples = args.samples.split(",") if args.samples else None

    out_names, scaffold_names, sids, positions, seqs = read_geno_strings(
        geno_file, samples, args.splitPhased, args.ploidy)
    if args.genoFile:
        geno_file.close()

    def open_seq_out(path):
        if path:
            if path.endswith(".gz"):
                return gzip.open(path, "wt")
            if args.gzip:
                return gzip.open(path + ".gz", "wt")
            return open(path, "wt")
        return sys.stdout

    if args.mode == "cat":
        out = open_seq_out(args.seqFile)
        out.write(make_aln_string(out_names, seqs, out_format=args.format,
                                  n_to_gap=args.NtoGap))
        if out is not sys.stdout:
            out.close()
        return 0

    if args.mode == "windows":
        if args.windType == "coordinate":
            plan = W.plan_coordinate_windows(sids, positions, args.windSize,
                                             args.stepSize or args.windSize)
        else:
            plan = W.plan_sites_windows(sids, positions, args.windSize,
                                        args.overlap or 0,
                                        args.maxDist or np.inf,
                                        args.minSites or args.windSize)
    else:
        plan = W.plan_coordinate_windows(sids, positions, int(1e7), int(1e7))

    out = None if args.separateFiles else open_seq_out(args.seqFile)
    ext = ".fa" if args.format == "fasta" else ".phy"
    for w in range(plan.n_windows):
        f, l = int(plan.first[w]), int(plan.last[w])
        if l <= f:
            continue        # reference crashes here; we skip empty windows
        scaffold = scaffold_names[int(plan.scaffold_id[w])]
        pos_string = f"{positions[f]}_{positions[l - 1]}"
        if args.separateFiles:
            name = args.seqFile + "." + scaffold
            if args.mode == "windows":
                name += "_" + pos_string
            name += ext
            if args.gzip:
                name += ".gz"
                out = gzip.open(name, "wt")
            else:
                out = open(name, "wt")
        if args.seqNameFormat == "contig":
            seq_names = [scaffold] * len(out_names)
        elif args.seqNameFormat == "sample_contig":
            seq_names = [n + "_" + scaffold for n in out_names]
        elif args.seqNameFormat == "contig_position":
            seq_names = [scaffold + "_" + pos_string] * len(out_names)
        elif args.seqNameFormat == "sample_contig_position":
            seq_names = [n + "_" + scaffold + "_" + pos_string
                         for n in out_names]
        else:
            seq_names = out_names
        out.write(make_aln_string(seq_names, [s[f:l] for s in seqs],
                                  out_format=args.format,
                                  n_to_gap=args.NtoGap))
        if args.separateFiles:
            out.close()
    if out is not None and out is not sys.stdout and not args.separateFiles:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
