"""Fasta/phylip region extraction and reformatting.

The port of genomics_general_tpu/cli/sequence.py, with the same flags and
output bytes; it launches no kernel.

Mirrors the reference ``sequence.py`` (sequence.py:1-83):
reads an alignment from stdin, optionally extracts regions
(``NAME[:FROM-TO[:ORI]]`` text or a regions file), reverse-complements
``-`` -oriented regions, and writes fasta or phylip to stdout.

Divergence from the reference: none — this tool is pure host-side string
handling; byte-identical output is validated in tests/test_seq_converters.py.
"""

from __future__ import annotations

import argparse
import sys

from ..encoding import revComplement
from ..io.seqio import parse_fasta, parse_phylip
from ..io.writers import make_aln_string
from ..regions import parse_region_list, parse_region_text


def main(argv=None, stdin=None, stdout=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--phylipIn", action="store_true",
                        help="Input is phylip format")
    parser.add_argument("-P", "--phylipOut", action="store_true",
                        help="Output is phylip format")
    parser.add_argument("-r", "--regions", nargs="+", action="store",
                        metavar="region",
                        help="Output regions and orientation e.g. "
                             "'SEQX:1001-1500:+'")
    parser.add_argument("-f", "--regionsFile", action="store",
                        help="File of regions to output (tab separated)")
    parser.add_argument("-l", "--lineLen", type=int, action="store",
                        metavar="integer", default=100,
                        help="Output line length")
    parser.add_argument("--extendLeft", type=int, default=0,
                        metavar="integer")
    parser.add_argument("--extendRight", type=int, default=0,
                        metavar="integer")
    parser.add_argument("--truncateNames", action="store_true",
                        help="Truncate names at first whitespace")
    parser.add_argument("--preserveNames", action="store_true",
                        help="Do not add start/end position to names of "
                             "chopped sequences")
    args = parser.parse_args(argv)

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout

    all_text = stdin.read()
    if args.phylipIn:
        names, seqs = parse_phylip(all_text)
    else:
        names, seqs = parse_fasta(all_text)
    names, seqs = list(names), list(seqs)

    if args.truncateNames:
        names = [name.split()[0] for name in names]

    regions = ([parse_region_text(r) for r in args.regions]
               if args.regions else [])
    if args.regionsFile:
        with open(args.regionsFile) as rf:
            for line in rf:
                regions.append(parse_region_list(line.split()))

    if len(regions) >= 1:
        out_names = []
        out_seqs = []
        for seq_name, start, end, ori in regions:
            i = names.index(seq_name)
            out_names.append(seq_name)
            if start is not None or end is not None or ori == "-":
                seq_len = len(seqs[i])
                if start is None:
                    start = 1
                if end is None:
                    end = seq_len
                start = max(1, start - args.extendLeft)
                end = min(seq_len, end + args.extendRight)
                chopped = seqs[i][start - 1:end]
                out_seqs.append(revComplement(chopped) if ori == "-"
                                else chopped)
                if not args.preserveNames:
                    out_names[-1] = (out_names[-1] + ":" + str(start) + "-" +
                                     str(end) + ":" + ori)
            else:
                out_seqs.append(seqs[i])
    else:
        out_names = names
        out_seqs = seqs

    sys.stderr.write("\nWriting %i sequences.\n" % len(out_names))
    stdout.write(make_aln_string(out_names, out_seqs,
                                 out_format="phylip" if args.phylipOut
                                 else "fasta",
                                 line_len=args.lineLen))


if __name__ == "__main__":
    main()
