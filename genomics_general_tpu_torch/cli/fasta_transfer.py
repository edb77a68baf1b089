"""Rebuild a fasta under a new assembly from an AGP/transfers table.

The port of genomics_general_tpu/cli/fasta_transfer.py, with the same flags
and output bytes; it launches no kernel.

Mirror of tools/fastaTransfer.py: each new scaffold is
built as an N-filled buffer of its maximum transfer end, with pieces
copied from the old assembly (reverse-complemented for '-' strand,
fastaTransfer.py:126-136); 60-column fasta output.
"""

from __future__ import annotations

import argparse
import sys

from ..encoding import revComplement
from ..io.geno import open_maybe_gz
from ..io.seqio import parse_fasta
from ..io.writers import make_aln_string, open_out
from .transfer_scaf_pos import read_transfers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fastaTransfer")
    p.add_argument("-i", "--inFile", action="store")
    p.add_argument("-o", "--outFile", action="store")
    p.add_argument("-a", "--agpFile", action="store")
    p.add_argument("-t", "--transfersFile", action="store")
    args = p.parse_args(argv)

    in_file = open_maybe_gz(args.inFile, "rt") if args.inFile else sys.stdin
    out_file = open_out(args.outFile)
    if not args.transfersFile and not args.agpFile:
        raise ValueError("Please provide an AGP file (or a 'transfers' file)")

    by_old = read_transfers(args.agpFile, args.transfersFile,
                            allow_agp_fails=False)
    # regroup by NEW scaffold, in first-appearance order (fastaTransfer.py:93)
    new_scafs: list[str] = []
    pieces: dict[str, list[dict]] = {}
    for rows in by_old.values():
        for r in rows:
            if r["newScaf"] not in pieces:
                pieces[r["newScaf"]] = []
                new_scafs.append(r["newScaf"])
            pieces[r["newScaf"]].append(r)
    # first-appearance order must follow the FILE order, not by_old grouping:
    # re-read preserving order
    ordered: list[str] = []
    seen = set()
    src = args.agpFile or args.transfersFile
    with open(src, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if args.agpFile:
                if len(parts) < 9 or parts[4] in ("N", "U"):
                    continue
            new_scaf = parts[0]
            if new_scaf not in seen:
                seen.add(new_scaf)
                ordered.append(new_scaf)
    new_scafs = [s for s in ordered if s in pieces]

    sys.stderr.write(f"{len(new_scafs)} new scaffolds to be made.\n")
    scafs, seqs = parse_fasta(in_file.read())
    seq_dict = dict(zip(scafs, seqs))

    new_seqs = []
    for new_scaf in new_scafs:
        rows = pieces[new_scaf]
        length = max(r["newEnd"] for r in rows)
        sys.stderr.write(f"Making new sequence: {new_scaf}, {len(rows)} "
                         f"pieces, {length} bp.\n")
        buf = ["N"] * length
        for r in rows:
            piece = seq_dict[r["scaf"]][r["start"] - 1:r["end"]]
            if r["strand"] == "-":
                piece = revComplement(piece)
            buf[r["newStart"] - 1:r["newEnd"]] = piece
        new_seqs.append(buf)

    out_file.write(make_aln_string(new_scafs, new_seqs, out_format="fasta",
                                   line_len=60))
    if out_file is not sys.stdout:
        out_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
