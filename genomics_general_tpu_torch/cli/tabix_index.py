"""bgzip + tabix indexing utility (engine extension).

The port of genomics_general_tpu/cli/tabix_index.py, with the same flags and
output bytes; it launches no kernel.

The reference workflows assume external ``bgzip``/``tabix`` binaries to
prepare indexed inputs (VCF_processing/README.md; parseVCFs.py:27-35).
This module makes the engine self-sufficient:

    python -m genomics_general_tpu_torch.cli.tabix_index bgzip in.vcf -o out.vcf.bgz
    python -m genomics_general_tpu_torch.cli.tabix_index index out.vcf.bgz --preset vcf

``index`` writes ``{input}.tbi`` (spec-conforming; readable by htslib
tabix and by this package's io/tabix reader).  ``vcfChromTransfer`` and
``extractCDSAlignments`` pick the index up automatically.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tabix_index")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bgzip", help="re-compress a text file into BGZF")
    b.add_argument("input")
    b.add_argument("-o", "--output", required=True)
    i = sub.add_parser("index", help="write a .tbi for a BGZF text file")
    i.add_argument("input")
    i.add_argument("--preset", choices=("vcf", "geno", "generic"),
                   default="vcf")
    i.add_argument("-o", "--output", help="index path (default {input}.tbi)")
    args = p.parse_args(argv)

    from ..io import tabix as T
    if args.cmd == "bgzip":
        T.bgzip_file(args.input, args.output)
        sys.stderr.write(f"wrote BGZF: {args.output}\n")
    else:
        dst = T.build_index(args.input, preset=args.preset,
                            tbi_path=args.output)
        sys.stderr.write(f"wrote index: {dst}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
