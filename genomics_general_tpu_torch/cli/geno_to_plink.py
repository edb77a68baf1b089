"""geno -> PLINK .ped/.map/.fam converter.

The port of genomics_general_tpu/cli/geno_to_plink.py, with the same flags
and output bytes; it launches no kernel.

Mirror of tools/genoToPlink.py: whole scaffolds are read
(nonOverlappingSitesWindows with windSites=inf, genoToPlink.py:37-40),
haplotypes interleaved per site into the PED allele columns
(splitSeq + zip, :50), MAP rows are "scaffold pos 0 pos" (:72).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import geno as geno_io
from ..samples import SampleData


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="genoToPlink")
    p.add_argument("-g", "--genoFile", action="store")
    p.add_argument("-f", "--genoFormat", action="store",
                   choices=["haplo", "diplo", "pairs", "alleles", "phased"],
                   default="phased")
    p.add_argument("--prefix", action="store")
    p.add_argument("--makeFAM", action="store_true")
    p.add_argument("--FAMprefix", action="store")
    p.add_argument("-s", "--samples", nargs="+", action="store")
    args = p.parse_args(argv)

    src = args.genoFile if args.genoFile else sys.stdin
    if not args.genoFile:
        assert args.prefix is not None, \
            "Please povide a prefix for the ouput files"
    fmt = "pairs" if args.genoFormat == "alleles" else args.genoFormat
    probe = geno_io.GenoReader(src, geno_format=fmt)
    names = args.samples if args.samples else list(probe.file_ind_names)
    ploidy = 1 if fmt == "haplo" else 2
    sd = SampleData(ind_names=names, ploidy={n: ploidy for n in names})
    reader = geno_io.rebind_reader(probe, sd)
    model = reader.model
    row_of = dict(zip(model.sample_names, model.sample_rows))
    chars = np.array(["A", "C", "G", "T"])
    prefix = args.prefix if args.prefix else args.genoFile.rsplit(".", 1)[0]

    # PED rows are individual-major (every site per line), so a single pass
    # over the site-major stream spills each individual's interleaved
    # haplotype codes to a temp file (O(chunk) RAM; the reference instead
    # reads whole scaffolds into memory, genoToPlink.py:37-40); the .map
    # rows stream out directly.
    import os
    import tempfile
    from .. import engine as _engine
    tmpdir = tempfile.mkdtemp(prefix="ggt_plink_")
    spool = {name: open(os.path.join(tmpdir, f"{i}.bin"), "wb")
             for i, name in enumerate(names)}
    try:
        with open(prefix + ".map", "wt") as out_map:
            for chunk in _engine._prefetched(reader.iter_chunks()):
                for name in names:
                    block = chunk.alleles[row_of[name]]     # [ploidy, s]
                    spool[name].write(block.T.ravel().tobytes())
                for sid, pos in zip(chunk.scaffold_ids, chunk.positions):
                    scaf = reader.scaffold_names[int(sid)]
                    out_map.write(f"{scaf} {pos} 0 {pos}\n")
        for f in spool.values():
            f.close()
        sys.stderr.write(
            f"{len(reader.scaffold_names)} scaffolds read\n")
        sys.stderr.write("Writing PED file...\n")
        with open(prefix + ".ped", "wt") as out_ped:
            for i, name in enumerate(names):
                out_ped.write(" ".join(["0", name, "0 0 0 0 "]))
                with open(os.path.join(tmpdir, f"{i}.bin"), "rb") as f:
                    first = True
                    while True:
                        blk = f.read(4 << 20)
                        if not blk:
                            break
                        inter = np.frombuffer(blk, dtype=np.int8)
                        seq = np.where(inter >= 0,
                                       chars[np.maximum(inter, 0)], "N")
                        if not first:
                            out_ped.write(" ")
                        out_ped.write(" ".join(seq))
                        first = False
                out_ped.write("\n")
    finally:
        for i in range(len(names)):
            try:
                os.remove(os.path.join(tmpdir, f"{i}.bin"))
            except OSError:
                pass
        try:
            os.rmdir(tmpdir)
        except OSError:
            pass

    if args.makeFAM:
        sys.stderr.write("Writing FAM file...\n")
        with open(args.FAMprefix if args.FAMprefix else prefix + ".fam",
                  "wt") as out_fam:
            for name in names:
                out_fam.write(f"0 {name} 0 0 0 0\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
