"""Shared CLI plumbing mirroring the reference scripts' flag conventions
(window quad, population/ploidy parsing, include/exclude lists; see
popgenWindows.py:170-307 for the canonical block)."""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from .. import windows as W
from ..samples import SampleData


def add_window_args(parser: argparse.ArgumentParser,
                    choices=("sites", "coordinate", "predefined"),
                    overlap_short: bool = True):
    """overlap_short: popgenWindows/distMat spell it "-O/--overlap"; the
    ABBA-BABA scripts use bare "--overlap" because -O is the outgroup."""
    parser.add_argument("--windType", action="store", choices=choices, default="coordinate")
    parser.add_argument("-w", "--windSize", type=int, action="store", required=False)
    parser.add_argument("-s", "--stepSize", type=int, action="store", required=False)
    parser.add_argument("-m", "--minSites", type=int, action="store", required=False, default=1)
    if overlap_short:
        parser.add_argument("-O", "--overlap", type=int, action="store", required=False)
    else:
        parser.add_argument("--overlap", type=int, action="store", required=False)
    parser.add_argument("-D", "--maxDist", type=int, action="store", required=False)
    parser.add_argument("--windCoords", required=False)


def resolve_window_args(args, wind_coord_cols: int = 3):
    """Validate the window-flag combinations (popgenWindows.py:216-244) and
    return a dict of window parameters.

    wind_coord_cols: how many --windCoords columns the script keeps —
    popgenWindows/distMat keep 3 (window IDs become "NA",
    popgenWindows.py:241), ABBABABA/fourPop keep 4 (ABBABABAwindows.py:176).
    """
    wt = args.windType
    out = {"windType": wt}
    if wt == "coordinate":
        assert args.windSize, "Window size must be provided."
        out["windSize"] = args.windSize
        out["stepSize"] = args.stepSize or args.windSize
        assert not args.overlap, "Overlap does not apply to coordinate windows. Use --stepSize instead."
        assert not args.maxDist, "Maximum distance only applies to sites windows."
    elif wt == "sites":
        assert args.windSize, "Window size (number of sites) must be provided."
        out["windSize"] = args.windSize
        out["overlap"] = args.overlap or 0
        out["maxDist"] = args.maxDist or np.inf
        assert not args.stepSize, "Step size only applies to coordinate windows. Use --overlap instead."
    elif wt == "predefined":
        assert args.windCoords, "Please provide a file of window coordinates."
        assert not args.overlap and not args.maxDist and not args.stepSize
        assert not getattr(args, "include", None) and not getattr(args, "exclude", None)
        with open(args.windCoords, "rt") as wc:
            out["windCoords"] = [line.split()[:wind_coord_cols]
                                 for line in wc if line.strip()]
    min_sites = args.minSites
    if not min_sites:
        min_sites = args.windSize
    out["minSites"] = min_sites
    return out


def build_plan(wind, scaffold_ids, positions, scaffold_names):
    wt = wind["windType"]
    if wt == "coordinate":
        return W.plan_coordinate_windows(scaffold_ids, positions,
                                         wind["windSize"], wind["stepSize"])
    if wt == "sites":
        return W.plan_sites_windows(scaffold_ids, positions, wind["windSize"],
                                    wind["overlap"], wind["maxDist"],
                                    wind["minSites"])
    if wt == "predefined":
        return W.plan_predefined_windows(scaffold_ids, positions,
                                         scaffold_names, wind["windCoords"])
    if wt == "cat":
        return W.plan_cat_window(scaffold_ids, positions)
    raise ValueError(wt)


def add_pop_args(parser: argparse.ArgumentParser):
    parser.add_argument("-p", "--population", required=False, action="append",
                        nargs="+", metavar=("popName", "[samples]"))
    parser.add_argument("--popsFile", action="store", required=False)


def add_ploidy_args(parser: argparse.ArgumentParser):
    parser.add_argument("--ploidy", action="store", type=int, nargs="+")
    parser.add_argument("--ploidyFile", action="store")
    parser.add_argument("--haploid", action="store")
    parser.add_argument("--inferPloidy", action="store_true")


def add_io_args(parser: argparse.ArgumentParser, formats=("phased", "pairs", "haplo", "diplo")):
    parser.add_argument("-g", "--genoFile", required=False)
    parser.add_argument("-o", "--outFile", required=False)
    parser.add_argument("--exclude", required=False)
    parser.add_argument("--include", required=False)
    parser.add_argument("-f", "--genoFormat", action="store", choices=formats, required=True)
    parser.add_argument("--header", action="store")
    parser.add_argument("-T", "--threads", type=int, default=1, required=False,
                        help="Accepted for reference-CLI compatibility; device "
                             "placement is configured via GGT_DEVICE instead.")
    parser.add_argument("--verbose", action="store_true")


def add_runtime_args(parser: argparse.ArgumentParser):
    """Engine runtime flags (extensions beyond the reference surface)."""
    parser.add_argument("--profile", action="store_true",
                        help="report per-stage wall-clock timing "
                             "(parse/h2d/kernel/finalize/write) on stderr")
    parser.add_argument("--resume", action="store_true",
                        help="checkpoint per flushed window batch and resume "
                             "an interrupted run (plain-text --outFile only)")


def config_key(args) -> str:
    """Stable hash of the CLI config, used to validate resume cursors."""
    d = {k: v for k, v in sorted(vars(args).items()) if k != "resume"}
    return hashlib.sha1(repr(d).encode()).hexdigest()


def open_resumable_out(args, header_line: str):
    """Open the output stream honoring ``--resume``.

    Returns (out, skip_windows, cursor).  On resume, the output file is
    truncated to the last flushed batch boundary and reopened in append mode;
    ``skip_windows`` is the number of windows already fully written.
    """
    from .. import engine as _engine
    from ..io import writers

    if not getattr(args, "resume", False) or not args.outFile:
        out = writers.open_out(args.outFile)
        out.write(header_line)
        return out, 0, None
    if args.outFile.endswith(".gz"):
        raise SystemExit(
            "--resume requires a plain-text --outFile (a gzip stream cannot "
            "be truncated to a flush boundary and stay well-formed)")
    cursor = _engine.Cursor(args.outFile, config_key(args))
    st = cursor.load()
    if st and os.path.exists(args.outFile):
        with open(args.outFile, "r+") as f:
            f.truncate(st["bytes_done"])
        out = open(args.outFile, "at")
        return out, int(st["windows_done"]), cursor
    out = open(args.outFile, "wt")
    out.write(header_line)
    out.flush()
    cursor.save(0, out.tell())
    return out, 0, cursor


def read_scaffold_list(path: str | None):
    if not path:
        return None
    with open(path, "rt") as f:
        return [line.rstrip() for line in f.readlines()]


def sample_data_from_args(args, extra_inds=None, geno_path=None):
    """Replicate the reference's pops/ploidy resolution (popgenWindows.py:258-307)."""
    haploid = args.haploid.split(",") if getattr(args, "haploid", None) else None
    sd = SampleData.from_pop_args(
        population_args=getattr(args, "population", None),
        pops_file=getattr(args, "popsFile", None),
        extra_inds=extra_inds,
        ploidy_list=getattr(args, "ploidy", None),
        ploidy_file=getattr(args, "ploidyFile", None),
        haploid=haploid,
        geno_format=args.genoFormat)
    return sd
