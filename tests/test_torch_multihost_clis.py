"""Two gloo ranks of the port's popgenWindows, ABBABABAwindows and
fourPopWindows (GGT_DEVICE=cpu), each byte-identical to the port's
one-process run, itself byte-identical to the JAX CLI's: the popgen and
ABBA cases of tests/test_multihost.py, predefined windows with a ghost
scaffold and indexed (BGZF + .tbi) input among them.  With sim1's two
scaffolds crc32 gives both to rank 1, so rank 0 owns nothing and still
makes every collective call."""

import pytest

from .torch_multihost_util import (D, abba_within_quantum, check_cli,
                                   indexed_copy)

pytestmark = pytest.mark.multihost

POPGEN = "genomics_general_tpu_torch.cli.popgen_windows"
ABBA = "genomics_general_tpu_torch.cli.abba_windows"
FOUR_POP = "genomics_general_tpu_torch.cli.four_pop_windows"
WINDOW = ["-w", "50000", "-s", "25000", "-m", "100", "--minData", "0.3"]
POPS4 = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
         "--popsFile", str(D / "sim1.pops.txt")]
ABBA_POPS = ["-P1", "pop1", "-P2", "pop2", "-P3", "pop3", "-O", "pop4",
             "--popsFile", str(D / "sim1.pops.txt")]


def _popgen(tmp_path, extra, geno=D / "sim1.geno.gz"):
    return lambda tag: ["-g", str(geno), "-f", "phased", *POPS4,
                        "--writeFailedWindows", *extra,
                        "-o", str(tmp_path / f"{tag}.csv")]


def _csv(tmp_path):
    return lambda tag: [tmp_path / f"{tag}.csv"]


@pytest.mark.parametrize("analysis", [
    ["popDist", "popPairDist"],
    ["popFreq", "popDist", "hapStats"],
], ids=["pop_dist", "pop_freq_hap_stats"])
def test_two_ranks_popgen(tmp_path, analysis):
    check_cli(tmp_path, POPGEN,
              _popgen(tmp_path, [*WINDOW, "--analysis", *analysis]),
              _csv(tmp_path))


@pytest.mark.parametrize("module, extra", [
    (ABBA, ["-w", "50000", "-s", "25000", "-m", "50", "--writeFailedWindows"]),
    (FOUR_POP, ["-w", "50000", "-s", "50000", "-m", "50"]),
], ids=["abba", "four_pop"])
def test_two_ranks_abba(tmp_path, module, extra):
    check_cli(tmp_path, module,
              lambda tag: ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
                           *extra, "--minData", "0.3", *ABBA_POPS,
                           "-o", str(tmp_path / f"{tag}.csv")],
              _csv(tmp_path))


@pytest.mark.parametrize("env, jax_equal", [
    ({}, abba_within_quantum),           # the kernel route (K6, K7, K8)
    ({"GGT_ABBA_HOST": "1"}, None),       # per-site counts, host panel
], ids=["kernel", "abba_host"])
def test_two_ranks_abba_jackknife(tmp_path, env, jax_equal):
    """The jackknife table from every rank's window partials
    (allgather_bytes), written by rank 0: byte-equal to one process."""
    check_cli(tmp_path, ABBA,
              lambda tag: ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
                           "-w", "25000", "-s", "25000", "-m", "20",
                           "--minData", "0.3", *ABBA_POPS,
                           "--jackknife", "60000",
                           "--jackknifeFile", str(tmp_path / f"{tag}.jk.tsv"),
                           "-o", str(tmp_path / f"{tag}.csv")],
              lambda tag: [tmp_path / f"{tag}.{ext}"
                           for ext in ("csv", "jk.tsv")],
              env=env, jax_equal=jax_equal)


def test_two_ranks_predefined_interleaved_ghost(tmp_path):
    """A window list that interleaves scaffolds (rank 0 writes the rows in
    file order, by their keys) and names scaffolds absent from the data."""
    wc = tmp_path / "wc.txt"
    rows = [("scaf1", 1, 50000, "a1"), ("scaf2", 1, 50000, "b1"),
            ("scaf1", 50001, 100000, "a2"), ("ghostA", 1, 40000, "g1"),
            ("scaf2", 50001, 100000, "b2"), ("scaf1", 100001, 150000, "a3"),
            ("ghostB", 1, 40000, "g2")]
    wc.write_text("".join(f"{s}\t{a}\t{b}\t{i}\n" for s, a, b, i in rows))
    check_cli(tmp_path, POPGEN,
              _popgen(tmp_path, ["--windType", "predefined", "--windCoords",
                                 str(wc), "-m", "50", "--addWindowID",
                                 "--analysis", "popDist", "popPairDist"]),
              _csv(tmp_path))


def test_two_ranks_popgen_indexed_input(tmp_path):
    """Each rank reads only its scaffolds' BGZF blocks through the .tbi;
    the output equals the one-process run over the plain file."""
    bgz = indexed_copy(tmp_path)
    extra = ["-w", "50000", "-m", "50", "--analysis", "popDist",
             "popPairDist"]
    check_cli(tmp_path, POPGEN, _popgen(tmp_path, extra), _csv(tmp_path),
              dist_args_for=_popgen(tmp_path, extra, geno=bgz))


def test_two_ranks_abba_indexed_input(tmp_path):
    bgz = indexed_copy(tmp_path)

    def args_for(geno):
        return lambda tag: ["-g", str(geno), "-f", "phased", "-w", "50000",
                            "-s", "25000", "-m", "50", "--minData", "0.3",
                            *ABBA_POPS, "--writeFailedWindows",
                            "-o", str(tmp_path / f"{tag}.csv")]
    check_cli(tmp_path, ABBA, args_for(D / "sim1.geno.gz"), _csv(tmp_path),
              dist_args_for=args_for(bgz))
