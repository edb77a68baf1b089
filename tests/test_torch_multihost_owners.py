"""Two gloo ranks that each own scaffolds: a 4-scaffold cohort from
``testing.write_geno``, where crc32 gives scaf4 to rank 0 and scaf1-scaf3
to rank 1 (sim1 gives both its scaffolds to rank 1).  The routes of
chip_smoke.py's run S: popDist (plain and indexed input), ABBA with its
jackknife table, sfs's sum / min merge and distMat cat's packed sum, plus
freq's incremental gather with rows on both ranks.  Each two-rank output
is byte-identical to the port's one-process run, itself equal to the JAX
CLI's (ABBA's kernel route within its disclosed quantum)."""

import pytest

from genomics_general_tpu_torch import testing
from genomics_general_tpu_torch.parallel import multihost

from .torch_multihost_util import abba_within_quantum, check_cli, indexed_copy

pytestmark = pytest.mark.multihost

CLI = "genomics_general_tpu_torch.cli."
SCAFS = ["scaf1", "scaf2", "scaf3", "scaf4"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    d = tmp_path_factory.mktemp("cohort")
    geno = d / "c4.geno.gz"
    inds = testing.write_geno(str(geno), n_sites=6000,
                              scaffold_len=300_000, n_scaffolds=4, seed=7)
    testing.write_pops_file(str(d / "c4.pops.txt"), inds)
    return geno, d / "c4.pops.txt"


def test_both_ranks_own_scaffolds():
    assert {s: multihost.owner(s, 2) for s in SCAFS} == \
        {"scaf1": 1, "scaf2": 1, "scaf3": 1, "scaf4": 0}


def _pops(pops, names):
    return [a for n in names for a in ("-p", n)] + ["--popsFile", str(pops)]


@pytest.mark.parametrize("indexed", [False, True], ids=["plain", "indexed"])
def test_owned_popgen(tmp_path, cohort, indexed):
    geno, pops = cohort

    def args_for(g):
        return lambda tag: ["-g", str(g), "-f", "phased", "-w", "50000",
                            "-m", "100",
                            *_pops(pops, ["pop1", "pop2", "pop3", "pop4"]),
                            "--analysis", "popDist", "popPairDist",
                            "--writeFailedWindows",
                            "-o", str(tmp_path / f"{tag}.csv")]
    dist_geno = indexed_copy(tmp_path, geno) if indexed else geno
    check_cli(tmp_path, CLI + "popgen_windows", args_for(geno),
              lambda tag: [tmp_path / f"{tag}.csv"],
              dist_args_for=args_for(dist_geno))


def test_owned_abba_jackknife(tmp_path, cohort):
    geno, pops = cohort
    check_cli(tmp_path, CLI + "abba_windows",
              lambda tag: ["-g", str(geno), "-f", "phased", "-w", "25000",
                           "-m", "20", "--minData", "0.3", "-P1", "pop1",
                           "-P2", "pop2", "-P3", "pop3", "-O", "pop4",
                           "--popsFile", str(pops), "--jackknife", "100000",
                           "--jackknifeFile", str(tmp_path / f"{tag}.jk.tsv"),
                           "-o", str(tmp_path / f"{tag}.csv")],
              lambda tag: [tmp_path / f"{tag}.{ext}"
                           for ext in ("csv", "jk.tsv")],
              jax_equal=abba_within_quantum)


def test_owned_sfs(tmp_path, cohort):
    geno, pops = cohort
    groups = ("pop1", "pop2", "pop3", "pop1_pop2", "pop1_pop3", "pop2_pop3")
    check_cli(tmp_path, CLI + "sfs",
              lambda tag: ["-i", str(geno), "--inputType", "genotypes",
                           "--genoFormat", "phased",
                           *_pops(pops, ["pop1", "pop2", "pop3"]),
                           "--doPairs", "--pref", str(tmp_path / f"{tag}_"),
                           "--suff", ".sfs"],
              lambda tag: [tmp_path / f"{tag}_{g}.sfs" for g in groups])


def test_owned_dist_mat_cat(tmp_path, cohort):
    geno, _ = cohort
    check_cli(tmp_path, CLI + "dist_mat",
              lambda tag: ["-g", str(geno), "-f", "phased", "--windType",
                           "cat", "--outFormat", "phylip",
                           "-o", str(tmp_path / f"{tag}.phy")],
              lambda tag: [tmp_path / f"{tag}.phy"])


def test_owned_freq_incremental_gather(tmp_path, cohort):
    """One gather round a scaffold: rank 1's rows for scaf1-scaf3 and rank
    0's for scaf4 interleave in file order."""
    geno, pops = cohort
    errs = check_cli(tmp_path, CLI + "freq",
                     lambda tag: ["-g", str(geno), "-f", "phased",
                                  *_pops(pops, ["pop1", "pop2", "pop4"]),
                                  "-o", str(tmp_path / f"{tag}.tsv")],
                     lambda tag: [tmp_path / f"{tag}.tsv"],
                     env={"GGT_GATHER_SCAFS": "1", "GGT_GATHER_DEBUG": "1"})
    peaks = [int(ln.split()[-2]) for e in errs for ln in e.splitlines()
             if "[gather]" in ln]
    assert len(peaks) == 2 and min(peaks) > 0
