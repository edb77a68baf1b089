"""Two gloo ranks of the port's freq, filterGenotypes and sfs
(GGT_DEVICE=cpu), each byte-identical to the port's one-process run,
itself byte-identical to the JAX CLI's: the per-site cases of
tests/test_multihost.py, with the incremental gather (GGT_GATHER_SCAFS=1:
rank 0 writes each scaffold while the ranks stream) and indexed (BGZF +
.tbi) input, and sfs's int64 sum / min merge."""

import pytest

from .torch_multihost_util import D, check_cli, indexed_copy

pytestmark = pytest.mark.multihost

FREQ = "genomics_general_tpu_torch.cli.freq"
FILTER = "genomics_general_tpu_torch.cli.filter_genotypes"
SFS = "genomics_general_tpu_torch.cli.sfs"
POPS4 = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
         "--popsFile", str(D / "sim1.pops.txt")]
GATHER_1 = {"GGT_GATHER_SCAFS": "1", "GGT_GATHER_DEBUG": "1"}


def _out(tmp_path, suffix):
    return lambda tag: [tmp_path / f"{tag}.{suffix}"]


def _freq(tmp_path, extra=(), geno=D / "sim1.geno.gz"):
    return lambda tag: ["-g", str(geno), "-f", "phased", *extra, *POPS4,
                        "-o", str(tmp_path / f"{tag}.tsv")]


def _filter(tmp_path, min_calls, geno=D / "sim1.geno.gz"):
    return lambda tag: ["-i", str(geno), "-if", "phased", "-of", "phased",
                        "--minCalls", str(min_calls), "--minAlleles", "2",
                        "-o", str(tmp_path / f"{tag}.geno")]


def _peaks(errs):
    return [int(ln.split()[-2]) for e in errs for ln in e.splitlines()
            if "[gather]" in ln]


@pytest.mark.parametrize("extra", [[], ["--target", "derived"]],
                         ids=["counts", "derived"])
def test_two_ranks_freq(tmp_path, extra):
    check_cli(tmp_path, FREQ, _freq(tmp_path, extra), _out(tmp_path, "tsv"))


def test_two_ranks_filter_genotypes(tmp_path):
    check_cli(tmp_path, FILTER, _filter(tmp_path, 15),
              _out(tmp_path, "geno"))


def test_two_ranks_sfs_sum_min(tmp_path):
    """Per-rank dense spectra merged with int64 collectives (sum of counts,
    min of first-occurrence keys): every spectrum, its order included."""
    groups = ("pop1", "pop2", "pop1_pop2")
    check_cli(tmp_path, SFS,
              lambda tag: ["-i", str(D / "sim1.geno.gz"), "--inputType",
                           "genotypes", "--genoFormat", "phased",
                           "-p", "pop1", "-p", "pop2",
                           "--popsFile", str(D / "sim1.pops.txt"),
                           "--doPairs", "--pref", str(tmp_path / f"{tag}_"),
                           "--suff", ".sfs"],
              lambda tag: [tmp_path / f"{tag}_{g}.sfs" for g in groups])


@pytest.mark.parametrize("module, args_for, suffix", [
    (FREQ, lambda t: _freq(t), "tsv"),
    (FILTER, lambda t: _filter(t, 12), "geno"),
], ids=["freq", "filter_genotypes"])
def test_two_ranks_incremental_gather(tmp_path, module, args_for, suffix):
    """GGT_GATHER_SCAFS=1: one gather round a scaffold; each rank's peak
    buffered bytes stay under the output's size."""
    errs = check_cli(tmp_path, module, args_for(tmp_path),
                     _out(tmp_path, suffix), env=GATHER_1)
    peaks = _peaks(errs)
    assert len(peaks) == 2
    assert max(peaks) < (tmp_path / f"one.{suffix}").stat().st_size


def test_two_ranks_freq_indexed_incremental(tmp_path):
    """Indexed input and incremental gather together: the ranks' streams
    end at different scaffolds, and the rounds still match."""
    bgz = indexed_copy(tmp_path)
    check_cli(tmp_path, FREQ, _freq(tmp_path), _out(tmp_path, "tsv"),
              env={"GGT_GATHER_SCAFS": "1"},
              dist_args_for=_freq(tmp_path, geno=bgz))


def test_two_ranks_filter_genotypes_indexed_input(tmp_path):
    """The ploidy peek's first chunk is dropped when the ranks switch to
    the indexed stream."""
    bgz = indexed_copy(tmp_path)
    check_cli(tmp_path, FILTER, _filter(tmp_path, 15), _out(tmp_path, "geno"),
              env={"GGT_GATHER_SCAFS": "1"},
              dist_args_for=_filter(tmp_path, 15, geno=bgz))
