"""sfs through the PyTorch port (GGT_DEVICE=cpu: the count kernels' plain
versions): the nine sfs goldens at tol 0 (folded with pairs, polarized,
subsampled, per region), also on the raw-upload and host routes; byte
equality with the JAX CLI for --doTrios, --subsampleIndividuals and the
baseCounts / targetCounts table inputs; and NotImplementedError for
multi-process runs."""

import numpy as np
import pytest

from genomics_general_tpu.cli import sfs as jax_sfs
from genomics_general_tpu_torch.cli import sfs as port_sfs
from genomics_general_tpu_torch.kernels import counts as port_counts

from .util import REPO, assert_text_equal

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
GENO = ["-i", str(D / "sim1.geno.gz"), "--inputType", "genotypes",
        "--genoFormat", "phased", "--popsFile", str(D / "sim1.pops.txt")]
GOLDENS = {
    "folded": (["-p", "pop1", "-p", "pop2", "--doPairs"],
               ["pop1", "pop2", "pop1_pop2"]),
    "pol": (["-p", "pop1", "-p", "pop2", "-p", "pop4", "--polarized"],
            ["pop1", "pop2"]),
    "sub": (["-p", "pop1", "-p", "pop2", "--subsample", "6", "--seed", "42"],
            ["pop1", "pop2"]),
    "reg": (["-p", "pop1", "-p", "pop2", "--regions", "scaf1:1-400000",
             "scaf1:400001-900000", "scaf2:1-500000"], ["pop1", "pop2"]),
}


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return monkeypatch


def _run(main, args, pref):
    assert main(args + ["--pref", str(pref), "--suff", ".sfs"]) == 0


@pytest.mark.parametrize("route", [{}, {"GGT_PACKED_TRANSFER": "0"},
                                   {"GGT_EXEC": "host"}],
                         ids=["kernel", "raw_upload", "host_exec"])
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_golden(port_cpu, tmp_path, name, route):
    for k, v in route.items():
        port_cpu.setenv(k, v)
    extra, files = GOLDENS[name]
    port_counts.reset_launches()
    _run(port_sfs.main, GENO + extra, tmp_path / "sfs_")
    assert (port_counts.HOST_FLUSHES > 0) == ("GGT_EXEC" in route)
    for f in files:
        assert_text_equal(G / f"sfs_{name}_{f}.sfs",
                          tmp_path / f"sfs_{f}.sfs")


def _same_as_jax(tmp_path, args, names, seed=None):
    for tag, mod in (("jax", jax_sfs), ("port", port_sfs)):
        if seed is not None:
            np.random.seed(seed)
        _run(mod.main, args, tmp_path / f"{tag}_")
    for n in names:
        assert (tmp_path / f"port_{n}.sfs").read_bytes() == \
            (tmp_path / f"jax_{n}.sfs").read_bytes()


def test_port_do_trios_bytes_equal_jax_cli(port_cpu, tmp_path):
    _same_as_jax(tmp_path, GENO + ["-p", "pop1", "-p", "pop2", "-p", "pop3",
                                   "--doTrios"],
                 ["pop1", "pop2", "pop3", "pop1_pop2_pop3"])


def test_port_subsample_individuals_bytes_equal_jax_cli(port_cpu, tmp_path):
    """--subsampleIndividuals draws from the seeded ``random`` stream site
    by site, in the JAX CLI's order."""
    import random
    for tag, mod in (("jax", jax_sfs), ("port", port_sfs)):
        random.seed(5)
        _run(mod.main, GENO + ["-p", "pop1", "-p", "pop2", "--subsample",
                               "3", "--subsampleIndividuals"],
             tmp_path / f"{tag}_")
    for n in ("pop1", "pop2"):
        assert (tmp_path / f"port_{n}.sfs").read_bytes() == \
            (tmp_path / f"jax_{n}.sfs").read_bytes()


@pytest.mark.parametrize("extra", [
    ["--inputType", "baseCounts", "--doPairs"],
    ["--inputType", "baseCounts", "--polarized"],
    ["--inputType", "baseCounts", "--subsample", "4"],
], ids=["folded_pairs", "polarized", "subsample"])
def test_port_base_counts_bytes_equal_jax_cli(port_cpu, tmp_path, extra):
    """The baseCounts table input (freq's counts output) on the host: the
    JAX CLI's bytes."""
    _same_as_jax(tmp_path, ["-i", str(G / "freq_counts.tsv")] + extra,
                 ["pop1", "pop2", "pop3"], seed=11)


def test_port_target_counts_bytes_equal_jax_cli(port_cpu, tmp_path):
    """The targetCounts table input (freq --target derived --asCounts)."""
    table = tmp_path / "targets.tsv"
    from genomics_general_tpu_torch.cli import freq as port_freq
    assert port_freq.main(["-g", str(D / "sim1.geno.gz"), "-f", "phased",
                           "-p", "pop1", "-p", "pop2", "-p", "pop4",
                           "--popsFile", str(D / "sim1.pops.txt"),
                           "--target", "derived", "--asCounts",
                           "-o", str(table)]) == 0
    _same_as_jax(tmp_path, ["-i", str(table), "--inputType", "targetCounts",
                            "--doPairs"],
                 ["pop1", "pop2", "pop4", "pop1_pop2"])


def test_port_multi_process_raises(port_cpu, tmp_path):
    port_cpu.setenv("GGT_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="GGT_COORDINATOR"):
        _run(port_sfs.main, GENO + ["-p", "pop1"], tmp_path / "sfs_")
