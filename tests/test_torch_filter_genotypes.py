"""filterGenotypes through the PyTorch port (GGT_DEVICE=cpu: the count
kernels' plain versions): the five filter goldens at tol 0, also on the
raw-upload and host routes; byte equality with the JAX CLI for --HWE with
populations and for 9 populations that leave rows out (a 10-class mask);
and NotImplementedError for multi-process runs."""

import pytest

from genomics_general_tpu.cli import filter_genotypes as jax_filter
from genomics_general_tpu_torch.cli import filter_genotypes as port_filter
from genomics_general_tpu_torch.kernels import counts as port_counts

from .test_filter_genotypes import CONFIGS
from .util import REPO, assert_text_equal

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
SIM1 = ["-i", str(D / "sim1.geno.gz"), "-if", "phased"]
POPS = ["--popsFile", str(D / "sim1.pops.txt")]


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return monkeypatch


@pytest.mark.parametrize("route", [{}, {"GGT_PACKED_TRANSFER": "0"},
                                   {"GGT_EXEC": "host"}],
                         ids=["kernel", "raw_upload", "host_exec"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_golden(port_cpu, tmp_path, name, route):
    for k, v in route.items():
        port_cpu.setenv(k, v)
    out = tmp_path / "o.geno"
    port_counts.reset_launches()
    assert port_filter.main(SIM1 + CONFIGS[name] + ["-o", str(out)]) == 0
    assert (port_counts.HOST_FLUSHES > 0) == ("GGT_EXEC" in route)
    assert_text_equal(G / f"filter_{name}.geno", out)


def _pops9(tmp_path):
    """18 of the 20 sim1 individuals in 9 populations of 2."""
    inds = [f"pop{p}_ind{j}" for p in range(1, 5) for j in range(1, 6)]
    path = tmp_path / "pops9.txt"
    path.write_text("".join(f"{ind}\tq{k // 2 + 1}\n"
                            for k, ind in enumerate(inds[:18])))
    return [a for k in range(1, 10) for a in ("-p", f"q{k}")] + \
        ["--popsFile", str(path)]


@pytest.mark.parametrize("extra", [
    ["-p", "pop1", "-p", "pop2", *POPS, "--HWE", "0.05", "both"],
    ["-p", "pop1", "-p", "pop3", *POPS, "--HWE", "0.2", "both",
     "--minAlleles", "2", "-of", "diplo"],
    ["KEEP9", "--keepAllSamples", "--minPopCalls", "2", "--minAlleles", "2",
     "-of", "coded"],
    ["KEEP9", "--minPopCalls", "1", "--maxPopAlleles", "1", "-of", "count"],
], ids=["hwe", "hwe_diplo", "pops9_keep_all", "pops9"])
@pytest.mark.parametrize("route", [{}, {"GGT_PACKED_TRANSFER": "0"}],
                         ids=["kernel", "raw_upload"])
def test_port_bytes_equal_jax_cli(port_cpu, tmp_path, extra, route):
    """--HWE with populations (its per-site host loop), and 9 populations
    with and without --keepAllSamples (the pop mask leaves the two other
    individuals' rows out: 10 classes)."""
    if extra[0] == "KEEP9":
        extra = _pops9(tmp_path) + extra[1:]
    args = SIM1 + extra
    want, got = tmp_path / "jax.geno", tmp_path / "port.geno"
    assert jax_filter.main(args + ["-o", str(want)]) == 0
    for k, v in route.items():
        port_cpu.setenv(k, v)
    assert port_filter.main(args + ["-o", str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text().count("\n") > 10


def test_port_multi_process_raises(port_cpu, tmp_path):
    port_cpu.setenv("GGT_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="GGT_COORDINATOR"):
        port_filter.main(SIM1 + ["-o", str(tmp_path / "o.geno")])
