"""popgenWindows through the PyTorch port (GGT_DEVICE=cpu: the kernels'
plain versions): the popDist/popPairDist goldens at tol 0, byte equality
with the JAX CLI, and NotImplementedError outside the ported slice."""

import pytest

from .util import REPO, assert_csv_equal, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
POPS = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
        "--popsFile", str(D / "sim1.pops.txt")]
PORT = "genomics_general_tpu_torch.cli.popgen_windows"
JAX = "genomics_general_tpu.cli.popgen_windows"
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}

GOLDENS = {
    "sites_windows": (
        ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "--windType", "sites",
         "-w", "250", "-O", "50", "-D", "50000", "-m", "100", *POPS],
        "popgen_sites.csv"),
    "predefined_windows": (
        ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
         "--windType", "predefined",
         "--windCoords", str(D / "sim1.windCoords.txt"), "-m", "50", *POPS,
         "--writeFailedWindows", "--addWindowID"],
        "popgen_predef.csv"),
    "haploid_mix": (
        ["-g", str(D / "sim_hap.geno.gz"), "-f", "phased", "-w", "50000",
         "-m", "50", "-p", "pop1", "-p", "pop2",
         "--popsFile", str(D / "sim_hap.pops.txt"), "--haploid", "pop1_ind1"],
        "popgen_hap.csv"),
    "diplo_format": (
        ["-g", str(D / "sim_diplo.geno.gz"), "-f", "diplo", "-w", "50000",
         "-m", "50", "-p", "pop1", "-p", "pop2",
         "--popsFile", str(D / "sim_diplo.pops.txt")],
        "popgen_diplo.csv"),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_golden(tmp_path, name):
    args, golden = GOLDENS[name]
    out = tmp_path / "o.csv"
    run_cli(PORT, args + ["--analysis", "popDist", "popPairDist",
                          "-o", str(out)], env_extra=CPU)
    assert_csv_equal(G / golden, out)


SIM1 = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-m", "100", *POPS,
        "--analysis", "popDist", "popPairDist"]


@pytest.mark.parametrize("extra", [
    ["-w", "50000"],
    ["-w", "50000", "-s", "25000", "--minData", "0.3", "--writeFailedWindows",
     "--fstMethod", "Hudson"],
], ids=["coordinate", "overlap_hudson"])
def test_port_bytes_equal_jax_cli(tmp_path, extra):
    port, jax_out = tmp_path / "port.csv", tmp_path / "jax.csv"
    run_cli(PORT, SIM1 + extra + ["-o", str(port)], env_extra=CPU)
    run_cli(JAX, SIM1 + extra + ["-o", str(jax_out)])
    assert port.read_bytes() == jax_out.read_bytes()


def test_port_host_executor_bytes_equal_kernel_path(tmp_path):
    """GGT_EXEC=host (the C popcount executor) writes the same bytes as the
    kernel path."""
    kern, host = tmp_path / "kern.csv", tmp_path / "host.csv"
    args = SIM1 + ["-w", "50000"]
    run_cli(PORT, args + ["-o", str(kern)], env_extra=CPU)
    run_cli(PORT, args + ["-o", str(host)], env_extra={**CPU,
                                                       "GGT_EXEC": "host"})
    assert kern.read_bytes() == host.read_bytes()


@pytest.mark.parametrize("extra, env", [
    (["--analysis", "popDist", "indHet"], {}),
    (["--analysis", "popFreq"], {}),
    (["--analysis", "hapStats"], {}),
    (["--analysis", "popDist", "popPairDist", "--fstMethod", "WC"], {}),
    (["--analysis", "popDist"], {"GGT_HOST_DIST_FINALIZE": "1"}),
    (["--analysis", "popDist"], {"GGT_NUM_PROCS": "2"}),
], ids=["indHet", "popFreq", "hapStats", "fstWC", "host_finalize",
        "multi_process"])
def test_port_out_of_slice_raises(tmp_path, monkeypatch, extra, env):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    from genomics_general_tpu_torch.cli import popgen_windows
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        popgen_windows.main(["-g", str(D / "sim1.geno.gz"), "-f", "phased",
                             "-w", "50000", *POPS, *extra,
                             "-o", str(tmp_path / "o.csv")])
