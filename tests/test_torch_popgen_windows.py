"""popgenWindows through the PyTorch port (GGT_DEVICE=cpu: the kernels'
plain versions): the goldens at tol 0, byte equality with the JAX CLI for
every analysis, the fused routes against the general host finalize and
the host executor, the raw-upload route (GGT_PACKED_TRANSFER=0) against
the packed one, and NotImplementedError for multi-process runs."""

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


def test_port_coordinate_full_panel(tmp_path):
    """Every analysis at once through the Python row writer
    (--addWindowID): the popgen_coord.csv golden at tol 0."""
    out = tmp_path / "o.csv"
    run_cli(PORT, ["-g", str(D / "sim1.geno.gz"), "-f", "phased",
                   "-w", "50000", "-s", "25000", "-m", "100",
                   "--minData", "0.3", *POPS,
                   "--analysis", "popFreq", "popDist", "popPairDist",
                   "indPairDist", "indHet", "hapStats",
                   "--writeFailedWindows", "--addWindowID", "-o", str(out)],
            env_extra=CPU)
    assert_csv_equal(G / "popgen_coord.csv", out)


SIM1_W = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
          "-m", "50", *POPS, "--writeFailedWindows"]
ANALYSES = {
    "indHet": ["--analysis", "indHet"],
    "indPairDist": ["--analysis", "indPairDist"],
    "indHet_indPairDist": ["--analysis", "indHet", "indPairDist"],
    "popFreq": ["--analysis", "popFreq"],
    "hapStats": ["--analysis", "hapStats", "--hapDist", "2"],
    "fstWC": ["--analysis", "popDist", "popPairDist", "--fstMethod", "WC"],
}


@pytest.mark.parametrize("name", sorted(ANALYSES))
def test_port_analysis_bytes_equal_jax_cli(tmp_path, name):
    port, jax_out = tmp_path / "port.csv", tmp_path / "jax.csv"
    args = SIM1_W + ANALYSES[name]
    run_cli(PORT, args + ["-o", str(port)], env_extra=CPU)
    run_cli(JAX, args + ["-o", str(jax_out)])
    assert port.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("extra", [
    ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
     "--analysis", "indHet", "popFreq"],
    ["-g", str(D / "sim_hap.geno.gz"), "-f", "phased", "-w", "50000",
     "-m", "50", "-p", "pop1", "-p", "pop2",
     "--popsFile", str(D / "sim_hap.pops.txt"), "--haploid", "pop1_ind1",
     "--analysis", "popDist", "indPairDist", "indHet"],
    ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
     "-p", "pop1", "-p", "pop2", "--popsFile", str(D / "sim1.pops.txt"),
     "--samples", "pop3_ind1,pop4_ind2", "--analysis", "indPairDist",
     "popDist", "popPairDist"],
], ids=["no_pops", "haploid_ind", "samples_subset"])
def test_port_sample_layouts_bytes_equal_jax_cli(tmp_path, extra):
    """No pops given ("all" only for pop-level analyses), a haploid
    individual (r1 == r2 in the het rows), and --samples rows outside
    every pop: each row of the individual mask lies in exactly one
    individual."""
    port, jax_out = tmp_path / "port.csv", tmp_path / "jax.csv"
    run_cli(PORT, extra + ["-o", str(port)], env_extra=CPU)
    run_cli(JAX, extra + ["-o", str(jax_out)])
    assert port.read_bytes() == jax_out.read_bytes()


FAST_ARGS = {
    "all_four": ["-s", "25000", "-m", "100", "--minData", "0.3",
                 "--analysis", "popDist", "popPairDist", "indPairDist",
                 "indHet"],
    "indHet": ["-m", "50", "--analysis", "indHet"],
    "indPairDist": ["-m", "50", "--analysis", "indPairDist"],
    "indHet_indPairDist": ["-m", "50", "--analysis", "indHet",
                           "indPairDist"],
}


@pytest.mark.parametrize("name", sorted(FAST_ARGS))
def test_port_fast_route_equals_host_finalize(tmp_path, name):
    """The fused blocks / blocks_het routes write the bytes of the general
    route (GGT_HOST_DIST_FINALIZE=1: the tri counts finalized on the
    host), as tests/test_popgen_windows.py holds the JAX CLI to."""
    args = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
            *POPS, *FAST_ARGS[name], "--writeFailedWindows"]
    fast, host = tmp_path / "fast.csv", tmp_path / "host.csv"
    run_cli(PORT, args + ["-o", str(fast)], env_extra=CPU)
    run_cli(PORT, args + ["-o", str(host)],
            env_extra={**CPU, "GGT_HOST_DIST_FINALIZE": "1"})
    assert fast.read_bytes() == host.read_bytes()


RUN_A = ["--analysis", "popFreq", "popDist", "popPairDist", "indHet",
         "hapStats", "--fstMethod", "WC"]
RUN_B = ["--analysis", "popDist", "popPairDist", "indPairDist", "indHet"]


@pytest.mark.parametrize("analysis", [RUN_A, RUN_B], ids=["run_A", "run_B"])
def test_port_host_executor_equals_kernel_route(tmp_path, analysis):
    """GGT_EXEC=host (the C pair and site counters) writes the bytes of the
    kernel route for the analysis sets of chip_smoke.py's full-width
    runs."""
    kern, host = tmp_path / "kern.csv", tmp_path / "host.csv"
    args = SIM1 + ["-w", "50000"] + analysis
    run_cli(PORT, args + ["-o", str(kern)], env_extra=CPU)
    run_cli(PORT, args + ["-o", str(host)], env_extra={**CPU,
                                                       "GGT_EXEC": "host"})
    assert kern.read_bytes() == host.read_bytes()


def test_port_whh_cap_bounds_hapstats_flushes(tmp_path, monkeypatch):
    """hapStats at H = 512 materializes [W, H, H] counts on the host: the
    GGT_WHH_BUDGET cap must bound every flush's window count (budget
    8 * 32 * 512^2 bytes -> 8 windows), over several flushes."""
    from genomics_general_tpu_torch import testing
    from genomics_general_tpu_torch.cli import popgen_windows
    from genomics_general_tpu_torch.kernels import pairdist

    geno = tmp_path / "big.geno.gz"
    inds = testing.write_geno(str(geno), n_pops=2, inds_per_pop=128,
                              n_sites=3000, scaffold_len=300_000,
                              n_scaffolds=1, seed=3)
    pops = tmp_path / "pops.txt"
    testing.write_pops_file(str(pops), inds)
    for k, v in {**CPU, "GGT_EXEC": "host",
                 "GGT_WHH_BUDGET": str(8 * 32 * 512 * 512)}.items():
        monkeypatch.setenv(k, v)
    sizes = []
    real = pairdist.window_pair_counts_dispatch

    def recording(alleles, first, n_sites, mesh=None):
        assert alleles.shape[0] == 512 and mesh is None
        sizes.append(first.shape[0])
        return real(alleles, first, n_sites, mesh=mesh)

    monkeypatch.setattr(pairdist, "window_pair_counts_dispatch", recording)
    out = tmp_path / "o.csv"
    assert popgen_windows.main(
        ["-g", str(geno), "-f", "phased", "--windType", "sites", "-w", "100",
         "-m", "10", "-p", "pop1", "-p", "pop2", "--popsFile", str(pops),
         "--analysis", "hapStats", "-o", str(out)]) == 0
    assert len(sizes) >= 3 and max(sizes) <= 8, sizes
    assert sum(sizes) == out.read_text().count("\n") - 1 == 30


@pytest.mark.parametrize("extra, env", [
    (["--analysis", "popDist"], {"GGT_NUM_PROCS": "2"}),
    (["--analysis", "popDist"], {"GGT_WIRE": "2"}),
    (["--analysis", "popFreq"], {"GGT_PACKED_TRANSFER": "0"}),
], ids=["multi_process", "wire_v2", "raw_upload"])
def test_port_out_of_slice_raises(tmp_path, monkeypatch, extra, env):
    """GGT_NUM_PROCS=2 without a coordinator raises, naming the missing
    variable, instead of running one process.  GGT_WIRE=2
    (K13) and GGT_PACKED_TRANSFER=0 (K9, K12) write the default route's
    bytes."""
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    from genomics_general_tpu_torch.cli import popgen_windows
    args = ["-g", str(D / "sim1.geno.gz"), "-f", "phased", "-w", "50000",
            *POPS, *extra]
    if "GGT_NUM_PROCS" not in env:
        assert popgen_windows.main(args + ["-o", str(tmp_path / "d.csv")]) \
            == 0
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "GGT_NUM_PROCS" in env:
        with pytest.raises(ValueError, match="GGT_COORDINATOR"):
            popgen_windows.main(args + ["-o", str(tmp_path / "o.csv")])
        return
    assert popgen_windows.main(args + ["-o", str(tmp_path / "o.csv")]) == 0
    assert (tmp_path / "o.csv").read_bytes() == \
        (tmp_path / "d.csv").read_bytes()


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_golden_raw_upload(tmp_path, name):
    """The popgen goldens under GGT_PACKED_TRANSFER=0 (the blocks route
    ships its wire either way, as the JAX package's does)."""
    args, golden = GOLDENS[name]
    out = tmp_path / "o.csv"
    run_cli(PORT, args + ["--analysis", "popDist", "popPairDist",
                          "-o", str(out)],
            env_extra={**CPU, "GGT_PACKED_TRANSFER": "0"})
    assert_csv_equal(G / golden, out)


@pytest.mark.parametrize("analysis", [
    RUN_A, ["--analysis", "popFreq"], ["--analysis", "hapStats", "popFreq"],
    ["--analysis", "popDist", "popPairDist", "--fstMethod", "WC"],
], ids=["run_A", "popFreq", "hapStats_popFreq", "fstWC"])
def test_port_raw_upload_bytes_equal_packed(tmp_path, monkeypatch, analysis):
    """GGT_PACKED_TRANSFER=0 with pair and site counts in one run: one raw
    upload per flush serves both (K9's and K12's plain versions), and the
    bytes equal the packed run's; the coordinate full panel golden too."""
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    from genomics_general_tpu_torch.cli import popgen_windows
    from genomics_general_tpu_torch.kernels import transfer
    args = SIM1_W + analysis
    packed, raw = tmp_path / "packed.csv", tmp_path / "raw.csv"
    assert popgen_windows.main(args + ["-o", str(packed)]) == 0
    monkeypatch.setenv("GGT_PACKED_TRANSFER", "0")
    uploads = []
    real = transfer.upload_span

    def counting(span, *a, **kw):
        uploads.append(span.shape)
        return real(span, *a, **kw)
    monkeypatch.setattr(transfer, "upload_span", counting)
    assert popgen_windows.main(args + ["-o", str(raw)]) == 0
    assert raw.read_bytes() == packed.read_bytes()
    assert uploads, "the raw route did not upload the span"
