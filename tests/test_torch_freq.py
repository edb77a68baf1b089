"""freq through the PyTorch port (GGT_DEVICE=cpu: the count kernels' plain
versions): the two freq goldens at tol 0; byte equality with the JAX CLI
for every --target mode and option, for the device counts mode
(GGT_HOST_FREQ_ROWS=0) and for 9 populations (10 overlapping mask rows);
the raw-upload and host routes; and NotImplementedError for multi-process
runs."""

import numpy as np
import pytest

from genomics_general_tpu.cli import freq as jax_freq
from genomics_general_tpu_torch.cli import freq as port_freq
from genomics_general_tpu_torch.kernels import counts as port_counts

from .util import REPO, assert_text_equal

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
SIM1 = ["-g", str(D / "sim1.geno.gz"), "-f", "phased"]
POPS4 = ["-p", "pop1", "-p", "pop2", "-p", "pop3", "-p", "pop4",
         "--popsFile", str(D / "sim1.pops.txt")]


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return monkeypatch


def _pops9(tmp_path):
    """The 20 sim1 individuals in 9 populations of 2 or 3."""
    inds = [f"pop{p}_ind{j}" for p in range(1, 5) for j in range(1, 6)]
    path = tmp_path / "pops9.txt"
    path.write_text("".join(f"{ind}\tq{k % 9 + 1}\n"
                            for k, ind in enumerate(inds)))
    return [a for k in range(1, 10) for a in ("-p", f"q{k}")] + \
        ["--popsFile", str(path)]


def _run(main, args, out, seed):
    """One in-process CLI run; ``seed`` seeds the global numpy stream that
    --target minor draws its ties from."""
    np.random.seed(seed)
    assert main(args + ["-o", str(out)]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("extra, golden", [
    ([], "freq_counts.tsv"),
    (["--target", "derived", "--minData", "2"], "freq_derived.tsv"),
], ids=["counts", "derived"])
def test_port_golden(port_cpu, tmp_path, extra, golden):
    out = tmp_path / "o.tsv"
    _run(port_freq.main, SIM1 + POPS4 + extra, out, 0)
    assert_text_equal(G / golden, out)


CONFIGS = {
    "minor": ["--target", "minor"],
    "minor_asCounts": ["--target", "minor", "--asCounts"],
    "derived": ["--target", "derived", "--minData", "2"],
    "derived_asCounts": ["--target", "derived", "--asCounts"],
    "threshold": ["--target", "derived", "--threshold", "0.5"],
    "keepNanLines": ["--target", "minor", "--keepNanLines",
                     "--minData", "6"],
    "minData": ["--target", "minor", "--minData", "8"],
    "indFreqs": ["--indFreqs", "--target", "minor"],
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_bytes_equal_jax_cli(port_cpu, tmp_path, name):
    """Every --target option: the JAX CLI's bytes, the minor allele's tie
    draws taken from the same seeded stream in the same order."""
    args = SIM1 + ([] if name == "indFreqs" else POPS4) + CONFIGS[name]
    want = _run(jax_freq.main, args, tmp_path / "jax.tsv", 7)
    got = _run(port_freq.main, args, tmp_path / "port.tsv", 7)
    assert got == want


@pytest.mark.parametrize("extra", [[], ["--target", "minor"],
                                   ["--target", "derived"]],
                         ids=["counts", "minor", "derived"])
def test_port_nine_pops_bytes_equal_jax_cli(port_cpu, tmp_path, extra):
    """9 populations: counts through the device (GGT_HOST_FREQ_ROWS=0, a
    partition), minor (the 9 pops and the all-rows union) and derived (the
    9 pops and the ingroup union) on 10 overlapping mask rows."""
    port_cpu.setenv("GGT_HOST_FREQ_ROWS", "0")
    args = SIM1 + _pops9(tmp_path) + extra
    want = _run(jax_freq.main, args, tmp_path / "jax.tsv", 3)
    port_counts.reset_launches()
    got = _run(port_freq.main, args, tmp_path / "port.tsv", 3)
    assert got == want
    assert port_counts.HOST_FLUSHES == 0


@pytest.mark.parametrize("env", [{"GGT_PACKED_TRANSFER": "0"},
                                 {"GGT_EXEC": "host"},
                                 {"GGT_HOST_FREQ_ROWS": "0"}],
                         ids=["raw_upload", "host_exec", "device_rows"])
@pytest.mark.parametrize("nine", [False, True], ids=["pops4", "pops9"])
def test_port_routes_bytes_equal_default(port_cpu, tmp_path, env, nine):
    """The raw upload (K12's plain version), the host counter (C for up to
    8 masks, numpy above) and the counts mode through the device write the
    default route's bytes, for derived and for the counts mode."""
    pops = _pops9(tmp_path) if nine else POPS4
    for extra in (["--target", "derived", "--minData", "2"], []):
        args = SIM1 + pops + extra
        want = _run(port_freq.main, args, tmp_path / "default.tsv", 0)
        for k, v in env.items():
            port_cpu.setenv(k, v)
        port_counts.reset_launches()
        got = _run(port_freq.main, args, tmp_path / "route.tsv", 0)
        for k in env:
            port_cpu.delenv(k)
        assert got == want
        host = env.get("GGT_EXEC") == "host" and extra
        assert (port_counts.HOST_FLUSHES > 0) == bool(host)


def test_port_multi_process_raises(port_cpu, tmp_path):
    port_cpu.setenv("GGT_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="GGT_COORDINATOR"):
        port_freq.main(SIM1 + POPS4 + ["-o", str(tmp_path / "o.tsv")])
