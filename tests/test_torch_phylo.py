"""phymlSlidingWindows and raxmlSlidingWindows through the PyTorch port
against the JAX CLIs on the same input: byte-identical ``.data.tsv`` and
decompressed tree files, with the built-in NJ backend (--maxLDphase,
bootstraps, -T 1 and -T 4) and with a shell stand-in for the phyml and
raxml binaries.  Multi-process runs raise until they are ported."""

import gzip
import os
import stat
from pathlib import Path

import pytest

from genomics_general_tpu.cli import phyml_sliding_windows as jax_phyml
from genomics_general_tpu.cli import raxml_sliding_windows as jax_raxml
from genomics_general_tpu_torch.cli import phyml_sliding_windows as port_phyml
from genomics_general_tpu_torch.cli import raxml_sliding_windows as port_raxml

D = Path(__file__).parent / "data"
SIM1 = D / "sim1.geno.gz"


@pytest.fixture
def port_cpu(monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def head_geno(tmp_path: Path, n_sites: int) -> Path:
    """The first ``n_sites`` sites of sim1 (--maxLDphase's greedy phasing
    costs a few ms of Python a site)."""
    lines = gzip.open(SIM1, "rt").read().splitlines(keepends=True)
    out = tmp_path / f"head{n_sites}.geno.gz"
    with gzip.open(out, "wt") as f:
        f.writelines(lines[:n_sites + 1])
    return out


def outputs(prefix: str, bootstraps: int = 0) -> tuple:
    names = ["trees.gz"] + [f"BS{b}.trees.gz" for b in range(bootstraps)]
    return (Path(prefix + ".data.tsv").read_bytes(),
            *(gzip.open(f"{prefix}.{n}", "rb").read() for n in names))


def both(main_jax, main_port, argv, tmp_path: Path, bootstraps: int = 0):
    """Run the JAX and the port CLI on the same arguments; their outputs
    must be byte-identical.  Returns the port's."""
    got = {}
    for name, main in (("jax", main_jax), ("port", main_port)):
        prefix = str(tmp_path / name)
        assert main(argv + ["-p", prefix]) == 0
        got[name] = outputs(prefix, bootstraps)
    assert got["port"] == got["jax"]
    return got["port"]


@pytest.mark.parametrize("threads", ["1", "4"])
def test_phyml_builtin_nj_max_ld_phase_matches_jax(port_cpu, tmp_path,
                                                   threads):
    """--phyml builtin-nj --njCorrect --maxLDphase --bootstraps 2 --seed 7
    on sim1's first 600 sites in 10 kb windows."""
    geno = head_geno(tmp_path, 600)
    data, trees, *_ = both(
        jax_phyml.main, port_phyml.main,
        ["-g", str(geno), "-w", "10000", "-M", "30", "--phyml",
         "builtin-nj", "--njCorrect", "--maxLDphase", "--bootstraps", "2",
         "--seed", "7", "-T", threads], tmp_path, bootstraps=2)
    rows = data.decode().rstrip("\n").split("\n")[1:]
    good = [t for t in trees.decode().split("\n") if t and t != "NA"]
    assert len(rows) >= 3 and good
    assert all(t.endswith(";") for t in good)


@pytest.mark.parametrize("threads", ["1", "4"])
def test_phyml_builtin_nj_whole_file_matches_jax(port_cpu, tmp_path,
                                                 threads):
    """sim1 in 50 kb windows with bootstraps, as the JAX -T test runs it."""
    both(jax_phyml.main, port_phyml.main,
         ["-g", str(SIM1), "-w", "50000", "-M", "100", "--phyml",
          "builtin-nj", "--bootstraps", "2", "--seed", "7", "-T", threads],
         tmp_path, bootstraps=2)


def test_phyml_sites_windows_filters_match_jax(port_cpu, tmp_path):
    """Site windows with the minSNPs and minPerInd filters and an
    outgroup, so some windows fail and write NA."""
    data, *_ = both(
        jax_phyml.main, port_phyml.main,
        ["-g", str(SIM1), "--windType", "sites", "-w", "150", "-O", "20",
         "-Ms", "60", "-Mi", "140", "--outgroup", "pop4_ind1",
         "--phyml", "builtin-nj", "--njCorrect", "-T", "2"], tmp_path)
    assert b"\tNA" in data


@pytest.mark.parametrize("threads", ["1", "4"])
def test_raxml_builtin_nj_matches_jax(port_cpu, tmp_path, threads):
    both(jax_raxml.main, port_raxml.main,
         ["-g", str(SIM1), "-w", "50000", "-M", "100", "--raxml",
          "builtin-nj", "--njCorrect", "-Ms", "10", "-T", threads],
         tmp_path)


def _stand_in(tmp_path: Path, kind: str) -> Path:
    """A shell script in place of the phyml or raxml binary: it writes the
    files the CLI reads back, naming the alignment's line count."""
    fake = tmp_path / f"fake{kind}"
    if kind == "phyml":
        body = ('in=""\n'
                'while [ $# -gt 0 ]; do\n'
                '  if [ "$1" = "--input" ]; then in="$2"; shift; fi\n'
                "  shift\n"
                "done\n"
                'n=$(wc -l < "$in")\n'
                'echo "(a,b$n);" > "${in}_phyml_tree.txt"\n'
                'echo "Log-likelihood: -$n.5" > "${in}_phyml_stats.txt"\n')
    else:
        body = ('s=""; n=""\n'
                'while [ $# -gt 0 ]; do\n'
                '  if [ "$1" = "-s" ]; then s="$2"; shift; fi\n'
                '  if [ "$1" = "-n" ]; then n="$2"; shift; fi\n'
                "  shift\n"
                "done\n"
                'k=$(wc -l < "$s")\n'
                'echo "(c,d$k);" > "RAxML_bestTree.$n"\n')
    fake.write_text("#!/bin/sh\n" + body)
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    return fake


@pytest.mark.parametrize("threads", ["1", "4"])
def test_phyml_stand_in_binary_matches_jax(port_cpu, tmp_path, threads):
    """The phyml command line, the tree and the lnL read back, and the
    temporary files cleaned up, through a stand-in binary."""
    fake = _stand_in(tmp_path, "phyml")
    work = tmp_path / "tmp"
    work.mkdir()
    data, trees = both(
        jax_phyml.main, port_phyml.main,
        ["-g", str(SIM1), "-w", "50000", "-M", "10", "--phyml", str(fake),
         "--tmp", str(work), "-T", threads], tmp_path)
    assert b"(a,b" in trees and b"\t-" in data
    assert not os.listdir(work)


def test_raxml_stand_in_binary_matches_jax(port_cpu, tmp_path):
    fake = _stand_in(tmp_path, "raxml")
    work = tmp_path / "tmp"
    work.mkdir()
    _, trees = both(
        jax_raxml.main, port_raxml.main,
        ["-g", str(SIM1), "-w", "50000", "-M", "10", "--raxml", str(fake),
         "--tmp", str(work), "--outgroup", "pop4_ind1"], tmp_path)
    assert b"(c,d" in trees
    assert not os.listdir(work)


@pytest.mark.parametrize("main", [port_phyml.main, port_raxml.main],
                         ids=["phyml", "raxml"])
def test_multi_process_runs_raise(port_cpu, monkeypatch, tmp_path, main):
    """GGT_NUM_PROCS=2 without a coordinator raises, naming the missing
    variable, instead of running one process."""
    monkeypatch.setenv("GGT_NUM_PROCS", "2")
    with pytest.raises(ValueError, match="GGT_COORDINATOR"):
        main(["-g", str(SIM1), "-w", "50000", "-p", str(tmp_path / "x"),
              "--phyml" if main is port_phyml.main else "--raxml",
              "builtin-nj"])
