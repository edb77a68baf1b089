"""distMat through the PyTorch port (GGT_DEVICE=cpu: the kernels' plain
versions): the three distMat goldens at tol 0, byte equality with the JAX
CLI for every window type, output format and option, the raw
GGT_PACKED_TRANSFER=0 route and the host executor, and the multi-process
raise."""

import pytest

from .util import REPO, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
PORT = "genomics_general_tpu_torch.cli.dist_mat"
JAX = "genomics_general_tpu.cli.dist_mat"
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
SIM1 = ["-g", str(D / "sim1.geno.gz"), "-f", "phased"]
WIND = SIM1 + ["-w", "50000", "-m", "50", "--outFormat", "phylip"]
CAT = SIM1 + ["--windType", "cat", "--outFormat", "phylip"]


def _wind_golden(tmp_path, env):
    out, data = tmp_path / "o.phy", tmp_path / "w.tsv"
    run_cli(PORT, WIND + ["--windowDataOutFile", str(data), "-o", str(out)],
            env_extra=env)
    return {"distmat_wind.phy": out, "distmat_wind.data.tsv": data}


@pytest.mark.parametrize("golden", ["distmat_wind.phy",
                                    "distmat_wind.data.tsv",
                                    "distmat_cat.phy"])
def test_port_golden(tmp_path, golden):
    if golden == "distmat_cat.phy":
        out = tmp_path / "c.phy"
        run_cli(PORT, CAT + ["-o", str(out)], env_extra=CPU)
    else:
        out = _wind_golden(tmp_path, CPU)[golden]
    assert out.read_text() == (G / golden).read_text()


def test_port_raw_upload_golden(tmp_path):
    """GGT_PACKED_TRANSFER=0 ships the raw int8 span and counts with K9 +
    K4: both windowed goldens at tol 0."""
    outs = _wind_golden(tmp_path, {**CPU, "GGT_PACKED_TRANSFER": "0"})
    for golden, out in outs.items():
        assert out.read_text() == (G / golden).read_text(), golden


def _scaffold_file(tmp_path, name):
    path = tmp_path / f"{name}.txt"
    path.write_text(name + "\n")
    return str(path)


def _extra(name, tmp_path):
    return {
        "raw": ["-w", "50000", "-m", "50", "--outFormat", "raw"],
        "nexus": ["-w", "50000", "-s", "25000", "-m", "50",
                  "--outFormat", "nexus"],
        "sites": ["--windType", "sites", "-w", "800", "-O", "100",
                  "--windowDataOutFile", str(tmp_path / "w.tsv")],
        "predefined": ["--windType", "predefined", "--windCoords",
                       str(D / "sim1.windCoords.txt"), "-m", "50",
                       "--writeFailedWindows", "--addWindowID",
                       "--windowDataOutFile", str(tmp_path / "w.tsv")],
        "minPerInd": ["-w", "50000", "-m", "50", "--minPerInd", "450",
                      "--writeFailedWindows"],
        "sameWithSame": ["-w", "50000", "-m", "50",
                         "--includeSameWithSame"],
        "failed_windows": ["-w", "20000", "-m", "200",
                           "--writeFailedWindows", "--addWindowID",
                           "--windowDataOutFile", str(tmp_path / "w.tsv")],
        "cat_include": ["--windType", "cat", "--include",
                        _scaffold_file(tmp_path, "scaf2"),
                        "--windowDataOutFile", str(tmp_path / "w.tsv")],
        "cat_exclude": ["--windType", "cat", "--exclude",
                        _scaffold_file(tmp_path, "scaf1"), "--outFormat",
                        "nexus", "--minPerInd", "10"],
        "cat_same": ["--windType", "cat", "--includeSameWithSame",
                     "--outFormat", "raw", "--addWindowID",
                     "--windowDataOutFile", str(tmp_path / "w.tsv")],
    }[name]


OPTIONS = ["raw", "nexus", "sites", "predefined", "minPerInd",
           "sameWithSame", "failed_windows", "cat_include", "cat_exclude",
           "cat_same"]


@pytest.mark.parametrize("name", OPTIONS)
def test_port_bytes_equal_jax_cli(tmp_path, name):
    """Every window type, output format and option: the port's bytes (and
    its --windowDataOutFile, when asked for) == the JAX CLI's."""
    outs = {}
    for who, module in (("port", PORT), ("jax", JAX)):
        d = tmp_path / who
        d.mkdir()
        out = d / "o.txt"
        run_cli(module, SIM1 + _extra(name, d) + ["-o", str(out)],
                env_extra=CPU if who == "port" else None)
        outs[who] = [out.read_bytes()]
        if (d / "w.tsv").exists():
            outs[who].append((d / "w.tsv").read_bytes())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]


@pytest.mark.parametrize("args", [WIND, CAT], ids=["windowed", "cat"])
def test_port_host_executor_bytes_equal_kernel_path(tmp_path, args):
    kern, host = tmp_path / "kern.phy", tmp_path / "host.phy"
    run_cli(PORT, args + ["-o", str(kern)], env_extra=CPU)
    run_cli(PORT, args + ["-o", str(host)],
            env_extra={**CPU, "GGT_EXEC": "host"})
    assert kern.read_bytes() == host.read_bytes()


def test_port_multi_process_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    monkeypatch.setenv("GGT_NUM_PROCS", "2")
    from genomics_general_tpu_torch.cli import dist_mat
    with pytest.raises(ValueError, match="GGT_COORDINATOR"):
        dist_mat.main(WIND + ["-o", str(tmp_path / "o.phy")])
