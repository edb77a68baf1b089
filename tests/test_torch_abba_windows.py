"""ABBABABAwindows / fourPopWindows through the PyTorch port
(GGT_DEVICE=cpu: the kernels' plain versions): the ABBA goldens at one
rounding quantum on the kernel route and at tol 0 under GGT_ABBA_HOST=1,
the host executor, the jackknife, byte equality with the JAX CLI, the
raw-upload route (GGT_PACKED_TRANSFER=0), and NotImplementedError for
multi-process runs."""

import numpy as np
import pytest

from .test_abba_jackknife import ARGS as JK_ARGS, BS, _read_table
from .test_abba_windows import CONFIGS
from .util import REPO, assert_csv_equal, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
PORT = {"genomics_general_tpu.cli.abba_windows":
        "genomics_general_tpu_torch.cli.abba_windows",
        "genomics_general_tpu.cli.four_pop_windows":
        "genomics_general_tpu_torch.cli.four_pop_windows"}
IDS = [c[0].split(".")[0] for c in CONFIGS]
FOURPOP = CONFIGS[2]


@pytest.mark.parametrize("golden,module,args", CONFIGS, ids=IDS)
@pytest.mark.parametrize("env, tol", [
    ({}, 1.01e-4),                        # the kernel route (K6, K7, K8)
    ({"GGT_EXEC": "host"}, 1.01e-4),      # the host executor
    ({"GGT_ABBA_HOST": "1"}, 0.0),        # per-site counts, host panel
], ids=["kernel", "host_exec", "abba_host"])
def test_port_golden(golden, module, args, env, tol, tmp_path):
    out = tmp_path / "o.csv"
    run_cli(PORT[module], args + ["-o", str(out)], env_extra={**CPU, **env})
    assert_csv_equal(G / golden, out, tol=tol)


@pytest.mark.parametrize("golden,module,args,extra", [
    (*CONFIGS[0], []),
    (*FOURPOP, ["--polarize"]),
    (*FOURPOP, ["--fixed"]),
], ids=["abba_coord", "fourpop_polarize", "fourpop_fixed"])
def test_abba_host_bytes_equal_jax_cli(golden, module, args, extra,
                                       tmp_path):
    """GGT_ABBA_HOST=1 writes the JAX CLI's bytes (fourPop's --polarize
    and --fixed allele choices included)."""
    port, jax_out = tmp_path / "port.csv", tmp_path / "jax.csv"
    env = {"GGT_ABBA_HOST": "1"}
    run_cli(PORT[module], args + extra + ["-o", str(port)],
            env_extra={**CPU, **env})
    run_cli(module, args + extra + ["-o", str(jax_out)], env_extra=env)
    assert port.read_bytes() == jax_out.read_bytes()


@pytest.mark.parametrize("extra", [["--polarize"], ["--fixed"]],
                         ids=["polarize", "fixed"])
def test_fourpop_modes_kernel_route_vs_host_panel(extra, tmp_path):
    """The kernel route's --polarize and --fixed rows agree with the host
    panel's within one rounding quantum."""
    _, module, args = FOURPOP
    kern, host = tmp_path / "kern.csv", tmp_path / "host.csv"
    run_cli(PORT[module], args + extra + ["-o", str(kern)], env_extra=CPU)
    run_cli(PORT[module], args + extra + ["-o", str(host)],
            env_extra={**CPU, "GGT_ABBA_HOST": "1"})
    assert_csv_equal(host, kern, tol=1.01e-4)


def test_jackknife_kernel_and_host_routes_agree(tmp_path):
    """--jackknife from the window sums and from the host panel's ratio
    components (tests/test_abba_jackknife.py:35-51)."""
    tables = {}
    for name, env in (("dev", {}), ("host", {"GGT_ABBA_HOST": "1"})):
        jk = tmp_path / f"{name}.jk.tsv"
        run_cli(PORT["genomics_general_tpu.cli.abba_windows"],
                JK_ARGS + ["-o", str(tmp_path / f"{name}.csv"),
                           "--jackknife", BS, "--jackknifeFile", str(jk)],
                env_extra={**CPU, **env})
        tables[name] = _read_table(jk)
    assert set(tables["dev"]) == {"D", "fd", "fdM"}
    for stat in ("D", "fd", "fdM"):
        a, b = tables["dev"][stat], tables["host"][stat]
        assert a["n_blocks"] == b["n_blocks"] and int(a["n_blocks"]) >= 3
        for col in ("overall", "jackknife_mean", "standard_error"):
            np.testing.assert_allclose(float(a[col]), float(b[col]),
                                       rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("env", [{"GGT_NUM_PROCS": "2"},
                                 {"GGT_PACKED_TRANSFER": "0"}],
                         ids=["multi_process", "raw_upload"])
def test_port_out_of_slice_raises(env, tmp_path):
    """GGT_NUM_PROCS=2 without a coordinator raises, naming the missing
    variable.  GGT_PACKED_TRANSFER=0 writes the packed
    run's bytes (the kernel route ships its flush buffer either way)."""
    golden, module, args = CONFIGS[0]
    if "GGT_NUM_PROCS" in env:
        with pytest.raises(AssertionError,
                           match="ValueError: .*GGT_COORDINATOR"):
            run_cli(PORT[module], args + ["-o", str(tmp_path / "o.csv")],
                    env_extra={**CPU, **env})
        return
    run_cli(PORT[module], args + ["-o", str(tmp_path / "p.csv")],
            env_extra=CPU)
    run_cli(PORT[module], args + ["-o", str(tmp_path / "o.csv")],
            env_extra={**CPU, **env})
    assert (tmp_path / "o.csv").read_bytes() == \
        (tmp_path / "p.csv").read_bytes()


@pytest.mark.parametrize("golden,module,args", CONFIGS, ids=IDS)
@pytest.mark.parametrize("env, tol", [
    ({}, 1.01e-4),                        # the kernel route (K6, K7, K8)
    ({"GGT_ABBA_HOST": "1"}, 0.0),        # per-site counts through K12
], ids=["kernel", "abba_host"])
def test_port_golden_raw_upload(golden, module, args, env, tol, tmp_path):
    """Under GGT_PACKED_TRANSFER=0: the goldens on both routes, and the
    bytes of the packed run."""
    raw, packed = tmp_path / "raw.csv", tmp_path / "packed.csv"
    run_cli(PORT[module], args + ["-o", str(raw)],
            env_extra={**CPU, **env, "GGT_PACKED_TRANSFER": "0"})
    run_cli(PORT[module], args + ["-o", str(packed)],
            env_extra={**CPU, **env})
    assert_csv_equal(G / golden, raw, tol=tol)
    assert raw.read_bytes() == packed.read_bytes()
