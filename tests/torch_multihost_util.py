"""Helpers of the port's multi-process tests (tests/test_torch_multihost_*):
each CLI case runs the JAX CLI in one process, the port in one process, and
the port as gloo ranks, and holds the three outputs byte-equal.

Every rank is a subprocess with a hard deadline: when one rank fails or
the deadline passes, every rank still running is killed, so a hung
rendezvous fails its test instead of running the suite into its limit.
"""

from __future__ import annotations

import gzip
import os
import sys
from pathlib import Path

import numpy as np

from genomics_general_tpu_torch.parallel import launch

from .util import assert_csv_equal

REPO = Path(__file__).resolve().parent.parent
D = REPO / "tests" / "data"
TIMEOUT = 240          # seconds for one group of processes, all ranks


def clean_env(extra: dict | None = None) -> dict:
    """The suite's environment without any multi-process variable, on the
    CPU: the JAX CLI on a 2-device CPU platform, the port under
    ``GGT_DEVICE=cpu`` with one OpenMP thread."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS",
                        "GGT_COORDINATOR", "GGT_NUM_PROCS", "GGT_PROC_ID",
                        "GGT_DIST_AUTO", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK")}
    env.update({
        "PYTHONPATH": str(REPO),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "GGT_DEVICE": "cpu",
        "OMP_NUM_THREADS": "1",
    })
    env.update(extra or {})
    return env


def run_group(argvs: list[list[str]], envs: list[dict], log_dir: Path,
              timeout: float = TIMEOUT) -> list[str]:
    """Every process at once, killed at the deadline or when another
    fails (parallel/launch.run_group); returns each one's stderr."""
    return [err for _, err in launch.run_group(argvs, envs, log_dir,
                                               timeout, cwd=REPO)]


def cli(module: str, args: list[str]) -> list[str]:
    return [sys.executable, "-m", module, *args]


def rank_envs(n: int, extra: dict | None = None,
              auto: bool = False) -> list[dict]:
    """One environment per rank: the ``GGT_COORDINATOR`` contract, or the
    ``env://`` variables under ``GGT_DIST_AUTO=1``."""
    port = launch.free_port()
    if auto:
        return [clean_env({"GGT_DIST_AUTO": "1", "MASTER_ADDR": "127.0.0.1",
                           "MASTER_PORT": str(port), "WORLD_SIZE": str(n),
                           "RANK": str(r), **(extra or {})})
                for r in range(n)]
    return [clean_env({"GGT_COORDINATOR": f"127.0.0.1:{port}",
                       "GGT_NUM_PROCS": str(n), "GGT_PROC_ID": str(r),
                       **(extra or {})})
            for r in range(n)]


def read_output(path: Path) -> bytes:
    """A file's bytes; a .gz file's content (its header carries an mtime)."""
    if path.suffix == ".gz":
        with gzip.open(path) as f:
            return f.read()
    return path.read_bytes()


def check_cli(tmp_path: Path, module: str, args_for, outputs,
              env: dict | None = None, dist_args_for=None,
              auto: bool = False, n_ranks: int = 2,
              jax_equal=None) -> list[str]:
    """The JAX CLI and the port, each in one process, then the port as
    ``n_ranks`` gloo ranks, all with ``env`` added.  ``args_for(tag)``
    gives the CLI arguments writing under ``tmp_path / tag``;
    ``outputs(tag)`` the files to compare (``dist_args_for`` overrides the
    ranks' arguments, e.g. an indexed copy of the input).  Every output
    must be non-empty, and byte-equal between the ranks and the port's one
    process; the JAX CLI's must be byte-equal too, or pass
    ``jax_equal(jax_path, port_path)`` where one is given.  Returns the
    ranks' stderr."""
    jax_mod = module.replace("genomics_general_tpu_torch.",
                             "genomics_general_tpu.")
    run_group([cli(jax_mod, args_for("jax")), cli(module, args_for("one"))],
              [clean_env(env), clean_env(env)], tmp_path / "logs_one")
    dist_args_for = dist_args_for or args_for
    errs = run_group([cli(module, dist_args_for("dist"))] * n_ranks,
                     rank_envs(n_ranks, env, auto), tmp_path / "logs_d")
    for jax_out, one_out, dist_out in zip(outputs("jax"), outputs("one"),
                                          outputs("dist")):
        one = read_output(one_out)
        assert one, one_out
        assert read_output(dist_out) == one, (dist_out, one_out)
        if jax_equal is None:
            assert read_output(jax_out) == one, (jax_out, one_out)
        else:
            jax_equal(jax_out, one_out)
    return errs


def abba_within_quantum(jax_path, port_path):
    """The kernel route's disclosed tolerance against the JAX device
    path: one 4-decimal quantum in the CSV (tests/test_abba_windows.py:44),
    rtol 1e-8 in the jackknife table (test_torch_abba_windows.py)."""
    if jax_path.suffix == ".csv":
        assert_csv_equal(jax_path, port_path, tol=1.01e-4)
        return
    a, b = (np.loadtxt(p, dtype=object, delimiter="\t", skiprows=1)
            for p in (jax_path, port_path))
    assert (a[:, 0] == b[:, 0]).all()
    np.testing.assert_allclose(a[:, 1:].astype(float),
                               b[:, 1:].astype(float), rtol=1e-8, atol=1e-12)


def indexed_copy(tmp_path: Path, src: Path = D / "sim1.geno.gz") -> Path:
    """A BGZF copy of ``src`` with its ``.tbi`` (the port's io/tabix)."""
    from genomics_general_tpu_torch.io import tabix as T
    bgz = tmp_path / (src.name.split(".")[0] + ".geno.bgz")
    T.bgzip_file(str(src), str(bgz))
    T.build_index(str(bgz), preset="geno")
    return bgz
