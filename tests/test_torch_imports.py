"""The PyTorch port imports neither jax nor any module of the JAX package,
and asks for the card unless told to use the CPU."""

import json
import subprocess
import sys

import pytest

from .util import REPO

PORT_MODULES = [
    "genomics_general_tpu_torch",
    "genomics_general_tpu_torch._buildcache",
    "genomics_general_tpu_torch.device",
    "genomics_general_tpu_torch.encoding",
    "genomics_general_tpu_torch.samples",
    "genomics_general_tpu_torch.windows",
    "genomics_general_tpu_torch.engine",
    "genomics_general_tpu_torch.testing",
    "genomics_general_tpu_torch.io",
    "genomics_general_tpu_torch.io.native",
    "genomics_general_tpu_torch.io.geno",
    "genomics_general_tpu_torch.io.writers",
    "genomics_general_tpu_torch.stats",
    "genomics_general_tpu_torch.stats.popgen",
    "genomics_general_tpu_torch.stats.abbababa",
    "genomics_general_tpu_torch.stats.jackknife",
    "genomics_general_tpu_torch.parallel",
    "genomics_general_tpu_torch.parallel.multihost",
    "genomics_general_tpu_torch.kernels",
    "genomics_general_tpu_torch.kernels._build",
    "genomics_general_tpu_torch.kernels.transfer",
    "genomics_general_tpu_torch.kernels.pairdist",
    "genomics_general_tpu_torch.kernels.counts",
    "genomics_general_tpu_torch.kernels.abba",
    "genomics_general_tpu_torch.cli",
    "genomics_general_tpu_torch.cli.common",
    "genomics_general_tpu_torch.cli.popgen_windows",
    "genomics_general_tpu_torch.cli.abba_windows",
    "genomics_general_tpu_torch.cli.four_pop_windows",
]

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted(sys.modules)))
"""


def _env(**extra):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "OMP_NUM_THREADS": "1"}
    env.update(extra)
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE, *PORT_MODULES],
                       capture_output=True, text=True, env=_env(), cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = json.loads(r.stdout.strip().splitlines()[-1])
    assert "jax" not in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib")]
    jax_pkg = [m for m in mods if m == "genomics_general_tpu"
               or m.startswith("genomics_general_tpu.")]
    assert not jax_pkg, jax_pkg
    assert set(PORT_MODULES) <= set(mods)


@pytest.mark.parametrize("device, ok", [("cpu", True), ("cuda", False),
                                         ("tpu", False)])
def test_device_choice(device, ok):
    """GGT_DEVICE=cpu runs on the CPU; cuda without a card and unknown
    names raise instead of moving to the CPU."""
    import torch
    if device == "cuda" and torch.cuda.is_available():
        ok = True
    code = ("from genomics_general_tpu_torch.device import get_device; "
            "print(get_device().type)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(GGT_DEVICE=device), cwd=REPO,
                       timeout=300)
    if ok:
        assert r.returncode == 0 and r.stdout.strip() == device, r.stderr
    else:
        assert r.returncode != 0
        assert "GGT_DEVICE" in r.stderr
