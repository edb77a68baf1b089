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
    "genomics_general_tpu_torch.regions",
    "genomics_general_tpu_torch.engine",
    "genomics_general_tpu_torch.testing",
    "genomics_general_tpu_torch.io",
    "genomics_general_tpu_torch.io.native",
    "genomics_general_tpu_torch.io.bam",
    "genomics_general_tpu_torch.io.tabix",
    "genomics_general_tpu_torch.io.geno",
    "genomics_general_tpu_torch.io.writers",
    "genomics_general_tpu_torch.io.seqio",
    "genomics_general_tpu_torch.io.table",
    "genomics_general_tpu_torch.io.vcf",
    "genomics_general_tpu_torch.io.vcf_fast",
    "genomics_general_tpu_torch.cds",
    "genomics_general_tpu_torch.stats",
    "genomics_general_tpu_torch.stats.popgen",
    "genomics_general_tpu_torch.stats.abbababa",
    "genomics_general_tpu_torch.stats.jackknife",
    "genomics_general_tpu_torch.stats.sfs",
    "genomics_general_tpu_torch.stats.sfs_accum",
    "genomics_general_tpu_torch.stats.filters",
    "genomics_general_tpu_torch.stats.ld",
    "genomics_general_tpu_torch.stats.nj",
    "genomics_general_tpu_torch.parallel",
    "genomics_general_tpu_torch.parallel.multihost",
    "genomics_general_tpu_torch.parallel.mesh",
    "genomics_general_tpu_torch.parallel.dispatch",
    "genomics_general_tpu_torch.parallel.hostpool",
    "genomics_general_tpu_torch.parallel.launch",
    "genomics_general_tpu_torch.kernels",
    "genomics_general_tpu_torch.kernels._build",
    "genomics_general_tpu_torch.kernels.transfer",
    "genomics_general_tpu_torch.kernels.pairdist",
    "genomics_general_tpu_torch.kernels.counts",
    "genomics_general_tpu_torch.kernels.abba",
    "genomics_general_tpu_torch.kernels.window_stats",
    "genomics_general_tpu_torch.kernels.ld",
    "genomics_general_tpu_torch.entry",
    "genomics_general_tpu_torch.cli",
    "genomics_general_tpu_torch.cli.common",
    "genomics_general_tpu_torch.cli.popgen_windows",
    "genomics_general_tpu_torch.cli.abba_windows",
    "genomics_general_tpu_torch.cli.four_pop_windows",
    "genomics_general_tpu_torch.cli.dist_mat",
    "genomics_general_tpu_torch.cli.dist_paint",
    "genomics_general_tpu_torch.cli.freq",
    "genomics_general_tpu_torch.cli.sfs",
    "genomics_general_tpu_torch.cli.filter_genotypes",
    "genomics_general_tpu_torch.cli.phyml_sliding_windows",
    "genomics_general_tpu_torch.cli.raxml_sliding_windows",
    "genomics_general_tpu_torch.cli.count_genotype_patterns",
    "genomics_general_tpu_torch.cli.fasta_transfer",
    "genomics_general_tpu_torch.cli.geno_to_eigenstrat",
    "genomics_general_tpu_torch.cli.geno_to_plink",
    "genomics_general_tpu_torch.cli.geno_to_seq",
    "genomics_general_tpu_torch.cli.geno_to_vcf",
    "genomics_general_tpu_torch.cli.jackknife",
    "genomics_general_tpu_torch.cli.maf_to_geno",
    "genomics_general_tpu_torch.cli.merge_geno",
    "genomics_general_tpu_torch.cli.seq_to_geno",
    "genomics_general_tpu_torch.cli.sequence",
    "genomics_general_tpu_torch.cli.transfer_scaf_pos",
    "genomics_general_tpu_torch.cli.window_stats",
    "genomics_general_tpu_torch.cli.parse_vcf",
    "genomics_general_tpu_torch.cli.parse_vcfs",
    "genomics_general_tpu_torch.cli.tabix_index",
    "genomics_general_tpu_torch.cli.vcf_chrom_transfer",
    "genomics_general_tpu_torch.cli.coding_site_types",
    "genomics_general_tpu_torch.cli.extract_cds_alignments",
    "genomics_general_tpu_torch.cli.filter_sam_by_target_base",
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


@pytest.mark.parametrize("script", ["chip_smoke.py", "mesh_cards.py"])
def test_card_scripts_need_cards_and_no_jax(script):
    """The card scripts import nothing of JAX and, without a CUDA card,
    exit non-zero having printed no result."""
    mod = script[:-3]
    r = subprocess.run([sys.executable, "-c", _PROBE, mod],
                       capture_output=True, text=True, env=_env(), cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = json.loads(r.stdout.strip().splitlines()[-1])
    assert mod in mods
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "genomics_general_tpu")]
    r = subprocess.run([sys.executable, script], capture_output=True,
                       text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
                       cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_timing_script_needs_a_card_and_no_jax():
    """kernel_ab.py (two checkouts' K9, K12, K14, K18 and K20 timed on one
    card) imports nothing of JAX and, without a CUDA card, exits non-zero
    having printed no result."""
    r = subprocess.run([sys.executable, "-c", _PROBE, "kernel_ab"],
                       capture_output=True, text=True, env=_env(), cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = json.loads(r.stdout.strip().splitlines()[-1])
    assert "kernel_ab" in mods
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "genomics_general_tpu")]
    r = subprocess.run([sys.executable, "kernel_ab.py", "--base", "."],
                       capture_output=True, text=True,
                       env=_env(CUDA_VISIBLE_DEVICES=""), cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
