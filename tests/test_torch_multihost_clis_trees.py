"""Two gloo ranks of the port's distMat, distPaint, phymlSlidingWindows and
raxmlSlidingWindows (GGT_DEVICE=cpu), each byte-identical to the port's
one-process run, itself byte-identical to the JAX CLI's: the distance and
tree cases of tests/test_multihost.py (distMat cat's packed int64 sum among
them), and one run launched through ``GGT_DIST_AUTO=1`` with the
``env://`` variables that torchrun sets."""

import pytest

from .torch_multihost_util import D, check_cli

pytestmark = pytest.mark.multihost

DIST_MAT = "genomics_general_tpu_torch.cli.dist_mat"
DIST_PAINT = "genomics_general_tpu_torch.cli.dist_paint"
PHYML = "genomics_general_tpu_torch.cli.phyml_sliding_windows"
RAXML = "genomics_general_tpu_torch.cli.raxml_sliding_windows"
SIM1 = ["-g", str(D / "sim1.geno.gz")]


def test_two_ranks_dist_mat_windowed(tmp_path):
    """Matrices and window rows, two process-0 writers."""
    check_cli(tmp_path, DIST_MAT,
              lambda tag: [*SIM1, "-f", "phased", "--windType", "coordinate",
                           "-w", "50000", "-m", "10", "--outFormat", "phylip",
                           "--windowDataOutFile",
                           str(tmp_path / f"{tag}.meta"),
                           "--writeFailedWindows",
                           "-o", str(tmp_path / f"{tag}.phy")],
              lambda tag: [tmp_path / f"{tag}.phy", tmp_path / f"{tag}.meta"])


@pytest.mark.parametrize("auto", [False, True],
                         ids=["coordinator", "dist_auto"])
def test_two_ranks_dist_mat_cat(tmp_path, auto):
    """cat mode: the ranks' [H, H] pair counts, called counts and site
    total summed by one collective; rank 0 writes the matrix."""
    check_cli(tmp_path, DIST_MAT,
              lambda tag: [*SIM1, "-f", "phased", "--windType", "cat",
                           "--outFormat", "phylip",
                           "-o", str(tmp_path / f"{tag}.phy")],
              lambda tag: [tmp_path / f"{tag}.phy"], auto=auto)


def test_two_ranks_dist_paint(tmp_path):
    check_cli(tmp_path, DIST_PAINT,
              lambda tag: ["-g", str(D / "sim_paint.geno.gz"),
                           "-w", "50000", "-s", "25000", "-m", "50",
                           "-p", "pop1", "-p", "pop2", "-p", "pop3",
                           "--popsFile", str(D / "sim_paint.pops.txt"),
                           "--writeFailedWindows",
                           "-o", str(tmp_path / f"{tag}.tsv")],
              lambda tag: [tmp_path / f"{tag}.tsv"])


@pytest.mark.parametrize("module, flags", [
    (PHYML, ["--phyml", "builtin-nj"]),
    (RAXML, ["--raxml", "builtin-nj", "-T", "2"]),
], ids=["phyml", "raxml"])
def test_two_ranks_trees_nj(tmp_path, module, flags):
    """data.tsv and the trees (compared after gunzip: the gzip header
    carries an mtime)."""
    check_cli(tmp_path, module,
              lambda tag: [*SIM1, "--windType", "coordinate", "-w", "50000",
                           "-M", "10", *flags, "-p", str(tmp_path / tag)],
              lambda tag: [tmp_path / f"{tag}.data.tsv",
                           tmp_path / f"{tag}.trees.gz"])
