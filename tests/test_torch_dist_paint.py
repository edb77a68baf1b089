"""distPaint through the PyTorch port (GGT_DEVICE=cpu: the kernels' plain
versions): both distPaint goldens at tol 0, and the host executor and the
raw GGT_PACKED_TRANSFER=0 route (K9 + K4) writing the same bytes."""

import pytest

from .util import REPO, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
PORT = "genomics_general_tpu_torch.cli.dist_paint"
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
BASE = ["-g", str(D / "sim_paint.geno.gz"), "-p", "pop1", "-p", "pop2",
        "-p", "pop3", "--popsFile", str(D / "sim_paint.pops.txt")]
GOLDENS = {
    "distpaint_test.tsv": ["-w", "50000", "-s", "25000", "-m", "50",
                           "--writeFailedWindows"],
    "distpaint_delta.tsv": ["--windType", "sites", "-w", "200", "-m", "100",
                            "--delta_threshold", "0.02", "--addWindowID"],
}


@pytest.mark.parametrize("golden", sorted(GOLDENS))
@pytest.mark.parametrize("env", [{}, {"GGT_EXEC": "host"},
                                 {"GGT_PACKED_TRANSFER": "0"}],
                         ids=["kernel", "host", "raw_upload"])
def test_port_golden(tmp_path, golden, env):
    out = tmp_path / "o.tsv"
    run_cli(PORT, BASE + GOLDENS[golden] + ["-o", str(out)],
            env_extra={**CPU, **env})
    assert out.read_text() == (G / golden).read_text()
