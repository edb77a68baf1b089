"""Multi-process execution: single process only in this slice of the port.

The JAX package runs one pipeline per host over a hash-sharded scaffold
set (genomics_general_tpu/parallel/multihost.py).  Its torch.distributed
counterpart is still to be ported (ROADMAP queue 1, "parallel/multihost.py,
full, on torch.distributed"); until then a run is one process, and asking
for more raises instead of silently running a single-process job.
"""

from __future__ import annotations

import os


def maybe_initialize() -> None:
    """No-op for one process; raises when ``GGT_NUM_PROCS`` asks for more."""
    n = int(os.environ.get("GGT_NUM_PROCS", 1))
    if n > 1 or os.environ.get("GGT_DIST_AUTO") == "1":
        raise NotImplementedError(
            "multi-process runs (GGT_NUM_PROCS>1, GGT_DIST_AUTO) are not "
            "ported yet: ROADMAP queue 1, parallel/multihost.py on "
            "torch.distributed")


def process_count() -> int:
    return 1


def process_index() -> int:
    return 0
