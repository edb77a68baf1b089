"""Multi-process execution: single process only in this slice of the port.

The JAX package runs one pipeline per host over a hash-sharded scaffold
set (genomics_general_tpu/parallel/multihost.py).  Its torch.distributed
counterpart is still to be ported (ROADMAP queue 1, item 6,
"parallel/multihost.py, full, on torch.distributed"); until then a run is
one process, and asking for more raises instead of silently running a
single-process job.  :func:`mesh_reduce_stacked`, the merge of stacked
accumulators over the devices of one process's mesh, is here.
"""

from __future__ import annotations

import os

import numpy as np


def maybe_initialize() -> None:
    """No-op for one process; raises when ``GGT_NUM_PROCS`` asks for more."""
    n = int(os.environ.get("GGT_NUM_PROCS", 1))
    if n > 1 or os.environ.get("GGT_DIST_AUTO") == "1":
        raise NotImplementedError(
            "multi-process runs (GGT_NUM_PROCS>1, GGT_DIST_AUTO) are not "
            "ported yet: ROADMAP queue 1, item 6 (parallel/multihost.py on "
            "torch.distributed)")


def process_count() -> int:
    return 1


def process_index() -> int:
    return 0


def mesh_reduce_stacked(stacked, mesh, op: str = "sum"):
    """Reduce a host-stacked [k, ...] integer array over a device mesh: the
    k rows are sharded over the mesh's devices (k a multiple of its size,
    as the JAX placement needs), each shard is copied to the first device
    and K16 sums (``op="sum"``) or takes the minimum (``"min"``) there.
    int64 survives exactly.  Returns the [...] numpy result.  Used by the
    multi-device dry run to merge sfs and distMat cat partials."""
    from ..kernels import transfer
    from .mesh import reduce_on_first
    stacked = np.ascontiguousarray(stacked)
    k = stacked.shape[0]
    if k % mesh.size:
        raise ValueError(f"{k} stacked rows do not shard over {mesh.size} "
                         "devices")
    shards = [transfer.to_device(stacked[lo:hi], d) for d, (lo, hi) in
              zip(mesh.devices, transfer.sharded_axis(k, mesh.size))]
    return reduce_on_first(shards, mesh, op)
