"""Default device-mesh selection for the CLIs (the port of
genomics_general_tpu/parallel/dispatch.py).

On one card the dispatches run their single-device routes; with more than
one local CUDA device they shard the window batch (data-parallel) or the
site axis (sequence-parallel) over a one-axis ``data`` mesh
(parallel/mesh.py).  ``GGT_NO_MESH=1`` forces the single-device routes
(used to hold the sharded routes against them), and ``GGT_DEVICE=cpu``
runs on the CPU alone.
"""

from __future__ import annotations

import os


def default_mesh():
    """A mesh over the distinct local CUDA devices, or None with fewer than
    two cards, under ``GGT_NO_MESH=1`` or under ``GGT_DEVICE=cpu``.  The
    mesh is local only: a multi-process run shards its input over the
    processes at the scaffold level (parallel/multihost.py)."""
    if os.environ.get("GGT_NO_MESH") == "1" or \
            os.environ.get("GGT_DEVICE") == "cpu":
        return None
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        return None
    from .mesh import Mesh
    return Mesh([torch.device("cuda", i) for i in range(n)])
