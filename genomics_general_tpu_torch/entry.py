"""The port's counterpart of ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, example_args)``: the fused window-statistics
step (K9 pair counts, K10 pi / dxy / Fst, K11 allele counts) and the same
example data as the JAX entry (``np.random.default_rng(0)``), on
``get_device()`` (the card unless ``GGT_DEVICE=cpu``).  The multi-device
dry run waits for the multi-GPU port (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import get_device
from .kernels.window_stats import window_stats_step


def _example_data(n_sites=4096, n_ind=8, seed=0):
    rng = np.random.default_rng(seed)
    H = n_ind * 2
    alleles = rng.integers(0, 4, size=(H, n_sites)).astype(np.int8)
    alleles[rng.random((H, n_sites)) < 0.05] = -1
    pop_mask = np.zeros((2, H), dtype=np.float32)
    pop_mask[0, :H // 2] = 1
    pop_mask[1, H // 2:] = 1
    n_windows = 8
    first = np.arange(0, n_sites, n_sites // n_windows,
                      dtype=np.int32)[:n_windows]
    n_s = np.full(n_windows, n_sites // n_windows, dtype=np.int32)
    return alleles, first, n_s, pop_mask


def entry():
    """Return (fn, example_args): the forward step and its example
    tensors on the device."""
    dev = get_device()
    example_args = tuple(torch.from_numpy(x).to(dev)
                         for x in _example_data())
    return window_stats_step, example_args


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", {k: tuple(v.shape) for k, v in out.items()})
