"""Device selection for the port's entry points.

``GGT_DEVICE`` names the torch device the kernels run on: ``cuda`` (the
default) or ``cpu``.  Asking for ``cuda`` on a machine without a usable
card raises: a run never moves to the CPU on its own, so a timing or a
launch count can never come from the wrong device.  On the CPU the kernel
wrappers run their plain PyTorch versions.
"""

from __future__ import annotations

import os

import torch

_CHOICES = ("cuda", "cpu")


def get_device() -> torch.device:
    """The device named by ``GGT_DEVICE`` (default ``cuda``)."""
    name = os.environ.get("GGT_DEVICE", "cuda")
    if name not in _CHOICES:
        raise ValueError(f"GGT_DEVICE={name!r}: expected one of {_CHOICES}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "GGT_DEVICE=cuda (the default) but torch.cuda.is_available() is "
            "False; set GGT_DEVICE=cpu to run the plain PyTorch kernels on "
            "the CPU")
    if name == "cpu":
        cap_cpu_threads()
    return torch.device(name)


def cap_cpu_threads() -> None:
    """Cap torch's intra-op CPU threads at ``OMP_NUM_THREADS`` (default 4):
    CPU runs are tests and small checks, often several processes at once,
    and torch otherwise takes one thread per core in each of them."""
    limit = int(os.environ.get("OMP_NUM_THREADS", 4))
    torch.set_num_threads(max(1, min(torch.get_num_threads(), limit)))
