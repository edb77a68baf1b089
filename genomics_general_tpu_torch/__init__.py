"""genomics_general_tpu_torch — the PyTorch/CUDA port of genomics_general_tpu.

The same engine, on an NVIDIA H100 instead of a TPU: host parsing, window
planning, float64 finalize and CSV emission are copies of the JAX
package's host modules (same module names, so each has an obvious
counterpart), and every device kernel on a ported path is a CUDA C++
kernel written by hand for ``sm_90a`` (``kernels/csrc``), bound with
``ctypes`` and built by ``nvcc`` on first use.

The package imports ``torch`` and never ``jax`` or any module of
``genomics_general_tpu``.  Entry points run on the card (``GGT_DEVICE``
defaults to ``cuda``); ``GGT_DEVICE=cpu`` runs the kernels' plain PyTorch
versions instead (device.py).
"""

__version__ = "0.1.0"

from . import encoding  # noqa: F401

__all__ = ["encoding"]
