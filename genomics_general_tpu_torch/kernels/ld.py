"""Pairwise joint allele tables for LD statistics on the GPU.

The reference computes per-site-pair LD by building a python list of jointly
called haplotypes and calling np.unique per pair (genomics.py:1132-1157 via
LDmatrix :1072-1077) — O(S^2) python calls per window.  Here the whole
window's pairwise 4x4 joint allele tables

    N[x, y, a, b] = sum_h [alleles[h,x] = a] [alleles[h,y] = b]

come from one CUDA kernel, :func:`pair_allele_tables` (K17,
kernels/csrc/ld.cu): the one-hot Gram on the int8 tensor cores, its
upper triangle's tiles written with their mirrors.  A code outside 0..3
(missing is -1) one-hots to zero, so only jointly called haplotypes
count.  All
float64 probability math happens on the host from the exact integer tables
(stats/ld.ld_from_tables), preserving the reference's per-pair biallelic
gate and major-allele tie-breaks.

The wrapper launches the kernel for a CUDA tensor (counting the launch in
``LAUNCHES``) and runs its plain PyTorch version only for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from . import _build
from .pairdist import _check_cuda, _stream_ptr

# launches of the CUDA kernel since the last reset (the plain version never
# counts)
LAUNCHES = {"pair_allele_tables": 0}
# the C entry points, each resolved on its first launch (_build.Entry)
_ggt_pair_allele_tables = _build.Entry("ld", "ggt_pair_allele_tables")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pair_allele_tables(alleles: torch.Tensor) -> torch.Tensor:
    """int8 [H, S] (rows may be strided, sites contiguous) -> int32
    [S, S, 4, 4] joint allele-count tables over jointly called haplotypes.
    Replaces the JAX ``ld.pair_allele_tables``."""
    if alleles.dim() != 2 or alleles.dtype != torch.int8:
        raise ValueError("alleles must be int8 [H, S]")
    if not alleles.is_cuda:
        return pair_allele_tables_plain(alleles)
    if alleles.stride(1) != 1:
        raise ValueError("alleles must have contiguous sites")
    h, S = alleles.shape
    out = torch.empty((S, S, 4, 4), dtype=torch.int32, device=alleles.device)
    if S == 0:
        return out
    onehot = torch.empty(onehot_bytes(h, S), dtype=torch.uint8,
                         device=alleles.device)
    _check_cuda(onehot, out)
    _ggt_pair_allele_tables(
        alleles.data_ptr(), alleles.stride(0), h, S, onehot.data_ptr(),
        out.data_ptr(), _stream_ptr(out))
    LAUNCHES["pair_allele_tables"] += 1
    return out


def onehot_bytes(h: int, S: int) -> int:
    """Bytes of K17's K-major one-hot scratch: a 4 KB block per 32 sites
    and 32 haplotypes (one step at least)."""
    return -(-S // 32) * max(-(-h // 32), 1) * 4096


def pair_allele_tables_plain(alleles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K17, the JAX form: the one-hot Gram
    ``onehot.reshape(H, S*4)^T @ onehot.reshape(H, S*4)`` in float64
    (exact counts), transposed to [S, S, 4, 4] int32."""
    h, S = alleles.shape
    codes = torch.arange(4, dtype=torch.int8, device=alleles.device)
    flat = (alleles[:, :, None] == codes).to(torch.float64).reshape(h, S * 4)
    n = flat.T @ flat
    return n.reshape(S, 4, S, 4).permute(0, 2, 1, 3).to(torch.int32)


def window_pair_tables(alleles: np.ndarray) -> np.ndarray:
    """Host wrapper: numpy [S, S, 4, 4] int32 tables for one window, on
    the device ``GGT_DEVICE`` names (K17 on a card)."""
    dev = get_device()
    a = torch.from_numpy(np.ascontiguousarray(alleles, dtype=np.int8))
    return pair_allele_tables(a.to(dev)).cpu().numpy()
