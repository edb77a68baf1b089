"""The fused window-statistics step (the JAX package's "forward step").

:func:`window_stats_step` takes the encoded haplotype matrix plus a window
batch and produces per-window population statistics on the device in
float32, as the JAX ``window_stats_step`` does: the pair counts (K9
:func:`pairdist.pair_counts_4state`), the masked block means pi / dxy and
Fst (K10 :func:`window_stats_tail`) and the per-population allele counts
(K11 :func:`window_pop_counts`), both in kernels/csrc/window_stats.cu.  The
CSV-exact production path instead finalizes integer counts in float64 on
the host (stats/popgen.py).

Each wrapper launches its kernel for CUDA tensors (counting the launch in
``LAUNCHES``) and runs its plain PyTorch version only for CPU tensors.
The plain K10 sums in the kernel's own fixed order (:func:`_fixed_sum`),
so on the same inputs the two agree bit for bit; against the JAX function,
whose XLA sums run in another order, they agree to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from . import _build
from . import pairdist

LAUNCHES = {"window_stats_tail": 0, "window_pop_counts": 0}
_NT = 1024                       # window_stats.cu: K10 threads per block
# windows per launch of the step's kernels: K9 and K11 put the window on a
# grid axis of at most 65,535 blocks
STEP_CHUNK = 65535


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _as_tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, dtype).contiguous()


# --------------------------------------------------------- K10 the tail

def window_stats_tail(m: torch.Tensor, s: torch.Tensor,
                      pop_mask: torch.Tensor):
    """float32 (pi [B, P], dxy [B, P, P], fst [B, P, P]) from the pair
    counts int32 [B, H, H] and the float32 [P, H] mask (entries >= 0).
    Replaces the epilogue of the JAX ``window_stats_step``."""
    if not m.is_cuda:
        return window_stats_tail_plain(m, s, pop_mask)
    for t in (m, s, pop_mask):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous CUDA tensors")
    if m.dtype != torch.int32 or s.dtype != torch.int32 or \
            pop_mask.dtype != torch.float32:
        raise ValueError("counts must be int32 and the mask float32")
    B, h, _ = m.shape
    P = pop_mask.shape[0]
    pi = torch.empty((B, P), dtype=torch.float32, device=m.device)
    dxy = torch.empty((B, P, P), dtype=torch.float32, device=m.device)
    fst = torch.empty_like(dxy)
    if B == 0 or P == 0:
        return pi, dxy, fst
    code = _build.lib("window_stats").ggt_window_stats_tail(
        m.data_ptr(), s.data_ptr(), pop_mask.data_ptr(), h, P, B,
        pi.data_ptr(), dxy.data_ptr(), fst.data_ptr(),
        pairdist._stream_ptr(m))
    _build.check(code, "window_stats_tail")
    LAUNCHES["window_stats_tail"] += 1
    return pi, dxy, fst


def _fixed_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in K10's order: term p goes to lane
    p % 1024, each lane adds its terms in order, then a binary tree adds
    lane t + stride into lane t.  Float32 in, float32 out."""
    n = terms.shape[-1]
    k = max(1, -(-n // _NT))
    pad = torch.zeros((*terms.shape[:-1], k * _NT - n), dtype=terms.dtype,
                      device=terms.device)
    x = torch.cat([terms, pad], dim=-1).reshape(*terms.shape[:-1], k, _NT)
    acc = torch.zeros((*terms.shape[:-1], _NT), dtype=terms.dtype,
                      device=terms.device)
    for r in range(k):
        acc = acc + x[..., r, :]
    stride = _NT // 2
    while stride:
        acc = acc[..., :stride] + acc[..., stride:2 * stride]
        stride //= 2
    return acc[..., 0]


def window_stats_tail_plain(m: torch.Tensor, s: torch.Tensor,
                            pop_mask: torch.Tensor):
    """Plain PyTorch K10: the JAX ``_block_nanmean`` means and Fst, each
    block's pairs listed (rows of weight > 0 in order, row-major) and
    summed with :func:`_fixed_sum`."""
    B, h, _ = m.shape
    pm = pop_mask.to(m.device, torch.float32)
    P = pm.shape[0]
    n_pop = _fixed_sum(pm)                                        # [P]

    def block_mean(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        iu = torch.nonzero(u > 0).flatten()
        jv = torch.nonzero(v > 0).flatten()
        ii, jj = iu[:, None], jv[None, :]
        sv = s[:, ii, jj]                                     # [B, nu, nv]
        ok = (ii != jj)[None] & (sv > 0)
        wgt = torch.where(ok, (u[iu][:, None] * v[jv][None, :])[None],
                          torch.zeros((), device=m.device))
        dist = m[:, ii, jj].to(torch.float32) / \
            sv.clamp(min=1).to(torch.float32)
        d = torch.where(wgt > 0, dist, torch.zeros((), device=m.device))
        return _fixed_sum(d.reshape(B, -1)) / _fixed_sum(wgt.reshape(B, -1))

    dmean = torch.stack([torch.stack([block_mean(pm[a], pm[b])
                                      for b in range(P)], dim=1)
                         for a in range(P)], dim=1)           # [B, P, P]
    pooled = torch.empty_like(dmean)
    for a in range(P):
        for b in range(P):
            u = torch.clamp(pm[a] + pm[b], 0, 1)
            pooled[:, a, b] = block_mean(u, u)
    pi = torch.diagonal(dmean, dim1=1, dim2=2).contiguous()     # [B, P]
    w = n_pop[:, None] / (n_pop[:, None] + n_pop[None, :])
    pi_s = w[None] * pi[:, :, None] + (1 - w[None]) * pi[:, None, :]
    return pi, dmean, 1 - pi_s / pooled


# -------------------------------------------------- K11 the pop counts

def window_pop_counts(alleles: torch.Tensor, first: torch.Tensor,
                      n_sites: torch.Tensor, pop_mask: torch.Tensor):
    """int32 [B, P, 4]: per window and population, the number of
    (haplotype, site) cells of each code 0..3 over the population's rows
    (a 0/1 [P, H] mask) and the window's sites.  Replaces the allele
    counts of the JAX ``window_stats_step``."""
    if not alleles.is_cuda:
        return window_pop_counts_plain(alleles, first, n_sites, pop_mask)
    if alleles.dtype != torch.int8 or alleles.stride(1) != 1 or \
            pop_mask.dtype != torch.float32 or first.dtype != torch.int32 \
            or n_sites.dtype != torch.int32:
        raise ValueError("alleles int8 [H, S], first/n_sites int32, mask "
                         "float32")
    for t in (first, n_sites, pop_mask):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous CUDA tensors")
    h, S = alleles.shape
    B, P = first.shape[0], pop_mask.shape[0]
    out = torch.zeros((B, P, 4), dtype=torch.int32, device=alleles.device)
    if B == 0 or P == 0 or h == 0:
        return out
    if B > 65535:
        raise ValueError(f"{B} windows in one launch (at most 65535)")
    code = _build.lib("window_stats").ggt_window_pop_counts(
        alleles.data_ptr(), alleles.stride(0), S, first.data_ptr(),
        n_sites.data_ptr(), pop_mask.data_ptr(), h, P, B, out.data_ptr(),
        pairdist._stream_ptr(out))
    _build.check(code, "window_pop_counts")
    LAUNCHES["window_pop_counts"] += 1
    return out


def window_pop_counts_plain(alleles: torch.Tensor, first: torch.Tensor,
                            n_sites: torch.Tensor, pop_mask: torch.Tensor):
    """Plain PyTorch K11, the JAX form: gather the windows, count each
    code per row, and sum the rows of each population (exact in float64)."""
    h, S = alleles.shape
    dev = alleles.device
    f, n = first.long().to(dev), n_sites.long().to(dev)
    B = f.shape[0]
    s_max = max(int(n.max()) if B else 0, 1)
    offs = torch.arange(s_max, device=dev)
    idx = f[:, None] + offs[None, :]
    valid = (offs[None, :] < n[:, None]) & (idx >= 0) & (idx < S)
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    wa = alleles[:, idx]                                       # [H, B, s]
    member = (pop_mask.to(dev) != 0).to(torch.float64)         # [P, H]
    per_row = torch.stack([((wa == c) & valid[None]).sum(dim=2)
                           for c in range(4)], dim=-1)         # [H, B, 4]
    out = torch.einsum("ph,hbc->bpc", member, per_row.to(torch.float64))
    return out.to(torch.int32)


# ------------------------------------------------------------ the step

def window_stats_step(alleles, first, n_sites, pop_mask):
    """Forward step over one window batch, the port of the JAX
    ``window_stats_step`` (each window is read at its own length, so there
    is no ``s_max``).

    ``alleles`` int8 [H, S] (0..3, -1 missing), ``first`` / ``n_sites``
    int32 [B] window spans, ``pop_mask`` float32 [P, H] 0/1 population
    membership: numpy arrays (uploaded to ``get_device()``) or tensors on
    one device.  Returns the JAX dict on that device: float32 ``pi``
    [B, P], ``dxy`` and ``fst`` [B, P, P], int32 ``mismatch`` and
    ``shared`` [B, H, H] and ``pop_counts`` [B, P, 4].  Any B: the kernels
    run ``STEP_CHUNK`` windows at a time (on every device, so the CPU
    tests hold the chunking too) and the outputs join in window order."""
    if isinstance(pop_mask, np.ndarray) and \
            not np.isin(pop_mask, (0.0, 1.0)).all():
        raise ValueError("pop_mask must be 0/1 population membership")
    dev = alleles.device if isinstance(alleles, torch.Tensor) \
        else get_device()
    a = alleles if isinstance(alleles, torch.Tensor) and \
        alleles.dtype == torch.int8 and alleles.stride(-1) == 1 \
        else _as_tensor(alleles, torch.int8, dev)
    f = _as_tensor(first, torch.int32, dev)
    n = _as_tensor(n_sites, torch.int32, dev)
    pm = _as_tensor(pop_mask, torch.float32, dev)
    s_max = int(np.max(n_sites)) if isinstance(n_sites, np.ndarray) \
        and n_sites.size else None
    parts = []
    for w0 in range(0, max(f.shape[0], 1), STEP_CHUNK):
        fc, nc = f[w0:w0 + STEP_CHUNK], n[w0:w0 + STEP_CHUNK]
        mismatch, shared = pairdist.pair_counts_4state(a, fc, nc, s_max)
        pi, dxy, fst = window_stats_tail(mismatch, shared, pm)
        parts.append({"pi": pi, "dxy": dxy, "fst": fst,
                      "mismatch": mismatch, "shared": shared,
                      "pop_counts": window_pop_counts(a, fc, nc, pm)})
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
