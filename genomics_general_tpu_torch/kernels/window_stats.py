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
``LAUNCHES``; K10's two launches count once) and runs its plain PyTorch
version only for CPU tensors.  K10 works on the mask's membership classes
(:class:`TailClasses`); its plain version sums in the kernel's own fixed
order (:func:`_fixed_sum`), so on the same inputs the two agree bit for
bit; against the JAX function, whose XLA sums run in another order, they
agree to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from . import _build
from . import pairdist

LAUNCHES = {"window_stats_tail": 0, "window_pop_counts": 0}
# the C entry points, each resolved on its first launch (_build.Entry)
_ggt_window_stats_tail = _build.Entry("window_stats", "ggt_window_stats_tail")
_ggt_window_pop_counts = _build.Entry("window_stats", "ggt_window_pop_counts")
_NT = 1024                       # lanes of a population size's sum
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

class TailClasses:
    """A float32 mask [P, H] (entries >= 0; rows may overlap, lie in no
    population or carry fractional weights) as the membership classes K10
    takes: the haplotype rows grouped by their column ``mask[:, i]``, one
    class per distinct column in order of its first row, the all-zero
    column (rows in no population) dropped.

    ``members`` (host int64 [n_rows]) lists the classes' rows class by
    class, each class's rows ascending, ``starts`` (host int64 [C + 1])
    bounds each class's run; ``weights`` float32 [C, P] is each class's
    column and ``n_pop`` float32 [P] each population's size
    (:func:`_fixed_sum` of its mask row).  ``ints`` and ``floats`` hold
    them on ``device`` as window_stats.cu reads them: int32 [members |
    starts | pos] (pos [H]: a row's place in ``members``, -1 for none) and
    float32 [weights | n_pop]."""

    def __init__(self, pop_mask: np.ndarray, device):
        pm = np.ascontiguousarray(pop_mask, dtype=np.float32)
        if pm.ndim != 2:
            raise ValueError("pop_mask must be [P, H]")
        P, h = pm.shape
        cols = pm.T + np.float32(0)             # -0.0 reads as 0.0
        cls = np.full(h, -1, np.int64)
        if h and P:
            uniq, first, inv = np.unique(cols, axis=0, return_index=True,
                                         return_inverse=True)
            order = [u for u in np.argsort(first, kind="stable")
                     if (uniq[u] != 0).any()]
            rank = np.full(uniq.shape[0], -1, np.int64)
            rank[order] = np.arange(len(order))
            cls = rank[inv.reshape(-1)]
        self.C = int(cls.max(initial=-1)) + 1
        rows = np.flatnonzero(cls >= 0)
        self.members = rows[np.argsort(cls[rows], kind="stable")]
        self.n_rows = int(self.members.shape[0])
        self.starts = np.zeros(self.C + 1, np.int64)
        np.cumsum(np.bincount(cls[rows], minlength=self.C),
                  out=self.starts[1:])
        self.weights = np.ascontiguousarray(
            cols[self.members[self.starts[:-1]]], dtype=np.float32)
        self.n_pop = _fixed_sum(torch.from_numpy(pm)).numpy()
        pos = np.full(h, -1, np.int64)
        pos[self.members] = np.arange(self.n_rows)
        self.device = device
        self.ints = torch.from_numpy(np.concatenate(
            [self.members, self.starts, pos]).astype(np.int32)).to(device)
        self.floats = torch.from_numpy(np.concatenate(
            [self.weights.reshape(-1), self.n_pop]).astype(
                np.float32)).to(device)


# the classes of the masks last seen as tensors: (tensor, its version,
# TailClasses), so a mask on the card is read back once, not every call
# (nor inside a CUDA graph's capture)
_MASKS: list = []
_MAX_MASKS = 8


def tail_classes(pop_mask, device) -> TailClasses:
    """The :class:`TailClasses` of a mask (numpy array or tensor) on
    ``device``: built once per distinct mask (``pairdist._run_const``), and
    a tensor mask is read to the host once while it is unchanged."""
    if isinstance(pop_mask, torch.Tensor):
        for t, version, classes in _MASKS:
            if t is pop_mask and version == t._version and \
                    classes.device == device:
                return classes
        arr = pop_mask.detach().to("cpu", torch.float32).numpy()
    else:
        arr = np.asarray(pop_mask, dtype=np.float32)
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    classes = pairdist._run_const("tail_classes", arr, device,
                                  lambda x: TailClasses(x, device))
    if isinstance(pop_mask, torch.Tensor):
        if len(_MASKS) >= _MAX_MASKS:
            _MASKS.pop(0)
        _MASKS.append((pop_mask, pop_mask._version, classes))
    return classes


def window_stats_tail(m: torch.Tensor, s: torch.Tensor,
                      pop_mask: torch.Tensor):
    """float32 (pi [B, P], dxy [B, P, P], fst [B, P, P]) from the pair
    counts int32 [B, H, H] and the float32 [P, H] mask (entries >= 0).
    Replaces the epilogue of the JAX ``window_stats_step``."""
    return _tail(m, s, pop_mask, tail_classes(pop_mask, m.device))


def _tail(m: torch.Tensor, s: torch.Tensor, pop_mask: torch.Tensor,
          classes: TailClasses):
    """:func:`window_stats_tail` on the mask's classes, built beforehand."""
    if not m.is_cuda:
        return window_stats_tail_plain(m, s, pop_mask, classes)
    for t in (m, s, pop_mask):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous CUDA tensors")
    if m.dtype != torch.int32 or s.dtype != torch.int32 or \
            pop_mask.dtype != torch.float32:
        raise ValueError("counts must be int32 and the mask float32")
    B, h, _ = m.shape
    P = pop_mask.shape[0]
    if pop_mask.shape[1] != h or s.shape != m.shape:
        raise ValueError(f"mask {tuple(pop_mask.shape)} or counts "
                         f"{tuple(s.shape)} do not fit [B, {h}, {h}]")
    pi = torch.empty((B, P), dtype=torch.float32, device=m.device)
    dxy = torch.empty((B, P, P), dtype=torch.float32, device=m.device)
    fst = torch.empty_like(dxy)
    if B == 0 or P == 0:
        return pi, dxy, fst
    C, n = classes.C, classes.n_rows
    scratch = torch.empty(2 * B * C * (n + C), dtype=torch.int32,
                          device=m.device)
    _ggt_window_stats_tail(
        m.data_ptr(), s.data_ptr(), classes.ints.data_ptr(),
        classes.floats.data_ptr(), h, P, C, n, B, scratch.data_ptr(),
        pi.data_ptr(), dxy.data_ptr(), fst.data_ptr(),
        pairdist._stream_ptr(m))
    LAUNCHES["window_stats_tail"] += 1
    return pi, dxy, fst


def _fixed_sum(terms: torch.Tensor, lanes: int = _NT) -> torch.Tensor:
    """Sum over the last axis in a fixed order: term p goes to lane
    p % ``lanes``, each lane adds its terms in order, then a binary tree
    adds lane t + stride into lane t.  Float32 in, float32 out.  With 32
    lanes it is window_stats.cu's warp_sum; with 1024, the order of each
    population's size."""
    n = terms.shape[-1]
    k = max(1, -(-n // lanes))
    pad = torch.zeros((*terms.shape[:-1], k * lanes - n), dtype=terms.dtype,
                      device=terms.device)
    x = torch.cat([terms, pad], dim=-1).reshape(*terms.shape[:-1], k, lanes)
    acc = torch.zeros((*terms.shape[:-1], lanes), dtype=terms.dtype,
                      device=terms.device)
    for r in range(k):
        acc = acc + x[..., r, :]
    stride = lanes // 2
    while stride:
        acc = acc[..., :stride] + acc[..., stride:2 * stride]
        stride //= 2
    return acc[..., 0]


def window_stats_tail_plain(m: torch.Tensor, s: torch.Tensor,
                            pop_mask: torch.Tensor,
                            classes: TailClasses | None = None):
    """Plain PyTorch K10: the JAX ``_block_nanmean`` means and Fst from
    the mask's class-pair sums, in the kernel's order: each row's valid
    dists summed over each column class (:func:`_fixed_sum`, 32 lanes, the
    class's columns ascending), those over each class's rows (rows
    ascending), then each block mean over its class pairs (ci C + cj)."""
    B, h, _ = m.shape
    dev = m.device
    cls = classes or tail_classes(pop_mask, dev)
    C, P = cls.weights.shape
    members = torch.from_numpy(cls.members).to(dev)
    runs = [(int(cls.starts[c]), int(cls.starts[c + 1])) for c in range(C)]
    eye = torch.eye(h, dtype=torch.bool, device=dev)
    valid = ((s > 0) & ~eye[None])[:, members][:, :, members]
    dist = (m.to(torch.float32) / s.clamp(min=1).to(torch.float32))[
        :, members][:, :, members]                         # class order
    dist = torch.where(valid, dist, torch.zeros((), device=dev))
    s_num = torch.zeros((B, C, C), dtype=torch.float32, device=dev)
    s_cnt = torch.zeros((B, C, C), dtype=torch.float32, device=dev)
    if C:
        # each row over each column class, then each class's rows
        part = torch.stack([_fixed_sum(dist[:, :, a:b], 32)
                            for a, b in runs], dim=-1)     # [B, n, C]
        cnt = torch.stack([valid[:, :, a:b].sum(dim=-1)
                           for a, b in runs], dim=-1)
        s_num = torch.stack([_fixed_sum(part[:, a:b].transpose(1, 2), 32)
                             for a, b in runs], dim=1)     # [B, ci, cj]
        s_cnt = torch.stack([cnt[:, a:b].sum(dim=1) for a, b in runs],
                            dim=1).to(torch.float32)
    w = torch.from_numpy(cls.weights).to(dev)             # [C, P]
    pooled_w = torch.clamp(w[:, :, None] + w[:, None, :], 0, 1)  # [C, a, b]
    # u_a(ci) v_b(cj) of every (a, b) and class pair (ci C + cj): [2, P,
    # P, C C], the block means first, the pooled ones second
    uv = torch.stack([
        w.T[:, None, :, None] * w.T[None, :, None, :],
        pooled_w.permute(1, 2, 0)[..., :, None] *
        pooled_w.permute(1, 2, 0)[..., None, :]]).reshape(2, P, P, C * C)
    keep = uv > 0
    zero = torch.zeros((), device=dev)
    num = torch.where(keep, s_num.reshape(B, 1, 1, 1, C * C), zero)
    den = torch.where(keep, uv * s_cnt.reshape(B, 1, 1, 1, C * C), zero)
    mean = _fixed_sum(num, 32) / _fixed_sum(den, 32)      # [B, 2, P, P]
    dmean, pooled = mean[:, 0].contiguous(), mean[:, 1]
    n_pop = torch.from_numpy(cls.n_pop).to(dev)
    pi = torch.diagonal(dmean, dim1=1, dim2=2).contiguous()     # [B, P]
    wt = n_pop[:, None] / (n_pop[:, None] + n_pop[None, :])
    pi_s = wt[None] * pi[:, :, None] + (1 - wt[None]) * pi[:, None, :]
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
    _ggt_window_pop_counts(
        alleles.data_ptr(), alleles.stride(0), S, first.data_ptr(),
        n_sites.data_ptr(), pop_mask.data_ptr(), h, P, B, out.data_ptr(),
        pairdist._stream_ptr(out))
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
    classes = tail_classes(pop_mask if isinstance(pop_mask, np.ndarray)
                           else pm, dev)
    s_max = int(np.max(n_sites)) if isinstance(n_sites, np.ndarray) \
        and n_sites.size else None
    parts = []
    for w0 in range(0, max(f.shape[0], 1), STEP_CHUNK):
        fc, nc = f[w0:w0 + STEP_CHUNK], n[w0:w0 + STEP_CHUNK]
        mismatch, shared = pairdist.pair_counts_4state(a, fc, nc, s_max)
        pi, dxy, fst = _tail(mismatch, shared, pm, classes)
        parts.append({"pi": pi, "dxy": dxy, "fst": fst,
                      "mismatch": mismatch, "shared": shared,
                      "pop_counts": window_pop_counts(a, fc, nc, pm)})
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
