"""Pairwise masked-Hamming counting for popgenWindows' popDist/popPairDist.

For haplotypes i, j of a window (the reference's ``Alignment.distMatrix``
inner loop, genomics.py:903-916):

    shared(i,j)   = #sites where both are called
    mismatch(i,j) = #of those where they differ

and the per-population-block float64 reductions of ``mismatch / shared``
that stats/popgen.group_dist_stats_from_blocks finalizes on the host.

Three CUDA kernels (kernels/csrc/pair_v3.cu) do the device work of a flush,
window chunk by window chunk so the [chunk, H, H] int32 scratch stays
bounded at large H:

* :func:`pair_counts_v3` (K1) — counts from the wire-v3 bit planes,
* :func:`exception_patch` (K2) — multi-allelic sites' contributions,
* :func:`blocks_tail` (K3) — f64 per-pop-block sums and valid-pair counts.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
``LAUNCHES``) and runs its plain PyTorch version, in this module, only for
CPU tensors.  ``GGT_EXEC=host`` instead runs the host C executor
(io/native ``pairwise_window_counts``, copied from the JAX package), an
independent check of the kernels.

Dispatch/collect split: on CUDA, :func:`window_pair_block_stats_dispatch`
stages the wire in pinned memory, copies it with ``non_blocking`` and
launches on the current stream, then starts the copy back into pinned
memory and records an event; ``collect()`` waits on that event only.  So
engine.run_pipeline's finalize of batch k overlaps the parse, pack, upload
and kernels of batch k+1.  On the CPU the flush runs at dispatch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import get_device
from . import _build
from . import transfer

# launches of each CUDA kernel since the last reset (the plain versions
# and the host executor never count)
LAUNCHES = {"pair_counts_v3": 0, "exception_patch": 0, "blocks_tail": 0}
# flushes run by the host C executor (GGT_EXEC=host)
HOST_FLUSHES = 0
# pair cells the plain K2 materializes per slab of exception entries
_EX_SLAB_PAIRS = 1 << 24


def reset_launches() -> None:
    global HOST_FLUSHES
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    HOST_FLUSHES = 0


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous CUDA tensors")


# ------------------------------------------------------- K1 pair counts

def pair_counts_v3(wire: transfer.PairWireV3, w0: int, nwin: int):
    """Mismatch/shared int32 [nwin, H, H] of windows w0 .. w0 + nwin - 1
    from the wire-v3 planes (exception sites not included: K2 adds them).

    Replaces the JAX ``_fused_flush_pair_v3`` count stage with its
    ``unpack_pair_wire_v3`` and ``_gather_bits``."""
    if not wire.buf.is_cuda:
        return pair_counts_v3_plain(wire, w0, nwin)
    h, wp = wire.h, wire.wp
    if w0 < 0 or w0 + nwin > wp:
        raise ValueError(f"windows {w0}..{w0 + nwin} outside wp={wp}")
    _check_cuda(wire.buf)
    m = torch.empty((nwin, h, h), dtype=torch.int32, device=wire.buf.device)
    s = torch.empty_like(m)
    if nwin == 0:
        return m, s
    code = _build.lib("pair_v3").ggt_pair_counts_v3(
        wire.cB.data_ptr(), wire.meta.data_ptr(), h, wire.cB.shape[1],
        wire.aC.shape[1], wire.cD.shape[1], wp, w0, nwin, m.data_ptr(),
        s.data_ptr(), _stream_ptr(m))
    _build.check(code, "pair_counts_v3")
    LAUNCHES["pair_counts_v3"] += 1
    return m, s


def _gather_bits(plane: torch.Tensor, first: torch.Tensor,
                 n_sites: torch.Tensor) -> torch.Tensor:
    """Gather B spans of a 0/1 int8 plane [H, S] into float64 [B, H, s_max]
    factors (padded slots zeroed); s_max = the longest span."""
    s_max = max(int(n_sites.max()), 1) if n_sites.numel() else 1
    offs = torch.arange(s_max, device=plane.device)
    idx = first[:, None].long() + offs[None, :]
    valid = offs[None, :] < n_sites[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    w = plane[:, idx].permute(1, 0, 2)                     # [B, H, s_max]
    return (w * valid[:, None, :]).to(torch.float64)


def pair_counts_v3_plain(wire: transfer.PairWireV3, w0: int, nwin: int):
    """Plain PyTorch K1: the JAX Gram forms on the unpacked planes,

        shared   = nconst + cB.cB^T + cD.cD^T
        mismatch = (rC_i + rC_j - 2 aC.aC^T) + (aD.cD^T + (aD.cD^T)^T
                   - 2 aD.aD^T)

    with 0/1 float64 factors (exact integers)."""
    (cB, aC, cD, aD, fB, nB, fC, nC, fD, nD, nconst, _, _) = \
        transfer.unpack_pair_wire_v3(wire)
    sl = slice(w0, w0 + nwin)

    def gram(x, y):
        return torch.einsum("bhs,bgs->bhg", x, y)

    b = _gather_bits(cB, fB[sl], nB[sl])
    a = _gather_bits(aC, fC[sl], nC[sl])
    dc = _gather_bits(cD, fD[sl], nD[sl])
    da = _gather_bits(aD, fD[sl], nD[sl])
    rC = a.sum(dim=2)
    G3D = gram(da, dc)
    m = (rC[:, :, None] + rC[:, None, :] - 2.0 * gram(a, a)) \
        + (G3D + G3D.transpose(1, 2) - 2.0 * gram(da, da))
    s = nconst[sl].to(torch.float64)[:, None, None] + gram(b, b) \
        + gram(dc, dc)
    return m.to(torch.int32), s.to(torch.int32)


# -------------------------------------------------- K2 exception patch

def exception_patch(m: torch.Tensor, s: torch.Tensor,
                    wire: transfer.PairWireV3, w0: int) -> None:
    """Add, in place, the multi-allelic exception entries of windows
    w0 .. w0 + len(m) - 1 to the chunk's counts.  Padding entries
    (``ex_w == wp``) are skipped.  Replaces the JAX ``_exception_patch``."""
    if not m.is_cuda:
        exception_patch_plain(m, s, wire, w0)
        return
    ep, h = wire.ex_codes.shape
    if ep == 0:
        return
    if h > 48 * 1024:
        raise ValueError(f"exception_patch stages h={h} codes in 48 KB of "
                         "shared memory")
    _check_cuda(m, s, wire.ex_w, wire.ex_codes)
    code = _build.lib("pair_v3").ggt_exception_patch(
        wire.ex_w.data_ptr(), wire.ex_codes.data_ptr(), ep, h, wire.wp, w0,
        m.shape[0], m.data_ptr(), s.data_ptr(), _stream_ptr(m))
    _build.check(code, "exception_patch")
    LAUNCHES["exception_patch"] += 1


def exception_patch_plain(m: torch.Tensor, s: torch.Tensor,
                          wire: transfer.PairWireV3, w0: int) -> None:
    """Plain PyTorch K2: a segment sum of each entry's both-called /
    unequal pairs into its window, in entry slabs of at most
    ``_EX_SLAB_PAIRS`` pair cells."""
    nwin, h, _ = m.shape
    local = wire.ex_w.long() - w0
    sel = torch.nonzero((local >= 0) & (local < nwin)).flatten()
    step = max(1, _EX_SLAB_PAIRS // max(h * h, 1))
    for k in range(0, sel.numel(), step):
        e = sel[k:k + step]
        codes = wire.ex_codes[e]                              # [E, h]
        called = codes >= 0
        both = called[:, :, None] & called[:, None, :]
        neq = codes[:, :, None] != codes[:, None, :]
        s.index_add_(0, local[e], both.to(torch.int32))
        m.index_add_(0, local[e], (both & neq).to(torch.int32))


# ------------------------------------------------------ K3 blocks tail

class PopGroups:
    """A 0/1 population mask [P, H] in which every haplotype row lies in
    exactly one group, as K3 takes it: ``perm`` int32 [H] lists the rows
    group by group and ``offs`` int32 [P + 1] bounds each group's run
    (both on ``device``).  ``mask`` float64 [P, H] stays on the host: only
    the plain version reads it."""

    def __init__(self, pop_mask: np.ndarray, device: torch.device):
        mask = np.asarray(pop_mask, dtype=np.float64)
        if mask.ndim != 2 or not np.isin(mask, (0.0, 1.0)).all() \
                or not (mask.sum(axis=0) == 1).all():
            raise ValueError("blocks_tail needs a 0/1 mask [P, H] with each "
                             "row in exactly one group")
        groups = mask.argmax(axis=0)
        self.P = mask.shape[0]
        self.mask = torch.from_numpy(np.ascontiguousarray(mask))
        self.perm = torch.from_numpy(
            np.argsort(groups, kind="stable").astype(np.int32)).to(device)
        offs = np.zeros(self.P + 1, dtype=np.int32)
        np.cumsum(np.bincount(groups, minlength=self.P), out=offs[1:])
        self.offs = torch.from_numpy(offs).to(device)


_GROUPS: dict = {}


def _pop_groups(pop_mask: np.ndarray, device: torch.device) -> PopGroups:
    """The run's PopGroups, built and uploaded once: the CLI hands every
    flush the same mask, and a pageable upload per flush would block
    dispatch until the previous flush's work had drained."""
    mask = np.ascontiguousarray(pop_mask, dtype=np.float64)
    key = (mask.shape, mask.tobytes(), str(device))
    if key not in _GROUPS:
        _GROUPS.clear()
        _GROUPS[key] = PopGroups(mask, device)
    return _GROUPS[key]


def blocks_tail(m: torch.Tensor, s: torch.Tensor, groups: PopGroups,
                min_sites: int, out: torch.Tensor) -> None:
    """Write float64 [nwin, 2, P, P] into ``out``: per window and pop block,
    the sum of ``m / s`` over valid pairs and the number of valid pairs
    (off-diagonal, ``s >= max(min_sites, 1)``).  Replaces the ``blocks``
    mode of the JAX ``_modes_tail``."""
    nwin, h, _ = m.shape
    P = groups.P
    if out.shape != (nwin, 2, P, P) or out.dtype != torch.float64:
        raise ValueError(f"out must be float64 {(nwin, 2, P, P)}")
    if not m.is_cuda:
        out.copy_(blocks_tail_plain(m, s, groups.mask, min_sites))
        return
    _check_cuda(m, s, groups.perm, groups.offs, out)
    if nwin == 0:
        return
    code = _build.lib("pair_v3").ggt_blocks_tail(
        m.data_ptr(), s.data_ptr(), groups.perm.data_ptr(),
        groups.offs.data_ptr(), P, h, nwin, int(min_sites or 0),
        out.data_ptr(), _stream_ptr(m))
    _build.check(code, "blocks_tail")
    LAUNCHES["blocks_tail"] += 1


def blocks_tail_plain(m: torch.Tensor, s: torch.Tensor,
                      pop_mask: torch.Tensor, min_sites: int) -> torch.Tensor:
    """Plain PyTorch K3 (the JAX einsum form): float64 [nwin, 2, P, P]."""
    h = m.shape[1]
    ms = max(int(min_sites or 0), 1)
    offdiag = ~torch.eye(h, dtype=torch.bool, device=m.device)
    valid = (s >= ms) & offdiag[None, :, :]
    d0 = torch.where(valid, m.to(torch.float64) / s.to(torch.float64),
                     torch.zeros((), dtype=torch.float64, device=m.device))
    pm = pop_mask.to(m.device, torch.float64)
    sums = torch.einsum("whg,ph,qg->wpq", d0, pm, pm)
    cnts = torch.einsum("whg,ph,qg->wpq", valid.to(torch.float64), pm, pm)
    return torch.stack([sums, cnts], dim=1)


# ------------------------------------------------------------ the flush

def _next_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def _v3_flush_args(alleles: np.ndarray, first: np.ndarray,
                   n_sites: np.ndarray):
    """Host-side prep for the wire-v3 kernels: classify + pack the flush
    buffer and choose the window chunk so the [chunk, H, H] count scratch
    stays bounded."""
    if os.environ.get("GGT_WIRE") == "2":
        raise NotImplementedError(
            "GGT_WIRE=2 (the wire-v2 kernels) is not ported yet: ROADMAP "
            "queue 2, row 5")
    W = first.shape[0]
    H = alleles.shape[0]
    wp = _next_pow2(W, 8)
    buf, SpB, SpC, SpD, ep, _ = transfer.pack_pair_wire_v3(
        alleles, first, n_sites, wp)
    chunk = min(wp, 128)
    while chunk > 8 and chunk * H * H > (1 << 25):
        chunk //= 2
    return buf, SpB, SpC, SpD, H, wp, chunk, ep


def flush_blocks(wire: transfer.PairWireV3, W: int, chunk: int,
                 groups: PopGroups, min_sites: int) -> torch.Tensor:
    """Run K1, K2 and K3 over windows 0 .. W-1 of one wire, ``chunk``
    windows at a time, on the wire's device.  Returns float64
    [W, 2, P, P]."""
    dev = wire.buf.device
    if dev.type != "cuda" and W:
        # the plain K1 also holds float64 [chunk, H, s_max] factors
        s_max = _next_pow2(max(int(wire.meta[1:6:2, :W].max()), 1), 128)
        while chunk > 8 and chunk * wire.h * s_max > (1 << 26):
            chunk //= 2
    out = torch.empty((W, 2, groups.P, groups.P), dtype=torch.float64,
                      device=dev)
    for w0 in range(0, W, chunk):
        n = min(chunk, W - w0)
        m, s = pair_counts_v3(wire, w0, n)
        exception_patch(m, s, wire, w0)
        blocks_tail(m, s, groups, min_sites, out[w0:w0 + n])
    return out


# ------------------------------------------------------- host executor

def _exec_choice() -> str:
    """'host' runs the C popcount executor (GGT_EXEC=host); every other
    value (auto, device, tpu) runs the kernels.  The JAX package's H <= 96
    host crossover was measured on its TPU host and is not carried over."""
    return "host" if os.environ.get("GGT_EXEC") == "host" else "kernel"


def _host_flush_counts(alleles: np.ndarray, first: np.ndarray,
                       n_sites: np.ndarray):
    """Host executor: (mismatch, shared) int32 [W, H, H] for one flush —
    identical integers to the device kernels (same planes, same exception
    patching).  Returns None when the native library is unavailable."""
    from ..io import native
    H, S = alleles.shape
    sp8 = ((max(S, 1) + 63) // 64) * 8
    planes = np.empty((2, H, sp8), dtype=np.uint8)
    res = None
    if os.environ.get("GGT_NO_NATIVE_PARSER") != "1":
        res = native.pack_pair_planes_native(alleles, planes[0], planes[1],
                                             sp8)
    if res is None:
        res = transfer._pack_pair_planes_numpy(alleles, planes[0], planes[1],
                                               sp8)
    refalt, ex_idx = res
    ms = native.pairwise_window_counts_native(planes[0], planes[1], sp8,
                                              first, n_sites)
    if ms is None:
        return None
    m, s = ms
    if ex_idx.size:
        pairs_w, pairs_s = transfer.map_exception_windows(
            ex_idx, first, n_sites)
        if pairs_w.size:
            codes = alleles[:, pairs_s].T                  # [E, H]
            called = codes >= 0
            both = called[:, :, None] & called[:, None, :]
            eq = codes[:, :, None] == codes[:, None, :]
            np.add.at(m, pairs_w, (both & ~eq).astype(np.int32))
            np.add.at(s, pairs_w, both.astype(np.int32))
    return m, s


def _blocks_from_counts(m: np.ndarray, s: np.ndarray, pop_mask: np.ndarray,
                        min_sites: int):
    """Numpy mirror of the device blocks tail (:func:`_modes_tail`):
    float64 nanmean numerators/denominators per pop-pair block."""
    ms = max(int(min_sites or 0), 1)
    h = m.shape[1]
    offdiag = ~np.eye(h, dtype=bool)
    valid = (s >= ms) & offdiag[None, :, :]
    d0 = np.zeros(m.shape, dtype=np.float64)
    np.divide(m, s, out=d0, where=valid)
    pm = pop_mask.astype(np.float64)
    sums = np.einsum("whg,ph,qg->wpq", d0, pm, pm)
    cnts = np.einsum("whg,ph,qg->wpq", valid.astype(np.float64), pm, pm)
    return sums, cnts


def _host_blocks(alleles, first, n_sites, pop_mask, min_sites):
    global HOST_FLUSHES
    counts = _host_flush_counts(alleles, first, n_sites)
    if counts is None:
        raise RuntimeError("GGT_EXEC=host needs the native library "
                           "(io/native.py), which did not build")
    HOST_FLUSHES += 1
    return _blocks_from_counts(*counts, pop_mask, min_sites)


class _ReadyHandle:
    """Lazy handle for the host executor: the flush computes at collect()
    time on the single consumer thread, so at most one batch's [W, H, H]
    matrices are materialized however deep the pipeline is."""

    def __init__(self, thunk):
        self._thunk = thunk

    def collect(self):
        return self._thunk()


# ------------------------------------------------------------ dispatch

class PairBlockStatsHandle:
    """In-flight per-window pop-block distance sums.

    ``collect()`` returns float64 (sums [W, P, P], counts [W, P, P]):
    sums[w, x, y] = sum over valid (i in pop x, j in pop y) of
    mismatch/shared; counts = number of valid pairs.  Valid = off-diagonal
    and shared >= max(min_sites, 1) — exactly the non-NaN entries of the
    reference's per-window distance matrix after ``apply_min_sites``
    (stats/popgen.DistStatsContext).

    On CUDA it holds the pinned host buffers of the flush (the wire being
    uploaded and the result being fetched) and the event recorded after
    the fetch; ``collect()`` waits on that event alone."""

    def __init__(self, W: int, P: int, result=None, event=None, keep=()):
        self.W, self.P = W, P
        self._result, self._event, self._keep = result, event, keep

    def collect(self):
        if self._result is None:
            z = np.zeros((self.W, self.P, self.P), dtype=np.float64)
            return z, z.copy()
        if self._event is not None:
            self._event.synchronize()
        host = self._result.numpy()
        self._result, self._event, self._keep = None, None, ()
        return host[:, 0].copy(), host[:, 1].copy()


def window_pair_block_stats_dispatch(alleles: np.ndarray, first: np.ndarray,
                                     n_sites: np.ndarray,
                                     pop_mask: np.ndarray,
                                     min_sites: int) -> PairBlockStatsHandle:
    """Dispatch the fused popDist/popPairDist flush: pair counts AND the
    float64 per-pop-block reductions run on the device; only [W, 2, P, P]
    floats come back (vs [W, H, H] count matrices).

    ``pop_mask``: float [P, H] 0/1 row membership per population (np.unique
    group order), every row in exactly one group.  The host finalize
    (stats/popgen.group_dist_stats_from_blocks) reproduces the reference's
    nanmean_min/Fst arithmetic exactly."""
    W = first.shape[0]
    P = pop_mask.shape[0]
    if W == 0:
        return PairBlockStatsHandle(W, P)
    if _exec_choice() == "host":
        return _ReadyHandle(lambda: _host_blocks(
            alleles, first, n_sites, pop_mask, min_sites))
    dev = get_device()
    buf, SpB, SpC, SpD, H, wp, chunk, ep = _v3_flush_args(
        alleles, first, n_sites)
    groups = _pop_groups(pop_mask, dev)
    if dev.type != "cuda":
        wire = transfer.from_jax_wire(buf, SpB, SpC, SpD, H, wp, ep)
        return PairBlockStatsHandle(
            W, P, flush_blocks(wire, W, chunk, groups, min_sites))
    staged = torch.empty(buf.size, dtype=torch.uint8, pin_memory=True)
    staged.numpy()[:] = buf
    wire = transfer.from_jax_wire(staged.to(dev, non_blocking=True),
                                  SpB, SpC, SpD, H, wp, ep)
    out = flush_blocks(wire, W, chunk, groups, min_sites)
    result = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    result.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PairBlockStatsHandle(W, P, result, event, keep=(staged,))
