"""Pairwise masked-Hamming counting for popgenWindows' distance analyses.

For haplotypes i, j of a window (the reference's ``Alignment.distMatrix``
inner loop, genomics.py:903-916):

    shared(i,j)   = #sites where both are called
    mismatch(i,j) = #of those where they differ

and the per-population-block float64 reductions of ``mismatch / shared``
that stats/popgen.group_dist_stats_from_blocks finalizes on the host.

CUDA kernels (kernels/csrc/pair_v3.cu) do the device work of a flush,
window chunk by window chunk so the [chunk, H, H] int32 scratch stays
bounded at large H:

* :func:`pair_counts_v3` (K1) — counts from the wire-v3 bit planes, or
  under ``GGT_WIRE=2`` :func:`pair_counts_v2` (K13) from the wire-v2
  called / alt planes,
* :func:`exception_patch` (K2) — multi-allelic sites' contributions (the
  two wires lay out their exception sections alike),

then one of three epilogues, the modes of the JAX ``_modes_tail``:

* ``blocks``: :func:`blocks_tail` (K3) — f64 per-block sums and valid-pair
  counts (:func:`window_pair_block_stats_dispatch`);
* ``blocks_het``: K3 plus :func:`het_pairs` (K5) — each individual's own
  (mismatch, shared) pair (:func:`window_pair_ind_blocks_dispatch`);
* ``tri``: :func:`tri_pack` (K4) — the upper triangles of both count
  matrices, which the host mirrors back to [W, H, H]
  (:func:`window_pair_counts_dispatch`).

On a device mesh the blocks dispatches cut the flush's windows into one
slab a device and send each slab its own wire of the sites its windows
cover (:func:`upload_slabs`); each device runs the same kernels on its
slab (:func:`_slab_dispatch`).

The general 4-state counts, :func:`pair_counts_4state` (K9,
kernels/csrc/pair4.cu), count windows straight from an int8 [H, S] allele
matrix on the device: the ``tri`` route of a device-array span or of the
raw ``GGT_PACKED_TRANSFER=0`` upload (K9 then K4), distMat's
:class:`CatPairAccumulator`, :func:`long_span_pair_counts` and the
window-stats step (kernels/window_stats.py).  The JAX package's
one-transfer flush, :func:`_fused_flush_pair_counts` (K20, pair4.cu),
counts the same way straight from a ``transfer.pack_flush_buffer`` buffer
into the tri-packed rows.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
``LAUNCHES``) and runs its plain PyTorch version, in this module, only for
CPU tensors.  ``GGT_EXEC=host`` instead runs the host C executor
(io/native ``pairwise_window_counts``, copied from the JAX package), an
independent check of the kernels.

Dispatch/collect split: on CUDA, each dispatch stages the wire in pinned
memory, copies it with ``non_blocking`` and launches on the current
stream, then starts the copy back into pinned memory and records an event;
``collect()`` waits on that event only.  So engine.run_pipeline's finalize
of batch k overlaps the parse, pack, upload and kernels of batch k+1.  On
the CPU the flush runs at dispatch.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import get_device
from ..engine import NO_TIMER
from . import _build
from . import transfer

# launches of each CUDA kernel since the last reset (the plain versions
# and the host executor never count)
LAUNCHES = {"pair_counts_v3": 0, "exception_patch": 0, "blocks_tail": 0,
            "tri_pack": 0, "het_pairs": 0, "pair_counts_4state": 0,
            "pair_counts_v2": 0, "pair_counts_4state_rows": 0,
            "flush_pair_counts": 0}
# the C entry points, each resolved on its first launch (_build.Entry)
_ggt_pair_counts_v3 = _build.Entry("pair_v3", "ggt_pair_counts_v3")
_ggt_pair_counts_v2 = _build.Entry("pair_v3", "ggt_pair_counts_v2")
_ggt_exception_patch = _build.Entry("pair_v3", "ggt_exception_patch")
_ggt_blocks_tail = _build.Entry("pair_v3", "ggt_blocks_tail")
_ggt_tri_pack = _build.Entry("pair_v3", "ggt_tri_pack")
_ggt_het_pairs = _build.Entry("pair_v3", "ggt_het_pairs")
_ggt_pair_counts_4state = _build.Entry("pair4", "ggt_pair_counts_4state")
_ggt_pair_counts_4state_rows = _build.Entry("pair4",
                                            "ggt_pair_counts_4state_rows")
_ggt_flush_pair_counts = _build.Entry("pair4", "ggt_flush_pair_counts")
# flushes run by the host C executor (GGT_EXEC=host)
HOST_FLUSHES = 0
# pair cells the plain K2 materializes per slab of exception entries
_EX_SLAB_PAIRS = 1 << 24
_K2_TILE = 32                # K2's pair tile side (pair_v3.cu kTile)
# K3 runs a thread per (window, p, q) cell while no group has more rows
# than this, else a block per cell: on the card (chip_smoke.py's sweep,
# PERF.md) the thread per cell is faster up to groups of 16 rows, the
# block per cell from 32
_K3_NARROW_ROWS = 16


def reset_launches() -> None:
    global HOST_FLUSHES
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    HOST_FLUSHES = 0


def _public_raw_stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# The current CUDA stream's raw handle on a device index, as PyTorch's own
# generated kernel launchers read it: a private binding of torch._C that
# builds no torch.cuda.Stream object (the public path when a build lacks
# it).  Read on every launch, never cached: a launch inside CUDA graph
# capture must go on the capturing stream.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
    or _public_raw_stream


def _stream_ptr(t: torch.Tensor) -> int:
    """The handle of the current stream of ``t``'s device."""
    return _raw_stream(t.get_device())


def _check_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous CUDA tensors")


def _check_planes(*planes: torch.Tensor) -> None:
    """K1 and K13 copy plane rows in 16-byte runs: each plane must start
    on a 16-byte boundary with rows of whole 16-byte runs (the packers'
    site buckets are multiples of 128 sites)."""
    for p in planes:
        if p.data_ptr() % 16 or p.shape[1] % 4:
            raise ValueError("bit planes must start 16-byte aligned with "
                             "rows of a multiple of 4 words")


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
    _check_planes(wire.cB, wire.aC, wire.cD, wire.aD)
    m = torch.empty((nwin, h, h), dtype=torch.int32, device=wire.buf.device)
    s = torch.empty_like(m)
    if nwin == 0:
        return m, s
    _ggt_pair_counts_v3(
        wire.cB.data_ptr(), wire.meta.data_ptr(), h, wire.cB.shape[1],
        wire.aC.shape[1], wire.cD.shape[1], wp, w0, nwin, m.data_ptr(),
        s.data_ptr(), _stream_ptr(m))
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


# ------------------------------------------------------ K13 pair counts

def pair_counts_v2(wire: transfer.PairWireV2, w0: int, nwin: int):
    """Mismatch/shared int32 [nwin, H, H] of windows w0 .. w0 + nwin - 1
    from the wire-v2 called / alt planes (exception sites not included: K2
    adds them).

    Replaces the JAX ``_fused_flush_pair_v2`` count stage with its
    ``unpack_pair_wire``, ``gather_window_code2`` and ``_pair_counts_v2``."""
    if not wire.buf.is_cuda:
        return pair_counts_v2_plain(wire, w0, nwin)
    h, wp = wire.h, wire.wp
    if w0 < 0 or w0 + nwin > wp:
        raise ValueError(f"windows {w0}..{w0 + nwin} outside wp={wp}")
    _check_cuda(wire.buf)
    _check_planes(wire.called, wire.alt)
    m = torch.empty((nwin, h, h), dtype=torch.int32, device=wire.buf.device)
    s = torch.empty_like(m)
    if nwin == 0:
        return m, s
    _ggt_pair_counts_v2(
        wire.called.data_ptr(), wire.alt.data_ptr(), wire.first.data_ptr(),
        wire.n_sites.data_ptr(), h, wire.called.shape[1], w0, nwin,
        m.data_ptr(), s.data_ptr(), _stream_ptr(m))
    LAUNCHES["pair_counts_v2"] += 1
    return m, s


def pair_counts_v2_plain(wire: transfer.PairWireV2, w0: int, nwin: int):
    """Plain PyTorch K13: the JAX Gram forms on the unpacked planes,

        shared   = c . c^T
        mismatch = ca . c^T + (ca . c^T)^T - 2 ca . ca^T

    with 0/1 float64 factors (exact integers)."""
    code2, first, n_sites, _, _ = transfer.unpack_pair_wire(wire)
    sl = slice(w0, w0 + nwin)
    c = _gather_bits(code2 & 1, first[sl], n_sites[sl])
    ca = _gather_bits(code2 >> 1, first[sl], n_sites[sl])
    G3 = torch.einsum("bhs,bgs->bhg", ca, c)
    m = G3 + G3.transpose(1, 2) - 2.0 * torch.einsum("bhs,bgs->bhg", ca, ca)
    s = torch.einsum("bhs,bgs->bhg", c, c)
    return m.to(torch.int32), s.to(torch.int32)


# -------------------------------------------------- K2 exception patch

class ExceptionIndex(NamedTuple):
    """A flush's exception entries window by window, as K2 reads them:
    ``order`` int32 [ep] lists the entries sorted by window (stable), and
    window w's are ``order[starts[w]:starts[w + 1]]`` (``starts`` int32
    [wp + 1]); padding entries (``ex_w == wp``) sort last, after
    ``starts[wp]``, where no window reads them."""
    order: torch.Tensor
    starts: torch.Tensor


def exception_index(wire) -> ExceptionIndex:
    """The per-window entry index of a wire-v3 or wire-v2 flush, on the
    wire's device.  ``ex_w`` is not sorted by window: overlapping windows
    interleave their entries, and unsorted plans emit any order."""
    order = torch.argsort(wire.ex_w, stable=True)
    windows = torch.arange(wire.wp + 1, dtype=wire.ex_w.dtype,
                           device=wire.ex_w.device)
    starts = torch.searchsorted(wire.ex_w[order], windows, out_int32=True)
    return ExceptionIndex(order.to(torch.int32), starts)


def exception_patch(m: torch.Tensor, s: torch.Tensor, wire, w0: int,
                    index: ExceptionIndex | None = None) -> None:
    """Add, in place, the multi-allelic exception entries of windows
    w0 .. w0 + len(m) - 1 of a wire-v3 or wire-v2 flush to the chunk's
    counts.  Padding entries (``ex_w == wp``) are skipped.  ``index`` is
    the flush's :func:`exception_index`, built once per flush by the
    caller (or here when None).  Replaces the JAX ``_exception_patch``."""
    if not m.is_cuda:
        exception_patch_plain(m, s, wire, w0)
        return
    ep, h = wire.ex_codes.shape
    nwin = m.shape[0]
    if w0 < 0 or w0 + nwin > wire.wp:
        raise ValueError(f"windows {w0}..{w0 + nwin} outside wp={wire.wp}")
    if ep == 0 or nwin == 0:
        return
    if max(-(-h // _K2_TILE), nwin) > 65535:
        raise ValueError(f"exception_patch: {-(-h // _K2_TILE)} row tiles "
                         f"and {nwin} windows in one launch (at most 65535)")
    if index is None:
        index = exception_index(wire)
    _check_cuda(m, s, wire.ex_codes, *index)
    _ggt_exception_patch(
        index.order.data_ptr(), index.starts.data_ptr(),
        wire.ex_codes.data_ptr(), h, w0, nwin, m.data_ptr(), s.data_ptr(),
        _stream_ptr(m))
    LAUNCHES["exception_patch"] += 1


def exception_patch_plain(m: torch.Tensor, s: torch.Tensor, wire,
                          w0: int) -> None:
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
    (both on ``device``), ``max_rows`` is the largest group's size (K3's
    launch shape).  ``mask`` float64 [P, H] stays on the host: only the
    plain version reads it."""

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
        sizes = np.bincount(groups, minlength=self.P)
        offs = np.zeros(self.P + 1, dtype=np.int32)
        np.cumsum(sizes, out=offs[1:])
        self.offs = torch.from_numpy(offs).to(device)
        self.max_rows = int(sizes.max(initial=0))


# per-run constants on each device, keyed on their bytes (a few at a time
# per device: a run hands every flush the same masks and rows, and a mesh
# run needs them on each of its devices)
_CONSTS: dict = {}
_MAX_CONSTS = 8


def _run_const(kind: str, arr: np.ndarray, device: torch.device, build):
    """``build(arr)`` once per distinct (kind, bytes, device): the CLI hands
    every flush the same mask, and a pageable upload per flush would block
    dispatch until the previous flush's work had drained.  The bytes are
    compared, not hashed: each call's bytes object is new, so a key of
    them would hash a whole mask (16 KB at [4, 512]) every call, where a
    comparison with the few cached entries is a memcmp."""
    key = (kind, arr.dtype.str, arr.shape)
    data = arr.tobytes()
    cache = _CONSTS.setdefault(str(device), [])
    for k, d, value in cache:
        if k == key and d == data:
            return value
    if len(cache) >= _MAX_CONSTS:
        cache.clear()
    value = build(arr)
    cache.append((key, data, value))
    return value


def _pop_groups(pop_mask: np.ndarray, device: torch.device) -> PopGroups:
    """The run's PopGroups, built and uploaded once."""
    mask = np.ascontiguousarray(pop_mask, dtype=np.float64)
    return _run_const("groups", mask, device,
                      lambda m: PopGroups(m, device))


def _het_rows(het_rows: np.ndarray, h: int, device: torch.device):
    """The run's (r1, r2) int32 [I] row indices on ``device``, uploaded
    once; every index must name a row of the [H, H] counts."""
    rows = np.ascontiguousarray(het_rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[0] != 2 or \
            (rows.size and (rows.min() < 0 or rows.max() >= h)):
        raise ValueError(f"het_rows must be int32 [2, I] rows of 0..{h - 1}")
    return _run_const("het_rows", rows, device,
                      lambda r: tuple(torch.from_numpy(r[k].copy()).to(device)
                                      for k in range(2)))


def blocks_tail_wide(groups: PopGroups) -> bool:
    """K3's launch shape: a block per (window, p, q) cell when a group has
    more than ``_K3_NARROW_ROWS`` rows, else a thread per cell."""
    return groups.max_rows > _K3_NARROW_ROWS


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
    _blocks_tail_launch(m, s, groups, min_sites, out,
                        blocks_tail_wide(groups))


def _blocks_tail_launch(m, s, groups: PopGroups, min_sites: int, out,
                        wide: bool) -> None:
    """K3 on the card in the given launch shape (``chip_smoke.py`` times
    both shapes to set ``_K3_NARROW_ROWS``)."""
    _check_cuda(m, s, groups.perm, groups.offs, out)
    nwin, h, _ = m.shape
    if nwin == 0:
        return
    _ggt_blocks_tail(
        m.data_ptr(), s.data_ptr(), groups.perm.data_ptr(),
        groups.offs.data_ptr(), groups.P, h, nwin, int(min_sites or 0),
        groups.max_rows, int(wide), out.data_ptr(), _stream_ptr(m))
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


# --------------------------------------------------------- K4 tri pack

def tri_pack(m: torch.Tensor, s: torch.Tensor, out: torch.Tensor) -> None:
    """Write the upper triangles (``i <= j``, ``np.triu_indices`` order) of
    the chunk's counts into ``out`` [nwin, 2T], T = H(H+1)/2: the m half,
    then the s half, as uint16 or int32 (``out``'s dtype; uint16 only when
    every count is below 2^16).  Replaces the ``tri`` mode of the JAX
    ``_modes_tail``."""
    nwin, h, _ = m.shape
    T = h * (h + 1) // 2
    if out.shape != (nwin, 2 * T) or \
            out.dtype not in (torch.uint16, torch.int32):
        raise ValueError(f"out must be uint16 or int32 {(nwin, 2 * T)}")
    if not m.is_cuda:
        out.copy_(tri_pack_plain(m, s, out.dtype == torch.uint16))
        return
    _check_cuda(m, s, out)
    if nwin == 0:
        return
    _ggt_tri_pack(
        m.data_ptr(), s.data_ptr(), h, nwin, int(out.dtype == torch.uint16),
        out.data_ptr(), _stream_ptr(m))
    LAUNCHES["tri_pack"] += 1


def tri_pack_plain(m: torch.Tensor, s: torch.Tensor,
                   u16: bool) -> torch.Tensor:
    """Plain PyTorch K4 (the JAX form): [nwin, 2T] uint16 or int32."""
    iu, ju = np.triu_indices(m.shape[1])
    iu = torch.from_numpy(iu).to(m.device)
    ju = torch.from_numpy(ju).to(m.device)
    out = torch.cat([m[:, iu, ju], s[:, iu, ju]], dim=1)
    # counts below 2^16 keep their low 16 bits through int16; reading
    # those bits as uint16 needs no uint16 arithmetic on the device
    return out.to(torch.int16).view(torch.uint16) if u16 else out


def _tri_unpack(host: np.ndarray, b: int, H: int):
    T = H * (H + 1) // 2
    iu, ju = np.triu_indices(H)
    mt = host[:b, :T].astype(np.int32)
    st = host[:b, T:].astype(np.int32)
    mism = np.empty((b, H, H), dtype=np.int32)
    shar = np.empty((b, H, H), dtype=np.int32)
    mism[:, iu, ju] = mt
    mism[:, ju, iu] = mt
    shar[:, iu, ju] = st
    shar[:, ju, iu] = st
    return mism, shar


# -------------------------------------------------------- K5 het pairs

def het_pairs(m: torch.Tensor, s: torch.Tensor, r1: torch.Tensor,
              r2: torch.Tensor, out: torch.Tensor) -> None:
    """Write float64 [nwin, I, 2] into ``out``: (m, s)[w, r1[k], r2[k]], each
    individual's own haplotype pair (``r1 == r2`` for a non-diploid, whose
    value the host discards).  Replaces the het gather of the JAX
    ``_modes_tail`` ``blocks_het`` mode."""
    nwin, h, _ = m.shape
    n_ind = r1.shape[0]
    if m.dtype != torch.int32 or s.dtype != torch.int32 or \
            s.shape != m.shape:
        raise ValueError("m and s must be int32 of one shape [nwin, h, h]")
    if out.shape != (nwin, n_ind, 2) or out.dtype != torch.float64:
        raise ValueError(f"out must be float64 {(nwin, n_ind, 2)}")
    if not m.is_cuda:
        out.copy_(het_pairs_plain(m, s, r1, r2))
        return
    _check_cuda(m, s, r1, r2, out)
    if r1.dtype != torch.int32 or r2.dtype != torch.int32:
        raise ValueError("het rows must be int32")
    if nwin == 0 or n_ind == 0:
        return
    _ggt_het_pairs(
        m.data_ptr(), s.data_ptr(), r1.data_ptr(), r2.data_ptr(), h, n_ind,
        nwin, out.data_ptr(), _stream_ptr(m))
    LAUNCHES["het_pairs"] += 1


def launch_probe(n: int, device: torch.device) -> None:
    """Launch the zero-work probe kernel with K5's grid and block for
    ``n`` (window, individual) cells: a measurement of the launch floor a
    short kernel cannot go below, not a kernel of the port (no launch
    count, and no entry point of its own: it resolves through the
    library on every call)."""
    _build.check(_build.lib("pair_v3").ggt_launch_probe(n, _raw_stream(
        device.index if device.index is not None
        else torch.cuda.current_device())), "launch_probe")


def het_pairs_plain(m: torch.Tensor, s: torch.Tensor, r1: torch.Tensor,
                    r2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5 (the JAX form): float64 [nwin, I, 2]."""
    r1, r2 = r1.long(), r2.long()
    return torch.stack([m[:, r1, r2], s[:, r1, r2]], dim=-1) \
        .to(torch.float64)


# ------------------------------------------- K9 general 4-state counts

# K9's and K14's geometry (pair4.cu namespace k9, the tensor-core loop):
# 128 x 128 pairs per block, 128 sites staged per step, split ranges of at
# least 16 steps
_K9_MMA_TILE = 128
_K9_MMA_STAGE = 128
_K9_MIN_SPLIT = 16 * _K9_MMA_STAGE
_NO_SPLIT = (1 << 31) - 1
# float64 cells of one one-hot factor of the plain K9 (per site slab)
_PLAIN_CELLS = 1 << 24
_SM_COUNT: dict = {}


def _sm_count(dev: torch.device) -> int:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SM_COUNT:
        _SM_COUNT[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _SM_COUNT[key]


def _k9_grid(h: int, nwin: int, s_max: int, dev,
             tiles: int | None = None) -> tuple[int, int, int]:
    """(tiles, splits, split_len) of K9's or K14's launch, grid (tiles,
    splits, nwin): ``tiles`` tiles of 128 x 128 pairs a window (default
    K9's upper triangle of h rows; K14 passes its rectangle's).  A block
    holds a whole SM (its registers), so when the windows' tiles give
    fewer blocks than the card has SMs, each window's sites are cut into
    as many ranges as keep the blocks within two full waves, each of whole
    staging steps and at least 16 of them; the ranges add their counts
    with exact int32 atomics."""
    if tiles is None:
        t = -(-h // _K9_MMA_TILE)
        tiles = t * (t + 1) // 2
    blocks = tiles * max(nwin, 1)
    sms = _sm_count(dev)
    if blocks >= sms:
        return tiles, 1, _NO_SPLIT
    splits = min(2 * sms // blocks, s_max // _K9_MIN_SPLIT)
    if splits <= 1:
        return tiles, 1, _NO_SPLIT
    split_len = -(-s_max // splits)
    split_len = -(-split_len // _K9_MMA_STAGE) * _K9_MMA_STAGE
    return tiles, -(-s_max // split_len), split_len


def pair_counts_4state(alleles: torch.Tensor, first: torch.Tensor,
                       n_sites: torch.Tensor, s_max: int | None = None):
    """Mismatch/shared int32 [W, H, H] of the windows
    [first[w], first[w] + n_sites[w]) of an int8 [H, S] allele matrix
    (codes 0..3, -1 missing; rows may be strided, sites contiguous): the
    general 4-state counts.  ``s_max``, the longest window (a host int,
    default S), sets how K9 splits the sites over blocks.  Replaces the
    JAX ``gather_window_batch`` + ``pairwise_counts``."""
    if not alleles.is_cuda:
        return pair_counts_4state_plain(alleles, first, n_sites)
    if alleles.dim() != 2 or alleles.dtype != torch.int8 or \
            alleles.stride(1) != 1:
        raise ValueError("alleles must be int8 [H, S] with contiguous sites")
    if first.dtype != torch.int32 or n_sites.dtype != torch.int32 or \
            first.shape != n_sites.shape or first.dim() != 1:
        raise ValueError("first and n_sites must be int32 [W]")
    _check_cuda(first, n_sites)
    h, S = alleles.shape
    nwin = first.shape[0]
    if nwin > 65535:
        raise ValueError(f"{nwin} windows in one launch (at most 65535)")
    _, splits, split_len = _k9_grid(h, nwin, S if s_max is None else s_max,
                                    alleles.device)
    alloc = torch.zeros if splits > 1 else torch.empty
    m = alloc((nwin, h, h), dtype=torch.int32, device=alleles.device)
    s = alloc((nwin, h, h), dtype=torch.int32, device=alleles.device)
    if nwin == 0 or h == 0:
        return m, s
    _ggt_pair_counts_4state(
        alleles.data_ptr(), alleles.stride(0), S, first.data_ptr(),
        n_sites.data_ptr(), h, nwin, splits, split_len, m.data_ptr(),
        s.data_ptr(), _stream_ptr(m))
    LAUNCHES["pair_counts_4state"] += 1
    return m, s


def pair_counts_4state_plain(alleles: torch.Tensor, first: torch.Tensor,
                             n_sites: torch.Tensor, r0: int = 0,
                             r1: int | None = None):
    """Plain PyTorch K9, the JAX form: gather each window's sites (padded
    slots, and sites outside the matrix, are missing), then the one-hot
    Grams

        shared = called . called^T,  mismatch = shared - sum_c oh_c . oh_c^T

    in float64 (exact counts), over slabs of sites so each [W, H, slab]
    factor stays below 2^24 cells.  With a row block ``r0 .. r1 - 1`` (the
    plain K14) the left factors are those rows alone: [W, r1 - r0, H]."""
    h, S = alleles.shape
    r1 = h if r1 is None else r1
    W = first.shape[0]
    dev = alleles.device
    s = torch.zeros((W, r1 - r0, h), dtype=torch.float64, device=dev)
    match = torch.zeros_like(s)
    f, n = first.long().to(dev), n_sites.long().to(dev)
    n_max = int(n.max()) if W else 0
    slab = max(64, _PLAIN_CELLS // max(W * h, 1))
    for off in range(0, n_max, slab):
        offs = torch.arange(off, min(off + slab, n_max), device=dev)
        idx = f[:, None] + offs[None, :]
        valid = (offs[None, :] < n[:, None]) & (idx >= 0) & (idx < S)
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        wa = alleles[:, idx].permute(1, 0, 2)                  # [W, H, k]
        keep = valid[:, None, :]
        called = ((wa >= 0) & keep).to(torch.float64)
        s += called[:, r0:r1] @ called.transpose(1, 2)
        for c in range(4):
            oh = ((wa == c) & keep).to(torch.float64)
            match += oh[:, r0:r1] @ oh.transpose(1, 2)
    return (s - match).to(torch.int32), s.to(torch.int32)


# ------------------------------------- K14 the rows of the 4-state counts

def pair_counts_4state_rows(alleles: torch.Tensor, first: torch.Tensor,
                            n_sites: torch.Tensor, r0: int, r1: int,
                            s_max: int | None = None):
    """Rows ``r0 .. r1 - 1`` of K9's counts: mismatch/shared int32
    [W, r1 - r0, H], each row against every haplotype (the row block one
    device holds in the tensor-parallel pair counts).  ``s_max`` as in
    :func:`pair_counts_4state`.  Replaces the row-sharded
    ``gather_window_batch`` + ``pairwise_counts`` of the JAX
    ``mesh.sharded_pair_counts_tp``."""
    h, S = alleles.shape
    if not 0 <= r0 < r1 <= h:
        raise ValueError(f"row block {r0}..{r1} outside {h} rows")
    if not alleles.is_cuda:
        return pair_counts_4state_plain(alleles, first, n_sites, r0, r1)
    if alleles.dim() != 2 or alleles.dtype != torch.int8 or \
            alleles.stride(1) != 1:
        raise ValueError("alleles must be int8 [H, S] with contiguous sites")
    if first.dtype != torch.int32 or n_sites.dtype != torch.int32 or \
            first.shape != n_sites.shape or first.dim() != 1:
        raise ValueError("first and n_sites must be int32 [W]")
    _check_cuda(first, n_sites)
    nwin = first.shape[0]
    if nwin > 65535:
        raise ValueError(f"{nwin} windows in one launch (at most 65535)")
    tiles = -(-(r1 - r0) // _K9_MMA_TILE) * -(-h // _K9_MMA_TILE)
    _, splits, split_len = _k9_grid(h, nwin, S if s_max is None else s_max,
                                    alleles.device, tiles)
    alloc = torch.zeros if splits > 1 else torch.empty
    m = alloc((nwin, r1 - r0, h), dtype=torch.int32, device=alleles.device)
    s = alloc((nwin, r1 - r0, h), dtype=torch.int32, device=alleles.device)
    if nwin == 0:
        return m, s
    _ggt_pair_counts_4state_rows(
        alleles.data_ptr(), alleles.stride(0), S, first.data_ptr(),
        n_sites.data_ptr(), h, r0, r1, nwin, splits, split_len,
        m.data_ptr(), s.data_ptr(), _stream_ptr(m))
    LAUNCHES["pair_counts_4state_rows"] += 1
    return m, s


# ------------------------------------------------------------ the flush

def _next_pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


class V3Flush(NamedTuple):
    """One flush's wire-v3 buffer with its static sizes (the packer's),
    the window chunk and the ``tri`` output type."""
    buf: np.ndarray
    spb: int
    spc: int
    spd: int
    h: int
    wp: int
    chunk: int
    ep: int
    u16: bool

    def wire(self, buf: torch.Tensor) -> transfer.PairWireV3:
        """Typed views of ``buf``, this flush's bytes on some device."""
        return transfer.from_jax_wire(buf, self.spb, self.spc, self.spd,
                                      self.h, self.wp, self.ep)


class V2Flush(NamedTuple):
    """One flush's wire-v2 buffer (``GGT_WIRE=2``) with its static sizes,
    the window chunk and the ``tri`` output type."""
    buf: np.ndarray
    sp: int
    h: int
    wp: int
    chunk: int
    ep: int
    u16: bool

    def wire(self, buf: torch.Tensor) -> transfer.PairWireV2:
        """Typed views of ``buf``, this flush's bytes on some device."""
        return transfer.pair_wire_v2_views(buf, self.sp, self.h, self.wp,
                                           self.ep)


def _v3_flush_args(alleles: np.ndarray, first: np.ndarray,
                   n_sites: np.ndarray) -> V3Flush:
    """Host-side prep for the wire-v3 kernels: classify + pack the flush
    buffer, choose the window chunk so the [chunk, H, H] count scratch
    stays bounded, and whether the ``tri`` output fits uint16 (every count
    is at most its window's site count)."""
    W = first.shape[0]
    H = alleles.shape[0]
    wp = _next_pow2(W, 8)
    buf, SpB, SpC, SpD, ep, _ = transfer.pack_pair_wire_v3(
        alleles, first, n_sites, wp)
    return V3Flush(buf, SpB, SpC, SpD, H, wp, _window_chunk(W, H), ep,
                   _tri_u16(n_sites))


def _v2_flush_args(alleles: np.ndarray, first: np.ndarray,
                   n_sites: np.ndarray) -> V2Flush:
    """Host-side prep for the wire-v2 kernels: pack the flush buffer
    (:func:`transfer.pack_pair_wire`), with the chunk and ``tri`` type of
    :func:`_v3_flush_args`."""
    W = first.shape[0]
    H = alleles.shape[0]
    wp = _next_pow2(W, 8)
    buf, Sp, ep = transfer.pack_pair_wire(alleles, first, n_sites, wp)
    return V2Flush(buf, Sp, H, wp, _window_chunk(W, H), ep,
                   _tri_u16(n_sites))


def _flush_args(alleles: np.ndarray, first: np.ndarray, n_sites: np.ndarray):
    """The flush's wire: v3, or v2 under ``GGT_WIRE=2`` (the JAX
    package's switch, pairdist.py:438-445)."""
    if os.environ.get("GGT_WIRE") == "2":
        return _v2_flush_args(alleles, first, n_sites)
    return _v3_flush_args(alleles, first, n_sites)


def _window_chunk(W: int, H: int) -> int:
    """Windows per launch, so the [chunk, H, H] int32 count scratch stays
    bounded (2^25 cells) at large H."""
    chunk = min(_next_pow2(W, 8), 128)
    while chunk > 8 and chunk * H * H > (1 << 25):
        chunk //= 2
    return chunk


def _tri_u16(n_sites: np.ndarray) -> bool:
    """Whether the ``tri`` output fits uint16: every count is at most its
    window's site count (the JAX rule)."""
    return max(int(n_sites.max()), 1) < (1 << 16)


def _chunks(counts, W: int, chunk: int, epilogue) -> None:
    """Count windows 0 .. W-1, ``chunk`` at a time, with
    ``counts(w0, n) -> (m, s)`` and hand each chunk's counts to
    ``epilogue(m, s, w0, n)``."""
    for w0 in range(0, W, chunk):
        n = min(chunk, W - w0)
        epilogue(*counts(w0, n), w0, n)


def _flush(wire, W: int, chunk: int, epilogue) -> None:
    """Run K1 (wire v3) or K13 (wire v2), then K2, over windows 0 .. W-1
    of one wire, ``chunk`` windows at a time, on the wire's device, and
    hand each chunk's counts to ``epilogue(m, s, w0, n)``.  K2's entry
    index is built once for the whole wire."""
    v2 = isinstance(wire, transfer.PairWireV2)
    if wire.buf.device.type != "cuda" and W:
        # the plain K1 / K13 also hold float64 [chunk, H, s_max] factors
        longest = wire.n_sites[:W] if v2 else wire.meta[1:6:2, :W]
        s_max = _next_pow2(max(int(longest.max()), 1), 128)
        while chunk > 8 and chunk * wire.h * s_max > (1 << 26):
            chunk //= 2
    pair_counts = pair_counts_v2 if v2 else pair_counts_v3
    index = exception_index(wire)

    def counts(w0, n):
        m, s = pair_counts(wire, w0, n)
        exception_patch(m, s, wire, w0, index)
        return m, s
    _chunks(counts, W, chunk, epilogue)


def flush_blocks(wire, W: int, chunk: int,
                 groups: PopGroups, min_sites: int) -> torch.Tensor:
    """K1 (or K13), K2 and K3 over one flush: float64 [W, 2, P, P]."""
    out = torch.empty((W, 2, groups.P, groups.P), dtype=torch.float64,
                      device=wire.buf.device)
    _flush(wire, W, chunk, lambda m, s, w0, n: blocks_tail(
        m, s, groups, min_sites, out[w0:w0 + n]))
    return out


def flush_blocks_het(wire, W: int, chunk: int,
                     groups: PopGroups, rows, min_sites: int) -> torch.Tensor:
    """K1 (or K13), K2, K3 and K5 over one flush into ONE float64
    buffer, so one copy brings it back: blocks [W, 2, P, P] then het
    [W, I, 2], flat."""
    P, n_ind = groups.P, rows[0].shape[0]
    flat = torch.empty(W * 2 * P * P + W * n_ind * 2, dtype=torch.float64,
                       device=wire.buf.device)
    blocks = flat[:W * 2 * P * P].view(W, 2, P, P)
    het = flat[W * 2 * P * P:].view(W, n_ind, 2)

    def epilogue(m, s, w0, n):
        blocks_tail(m, s, groups, min_sites, blocks[w0:w0 + n])
        het_pairs(m, s, rows[0], rows[1], het[w0:w0 + n])
    _flush(wire, W, chunk, epilogue)
    return flat


def _tri_out(W: int, h: int, u16: bool, device) -> torch.Tensor:
    T = h * (h + 1) // 2
    return torch.empty((W, 2 * T), dtype=torch.uint16 if u16 else torch.int32,
                       device=device)


def flush_tri(wire, W: int, chunk: int,
              u16: bool) -> torch.Tensor:
    """K1 (or K13), K2 and K4 over one flush: [W, 2T] uint16 or
    int32."""
    out = _tri_out(W, wire.h, u16, wire.buf.device)
    _flush(wire, W, chunk, lambda m, s, w0, n: tri_pack(
        m, s, out[w0:w0 + n]))
    return out


def flush_tri_4state(alleles: torch.Tensor, first: torch.Tensor,
                     n_sites: torch.Tensor, chunk: int, u16: bool,
                     s_max: int) -> torch.Tensor:
    """K9 and K4 over one flush of windows of an int8 [H, S] tensor:
    [W, 2T] uint16 or int32."""
    W = first.shape[0]
    out = _tri_out(W, alleles.shape[0], u16, alleles.device)
    _chunks(lambda w0, n: pair_counts_4state(
        alleles, first[w0:w0 + n], n_sites[w0:w0 + n], s_max), W, chunk,
        lambda m, s, w0, n: tri_pack(m, s, out[w0:w0 + n]))
    return out


# ------------------------------------------ K20 the one-transfer flush

def _fused_flush_pair_counts(buf: torch.Tensor, sp: int, h: int, wp: int,
                             s_max: int, chunk: int) -> torch.Tensor:
    """The one-transfer flush: ``buf`` is the uint8 buffer of
    ``transfer.pack_flush_buffer`` (packed allele planes of [h, sp], then
    ``first`` and ``n_sites`` int32 [wp]); each window's first ``s_max``
    sites are counted and tri-packed: [wp, 2T], T = h(h+1)/2, uint16 when
    ``s_max`` < 2^16, else int32.  ``chunk`` must divide ``wp`` (the JAX
    function maps ``chunk`` windows at a time; K20 needs no intermediate,
    so it counts up to 65,535 windows a launch).  Replaces the JAX
    ``pairdist._fused_flush_pair_counts``."""
    if chunk <= 0 or wp % chunk:
        raise ValueError(f"chunk {chunk} does not divide wp={wp}")
    if not buf.is_cuda:
        return _fused_flush_pair_counts_plain(buf, sp, h, wp, s_max, chunk)
    transfer.flush_views(buf, sp, h, wp)       # checks the buffer's size
    _check_cuda(buf)
    T = h * (h + 1) // 2
    u16 = s_max < (1 << 16)
    out = torch.empty((wp, 2 * T), dtype=torch.uint16 if u16 else torch.int32,
                      device=buf.device)
    if h == 0:
        return out
    for w0 in range(0, wp, 65535):
        _ggt_flush_pair_counts(
            buf.data_ptr(), h, sp, wp, w0, min(65535, wp - w0), s_max,
            int(u16), out.data_ptr(), _stream_ptr(out))
        LAUNCHES["flush_pair_counts"] += 1
    return out


def _fused_flush_pair_counts_plain(buf: torch.Tensor, sp: int, h: int,
                                   wp: int, s_max: int,
                                   chunk: int) -> torch.Tensor:
    """Plain PyTorch K20, the JAX form: ``transfer.unpack_flush_buffer``,
    then per ``chunk`` windows the plain K9 over each window's first
    ``s_max`` sites and the plain K4."""
    alleles, first, n_sites = transfer.unpack_flush_buffer(buf, sp, h, wp)
    n_sites = n_sites.clamp(max=s_max)
    u16 = s_max < (1 << 16)
    return torch.cat([tri_pack_plain(*pair_counts_4state_plain(
        alleles, first[w0:w0 + chunk], n_sites[w0:w0 + chunk]), u16)
        for w0 in range(0, wp, chunk)])


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
    """Numpy mirror of the device blocks tail (K3): float64 nanmean
    numerators/denominators per block, as two matmuls per window
    (``pm @ d0 @ pm.T``).  The JAX package's single three-operand
    ``np.einsum`` contracts without a path, in O(W H^2 P^2): hours at
    H = 512 with one block per individual."""
    ms = max(int(min_sites or 0), 1)
    h = m.shape[1]
    offdiag = ~np.eye(h, dtype=bool)
    valid = (s >= ms) & offdiag[None, :, :]
    d0 = np.zeros(m.shape, dtype=np.float64)
    np.divide(m, s, out=d0, where=valid)
    pm = pop_mask.astype(np.float64)
    sums = pm @ d0 @ pm.T
    cnts = pm @ valid.astype(np.float64) @ pm.T
    return sums, cnts


def _host_counts(alleles, first, n_sites):
    """The host executor's (m, s) of one flush, counted in HOST_FLUSHES."""
    global HOST_FLUSHES
    counts = _host_flush_counts(alleles, first, n_sites)
    if counts is None:
        raise RuntimeError("GGT_EXEC=host needs the native library "
                           "(io/native.py), which did not build")
    HOST_FLUSHES += 1
    return counts


def _host_blocks(alleles, first, n_sites, pop_mask, min_sites):
    return _blocks_from_counts(*_host_counts(alleles, first, n_sites),
                               pop_mask, min_sites)


def _host_blocks_het(alleles, first, n_sites, ind_mask, het_rows,
                     min_sites):
    m, s = _host_counts(alleles, first, n_sites)
    sums, cnts = _blocks_from_counts(m, s, ind_mask, min_sites)
    r1, r2 = het_rows[0], het_rows[1]
    return (sums, cnts, m[:, r1, r2].astype(np.int64),
            s[:, r1, r2].astype(np.int64))


class _ReadyHandle:
    """Lazy handle for the host executor: the flush computes at collect()
    time on the single consumer thread, so at most one batch's [W, H, H]
    matrices are materialized however deep the pipeline is."""

    def __init__(self, thunk):
        self._thunk = thunk

    def collect(self, timer=None, flush=None):
        """The thunk's result; ``timer`` (engine.StageTimer) times it as
        ``d2h``, the stage of the wait it stands in for."""
        with (timer or NO_TIMER).stage("d2h", flush=flush):
            return self._thunk()


# ------------------------------------------------------------ dispatch

def _wait(pending, timer, flush) -> np.ndarray:
    """A flush's result on the host.  ``timer`` (engine.StageTimer) times
    the wait as ``gather`` when the result comes from a mesh's slabs (a
    :class:`transfer.Gathered`; it counts the slabs, ``mesh_slabs``, and
    the joined bytes, ``gather_bytes``), as ``d2h`` otherwise."""
    gathered = isinstance(pending, transfer.Gathered)
    if gathered:
        timer.count("mesh_slabs", pending.n_parts)
    with timer.stage("gather" if gathered else "d2h", flush=flush):
        host = pending.wait()
    if gathered:
        timer.count("gather_bytes", host.nbytes)
    return host


class Slab(NamedTuple):
    """One device's slab of a flush's windows on a mesh
    (:func:`upload_slabs`): its ``k`` windows' wire, packed from the sites
    they cover (``fl``), as ``buf`` on ``device``, and the pinned staging
    to keep alive until the copy is done."""
    device: torch.device
    k: int
    fl: V3Flush | V2Flush
    buf: torch.Tensor
    keep: tuple


class Slabs(tuple):
    """A flush's :class:`Slab` s in window order, as the blocks dispatches
    take them on a mesh."""


def upload_slabs(alleles: np.ndarray, first: np.ndarray,
                 n_sites: np.ndarray, mesh, timer=None) -> Slabs:
    """Cut a flush's windows into one contiguous slab per device of
    ``mesh``, padded and cut as :func:`_mesh_pair_counts` cuts them
    (:func:`transfer.mesh_batch`, :func:`transfer.slabs`), and send each
    non-empty slab to its device as a wire of its own (v3, or v2 under
    ``GGT_WIRE=2``) of only the sites its windows cover: packed
    (``dispatch.pack``), staged and uploaded (:func:`transfer.upload`).
    Nothing is replicated and nothing is padded to a site bucket beyond
    the wire's own."""
    W = first.shape[0]
    _check_windows(first, n_sites, alleles.shape[1])
    timer = timer or NO_TIMER
    parts = []
    for dev, (lo, hi) in zip(mesh.devices, transfer.slabs(
            transfer.mesh_batch(W, mesh.size), mesh.size, W)):
        if hi == lo:
            continue
        f, n = first[lo:hi], n_sites[lo:hi]
        live = n > 0
        s0, s1 = (int(f[live].min()), int((f + n)[live].max())) \
            if live.any() else (0, 0)
        with timer.span("dispatch.pack"):
            fl = _flush_args(alleles[:, s0:s1],
                             np.clip(f - s0, 0, s1 - s0).astype(np.int32), n)
        buf, keep = transfer.upload(fl.buf, dev, timer=timer)
        parts.append(Slab(dev, hi - lo, fl, buf, keep))
    return Slabs(parts)


def _slab_dispatch(alleles, first: np.ndarray, n_sites: np.ndarray, mesh,
                   timer, flush, join=np.concatenate) -> transfer.Gathered:
    """The blocks routes on a mesh: each device runs ``flush(wire, k,
    chunk, device)`` (K1 or K13, K2, K3, and K5 for ``blocks_het``) on its
    slab of :func:`upload_slabs` (``alleles`` is their result, or the host
    span they are made from), its launches inside
    :func:`transfer.fetch_on`; the results come back joined by ``join`` in
    window order.  ``timer`` spans the launches (``dispatch.launch``) and
    counts the slabs, ``blocks_slabs``."""
    timer = timer or NO_TIMER
    slabs = alleles if isinstance(alleles, Slabs) else upload_slabs(
        alleles, first, n_sites, mesh, timer)
    timer.count("blocks_slabs", len(slabs))
    with timer.span("dispatch.launch"):
        return transfer.Gathered(
            [transfer.fetch_on(s.device, lambda s=s: flush(
                s.fl.wire(s.buf), s.k, s.fl.chunk, s.device), keep=s.keep)
             for s in slabs], join)


class PairBlockStatsHandle:
    """In-flight per-window pop-block distance sums.

    ``collect()`` returns float64 (sums [W, P, P], counts [W, P, P]):
    sums[w, x, y] = sum over valid (i in pop x, j in pop y) of
    mismatch/shared; counts = number of valid pairs.  Valid = off-diagonal
    and shared >= max(min_sites, 1) — exactly the non-NaN entries of the
    reference's per-window distance matrix after ``apply_min_sites``
    (stats/popgen.DistStatsContext).  ``timer`` (engine.StageTimer; the
    CLI gives it on a mesh) times the wait as :func:`_wait` does and the
    split into the two arrays as ``mirror``."""

    def __init__(self, W: int, P: int, pending=None):
        self.W, self.P, self._pending = W, P, pending

    def collect(self, timer=None, flush=None):
        if self._pending is None:
            z = np.zeros((self.W, self.P, self.P), dtype=np.float64)
            return z, z.copy()
        timer = timer or NO_TIMER
        host = _wait(self._pending, timer, flush)
        self._pending = None
        with timer.stage("mirror", flush=flush):
            return host[:, 0].copy(), host[:, 1].copy()


def window_pair_block_stats_dispatch(alleles, first: np.ndarray,
                                     n_sites: np.ndarray,
                                     pop_mask: np.ndarray,
                                     min_sites: int, timer=None,
                                     mesh=None) -> PairBlockStatsHandle:
    """Dispatch the fused popDist/popPairDist flush: pair counts AND the
    float64 per-pop-block reductions run on the device; only [W, 2, P, P]
    floats come back (vs [W, H, H] count matrices).

    ``pop_mask``: float [P, H] 0/1 row membership per population (np.unique
    group order), every row in exactly one group.  The host finalize
    (stats/popgen.group_dist_stats_from_blocks) reproduces the reference's
    nanmean_min/Fst arithmetic exactly.  ``timer`` (engine.StageTimer)
    spans the wire's pack (``dispatch.pack``), then the staging and the
    launches (:func:`transfer.run_on_device`).  With a ``mesh`` each
    device counts its slab of the windows (:func:`_slab_dispatch`;
    ``alleles`` may be their :func:`upload_slabs`)."""
    W = first.shape[0]
    P = pop_mask.shape[0]
    if W == 0:
        return PairBlockStatsHandle(W, P)
    if mesh is not None:
        return PairBlockStatsHandle(W, P, _slab_dispatch(
            alleles, first, n_sites, mesh, timer,
            lambda wire, k, chunk, dev: flush_blocks(
                wire, k, chunk, _pop_groups(pop_mask, dev), min_sites)))
    if _exec_choice() == "host":
        return _ReadyHandle(lambda: _host_blocks(
            alleles, first, n_sites, pop_mask, min_sites))
    dev = get_device()
    timer = timer or NO_TIMER
    with timer.span("dispatch.pack"):
        fl = _flush_args(alleles, first, n_sites)
    groups = _pop_groups(pop_mask, dev)
    return PairBlockStatsHandle(W, P, transfer.run_on_device(
        fl.buf, dev, lambda buf: flush_blocks(
            fl.wire(buf), W, fl.chunk, groups, min_sites), timer=timer))


class PairBlocksHetHandle:
    """In-flight packed (blocks | het) results of the ``blocks_het`` flush
    (one float64 buffer per flush, fetched by one copy).

    ``collect()`` -> (sums f64 [W, P, P], cnts f64 [W, P, P],
    het_m int64 [W, I], het_s int64 [W, I]); P is the mask's block count
    (populations, or individuals for the indPairDist path — pop blocks are
    exact aggregations of individual blocks).  ``timer``: as
    :meth:`PairBlockStatsHandle.collect`."""

    def __init__(self, W: int, P: int, n_ind: int, pending=None):
        self.W, self.P, self.n_ind, self._pending = W, P, n_ind, pending

    def collect(self, timer=None, flush=None):
        W, P = self.W, self.P
        if self._pending is None:
            z = np.zeros((W, P, P), dtype=np.float64)
            e = np.zeros((W, self.n_ind), dtype=np.int64)
            return z, z.copy(), e, e.copy()
        timer = timer or NO_TIMER
        host = _wait(self._pending, timer, flush)
        self._pending = None
        with timer.stage("mirror", flush=flush):
            blocks = host[:W * 2 * P * P].reshape(W, 2, P, P)
            het = host[W * 2 * P * P:].reshape(W, self.n_ind, 2)
            return (blocks[:, 0].copy(), blocks[:, 1].copy(),
                    het[..., 0].astype(np.int64),
                    het[..., 1].astype(np.int64))


def window_pair_ind_blocks_dispatch(alleles, first: np.ndarray,
                                    n_sites: np.ndarray,
                                    ind_mask: np.ndarray,
                                    het_rows: np.ndarray,
                                    min_sites: int, timer=None,
                                    mesh=None) -> PairBlocksHetHandle:
    """Fused popDist/popPairDist/indPairDist/indHet flush: per-block sums
    and counts (K3) plus each individual's own-pair raw (mismatch, shared)
    (K5) come back in one transfer, never [W, H, H] matrices.

    ``ind_mask``: float [P, H] 0/1 row membership per block (individuals,
    or populations for indHet without indPairDist), every row in exactly
    one block; ``het_rows``: int32 [2, I] the two haplotype rows of each
    individual (any pair for non-diploids — the host overwrites their het
    with NaN).  ``timer`` and ``mesh``: as
    :func:`window_pair_block_stats_dispatch`; the slabs' (blocks | het)
    buffers are joined into one such buffer of the whole flush."""
    W = first.shape[0]
    P, n_ind = ind_mask.shape[0], het_rows.shape[1]
    if W == 0:
        return PairBlocksHetHandle(W, P, n_ind)
    if mesh is not None:
        nb = 2 * P * P

        def join(parts):
            cut = [p.size // (nb + 2 * n_ind) * nb for p in parts]
            return np.concatenate([p[:c] for p, c in zip(parts, cut)]
                                  + [p[c:] for p, c in zip(parts, cut)])
        return PairBlocksHetHandle(W, P, n_ind, _slab_dispatch(
            alleles, first, n_sites, mesh, timer,
            lambda wire, k, chunk, dev: flush_blocks_het(
                wire, k, chunk, _pop_groups(ind_mask, dev),
                _het_rows(het_rows, wire.h, dev), min_sites), join))
    if _exec_choice() == "host":
        return _ReadyHandle(lambda: _host_blocks_het(
            alleles, first, n_sites, ind_mask, het_rows, min_sites))
    dev = get_device()
    timer = timer or NO_TIMER
    with timer.span("dispatch.pack"):
        fl = _flush_args(alleles, first, n_sites)
    groups = _pop_groups(ind_mask, dev)
    rows = _het_rows(het_rows, alleles.shape[0], dev)
    return PairBlocksHetHandle(W, P, n_ind, transfer.run_on_device(
        fl.buf, dev, lambda buf: flush_blocks_het(
            fl.wire(buf), W, fl.chunk, groups, rows, min_sites),
        timer=timer))


class PairCountsHandle:
    """In-flight pair counts of one flush (the ``tri`` output).
    ``collect()`` waits for the fetch and returns numpy (mismatch
    [W, H, H], shared [W, H, H]) int32 in window order: the only [W, H, H]
    arrays of the flush on the host, made at collect time.  ``timer``
    (engine.StageTimer) times the wait for the packed triangles as
    :func:`_wait` does and their unpacking as ``mirror``."""

    def __init__(self, W: int, H: int, pending=None):
        self.W, self.H, self._pending = W, H, pending

    def collect(self, timer=None, flush=None):
        if self._pending is None:
            z = np.zeros((self.W, self.H, self.H), dtype=np.int32)
            return z, z.copy()
        timer = timer or NO_TIMER
        host = _wait(self._pending, timer, flush)
        self._pending = None
        with timer.stage("mirror", flush=flush):
            return _tri_unpack(host, self.W, self.H)


def _check_windows(first: np.ndarray, n_sites: np.ndarray, S: int) -> None:
    if ((n_sites < 0) | ((n_sites > 0)
                         & ((first < 0) | (first + n_sites > S)))).any():
        raise ValueError(f"a window's range leaves the span of {S} sites")


def window_pair_counts_dispatch(alleles, first: np.ndarray,
                                n_sites: np.ndarray,
                                mesh=None) -> PairCountsHandle:
    """Dispatch the pair counts of one flush without fetching them.

    ``alleles`` is the flush's int8 [H, S] span.  A host array ships as one
    wire-v3 buffer (wire v2 under ``GGT_WIRE=2``): K1 (K13) and K2 count
    each window chunk and K4 packs the upper triangles (uint16 when every
    window has fewer than 2^16 sites).
    Under ``GGT_PACKED_TRANSFER=0`` it ships as the raw int8 matrix with the
    windows (one upload, :func:`transfer.pack_raw_span`), and a tensor (the
    JAX device-array route) is counted where it lies; both of those run the
    general 4-state counts K9, then K4, per window chunk.  ``GGT_EXEC=host``
    sends a host span to the host C executor.  With a ``mesh`` the window
    batch is counted data-parallel over its devices
    (:func:`_mesh_pair_counts`)."""
    W = first.shape[0]
    H, S = alleles.shape
    if W == 0:
        return PairCountsHandle(W, H)
    if mesh is not None:
        return _mesh_pair_counts(alleles, first, n_sites, mesh)
    on_host = isinstance(alleles, np.ndarray)
    if on_host and _exec_choice() == "host":
        return _ReadyHandle(lambda: _host_counts(alleles, first, n_sites))
    if on_host and transfer.packed_enabled():
        dev = get_device()
        fl = _flush_args(alleles, first, n_sites)
        return PairCountsHandle(W, H, transfer.run_on_device(
            fl.buf, dev, lambda buf: flush_tri(
                fl.wire(buf), W, fl.chunk, fl.u16)))
    first = np.ascontiguousarray(first, dtype=np.int32)
    n_sites = np.ascontiguousarray(n_sites, dtype=np.int32)
    _check_windows(first, n_sites, S)
    chunk, u16 = _window_chunk(W, H), _tri_u16(n_sites)
    s_max = int(n_sites.max())
    if on_host:
        buf = transfer.pack_raw_span(alleles, first, n_sites)
        return PairCountsHandle(W, H, transfer.run_on_device(
            buf, get_device(), lambda b: flush_tri_4state(
                *transfer.raw_span_views(b, H, S, W), chunk, u16, s_max)))
    meta = np.concatenate([first, n_sites]).view(np.uint8)

    def run(b):
        fn = b.view(torch.int32)
        return flush_tri_4state(alleles, fn[:W], fn[W:], chunk, u16, s_max)
    return PairCountsHandle(W, H, transfer.run_on_device(
        meta, alleles.device, run))


def _mesh_pair_counts(alleles, first: np.ndarray, n_sites: np.ndarray,
                      mesh) -> PairCountsHandle:
    """Data-parallel pair counts (the JAX ``_sharded_gathered_pair_counts``):
    the window batch, padded to ``n_dev * 2^k``, is cut into one contiguous
    slab per device.  The span is replicated over the mesh (a host span as
    the raw bucket-padded upload, the int8 array of the JAX mesh route: no
    wire v3, no host executor; a :class:`transfer.Replicated` span is
    counted where it lies), and each device runs K9 + K4 on its slab's
    windows.  The slabs come back in window order."""
    W = first.shape[0]
    H, S = alleles.shape
    first = np.ascontiguousarray(first, dtype=np.int32)
    n_sites = np.ascontiguousarray(n_sites, dtype=np.int32)
    _check_windows(first, n_sites, S)
    span = transfer.upload_span(alleles, mesh=mesh) \
        if isinstance(alleles, np.ndarray) else \
        transfer.replicate(alleles, mesh)
    u16, s_max = _tri_u16(n_sites), int(n_sites.max())
    parts = []
    for d, a, (lo, hi) in zip(mesh.devices, span.shards, transfer.slabs(
            transfer.mesh_batch(W, mesh.size), mesh.size, W)):
        if hi == lo:
            continue
        k = hi - lo
        meta = np.concatenate([first[lo:hi], n_sites[lo:hi]]).view(np.uint8)

        def run(b, a=a, k=k):
            fn = b.view(torch.int32)
            return flush_tri_4state(a, fn[:k], fn[k:], _window_chunk(k, H),
                                    u16, s_max)
        parts.append(transfer.run_on_device(meta, d, run))
    return PairCountsHandle(W, H, transfer.Gathered(parts))


def window_pair_counts(alleles, first: np.ndarray, n_sites: np.ndarray,
                       mesh=None):
    """Dispatch + collect in one call: numpy (mismatch [W, H, H], shared
    [W, H, H]) int32 in window order."""
    return window_pair_counts_dispatch(alleles, first, n_sites,
                                       mesh=mesh).collect()


# ----------------------------------------------- the long-span consumers

def long_span_pair_counts(alleles_dev, first: int, last: int,
                          block: int = 1 << 18):
    """Pairwise counts over one long span [first, last) (e.g. distMat
    --windType cat) as numpy int64 [H, H] (mismatch, shared): K9 counts
    each block of ``block`` sites as one window and the blocks add up in
    int64 on the device.  ``alleles_dev`` is an int8 [H, S] tensor or a
    host array, which is uploaded raw (:func:`transfer.device_alleles`),
    or counted by the host executor under ``GGT_EXEC=host``."""
    if isinstance(alleles_dev, np.ndarray) and _exec_choice() == "host":
        span = np.ascontiguousarray(alleles_dev[:, first:last])
        m, s = _host_counts(span, np.array([0], np.int64),
                            np.array([last - first], np.int64))
        return m[0].astype(np.int64), s[0].astype(np.int64)
    if isinstance(alleles_dev, np.ndarray):
        alleles_dev = transfer.device_alleles(alleles_dev)
    H, S = alleles_dev.shape
    dev = alleles_dev.device
    starts = np.arange(first, last, block, dtype=np.int32)
    lens = (np.minimum(starts.astype(np.int64) + block, last)
            - starts).astype(np.int32)
    _check_windows(starts, lens, S)
    f = torch.from_numpy(starts).to(dev)
    n = torch.from_numpy(lens).to(dev)
    mism = torch.zeros((H, H), dtype=torch.int64, device=dev)
    shar = torch.zeros_like(mism)
    for k in range(starts.shape[0]):
        m, s = pair_counts_4state(alleles_dev, f[k:k + 1], n[k:k + 1],
                                  int(lens[k]))
        mism += m[0]
        shar += s[0]
    return mism.cpu().numpy(), shar.cpu().numpy()


class CatPairAccumulator:
    """Streaming genome-wide pair-count accumulator (distMat --windType
    cat), the JAX class's counterpart.

    Sites are appended into one staging block of ``block`` sites; each
    full block, and the tail, is counted by K9 as one window of the
    block's own length (no padding) while only the [H, H] int64
    accumulators stay on the host: O(block) memory.  One block stays in
    flight, so the card counts block k while the host parses block k + 1;
    launching block k + 1 first collects block k.  On CUDA the staging
    block is pinned memory uploaded with ``non_blocking``, and it is
    written again only after that upload's event.  Under ``GGT_EXEC=host``
    the host C executor counts each block instead."""

    def __init__(self, H: int, block: int = 1 << 18):
        self.H, self.block = H, block
        self.fill = 0
        self.mism = np.zeros((H, H), dtype=np.int64)
        self.shar = np.zeros((H, H), dtype=np.int64)
        self._pending = None
        self._uploaded = None            # event after the staging upload
        self._dev = None if _exec_choice() == "host" else get_device()
        self._stage = torch.empty(
            (H, block), dtype=torch.int8,
            pin_memory=self._dev is not None and self._dev.type == "cuda")
        self.buf = self._stage.numpy()

    def _launch(self, S: int):
        self._collect()
        if self._dev is None:
            m, s = _host_counts(np.ascontiguousarray(self.buf[:, :S]),
                                np.array([0], np.int64),
                                np.array([S], np.int64))
            self.mism += m[0]
            self.shar += s[0]
            return
        window = torch.tensor([0, S], dtype=torch.int32)
        if self._dev.type != "cuda":
            m, s = pair_counts_4state(self._stage, window[:1], window[1:], S)
            self.mism += m[0].numpy()
            self.shar += s[0].numpy()
            return
        a = self._stage.to(self._dev, non_blocking=True)
        window = window.pin_memory().to(self._dev, non_blocking=True)
        self._uploaded = torch.cuda.Event()
        self._uploaded.record()
        m, s = pair_counts_4state(a, window[:1], window[1:], S)
        res = torch.empty((2, self.H, self.H), dtype=torch.int32,
                          pin_memory=True)
        res[0].copy_(m[0], non_blocking=True)
        res[1].copy_(s[0], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending = transfer.Pending(res, done, keep=(a, window, m, s))

    def _collect(self):
        if self._pending is not None:
            host = self._pending.wait()
            self.mism += host[0]
            self.shar += host[1]
            self._pending = None

    def add(self, a: np.ndarray):
        """Append int8 [H, n] sites; dispatches full blocks."""
        n = a.shape[1]
        off = 0
        while n - off > 0:
            if self._uploaded is not None:
                self._uploaded.synchronize()
                self._uploaded = None
            take = min(self.block - self.fill, n - off)
            self.buf[:, self.fill:self.fill + take] = a[:, off:off + take]
            self.fill += take
            off += take
            if self.fill == self.block:
                self._launch(self.block)
                self.fill = 0

    def finish(self):
        """Flush the tail and return (mismatch, shared) int64 [H, H]."""
        if self.fill:
            self._launch(self.fill)
            self.fill = 0
        self._collect()
        return self.mism, self.shar
