"""Per-site allele counting for popgenWindows' popFreq and WC Fst, and
for ABBABABAwindows / fourPopWindows.

Replaces the reference's per-site Python loops (``binBaseFreqs`` /
``Alignment.siteFreqs``, genomics.py:592-599, 1049-1052):

    counts[s, p, a] = sum_h pop_mask[p, h] * (alleles[h, s] == a)

A host span ships as the 2-bit span wire (transfer.pack_span: 2-bit
codes [H, Sp/4], then the missing-bit plane [H, Sp/8]) and the CUDA kernel
:func:`site_pop_counts` (K6, kernels/csrc/counts.cu) counts from it in
place: there is no device-side unpack.  Under ``GGT_PACKED_TRANSFER=0`` the
span ships as the raw int8 matrix padded to the site bucket
(transfer.upload_span), and an int8 tensor (a device array) is counted
where it lies: :func:`site_pop_counts_raw` (K12) reads those rows through
their stride.  Counts come back uint16 while H < 2^16 (a count never
exceeds H), else int32, and widen to int32 on the host; every downstream
statistic derives from them in float64 on the host.  K6 and K12 take a
partition of the haplotype rows; any other 0/1 mask (rows that overlap,
as ABBA's P1, P2, P3, O and their union, or rows in no mask) is counted
on the partition of its distinct membership columns
(:class:`MaskClasses`), and each mask's counts are exact integer sums of
its classes'.

Two library functions on an int8 [H, S] matrix have kernels of their own
in counts.cu: :func:`site_nonmissing` (K18), the called haplotypes of each
site and population (any 0/1 mask, counted on its classes), and
:func:`sample_base_counts` (K19), each haplotype's one-hot code.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
``LAUNCHES``) and runs its plain version only for CPU tensors.
``GGT_EXEC=host`` counts a host span on the host instead: the C counter
(io/native.site_pop_counts_host, copied from the JAX package) for up to 8
masks, numpy above that.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import get_device
from . import _build
from . import transfer
from .pairdist import PopGroups, _ReadyHandle, _check_cuda, _exec_choice, \
    _pop_groups, _run_const, _sm_count, _stream_ptr

# sites per kernel launch when counting long site axes
DEFAULT_SITE_BLOCK = 1 << 18

# launches of the CUDA kernel since the last reset (the plain version and
# the host counters never count)
LAUNCHES = {"site_pop_counts": 0, "site_pop_counts_raw": 0,
            "global_sfs_hist": 0, "stacked_reduce": 0, "site_nonmissing": 0,
            "sample_base_counts": 0}
# the C entry points, each resolved on its first launch (_build.Entry)
_ggt_site_pop_counts = _build.Entry("counts", "ggt_site_pop_counts")
_ggt_site_pop_counts_raw = _build.Entry("counts", "ggt_site_pop_counts_raw")
_ggt_global_sfs_hist = _build.Entry("counts", "ggt_global_sfs_hist")
_ggt_stacked_reduce = _build.Entry("counts", "ggt_stacked_reduce")
_ggt_site_nonmissing = _build.Entry("counts", "ggt_site_nonmissing")
_ggt_sample_base_counts = _build.Entry("counts", "ggt_sample_base_counts")
# flushes counted on the host (GGT_EXEC=host)
HOST_FLUSHES = 0


def reset_launches() -> None:
    global HOST_FLUSHES
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    HOST_FLUSHES = 0


def count_dtype(h: int) -> torch.dtype:
    """uint16 while every count fits (H < 2^16), else int32."""
    return torch.uint16 if h < (1 << 16) else torch.int32


# ---------------------------------------------------- K6 site pop counts

def site_pop_counts(buf: torch.Tensor, sp: int, h: int, s0: int, s1: int,
                    groups: PopGroups, out: torch.Tensor) -> None:
    """Write the counts of sites s0 .. s1 - 1 of the span wire ``buf``
    (uint8, :func:`transfer.pack_span` layout for [h, sp]) into ``out``
    [s1 - s0, P, 4] (uint16 or int32).  ``s0`` is a multiple of 8, so the
    block starts on a whole byte of both planes.  Replaces the JAX
    ``counts.site_pop_counts`` / ``_site_pop_counts_u16`` with the
    ``_unpack`` of the span wire."""
    P = groups.P
    if s0 % 8 or not 0 <= s0 <= s1 <= sp:
        raise ValueError(f"site block {s0}..{s1} of sp={sp}: s0 must be a "
                         "multiple of 8")
    if out.shape != (s1 - s0, P, 4) or \
            out.dtype not in (torch.uint16, torch.int32):
        raise ValueError(f"out must be uint16 or int32 {(s1 - s0, P, 4)}")
    if buf.dtype != torch.uint8 or buf.numel() != h * (sp // 4 + sp // 8):
        raise ValueError("buf is not the uint8 span wire of [h, sp]")
    if not buf.is_cuda:
        out.copy_(site_pop_counts_plain(buf, sp, h, s0, s1, groups.mask))
        return
    _check_cuda(buf, groups.perm, groups.offs, out)
    if s1 == s0:
        return
    _ggt_site_pop_counts(
        buf.data_ptr(), h, sp, s0, s1, groups.perm.data_ptr(),
        groups.offs.data_ptr(), P, _k12_lanes(s1 - s0, P, buf.device),
        int(out.dtype == torch.uint16), out.data_ptr(), _stream_ptr(buf))
    LAUNCHES["site_pop_counts"] += 1


def _onehot_counts(al: torch.Tensor, pop_mask: torch.Tensor) -> torch.Tensor:
    """The JAX form on int8 alleles [H, S]: one float64 matmul of the
    [P, H] mask with each allele's 0/1 plane — exact integers.  Returns
    int32 [S, P, 4]."""
    pm = pop_mask.to(al.device, torch.float64)
    counts = torch.stack([pm @ (al == a).to(torch.float64)
                          for a in range(4)], dim=-1)     # [P, S, 4]
    return counts.permute(1, 0, 2).to(torch.int32)


def site_pop_counts_plain(buf: torch.Tensor, sp: int, h: int, s0: int,
                          s1: int, pop_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6 (the JAX form): unpack the span, then the one-hot
    matmul.  Returns int32 [s1 - s0, P, 4]."""
    return _onehot_counts(transfer.unpack_span(buf, sp, h)[:, s0:s1],
                          pop_mask)


def count_span(buf: torch.Tensor, sp: int, h: int, S: int,
               groups: PopGroups, block: int = DEFAULT_SITE_BLOCK
               ) -> torch.Tensor:
    """K6 over sites 0 .. S - 1, ``block`` sites per launch."""
    out = torch.empty((S, groups.P, 4), dtype=count_dtype(h),
                      device=buf.device)
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        site_pop_counts(buf, sp, h, s0, s1, groups, out[s0:s1])
    return out


# ---------------------------------------------------- K12 raw counts

def _k12_lanes(n: int, P: int, dev) -> int:
    """Lanes a row of the row-slot loop's blocks (K6, K12, K18: 4 sites a
    lane, 256 threads, one group a block, so a block covers 4 * lanes
    sites of one of the P groups): 16 while the blocks over ``n`` sites
    give four a SM (up to 8 are resident), else 8."""
    blocks = -(-n // 64) * min(P, 65535)
    return 16 if blocks >= 4 * _sm_count(dev) else 8


def site_pop_counts_raw(alleles: torch.Tensor, s0: int, s1: int,
                        groups: PopGroups, out: torch.Tensor) -> None:
    """Write the counts of sites s0 .. s1 - 1 of an int8 [H, S] allele
    matrix (codes 0..3, below 0 missing; rows may be strided, sites
    contiguous) into ``out`` [s1 - s0, P, 4] (uint16 or int32).  Replaces
    the JAX ``counts.site_pop_counts`` / ``_site_pop_counts_u16`` on a raw
    upload or a device array."""
    P = groups.P
    if alleles.dim() != 2 or alleles.dtype != torch.int8:
        raise ValueError("alleles must be int8 [H, S]")
    if not 0 <= s0 <= s1 <= alleles.shape[1]:
        raise ValueError(f"site block {s0}..{s1} outside "
                         f"{alleles.shape[1]} sites")
    if out.shape != (s1 - s0, P, 4) or \
            out.dtype not in (torch.uint16, torch.int32):
        raise ValueError(f"out must be uint16 or int32 {(s1 - s0, P, 4)}")
    if not alleles.is_cuda:
        out.copy_(site_pop_counts_raw_plain(alleles, s0, s1, groups.mask))
        return
    if alleles.stride(1) != 1:
        raise ValueError("alleles must have contiguous sites")
    _check_cuda(groups.perm, groups.offs, out)
    if s1 == s0:
        return
    _ggt_site_pop_counts_raw(
        alleles.data_ptr(), alleles.stride(0), s0, s1,
        groups.perm.data_ptr(), groups.offs.data_ptr(), P,
        _k12_lanes(s1 - s0, P, alleles.device),
        int(out.dtype == torch.uint16),
        out.data_ptr(), _stream_ptr(alleles))
    LAUNCHES["site_pop_counts_raw"] += 1


def site_pop_counts_raw_plain(alleles: torch.Tensor, s0: int, s1: int,
                              pop_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K12 (the JAX form): the one-hot matmul of sites
    s0 .. s1 - 1.  Returns int32 [s1 - s0, P, 4]."""
    return _onehot_counts(alleles[:, s0:s1], pop_mask)


def count_raw(alleles: torch.Tensor, S: int, groups: PopGroups,
              block: int = DEFAULT_SITE_BLOCK) -> torch.Tensor:
    """K12 over sites 0 .. S - 1, ``block`` sites per launch."""
    out = torch.empty((S, groups.P, 4), dtype=count_dtype(alleles.shape[0]),
                      device=alleles.device)
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        site_pop_counts_raw(alleles, s0, s1, groups, out[s0:s1])
    return out


# ------------------------------------------------- K15 the global SFS

def sfs_dims(n_hap) -> tuple[int, ...]:
    """The dense folded joint SFS's shape: ``n_hap[p] + 1`` a population."""
    return tuple(int(n) + 1 for n in n_hap)


# K15's launch (counts.cu; 256 threads a block): sites a tile staged in
# shared memory, blocks an SM, and the bytes of each block's private
# histogram of the low corner (the bins where every population's target
# count is at most k).  On the H100 at full width (3 x 128 haplotypes;
# kernel_ab.py --sweep) 2 and 4 KB corners tied, and 16 KB (k = 15) cost
# more in its zeroing and flush than it saved: a block sees few sites of
# any bin but the hottest, so its flush made nearly one atomic a site it
# held.
_K15_TILE = 1024
_K15_BLOCKS_PER_SM = 8
_K15_CORNER_BYTES = 2 << 10
# the most bytes of a tile (fewer sites a tile when a site is wide), and
# the most populations K15 takes (its shared memory holds their constants
# and at least one site)
_K15_TILE_BYTES = 64 << 10
_K15_MAX_POPS = 2048


def sfs_corner(n_hap, corner_bytes: int) -> np.ndarray:
    """The radices of K15's corner: ``min(k + 1, n_hap[p] + 1)`` a
    population for the largest k whose corner of int32 entries fits
    ``corner_bytes`` (0 everywhere, no corner, when a population has a
    negative ``n_hap``)."""
    n = np.asarray(n_hap, dtype=np.int64).reshape(-1)
    if n.size == 0 or n.min() < 0:
        return np.zeros(n.size, np.int64)
    cap = max(corner_bytes // 4, 1)
    lo, hi = 0, int(n.max())
    while lo < hi:                       # the largest k that fits
        k = (lo + hi + 1) // 2
        if math.prod(np.minimum(k + 1, n + 1).tolist()) <= cap:
            lo = k
        else:
            hi = k - 1
    return np.minimum(lo + 1, n + 1)


def _sfs_pop_consts(n_hap: np.ndarray, corner_bytes: int,
                    device: torch.device):
    """K15's int64 [4, P] (each population's bin stride, n_hap, corner
    radix and corner stride) on ``device`` and the corner's entries,
    built once per (n_hap, corner budget)."""
    def build(_):
        dims = sfs_dims(n_hap)
        cdim = sfs_corner(n_hap, corner_bytes).tolist()
        stride = [math.prod(dims[p + 1:]) for p in range(len(dims))]
        cstride = [math.prod(cdim[p + 1:]) for p in range(len(dims))]
        pop = np.array([stride, n_hap, cdim, cstride], np.int64)
        return torch.from_numpy(pop).to(device), math.prod(cdim)
    key = np.append(np.asarray(n_hap, np.int64), corner_bytes)
    return _run_const("sfs", key, device, build)


def global_sfs_hist(counts: torch.Tensor, n_hap) -> torch.Tensor:
    """The dense folded joint SFS of one shard's sites as int32
    [prod(n_hap + 1)] (row-major, population 0 most significant), from
    their counts [S, P, 4] (uint16 or int32) and the populations'
    haplotype counts ``n_hap`` [P]: a site with every population complete
    (its counts sum to ``n_hap[p]``) and 1 or 2 alleles in all adds 1 at
    its populations' counts of the allele at position 2 of the stable
    ascending order of the totals (the second-commonest; ties keep the
    lower code first, as ``jnp.argsort``).  Replaces the per-shard body of
    the JAX ``mesh.sharded_global_sfs``."""
    n_hap = np.asarray(n_hap, dtype=np.int32).reshape(-1)
    if counts.dim() != 3 or counts.shape[1:] != (n_hap.shape[0], 4):
        raise ValueError(f"counts must be [S, {n_hap.shape[0]}, 4]")
    if not counts.is_cuda:
        return global_sfs_hist_plain(counts, n_hap)
    if counts.dtype not in (torch.uint16, torch.int32):
        raise ValueError("counts must be uint16 or int32")
    _check_cuda(counts)
    S, P, _ = counts.shape
    if P > _K15_MAX_POPS:
        raise ValueError(f"global_sfs_hist takes at most {_K15_MAX_POPS} "
                         "populations")
    nbins = math.prod(sfs_dims(n_hap))
    hist = torch.zeros(nbins, dtype=torch.int32, device=counts.device)
    if S == 0:
        return hist
    pop, ncorner = _sfs_pop_consts(n_hap, _K15_CORNER_BYTES, counts.device)
    site_bytes = 4 * P * counts.element_size()
    tile = max(1, min(_K15_TILE, _K15_TILE_BYTES // site_bytes))
    blocks = min(-(-S // tile), _K15_BLOCKS_PER_SM * _sm_count(counts.device))
    _ggt_global_sfs_hist(
        counts.data_ptr(), int(counts.dtype == torch.uint16), S, P, tile,
        pop.data_ptr(), ncorner, nbins, blocks, hist.data_ptr(),
        _stream_ptr(hist))
    LAUNCHES["global_sfs_hist"] += 1
    return hist


def global_sfs_hist_plain(counts: torch.Tensor, n_hap) -> torch.Tensor:
    """Plain PyTorch K15, the JAX form: the passing sites' flat bins
    (:func:`global_sfs_bins_plain`) scatter-added into a dense histogram."""
    flat = global_sfs_bins_plain(counts, n_hap)
    hist = torch.zeros(math.prod(sfs_dims(n_hap)), dtype=torch.int64,
                       device=flat.device)
    hist.index_add_(0, flat, torch.ones_like(flat))
    return hist.to(torch.int32)


def global_sfs_bins_plain(counts: torch.Tensor, n_hap) -> torch.Tensor:
    """The flat int64 bin of each site that passes K15's gate, in site
    order: a stable argsort of the totals, the target's counts as a flat
    index (int64, wrapping as it does)."""
    c = counts.to(torch.int64)
    nh = torch.as_tensor(np.asarray(n_hap, np.int64), device=c.device)
    complete = (c.sum(dim=2) == nh[None, :]).all(dim=1)
    total = c.sum(dim=1)                                       # [S, 4]
    n_alleles = (total > 0).sum(dim=1)
    ok = complete & (n_alleles >= 1) & (n_alleles <= 2)
    target = torch.argsort(total, dim=1, stable=True)[:, 2]
    tgt = torch.gather(c, 2, target[:, None, None].expand(-1, c.shape[1], 1)
                       )[:, :, 0]                              # [S, P]
    dims = sfs_dims(n_hap)
    flat = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    stride = 1
    for p in range(len(dims) - 1, -1, -1):
        flat += tgt[:, p] * stride
        stride *= dims[p]
    return flat[ok]


# ------------------------------------------- K16 the stacked reduction

def stacked_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """The sum (``op="sum"``, wrapping as the integer type does) or the
    minimum (``"min"``) over the leading axis of a [k, ...] int64 or int32
    stack (k >= 1) on one device: [...] of the same type.  Replaces the
    reduce of the JAX ``multihost.mesh_reduce_stacked`` and the psum of
    ``mesh.sharded_global_sfs``."""
    if op != "sum" and op != "min":
        raise ValueError(f"op must be 'sum' or 'min', not {op!r}")
    shape = x.shape
    if not shape or shape[0] < 1:
        raise ValueError("stacked_reduce needs a [k, ...] stack, k >= 1")
    if not x.is_cuda:
        return stacked_reduce_plain(x, op)
    dt = x.dtype
    if dt is not torch.int32 and dt is not torch.int64:
        raise ValueError("stacked_reduce takes int64 or int32")
    if not x.is_contiguous():
        raise ValueError("kernel inputs must be contiguous CUDA tensors")
    out = torch.empty(shape[1:], dtype=dt, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    _ggt_stacked_reduce(x.data_ptr(), dt is torch.int64, shape[0], n,
                        op == "min", out.data_ptr(), _stream_ptr(out))
    LAUNCHES["stacked_reduce"] += 1
    return out


def stacked_reduce_plain(x: torch.Tensor, op: str) -> torch.Tensor:
    """Plain PyTorch K16: ``torch.sum`` in the stack's type, or
    ``torch.amin``, over dim 0."""
    return x.sum(dim=0, dtype=x.dtype) if op == "sum" else x.amin(dim=0)


# ------------------------------- K18 called counts, K19 the one-hot

# mask rows one K18 block folds its classes into (counts.cu kFoldRows)
_K18_FOLD_ROWS = 64


def _check_alleles(alleles: torch.Tensor) -> None:
    if alleles.dim() != 2 or alleles.dtype != torch.int8:
        raise ValueError("alleles must be int8 [H, S]")
    if alleles.is_cuda and alleles.stride(1) != 1:
        raise ValueError("alleles must have contiguous sites")


def _check_01(mask: np.ndarray) -> None:
    if not np.isin(mask, (0, 1)).all():
        raise ValueError("pop_mask must hold only 0 and 1")


def _nonmissing_classes(mask: np.ndarray, dev: torch.device):
    """(perm, offs, C, bits) K18 counts the 0/1 mask [P, H] on, checked,
    built and uploaded once per distinct mask: its membership classes
    (:class:`MaskClasses`) but the one in no mask row, which sorts first
    and whose rows K18 then never reads; ``bits`` int32 [C, P]."""
    def build(m: np.ndarray):
        _check_01(m)
        classes = MaskClasses(m, dev)
        g = classes.groups
        skip = int(not classes.bits[0].any())
        n0 = int((~(m > 0).any(axis=0)).sum())
        offs = g.offs[skip:] - n0
        bits = classes.bits[skip:].astype(np.int32)
        return (g.perm[n0:], offs, bits.shape[0],
                torch.from_numpy(bits).to(dev))
    return _run_const("nonmissing", mask, dev, build)


def site_nonmissing(alleles: torch.Tensor, pop_mask) -> torch.Tensor:
    """Called haplotypes per site and population: int32 [S, P], from an
    int8 [H, S] matrix (below 0 missing; rows may be strided, sites
    contiguous) and a 0/1 mask [P, H] (numpy or tensor; rows may overlap
    or leave haplotypes out; any other value raises ``ValueError``).
    Replaces the JAX ``counts.site_nonmissing``."""
    _check_alleles(alleles)
    mask = np.asarray(pop_mask.cpu() if isinstance(pop_mask, torch.Tensor)
                      else pop_mask)
    H, S = alleles.shape
    if mask.ndim != 2 or mask.shape[1] != H:
        raise ValueError(f"pop_mask must be [P, {H}]")
    P = mask.shape[0]
    if not alleles.is_cuda:
        _check_01(mask)
        return site_nonmissing_plain(
            alleles, torch.from_numpy(mask.astype(np.float64)))
    if S * P * H == 0:
        _check_01(mask)
        return torch.zeros((S, P), dtype=torch.int32, device=alleles.device)
    perm, offs, C, bits = _nonmissing_classes(mask, alleles.device)
    out = torch.empty((S, P), dtype=torch.int32, device=alleles.device)
    _ggt_site_nonmissing(
        alleles.data_ptr(), alleles.stride(0), S, perm.data_ptr(),
        offs.data_ptr(), C, bits.data_ptr(), P,
        _k12_lanes(S, -(-P // _K18_FOLD_ROWS), alleles.device),
        out.data_ptr(), _stream_ptr(out))
    LAUNCHES["site_nonmissing"] += 1
    return out


def site_nonmissing_plain(alleles: torch.Tensor,
                          pop_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K18, the JAX form: the float64 matmul of the mask with
    the called matrix (exact counts), transposed to int32 [S, P]."""
    called = (alleles >= 0).to(torch.float64)
    pm = pop_mask.to(alleles.device, torch.float64)
    return (pm @ called).T.to(torch.int32)


def sample_base_counts(alleles: torch.Tensor) -> torch.Tensor:
    """Each haplotype's one-hot code: int32 [H, S, 4] from an int8 [H, S]
    matrix (rows may be strided, sites contiguous); a missing call or any
    code outside 0..3 gives four zeros.  Replaces the JAX
    ``counts.sample_base_counts``."""
    _check_alleles(alleles)
    if not alleles.is_cuda:
        return sample_base_counts_plain(alleles)
    H, S = alleles.shape
    out = torch.empty((H, S, 4), dtype=torch.int32, device=alleles.device)
    if H * S == 0:
        return out
    _ggt_sample_base_counts(
        alleles.data_ptr(), alleles.stride(0), H, S, out.data_ptr(),
        _stream_ptr(out))
    LAUNCHES["sample_base_counts"] += 1
    return out


def sample_base_counts_plain(alleles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K19, the JAX form: each code compared with 0..3."""
    return torch.stack([alleles == a for a in range(4)],
                       dim=-1).to(torch.int32)


# ------------------------------------------------------- any 0/1 mask

class MaskClasses:
    """Any 0/1 mask [P, H] (rows may overlap, as ABBA's P1, P2, P3, O and
    their union or freq's ingroup union; rows may lie in no mask) as the
    partition K6 and K12 take: the haplotype rows grouped by their
    membership column ``mask[:, h]``, one class per distinct column.

    ``groups`` is the PopGroups of the C classes, ``bits`` int64 [C, P]
    each class's 0/1 membership (host), in ascending order of the code
    ``sum_p bits[c, p] << p``; ``codes`` int32 [C] those codes on
    ``device`` (for K7, which only ever has P = 5; None above P = 31).  A
    mask's counts are the exact integer sum of the counts of the classes
    in it (:meth:`combine`)."""

    def __init__(self, pop_mask: np.ndarray, device: torch.device):
        mask = np.asarray(pop_mask, dtype=np.float64)
        if mask.ndim != 2 or not np.isin(mask, (0.0, 1.0)).all():
            raise ValueError("MaskClasses needs a 0/1 mask [P, H]")
        self.P, H = mask.shape
        # last mask row first: the lexicographic order of the columns is
        # the ascending order of their codes
        cols, cls = np.unique(mask.T[:, ::-1] > 0, axis=0,
                              return_inverse=True)
        self.bits = cols[:, ::-1].astype(np.int64)
        onehot = np.zeros((cols.shape[0], H))
        onehot[cls.reshape(-1), np.arange(H)] = 1.0
        self.groups = PopGroups(onehot, device)
        self.codes = None
        if self.P <= 31:
            codes = (self.bits << np.arange(self.P)).sum(axis=1)
            self.codes = torch.from_numpy(codes.astype(np.int32)).to(device)

    def combine(self, class_counts: np.ndarray) -> np.ndarray:
        """int [S, C, 4] class counts -> int32 [S, P, 4] mask counts."""
        c = np.asarray(class_counts, dtype=np.int64)
        return np.einsum("sca,cp->spa", c, self.bits).astype(np.int32)


def _mask_classes(pop_mask: np.ndarray, device: torch.device) -> MaskClasses:
    """The run's MaskClasses, built and uploaded once."""
    mask = np.ascontiguousarray(pop_mask, dtype=np.float64)
    return _run_const("classes", mask, device,
                      lambda m: MaskClasses(m, device))


def is_partition(pop_mask: np.ndarray) -> bool:
    """True when every haplotype row lies in exactly one mask row."""
    return bool(((np.asarray(pop_mask) > 0).sum(axis=0) == 1).all())


# ------------------------------------------------------------ host route

def membership_bits(pop_mask: np.ndarray) -> np.ndarray:
    """uint8 [H]: bit p set when the row lies in mask row p (P <= 8), the
    membership the C site counter takes."""
    m = np.asarray(pop_mask) > 0
    return (m.astype(np.uint8)
            << np.arange(m.shape[0], dtype=np.uint8)[:, None]
            ).sum(axis=0).astype(np.uint8)


def _host_site_pop_counts(alleles: np.ndarray,
                          pop_mask: np.ndarray) -> np.ndarray:
    """int32 [S, P, 4] on the host: the C counter for P <= 8 (the JAX
    package's host route), numpy for more masks."""
    global HOST_FLUSHES
    S = alleles.shape[1]
    P = pop_mask.shape[0]
    HOST_FLUSHES += 1
    if P <= 8:
        from ..io import native
        c = native.site_pop_counts_host_native(alleles,
                                               membership_bits(pop_mask))
        if c is None:
            raise RuntimeError("GGT_EXEC=host needs the native library "
                               "(io/native.py), which did not build")
        if c.shape[1] < P:       # trailing all-empty masks
            c = np.concatenate(
                [c, np.zeros((S, P - c.shape[1], 4), c.dtype)], axis=1)
        return c[:, :P].astype(np.int32)
    # float64 products of 0/1 factors are exact integers (and take BLAS)
    pm = (np.asarray(pop_mask) > 0).astype(np.float64)
    return np.stack([(pm @ (alleles == a).astype(np.float64)).T
                     for a in range(4)], axis=-1).astype(np.int32)


# ------------------------------------------------------------ dispatch

class SitePopCountsHandle:
    """In-flight per-site counts of one span; ``collect()`` waits for the
    fetch and returns numpy int32 [S, P, 4].  ``classes`` (a MaskClasses)
    means the fetch holds class counts, combined here on the host."""

    def __init__(self, S: int, P: int, pending=None, classes=None):
        self.S, self.P, self._pending = S, P, pending
        self._classes = classes

    def collect(self) -> np.ndarray:
        if self._pending is None:
            return np.zeros((self.S, self.P, 4), dtype=np.int32)
        host = self._pending.wait()
        self._pending = None
        if self._classes is not None:
            return self._classes.combine(host)
        return host.astype(np.int32)


def _count_groups(pop_mask: np.ndarray, dev: torch.device):
    """(groups, classes) the kernels count ``pop_mask`` on, on ``dev``:
    its groups when it is a partition (classes None), else its membership
    classes' (:class:`MaskClasses`)."""
    if is_partition(pop_mask):
        return _pop_groups(pop_mask, dev), None
    classes = _mask_classes(pop_mask, dev)
    return classes.groups, classes


def site_pop_counts_dispatch(alleles, pop_mask: np.ndarray,
                             block: int = DEFAULT_SITE_BLOCK, mesh=None):
    """Dispatch per-site counting of an int8 [H, S] span without fetching.
    ``alleles`` is a host array or an int8 tensor (a device array, or a
    strided view of one such as ``dev[:, :S]``); ``pop_mask``: any 0/1
    [P, H].  When every row lies in exactly one group (popgenWindows' mask
    puts ungrouped rows in the "" group) the kernels count the groups;
    otherwise they count the membership classes (:class:`MaskClasses`) and
    the host sums them per mask.

    Counting is sequence-parallel over the devices of the ``mesh``
    (default: the one device ``get_device()``, or the tensor's; the JAX
    ``_sharded_site_pop_counts``): each launch block of ``block`` sites (a
    multiple of 8), padded to a multiple of the mesh size, is cut into one
    contiguous slab per device, which counts its slab, and the slabs come
    back in site order.  A host span is replicated once over the mesh, as
    the 2-bit span wire (K6) or under ``GGT_PACKED_TRANSFER=0`` as the raw
    bucket-padded upload (:func:`transfer.upload_span`, K12); a tensor or
    a :class:`transfer.Replicated` is counted where it lies (K12).  Only
    without a mesh may ``GGT_EXEC=host`` count a host span on the host."""
    if block % 8:
        raise ValueError(f"block {block} is not a multiple of 8")
    H, S = alleles.shape
    P = pop_mask.shape[0]
    if S == 0:
        return SitePopCountsHandle(S, P)
    on_host = isinstance(alleles, np.ndarray)
    if mesh is None:
        if on_host and _exec_choice() == "host":
            return _ReadyHandle(
                lambda: _host_site_pop_counts(alleles, pop_mask))
        from ..parallel.mesh import Mesh
        mesh = Mesh([get_device() if on_host else alleles.device])
    wire = on_host and transfer.packed_enabled()
    if wire:
        buf, Sp = transfer.pack_span(alleles)
        src = transfer.replicate(buf, mesh)
    elif on_host:
        src = transfer.upload_span(alleles, mesh=mesh)
    else:
        src = transfer.replicate(alleles, mesh)
    classes = _count_groups(pop_mask, mesh.devices[0])[1]
    parts = []
    for s0 in range(0, S, block):
        n = min(block, S - s0)
        for d, a, (lo, hi) in zip(mesh.devices, src.shards,
                                  transfer.sharded_axis(n, mesh.size)):
            if hi == lo:
                continue
            groups = _count_groups(pop_mask, d)[0]
            if wire:
                run = (lambda a=a, lo=s0 + lo, hi=s0 + hi, g=groups:
                       _span_slab(a, Sp, H, lo, hi, g))
            else:
                run = (lambda a=a, lo=s0 + lo, hi=s0 + hi, g=groups:
                       _raw_slab(a, lo, hi, g))
            parts.append(transfer.fetch_on(d, run))
    return SitePopCountsHandle(S, P, transfer.Gathered(parts), classes)


def _span_slab(buf: torch.Tensor, sp: int, h: int, lo: int, hi: int,
               groups: PopGroups) -> torch.Tensor:
    """K6 counts of sites lo .. hi - 1 of the span wire: K6 starts on a
    whole byte of both planes, so it counts from lo rounded down to a
    multiple of 8 and the first ``lo % 8`` rows are dropped."""
    lo8 = lo - lo % 8
    out = torch.empty((hi - lo8, groups.P, 4), dtype=count_dtype(h),
                      device=buf.device)
    site_pop_counts(buf, sp, h, lo8, hi, groups, out)
    return out[lo - lo8:]


def _raw_slab(alleles: torch.Tensor, lo: int, hi: int,
              groups: PopGroups) -> torch.Tensor:
    """K12 counts of sites lo .. hi - 1 of an int8 [H, S] tensor."""
    out = torch.empty((hi - lo, groups.P, 4),
                      dtype=count_dtype(alleles.shape[0]),
                      device=alleles.device)
    site_pop_counts_raw(alleles, lo, hi, groups, out)
    return out


def site_pop_counts_chunked(alleles, pop_mask: np.ndarray,
                            block: int = DEFAULT_SITE_BLOCK,
                            mesh=None) -> np.ndarray:
    """Dispatch + collect in one call: numpy int32 [S, P, 4]."""
    return site_pop_counts_dispatch(alleles, pop_mask, block=block,
                                    mesh=mesh).collect()
