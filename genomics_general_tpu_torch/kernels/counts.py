"""Per-site allele counting for popgenWindows' popFreq and WC Fst.

Replaces the reference's per-site Python loops (``binBaseFreqs`` /
``Alignment.siteFreqs``, genomics.py:592-599, 1049-1052):

    counts[s, p, a] = sum_h pop_mask[p, h] * (alleles[h, s] == a)

The flush span ships as the 2-bit span wire (transfer.pack_span: 2-bit
codes [H, Sp/4], then the missing-bit plane [H, Sp/8]) and the CUDA kernel
:func:`site_pop_counts` (K6, kernels/csrc/counts.cu) counts from it in
place: there is no device-side unpack.  Counts come back uint16 while
H < 2^16 (a count never exceeds H), else int32, and widen to int32 on the
host; every downstream statistic derives from them in float64 on the host.

The wrapper launches K6 for CUDA tensors (counting the launch in
``LAUNCHES``) and runs :func:`site_pop_counts_plain` only for CPU tensors.
``GGT_EXEC=host`` counts on the host instead: the C counter
(io/native.site_pop_counts_host, copied from the JAX package) for up to 8
masks, numpy above that.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from . import _build
from . import transfer
from .pairdist import PopGroups, _ReadyHandle, _check_cuda, _exec_choice, \
    _pop_groups, _stream_ptr

# sites per kernel launch when counting long site axes
DEFAULT_SITE_BLOCK = 1 << 18

# launches of the CUDA kernel since the last reset (the plain version and
# the host counters never count)
LAUNCHES = {"site_pop_counts": 0}
# flushes counted on the host (GGT_EXEC=host)
HOST_FLUSHES = 0


def reset_launches() -> None:
    global HOST_FLUSHES
    LAUNCHES["site_pop_counts"] = 0
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
    code = _build.lib("counts").ggt_site_pop_counts(
        buf.data_ptr(), h, sp, s0, s1, groups.perm.data_ptr(),
        groups.offs.data_ptr(), P, int(out.dtype == torch.uint16),
        out.data_ptr(), _stream_ptr(buf))
    _build.check(code, "site_pop_counts")
    LAUNCHES["site_pop_counts"] += 1


def site_pop_counts_plain(buf: torch.Tensor, sp: int, h: int, s0: int,
                          s1: int, pop_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6 (the JAX form): unpack the span, then one float64
    matmul of the [P, H] mask with each allele's 0/1 plane — exact
    integers.  Returns int32 [s1 - s0, P, 4]."""
    al = transfer.unpack_span(buf, sp, h)[:, s0:s1]
    pm = pop_mask.to(buf.device, torch.float64)
    counts = torch.stack([pm @ (al == a).to(torch.float64)
                          for a in range(4)], dim=-1)     # [P, S, 4]
    return counts.permute(1, 0, 2).to(torch.int32)


def _count_span(buf: torch.Tensor, sp: int, h: int, S: int,
                groups: PopGroups, block: int) -> torch.Tensor:
    """K6 over sites 0 .. S - 1, ``block`` sites per launch."""
    out = torch.empty((S, groups.P, 4), dtype=count_dtype(h),
                      device=buf.device)
    for s0 in range(0, S, block):
        s1 = min(s0 + block, S)
        site_pop_counts(buf, sp, h, s0, s1, groups, out[s0:s1])
    return out


# ------------------------------------------------------------ host route

def _host_site_pop_counts(alleles: np.ndarray,
                          pop_mask: np.ndarray) -> np.ndarray:
    """int32 [S, P, 4] on the host: the C counter for P <= 8 (the JAX
    package's host route), numpy for more masks."""
    global HOST_FLUSHES
    H, S = alleles.shape
    P = pop_mask.shape[0]
    HOST_FLUSHES += 1
    if P <= 8:
        from ..io import native
        membership = np.zeros(H, dtype=np.uint8)
        for p in range(P):
            membership[np.asarray(pop_mask[p]) > 0] |= 1 << p
        c = native.site_pop_counts_host_native(alleles, membership)
        if c is None:
            raise RuntimeError("GGT_EXEC=host needs the native library "
                               "(io/native.py), which did not build")
        if c.shape[1] < P:       # trailing all-empty masks
            c = np.concatenate(
                [c, np.zeros((S, P - c.shape[1], 4), c.dtype)], axis=1)
        return c[:, :P].astype(np.int32)
    pm = (np.asarray(pop_mask) > 0).astype(np.int64)
    return np.stack([(pm @ (alleles == a)).T for a in range(4)],
                    axis=-1).astype(np.int32)


# ------------------------------------------------------------ dispatch

class SitePopCountsHandle:
    """In-flight per-site counts of one span; ``collect()`` waits for the
    fetch and returns numpy int32 [S, P, 4]."""

    def __init__(self, S: int, P: int, pending=None):
        self.S, self.P, self._pending = S, P, pending

    def collect(self) -> np.ndarray:
        if self._pending is None:
            return np.zeros((self.S, self.P, 4), dtype=np.int32)
        host = self._pending.wait()
        self._pending = None
        return host.astype(np.int32)


def site_pop_counts_dispatch(alleles, pop_mask: np.ndarray,
                             block: int = DEFAULT_SITE_BLOCK):
    """Dispatch per-site counting of a host int8 [H, S] span without
    fetching.  ``pop_mask``: 0/1 [P, H], every row in exactly one group
    (popgenWindows' mask puts ungrouped rows in the "" group).  The span
    ships once as the 2-bit span wire; K6 counts ``block`` sites per
    launch (a multiple of 8)."""
    if not isinstance(alleles, np.ndarray) or not transfer.packed_enabled():
        raise NotImplementedError(
            "site counts of a device-array span or with "
            "GGT_PACKED_TRANSFER=0 are not ported yet: ROADMAP queue 2, "
            "rows 7 and 13")
    if block % 8:
        raise ValueError(f"block {block} is not a multiple of 8")
    H, S = alleles.shape
    P = pop_mask.shape[0]
    if S == 0:
        return SitePopCountsHandle(S, P)
    if _exec_choice() == "host":
        return _ReadyHandle(lambda: _host_site_pop_counts(alleles, pop_mask))
    dev = get_device()
    buf, Sp = transfer.pack_span(alleles)
    groups = _pop_groups(pop_mask, dev)
    return SitePopCountsHandle(S, P, transfer.run_on_device(
        buf, dev, lambda b: _count_span(b, Sp, H, S, groups, block)))


def site_pop_counts_chunked(alleles, pop_mask: np.ndarray,
                            block: int = DEFAULT_SITE_BLOCK) -> np.ndarray:
    """Dispatch + collect in one call: numpy int32 [S, P, 4]."""
    return site_pop_counts_dispatch(alleles, pop_mask, block=block).collect()
