"""ABBA-BABA / f4-family window reduction for ABBABABAwindows and
fourPopWindows.

The port of genomics_general_tpu/kernels/abba.py.  One flush ships as one
wire buffer (transfer.pack_flush_buffer: the 2-bit span wire, then the
windows' ``first`` and ``n_sites``; under ``GGT_PACKED_TRANSFER=0`` too,
as the JAX fused route ships it, abba.py:411, :427) and three CUDA kernels
reduce it to [W, K] float64 window sums, the only thing fetched (reference
semantics: genomics.py:1647-1695, 1585-1643):

* K6 ``site_pop_counts`` (kernels/csrc/counts.cu) counts each site's
  alleles on the membership-class partition of the overlapping P1, P2, P3,
  O and union mask (counts.MaskClasses);
* K7 :func:`abba_site_terms` (kernels/csrc/abba.cu) sums the classes into
  the 5 x 4 population counts, gates the site (biallelic across the union,
  per-population minData), picks the alleles (polarize / fixed / minor via
  numpy's argsort tie order) and writes each site's K channels — float64
  terms equal to numpy's bit for bit;
* K8 :func:`abba_window_sums` (abba.cu) sums each window's range of sites
  (windows may overlap) with a fixed reduction tree.  Only this summation
  order differs from numpy's, a <= 1 ulp effect below the 4-decimal CSV
  rounding.

Each wrapper launches its kernel for CUDA tensors (counting the launch in
``LAUNCHES``) and runs its plain PyTorch version, in this module, only for
CPU tensors.  ``GGT_EXEC=host`` runs :func:`host_window_abba_sums` instead
(the C site counter and numpy terms, copied from the JAX package).  The
host finalize (:func:`finalize_window_stats`) divides the fetched sums.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import get_device
from . import _build
from . import counts as counts_k
from . import transfer
from .pairdist import _ReadyHandle, _check_cuda, _exec_choice, _stream_ptr

# fetched channels, classic panel (ABBABABAwindows) and full panel (fourPop)
CLASSIC_CHANNELS = ("good", "used", "num_f4", "den_D", "den_fd", "den_fdm",
                    "ABBA", "BABA")
FULL_CHANNELS = CLASSIC_CHANNELS + (
    "num_f4c", "den_fhom_old", "den_fhom_new", "den_fd_new", "den_fdm_new",
    "den_fdh", "den_fdh2", "den_fh", "ABAA", "BAAA")
MODES = ("polarize", "fixed", "minor")

# launches of each CUDA kernel since the last reset (the plain versions
# and the host executor never count)
LAUNCHES = {"abba_site_terms": 0, "abba_window_sums": 0}
# the C entry points, each resolved on its first launch (_build.Entry)
_ggt_abba_site_terms = _build.Entry("abba", "ggt_abba_site_terms")
_ggt_abba_window_sums = _build.Entry("abba", "ggt_abba_window_sums")
# flushes run by the host executor (GGT_EXEC=host)
HOST_FLUSHES = 0


def reset_launches() -> None:
    global HOST_FLUSHES
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    HOST_FLUSHES = 0


def _np_argsort2_lut() -> np.ndarray:
    """LUT replicating ``np.argsort(freqs)[:, 2]`` (the reference's minor-
    allele pick, genomics.py:1677) for every weak ordering of 4 values.

    numpy's small-array introsort is NOT stable on ties (e.g.
    np.argsort([.5,.5,0,0]) == [3,2,1,0]), and the reference's minor-allele
    choice inherits that tie order, so a plain stable device argsort picks
    different alleles on tied sites.  Key = base-3 code of the 6 pairwise
    comparisons (<,==,>); value = the index numpy returns at position 2.
    Validated against np.argsort on 200k tie-heavy rows."""
    import itertools
    lut = np.full(729, 0, np.int8)
    pairs = list(itertools.combinations(range(4), 2))
    for r in itertools.product(range(4), repeat=4):
        v = np.array(r, float)
        c = 0
        for k, (i, j) in enumerate(pairs):
            t = 0 if v[i] < v[j] else (1 if v[i] == v[j] else 2)
            c += t * 3 ** k
        lut[c] = np.argsort(v)[2]
    return lut


_ARGSORT2_LUT = _np_argsort2_lut()
_PAIRS_4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def channels_of(full: bool) -> tuple:
    return FULL_CHANNELS if full else CLASSIC_CHANNELS


_LUTS: dict = {}


def _lut(device: torch.device) -> torch.Tensor:
    """The tie LUT as int8 [729] on ``device``, uploaded once a device."""
    lut = _LUTS.get(device)
    if lut is None:
        lut = _LUTS[device] = torch.from_numpy(_ARGSORT2_LUT.copy()).to(
            device)
    return lut


# -------------------------------------------------------- K7 site terms

def abba_site_terms(counts: torch.Tensor, codes: torch.Tensor, n_pops,
                    min_data: float, mode: str, full: bool) -> torch.Tensor:
    """Per-site channels float64 [S, K] from class counts [S, C, 4]
    (uint16 or int32, K6's output on a :class:`counts.MaskClasses`
    partition) and the classes' membership codes int32 [C] (bit p: P1, P2,
    P3, O, union).  Channel k of site s is the sum over the site's selected
    alleles of term k (``good`` is 1 for a gated site, ``used`` the number
    of selected alleles); a site that fails the gate is all zeros.
    Replaces the JAX ``_np_minor_allele`` + ``_site_terms`` and the freqs
    step of ``fused_abba_flush``."""
    if counts.dim() != 3 or counts.shape[2] != 4 or \
            codes.shape != (counts.shape[1],):
        raise ValueError("counts must be [S, C, 4] and codes [C]")
    if mode not in MODES or len(n_pops) != 4:
        raise ValueError(f"mode must be one of {MODES}, n_pops 4 sizes")
    if not counts.is_cuda:
        return abba_site_terms_plain(counts, codes, n_pops, min_data, mode,
                                     full)
    if counts.dtype not in (torch.uint16, torch.int32) or \
            codes.dtype != torch.int32:
        raise ValueError("counts must be uint16 or int32, codes int32")
    _check_cuda(counts, codes)
    S, C, _ = counts.shape
    out = torch.empty((S, len(channels_of(full))), dtype=torch.float64,
                      device=counts.device)
    if S == 0:
        return out
    _ggt_abba_site_terms(
        counts.data_ptr(), int(counts.dtype == torch.uint16), S, C,
        codes.data_ptr(), _lut(counts.device).data_ptr(),
        *(float(n) for n in n_pops), float(min_data), MODES.index(mode),
        int(full), out.data_ptr(), _stream_ptr(out))
    LAUNCHES["abba_site_terms"] += 1
    return out


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _f4(p1, p2, p3, p4):
    return (1 - p1) * p2 * p3 * (1 - p4) - p1 * (1 - p2) * p3 * (1 - p4)


def _f4c(p1, p2, p3, p4):
    return _f4(p1, p2, p3, p4) + _f4(1 - p1, 1 - p2, 1 - p3, 1 - p4)


def _allele_terms(p1, p2, p3, p4, full: bool) -> list:
    """The K - 2 term channels of (site, allele) pairs: the expressions of
    the JAX ``host_window_abba_sums``, in its order (a boolean factor is a
    multiply by 1.0 or 0.0, ``** 2`` is ``x * x``)."""
    q1, q2, q3, q4 = 1 - p1, 1 - p2, 1 - p3, 1 - p4
    abba = q1 * p2 * p3 * q4
    baba = p1 * q2 * p3 * q4
    num_f4 = abba - baba
    pd = p2 * _f64(p2 > p3) + p3 * _f64(p3 >= p2)
    den_fd = _f4(p1, pd, pd, p4)
    a = p3 > p1
    b = p3 > p2
    x = p1 > p2
    y = ~x
    pdm1 = p3 * _f64(x & a) + p1 * _f64(~(x & a))
    pdm2 = p3 * _f64(y & b) + p2 * _f64(~(y & b))
    pdm3 = -p3 * _f64(x & a) + p3 * _f64(y & b) - p1 * _f64(x & ~a) \
        + p2 * _f64(y & ~b)
    den_fdm = _f4(pdm1, pdm2, pdm3, p4)
    chans = [num_f4, abba + baba, den_fd, den_fdm, abba, baba]
    if full:
        num_f4c = _f4c(p1, p2, p3, p4)
        t11 = _f4c(p1, p3, p3, p4)
        t12 = _f4c(p4, p2, p3, p4)
        t21 = _f4c(p3, p2, p3, p4)
        t22 = _f4c(p1, p4, p3, p4)
        den_fdh = torch.maximum(torch.maximum(t11, t12),
                                torch.maximum(t21, t22))
        t31 = _f4c(p1, p2, p2, p4)
        t32 = _f4c(p1, p2, p3, p1)
        t41 = _f4c(p1, p2, p1, p4)
        t42 = _f4c(p1, p2, p3, p2)
        den_fdh2 = torch.maximum(den_fdh,
                                 torch.maximum(torch.maximum(t31, t32),
                                               torch.maximum(t41, t42)))
        t1 = torch.abs(p1 - p2)
        t2 = torch.abs(p3 - p4)
        dh = t1 * _f64(t1 > t2) + t2 * _f64(t2 >= t1)
        abaa = q1 * p2 * q3 * q4
        baaa = p1 * q2 * q3 * q4
        den_fdm_new = _f4c(pdm1, pdm2, pdm3, p4)
        chans += [num_f4c, _f4(p1, p3, p3, p4), _f4c(p1, p3, p3, p4),
                  _f4c(p1, pd, pd, p4), den_fdm_new, den_fdh, den_fdh2,
                  dh * dh, abaa, baaa]
    return chans


def abba_site_terms_plain(counts: torch.Tensor, codes: torch.Tensor,
                          n_pops, min_data: float, mode: str,
                          full: bool) -> torch.Tensor:
    """Plain PyTorch K7: the same float64 [S, K], computed on all four
    alleles of every site and masked."""
    dev = counts.device
    c = counts.to(torch.int64)
    bits = (codes.to(dev, torch.int64)[:, None]
            >> torch.arange(5, device=dev)) & 1               # [C, 5]
    c5 = torch.stack([c[:, bits[:, p] == 1].sum(dim=1) for p in range(5)],
                     dim=1)                                   # [S, 5, 4]
    nonmiss = c5.sum(dim=2)                                   # [S, 5]
    good = (c5[:, 4] > 0).sum(dim=1) == 2
    for k in range(4):
        good &= (_f64(nonmiss[:, k]) / float(n_pops[k])) >= min_data
    freqs = _f64(c5) / _f64(nonmiss)[:, :, None]              # NaN: no calls
    p1, p2, p3, p4, pu = freqs.unbind(dim=1)                  # [S, 4] each
    if mode == "minor":
        key = torch.zeros(c.shape[0], dtype=torch.int64, device=dev)
        for k, (i, j) in enumerate(_PAIRS_4):
            u, v = pu[:, i], pu[:, j]
            trit = torch.where(u < v, 0, torch.where(u == v, 1, 2))
            key += trit * 3 ** k
        mi = torch.from_numpy(_ARGSORT2_LUT).to(dev, torch.int64)[key]
        sel = mi[:, None] == torch.arange(4, device=dev)
    else:
        sel = (c5[:, 4] > 0) & (p4 == 0)
        if mode == "fixed":
            for p in (p1, p2, p3):
                sel &= (p == 0) | (p == 1)
    sel &= good[:, None]
    terms = torch.stack(_allele_terms(p1, p2, p3, p4, full), dim=2)
    # numpy's order of the (site, allele) pairs: the first selected
    # allele's terms, plus the next one's
    acc = torch.zeros_like(terms[:, 0])
    seen = torch.zeros_like(good)
    for a in range(4):
        s = sel[:, a, None]
        acc = torch.where(s, torch.where(seen[:, None], acc + terms[:, a],
                                         terms[:, a]), acc)
        seen |= sel[:, a]
    return torch.cat([_f64(good)[:, None], _f64(sel.sum(dim=1))[:, None],
                      acc], dim=1)


# ------------------------------------------------------- K8 window sums

def abba_window_sums(terms: torch.Tensor, first: torch.Tensor,
                     n_sites: torch.Tensor) -> torch.Tensor:
    """float64 [W, K]: row w sums ``terms`` [S, K] over sites first[w] ..
    first[w] + n_sites[w] - 1 (int32 [W] each; windows may overlap; every
    range must lie inside [0, S), which the kernel clips to).  Replaces
    the window gather-sum of the JAX ``fused_abba_flush``."""
    if terms.dim() != 2 or terms.dtype != torch.float64 or \
            first.shape != n_sites.shape or first.dim() != 1:
        raise ValueError("terms must be float64 [S, K], first and n_sites "
                         "[W]")
    if not terms.is_cuda:
        return abba_window_sums_plain(terms, first, n_sites)
    S, K = terms.shape
    if K not in (len(CLASSIC_CHANNELS), len(FULL_CHANNELS)):
        raise ValueError(f"K = {K} is neither panel's channel count")
    if first.dtype != torch.int32 or n_sites.dtype != torch.int32:
        raise ValueError("first and n_sites must be int32")
    _check_cuda(terms, first, n_sites)
    W = first.shape[0]
    out = torch.empty((W, K), dtype=torch.float64, device=terms.device)
    if W == 0:
        return out
    _ggt_abba_window_sums(
        terms.data_ptr(), S, K, first.data_ptr(), n_sites.data_ptr(), W,
        out.data_ptr(), _stream_ptr(out))
    LAUNCHES["abba_window_sums"] += 1
    return out


def abba_window_sums_plain(terms: torch.Tensor, first: torch.Tensor,
                           n_sites: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8 (the JAX form): gather each window's sites up to
    the longest window, zero the padding, sum; window chunks keep the
    gather under 2^24 elements."""
    S, K = terms.shape
    W = first.shape[0]
    f, n = first.to(torch.int64), n_sites.to(torch.int64)
    out = torch.zeros((W, K), dtype=torch.float64, device=terms.device)
    has = n > 0
    if not bool(has.any()):
        return out
    if bool(((f < 0) | (f + n > S))[has].any()):
        raise ValueError(f"a window's range leaves the {S} sites")
    s_max = int(n.max())
    offs = torch.arange(s_max, device=terms.device)
    chunk = max(1, (1 << 24) // (s_max * K))
    for w0 in range(0, W, chunk):
        fw, nw = f[w0:w0 + chunk], n[w0:w0 + chunk]
        valid = offs[None, :] < nw[:, None]
        idx = torch.where(valid, fw[:, None] + offs[None, :], 0)
        t = torch.where(valid[:, :, None], terms[idx], 0.0)
        out[w0:w0 + chunk] = t.sum(dim=1)
    return out


# ------------------------------------------------------------ host route

def host_window_abba_sums(alleles: np.ndarray, first: np.ndarray,
                          n_sites: np.ndarray, membership: np.ndarray,
                          n_pops, min_data: float, mode: str,
                          full: bool) -> np.ndarray:
    """Host executor for the fused ABBA window reduction: same [W, K]
    float64 sums as the kernels, computed with C per-site pop counts +
    numpy float64 terms on gate-compacted sites — zero device transfers
    (the device wire is O(sites * haplotypes) and dominates on a degraded
    link; host cost is O(sites * pop_sizes) count increments).

    ``membership``: uint8 [H] bitmask (bits 0-3 = P1..P4, bit 4 = union).
    Formula expressions mirror :func:`_allele_terms` literally — float64
    elementwise ops are correctly rounded, so per-site terms are identical;
    only the per-window summation tree can differ by ulps (sequential numpy
    sums here, which for windows under numpy's 128-element pairwise block
    ARE np.sum's order)."""
    import os

    from ..io import native
    S = alleles.shape[1]
    W = first.shape[0]
    K = len(FULL_CHANNELS) if full else len(CLASSIC_CHANNELS)
    counts = None
    if os.environ.get("GGT_NO_NATIVE_PARSER") != "1":
        counts = native.site_pop_counts_host_native(alleles, membership)
    if counts is None:
        counts = np.zeros((S, 5, 4), np.int32)
        for p in range(5):
            sub = alleles[np.flatnonzero(membership & (1 << p))]
            for c in range(4):
                counts[:, p, c] = (sub == c).sum(axis=0)
    # gate on the integer counts; only gated sites convert to float64
    # (the full [S, 5, 4] f64 conversion was ~40 MB of traffic per flush)
    nonmiss_i = counts.sum(axis=2, dtype=np.int32)    # [S, 5]
    biallelic = (counts[:, 4, :] > 0).sum(axis=1) == 2
    enough = np.ones(S, dtype=bool)
    n_pops = np.asarray(n_pops, dtype=np.float64)
    for k in range(4):
        enough &= (nonmiss_i[:, k] / n_pops[k]) >= min_data
    good = biallelic & enough
    g = np.flatnonzero(good)
    # selection on [Sg, 4], then FLATTEN to the selected (site, allele)
    # pair list: every term below runs on 1-D [E] arrays (typically ~1
    # pair/site), which cuts the elementwise-temporary traffic ~4x vs
    # computing all 4 allele columns and masking — this stage is memory-
    # bandwidth-bound on the host
    terms = np.zeros((0, K - 2), np.float64)
    si = np.zeros(0, np.int64)
    if g.size:
        cg = counts[g].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            freqs = cg / nonmiss_i[g].astype(np.float64)[:, :, None]
        ucp = cg[:, 4, :] > 0
        P1, P2, P3, P4 = (freqs[:, k, :] for k in range(4))
        if mode == "polarize":
            sel = ucp & (P4 == 0)
        elif mode == "fixed":
            sel = (ucp & (P4 == 0)
                   & ((P1 == 0) | (P1 == 1))
                   & ((P2 == 0) | (P2 == 1))
                   & ((P3 == 0) | (P3 == 1)))
        else:                                         # minor allele
            mi = np.argsort(freqs[:, 4, :], axis=1)[:, 2]
            sel = np.zeros((g.size, 4), dtype=bool)
            sel[np.arange(g.size), mi] = True
        si, ai = np.nonzero(sel)                      # sorted by site
        p1 = P1[si, ai]
        p2 = P2[si, ai]
        p3 = P3[si, ai]
        p4 = P4[si, ai]
        with np.errstate(invalid="ignore"):
            q1, q2, q3, q4 = 1 - p1, 1 - p2, 1 - p3, 1 - p4
            abba = q1 * p2 * p3 * q4
            baba = p1 * q2 * p3 * q4
            num_f4 = abba - baba                      # == _f4(p1,p2,p3,p4)
            pd = p2 * (p2 > p3) + p3 * (p3 >= p2)
            den_fd = _f4(p1, pd, pd, p4)
            a = p3 > p1
            b = p3 > p2
            x = p1 > p2
            y = ~x
            pdm1 = p3 * (x & a) + p1 * (~(x & a))
            pdm2 = p3 * (y & b) + p2 * (~(y & b))
            pdm3 = -p3 * (x & a) + p3 * (y & b) - p1 * (x & ~a) \
                + p2 * (y & ~b)
            den_fdm = _f4(pdm1, pdm2, pdm3, p4)
            chans = [num_f4, abba + baba, den_fd, den_fdm, abba, baba]
            if full:
                num_f4c = _f4c(p1, p2, p3, p4)
                t11 = _f4c(p1, p3, p3, p4)
                t12 = _f4c(p4, p2, p3, p4)
                t21 = _f4c(p3, p2, p3, p4)
                t22 = _f4c(p1, p4, p3, p4)
                den_fdh = np.maximum(np.maximum(t11, t12),
                                     np.maximum(t21, t22))
                t31 = _f4c(p1, p2, p2, p4)
                t32 = _f4c(p1, p2, p3, p1)
                t41 = _f4c(p1, p2, p1, p4)
                t42 = _f4c(p1, p2, p3, p2)
                den_fdh2 = np.maximum(den_fdh,
                                      np.maximum(np.maximum(t31, t32),
                                                 np.maximum(t41, t42)))
                t1 = np.abs(p1 - p2)
                t2 = np.abs(p3 - p4)
                den_fh = (t1 * (t1 > t2) + t2 * (t2 >= t1)) ** 2
                abaa = q1 * p2 * q3 * q4
                baaa = p1 * q2 * q3 * q4
                den_fdm_new = _f4c(pdm1, pdm2, pdm3, p4)
                chans += [num_f4c, _f4(p1, p3, p3, p4),
                          _f4c(p1, p3, p3, p4), _f4c(p1, pd, pd, p4),
                          den_fdm_new, den_fdh, den_fdh2, den_fh,
                          abaa, baaa]
            terms = np.stack(chans, axis=1)           # [E, K-2]

    out = np.zeros((W, K), np.float64)
    last = first + n_sites
    e0 = np.searchsorted(g, first)                    # gated sites / window
    e1 = np.searchsorted(g, last)
    pair_site = g[si]                                 # [E] global site index
    ee0 = np.searchsorted(pair_site, first)
    ee1 = np.searchsorted(pair_site, last)
    out[:, 0] = e1 - e0                               # "good"
    out[:, 1] = ee1 - ee0                             # "used"
    for w in range(W):
        if ee1[w] > ee0[w]:
            out[w, 2:] = terms[ee0[w]:ee1[w]].sum(axis=0)
    return out


def _host_sums(alleles, first, n_sites, pop_mask, n_pops, min_data, mode,
               full):
    """The host executor's sums of one flush, counted in HOST_FLUSHES."""
    global HOST_FLUSHES
    HOST_FLUSHES += 1
    return host_window_abba_sums(alleles, first, n_sites,
                                 counts_k.membership_bits(pop_mask), n_pops,
                                 min_data, mode, full)


# ------------------------------------------------------------ dispatch

class AbbaSumsHandle:
    """In-flight [W, K] window sums of one flush; ``collect()`` waits for
    the fetch and returns them as numpy float64."""

    def __init__(self, W: int, channels: tuple, pending=None):
        self.W, self.channels, self._pending = W, channels, pending

    def collect(self) -> np.ndarray:
        if self._pending is None:
            return np.zeros((self.W, len(self.channels)))
        host = self._pending.wait()
        self._pending = None
        return host


def flush_abba(buf: torch.Tensor, sp: int, h: int, S: int, w0: int,
               w1: int, wp: int, classes: counts_k.MaskClasses, n_pops,
               min_data: float, mode: str, full: bool) -> torch.Tensor:
    """One flush on the device: K6 class counts of sites 0 .. S - 1 of
    the flush buffer, K7 site terms, K8 sums of its windows w0 .. w1 - 1:
    [w1 - w0, K]."""
    span, first, n_sites = transfer.flush_views(buf, sp, h, wp)
    cc = counts_k.count_span(span, sp, h, S, classes.groups)
    terms = abba_site_terms(cc, classes.codes, n_pops, min_data, mode, full)
    return abba_window_sums(terms, first[w0:w1], n_sites[w0:w1])


def window_abba_sums_dispatch(alleles: np.ndarray, first: np.ndarray,
                              n_sites: np.ndarray, pop_mask: np.ndarray,
                              n_pops, min_data: float, mode: str,
                              full: bool, mesh=None) -> AbbaSumsHandle:
    """Dispatch the fused ABBA window reduction of one flush (host int8
    [H, S] span) without fetching: one upload of the flush buffer to each
    device and one fetch of each device's [w, K] float64 window sums.
    ``pop_mask``: 0/1 [5, H] rows P1, P2, P3, O and their union (rows
    overlap); ``n_pops``: the four populations' haplotype counts.  The
    window batch is padded to ``n_dev * 2^k`` and cut into one contiguous
    slab per device of the ``mesh`` (default: the one device
    ``get_device()``; the JAX ``_sharded_fused_abba_flush``): the flush
    buffer is replicated, every device counts and terms all the flush's
    sites (K6, K7) and sums its slab's windows (K8), and the slabs come
    back in window order.  Only without a mesh may ``GGT_EXEC=host``
    send the flush to the host executor."""
    channels = channels_of(full)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    W = first.shape[0]
    H, S = alleles.shape
    if W == 0 or H == 0:
        return AbbaSumsHandle(W, channels)
    if ((n_sites > 0) & ((first < 0) | (first + n_sites > S))).any():
        raise ValueError(f"a window's range leaves the span of {S} sites")
    if mesh is None:
        if _exec_choice() == "host":
            return _ReadyHandle(lambda: _host_sums(
                alleles, first, n_sites, pop_mask, n_pops, min_data, mode,
                full))
        from ..parallel.mesh import Mesh
        mesh = Mesh([get_device()])
    wp = transfer.mesh_batch(W, mesh.size)
    buf, Sp = transfer.pack_flush_buffer(alleles, first, n_sites, wp)
    bufs = transfer.replicate(buf, mesh)
    parts = []
    for d, b, (lo, hi) in zip(mesh.devices, bufs.shards,
                              transfer.slabs(wp, mesh.size, W)):
        if hi == lo:
            continue
        classes = counts_k._mask_classes(pop_mask, d)
        parts.append(transfer.fetch_on(d, lambda: flush_abba(
            b, Sp, H, S, lo, hi, wp, classes, n_pops, min_data, mode,
            full)))
    return AbbaSumsHandle(W, channels, transfer.Gathered(parts))


def finalize_window_stats(sums: np.ndarray, channels: tuple,
                          full: bool) -> list[dict]:
    """Reference window stats from the fetched sums (float64 divisions are
    exact, so ratios equal the reference's ratio-of-sums).  Returns one dict
    per window, matching stats/abbababa.py window_four_pop_panel keys."""
    from ..stats.abbababa import ABBABABA_STATS, FOURPOP_STATS
    idx = {c: k for k, c in enumerate(channels)}
    out = []
    stats_names = FOURPOP_STATS if full else ABBABABA_STATS
    with np.errstate(invalid="ignore", divide="ignore"):
        for w in range(sums.shape[0]):
            s = sums[w]
            if s[idx["good"]] < 0.5:       # no gated sites: reference NaN row
                out.append(dict(zip(stats_names,
                                    [np.nan] * (len(stats_names) - 1) + [0])))
                continue
            used = int(round(s[idx["used"]]))
            num = s[idx["num_f4"]]
            vals = {
                "D": num * 1.0 / s[idx["den_D"]],
                "fd": num * 1.0 / s[idx["den_fd"]],
                "fdM": num * 1.0 / s[idx["den_fdm"]],
                "fdm": num * 1.0 / s[idx["den_fdm"]],
                "ABBA": s[idx["ABBA"]],
                "BABA": s[idx["BABA"]],
                "sitesUsed": used,
            }
            if full:
                numc = s[idx["num_f4c"]]
                vals.update({
                    "fhom": num * 1.0 / s[idx["den_fhom_old"]],
                    "fhom'": numc * 1.0 / s[idx["den_fhom_new"]],
                    "fd'": numc * 1.0 / s[idx["den_fd_new"]],
                    "fdm'": numc * 1.0 / s[idx["den_fdm_new"]],
                    "fdh": numc * 1.0 / s[idx["den_fdh"]],
                    "fdh2": numc * 1.0 / s[idx["den_fdh2"]],
                    "fh": numc * 1.0 / s[idx["den_fh"]],
                    "ABAA": s[idx["ABAA"]],
                    "BAAA": s[idx["BAAA"]],
                })
            out.append({k: vals[k] for k in stats_names})
    return out
