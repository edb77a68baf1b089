"""Host packers of the kernels' wires, and their typed views.

The 2-bit span wire of the per-site count kernel (``pack_alleles`` /
``pack_span``, copies of the JAX package's) is one uint8 buffer
``[codes H x Sp/4 | miss H x Sp/8]``; the CUDA kernel reads it in place
and :func:`unpack_span` is its plain inverse.  The ABBA flush buffer
(``pack_flush_buffer``, also a copy) appends the window metadata
``first, n_sites int32[wp]``; :func:`flush_views` cuts it into typed views
in place and :func:`unpack_flush_buffer` is its plain inverse.  The general
4-state pair counts and the raw per-site counts read the int8 matrix
itself: :func:`device_alleles`, :func:`pack_raw_span` and
:func:`upload_span` upload the raw bytes.

Wire format v2 of the pairwise kernels (``GGT_WIRE=2``, :func:`pack_pair_wire`,
a copy of the JAX packer) ships the called and alt bit planes of every site
with the window ranges and the exception section; :func:`pair_wire_v2_views`
cuts it into typed views in place and :func:`unpack_pair_wire` is the plain
counterpart of the JAX device unpack.  Wire format v3 follows.

The host side is a copy of the JAX package's packer
(genomics_general_tpu/kernels/transfer.py: ``pack_pair_wire_v3`` with its
classifier, exception section and site buckets), so both packages produce
byte-identical buffers from the same alleles.  One uint8 buffer per flush:

    [calledB H x SpB/8 | altC H x SpC/8 | calledD H x SpD/8 |
     altD H x SpD/8 |
     firstB,nB,firstC,nC,firstD,nD,nconst int32[7*wp] |
     ex_w int32[ep] | ex_codes int8[ep, H]]

Bit ``k`` of plane byte ``b`` is site ``8b + k`` (``bitorder="little"``),
so a plane row read as little-endian 32-bit words holds site ``32q + t`` in
bit ``t`` of word ``q``.  Every Sp is a multiple of 2048 sites
(``_bucket_sites`` with ``min_bucket`` 8192), so every row and section
starts 4-byte aligned and the CUDA kernels read the planes as words in
place — there is no device-side unpack on the kernel path
(:func:`from_jax_wire` only makes typed views).  :func:`unpack_pair_wire_v3`
is the plain PyTorch counterpart of the JAX device unpack, used by the
kernels' plain versions.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..engine import NO_TIMER


def _bucket_sites(S: int, min_bucket: int = 1 << 16) -> int:
    """Round S up to a small closed set of site-axis lengths so jitted
    consumers do not recompile per flush: powers of two up to ``min_bucket``,
    then 8 steps per octave (pad-upload waste <= 12.5% — pad bytes ride the
    slow wire too — while compile count stays bounded at 8 per size octave,
    amortized by the persistent compilation cache)."""
    b = min_bucket
    while b < S:
        b <<= 1
    if b <= min_bucket:
        return b
    step = b >> 3
    return -(-S // step) * step


# ------------------------------------------------ the 2-bit span wire

def pack_alleles(alleles: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack int8 [H, S] (values -1..3) into (codes, miss, S) planes."""
    H, S = alleles.shape
    # contract: only {-1, 0..3} survive the 2-bit pack; anything else (e.g. a
    # stray parser poison value) would silently alias to a valid allele
    assert alleles.min(initial=0) >= -1 and alleles.max(initial=-1) <= 3, \
        "pack_alleles requires codes in {-1, 0..3}"
    s4 = -(-S // 4) * 4
    codes = np.ascontiguousarray(alleles).view(np.uint8) & 3
    if s4 != S:
        codes = np.concatenate(
            [codes, np.zeros((H, s4 - S), np.uint8)], axis=1)
    c = codes.reshape(H, s4 // 4, 4)
    packed_codes = (c[:, :, 0] | (c[:, :, 1] << 2) |
                    (c[:, :, 2] << 4) | (c[:, :, 3] << 6))
    miss = np.packbits(alleles < 0, axis=1, bitorder="little")
    return np.ascontiguousarray(packed_codes), miss, S


def pack_span(alleles: np.ndarray, min_bucket: int = 1 << 16) -> tuple[np.ndarray, int]:
    """Pack a host int8 [H, S] span into ONE flat uint8 wire buffer
    ``[codes H x Sp/4 | miss H x Sp/8]`` with the site axis padded to a
    power-of-two bucket Sp (pad sites = missing): one upload per flush.
    The same bytes as the JAX package's ``pack_span``.  Returns
    (buffer, Sp).
    """
    H, S = alleles.shape
    Sp = _bucket_sites(max(S, 1), min_bucket)
    codes, miss, _ = pack_alleles(alleles)
    c4, m8 = Sp // 4, Sp // 8
    buf = np.empty(H * (c4 + m8), dtype=np.uint8)
    cview = buf[:H * c4].reshape(H, c4)
    mview = buf[H * c4:].reshape(H, m8)
    cview[:, :codes.shape[1]] = codes
    cview[:, codes.shape[1]:] = 0
    mview[:, :miss.shape[1]] = miss
    mview[:, miss.shape[1]:] = 0xFF          # pad sites are missing
    # real sites S..8*ceil(S/8) inside the last miss byte: mark missing too
    rem = S % 8
    if rem and m8 > S // 8:
        mview[:, S // 8] |= (0xFF << rem) & 0xFF
    return buf, Sp


def packed_enabled() -> bool:
    """False under ``GGT_PACKED_TRANSFER=0``: the JAX package's raw int8
    upload instead of a packed wire (the pair counts run K9 on it, the
    per-site counts K12)."""
    return os.environ.get("GGT_PACKED_TRANSFER", "1") != "0"


# ------------------------------------------------ the raw int8 upload

def device_alleles(alleles: np.ndarray, dev=None) -> torch.Tensor:
    """Upload an int8 [H, S] allele matrix to ``dev`` (default
    ``get_device()``) and return the int8 tensor.

    The JAX package's ``device_alleles`` ships 2-bit codes plus a missing
    plane and unpacks them on the device, a packing made for its TPU
    host's slow link.  The port uploads the raw bytes, which the general
    4-state counts (K9) read as they are: staged in pinned memory and
    copied with ``non_blocking``."""
    from ..device import get_device
    dev = get_device() if dev is None else dev
    return to_device(np.ascontiguousarray(alleles, dtype=np.int8), dev)


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array (any dtype) as a tensor on ``dev``: staged in pinned
    memory and copied with ``non_blocking`` to a card, copied for the
    CPU."""
    x = np.ascontiguousarray(x)
    if dev.type != "cuda":
        return torch.from_numpy(x.copy())
    return torch.from_numpy(x).pin_memory().to(dev, non_blocking=True)


def upload_span(alleles: np.ndarray, dev=None,
                min_bucket: int = 1 << 16, mesh=None):
    """The raw route of the JAX ``upload_span`` (``GGT_PACKED_TRANSFER=0``):
    the int8 [H, S] span padded on the site axis to the site bucket with -1
    (missing), uploaded to ``dev`` (default ``get_device()``).  Returns the
    int8 [H, Sp] tensor; callers count its ``[:, :S]`` view.  With a
    ``mesh`` the span is replicated over it (:func:`replicate`) and a
    :class:`Replicated` comes back."""
    H, S = alleles.shape
    Sp = _bucket_sites(max(S, 1), min_bucket)
    padded = np.full((H, Sp), -1, dtype=np.int8)
    padded[:, :S] = alleles
    if mesh is not None:
        return replicate(padded, mesh)
    return device_alleles(padded, dev)


# ------------------------------------------------ placement over a mesh

class Replicated:
    """One array placed on every device of a mesh (the JAX replicated
    ``NamedSharding(mesh, P())``): ``shards[d]`` is the tensor on
    ``mesh.devices[d]``; mesh entries that name the same device share one
    tensor.  Indexing indexes every shard."""

    def __init__(self, shards):
        self.shards = tuple(shards)

    @property
    def shape(self):
        return self.shards[0].shape

    def __getitem__(self, idx) -> "Replicated":
        return Replicated(t[idx] for t in self.shards)


def replicate(x, mesh) -> Replicated:
    """``x`` on every device of ``mesh``, copied once per distinct device:
    a host array (of any dtype) by :func:`to_device`, a tensor by a copy
    where it does not lie already.  A :class:`Replicated` is returned as
    it is."""
    if isinstance(x, Replicated):
        return x
    placed = {}
    for d in mesh.devices:
        if d not in placed:
            placed[d] = to_device(x, d) if isinstance(x, np.ndarray) \
                else x.to(d, non_blocking=True)
    return Replicated(placed[d] for d in mesh.devices)


def mesh_batch(n: int, n_dev: int) -> int:
    """The padded length of a window batch over ``n_dev`` devices: the
    least ``n_dev * 2^k`` of at least ``max(n, 8)`` (the JAX dispatches'
    padding), so every device holds an equal slab."""
    b = n_dev
    while b < max(n, 8):
        b *= 2
    return b


def slabs(padded: int, n_dev: int, n: int) -> list[tuple[int, int]]:
    """Each device's contiguous slab ``(lo, hi)`` of an axis of ``n``
    entries padded to ``padded`` (a multiple of ``n_dev``), in device
    order, as JAX's ``P("data")`` places it; ``hi`` is cut at ``n``, so a
    slab of padding alone comes back empty (pad entries are never
    computed: their results would be dropped)."""
    q = padded // n_dev
    return [(min(d * q, n), min((d + 1) * q, n)) for d in range(n_dev)]


def sharded_axis(n: int, n_dev: int) -> list[tuple[int, int]]:
    """:func:`slabs` of an axis padded to a multiple of ``n_dev`` (the
    site axis, the haplotype rows)."""
    return slabs(-(-n // n_dev) * n_dev, n_dev, n)


def _raw_layout(h: int, s: int, w: int) -> tuple[int, int]:
    """(row stride ld, size in bytes) of a :func:`pack_raw_span` buffer of
    h rows, s sites and w windows.  ld is s rounded up to 16 bytes, so
    every row starts 16-byte aligned and K9 copies it in whole chunks; the
    buffer ends with ld - s bytes after the windows, so that for h >= 1
    every s has a size of its own and :func:`raw_span_views` tells the
    width from the size alone, without reading the buffer."""
    ld = -(-max(s, 1) // 16) * 16
    return ld, h * ld + 8 * w + ld - s


def pack_raw_span(alleles: np.ndarray, first: np.ndarray,
                  n_sites: np.ndarray) -> np.ndarray:
    """One uint8 buffer for a raw flush upload (``GGT_PACKED_TRANSFER=0``):
    ``[int8 alleles H x ld | first int32[W] | n_sites int32[W] | ld - S
    bytes]``, each row's S sites then -1 up to the stride ld
    (:func:`_raw_layout`): the matrix K9 reads and its windows."""
    H, S = alleles.shape
    W = first.shape[0]
    ld, size = _raw_layout(H, S, W)
    buf = np.full(size, 0xFF, dtype=np.uint8)
    buf[:H * ld].reshape(H, ld)[:, :S] = np.asarray(alleles).view(np.uint8)
    meta = buf[H * ld:H * ld + 8 * W].view(np.int32)
    meta[:W] = first
    meta[W:] = n_sites
    return buf


def raw_span_views(buf: torch.Tensor, h: int, s: int, w: int):
    """Views of a :func:`pack_raw_span` buffer (a uint8 tensor on any
    device): (alleles int8 [h, s] at the row stride, first int32 [w],
    n_sites int32 [w])."""
    ld, size = _raw_layout(h, s, w)
    base = h * ld
    if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.numel() != size:
        raise ValueError(f"not a raw span buffer of h={h}, s={s}, w={w}")
    meta = buf[base:base + 8 * w].view(torch.int32)
    return (buf[:base].view(torch.int8).view(h, ld)[:, :s], meta[:w],
            meta[w:])


class Pending:
    """A flush result on its way to the host: the tensor (pinned, with the
    event recorded after its copy, on CUDA; the result itself on the CPU)
    and the buffers to keep alive until the copy is done."""

    def __init__(self, result: torch.Tensor, event=None, keep=()):
        self._result, self._event, self._keep = result, event, keep

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        host = self._result.numpy()
        self._result, self._event, self._keep = None, None, ()
        return host


class Gathered:
    """The shards of one result on their way to the host: ``wait()``
    joins their arrays in shard order (window or site order) with
    ``join``, by default along axis 0, and hands a single shard's array
    on as it is.  ``n_parts``: the shards it joins."""

    def __init__(self, parts, join=np.concatenate):
        self._parts = list(parts)
        self._join = join
        self.n_parts = len(self._parts)

    def wait(self) -> np.ndarray:
        parts = [p.wait() for p in self._parts]
        host = parts[0] if len(parts) == 1 else self._join(parts)
        self._parts = []
        return host


def fetch(out: torch.Tensor, keep=()) -> Pending:
    """Start bringing a result tensor back: on CUDA an asynchronous copy
    into pinned memory on the tensor's device's current stream, with an
    event recorded after it there (``keep`` stays alive until then); on
    the CPU the result itself."""
    if out.device.type != "cuda":
        return Pending(out)
    with torch.cuda.device(out.device):
        result = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        result.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return Pending(result, event, keep=keep)


def fetch_on(dev: torch.device, run, keep=()) -> Pending:
    """Call ``run()``, which launches kernels on ``dev`` and returns their
    result tensor, with ``dev`` the current device, then :func:`fetch`
    that result: one shard's work on a mesh."""
    from ..device import device_scope
    with device_scope(dev):
        return fetch(run(), keep=keep)


def _pinned(buf: np.ndarray) -> torch.Tensor:
    """A copy of the uint8 ``buf`` in pinned host memory."""
    staged = torch.empty(buf.size, dtype=torch.uint8, pin_memory=True)
    staged.numpy()[:] = buf
    return staged


def upload(buf: np.ndarray, dev: torch.device, timer=None):
    """Start the upload of one uint8 wire buffer to ``dev`` without
    launching anything: (the uint8 tensor on ``dev``, what to keep alive
    until its copy is done).  On CUDA the buffer is staged in pinned
    memory (``dispatch.stage``) and copied with ``non_blocking`` on
    ``dev``'s current stream, where :func:`fetch_on` later launches on
    it; on the CPU the tensor is the host buffer itself."""
    if dev.type != "cuda":
        return torch.from_numpy(buf), ()
    from ..device import device_scope
    with (timer or NO_TIMER).span("dispatch.stage"):
        staged = _pinned(buf)
    with device_scope(dev):
        return staged.to(dev, non_blocking=True), (staged,)


def unpack_span(buf, sp: int, h: int) -> torch.Tensor:
    """Plain PyTorch inverse of :func:`pack_span` (the JAX ``unpack_span``
    with its ``_unpack``): int8 [h, sp], -1 where the miss bit is set.
    ``buf`` is the uint8 numpy buffer or a uint8 tensor on any device."""
    if isinstance(buf, np.ndarray):
        buf = torch.from_numpy(buf)
    c4, m8 = sp // 4, sp // 8
    codes = buf[:h * c4].reshape(h, c4)
    miss = buf[h * c4:h * (c4 + m8)].reshape(h, m8)
    shifts2 = torch.arange(0, 8, 2, dtype=torch.uint8, device=buf.device)
    c = ((codes[:, :, None] >> shifts2) & 3).reshape(h, -1)[:, :sp]
    shifts1 = torch.arange(8, dtype=torch.uint8, device=buf.device)
    m = ((miss[:, :, None] >> shifts1) & 1).reshape(h, -1)[:, :sp]
    return torch.where(m == 1, torch.full((), -1, dtype=torch.int8,
                                          device=buf.device), c.to(torch.int8))


def pack_flush_buffer(alleles: np.ndarray, first: np.ndarray,
                      n_sites: np.ndarray, wp: int,
                      min_bucket: int = 1 << 16):
    """One wire buffer for a whole flush: packed allele planes + window
    metadata ``[planes | first int32[wp] | n_sites int32[wp]]``.
    Returns (buffer uint8 [.], Sp)."""
    span_buf, Sp = pack_span(alleles, min_bucket)
    W = first.shape[0]
    meta = np.zeros(2 * wp, np.int32)
    meta[:W] = first
    meta[wp:wp + W] = n_sites
    return np.concatenate([span_buf, meta.view(np.uint8)]), Sp


def flush_views(buf: torch.Tensor, sp: int, h: int, wp: int):
    """Views of a :func:`pack_flush_buffer` buffer (a uint8 tensor on any
    device): (span wire uint8, first int32 [wp], n_sites int32 [wp]).
    With the default bucket (Sp a multiple of 2^16) the metadata starts
    4-byte aligned and is read in place; a smaller bucket may leave it
    unaligned, and then the metadata is copied."""
    base = h * (sp // 4 + sp // 8)
    if buf.dtype != torch.uint8 or buf.dim() != 1 or \
            buf.numel() != base + 8 * wp:
        raise ValueError(f"not a flush buffer of h={h}, sp={sp}, wp={wp}")
    meta = buf[base:]
    meta = (meta if base % 4 == 0 else meta.clone()).view(torch.int32)
    return buf[:base], meta[:wp], meta[wp:]


def unpack_flush_buffer(buf, sp: int, h: int, wp: int):
    """Plain PyTorch inverse of :func:`pack_flush_buffer` (the JAX
    ``unpack_flush_buffer``): (alleles int8 [h, sp], first int32 [wp],
    n_sites int32 [wp])."""
    if isinstance(buf, np.ndarray):
        buf = torch.from_numpy(buf)
    span, first, n_sites = flush_views(buf, sp, h, wp)
    return unpack_span(span, sp, h), first, n_sites


# -------------------------------------------------------- wire v2

def pack_pair_wire(alleles: np.ndarray, first: np.ndarray,
                   n_sites: np.ndarray, wp: int, ep_min: int = 4096,
                   min_bucket: int = 1 << 16):
    """Wire format v2 for the pairwise kernel: ONE uint8 flush buffer

        [called bits H x Sp/8 | alt bits H x Sp/8 |
         first int32[wp] | n_sites int32[wp] |
         ex_w int32[ep] | ex_codes int8[ep, H]]

    ``called``/``alt`` are 1-bit planes (2 bits/site/haplotype vs the 3 of
    :func:`pack_span`) valid for sites with <= 2 distinct called alleles;
    multi-allelic *exception* sites are cleared from the planes and shipped
    as explicit (window, codes) patch entries — one per (window, site) pair
    for overlapping windows.  Returns (buffer, Sp, ep); ep == 0 when the
    flush has no exceptions (pad entries carry ex_w == wp and are dropped by
    the kernel's one-hot scatter).
    """
    H, S = alleles.shape
    Sp = _bucket_sites(max(S, 1), min_bucket)
    sp8 = Sp // 8
    W = first.shape[0]
    planes = np.empty(2 * H * sp8, dtype=np.uint8)
    called_out = planes[:H * sp8].reshape(H, sp8)
    alt_out = planes[H * sp8:].reshape(H, sp8)

    res = None
    if os.environ.get("GGT_NO_NATIVE_PARSER") != "1":
        from ..io import native
        res = native.pack_pair_planes_native(alleles, called_out, alt_out, sp8)
    if res is None:
        res = _pack_pair_planes_numpy(alleles, called_out, alt_out, sp8)
    refalt, ex_idx = res

    meta = np.zeros(2 * wp, np.int32)
    meta[:W] = first
    meta[wp:wp + W] = n_sites

    ep, ex_buf = _exception_buf(alleles, ex_idx, first, n_sites, wp, ep_min)
    buf = np.concatenate([planes, meta.view(np.uint8), ex_buf])
    return buf, Sp, ep


class PairWireV2(NamedTuple):
    """Typed views of one wire-v2 buffer (all share its storage):
    ``called`` and ``alt`` the bit planes as int32 words [h, Sp/32];
    ``first`` and ``n_sites`` int32 [wp]; ``ex_w`` int32 [ep] (``== wp``
    for padding entries) and ``ex_codes`` int8 [ep, h] the exception
    section, laid out as wire v3's."""
    buf: torch.Tensor
    called: torch.Tensor
    alt: torch.Tensor
    first: torch.Tensor
    n_sites: torch.Tensor
    ex_w: torch.Tensor
    ex_codes: torch.Tensor
    h: int
    wp: int


def pair_wire_v2_views(buf, sp: int, h: int, wp: int, ep: int) -> PairWireV2:
    """Typed views of a :func:`pack_pair_wire` buffer (the uint8 numpy
    array, or a uint8 tensor holding it on any device), with the static
    sizes the packer returned.  Sp is a multiple of 32, so each plane row
    is read as words in place.  No data is copied."""
    if isinstance(buf, np.ndarray):
        buf = torch.from_numpy(buf)
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("wire buffer must be a flat uint8 array")
    if sp % 32:
        raise ValueError(f"plane width {sp} is not a multiple of 32")
    p8 = sp // 8
    base = 2 * h * p8
    size = base + 8 * wp + 4 * ep + ep * h
    if buf.numel() != size:
        raise ValueError(f"wire buffer holds {buf.numel()} bytes, "
                         f"expected {size}")
    called = buf[:h * p8].view(torch.int32).view(h, p8 // 4)
    alt = buf[h * p8:base].view(torch.int32).view(h, p8 // 4)
    meta = buf[base:base + 8 * wp].view(torch.int32)
    ex0 = base + 8 * wp
    ex_w = buf[ex0:ex0 + 4 * ep].view(torch.int32)
    ex_codes = buf[ex0 + 4 * ep:size].view(torch.int8).view(ep, h)
    return PairWireV2(buf, called, alt, meta[:wp], meta[wp:], ex_w, ex_codes,
                      h, wp)


def unpack_pair_wire(wire: PairWireV2):
    """Plain PyTorch inverse of :func:`pack_pair_wire` (the JAX
    ``transfer.unpack_pair_wire`` contract): (code2 int8 [h, sp] with bit 0
    = called and bit 1 = alt, first int32 [wp], n_sites int32 [wp], ex_w
    int32 [ep], ex_codes int8 [ep, h])."""
    code2 = _bits(wire.called) | (_bits(wire.alt) << 1)
    return code2, wire.first, wire.n_sites, wire.ex_w, wire.ex_codes


# -------------------------------------------------------- wire v3

_POPCOUNT = np.array([bin(i).count("1") for i in range(16)], dtype=np.uint8)
_LOWBIT = np.array([0, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0],
                   dtype=np.uint8)          # index of lowest set bit (0 for 0)
_HIGHBIT = np.array([0, 0, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3],
                    dtype=np.uint8)         # index of highest set bit


def _pack_pair_planes_numpy(alleles: np.ndarray, called_out: np.ndarray,
                            alt_out: np.ndarray, sp8: int):
    """Numpy fallback for the C ``pack_pair_planes`` (same contract)."""
    H, S = alleles.shape
    seen = np.zeros(S, dtype=np.uint8)
    for c in range(4):
        seen |= (alleles == c).any(axis=0).astype(np.uint8) << c
    is_ex = _POPCOUNT[seen] > 2
    ex_idx = np.flatnonzero(is_ex).astype(np.int32)
    refalt = (_LOWBIT[seen] | (_HIGHBIT[seen] << 2)).astype(np.uint8)
    refalt[is_ex] = 0
    called = (alleles >= 0) & ~is_ex[None, :]
    altbit = called & (alleles == (refalt >> 2)[None, :])
    cb = np.packbits(called, axis=1, bitorder="little")
    ab = np.packbits(altbit, axis=1, bitorder="little")
    called_out[:, :cb.shape[1]] = cb
    called_out[:, cb.shape[1]:] = 0
    alt_out[:, :ab.shape[1]] = ab
    alt_out[:, ab.shape[1]:] = 0
    return refalt, ex_idx



def map_exception_windows(ex_idx: np.ndarray, first: np.ndarray,
                          n_sites: np.ndarray):
    """Map exception site indices to the windows containing them (possibly
    several for overlapping windows).  Returns (pairs_w int32, pairs_s)."""
    W = first.shape[0]
    if not (ex_idx.size and W):
        return np.empty(0, np.int32), np.empty(0, np.int64)
    last = first + n_sites
    if np.all(np.diff(first) >= 0) and np.all(np.diff(last) >= 0):
        lo = np.searchsorted(last, ex_idx, side="right")
        hi = np.searchsorted(first, ex_idx, side="right")
        reps = np.maximum(hi - lo, 0)
        pairs_s = np.repeat(ex_idx, reps)
        pairs_w = np.concatenate(
            [np.arange(l, h, dtype=np.int32)
             for l, h in zip(lo, hi) if h > l]) \
            if reps.sum() else np.empty(0, np.int32)
    else:  # unsorted plans (rare): exact O(E*W) containment
        inw = (ex_idx[:, None] >= first[None, :]) \
            & (ex_idx[:, None] < last[None, :])
        e_i, w_i = np.nonzero(inw)
        pairs_s = ex_idx[e_i]
        pairs_w = w_i.astype(np.int32)
    return pairs_w, pairs_s


def _exception_buf(alleles: np.ndarray, ex_idx: np.ndarray,
                   first: np.ndarray, n_sites: np.ndarray, wp: int,
                   ep_min: int) -> tuple[int, np.ndarray]:
    """Build the exception-patch wire section: map exception sites to the
    windows containing them (possibly several for overlapping windows;
    entries get the window's *batch* index) and pack
    ``[ex_w int32[ep] | ex_codes int8[ep, H]]``.  Returns (ep, buffer);
    ep == 0 -> empty buffer."""
    H = alleles.shape[0]
    W = first.shape[0]
    pairs_w, pairs_s = map_exception_windows(ex_idx, first, n_sites)
    E = pairs_w.size
    if E == 0:
        return 0, np.empty(0, dtype=np.uint8)
    ep = ep_min
    while ep < E:
        ep <<= 1
    ex_w = np.full(ep, wp, dtype=np.int32)      # pad -> out of range
    ex_w[:E] = pairs_w
    ex_codes = np.full((ep, H), -1, dtype=np.int8)
    ex_codes[:E] = alleles[:, pairs_s].T
    return ep, np.concatenate([ex_w.view(np.uint8),
                               ex_codes.reshape(-1).view(np.uint8)])



def _classify_pair_sites_numpy(alleles: np.ndarray):
    """Numpy fallback for the C ``classify_pair_sites`` (same contract)."""
    H, S = alleles.shape
    seen = np.zeros(S, dtype=np.uint8)
    for c in range(4):
        seen |= (alleles == c).any(axis=0).astype(np.uint8) << c
    pc = _POPCOUNT[seen]
    anymiss = (alleles < 0).any(axis=0)
    cls = np.where(pc > 2, 5,
                   np.where(pc == 0, 0,
                            np.where(pc == 1, np.where(anymiss, 2, 1),
                                     np.where(anymiss, 4, 3)))).astype(np.uint8)
    refalt = (_LOWBIT[seen] | (_HIGHBIT[seen] << 2)).astype(np.uint8)
    refalt[pc > 2] = 0
    ex_idx = np.flatnonzero(pc > 2).astype(np.int32)
    nA = int((cls == 1).sum())
    nB = int((cls == 2).sum())
    nC = int((cls == 3).sum())
    nD = int((cls == 4).sum())
    counts = np.array([nA, nB, nC, nD, nA + nC], dtype=np.int64)
    return cls, refalt, ex_idx, counts


def pack_pair_wire_v3(alleles: np.ndarray, first: np.ndarray,
                      n_sites: np.ndarray, wp: int, ep_min: int = 4096,
                      min_bucket: int = 1 << 13):
    """Wire format v3 for the pairwise kernel: class-partitioned planes.

    Most sites carry no pairwise information worth shipping: a monomorphic
    fully-called site adds 1 to every pair's shared count (a per-window
    COUNT suffices); a monomorphic site with missing calls only needs the
    1-bit called plane; a clean biallelic site only needs the 1-bit alt
    plane (called is implied all-ones); only biallelic sites with missing
    calls need both planes.  On real cohorts (overwhelmingly monomorphic)
    this cuts upload bytes ~10x vs :func:`pack_pair_wire`; the resulting
    mismatch/shared integers are IDENTICAL, so downstream output is
    byte-identical.  ONE uint8 flush buffer:

        [calledB H x SpB/8 | altC H x SpC/8 | calledD H x SpD/8 |
         altD H x SpD/8 |
         firstB,nB,firstC,nC,firstD,nD,nconst int32[7*wp] |
         ex_w int32[ep] | ex_codes int8[ep, H]]

    where nconst[w] = number of constant-shared sites (clean mono + clean
    biallelic) in window w.  Compaction preserves site order, so each
    window's class-k sites form a contiguous range [firstk, firstk + nk).
    Returns (buffer, SpB, SpC, SpD, ep, (nBmax, nCmax, nDmax))."""
    H, S = alleles.shape
    W = first.shape[0]
    res = None
    if os.environ.get("GGT_NO_NATIVE_PARSER") != "1":
        from ..io import native
        res = native.classify_pair_sites_native(alleles)
    if res is None:
        res = _classify_pair_sites_numpy(alleles)
    cls, refalt, ex_idx, counts = res
    nB, nC, nD = int(counts[1]), int(counts[2]), int(counts[3])
    SpB = _bucket_sites(max(nB, 1), min_bucket)
    SpC = _bucket_sites(max(nC, 1), min_bucket)
    SpD = _bucket_sites(max(nD, 1), min_bucket)
    b8, c8, d8 = SpB // 8, SpC // 8, SpD // 8
    planes = np.empty(H * (b8 + c8 + 2 * d8), dtype=np.uint8)
    calledB = planes[:H * b8].reshape(H, b8)
    altC = planes[H * b8:H * (b8 + c8)].reshape(H, c8)
    calledD = planes[H * (b8 + c8):H * (b8 + c8 + d8)].reshape(H, d8)
    altD = planes[H * (b8 + c8 + d8):].reshape(H, d8)

    from ..io import native as _native
    if os.environ.get("GGT_NO_NATIVE_PARSER") == "1" or \
            not _native.emit_class_planes_native(
                alleles, cls, refalt, calledB, b8, altC, c8,
                calledD, altD, d8):
        # numpy fallback: fancy-select per class then packbits
        al = np.ascontiguousarray(alleles)
        for sel_cls, outs in ((2, (calledB,)), (3, (altC,)),
                              (4, (calledD, altD))):
            idx = np.flatnonzero(cls == sel_cls)
            sub = al[:, idx]
            if sel_cls == 2:
                bits = [(sub >= 0)]
            elif sel_cls == 3:
                bits = [sub == (refalt[idx] >> 2)[None, :]]
            else:
                called = sub >= 0
                bits = [called,
                        called & (sub == (refalt[idx] >> 2)[None, :])]
            for o, b in zip(outs, bits):
                pb = np.packbits(b, axis=1, bitorder="little")
                o[:, :pb.shape[1]] = pb
                o[:, pb.shape[1]:] = 0

    # per-window class ranges via exclusive prefix sums over the class
    # vector (compaction preserves order -> contiguous ranges)
    last = first + n_sites
    meta = np.zeros(7 * wp, np.int32)
    nmax = []
    cums = None
    if os.environ.get("GGT_NO_NATIVE_PARSER") != "1":
        cums = _native.class_prefix_sums_native(cls)
    if cums is None:
        cums = np.empty((4, S + 1), dtype=np.int64)
        cums[:, 0] = 0
        for k, code in enumerate((2, 3, 4)):
            cums[k, 1:] = np.cumsum(cls == code)
        cums[3, 1:] = np.cumsum((cls == 1) | (cls == 3))
    for k in range(3):
        fk = cums[k][first]
        nk = cums[k][last] - fk
        meta[2 * k * wp:2 * k * wp + W] = fk
        meta[(2 * k + 1) * wp:(2 * k + 1) * wp + W] = nk
        nmax.append(int(nk.max()) if W else 0)
    meta[6 * wp:6 * wp + W] = cums[3][last] - cums[3][first]

    ep, ex_buf = _exception_buf(alleles, ex_idx, first, n_sites, wp, ep_min)
    buf = np.concatenate([planes, meta.view(np.uint8), ex_buf])
    return buf, SpB, SpC, SpD, ep, tuple(nmax)



class PairWireV3(NamedTuple):
    """Typed views of one wire-v3 buffer (all share its storage).

    ``planes`` holds the four bit planes as int32 words, ``cB`` [h, SpB/32],
    ``aC`` [h, SpC/32], ``cD`` and ``aD`` [h, SpD/32]; ``meta`` is
    int32 [7, wp] (firstB, nB, firstC, nC, firstD, nD, nconst);
    ``ex_w`` int32 [ep] (``== wp`` for padding entries) and ``ex_codes``
    int8 [ep, h] the exception section."""
    buf: torch.Tensor
    cB: torch.Tensor
    aC: torch.Tensor
    cD: torch.Tensor
    aD: torch.Tensor
    meta: torch.Tensor
    ex_w: torch.Tensor
    ex_codes: torch.Tensor
    h: int
    wp: int


def from_jax_wire(buf, spb: int, spc: int, spd: int, h: int, wp: int,
                  ep: int) -> PairWireV3:
    """Typed views of a wire-v3 buffer made by either package's packer.

    ``buf`` is the uint8 numpy array :func:`pack_pair_wire_v3` returns (the
    JAX package's ``transfer.pack_pair_wire_v3`` makes the same bytes) or a
    uint8 tensor holding it on any device; the static sizes are the ones the
    packer returned.  No data is copied."""
    if isinstance(buf, np.ndarray):
        buf = torch.from_numpy(buf)
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("wire buffer must be a flat uint8 array")
    for sp in (spb, spc, spd):
        if sp % 32:
            raise ValueError(f"plane width {sp} is not a multiple of 32")
    b8, c8, d8 = spb // 8, spc // 8, spd // 8
    base = h * (b8 + c8 + 2 * d8)
    size = base + 28 * wp + 4 * ep + ep * h
    if buf.numel() != size:
        raise ValueError(f"wire buffer holds {buf.numel()} bytes, "
                         f"expected {size}")

    def words(off, nbytes, cols):
        return buf[off:off + nbytes].view(torch.int32).view(h, cols)

    cB = words(0, h * b8, b8 // 4)
    aC = words(h * b8, h * c8, c8 // 4)
    cD = words(h * (b8 + c8), h * d8, d8 // 4)
    aD = words(h * (b8 + c8 + d8), h * d8, d8 // 4)
    meta = buf[base:base + 28 * wp].view(torch.int32).view(7, wp)
    ex0 = base + 28 * wp
    ex_w = buf[ex0:ex0 + 4 * ep].view(torch.int32)
    ex_codes = buf[ex0 + 4 * ep:size].view(torch.int8).view(ep, h)
    return PairWireV3(buf, cB, aC, cD, aD, meta, ex_w, ex_codes, h, wp)


def _bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words [h, n] -> 0/1 int8 [h, 32 n], bit t of word q = site
    32q + t."""
    b = words.view(torch.uint8)                              # [h, 4n] LE
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    return ((b[:, :, None] >> shifts) & 1).reshape(b.shape[0], -1) \
        .to(torch.int8)


def unpack_pair_wire_v3(wire: PairWireV3):
    """Plain PyTorch inverse of :func:`pack_pair_wire_v3` (the JAX
    ``transfer.unpack_pair_wire_v3`` contract).

    Returns (cB int8 [h, spb], aC int8 [h, spc], cD int8 [h, spd],
    aD int8 [h, spd], firstB, nB, firstC, nC, firstD, nD, nconst
    int32 [wp] each, ex_w int32 [ep], ex_codes int8 [ep, h])."""
    planes = [_bits(p) for p in (wire.cB, wire.aC, wire.cD, wire.aD)]
    return (*planes, *wire.meta.unbind(0), wire.ex_w, wire.ex_codes)
