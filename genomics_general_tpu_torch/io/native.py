"""ctypes loader for the native geno tokenizer (csrc/geno_parser.cpp).

Auto-builds the shared library with g++ on first use into the port's
gitignored ``build/`` directory (content-keyed, _buildcache); the source in
``csrc/`` is only read.  Falls back silently to the numpy parser when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .._buildcache import cached_build

_CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"

FMT_CODES = {"phased": 0, "pairs": 1, "alleles": 1, "haplo": 2, "diplo": 3}

_lib = None
_tried = False


def _build_and_load():
    """Build (cached) and load the first link variant that works here: a
    variant can compile and still fail to load (a shared library missing
    at run time)."""
    src = _CSRC / "geno_parser.cpp"
    if not src.exists():
        return None
    for extra in (["-DHAVE_LIBDEFLATE", "-DHAVE_ZLIB", "-ldeflate", "-lz"],
                  ["-DHAVE_ZLIB", "-lz"],
                  ["-DHAVE_LIBDEFLATE", "-ldeflate"], []):
        try:
            path = cached_build(
                "libgenoparser", [src],
                lambda out, extra=extra: [
                    "g++", "-O3", "-shared", "-fPIC", "-march=native",
                    "-o", str(out), str(src)] + extra, timeout=120)
            return ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _build_and_load()
    if lib is None:
        return None
    try:
        lib.gzip_decompress.restype = ctypes.c_int64
        lib.gzip_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64]
    except AttributeError:
        pass
    try:
        lib.gz_stream_open.restype = ctypes.c_void_p
        lib.gz_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.gz_stream_close.restype = None
        lib.gz_stream_close.argtypes = [ctypes.c_void_p]
        lib.gz_stream_next.restype = ctypes.c_int64
        lib.gz_stream_next.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64]
    except AttributeError:
        pass
    try:
        lib.parse_name_table.restype = ctypes.c_int64
        lib.parse_name_table.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float64, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    except AttributeError:
        pass
    try:
        lib.pack_pair_planes.restype = ctypes.c_int64
        lib.pack_pair_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int64]
    except AttributeError:
        pass
    try:
        lib.classify_pair_sites.restype = ctypes.c_int64
        lib.classify_pair_sites.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C")]
        lib.emit_class_planes.restype = None
        lib.emit_class_planes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.class_prefix_sums.restype = None
        lib.class_prefix_sums.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C")]
    except AttributeError:
        pass
    try:
        lib.site_pop_counts_host.restype = None
        lib.site_pop_counts_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint16, flags="C")]
    except AttributeError:
        pass
    try:
        lib.pairwise_window_counts.restype = None
        lib.pairwise_window_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C")]
    except AttributeError:
        pass
    try:
        lib.merge_geno_blocks.restype = ctypes.c_int64
        lib.merge_geno_blocks.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_uint8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C")]
    except AttributeError:
        pass
    try:
        lib.freq_counts_rows.restype = ctypes.c_int64
        lib.freq_counts_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
    except AttributeError:
        pass
    try:
        lib.parse_base_counts_targets.restype = ctypes.c_int64
        lib.parse_base_counts_targets.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int32,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
    except AttributeError:
        pass
    try:
        lib.format_window_csv.restype = ctypes.c_int64
        lib.format_window_csv.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
    except AttributeError:
        pass
    try:
        lib.vcf_to_geno_chunk.restype = ctypes.c_int64
        lib.vcf_to_geno_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C"), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            ctypes.c_uint8,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C"), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    except AttributeError:
        pass
    lib.parse_geno_chunk.restype = ctypes.c_int64
    lib.parse_geno_chunk.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int8, flags="C"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def scan_gz_members(data: bytes, seg_min: int = 1 << 20):
    """Candidate gzip member boundaries (magic ``1f 8b 08`` + plausible
    FLG), grouped into segments of >= ``seg_min`` compressed bytes.
    Returns a list of (start, end) segment bounds, or None when the blob
    is not multi-member enough to be worth splitting.  Candidates can be
    false positives — consumers must be prepared for a segment to fail
    decoding and merge it with its successor.  The scan is
    ``gzsplit.cpp``'s; None where that does not build."""
    if len(data) < 20 or data[:3] != b"\x1f\x8b\x08" \
            or get_gzsplit() is None:
        return None
    return _scan(data, 0, seg_min, 0)


def decompress_gz_segment(data: bytes, a: int, b: int) -> np.ndarray:
    """One-shot decompress of a [a, b) slice holding whole gzip members.
    Raises RuntimeError on decode failure (e.g. a false-positive boundary)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gzip_decompress"):
        raise RuntimeError("native gzip_decompress unavailable")
    import struct
    seg = data[a:b]
    # ISIZE only covers the segment's LAST member; size the buffer from the
    # compressed length (genomic text compresses ~6-9x at bgzip levels) so
    # multi-member segments don't pay a failed first decompress + retry
    isize = struct.unpack("<I", seg[-4:])[0]
    cap = max((b - a) * 12, isize + (1 << 16), 1 << 20)
    for _ in range(6):
        out = np.empty(cap, dtype=np.uint8)
        n = lib.gzip_decompress(seg, len(seg), out, cap)
        if n >= 0:
            return out[:n]
        if n == -1:                       # output too small
            cap *= 4
            continue
        raise RuntimeError(f"gz member decode failed at {a}")
    raise RuntimeError("gz member output growth runaway")


GZ_OK, GZ_BAD, GZ_NEEDS_WINDOW = 0, -2, -3
# the least compressed bytes of a segment that inflates apart (scan_gz_split)
SEG_MIN = 1 << 20
_WINDOW = 1 << 15                  # deflate's reach back, in bytes of text

_gzs = None
_gzs_tried = False


def get_gzsplit():
    """The flush-point splitter (``io/csrc/gzsplit.cpp``), built (cached)
    and loaded; None without zlib or a compiler."""
    global _gzs, _gzs_tried
    if _gzs is not None or _gzs_tried:
        return _gzs
    _gzs_tried = True
    src = Path(__file__).resolve().parent / "csrc" / "gzsplit.cpp"
    try:
        path = cached_build(
            "libgzsplit", [src],
            lambda out: ["g++", "-O2", "-shared", "-fPIC", "-o", str(out),
                         str(src), "-lz"], timeout=120)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    i64, p = ctypes.c_int64, ctypes.c_void_p
    lib.gzs_scan.restype = i64
    lib.gzs_scan.argtypes = [p, i64, i64, i64, ctypes.c_int32,
                             np.ctypeslib.ndpointer(np.int64, flags="C"), i64]
    lib.gzs_inflate.restype = i64
    lib.gzs_inflate.argtypes = [
        p, i64, ctypes.c_int32, p, i64,
        np.ctypeslib.ndpointer(np.uint8, flags="C"), i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.gzs_crc32_combine.restype = ctypes.c_uint32
    lib.gzs_crc32_combine.argtypes = [ctypes.c_uint32, ctypes.c_uint32, i64]
    _gzs = lib
    return _gzs


@dataclass
class GzPiece:
    """One inflated segment [start, ...): its text, the text's CRC-32
    (None for whole members, which carry their own), a ``GZ_*`` status and
    the offset of the compressed byte where the inflate stopped."""
    text: np.ndarray | None
    crc: int | None
    status: int
    start: int
    end: int


class GzMembers:
    """Segments of whole gzip members (bgzip-style files), found by
    :func:`scan_gz_members`; each inflates alone and checks its own CRC."""

    flushes = False

    def __init__(self, data: bytes, segments: list):
        self.data = data
        self.segments = segments

    def inflate(self, a: int, b: int, window: bytes = b"") -> GzPiece:
        try:
            return GzPiece(decompress_gz_segment(self.data, a, b), None,
                           GZ_OK, a, b)
        except RuntimeError:
            return GzPiece(None, None, GZ_BAD, a, a)

    def accept(self, crc, piece: GzPiece):
        return crc

    def release(self, piece: GzPiece):
        pass

    def finish(self, last: GzPiece, crc, size: int):
        return None


class GzFlushes:
    """Segments of one gzip member split at its flush points
    (``gzsplit.cpp``).  A segment inflates alone when it reaches back into
    no earlier one; the caller proves each boundary by inflating, from a
    true start, the segment before it, primes a segment that reaches back
    with the text before it, folds the segments' CRC-32s and holds them
    and the length to the member's trailer (:meth:`finish`)."""

    flushes = True

    def __init__(self, data: bytes, segments: list, lib):
        self.data = data
        self.segments = segments
        self.lib = lib
        self._base = np.frombuffer(data, dtype=np.uint8).ctypes.data
        self.ratio = 64.0      # text bytes a compressed byte, for buffers
        self._spare: list = []  # buffers of consumed pieces, for reuse

    def _buffer(self, cap: int) -> np.ndarray:
        """A spare buffer of at least ``cap`` bytes (its pages written
        already), else a new one rounded up to a power of two."""
        try:
            buf = self._spare.pop()
        except IndexError:
            buf = None
        if buf is None or buf.size < cap:
            buf = np.empty(1 << (cap - 1).bit_length(), dtype=np.uint8)
        return buf

    def release(self, piece: GzPiece):
        """Take back the buffer of a piece whose text nobody reads now."""
        self._spare.append(piece.text.base if piece.text.base is not None
                           else piece.text)

    def inflate(self, a: int, b: int, window: bytes = b"") -> GzPiece:
        """Inflate [a, b) (the last segment through its final block),
        primed with ``window``, the text before it, when given."""
        last = b == len(self.data)
        cap = int((b - a) * self.ratio * 1.25) + (1 << 20)
        out_len, in_used = ctypes.c_int64(), ctypes.c_int64()
        crc = ctypes.c_uint32()
        for _ in range(6):
            out = self._buffer(cap)
            r = self.lib.gzs_inflate(
                self._base + a, b - a, int(last), window, len(window), out,
                out.size, ctypes.byref(out_len), ctypes.byref(in_used),
                ctypes.byref(crc))
            if r != -1:
                break
            cap = 4 * out.size                # output too small
        if r != GZ_OK:
            return GzPiece(None, None, int(r), a, a)
        return GzPiece(out[:out_len.value], crc.value, GZ_OK, a,
                       a + in_used.value)

    def accept(self, crc: int, piece: GzPiece) -> int:
        """``crc`` with the piece's text folded in (the consumer calls it
        in order, so it alone sizes later buffers from the pieces seen)."""
        self.ratio = max(self.ratio,
                         piece.text.size / max(piece.end - piece.start, 1))
        return self.lib.gzs_crc32_combine(crc, piece.crc, piece.text.size)

    def finish(self, last: GzPiece, crc: int, size: int):
        """Hold the text's CRC-32 and length to the trailer after the final
        block; return the text of any members after it (or None)."""
        import gzip
        import struct
        import zlib
        trailer = self.data[last.end:last.end + 8]
        if len(trailer) < 8 or struct.unpack("<II", trailer) != \
                (crc, size & 0xFFFFFFFF):
            raise RuntimeError("gzip trailer does not match the text")
        if last.end + 8 == len(self.data):
            return None
        try:
            return np.frombuffer(gzip.decompress(self.data[last.end + 8:]),
                                 dtype=np.uint8)
        except (OSError, EOFError, zlib.error) as e:
            raise RuntimeError(
                f"gzip members after byte {last.end + 8}: {e}") from None


def _deflate_start(data: bytes) -> int | None:
    """Offset of the deflate data after a gzip member's header."""
    if len(data) < 18 or data[:3] != b"\x1f\x8b\x08" or data[3] & 0xE0:
        return None
    flg, p = data[3], 10
    if flg & 4:                                   # FEXTRA
        p += 2 + int.from_bytes(data[p:p + 2], "little")
    for bit in (8, 16):                           # FNAME, FCOMMENT
        if flg & bit:
            p = data.find(b"\0", p) + 1
            if p == 0:
                return None
    if flg & 2:                                   # FHCRC
        p += 2
    return p if p < len(data) else None


def scan_gz_flushes(data: bytes, seg_min: int) -> GzFlushes | None:
    """Split one gzip member at its candidate flush points (the offset
    after each byte-aligned ``00 00 FF FF``) into segments of >= ``seg_min``
    compressed bytes, the last running to the end of ``data``; None when
    that gives fewer than three (plain ``gzip`` output has no such
    points)."""
    lib = get_gzsplit()
    start = _deflate_start(data)
    if lib is None or start is None:
        return None
    segs = _scan(data, start, seg_min, 1)
    return GzFlushes(data, segs, lib) if segs is not None else None


def _scan(data: bytes, start: int, seg_min: int, kind: int):
    """``gzs_scan``'s segments of data[start:] (kind 0: members, 1: flush
    points) as (a, b) pairs, or None when there are fewer than three."""
    cap = (len(data) - start) // max(seg_min, 1) + 2
    bounds = np.empty(cap, dtype=np.int64)
    base = np.frombuffer(data, dtype=np.uint8).ctypes.data
    n = get_gzsplit().gzs_scan(base, start, len(data), seg_min, kind,
                               bounds, cap)
    if n < 4:
        return None
    b = bounds[:n].tolist()
    return list(zip(b[:-1], b[1:]))


def scan_gz_split(data: bytes):
    """The segments of a .gz blob that inflate apart: its members when it
    has enough (:func:`scan_gz_members`), else the flush points of its one
    member; None when it has neither."""
    segs = scan_gz_members(data, SEG_MIN)
    if segs is not None:
        return GzMembers(data, segs)
    return scan_gz_flushes(data, SEG_MIN)


def gzip_decompress_array(data: bytes):
    """Whole-buffer gzip decompression via libdeflate; returns a uint8 numpy
    array (no copy) or None on any failure.  Output size comes from the gzip
    ISIZE footer (mod 2^32); the buffer is grown on INSUFFICIENT_SPACE for
    >4GB or multi-member streams."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gzip_decompress"):
        return None
    import struct
    if len(data) < 18:
        return None
    isize = struct.unpack("<I", data[-4:])[0]
    cap = max(isize, len(data) * 3, 1 << 20)
    for _ in range(6):
        out = np.empty(cap, dtype=np.uint8)
        n = lib.gzip_decompress(data, len(data), out, cap)
        if n >= 0:
            return out[:n]
        if n == -1:
            cap *= 4
            continue
        return None
    return None


def pack_pair_planes_native(alleles: np.ndarray, called_out: np.ndarray,
                            alt_out: np.ndarray, sp8: int,
                            max_ex: int = 1 << 20):
    """C fast path for the biallelic pair-plane pack (kernels/pairdist wire
    format v2).  ``called_out``/``alt_out`` are uint8 [H, sp8] views into the
    caller's wire buffer (C-contiguous rows).  Returns (refalt uint8 [S],
    ex_idx int32 [E]) or None when the native library is unavailable or the
    exception capacity is exceeded."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pack_pair_planes"):
        return None
    H, S = alleles.shape
    if alleles.strides[1] != 1:          # rows may be strided (buffer views);
        alleles = np.ascontiguousarray(alleles)  # sites must be contiguous
    refalt = np.empty(S, dtype=np.uint8)
    ex_idx = np.empty(max_ex, dtype=np.int32)
    n_ex = lib.pack_pair_planes(
        alleles.ctypes.data_as(ctypes.c_void_p), np.int64(H),
        np.int64(alleles.strides[0]), np.int64(S),
        called_out.ctypes.data_as(ctypes.c_void_p),
        alt_out.ctypes.data_as(ctypes.c_void_p), np.int64(sp8),
        refalt, ex_idx, np.int64(max_ex))
    if n_ex < 0:
        return None
    return refalt, ex_idx[:n_ex].copy()


def classify_pair_sites_native(alleles: np.ndarray, max_ex: int = 1 << 20):
    """C classifier for the wire-v3 pair planes (kernels/transfer
    pack_pair_wire_v3): per-site class 0..5 (0 drop, 1 clean-mono, 2 mono
    w/ missing, 3 biallelic clean, 4 biallelic w/ missing, 5 exception),
    ref/alt codes, exception indices and class counts.  Returns
    (cls uint8 [S], refalt uint8 [S], ex_idx int32 [E],
    counts int64 [nA, nB, nC, nD, nA+nC]) or None when unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "classify_pair_sites"):
        return None
    H, S = alleles.shape
    if alleles.strides[1] != 1:
        alleles = np.ascontiguousarray(alleles)
    cls = np.empty(S, dtype=np.uint8)
    refalt = np.empty(S, dtype=np.uint8)
    ex_idx = np.empty(max_ex, dtype=np.int32)
    counts = np.zeros(5, dtype=np.int64)
    n_ex = lib.classify_pair_sites(
        alleles.ctypes.data_as(ctypes.c_void_p), np.int64(H),
        np.int64(alleles.strides[0]), np.int64(S),
        cls, refalt, ex_idx, np.int64(max_ex), counts)
    if n_ex < 0:
        return None
    return cls, refalt, ex_idx[:n_ex].copy(), counts


def emit_class_planes_native(alleles: np.ndarray, cls: np.ndarray,
                             refalt: np.ndarray,
                             calledB: np.ndarray, spB8: int,
                             altC: np.ndarray, spC8: int,
                             calledD: np.ndarray, altD: np.ndarray,
                             spD8: int) -> bool:
    """C emitter for the wire-v3 compacted class planes (buffers are uint8
    [H, sp8] views into the caller's wire buffer, fully overwritten)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "emit_class_planes"):
        return False
    H, S = alleles.shape
    if alleles.strides[1] != 1:
        alleles = np.ascontiguousarray(alleles)
    lib.emit_class_planes(
        alleles.ctypes.data_as(ctypes.c_void_p), np.int64(H),
        np.int64(alleles.strides[0]), np.int64(S), cls, refalt,
        calledB.ctypes.data_as(ctypes.c_void_p), np.int64(spB8),
        altC.ctypes.data_as(ctypes.c_void_p), np.int64(spC8),
        calledD.ctypes.data_as(ctypes.c_void_p),
        altD.ctypes.data_as(ctypes.c_void_p), np.int64(spD8))
    return True


def merge_geno_blocks_native(blocks: list, sep: int, limit_pos: int,
                             max_pos: int, intersect: bool,
                             missing: list):
    """C k-way positional merge of converted .geno row blocks (one
    scaffold).  ``blocks``: per-file bytes of "SCAF<sep>POS<sep>COLS\\n"
    rows with strictly increasing POS; ``missing``: per-file column fill
    bytes.  Returns (out_bytes, consumed int64 [n]) with rows at positions
    <= limit_pos merged under the union/intersect policy and positions >
    max_pos dropped, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "merge_geno_blocks"):
        return None
    n = len(blocks)
    blocks = [bytes(b) for b in blocks]
    missing = [bytes(m) for m in missing]
    bufs = (ctypes.c_void_p * n)(
        *[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p) for b in blocks])
    lens = np.array([len(b) for b in blocks], dtype=np.int64)
    mptr = (ctypes.c_void_p * n)(
        *[ctypes.cast(ctypes.c_char_p(m), ctypes.c_void_p) for m in missing])
    mlen = np.array([len(m) for m in missing], dtype=np.int64)
    consumed = np.zeros(n, dtype=np.int64)
    # worst case: every input row emits once with every other file's
    # missing fill appended
    rows_bound = sum(b.count(b"\n") for b in blocks) + 1
    cap = sum(lens) + rows_bound * (int(mlen.sum()) + n + 2) + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        w = lib.merge_geno_blocks(
            np.int32(n), bufs, lens, ctypes.c_uint8(sep),
            np.int64(limit_pos), np.int64(max_pos), np.int32(intersect),
            mptr, mlen, out, np.int64(cap), consumed)
        if w == -2:
            return None                       # too many files for the C path
        if w == -1:
            cap *= 2
            continue
        return out[:w].tobytes(), consumed


def pairwise_window_counts_native(called: np.ndarray, alt: np.ndarray,
                                  sp8: int, first: np.ndarray,
                                  n_sites: np.ndarray):
    """C host executor for per-window pairwise mismatch/shared counts over
    the v2 bit planes.  Returns (mismatch, shared) int32 [W, H, H] or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pairwise_window_counts"):
        return None
    H = called.shape[0]
    W = first.shape[0]
    m = np.empty((W, H, H), dtype=np.int32)
    s = np.empty((W, H, H), dtype=np.int32)
    lib.pairwise_window_counts(
        called.ctypes.data_as(ctypes.c_void_p),
        alt.ctypes.data_as(ctypes.c_void_p),
        np.int64(sp8), np.int64(H),
        np.ascontiguousarray(first, dtype=np.int64),
        np.ascontiguousarray(n_sites, dtype=np.int64), np.int64(W), m, s)
    return m, s


def site_pop_counts_host_native(alleles: np.ndarray,
                                membership: np.ndarray) -> np.ndarray | None:
    """C per-site per-mask allele counts: membership is a uint8 [H] bitmask
    of the (<= 8) masks each row belongs to.  Returns uint16
    [S, n_masks, 4] or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "site_pop_counts_host"):
        return None
    H, S = alleles.shape
    if alleles.strides[1] != 1:
        alleles = np.ascontiguousarray(alleles)
    n_masks = int(membership.max()).bit_length() if membership.size else 1
    n_masks = max(n_masks, 1)
    counts = np.empty((S, n_masks, 4), dtype=np.uint16)
    lib.site_pop_counts_host(
        alleles.ctypes.data_as(ctypes.c_void_p), np.int64(H),
        np.int64(alleles.strides[0]), np.int64(S),
        np.ascontiguousarray(membership, dtype=np.uint8),
        np.int32(n_masks), counts)
    return counts


def class_prefix_sums_native(cls: np.ndarray):
    """C exclusive prefix sums of the wire-v3 class indicators.  Returns
    int64 [4, S+1] (rows: class B, C, D, and A|C) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "class_prefix_sums"):
        return None
    S = cls.shape[0]
    cum = np.empty((4, S + 1), dtype=np.int64)
    lib.class_prefix_sums(cls, np.int64(S), cum)
    return cum


def gzip_decompress_bytes(data: bytes) -> bytes | None:
    arr = gzip_decompress_array(data)
    return arr.tobytes() if arr is not None else None


def parse_name_table(blob, n_vals: int):
    """C tokenizer for name + fixed-count numeric tables (tab/space/comma
    separated; [-]digits[.digits] or nan).  Returns (values float64
    [n_lines, n_vals], names list[bytes], bounds int64 [n_runs+1] giving
    each name run's line span) or None when the native library is missing
    or the blob does not fit the grammar (caller falls back).

    Values parse exactly as Python float() does (integer mantissa divided
    by a power of ten is correctly rounded; >18-digit mantissas bail to the
    fallback), so downstream rounding/formatting is bit-identical."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "parse_name_table"):
        return None
    if isinstance(blob, np.ndarray):
        buf_ptr = blob.ctypes.data_as(ctypes.c_void_p)
        blob_len = blob.size
        as_bytes = None
    else:
        buf_ptr = ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p)
        blob_len = len(blob)
        as_bytes = blob
    cap = blob_len // (2 * n_vals + 2) + 2        # minimal line ~2B/value
    values = np.empty((cap, n_vals), dtype=np.float64)
    max_breaks = 65536
    breaks = np.empty(3 * max_breaks, dtype=np.int64)
    n_breaks = ctypes.c_int64(0)
    n_lines = ctypes.c_int64(0)
    ret = lib.parse_name_table(buf_ptr, np.int64(blob_len),
                               np.int32(n_vals), values, np.int64(cap),
                               breaks, np.int64(max_breaks),
                               ctypes.byref(n_breaks), ctypes.byref(n_lines))
    if ret != 0:
        return None
    n = n_lines.value
    nb = n_breaks.value
    names = []
    lines_at = np.empty(nb + 1, dtype=np.int64)
    for k in range(nb):
        li, off, ln = breaks[3 * k], breaks[3 * k + 1], breaks[3 * k + 2]
        lines_at[k] = li
        if as_bytes is not None:
            names.append(as_bytes[off:off + ln])
        else:
            names.append(blob[off:off + ln].tobytes())
    lines_at[nb] = n
    return values[:n], names, lines_at


def freq_counts_rows(alleles: np.ndarray, pop_row_lists, positions: np.ndarray,
                     run_names: list[bytes], run_bounds: np.ndarray,
                     write, buf_bytes: int = 8 << 20) -> bool:
    """Fused per-site pop base counting + freq counts-mode row formatting
    (C one-pass; the per-site counts are the OUTPUT here, so no device round
    trip).  ``write(bytes)`` is called per filled buffer.  Returns False when
    the native library is unavailable (caller falls back)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "freq_counts_rows"):
        return False
    H, S = alleles.shape
    if S == 0:
        return True
    if alleles.strides[1] != 1:
        alleles = np.ascontiguousarray(alleles)
    pop_rows = np.ascontiguousarray(
        np.concatenate([np.asarray(r, dtype=np.int32) for r in pop_row_lists])
        if pop_row_lists else np.zeros(0, np.int32), dtype=np.int32)
    pop_starts = np.zeros(len(pop_row_lists) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in pop_row_lists], out=pop_starts[1:])
    blob = b"".join(run_names)
    run_off = np.zeros(len(run_names), dtype=np.int64)
    run_len = np.array([len(n) for n in run_names], dtype=np.int64)
    np.cumsum(run_len[:-1], out=run_off[1:])
    rb = np.ascontiguousarray(run_bounds, dtype=np.int64)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    out = np.empty(buf_bytes, dtype=np.uint8)
    done = ctypes.c_int64(0)
    s = 0
    while s < S:
        n = lib.freq_counts_rows(
            alleles.ctypes.data_as(ctypes.c_void_p),
            np.int64(alleles.strides[0]), np.int64(S),
            pop_rows, pop_starts, np.int32(len(pop_row_lists)),
            positions, blob, run_off, run_len, rb, np.int64(len(run_names)),
            np.int64(s), out, np.int64(buf_bytes), ctypes.byref(done))
        if n < 0:
            raise RuntimeError(f"freq_counts_rows error {n}")
        if n == 0 and done.value == s:
            raise RuntimeError("freq_counts_rows made no progress")
        write(out[:n].tobytes())
        s = done.value
    return True


def parse_base_counts_targets(blob, n_cols: int, sel_cols, out_col: int):
    """C fused baseCounts-table parse + SFS target selection.

    Returns (positions int64 [S], tgt int32 [S, n_in], ok uint8 [S],
    ambig_idx int64 [F], ambig_counts int32 [F, n_in+1, 4], nhap_max
    int32 [n_in], names list[bytes], bounds int64 [n_runs+1]) or None when
    the library is missing / the blob does not fit the integer grammar
    (caller falls back to the float64 table parser).  Ambiguous folded lines
    (argsort tie affecting the output) carry provisional targets; the caller
    re-resolves them with np.argsort on ambig_counts."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "parse_base_counts_targets"):
        return None
    if isinstance(blob, np.ndarray):
        buf_ptr = blob.ctypes.data_as(ctypes.c_void_p)
        blob_len = blob.size
        as_bytes = None
    else:
        buf_ptr = ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p)
        blob_len = len(blob)
        as_bytes = blob
    sel = np.ascontiguousarray(sel_cols, dtype=np.int32)
    n_in = sel.size
    cap = blob_len // (2 * (1 + 4 * n_cols)) + 2
    positions = np.empty(cap, dtype=np.int64)
    tgt = np.empty((cap, max(n_in, 1)), dtype=np.int32)
    ok = np.empty(cap, dtype=np.uint8)
    ambig = np.empty(cap, dtype=np.uint8)
    flag_cap = max(4096, cap // 16)
    flag_counts = np.empty((flag_cap, n_in + 1, 4), dtype=np.int32)
    flag_idx = np.empty(flag_cap, dtype=np.int64)
    nhap_max = np.zeros(max(n_in, 1), dtype=np.int32)
    max_breaks = 65536
    breaks = np.empty(3 * max_breaks, dtype=np.int64)
    n_breaks = ctypes.c_int64(0)
    n_lines = ctypes.c_int64(0)
    n_flag = ctypes.c_int64(0)
    ret = lib.parse_base_counts_targets(
        buf_ptr, np.int64(blob_len), np.int32(n_cols), sel, np.int32(n_in),
        np.int32(out_col), positions, tgt, ok, ambig,
        flag_counts.reshape(flag_cap, -1), flag_idx, np.int64(flag_cap),
        nhap_max, np.int64(cap), breaks, np.int64(max_breaks),
        ctypes.byref(n_breaks), ctypes.byref(n_lines), ctypes.byref(n_flag))
    if ret != 0:
        return None
    n = n_lines.value
    nb = n_breaks.value
    nf = n_flag.value
    names = []
    bounds = np.empty(nb + 1, dtype=np.int64)
    for k in range(nb):
        li, off, ln = breaks[3 * k], breaks[3 * k + 1], breaks[3 * k + 2]
        bounds[k] = li
        names.append(as_bytes[off:off + ln] if as_bytes is not None
                     else blob[off:off + ln].tobytes())
    bounds[nb] = n
    return (positions[:n], tgt[:n], ok[:n], flag_idx[:nf],
            flag_counts[:nf], nhap_max, names, bounds)


def format_window_csv(scaf_names: list[bytes], scaf_idx: np.ndarray,
                      start: np.ndarray, end: np.ndarray, mid: np.ndarray,
                      sites: np.ndarray, values: np.ndarray,
                      col_kind: np.ndarray, round_to: int,
                      emit: np.ndarray, good: np.ndarray,
                      write, buf_bytes: int = 8 << 20) -> bool:
    """C window-CSV emitter (reference round(np.float64, roundTo)+str text).

    ``values`` [W, C] float64; ``col_kind`` uint8 (0=float, 1=int-or-nan);
    ``write(bytes)`` per filled buffer.  Returns False when unavailable or a
    value falls outside the exact-format range (caller uses the Python row
    loop)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "format_window_csv"):
        return False
    W = start.shape[0]
    if W == 0:
        return True
    blob = b"".join(scaf_names)
    off = np.zeros(len(scaf_names), dtype=np.int64)
    ln = np.array([len(n) for n in scaf_names], dtype=np.int64)
    if len(scaf_names) > 1:
        np.cumsum(ln[:-1], out=off[1:])
    values = np.ascontiguousarray(values, dtype=np.float64)
    out = np.empty(buf_bytes, dtype=np.uint8)
    done = ctypes.c_int64(0)
    r = 0
    chunks = []
    while r < W:
        n = lib.format_window_csv(
            blob, off, ln, np.ascontiguousarray(scaf_idx, dtype=np.int32),
            np.ascontiguousarray(start, dtype=np.int64),
            np.ascontiguousarray(end, dtype=np.int64),
            np.ascontiguousarray(mid, dtype=np.float64),
            np.ascontiguousarray(sites, dtype=np.int64),
            values, np.int32(values.shape[1]),
            np.ascontiguousarray(col_kind, dtype=np.uint8),
            np.int32(round_to),
            np.ascontiguousarray(emit, dtype=np.uint8),
            np.ascontiguousarray(good, dtype=np.uint8),
            np.int64(W), np.int64(r), out, np.int64(buf_bytes),
            ctypes.byref(done))
        if n == -3:
            return False
        if n < 0:
            raise RuntimeError(f"format_window_csv error {n}")
        if n == 0 and done.value == r:
            raise RuntimeError("format_window_csv made no progress")
        chunks.append(out[:n].tobytes())
        r = done.value
    for c in chunks:
        write(c)
    return True


class GzChunkStream:
    """Streaming gzip chunker over an in-memory .gz blob (C session).

    Serves line-aligned uint8 chunks without materializing the decompressed
    file: gzip members that fit the chunk buffer are one-shot libdeflate
    decompressed (multi-member / bgzf-style files), oversized members stream
    through zlib.  The ctypes call releases the GIL, so decompression on the
    prefetch thread overlaps tokenize/dispatch threads.  Buffers come from a
    small rotating pool; ``pool_depth`` must exceed the number of chunks the
    consumer keeps alive at once (parse pipeline depth).
    """

    def __init__(self, data: bytes, chunk_bytes: int, pool_depth: int = 8):
        lib = get_lib()
        if lib is None or not hasattr(lib, "gz_stream_open"):
            raise RuntimeError("native gz stream unavailable")
        self.lib = lib
        self.data = data                       # keep the blob alive
        self.chunk_bytes = int(chunk_bytes)
        self._bufs = [np.empty(self.chunk_bytes, dtype=np.uint8)
                      for _ in range(pool_depth)]
        self._next_buf = 0
        self.ctx = lib.gz_stream_open(data, len(data))
        if not self.ctx:
            raise RuntimeError("gz_stream_open failed")
        self.failed = False

    def next_chunk(self) -> np.ndarray | None:
        """Return the next line-aligned chunk view, or None at EOF.

        Raises RuntimeError on corrupt input (caller falls back to the
        Python zlib path from scratch)."""
        if self.ctx is None:
            return None
        buf = self._bufs[self._next_buf]
        self._next_buf = (self._next_buf + 1) % len(self._bufs)
        n = self.lib.gz_stream_next(self.ctx, buf, buf.size)
        if n == 0:
            self.close()
            return None
        if n < 0:
            self.failed = True
            self.close()
            raise RuntimeError(f"gz stream error {n}")
        return buf[:n]

    def close(self):
        if self.ctx is not None:
            self.lib.gz_stream_close(self.ctx)
            self.ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeParser:
    """Per-reader state for the native tokenizer."""

    def __init__(self, n_rows: int, sel_offsets: np.ndarray,
                 sel_ploidy: list[int], row_orders: list[np.ndarray],
                 gt_block_len: int, geno_format: str):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native parser unavailable")
        self.n_rows = n_rows
        self.fmt = FMT_CODES[geno_format]
        self.gt_block_len = gt_block_len
        self.sel_offsets = np.ascontiguousarray(sel_offsets, dtype=np.int64)
        self.sel_ploidy = np.ascontiguousarray(sel_ploidy, dtype=np.int32)
        starts = np.zeros(len(sel_ploidy), dtype=np.int64)
        np.cumsum(self.sel_ploidy[:-1], out=starts[1:])
        self.sel_row_start = starts
        self.row_index = np.ascontiguousarray(
            np.concatenate(row_orders), dtype=np.int32)

    def parse(self, blob):
        """blob: bytes or uint8 numpy array of whole lines.  Returns
        (alleles [H,n], positions [n], scaf_names list, scaf_break line
        indices) or None if the chunk needs the fallback parser."""
        if isinstance(blob, np.ndarray):
            buf_ptr = blob.ctypes.data_as(ctypes.c_void_p)
            blob_len = blob.size
            blob_bytes = None
        else:
            buf_ptr = ctypes.cast(ctypes.c_char_p(blob), ctypes.c_void_p)
            blob_len = len(blob)
            blob_bytes = blob
        # upper bound on line count: minimal line is "s\tP\t" + block + "\n"
        n_max = blob_len // (self.gt_block_len + 4) + 2
        alleles = np.empty((self.n_rows, n_max), dtype=np.int8)
        positions = np.empty(n_max, dtype=np.int64)
        max_breaks = 65536
        breaks = np.empty(3 * max_breaks, dtype=np.int64)
        n_breaks = ctypes.c_int64(0)
        n_lines = ctypes.c_int64(0)
        ret = self.lib.parse_geno_chunk(
            buf_ptr, blob_len, self.gt_block_len,
            np.int32(len(self.sel_ploidy)), self.sel_offsets, self.sel_ploidy,
            self.sel_row_start, self.row_index, np.int32(self.fmt),
            alleles, np.int64(n_max), positions,
            breaks, np.int64(max_breaks),
            ctypes.byref(n_breaks), ctypes.byref(n_lines))
        if ret != 0:
            return None
        n = n_lines.value
        nb = n_breaks.value
        names = []
        lines_at = np.empty(nb, dtype=np.int64)
        for k in range(nb):
            li, off, ln = breaks[3 * k], breaks[3 * k + 1], breaks[3 * k + 2]
            lines_at[k] = li
            names.append(blob[off:off + ln])
        return alleles[:, :n], positions[:n], names, lines_at
