"""Streaming, vectorized reader for the `.geno` text format.

Format (reference README.md:32-40): whitespace-separated columns
``#CHROM  POS  ind1  ind2 ...`` with genotype fields like ``A/A``, ``G|T``,
``N/N`` (phased), ``AT`` (pairs), ``A`` (haplo) or IUPAC ``W`` (diplo).
Lines starting with ``#`` after the header are skipped
(reference GenoFileReader.siteBySite, genomics.py:1934-1938).

Instead of the reference's per-line ``str.split`` + per-genotype ``Genotype``
objects with a memo cache (genomics.py:1884-1932), we parse whole byte chunks
with numpy:

* newline/tab positions found in one vectorized pass,
* integer positions decoded by a padded digit-matrix dot product,
* the genotype block is reshaped to a [lines, width] uint8 matrix (all data
  lines have identical genotype-block layout in well-formed files) and decoded
  by per-individual byte-LUT lookups (see ``encoding.decode_genotype_fields``).

A slow per-line fallback handles irregular lines (variable whitespace, ragged
fields).  Output rows are haplotypes in the reference's sorted order
(``HaplotypeModel``); values int8 with A=0 C=1 G=2 T=3, missing=-1.

When available, a C++ tokenizer (csrc/geno_parser.cpp, loaded via ctypes)
replaces the numpy chunk parser; semantics are identical.
"""

from __future__ import annotations

import gzip
import os
import sys
from dataclasses import dataclass

import numpy as np

from .. import encoding
from ..engine import NO_TIMER
from ..samples import HaplotypeModel, SampleData

_POW10 = 10 ** np.arange(19, dtype=np.int64)[::-1]


def open_maybe_gz(path: str | None, mode: str = "rb"):
    """Open path (gz-aware by suffix) or stdin/stdout when path is None,
    mirroring the reference CLIs (e.g. popgenWindows.py:313-317)."""
    if path is None:
        if "r" in mode:
            return sys.stdin.buffer if "b" in mode else sys.stdin
        return sys.stdout.buffer if "b" in mode else sys.stdout
    if path.endswith((".gz", ".bgz")):
        return gzip.open(path, mode if "b" in mode else mode + "t")
    return open(path, mode)


@dataclass
class GenoChunk:
    """One parsed chunk: haplotype rows x sites (sorted row order)."""
    alleles: np.ndarray          # int8 [H, S]
    positions: np.ndarray        # int64 [S]
    scaffold_ids: np.ndarray     # int32 [S], indices into reader.scaffold_names


@dataclass
class GenoData:
    """A fully materialized dataset (concatenation of chunks)."""
    alleles: np.ndarray          # int8 [H, S]
    positions: np.ndarray        # int64 [S]
    scaffold_ids: np.ndarray     # int32 [S]
    scaffold_names: list[str]
    model: "HaplotypeModel"

    @property
    def n_sites(self) -> int:
        return self.positions.shape[0]


def first_data_line(blob) -> bytes | None:
    """First non-comment, non-empty line of a blob (bytes or uint8 array)
    WITHOUT splitting/copying the whole buffer — chunks can be hundreds of
    MB and only the head is needed to establish the genotype-block layout."""
    is_arr = isinstance(blob, np.ndarray)
    n = blob.size if is_arr else len(blob)
    pos = 0
    while pos < n:
        if is_arr:
            end = -1
            scan, step = pos, 1 << 16
            while scan < n:
                seg = blob[scan:scan + step]
                hits = np.flatnonzero(seg == ord("\n"))
                if hits.size:
                    end = scan + int(hits[0])
                    break
                scan += seg.size
                step *= 4
        else:
            end = blob.find(b"\n", pos)
        if end < 0:
            end = n
        if end > pos and blob[pos] != (ord("#") if is_arr else b"#"[0]):
            line = blob[pos:end]
            return line.tobytes() if is_arr else line
        pos = end + 1
    return None


def _newline(arr: np.ndarray, last: bool = False, step: int = 1 << 16) -> int:
    """Index of the first (or last) newline of a uint8 array, or -1,
    scanning ``step`` bytes at a time from that end (a line is a few kB;
    the text tens of MB)."""
    n = arr.size
    for k in range(0, n, step):
        lo, hi = (max(n - k - step, 0), n - k) if last else (k, k + step)
        hits = np.flatnonzero(arr[lo:hi] == ord("\n"))
        if hits.size:
            return lo + int(hits[-1] if last else hits[0])
    return -1


class _ZlibStreamFile:
    """File-like zlib streaming decompressor over an in-memory gzip blob.

    Used by the hybrid-start path: serves the first decompressed bytes while
    the (much faster, but one-shot) libdeflate whole-file decompress runs in
    a background thread.  ``served`` counts bytes handed out so the reader
    can jump into the whole-file buffer at the right offset."""

    def __init__(self, data: bytes):
        import zlib
        self._zlib = zlib
        self.obj = zlib.decompressobj(31)
        self.pending: bytes | None = data
        self.served = 0
        self.eof = False

    def read(self, n: int) -> bytes:
        if self.eof:
            return b""
        out = []
        got = 0
        while got < n:
            if self.obj.unconsumed_tail:
                chunk = self.obj.decompress(self.obj.unconsumed_tail, n - got)
            elif self.pending is not None:
                chunk = self.obj.decompress(self.pending, n - got)
                self.pending = None
            else:
                chunk = b""
            if chunk:
                out.append(chunk)
                got += len(chunk)
                continue
            if self.obj.eof and self.obj.unused_data:
                # multi-member gzip: restart on the next member
                nxt = self.obj.unused_data
                self.obj = self._zlib.decompressobj(31)
                self.pending = nxt
                continue
            self.eof = True
            break
        b = b"".join(out)
        self.served += len(b)
        return b


class GenoReader:
    """Chunked reader producing numeric haplotype matrices.

    Parameters
    ----------
    fileobj : binary file-like (already opened; gz handled by caller or
        ``open_maybe_gz``).
    sample_data : SampleData giving individuals (column subset), ploidy, pops.
    geno_format : 'phased' | 'pairs' | 'alleles' | 'haplo' | 'diplo'.
    header : optional header text when the stream has none
        (reference ``--header``).
    """

    def __init__(self, fileobj, sample_data: SampleData | None = None,
                 geno_format: str = "phased", header: str | None = None,
                 chunk_bytes: int | None = None,
                 preseed_scaffolds: list | None = None):
        if chunk_bytes is None:
            # GGT_CHUNK_BYTES: test hook to force tiny streaming chunks
            # (bounded-memory regression tests drive every CLI through many
            # chunk boundaries and assert unchanged output)
            chunk_bytes = int(os.environ.get("GGT_CHUNK_BYTES", 16 << 20))
        self._whole: np.ndarray | None = None
        self._gz_sess = None             # native streaming gz chunker
        self._gz_data: bytes | None = None
        self._gz_split = None            # segments that inflate apart
        self._gz_served = 0              # decompressed bytes already handed out
        self._sess_leftover: np.ndarray | None = None
        if isinstance(fileobj, str):
            if fileobj.endswith((".gz", ".bgz")) \
                    and os.path.getsize(fileobj) < (4 << 30) \
                    and os.environ.get("GGT_NO_NATIVE_PARSER") != "1":
                # C streaming decompressor: serves line-aligned chunks
                # without materializing the whole file (gzip members that fit
                # the chunk buffer go through one-shot libdeflate, oversized
                # members stream through zlib).  Chunk buffers stay
                # cache-warm for the tokenizer that runs right after, which
                # matters on bandwidth-starved hosts.
                data = open(fileobj, "rb").read()
                try:
                    from .native import GzChunkStream, ParallelGzChunks
                    self._gz_sess = None
                    gz_threads = int(os.environ.get("GGT_GZ_THREADS", "1"))
                    if gz_threads > 1:
                        # OPT-IN member-parallel decompress (multi-member /
                        # bgzip-style files).  Measured SLOWER on the 2-core
                        # dev host (0.53 vs 0.34 s median): the extra
                        # threads fight the tokenizer pool and the big
                        # inflated segments lose the sequential session's
                        # cache-warm chunk->tokenize pattern.  Kept as a
                        # knob for wider hosts.
                        try:
                            self._gz_sess = ParallelGzChunks(
                                data, chunk_bytes, threads=gz_threads)
                        except RuntimeError:
                            self._gz_sess = None
                    if self._gz_sess is None:
                        self._gz_sess = GzChunkStream(data, chunk_bytes)
                    self._gz_data = data
                    if os.environ.get("GGT_FUSED_GZ", "1") != "0":
                        from .native import scan_gz_split
                        self._gz_split = scan_gz_split(data)
                    fileobj = None
                except Exception:
                    self._gz_sess = None
                    fileobj = open_maybe_gz(fileobj, "rb")
            else:
                fileobj = open_maybe_gz(fileobj, "rb")
        if hasattr(fileobj, "buffer"):      # text stdin
            fileobj = fileobj.buffer
        self.f = fileobj
        self.geno_format = geno_format
        self.chunk_bytes = chunk_bytes
        self._tail = b""
        self._eof = False

        if header is not None:
            header_line = header.encode() if isinstance(header, str) else header
        else:
            header_line = self._read_header_line()
        cols = header_line.split()
        self.file_ind_names = [c.decode() for c in cols[2:]]

        if sample_data is None:
            sample_data = SampleData(ind_names=list(self.file_ind_names))
        elif not sample_data.ind_names:
            sample_data.ind_names = list(self.file_ind_names)
            for ind in self.file_ind_names:
                sample_data.ploidy.setdefault(ind, 2)
        self.sample_data = sample_data
        self.model = HaplotypeModel.build(sample_data)

        name_to_col = {n: i for i, n in enumerate(self.file_ind_names)}
        try:
            self.ind_cols = np.array(
                [name_to_col[n] for n in sample_data.ind_names], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"sample {e.args[0]!r} not found in geno header") from None

        self.scaffold_names: list[str] = []
        self._scaf_index: dict[bytes, int] = {}
        if preseed_scaffolds:
            # pre-register scaffold ids (multi-host indexed input: every
            # host numbers scaffolds by the shared index order even though
            # each stream only carries its own scaffolds)
            for name in preseed_scaffolds:
                self._scaf_index[name.encode()] = len(self.scaffold_names)
                self.scaffold_names.append(name)
        # genotype-block layout (established from the first data line)
        self._field_widths: np.ndarray | None = None
        self._native = None
        self._native_failed = os.environ.get("GGT_NO_NATIVE_PARSER") == "1"

    # ------------------------------------------------------------------ I/O

    def _session_next(self) -> np.ndarray | None:
        """Next line-aligned chunk from the native gz session, or None.

        On a native decode failure the remaining input is replayed through
        the Python zlib streamer from the already-served byte offset
        (``self.f`` is set and the caller falls through to the generic read
        path); at clean EOF ``self.f`` stays None."""
        if self._gz_sess is None:
            return None
        try:
            chunk = self._gz_sess.next_chunk()
        except RuntimeError:
            stream = _ZlibStreamFile(self._gz_data)
            skip = self._gz_served
            while skip > 0:
                b = stream.read(min(1 << 20, skip))
                if not b:
                    break
                skip -= len(b)
            self.f = stream
            self._gz_sess = None
            self._gz_data = None
            return None
        if chunk is None:
            self._gz_sess = None
            self._gz_data = None
            self._eof = True
            return None
        self._gz_served += chunk.size
        return chunk

    def _read_header_line(self) -> bytes:
        if self._gz_sess is not None:
            chunk = self._session_next()
            if chunk is not None:
                nl = np.flatnonzero(chunk == ord("\n"))
                if nl.size == 0:
                    return chunk.tobytes()
                first = int(nl[0])
                self._sess_leftover = chunk[first + 1:]
                return chunk[:first].tobytes()
            if self.f is None:
                return b""
            # session failed on the first chunk: replay stream owns the
            # bytes now; fall through to the generic read path
        if self._whole is not None:
            # scan only the head; headers are small
            step = 1 << 20
            nl = -1
            for off in range(0, self._whole.size, step):
                seg = self._whole[off:off + step]
                hits = np.flatnonzero(seg == ord("\n"))
                if hits.size:
                    nl = off + int(hits[0])
                    break
            if nl < 0:
                nl = self._whole.size
            self._whole_off = nl + 1
            return self._whole[:nl].tobytes()
        buf = b""
        while b"\n" not in buf:
            b_ = self.f.read(4096)
            if not b_:
                break
            buf += b_
        line, _, rest = buf.partition(b"\n")
        self._tail = rest
        return line

    def _read_chunk_lines(self):
        """Return a blob (bytes or uint8 array) of whole lines ending with a
        newline, or None at EOF."""
        if self._sess_leftover is not None:
            lo = self._sess_leftover
            self._sess_leftover = None
            if lo.size:
                return lo
        if self._gz_sess is not None:
            chunk = self._session_next()
            if chunk is not None:
                return chunk
            if self.f is None:
                return None
            # session failed mid-stream: continue on the replay stream below
        if self._whole is not None:
            off = self._whole_off
            total = self._whole.size
            if off >= total:
                return None
            # yield bounded slices (not the whole file) so parsing streams
            # and overlaps downstream upload/compute via the prefetch thread
            end = min(off + self.chunk_bytes, total)
            if end < total:
                seg = self._whole[off:end]
                hits = np.flatnonzero(seg[::-1] == ord("\n"))
                if hits.size:
                    end = end - int(hits[0])
                else:
                    end = total
            self._whole_off = end
            blob = self._whole[off:end]
            if blob.size and blob[-1] != ord("\n"):
                blob = np.concatenate([blob, np.array([ord("\n")], np.uint8)])
            return blob
        if self._eof and not self._tail:
            return None
        data = self._tail
        while True:
            b_ = self.f.read(self.chunk_bytes)
            if not b_:
                self._eof = True
                break
            data += b_
            if len(data) >= self.chunk_bytes:
                break
        if self._eof:
            self._tail = b""
            if data and not data.endswith(b"\n"):
                data += b"\n"
            return data if data else None
        cut = data.rfind(b"\n")
        if cut == -1:
            self._tail = data
            return self._read_chunk_lines()
        self._tail = data[cut + 1:]
        return data[:cut + 1]

    # ------------------------------------------------------------ parsing

    def _scaf_id(self, name: bytes) -> int:
        sid = self._scaf_index.get(name)
        if sid is None:
            sid = len(self.scaffold_names)
            self._scaf_index[name] = sid
            self.scaffold_names.append(name.decode())
        return sid

    def _establish_layout(self, first_line: bytes):
        parts = first_line.split()
        gts = parts[2:]
        widths = np.array([len(g) for g in gts], dtype=np.int64)
        self._field_widths = widths
        # byte offset of each genotype field within the tab-joined GT block
        self._field_offsets = np.concatenate([[0], np.cumsum(widths[:-1] + 1)])
        self._gt_block_len = int(widths.sum() + len(widths) - 1)
        # per requested individual: (offset, width)
        self._sel_offsets = self._field_offsets[self.ind_cols]
        self._sel_widths = widths[self.ind_cols]

    def _ensure_parser(self, blob) -> bool:
        """Establish the genotype-block layout + native parser from the first
        data line.  Must run on the consumer thread before workers parse.
        Returns False when the blob holds no data line yet."""
        if self._field_widths is None:
            ln = first_data_line(blob)
            if ln is not None:
                self._establish_layout(ln)
            if self._field_widths is None:
                return False
        if not self._native_failed and self._native is None:
            try:
                from .native import NativeParser
                self._native = NativeParser(
                    self.model.n_rows, self._sel_offsets,
                    [len(o) for o in self.model.ind_order],
                    self.model.ind_order, self._gt_block_len,
                    self.geno_format)
            except Exception as e:
                import sys
                sys.stderr.write(
                    f"[info] geno reader: C tokenizer unavailable ({e!r}); "
                    "using the vectorized numpy parser\n")
                self._native_failed = True
        return True

    def parse_blob_raw(self, blob):
        """Pure parse stage: blob -> (alleles, positions, names, bounds).

        Touches no reader state (after ``_ensure_parser``), so it can run on
        any worker thread; the ctypes tokenizer releases the GIL, so chunk
        parses genuinely overlap.  ``names[k]`` spans sites
        ``bounds[k]:bounds[k+1]``."""
        if self._native is not None:
            res = self._native.parse(blob)
            if res is not None:
                alleles, positions, names, lines_at = res
                bounds = np.concatenate([lines_at, [positions.shape[0]]])
                return alleles, positions, [bytes(n) for n in names], bounds
        try:
            return self._parse_chunk_fast(blob)
        except _FallbackNeeded:
            return self._parse_chunk_slow(blob)

    def _raw_to_chunk(self, raw) -> GenoChunk:
        """Ordered finish stage: map scaffold names to stable ids (ids are
        assigned in genome order, so this must run on the consumer thread,
        in order)."""
        alleles, positions, names, bounds = raw
        scaffold_ids = np.empty(positions.shape[0], dtype=np.int32)
        for k, name in enumerate(names):
            scaffold_ids[bounds[k]:bounds[k + 1]] = self._scaf_id(name)
        return GenoChunk(alleles=alleles, positions=positions,
                         scaffold_ids=scaffold_ids)

    def parse_chunk(self, blob: bytes) -> GenoChunk | None:
        """Parse a blob of complete lines into a GenoChunk."""
        if not self._ensure_parser(blob):
            return None
        return self._raw_to_chunk(self.parse_blob_raw(blob))

    def _parse_chunk_fast(self, blob: bytes):
        """Vectorized chunk parse using only 1-D gathers.

        Key trick: in a well-formed file the genotype block has a fixed byte
        length L, so the second tab sits at ``end - L - 1`` on every line —
        no tab scan needed.  The position field is parsed from a right-aligned
        digit window ending at that tab; the first non-digit byte from the
        right marks the scaffold/position boundary.
        """
        buf = blob if isinstance(blob, np.ndarray) \
            else np.frombuffer(blob, dtype=np.uint8)
        nl = np.flatnonzero(buf == ord("\n"))
        if nl.size == 0:
            return None
        starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
        ends = nl.astype(np.int64)
        # skip comment lines and empty lines
        keep = (ends > starts) & (buf[np.minimum(starts, buf.size - 1)] != ord("#"))
        starts, ends = starts[keep], ends[keep]
        n = starts.size
        if n == 0:
            return (np.empty((self.model.n_rows, 0), np.int8),
                    np.empty(0, np.int64), [], np.array([0], np.int64))

        L = self._gt_block_len
        t2 = ends - L - 1
        if np.any(t2 <= starts) or np.any(buf[t2] != ord("\t")):
            raise _FallbackNeeded
        gstart = t2 + 1

        # verify separators are single tabs at expected offsets (1-D gathers)
        for so in self._field_offsets[1:] - 1:
            if not np.all(buf[gstart + so] == ord("\t")):
                raise _FallbackNeeded

        # ---- positions: right-aligned digit window ending at t2
        W = min(19, int((t2 - starts).max()))
        col = np.arange(W)
        idx = (t2 - W)[:, None] + col[None, :]          # [n, W] small
        window = buf[np.maximum(idx, starts[:, None])]
        digit = (window >= ord("0")) & (window <= ord("9"))
        nd = ~digit
        has_nd = nd.any(axis=1)
        if not has_nd.all():
            raise _FallbackNeeded                        # position too wide
        r = W - 1 - np.argmax(nd[:, ::-1], axis=1)       # rightmost non-digit
        pw = W - 1 - r
        if np.any(pw < 1):
            raise _FallbackNeeded
        vals = window.astype(np.int64) - ord("0")
        contrib_mask = col[None, :] > r[:, None]
        positions = np.where(contrib_mask, vals, 0) @ _POW10[-W:]

        t1 = t2 - pw - 1
        if np.any(buf[t1] != ord("\t")):
            raise _FallbackNeeded

        # ---- scaffolds: padded name matrix, find run boundaries
        sw = t1 - starts
        maxsw = int(sw.max())
        scol = np.arange(maxsw)
        sidx = starts[:, None] + scol
        svalid = scol < sw[:, None]
        smat = np.where(svalid, buf[np.minimum(sidx, buf.size - 1)], 0)
        if n > 1:
            change = np.any(smat[1:] != smat[:-1], axis=1)
            boundaries = np.concatenate([[0], np.flatnonzero(change) + 1])
        else:
            boundaries = np.array([0], dtype=np.int64)
        bounds = np.concatenate([boundaries, [n]])
        names = [bytes(blob[starts[b0]:t1[b0]]) for b0 in boundaries]

        # ---- decode genotypes: per-haplotype 1-D gathers + LUT
        H = self.model.n_rows
        alleles = np.empty((H, n), dtype=np.int8)
        fmt = self.geno_format
        for j in range(len(self.sample_data.ind_names)):
            off = int(self._sel_offsets[j])
            w = int(self._sel_widths[j])
            rows = self.model.ind_order[j]
            k = rows.size
            if fmt == "phased":
                if w != 2 * k - 1:
                    raise _FallbackNeeded
                cols = [encoding.BASE_LUT[buf[gstart + off + 2 * a]]
                        for a in range(k)]
            elif fmt in ("pairs", "alleles", "haplo"):
                if w != k:
                    raise _FallbackNeeded
                cols = [encoding.BASE_LUT[buf[gstart + off + a]]
                        for a in range(k)]
            elif fmt == "diplo":
                if w != 1:
                    raise _FallbackNeeded
                b = buf[gstart + off]
                if k == 2:
                    cols = [encoding.DIPLO_LUT_1[b], encoding.DIPLO_LUT_2[b]]
                else:
                    cols = [encoding.DIPLO_HOMO_LUT[b]]
            else:
                raise _FallbackNeeded
            if k == 1:
                c0 = cols[0]
                np.copyto(c0, encoding.MISSING, where=(c0 == encoding._POISON))
                alleles[rows[0], :] = c0
            else:
                bad = cols[0] == encoding._POISON
                for c in cols[1:]:
                    bad |= c == encoding._POISON
                for a, c in enumerate(cols):
                    np.copyto(c, encoding.MISSING, where=bad)
                    alleles[rows[a], :] = c
        return alleles, positions, names, bounds

    def _parse_chunk_slow(self, blob):
        """Per-line fallback, matching reference parseGenoLine semantics
        (split on arbitrary whitespace, genomics.py:1884-1904)."""
        if isinstance(blob, np.ndarray):
            blob = blob.tobytes()
        lines = [ln for ln in blob.split(b"\n") if ln and not ln.startswith(b"#")]
        n = len(lines)
        H = self.model.n_rows
        alleles = np.full((H, n), encoding.MISSING, dtype=np.int8)
        positions = np.empty(n, dtype=np.int64)
        names: list[bytes] = []
        bounds_list: list[int] = []
        fmt = self.geno_format
        for i, ln in enumerate(lines):
            parts = ln.split()
            name = bytes(parts[0])
            if not names or names[-1] != name:
                names.append(name)
                bounds_list.append(i)
            positions[i] = int(parts[1])
            gts = parts[2:]
            for j, col in enumerate(self.ind_cols):
                field = np.frombuffer(gts[col], dtype=np.uint8)[None, :]
                rows = self.model.ind_order[j]
                try:
                    codes = encoding.decode_genotype_fields(field, fmt, rows.size)
                except ValueError:
                    codes = np.full((1, rows.size), encoding.MISSING, np.int8)
                alleles[rows, i] = codes[0]
        bounds = np.array(bounds_list + [n], dtype=np.int64)
        return alleles, positions, names, bounds

    # -------------------------------------------------------- entry points

    def _iter_chunks_fused(self, threads: int, timer):
        """Fused inflate+tokenize over segments of the gzip blob that
        inflate apart (``native.scan_gz_split``): whole members, or one
        member's flush points.

        The sequential gz session inflates on one thread while the
        tokenizer pool waits; here each worker inflates ITS segment and
        tokenizes it at once, so the inflate runs in parallel.  Segment
        boundaries are candidates from a byte scan, so one can be false:
        a segment that fails to inflate from a true start is MERGED with
        its successor and retried (nothing of it has been yielded), which
        recovers exactly.  A segment of a flush-split member that reaches
        back before its start (a dictionary-primed stream) is inflated in
        order, primed with the text before it; true corruption, or a CRC
        or length that the member's trailer does not hold, raises
        RuntimeError like the sequential path.  Returns None to decline
        (the caller uses the sequential session): when the text of the
        segments inflated here ends before the first data line, or when
        the first segment handed to the pool reaches back (pigz's default
        output, whose every segment would)."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        from .native import GZ_BAD, GZ_NEEDS_WINDOW, GZ_OK, _WINDOW
        split = self._gz_split
        segs = deque(split.segments)
        lo = self._sess_leftover
        # decompressed bytes the header reader already consumed
        skip = self._gz_served - (int(lo.size) if lo is not None else 0)
        crc, size, texts = 0, 0, []
        a, b = segs.popleft()
        while True:                       # until the text holds a data line
            with timer.span("parse.inflate"):
                piece = split.inflate(a, b)
            if piece.status != GZ_OK:
                if piece.status == GZ_NEEDS_WINDOW or len(segs) < 2:
                    return None
                b = segs.popleft()[1]     # a false boundary: merge
                continue
            crc = split.accept(crc, piece)
            size += piece.text.size
            texts.append(piece.text)
            full = np.concatenate(texts) if len(texts) > 1 else piece.text
            text = full[skip:]
            cut = _newline(text, last=True) + 1
            if cut and self._ensure_parser(text[:cut]):
                break
            if len(segs) < 2:
                return None               # nearly all header: keep it simple
            a, b = segs.popleft()
        body0, tail0 = text[:cut], text[cut:]
        window = full[-_WINDOW:].copy()

        def split3(arr):
            f = _newline(arr)
            if f < 0:
                return arr, arr[:0], arr[:0]
            last = _newline(arr, last=True)
            return arr[:f + 1], arr[f + 1:last + 1], arr[last + 1:]

        def tokenize(piece):
            head, body, tail = split3(piece.text)
            raw = self.parse_blob_raw(body) if body.size else None
            return piece, head, raw, tail

        def job(a, b):
            with timer.span("parse.segment.inflate"):
                piece = split.inflate(a, b)
            if piece.status != GZ_OK:
                return piece, None, None, None
            with timer.span("parse.segment.tokenize"):
                return tokenize(piece)

        pool = ThreadPoolExecutor(max_workers=threads)
        pending: deque = deque()          # ((a, b), merged, future)

        def fill():
            while segs and len(pending) < threads + 1:
                a, b = segs.popleft()
                pending.append(((a, b), False, pool.submit(job, a, b)))

        def pop_next():
            """The end of the next segment, its pending work dropped."""
            if pending:
                (_, b), _, fut = pending.popleft()
                fut.cancel()
                return b
            return segs.popleft()[1] if segs else None

        fill()
        # this thread tokenizes the text it inflated while the pool starts
        # on the segments after it
        with timer.span("parse.segment.tokenize"):
            raw0 = self.parse_blob_raw(body0)
        if pending:
            # the first segment the pool inflates decides: a stream whose
            # segments reach back would be inflated in order, one by one
            with timer.span("parse.wait_tokenize"):
                if pending[0][2].result()[0].status == GZ_NEEDS_WINDOW:
                    pool.shutdown(wait=False, cancel_futures=True)
                    return None
        # committed: the session's remaining state is re-served from the
        # decompressed offset `skip`
        self._sess_leftover = None
        self._gz_sess = None
        timer.count("text_bytes", text.size)

        def emit(raw):
            if raw is None:
                return
            chunk = self._raw_to_chunk(raw)
            if chunk.positions.size:
                yield chunk

        def in_order(a, b):
            """Inflate [a, b) primed with the text before it, merging
            successors until a boundary holds (the consumer's thread)."""
            while True:
                with timer.span("parse.inflate"):
                    piece = split.inflate(a, b, window.tobytes())
                if piece.status == GZ_OK:
                    return tokenize(piece)
                b = pop_next()
                if b is None:
                    raise RuntimeError(
                        f"gzip stream does not inflate from byte {a}")

        def gen():
            nonlocal crc, size, window
            try:
                yield from emit(raw0)
                prev_tail = tail0
                while pending or segs:
                    fill()
                    (a, b), merged, fut = pending.popleft()
                    with timer.span("parse.wait_tokenize"):
                        piece, head, raw, tail = fut.result()
                    if piece.status == GZ_BAD and (pending or segs):
                        # a false boundary: merge with the successor and
                        # retry; nothing of this segment was yielded
                        b = pop_next()
                        pending.appendleft(
                            ((a, b), True, pool.submit(job, a, b)))
                        continue
                    if piece.status != GZ_OK:
                        piece, head, raw, tail = in_order(a, b)
                        merged = True
                    if split.flushes:
                        timer.count("gz_segments_serial" if merged
                                    else "gz_segments")
                    crc = split.accept(crc, piece)
                    size += piece.text.size
                    window = np.concatenate([window, piece.text[-_WINDOW:]]
                                            )[-_WINDOW:]
                    timer.count("text_bytes", piece.text.size)
                    # copies: the piece's buffer goes back for reuse
                    boundary = np.concatenate([prev_tail, head])
                    prev_tail = tail.copy()
                    split.release(piece)
                    if boundary.size and boundary[-1] != ord("\n"):
                        # the whole segment lacked a newline: keep carrying
                        prev_tail = boundary
                        continue
                    if boundary.size:
                        yield from emit(self.parse_blob_raw(boundary))
                    yield from emit(raw)
                rest = split.finish(piece, crc, size)
                if rest is not None and rest.size:
                    timer.count("text_bytes", rest.size)
                    prev_tail = np.concatenate([prev_tail, rest])
                if prev_tail.size:
                    t = prev_tail
                    if t[-1] != ord("\n"):
                        t = np.concatenate(
                            [t, np.array([ord("\n")], np.uint8)])
                    yield from emit(self.parse_blob_raw(t))
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        return gen()

    def iter_chunks(self, threads: int | None = None, timer=None):
        """Yield parsed chunks in order.

        With ``threads`` > 1 (default: min(4, cpu count) when the native
        tokenizer is active), blob parses run on a thread pool — the ctypes
        tokenizer releases the GIL, so chunk parses genuinely overlap.  Blob
        slicing and scaffold-id assignment stay on the consumer thread, so
        ordering and id stability are preserved by construction.

        ``timer`` (engine.StageTimer) spans each read of text
        (``parse.inflate``) and each wait on the pool
        (``parse.wait_tokenize``), and counts the text's bytes
        (``text_bytes``)."""
        timer = timer or NO_TIMER
        if threads is None:
            threads = min(4, os.cpu_count() or 1)
        if threads > 1 and self._gz_split is not None \
                and self._gz_sess is not None:
            gen = self._iter_chunks_fused(threads, timer)
            if gen is not None:
                yield from gen
                return

        def read():
            with timer.span("parse.inflate"):
                blob = self._read_chunk_lines()
            if blob is not None:
                timer.count("text_bytes", len(blob))
            return blob

        # the first blob must be parsed serially: it establishes the
        # genotype-block layout the workers depend on
        blob = read()
        while blob is not None and not self._ensure_parser(blob):
            blob = read()
        if blob is None:
            return
        if threads <= 1:
            while blob is not None:
                chunk = self._raw_to_chunk(self.parse_blob_raw(blob))
                if chunk.positions.size:
                    yield chunk
                blob = read()
            return
        from concurrent.futures import ThreadPoolExecutor
        from collections import deque
        with ThreadPoolExecutor(max_workers=threads) as ex:
            futs = deque()
            futs.append(ex.submit(self.parse_blob_raw, blob))
            exhausted = False
            while futs:
                while not exhausted and len(futs) < threads + 1:
                    nxt = read()
                    if nxt is None:
                        exhausted = True
                        break
                    futs.append(ex.submit(self.parse_blob_raw, nxt))
                with timer.span("parse.wait_tokenize"):
                    raw = futs.popleft().result()
                chunk = self._raw_to_chunk(raw)
                if chunk.positions.size:
                    yield chunk

    def read_all(self) -> GenoData:
        chunks = list(self.iter_chunks())
        if len(chunks) == 1:
            c = chunks[0]
            return GenoData(alleles=c.alleles, positions=c.positions,
                            scaffold_ids=c.scaffold_ids,
                            scaffold_names=list(self.scaffold_names),
                            model=self.model)
        if chunks:
            alleles = np.concatenate([c.alleles for c in chunks], axis=1)
            positions = np.concatenate([c.positions for c in chunks])
            scaffold_ids = np.concatenate([c.scaffold_ids for c in chunks])
        else:
            alleles = np.empty((self.model.n_rows, 0), np.int8)
            positions = np.empty(0, np.int64)
            scaffold_ids = np.empty(0, np.int32)
        return GenoData(alleles=alleles, positions=positions,
                        scaffold_ids=scaffold_ids,
                        scaffold_names=list(self.scaffold_names),
                        model=self.model)


class _FallbackNeeded(Exception):
    pass


def read_geno(path_or_file, sample_data: SampleData | None = None,
              geno_format: str = "phased", header: str | None = None) -> GenoData:
    reader = GenoReader(path_or_file, sample_data=sample_data,
                        geno_format=geno_format, header=header)
    return reader.read_all()


def rebind_reader(probe: GenoReader, sample_data: SampleData) -> GenoReader:
    """Create a reader bound to a sample subset, continuing from a probe
    reader that already consumed the header (used by CLIs that must read the
    header before resolving populations)."""
    r = GenoReader(probe.f, sample_data=sample_data,
                   geno_format=probe.geno_format,
                   header="\t".join(["#CHROM", "POS"] + probe.file_ind_names))
    r._tail = probe._tail
    r._eof = probe._eof
    r._whole = probe._whole
    r._whole_off = getattr(probe, "_whole_off", 0)
    r._gz_sess = probe._gz_sess
    r._gz_data = probe._gz_data
    r._gz_split = probe._gz_split
    r._gz_served = probe._gz_served
    r._sess_leftover = probe._sess_leftover
    return r
