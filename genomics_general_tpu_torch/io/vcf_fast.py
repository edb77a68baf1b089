"""Fast VCF -> .geno conversion: C line converter + chunk-parallel driver.

The port of genomics_general_tpu/io/vcf_fast.py, with the same functions and
results; it launches no kernel.

The reference's parseVCF is "single threaded, and therefore slow"
(VCF_processing/README.md:31-43); parseVCFs.py exists to fan
tabix chunks over a process pool.  Here the per-line work itself runs in C
(csrc/geno_parser.cpp ``vcf_to_geno_chunk``) and ``-t`` fans decompressed
text chunks over a thread pool (the C call releases the GIL):

* each chunk's conversion is independent given the previous chunk's last
  (CHROM, POS) — recovered EXACTLY by a raw scan of the previous chunk's
  tail, because both duplicate suppression and the parseVCFs stale-drop
  depend only on the last data line's coordinates (stale-dropped lines do
  not update the walk, so the carried state is the running max; see the
  writer-side repair below);
* lines the C converter cannot handle (structural surprises, ploidy
  mismatches that must raise) BAIL individually: the worker re-parses just
  that line with the full Python VcfSite path and resumes C after it, so
  semantics are identical line by line;
* the in-order writer repairs the one cross-chunk ambiguity of the
  stale-drop mode by dropping a chunk's leading rows with POS <= the true
  running max (C's kept rows are strictly increasing per scaffold, so this
  reproduces the sequential walk exactly), then applies include/exclude per
  scaffold run and writes.
"""

from __future__ import annotations

import ctypes
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from . import native


@dataclass
class FastVcfOpts:
    n_samples: int
    sel: np.ndarray                  # int32 sample column picks (in order)
    ploidy: np.ndarray               # int32 per selected sample
    missing: bytes
    skip_indels: bool = False
    keep_partial: bool = False
    ploidy_mismatch_to_missing: bool = False
    add_ref: bool = False
    drop_dups: bool = False
    sorted_drop: bool = False
    min_qual: float = float("nan")
    max_ref_len: int = 0
    filt_flags: list = field(default_factory=list)   # list[(bytes, min, max)]
    out_sep: bytes = b"\t"


def ineligible_reason(args, gt_filters, n_samples: int) -> str | None:
    """None if the C fast path can handle this CLI configuration, else a
    human-readable reason.  Anything outside the common case falls back to
    the Python VcfSite pipeline wholesale (callers log the reason — a
    silent >10x perf cliff costs users real hours)."""
    if native.get_lib() is None or \
            not hasattr(native.get_lib(), "vcf_to_geno_chunk"):
        return "native library unavailable"
    if getattr(args, "field", None):
        return "--field needs the Python pipeline"
    if getattr(args, "expandMulti", False):
        return "--expandMulti needs the Python pipeline"
    if getattr(args, "simplifyALT", False):
        return "--simplifyALT needs the Python pipeline"
    if len(args.outSep) != 1:
        return "multi-character --outSep"
    if n_samples > 1024:
        return f"{n_samples} samples > 1024"
    if len(gt_filters) > 8:
        return f"{len(gt_filters)} genotype filters > 8"
    for f in gt_filters:
        for k in ("siteTypes", "gtTypes", "samples"):
            if k in f:
                return f"genotype filter with {k}= needs the Python pipeline"
    return None


def eligible(args, gt_filters, n_samples: int) -> bool:
    return ineligible_reason(args, gt_filters, n_samples) is None


def notice_fallback(tool: str, reason: str):
    import sys
    sys.stderr.write(f"[info] {tool}: C fast path disabled ({reason}); "
                     "using the per-line Python pipeline\n")


def make_opts(args, gt_filters, head_samples, samples, ploidy_dict) -> FastVcfOpts:
    sel = np.array([head_samples.index(s) for s in samples], dtype=np.int32)
    ploidy = np.array([ploidy_dict[s] for s in samples], dtype=np.int32)
    missing = (args.missing if args.missing else "N").encode()
    return FastVcfOpts(
        n_samples=len(head_samples), sel=sel, ploidy=ploidy, missing=missing,
        skip_indels=bool(args.skipIndels),
        keep_partial=bool(args.keepPartial),
        ploidy_mismatch_to_missing=bool(args.ploidyMismatchToMissing),
        add_ref=bool(getattr(args, "addRefTrack", False)),
        drop_dups=bool(getattr(args, "excludeDuplicates", False)),
        min_qual=float(args.minQual) if args.minQual else float("nan"),
        max_ref_len=int(args.maxREFlen) if args.maxREFlen else 0,
        filt_flags=[(f["flag"].encode(), float(f["min"]), float(f["max"]))
                    for f in gt_filters],
        out_sep=args.outSep.encode())


def _tail_coords(chunk: bytes):
    """(CHROM, POS-int, POS-raw-bytes) of the last data line of a raw text
    chunk, or None if the chunk has no data line.  The raw POS bytes matter
    because the reference compares duplicate positions as TEXT
    (parseVCF.py parseVcfSites: elements[1] == lastPos), so '0100' and
    '100' are distinct positions for --excludeDuplicates."""
    end = len(chunk)
    while end > 0:
        nl = chunk.rfind(b"\n", 0, end - 1)
        line = chunk[nl + 1:end]
        end = nl + 1
        if not line or line.startswith(b"#") or line == b"\n":
            continue
        parts = line.split(b"\t", 2)
        if len(parts) >= 2:
            try:
                return parts[0], int(parts[1]), parts[1]
            except ValueError:
                return None
        return None
    return None


def convert_chunk(chunk, opts: FastVcfOpts, prev_name: bytes | None,
                  prev_pos: int, slow_line, prev_ptext: bytes | None = None):
    """Convert one decompressed text chunk.

    Returns (segments, final_name, final_pos, final_ptext) where segments
    is an ordered list of (scaffold_name_bytes, bytes) runs.
    ``slow_line(line_bytes, prev_name, prev_pos, prev_ptext)`` handles a
    bail line with the full Python path; it receives and returns
    (row_bytes_or_None, name, pos, pos_text) given the current walk state.
    ``prev_ptext`` is the raw POS bytes of the previous data line when they
    are NOT the canonical decimal form of ``prev_pos`` (None = canonical);
    lines the C converter consumes always have canonical POS (non-canonical
    ones bail), so only slow_line and cross-chunk raw tails can set it.
    """
    lib = native.get_lib()
    if isinstance(chunk, np.ndarray):
        chunk = chunk.tobytes()
    flags_blob = b"".join(f[0] for f in opts.filt_flags)
    flag_lens = np.array([len(f[0]) for f in opts.filt_flags] or [0],
                         dtype=np.int64)
    fmin = np.array([f[1] for f in opts.filt_flags] or [0.0])
    fmax = np.array([f[2] for f in opts.filt_flags] or [0.0])
    segments: list = []
    out_prev = None

    def add_segment(name, data):
        if segments and segments[-1][0] == name:
            segments[-1][1].extend(data)
        else:
            segments.append((name, bytearray(data)))

    i = 0
    n = len(chunk)
    out = np.empty(max(2 * n + (1 << 16), 1 << 20), dtype=np.uint8)
    breaks = np.empty(4 * 65536, dtype=np.int64)
    while i < n:
        sub = chunk[i:]
        nb = ctypes.c_int64(0)
        consumed = ctypes.c_int64(0)
        written = ctypes.c_int64(0)
        ppos = ctypes.c_int64(0)
        # duplicate suppression compares POS as text in the reference; when
        # the carried previous POS text is non-canonical the C converter's
        # integer compare could wrongly drop a canonical line, so disarm it
        # (a canonical current POS can never text-equal a non-canonical
        # previous one; a non-canonical current POS bails to slow_line,
        # which does the text compare itself)
        c_prev_pos = prev_pos
        if opts.drop_dups and prev_ptext is not None and \
                prev_ptext != str(prev_pos).encode():
            c_prev_pos = -1
        ret = lib.vcf_to_geno_chunk(
            ctypes.cast(ctypes.c_char_p(sub), ctypes.c_void_p),
            np.int64(len(sub)),
            np.int32(opts.n_samples), opts.sel, np.int32(opts.sel.size),
            opts.ploidy,
            opts.missing, np.int64(len(opts.missing)),
            np.int32(opts.skip_indels), np.int32(opts.keep_partial),
            np.int32(opts.ploidy_mismatch_to_missing), np.int32(opts.add_ref),
            np.int32(opts.drop_dups), np.int32(opts.sorted_drop),
            ctypes.c_double(opts.min_qual), np.int64(opts.max_ref_len),
            np.int32(len(opts.filt_flags)), flags_blob, flag_lens, fmin, fmax,
            ctypes.c_uint8(opts.out_sep[0]),
            prev_name, np.int64(len(prev_name) if prev_name else 0),
            np.int64(c_prev_pos),
            out_prev, np.int64(len(out_prev) if out_prev else 0),
            out, np.int64(out.size),
            breaks, np.int64(65536),
            ctypes.byref(nb), ctypes.byref(consumed), ctypes.byref(written),
            ctypes.byref(ppos))
        # slice output into scaffold runs
        w = written.value
        k = nb.value
        for b in range(k):
            name = sub[breaks[4 * b + 1]:breaks[4 * b + 1] + breaks[4 * b + 2]]
            o0 = breaks[4 * b + 3]
            o1 = breaks[4 * (b + 1) + 3] if b + 1 < k else w
            add_segment(name, out[o0:o1].tobytes())
        if k == 0 and w and out_prev is not None:
            add_segment(out_prev, out[:w].tobytes())
        if k:
            out_prev = segments[-1][0]
        c = consumed.value
        # walk state after the consumed region: scaffold = last seen line's
        # CHROM; position = C's exact carry (the running max in stale-drop
        # mode — stale lines do not update it).  Consumed lines always have
        # canonical POS text, so the text carry resets.
        if c:
            tc = _tail_coords(sub[:c])
            if tc is not None:
                prev_name = tc[0]
            prev_pos = ppos.value
            prev_ptext = None
        if ret == 0:
            break
        if ret == -5:                      # output full: resume
            if c == 0:
                # not even one line fits the worst-case output estimate
                # (e.g. a tiny tail chunk of a many-sample VCF with long
                # ALT alleles): grow the buffer instead of spinning
                out = np.empty(out.size * 2, dtype=np.uint8)
            i += c
            continue
        if ret == -1:                      # break table full: flush + resume
            if c == 0:
                raise RuntimeError(
                    "vcf_to_geno_chunk: break table overflow with no "
                    "progress")
            i += c
            continue
        # bail line at sub[ret-1 ...]: full Python path for this one line
        ls = ret - 1
        if c != ls:
            raise RuntimeError("vcf_to_geno_chunk consumed != bail offset")
        le = sub.find(b"\n", ls)
        le = len(sub) if le < 0 else le + 1
        line = sub[ls:le]
        row, nm, ps, ptx = slow_line(line, prev_name, prev_pos, prev_ptext)
        if row is not None:
            add_segment(nm, row)
            out_prev = nm
        prev_name, prev_pos, prev_ptext = nm, ps, ptx
        i += le
    return segments, prev_name, prev_pos, prev_ptext


def text_chunks(path_or_stream, chunk_bytes: int | None = None):
    """Yield line-aligned decompressed text chunks of a VCF.

    ``path_or_stream``: a path (gz-aware; .gz goes through the C streaming
    decompressor when available) or a binary stream (stdin).  Comment lines
    pass through — the C converter skips them, so the header needs no
    separate consumption.  GGT_VCF_CHUNK: test hook forcing tiny chunks (so
    boundary-repair paths get exercised)."""
    import gzip as _gzip
    import os

    if chunk_bytes is None:
        chunk_bytes = int(os.environ.get("GGT_VCF_CHUNK", 16 << 20))

    if isinstance(path_or_stream, str):
        if path_or_stream.endswith(".gz"):
            with open(path_or_stream, "rb") as f:
                blob = f.read()
            try:
                sess = native.GzChunkStream(blob, chunk_bytes)
            except RuntimeError:
                sess = None
            if sess is not None:
                yielded = False
                while True:
                    try:
                        c = sess.next_chunk()
                    except RuntimeError:
                        # mid-stream failure (e.g. a single line beyond the
                        # C scanner's tail cap): once chunks have been
                        # yielded, restarting from the blob would duplicate
                        # them — propagate instead
                        if yielded:
                            raise
                        break
                    if c is None:
                        return
                    yielded = True
                    yield c
            stream = _gzip.GzipFile(fileobj=__import__("io").BytesIO(blob))
        else:
            stream = open(path_or_stream, "rb")
    else:
        stream = path_or_stream
    carry = b""
    while True:
        data = stream.read(chunk_bytes)
        if not data:
            if carry:
                yield carry + b"\n" if not carry.endswith(b"\n") else carry
            return
        data = carry + data
        nl = data.rfind(b"\n")
        if nl < 0:
            carry = data
            continue
        carry = data[nl + 1:]
        yield data[:nl + 1]


def stdin_header_chunks(stream, chunk_bytes: int = 16 << 20):
    """Read header chunks from a stream until the #CHROM line is seen.

    Returns (head_data, chunks) where ``chunks`` replays the buffered
    chunks then continues the stream (comment lines pass through — the C
    converter skips them); (None, None) if no #CHROM line appears in the
    first 64 MB (caller falls back)."""
    import io as _io

    from .vcf import parse_header_lines

    gen = text_chunks(stream, chunk_bytes)
    buf: list = []
    blob = b""
    head = None
    for c in gen:
        c = c.tobytes() if isinstance(c, np.ndarray) else c
        buf.append(c)
        blob += c
        if b"#CHROM" in blob:
            head = parse_header_lines(_io.BytesIO(blob))
            if "mainHead" in head:
                break
        if len(blob) > 64 << 20:
            return None, None

    if head is None or "mainHead" not in head:
        return None, None

    def chain():
        yield from buf
        yield from gen

    return head, chain()


def convert_stream(chunks, opts: FastVcfOpts, slow_line, emit_run,
                   threads: int = 1, pool: ThreadPoolExecutor | None = None):
    """Drive the whole stream: chunk-parallel C conversion, in-order writer.

    ``chunks``: iterable of decompressed text chunks (bytes / uint8 arrays,
    line-aligned).  ``emit_run(name_bytes, data_bytes)`` receives ordered
    scaffold runs (caller applies include/exclude and writes).  ``pool``:
    optional shared executor — multi-file drivers pass one so ``-t`` bounds
    the TOTAL converter thread count across files (the pool is not shut
    down here); ``threads`` then only sizes this stream's in-flight window.
    """
    if threads <= 1 and pool is None:
        prev_name, prev_pos, prev_ptext = None, -1, None
        for chunk in chunks:
            segs, prev_name, prev_pos, prev_ptext = convert_chunk(
                chunk, opts, prev_name, prev_pos, slow_line, prev_ptext)
            for name, data in segs:
                emit_run(name, bytes(data))
        return

    own_pool = pool is None
    if own_pool:
        pool = ThreadPoolExecutor(max_workers=threads)
    threads = max(1, threads)
    pending: deque = deque()
    # authoritative per-scaffold running position max for the stale-drop
    # repair.  A worker's raw-tail start state can underestimate (the
    # previous chunk's last line may itself have been stale-dropped), but
    # chaining max(prior, worker's returned final position) per scaffold
    # reconstructs the true sequential walk state exactly: both walks
    # consume identical lines above the true max, the under-walk's extra
    # consumptions are all at or below it, and a fresh scaffold inside a
    # chunk is exact by construction
    auth = {"name": None, "pos": -1}

    def repair_and_emit(segs, final_name, final_pos):
        prior_name, prior_pos = auth["name"], auth["pos"]
        for name, data in segs:
            data = bytes(data)
            if opts.sorted_drop and name == prior_name and prior_pos >= 0:
                # drop leading rows with POS <= the true running max (kept
                # rows are strictly increasing per scaffold, so this
                # reproduces the sequential walk exactly)
                off = 0
                while off < len(data):
                    nl = data.find(b"\n", off)
                    if nl < 0:
                        break
                    parts = data[off:nl].split(opts.out_sep, 2)
                    if len(parts) >= 2 and int(parts[1]) > prior_pos:
                        break
                    off = nl + 1
                data = data[off:]
                if not data:
                    continue
            else:
                # a different scaffold appeared: the prior boundary state
                # no longer applies within this chunk
                prior_name = None
            emit_run(name, data)
        if final_name is not None:
            if final_name == auth["name"]:
                auth["pos"] = max(auth["pos"], final_pos)
            else:
                auth["name"], auth["pos"] = final_name, final_pos

    prev_raw_tail = (None, -1, None)
    for chunk in chunks:
        if isinstance(chunk, np.ndarray):
            chunk = chunk.tobytes()
        fut = pool.submit(convert_chunk, chunk, opts,
                          prev_raw_tail[0], prev_raw_tail[1], slow_line,
                          prev_raw_tail[2])
        tc = _tail_coords(chunk)
        if tc is not None:
            name, ipos, ptext = tc
            # carry the raw POS bytes only when non-canonical (the text-
            # compare duplicate check needs them; see _tail_coords)
            canon = ptext == str(ipos).encode()
            prev_raw_tail = (name, ipos, None if canon else ptext)
        pending.append(fut)
        while pending and (len(pending) > threads + 1 or pending[0].done()):
            segs, fname, fpos, _ = pending.popleft().result()
            repair_and_emit(segs, fname, fpos)
    while pending:
        segs, fname, fpos, _ = pending.popleft().result()
        repair_and_emit(segs, fname, fpos)
    if own_pool:
        pool.shutdown()
