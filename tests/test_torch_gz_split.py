"""One gzip member split at its flush points (io/csrc/gzsplit.cpp,
``native.GzFlushes``), inflated and tokenized segment by segment on the
reader's pool: the chunks it serves (alleles, positions, scaffold ids) are
the sequential gz session's for every shape of stream, its counters say
which segments went in parallel and which in order, and a CRC or length
that the trailer does not hold raises.  The port's own ``.gz`` writers
(``io/writers.PiecedGzipFile``) write such streams."""

import gzip
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from genomics_general_tpu_torch import engine
from genomics_general_tpu_torch.cli import parse_vcf, popgen_windows
from genomics_general_tpu_torch.io import geno as geno_io
from genomics_general_tpu_torch.io import native, writers
from genomics_general_tpu_torch.testing import simulate_geno_bytes

HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"


@pytest.fixture(scope="module")
def text():
    data, _ = simulate_geno_bytes(n_sites=6000, n_scaffolds=3,
                                  scaffold_len=200_000, seed=7)
    return data


@pytest.fixture(autouse=True)
def small_segments(monkeypatch):
    """Segments of 4 kB, and the port's writers' pieces of 16 kB."""
    monkeypatch.setattr(native.ParallelGzChunks, "SEG_MIN", 4096)
    monkeypatch.setattr(writers.PiecedGzipFile, "PIECE", 16384)


def line_pieces(data: bytes, n_lines: int) -> list[bytes]:
    """The header line, then pieces of ``n_lines`` whole lines."""
    lines = data.splitlines(keepends=True)
    return [lines[0]] + [b"".join(lines[i:i + n_lines])
                         for i in range(1, len(lines), n_lines)]


def member(pieces, primed=lambda i: False, level=lambda i: 6) -> bytes:
    """One gzip member of independently deflated pieces, each ended by a
    sync flush (``pigz -i``); a piece for which ``primed(i)`` holds is
    deflated with the 32 KB of text before it as its dictionary (pigz's
    default); piece i at zlib level ``level(i)`` (0: stored)."""
    out, crc, size, before = [HEADER], 0, 0, b""
    for i, p in enumerate(pieces):
        zdict = before[-32768:] if primed(i) and before else None
        c = zlib.compressobj(level(i), zlib.DEFLATED, -15, zdict=zdict) \
            if zdict else zlib.compressobj(level(i), zlib.DEFLATED, -15)
        out.append(c.compress(p) + c.flush(zlib.Z_SYNC_FLUSH))
        crc, size = zlib.crc32(p, crc), size + len(p)
        before = (before + p)[-32768:]
    out.append(zlib.compressobj(6, zlib.DEFLATED, -15).flush(zlib.Z_FINISH))
    out.append(struct.pack("<II", crc, size & 0xFFFFFFFF))
    return b"".join(out)


def read(path, monkeypatch, split: bool):
    """Every chunk of ``path`` joined, the scaffold names and the
    counters; ``split`` False takes the sequential gz session."""
    with monkeypatch.context() as mp:
        mp.setenv("GGT_FUSED_GZ", "1" if split else "0")
        timer = engine.StageTimer(True)
        reader = geno_io.GenoReader(str(path))
        chunks = list(reader.iter_chunks(threads=4, timer=timer))
    return (np.concatenate([c.alleles for c in chunks], axis=1),
            np.concatenate([c.positions for c in chunks]),
            np.concatenate([c.scaffold_ids for c in chunks]),
            reader.scaffold_names, timer)


def check(tmp_path, monkeypatch, gz: bytes, expect: str):
    """The split reader serves the sequential session's chunks; return its
    timer.  ``expect``: ``split`` (gz_segments > 0), ``declined`` or
    ``none`` (no flush split found)."""
    path = tmp_path / "t.geno.gz"
    path.write_bytes(gz)
    got = read(path, monkeypatch, True)
    want = read(path, monkeypatch, False)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    counters = got[4].counters
    # the session counts the newline it adds to a last line without one
    assert counters["text_bytes"] in (want[4].counters["text_bytes"],
                                      want[4].counters["text_bytes"] - 1)
    assert want[4].counters.get("gz_segments", 0) == 0
    if expect == "split":
        assert counters["gz_segments"] > 0
    else:
        assert counters.get("gz_segments", 0) == 0
        assert counters.get("gz_segments_serial", 0) == 0
        is_flushes = isinstance(native.scan_gz_split(gz), native.GzFlushes)
        assert is_flushes == (expect == "declined")
    return got[4]


def plain_scan(data: bytes, start: int, seg_min: int, kind: int):
    """``gzsplit.cpp``'s scan as a plain search: kind 1, the offsets after
    ``00 00 FF FF``; kind 0, gzip member headers."""
    pat = b"\x00\x00\xff\xff" if kind else b"\x1f\x8b\x08"
    bounds = [start]
    i = data.find(pat, start)
    while i >= 0:
        c = i + 4 if kind else i
        if (kind or (i + 3 < len(data) and data[i + 3] < 0x20)) \
                and c > start and c - bounds[-1] >= seg_min \
                and len(data) - c >= seg_min:
            bounds.append(c)
        i = data.find(pat, i + 1)
    bounds.append(len(data))
    return list(zip(bounds[:-1], bounds[1:])) if len(bounds) >= 4 else None


@pytest.mark.parametrize("kind", [0, 1])
def test_scan_matches_a_plain_search(kind):
    rng = np.random.default_rng(3 + kind)
    pats = [b"\x00\x00\xff\xff", b"\x00\xff\xff\xff", b"\x00\x00\x00\xff\xff",
            b"\x1f\x8b\x08\x00", b"\x1f\x8b\x08\x1f\x8b\x08\x04",
            b"\x1f\x8b\x08\x20", b"\x1f\x8b\x08"]
    parts = []
    for _ in range(3000):
        parts.append(rng.integers(0, 256, int(rng.integers(0, 40)),
                                  dtype=np.uint8).tobytes())
        parts.append(pats[int(rng.integers(0, len(pats)))])
    data = b"".join(parts)
    for start in (0, 1, 5, 17):
        for seg_min in (1, 7, 64, 5000):
            for end in (len(data), len(data) - 1, len(data) - 3):
                assert native._scan(data[:end], start, seg_min, kind) \
                    == plain_scan(data[:end], start, seg_min, kind)


def test_independent_pieces_inflate_in_parallel(tmp_path, monkeypatch,
                                                 text):
    gz = member(line_pieces(text, 300))
    assert gzip.decompress(gz) == text
    timer = check(tmp_path, monkeypatch, gz, "split")
    assert timer.counters.get("gz_segments_serial", 0) == 0
    # the pool's workers inflate off the consumer's thread, which inflates
    # only the first segment
    inflaters = {s.thread for s in timer.spans
                 if s.name == "parse.segment.inflate"}
    consumer = {s.thread for s in timer.spans if s.name == "parse.inflate"}
    assert inflaters and len(consumer) == 1 and not inflaters & consumer
    assert "parse.segment.tokenize" in {s.name for s in timer.spans}


def test_primed_stream_declines(tmp_path, monkeypatch, text):
    check(tmp_path, monkeypatch,
          member(line_pieces(text, 300), primed=lambda i: True), "declined")


def test_later_primed_pieces_inflate_in_order(tmp_path, monkeypatch, text):
    gz = member(line_pieces(text, 300), primed=lambda i: i >= 6)
    timer = check(tmp_path, monkeypatch, gz, "split")
    assert timer.counters["gz_segments_serial"] > 0


def test_plain_gzip_is_not_split(tmp_path, monkeypatch, text):
    check(tmp_path, monkeypatch, gzip.compress(text, mtime=0), "none")


def test_members_keep_the_member_path(tmp_path, monkeypatch, text):
    gz = b"".join(gzip.compress(text[i:i + 20000], mtime=0)
                  for i in range(0, len(text), 20000))
    assert isinstance(native.scan_gz_split(gz), native.GzMembers)
    check(tmp_path, monkeypatch, gz, "none")


def test_false_candidate_in_stored_block_is_merged(tmp_path, monkeypatch,
                                                   text):
    """A comment line holding ``00 00 FF FF``, stored (level 0): the scan
    takes the offset after it for a boundary, which the segment before it
    disproves."""
    pieces = line_pieces(text, 300)
    trap = b"#" + b"x" * 5000 + b"\x00\x00\xff\xff" + b"x" * 6000 + b"\n"
    gz = member(pieces[:5] + [trap] + pieces[5:],
                level=lambda i: 0 if i == 5 else 6)
    false = gz.index(b"\x00\x00\xff\xffxxxx") + 4
    assert false in {a for a, _ in native.scan_gz_split(gz).segments}
    timer = check(tmp_path, monkeypatch, gz, "split")
    assert timer.counters["gz_segments_serial"] >= 1


def test_lines_straddle_segments(tmp_path, monkeypatch, text):
    step = 7001
    pieces = [text[i:i + step] for i in range(0, len(text), step)]
    check(tmp_path, monkeypatch, member(pieces), "split")


def test_header_only_first_segment(tmp_path, monkeypatch, text):
    monkeypatch.setattr(native.ParallelGzChunks, "SEG_MIN", 64)
    pieces = line_pieces(text, 300)
    gz = member(pieces)
    first = native.scan_gz_split(gz).segments[0]
    assert zlib.decompressobj(-15).decompress(gz[first[0]:first[1]]) \
        == pieces[0]
    check(tmp_path, monkeypatch, gz, "split")


def test_no_trailing_newline(tmp_path, monkeypatch, text):
    check(tmp_path, monkeypatch, member(line_pieces(text[:-1], 300)),
          "split")


def test_tiny_chunk_bytes(tmp_path, monkeypatch, text):
    monkeypatch.setenv("GGT_CHUNK_BYTES", "1024")
    check(tmp_path, monkeypatch, member(line_pieces(text, 300)), "split")


def test_members_after_the_split_member(tmp_path, monkeypatch, text):
    half = text.index(b"\n", len(text) // 2) + 1
    gz = member(line_pieces(text[:half], 300)) \
        + gzip.compress(text[half:], mtime=0)
    check(tmp_path, monkeypatch, gz, "split")


@pytest.mark.parametrize("where", ["trailer_crc", "stored_text"])
def test_corrupt_stream_raises(tmp_path, monkeypatch, text, where):
    """A flipped byte of the trailer's CRC, or of a genotype in a stored
    piece (which inflates, to other text): the trailer does not hold."""
    pieces = line_pieces(text, 300)
    gz = bytearray(member(pieces, level=lambda i: 0 if i == 3 else 6))
    if where == "trailer_crc":
        gz[-8] ^= 0x01
    else:
        at = gz.index(pieces[3][:200]) + pieces[3].index(b"|", 150) - 1
        assert gz[at:at + 1] in (b"A", b"C", b"G", b"T", b"N")
        gz[at] = ord("A") if gz[at] != ord("A") else ord("C")
    path = tmp_path / "bad.geno.gz"
    path.write_bytes(bytes(gz))
    # a header chunk smaller than the member, so the session that reads
    # the header does not meet the fault first
    monkeypatch.setenv("GGT_CHUNK_BYTES", "4096")
    with pytest.raises(RuntimeError, match="trailer"):
        read(path, monkeypatch, True)


@pytest.mark.parametrize("mode", ["wt", "wb"])
def test_port_writer_pieces_inflate_in_parallel(tmp_path, monkeypatch, text,
                                                mode):
    """``writers.open_gz_out`` writes one member that gzip reads back, in
    pieces that the reader inflates in parallel."""
    path = tmp_path / "w.geno.gz"
    with writers.open_gz_out(str(path), mode) as f:
        for i in range(0, len(text), 5000):
            piece = text[i:i + 5000]
            f.write(piece.decode() if mode == "wt" else piece)
    gz = path.read_bytes()
    assert gzip.decompress(gz) == text
    assert gz.count(b"\x00\x00\xff\xff") >= len(text) // 16384
    timer = check(tmp_path, monkeypatch, gz, "split")
    assert timer.counters.get("gz_segments_serial", 0) == 0


def test_parse_vcf_output_inflates_in_parallel(tmp_path, monkeypatch):
    """parseVCF's ``.geno.gz``: the same text as its plain output, and read
    in parallel segments (pieces and segments cut to the small file)."""
    monkeypatch.setattr(writers.PiecedGzipFile, "PIECE", 2048)
    monkeypatch.setattr(native.ParallelGzChunks, "SEG_MIN", 1024)
    vcf = str(Path(__file__).parent / "data" / "sim1.vcf.gz")
    gz_out, plain_out = tmp_path / "p.geno.gz", tmp_path / "p.geno"
    for out in (gz_out, plain_out):
        parse_vcf.main(["-i", vcf, "-o", str(out)])
    gz = gz_out.read_bytes()
    assert gzip.decompress(gz) == plain_out.read_bytes()
    timer = check(tmp_path, monkeypatch, gz, "split")
    assert timer.counters.get("gz_segments_serial", 0) == 0


@pytest.mark.parametrize("writer", ["pieces", "port"])
def test_popgen_windows_csv_matches_plain_gzip(tmp_path, monkeypatch,
                                               capsys, writer):
    """popgenWindows' CSV from a split stream (independent pieces, or the
    port's own writer) is byte-equal to plain gzip's."""
    data, inds = simulate_geno_bytes(n_sites=4000, n_scaffolds=2,
                                     scaffold_len=400_000, seed=11)
    pops = tmp_path / "pops.txt"
    pops.write_text("".join(f"{n}\tpop{i // 5 + 1}\n"
                            for i, n in enumerate(inds)))
    split, plain = tmp_path / "split.geno.gz", tmp_path / "plain.geno.gz"
    if writer == "pieces":
        split.write_bytes(member(line_pieces(data, 250)))
    else:
        with writers.open_gz_out(str(split), "wb") as f:
            f.write(data)
    plain.write_bytes(gzip.compress(data, mtime=0))
    monkeypatch.setenv("GGT_DEVICE", "cpu")
    outs = []
    for g in (split, plain):
        out = tmp_path / f"{g.stem}.csv"
        assert popgen_windows.main(
            ["-g", str(g), "-f", "phased", "-w", "50000", "-m", "10",
             "-p", "pop1", "-p", "pop2", "--popsFile", str(pops),
             "--analysis", "popDist", "popPairDist", "--profile",
             "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 10
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("[profile]")]
    assert len(lines) == 2
    assert "gz_segments=" in lines[0] and "gz_segments" not in lines[1]
    n = int(lines[0].split("gz_segments=")[1].split()[0].rstrip("]"))
    assert n > 0
