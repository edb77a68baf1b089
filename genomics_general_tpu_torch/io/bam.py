"""Minimal pure-Python BGZF/BAM reading and writing.

Replaces the reference's pysam dependency
(SAM_processing/filterSAMbyTargetBase.py) in environments
without htslib: enough of the BAM spec (SAM v1 §4) to stream alignment
records, compute aligned pairs from CIGAR, and write records back out.
No random access / BAI indexing — callers stream and filter.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

SEQ_CHARS = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"


def bgzf_blocks(data: bytes):
    """Yield decompressed BGZF block payloads."""
    off = 0
    n = len(data)
    while off < n:
        if n - off < 18:
            break
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        # find BSIZE in extra subfields
        extra = data[off + 12:off + 12 + xlen]
        bsize = None
        p = 0
        while p + 4 <= len(extra):
            si1, si2, slen = extra[p], extra[p + 1], \
                struct.unpack_from("<H", extra, p + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, p + 4)[0]
            p += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF block")
        comp = data[off + 12 + xlen:off + bsize + 1 - 8]
        yield zlib.decompress(comp, -15)
        off += bsize + 1


def bgzf_compress(payload: bytes) -> bytes:
    """One BGZF block for payload (<= 64KB)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
              struct.pack("<H", 6) + b"BC" + struct.pack("<H", 2) +
              struct.pack("<H", bsize - 1))
    return header + comp + struct.pack("<I", zlib.crc32(payload)) + \
        struct.pack("<I", len(payload))


@dataclass
class BamRecord:
    ref_id: int
    pos: int                 # 0-based
    read_name: str
    flag: int
    mapq: int
    cigar: list              # [(op_char, length)]
    seq: str
    raw: bytes               # the full record bytes (without block_size)

    def aligned_pairs(self):
        """(query_pos, ref_pos) pairs, None for gaps — matches
        pysam.AlignedSegment.get_aligned_pairs for M/I/D/N/S/=/X ops."""
        out = []
        q = 0
        r = self.pos
        for op, ln in self.cigar:
            if op in "M=X":
                for k in range(ln):
                    out.append((q + k, r + k))
                q += ln
                r += ln
            elif op in "IS":
                for k in range(ln):
                    out.append((q + k, None))
                q += ln
            elif op in "DN":
                for k in range(ln):
                    out.append((None, r + k))
                r += ln
            # H and P consume nothing
        return out


class BamReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        self._stream = b"".join(bgzf_blocks(data))
        assert self._stream[:4] == b"BAM\x01", "not a BAM file"
        l_text = struct.unpack_from("<i", self._stream, 4)[0]
        self.header_text = self._stream[8:8 + l_text].decode()
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", self._stream, off)[0]
        off += 4
        self.ref_names = []
        self.ref_lengths = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", self._stream, off)[0]
            self.ref_names.append(
                self._stream[off + 4:off + 4 + l_name - 1].decode())
            self.ref_lengths.append(
                struct.unpack_from("<i", self._stream, off + 4 + l_name)[0])
            off += 8 + l_name
        self._records_off = off
        # the raw header region (BAM magic .. end of refs) for re-emission
        self.raw_header = self._stream[:off]

    def records(self):
        off = self._records_off
        s = self._stream
        n = len(s)
        while off + 4 <= n:
            block_size = struct.unpack_from("<i", s, off)[0]
            raw = s[off + 4:off + 4 + block_size]
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _next_ref, _next_pos, _tlen) = struct.unpack_from(
                "<iiBBHHHiiii", raw, 0)
            name = raw[32:32 + l_read_name - 1].decode()
            coff = 32 + l_read_name
            cigar = []
            for k in range(n_cigar):
                v = struct.unpack_from("<I", raw, coff + 4 * k)[0]
                cigar.append((CIGAR_OPS[v & 0xF], v >> 4))
            soff = coff + 4 * n_cigar
            seq_bytes = raw[soff:soff + (l_seq + 1) // 2]
            seq = "".join(SEQ_CHARS[(b >> 4) if k % 2 == 0 else (b & 0xF)]
                          for k in range(l_seq)
                          for b in [seq_bytes[k // 2]])
            yield BamRecord(ref_id, pos, name, flag, mapq, cigar, seq, raw)
            off += 4 + block_size


class BamWriter:
    def __init__(self, path: str, raw_header: bytes):
        self.f = open(path, "wb")
        self._buf = bytearray(raw_header)
        self._flush_full()

    def _flush_full(self):
        while len(self._buf) >= 60000:
            self.f.write(bgzf_compress(bytes(self._buf[:60000])))
            del self._buf[:60000]

    def write_record(self, rec: BamRecord):
        self._buf += struct.pack("<i", len(rec.raw)) + rec.raw
        self._flush_full()

    def close(self):
        if self._buf:
            self.f.write(bgzf_compress(bytes(self._buf)))
        self.f.write(BGZF_EOF)
        self.f.close()
