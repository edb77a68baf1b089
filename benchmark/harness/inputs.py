"""A cell's input files, made from the seed and kept in a per-seed cache.

The ``.geno.gz`` is one gzip member, as ``gzip`` writes a stream at its
default level 6.  Its deflate blocks are compressed in parallel, a piece of
text each, every piece ended by a sync flush so that they join into one
stream (as ``pigz`` does); the text itself is formatted on the device.

The cache lives in ``benchmark/.cache/`` (gitignored), a directory per
(configuration, sites, seed), named with a digest of every source that
shapes the bytes, so a changed generator never hits an old entry.  At most
``KEEP`` entries are kept."""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import shutil
import struct
import time
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import spec
from ..gen import _common as C

KEEP = 6
LEVEL = 6


@dataclass
class Inputs:
    geno: Path
    pops: Path
    made_s: float | None          # seconds spent making them, None on a hit


def _digest(cfg: dict) -> str:
    h = hashlib.sha256()
    for path in (spec.generator_path(cfg["generator"]),
                 spec.ROOT / "gen" / "_common.py", Path(__file__)):
        h.update(path.read_bytes())
    h.update(json.dumps(cfg, sort_keys=True).encode())
    return h.hexdigest()[:12]


def format_rows(codes: torch.Tensor, fmt: str) -> np.ndarray:
    """The genotype block of each site as text, on the device: uint8
    [sites, bytes], tab-separated calls ending in a newline."""
    lut = torch.tensor(list(b"ACGTN"), dtype=torch.uint8, device=codes.device)
    b = lut[codes.long()]
    n, H = b.shape
    if fmt != "phased":
        raise ValueError(f"no text writer for genotype format {fmt!r}")
    t = torch.empty((n, H // 2, 4), dtype=torch.uint8, device=codes.device)
    t[:, :, 0] = b[:, 0::2]
    t[:, :, 1] = ord("|")
    t[:, :, 2] = b[:, 1::2]
    t[:, :, 3] = ord("\t")
    t = t.reshape(n, -1)
    t[:, -1] = ord("\n")
    return t.cpu().numpy()


def text(scaffold: str, positions: np.ndarray, rows: np.ndarray) -> bytes:
    """Lines ``scaffold<TAB>position<TAB>calls``."""
    width = rows.shape[1]
    body = rows.tobytes()
    parts = []
    for i, p in enumerate(positions.tolist()):
        parts.append(f"{scaffold}\t{p}\t".encode())
        parts.append(body[i * width:(i + 1) * width])
    return b"".join(parts)


class GzipStream:
    """One gzip member whose deflate pieces are compressed by a thread pool
    (zlib releases the interpreter lock)."""

    def __init__(self, path: Path, threads: int):
        self.f = open(path, "wb")
        self.f.write(b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03")
        self.pool = cf.ThreadPoolExecutor(max_workers=threads)
        self.pending: list[cf.Future] = []
        self.threads = threads
        self.crc = 0
        self.size = 0

    @staticmethod
    def _deflate(piece: bytes) -> bytes:
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
        return c.compress(piece) + c.flush(zlib.Z_SYNC_FLUSH)

    def write(self, piece: bytes) -> None:
        self.crc = zlib.crc32(piece, self.crc)
        self.size += len(piece)
        self.pending.append(self.pool.submit(self._deflate, piece))
        while len(self.pending) > 2 * self.threads:
            self.f.write(self.pending.pop(0).result())

    def close(self) -> None:
        try:
            for fut in self.pending:
                self.f.write(fut.result())
            self.f.write(zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
                         .flush(zlib.Z_FINISH))
            self.f.write(struct.pack("<II", self.crc & 0xFFFFFFFF,
                                     self.size & 0xFFFFFFFF))
        finally:
            self.pool.shutdown(wait=True)
            self.f.close()


def make(out: Path, cfg: dict, work: dict, seed: int, device) -> None:
    """Write the cell's input and pops file into ``out``."""
    gen = spec.generator(cfg["generator"])
    samples = C.samples(cfg)
    positions = gen.positions(cfg, seed)[:work["sites"]]
    header = ("#CHROM\tPOS\t" + "\t".join(n for n, _ in samples) + "\n").encode()
    stream = GzipStream(out / "input.geno.gz", threads=min(8, os.cpu_count() or 1))
    try:
        stream.write(header)
        s0 = 0
        for codes in gen.chunks(cfg, seed, work["sites"], device):
            s1 = s0 + codes.shape[0]
            piece = text(cfg["scaffold"], positions[s0:s1],
                         format_rows(codes, cfg["format"]))
            stream.write(piece)
            s0 = s1
    finally:
        stream.close()
    (out / "pops.txt").write_text("".join(f"{n}\t{p}\n" for n, p in samples))


def get(cfg: dict, work: dict, seed: int, device, log,
        cache: Path | None = None) -> Inputs:
    """The cell's input files for ``seed``: from the cache, or made now."""
    cache = cache or spec.ROOT / ".cache"
    name = f"{cfg['name']}-{work['sites']}-{seed}-{_digest(cfg)}"
    entry = cache / name
    files = Inputs(entry / "input.geno.gz", entry / "pops.txt", None)
    if (entry / "done").exists():
        os.utime(entry / "done")
        return files
    t0 = time.perf_counter()
    cache.mkdir(parents=True, exist_ok=True)
    part = cache / f".{name}.part"
    shutil.rmtree(part, ignore_errors=True)
    part.mkdir()
    make(part, cfg, work, seed, device)
    (part / "done").write_text("")
    shutil.rmtree(entry, ignore_errors=True)
    os.replace(part, entry)
    files.made_s = time.perf_counter() - t0
    log(f"input {name}: {work['sites']} sites, "
        f"{files.geno.stat().st_size} gz bytes, made in {files.made_s:.3f} s")
    entries = sorted((p for p in cache.iterdir()
                      if (p / "done").exists()),
                     key=lambda p: (p / "done").stat().st_mtime, reverse=True)
    for old in entries[KEEP:]:
        shutil.rmtree(old, ignore_errors=True)
    return files
