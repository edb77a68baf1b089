"""Multi-process execution on torch.distributed: per-process input
sharding, process-0 ordered output (the port of
genomics_general_tpu/parallel/multihost.py).

* :func:`maybe_initialize` brings up a gloo process group from the
  ``GGT_COORDINATOR`` / ``GGT_NUM_PROCS`` / ``GGT_PROC_ID`` contract of the
  JAX package (or, under ``GGT_DIST_AUTO=1``, from the ``env://`` variables
  that ``torchrun`` sets).  An incomplete multi-process environment raises
  a ``ValueError`` naming the missing variables; the JAX package runs one
  process when ``GGT_NUM_PROCS>1`` comes without a coordinator.
* **input sharding**: each process parses the shared input and keeps only
  the scaffolds it owns — ownership is crc32 of the scaffold name, so every
  process agrees without coordination and ownership is known before any
  data is read (required for predefined window lists).  With a native
  ``{geno}.tbi`` next to a BGZF input each process reads only its own
  scaffolds' blocks (:func:`indexed_input`, io/tabix.py).
* each process runs the normal single-process pipeline on its scaffold
  subset, with the same kernels on the card(s) it sees; per-window rows
  stay in process-local per-scaffold buffers,
* **process-0 ordered writer**: rows are allgathered and written by
  process 0 grouped by scaffold in genome (file) order — byte-identical to
  a one-process run (:class:`MultiHostWriter`),
* genome-wide accumulators (SFS, distMat cat, jackknife partials) merge
  with :func:`collective_reduce` (int64 SUM / MIN) and
  :func:`allgather_bytes`.

Every collective is gloo over CPU tensors, on the card too: every payload
starts and ends in host memory (pickled rows, numpy int64 accumulators),
and two ranks may share one card, which NCCL refuses.
:func:`mesh_reduce_stacked`, the merge of stacked accumulators over the
devices of one process's mesh (K16), is here as well.
"""

from __future__ import annotations

import atexit
import os
import pickle
import zlib

import numpy as np


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def maybe_initialize() -> None:
    """Initialize a gloo process group from GGT_* env vars if present.

    GGT_COORDINATOR=host:port GGT_NUM_PROCS=N GGT_PROC_ID=i — explicit
    single-machine / ad-hoc clusters (process 0 listens on host:port).
    Under ``torchrun``, set GGT_DIST_AUTO=1 instead (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``GGT_NUM_PROCS>1``
    without a coordinator, or a coordinator without ``GGT_NUM_PROCS`` or
    ``GGT_PROC_ID``, raises ``ValueError``.  The group is destroyed at
    exit."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    coord = os.environ.get("GGT_COORDINATOR")
    n_procs = os.environ.get("GGT_NUM_PROCS")
    rank = os.environ.get("GGT_PROC_ID")
    if coord:
        missing = [k for k, v in (("GGT_NUM_PROCS", n_procs),
                                  ("GGT_PROC_ID", rank)) if not v]
        if missing:
            raise ValueError(
                f"GGT_COORDINATOR={coord} needs {' and '.join(missing)} "
                "(the process count and this process's rank)")
        dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                world_size=int(n_procs), rank=int(rank))
    elif os.environ.get("GGT_DIST_AUTO") == "1":
        dist.init_process_group("gloo")
    elif n_procs and int(n_procs) > 1:
        missing = ["GGT_COORDINATOR"] + ([] if rank else ["GGT_PROC_ID"])
        raise ValueError(
            f"GGT_NUM_PROCS={n_procs} asks for a multi-process run but "
            f"{' and '.join(missing)} {'is' if len(missing) == 1 else 'are'}"
            " not set (or set GGT_DIST_AUTO=1 under torchrun); refusing to "
            "run one process")
    else:
        return
    atexit.register(_destroy)


def _destroy() -> None:
    dist = _dist()
    if dist is not None:
        dist.destroy_process_group()


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def owner(scaffold_name: str, n_procs: int) -> int:
    """Stable scaffold -> process assignment (crc32: identical on every
    process, no coordination, known before reading any data)."""
    return zlib.crc32(scaffold_name.encode()) % n_procs


def shard_predicate(n_procs: int, rank: int):
    """Predicate(scaffold_name) -> bool: does this process own the
    scaffold?"""
    return lambda name: owner(name, n_procs) == rank


class _IndexedScaffoldStream:
    """File-like serving the geno header plus this host's owned scaffolds'
    decompressed lines out of a BGZF+.tbi input, in global (index) order."""

    def __init__(self, path: str, owned: list[str], header: bytes,
                 idx, rd):
        self._path = path
        self._idx = idx
        self._rd = rd
        self._buf = header

        def lines():
            INT64_MAX = (1 << 63) - 1
            from ..io import tabix as T
            for name in owned:
                for ln in T.region_lines(path, name, 1, INT64_MAX - 1,
                                         index=idx, reader=rd):
                    yield ln

        self._lines = lines()
        self._eof = False

    def read(self, n: int) -> bytes:
        while not self._eof and len(self._buf) < n:
            parts = [self._buf]
            got = len(self._buf)
            for ln in self._lines:
                parts.append(ln)
                parts.append(b"\n")
                got += len(ln) + 1
                if got >= n:
                    break
            else:
                self._eof = True
            self._buf = b"".join(parts)
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def indexed_input(geno_file: str | None, shard_pred):
    """(stream, scaffold_names) reading ONLY this host's owned scaffolds
    through a native ``{geno_file}.tbi`` index (io/tabix), or (None, None)
    when no index exists.

    Without an index every host decompresses and tokenizes the WHOLE
    shared input and drops the scaffolds it does not own — parse cost is
    replicated N-fold and bounds host scaling.  With the index each host
    reads ~1/N of the blocks.  ``scaffold_names`` is the index's full
    contig list: callers preseed the reader with it so scaffold ids (and
    the incremental-gather thresholds derived from them) are globally
    consistent across hosts even though each host only SEES its own
    scaffolds."""
    if not geno_file or not os.path.exists(str(geno_file) + ".tbi"):
        return None, None
    from ..io import tabix as T
    try:
        idx = T.TabixIndex(str(geno_file) + ".tbi")
        rd = T.BGZFReader(str(geno_file))
        # header = leading '#' lines (read whole blocks until a data line)
        header = b""
        pos = 0
        while True:
            payload, pos = rd.block_at(pos)
            header += payload
            # stop once a complete non-# line exists
            done = False
            off = 0
            while True:
                nl = header.find(b"\n", off)
                if nl < 0:
                    break
                if nl > off and not header[off:nl].startswith(b"#"):
                    done = True
                    break
                off = nl + 1
            if done or not payload:
                header = header[:off]
                break
    except (ValueError, OSError):
        return None, None
    owned = [n for n in idx.names if shard_pred(n)]
    return _IndexedScaffoldStream(str(geno_file), owned, header, idx, rd), \
        list(idx.names)


def mesh_reduce_stacked(stacked, mesh, op: str = "sum"):
    """Reduce a host-stacked [k, ...] integer array over a device mesh: the
    k rows are sharded over the mesh's devices (k a multiple of its size,
    as the JAX placement needs), each shard is copied to the first device
    and K16 sums (``op="sum"``) or takes the minimum (``"min"``) there.
    int64 survives exactly.  Returns the [...] numpy result.  Used by the
    multi-device dry run to merge sfs and distMat cat partials."""
    from ..kernels import transfer
    from .mesh import reduce_on_first
    stacked = np.ascontiguousarray(stacked)
    k = stacked.shape[0]
    if k % mesh.size:
        raise ValueError(f"{k} stacked rows do not shard over {mesh.size} "
                         "devices")
    shards = [transfer.to_device(stacked[lo:hi], d) for d, (lo, hi) in
              zip(mesh.devices, transfer.sharded_axis(k, mesh.size))]
    return reduce_on_first(shards, mesh, op)


def collective_reduce(arr, op: str = "sum"):
    """Reduce a process-local integer accumulator across processes: one
    int64 ``all_reduce`` (SUM, or MIN for ``op="min"``) of a CPU tensor over
    gloo, exact past 2^53.  Used to merge SFS spectra counts (sum),
    first-occurrence order keys (min) and distMat cat's packed pair counts
    (sum).  Returns ``arr`` itself with one process."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return arr
    import torch
    arr = np.asarray(arr)
    if arr.dtype.kind not in "iub":
        raise TypeError(f"collective_reduce takes integers, not {arr.dtype}")
    t = torch.from_numpy(np.array(arr, dtype=np.int64, copy=True).ravel())
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MIN)
    return t.numpy().astype(arr.dtype).reshape(arr.shape)


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one bytes blob from every process (returned in rank order):
    the lengths first, then uint8 buffers padded to the longest."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return [bytes(payload)]
    import torch
    n = dist.get_world_size()
    arr = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lengths, torch.tensor([arr.numel()], dtype=torch.int64))
    lengths = [int(x) for x in lengths]
    max_len = max(lengths)
    if max_len == 0:
        return [b""] * n
    padded = torch.zeros(max_len, dtype=torch.uint8)
    padded[:arr.numel()] = arr
    gathered = [torch.empty(max_len, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(gathered, padded)
    return [gathered[i][:lengths[i]].numpy().tobytes() for i in range(n)]


class MultiHostWriter:
    """Host-local row buffers merged to an ordered host-0 CSV.

    Two ordering modes:

    * **scaffold blocks** (coordinate/sites windows): each host buffers rows
      per scaffold it owns; ``finish`` allgathers the buffers and process 0
      writes blocks in genome (file) order.  Every host observes the full
      scaffold sequence of the shared input, so host 0's order is the genome
      order, and within a scaffold window order is deterministic by
      construction.
    * **explicit keys** (predefined window lists): rows carry their global
      windCoords row index and host 0 writes them key-sorted — byte-identical
      to a single-host run even when the window file interleaves scaffolds
      (plain scaffold grouping would reorder such files)."""

    SEGMENT_RAW = 4 << 20      # compress buffered text in ~4 MB segments

    def __init__(self, incremental_every: int | None = None,
                 open_out=None, header: str = ""):
        # per-scaffold: (list of zlib-compressed segments, list of pending
        # raw strings, pending raw length).  Compressing as we go bounds the
        # held memory at roughly the compressed output size (~10x smaller
        # for CSV/TSV text) instead of the full uncompressed stream —
        # genome-scale per-site outputs (freq) would otherwise hold the
        # entire file on every host.
        self.blocks: dict[str, tuple[list[bytes], list[str], int]] = {}
        self.keyed_rows: list[tuple[int, str]] = []
        # incremental gather: every ``incremental_every`` scaffolds of the
        # shared input stream, all hosts run one allgather round and host 0
        # writes those scaffolds immediately — peak buffered memory is
        # O(scaffold group), not O(output).  Every host observes the same
        # scaffold sequence, so the round trigger (a scaffold INDEX
        # threshold) fires identically everywhere — the collective call
        # counts always match.  Incompatible with keyed rows (predefined
        # window files interleave scaffolds).
        self.incr = incremental_every
        self._open_out = open_out
        self._header = header
        self._out = None
        self._rounds_done = 0           # scaffolds gathered so far
        self.peak_buffered = 0          # diagnostics: max held compressed B

    def _track_peak(self):
        held = sum(len(s) for segs, raw, _ in self.blocks.values()
                   for s in segs)
        held += sum(rl for _, _, rl in self.blocks.values())
        if held > self.peak_buffered:
            self.peak_buffered = held

    def maybe_gather(self, completed_idx: int, scaffold_names: list) -> None:
        """Run incremental gather rounds for every full scaffold group below
        ``completed_idx`` (the index of the first scaffold NOT yet fully
        processed on this host).  Call with increasing values; every host
        must call through the same thresholds (they do: the shared stream
        shows all hosts the same scaffold order)."""
        if not self.incr:
            return
        assert not self.keyed_rows, \
            "incremental gather is incompatible with keyed rows"
        while self._rounds_done + self.incr <= completed_idx:
            lo = self._rounds_done
            hi = lo + self.incr
            self._gather_round(scaffold_names[lo:hi])
            self._rounds_done = hi

    def _gather_round(self, names: list) -> None:
        group = {}
        for n in names:
            entry = self.blocks.pop(n, None)
            if entry is not None:
                segs, raw, _ = entry
                if raw:
                    segs = segs + [zlib.compress("".join(raw).encode(), 1)]
                group[n] = segs
        self._track_peak()
        payload = pickle.dumps(group, protocol=pickle.HIGHEST_PROTOCOL)
        gathered = allgather_bytes(payload)
        if process_index() != 0:
            return
        if self._out is None:
            self._out = self._open_out()
            self._out.write(self._header)
        merged: dict[str, list[bytes]] = {}
        for blob in gathered:
            for k, segs in pickle.loads(blob).items():
                merged.setdefault(k, []).extend(segs)
        for n in names:
            for seg in merged.get(n, ()):
                self._out.write(zlib.decompress(seg).decode())

    def write_row(self, scaffold: str, line: str,
                  order_key: int | None = None) -> None:
        if order_key is not None:
            self.keyed_rows.append((order_key, line))
            return
        entry = self.blocks.get(scaffold)
        if entry is None:
            entry = ([], [], 0)
            self.blocks[scaffold] = entry
        segs, raw, raw_len = entry
        raw.append(line)
        raw_len += len(line)
        if raw_len >= self.SEGMENT_RAW:
            segs.append(zlib.compress("".join(raw).encode(), 1))
            raw.clear()
            raw_len = 0
        self.blocks[scaffold] = (segs, raw, raw_len)

    def _sealed(self) -> dict[str, list[bytes]]:
        out = {}
        for k, (segs, raw, _) in self.blocks.items():
            if raw:
                segs = segs + [zlib.compress("".join(raw).encode(), 1)]
            out[k] = segs
        return out

    def finish(self, out, header: str, scaffold_order: list[str]) -> None:
        """Gather all hosts' remaining rows; process 0 writes them in order
        (after the header, or appended to the incremental stream)."""
        self._track_peak()
        payload = pickle.dumps((self._sealed(), self.keyed_rows),
                               protocol=pickle.HIGHEST_PROTOCOL)
        gathered = allgather_bytes(payload)
        if process_index() != 0:
            return
        merged: dict[str, list[bytes]] = {}
        keyed: list[tuple[int, str]] = []
        for blob in gathered:
            blocks, rows = pickle.loads(blob)
            for k, segs in blocks.items():
                # defensive: scaffold ownership is disjoint, but never
                # silently drop rows if two hosts ever emit the same key
                merged.setdefault(k, []).extend(segs)
            keyed.extend(rows)
        if self.incr:
            # the writer owns the stream in incremental mode; already-
            # gathered scaffolds were written by their rounds
            if self._out is None:
                self._out = self._open_out()
                self._out.write(self._header)
            out = self._out
            scaffold_order = scaffold_order[self._rounds_done:]
        else:
            out.write(header)
        keyed.sort(key=lambda kv: kv[0])
        for _, line in keyed:
            out.write(line)

        def write_scaf(name):
            for seg in merged.pop(name):
                out.write(zlib.decompress(seg).decode())

        for name in scaffold_order:
            if name in merged:
                write_scaf(name)
        # scaffolds only present in predefined window lists but absent from
        # host-0's observed order: write in deterministic name order
        for name in sorted(merged):
            write_scaf(name)
        return out
