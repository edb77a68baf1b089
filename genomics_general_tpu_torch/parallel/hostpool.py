"""Ordered bounded worker pool for host/subprocess-bound per-item work.

The engine analog of the reference's worker pool + sorter thread
(phylo/phyml_sliding_windows.py:396-421): N items compute
concurrently on threads (the work is an external C binary or GIL-releasing
numpy), results are emitted strictly in submission order, and a bounded
pending queue provides backpressure.  Used by the phyml/raxml sliding-window
CLIs' ``-T``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor


class OrderedPool:
    """Submit (meta, work) items; ``emit(meta, result)`` fires in order."""

    def __init__(self, n_workers: int, emit, max_pending: int | None = None):
        self.emit = emit
        self.pool = ThreadPoolExecutor(max_workers=n_workers) \
            if n_workers > 1 else None
        self.pending: deque = deque()
        self.max_pending = max_pending if max_pending is not None \
            else max(1, n_workers) * 4

    def submit(self, meta, fn=None, *args):
        """Queue an item: ``fn(*args)`` on a worker (or inline without a
        pool), or — with ``fn=None`` — an immediate result in ``args[0]``."""
        if fn is None:
            self.pending.append((meta, args[0]))
        elif self.pool is not None:
            self.pending.append((meta, self.pool.submit(fn, *args)))
        else:
            self.pending.append((meta, fn(*args)))
        self.drain()

    def drain(self, all_: bool = False):
        def head_ready():
            h = self.pending[0][1]
            return not hasattr(h, "done") or h.done()
        while self.pending and (all_ or len(self.pending) > self.max_pending
                                or head_ready()):
            meta, res = self.pending.popleft()
            if hasattr(res, "result"):
                res = res.result()
            self.emit(meta, res)

    def close(self):
        self.drain(all_=True)
        if self.pool is not None:
            self.pool.shutdown()
