"""Window planning: turn (scaffold_ids, positions) into a static window plan.

The reference streams a geno file through four generator functions that
maintain one mutable ``GenoWindow`` (genomics.py:1971-2223).
Because the engine holds sites as sorted dense arrays, every window is a
*contiguous span* ``[first, last)`` of the global site axis, so the whole
schedule is a small static table — which is exactly what a jit-compiled,
sharded TPU pipeline wants (fixed shapes, no data-dependent control flow).

Semantics replicated exactly:

* ``coordinate`` (slidingCoordWindows, genomics.py:1971-2028): per scaffold,
  windows ``[1+k*step, windSize+k*step]``; window k emitted for every
  k = 0..K with K the first window whose end >= the scaffold's last site
  position (empty intermediate windows ARE emitted; trailing ones are not);
  sites with pos < limits[0] are dropped (step > size gaps, :1991).
* ``sites`` (slidingSitesWindows, :2032-2108): windows of ``windSites`` sites
  with ``overlap`` retained, optional ``maxDist`` span cap, emitted when
  ``seqLen >= minSites``; on shortfall the leftmost site is trimmed and
  reading continues (:2090-2091); a sub-minSites remainder at a scaffold edge
  is dropped.
* ``predefined`` (predefinedCoordWindows, :2112-2171): one window per
  coordinates row (even if empty), sites within [start, end] of the matching
  scaffold.  Rows must be sorted by (scaffold first-appearance, start).
* ``cat`` / ``nonoverlapping`` (:2176-2223, distMat.py:316-319): whole file /
  fixed site blocks per scaffold.

Window IDs are 1-based sequential in emission order (genomics.py:2011, 2017).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class WindowPlan:
    """Static window table.

    All arrays have length n_windows.  ``first``/``last`` index the global
    site axis (half-open span).  ``start``/``end`` are the printed coordinate
    limits (for coordinate/predefined windows) or are derived from the span's
    first/last site positions (sites windows; popgenWindows.py:39).
    """

    scaffold_id: np.ndarray     # int32
    start: np.ndarray           # int64 (printed window start)
    end: np.ndarray             # int64 (printed window end)
    first: np.ndarray           # int64 site-span start (inclusive)
    last: np.ndarray            # int64 site-span end (exclusive)
    wind_type: str
    ids: list = field(default_factory=list)   # window IDs (ints or strings)

    @property
    def n_windows(self) -> int:
        return self.scaffold_id.shape[0]

    @property
    def n_sites(self) -> np.ndarray:
        return self.last - self.first

    def mid(self, positions: np.ndarray) -> np.ndarray:
        """Window midpoints: int(round(mean(positions))) with Python banker's
        rounding (GenoWindow.midPos, genomics.py:1795-1797); NaN if empty.

        Vectorized over windows: exact int64 prefix sums (positions are ints,
        so span sums are exact) and np.round (round-half-even, same rule as
        Python round on the float quotient)."""
        out = np.full(self.n_windows, np.nan)
        if self.n_windows == 0:
            return out
        cs = np.concatenate([[0], np.cumsum(positions, dtype=np.int64)])
        n = self.last - self.first
        nz = n > 0
        sums = cs[self.last[nz]] - cs[self.first[nz]]
        out[nz] = np.round(sums / n[nz])
        return out


def _scaffold_spans(scaffold_ids: np.ndarray):
    """Yield (scaf_id, span_start, span_end) for consecutive runs."""
    n = scaffold_ids.shape[0]
    if n == 0:
        return []
    change = np.flatnonzero(scaffold_ids[1:] != scaffold_ids[:-1]) + 1
    bounds = np.concatenate([[0], change, [n]])
    return [(int(scaffold_ids[bounds[k]]), int(bounds[k]), int(bounds[k + 1]))
            for k in range(bounds.size - 1)]


def filter_scaffolds(scaffold_ids: np.ndarray, scaffold_names: list[str],
                     include=None, exclude=None) -> np.ndarray:
    """Boolean keep-mask over sites for --include/--exclude scaffold lists."""
    keep = np.ones(scaffold_ids.shape[0], dtype=bool)
    if include is not None:
        inc = set(include)
        ok = np.array([name in inc for name in scaffold_names])
        keep &= ok[scaffold_ids]
    if exclude is not None:
        exc = set(exclude)
        ok = np.array([name not in exc for name in scaffold_names])
        keep &= ok[scaffold_ids]
    return keep


def plan_coordinate_windows(scaffold_ids: np.ndarray, positions: np.ndarray,
                            wind_size: int, step_size: int) -> WindowPlan:
    scafs, starts, ends, firsts, lasts = [], [], [], [], []
    for sid, s0, s1 in _scaffold_spans(scaffold_ids):
        pos = positions[s0:s1]
        p_last = int(pos[-1])
        K = max(0, -(-(p_last - wind_size) // step_size))  # ceil
        k = np.arange(K + 1, dtype=np.int64)
        w_start = 1 + k * step_size
        w_end = wind_size + k * step_size
        # span of sites in [w_start, w_end]
        f = np.searchsorted(pos, w_start, side="left") + s0
        l = np.searchsorted(pos, w_end, side="right") + s0
        scafs.append(np.full(K + 1, sid, dtype=np.int32))
        starts.append(w_start)
        ends.append(w_end)
        firsts.append(f)
        lasts.append(l)
    if not scafs:
        z = np.empty(0, np.int64)
        return WindowPlan(np.empty(0, np.int32), z, z, z, z, "coordinate", [])
    plan = WindowPlan(np.concatenate(scafs), np.concatenate(starts),
                      np.concatenate(ends), np.concatenate(firsts),
                      np.concatenate(lasts), "coordinate")
    plan.ids = list(range(1, plan.n_windows + 1))
    return plan


def plan_sites_windows(scaffold_ids: np.ndarray, positions: np.ndarray,
                       wind_sites: int, overlap: int = 0,
                       max_dist: float = np.inf,
                       min_sites: int | None = None) -> WindowPlan:
    if not min_sites:
        min_sites = wind_sites  # genomics.py:2034
    scafs, firsts, lasts = [], [], []
    for sid, s0, s1 in _scaffold_spans(scaffold_ids):
        pos = positions[s0:s1]
        m = s1 - s0
        i = 0
        while i < m:
            # extend j while seqLen < windSites and pos - firstPos <= maxDist
            if np.isinf(max_dist):
                j = min(i + wind_sites, m)
            else:
                j_cap = int(np.searchsorted(pos, pos[i] + max_dist, side="right"))
                j = min(i + wind_sites, j_cap)
            full = (j - i) == wind_sites
            at_end = j == m
            if full or at_end:
                if (j - i) >= min_sites:
                    scafs.append(sid)
                    firsts.append(s0 + i)
                    lasts.append(s0 + j)
                    if at_end:
                        break
                    # trim(leave=overlap), genomics.py:2072; a negative
                    # remove keeps the whole window (genomics.py:1781-1784),
                    # where the reference generator would re-emit the same
                    # window forever — we advance one site instead
                    i = j - overlap if (j - i) > overlap else i + 1
                else:
                    if at_end:
                        break
                    i += 1           # trim(remove=1), genomics.py:2091
            else:
                # window capped by maxDist before filling
                if (j - i) >= min_sites:
                    scafs.append(sid)
                    firsts.append(s0 + i)
                    lasts.append(s0 + j)
                    i = j - overlap if (j - i) > overlap else i + 1
                else:
                    i += 1
    firsts = np.array(firsts, dtype=np.int64)
    lasts = np.array(lasts, dtype=np.int64)
    scafs = np.array(scafs, dtype=np.int32)
    start = positions[firsts] if firsts.size else np.empty(0, np.int64)
    end = positions[lasts - 1] if lasts.size else np.empty(0, np.int64)
    plan = WindowPlan(scafs, np.asarray(start, np.int64), np.asarray(end, np.int64),
                      firsts, lasts, "sites")
    plan.ids = list(range(1, plan.n_windows + 1))
    return plan


def plan_predefined_windows(scaffold_ids: np.ndarray, positions: np.ndarray,
                            scaffold_names: list[str],
                            wind_coords: list) -> WindowPlan:
    """wind_coords: list of (scaffold, start, end[, ID]) rows, in file order."""
    name_to_id = {n: i for i, n in enumerate(scaffold_names)}
    spans = {sid: (s0, s1) for sid, s0, s1 in _scaffold_spans(scaffold_ids)}
    n = len(wind_coords)
    scafs = np.empty(n, dtype=np.int32)
    starts = np.empty(n, dtype=np.int64)
    ends = np.empty(n, dtype=np.int64)
    firsts = np.empty(n, dtype=np.int64)
    lasts = np.empty(n, dtype=np.int64)
    ids = []
    for i, row in enumerate(wind_coords):
        scaf, a, b = row[0], int(row[1]), int(row[2])
        ids.append(row[3] if len(row) > 3 else "NA")
        sid = name_to_id.get(scaf, -1)
        if sid < 0:
            # register absent scaffolds so rows carry the true windCoords
            # name (the reference's GenoWindow keeps it, genomics.py:2135)
            sid = len(scaffold_names)
            scaffold_names.append(scaf)
            name_to_id[scaf] = sid
        scafs[i] = sid
        starts[i] = a
        ends[i] = b
        if sid in spans:
            s0, s1 = spans[sid]
            pos = positions[s0:s1]
            firsts[i] = s0 + np.searchsorted(pos, a, side="left")
            lasts[i] = s0 + np.searchsorted(pos, b, side="right")
        else:
            firsts[i] = lasts[i] = 0
    return WindowPlan(scafs, starts, ends, firsts, lasts, "predefined", ids)


def plan_cat_window(scaffold_ids: np.ndarray, positions: np.ndarray) -> WindowPlan:
    n = positions.shape[0]
    sid = scaffold_ids[0] if n else 0
    plan = WindowPlan(np.array([sid], np.int32),
                      np.array([positions[0] if n else 0], np.int64),
                      np.array([positions[-1] if n else 0], np.int64),
                      np.array([0], np.int64), np.array([n], np.int64), "cat")
    plan.ids = [1]
    return plan


class IncrementalPlanner:
    """Streaming window planner over a rolling site buffer.

    The engine appends parsed chunks to rolling (scaffold_ids, positions)
    buffers and calls :meth:`plan`; the planner returns a :class:`WindowPlan`
    piece covering every window that is *certainly complete* given the data
    seen so far, plus ``keep_from`` — the buffer index of the first site
    still needed by future windows (everything before it may be dropped).

    Window semantics are identical to the batch planners above (and hence to
    the reference generators, genomics.py:1971-2223); the
    streaming/batch equivalence is asserted in tests/test_streaming.py.
    first/last in the returned plan pieces are *buffer-relative*.

    Safety rules for emitting a window before EOF (input is position-sorted
    within scaffolds, like the reference requires):

    * coordinate: window ``[1+k*step, windSize+k*step]`` is complete once a
      site with a strictly greater position (or a later scaffold) is seen.
    * sites: the greedy loop is strictly left-to-right; a window is complete
      when it reached ``windSites`` sites or its maxDist cap was established
      by a site *inside* the buffer; only the trailing partial window needs
      the scaffold end.
    * predefined: a row is decidable once its scaffold's data is complete
      (or at EOF, for scaffolds absent from the data); rows are emitted in
      file order, so an undecidable row blocks later ones (they stay queued).
    """

    def __init__(self, wind: dict, scaffold_names: list[str]):
        self.wind = wind
        self.wt = wind["windType"]
        self.scaffold_names = scaffold_names   # live list owned by the reader
        self.next_id = 1                       # global 1-based window numbering
        # coordinate-window state: current scaffold + next window index k
        # (_next_k is None once a scaffold is finalized)
        self._cur_sid: int | None = None
        self._next_k: int | None = 0
        self._last_pos: int | None = None
        # predefined-window state
        self._rows = list(wind.get("windCoords") or [])
        self._row_cursor = 0
        self._done_sids: set[int] = set()
        self._frontier_sid: int | None = None

    # -------------------------------------------------------------- public

    def plan(self, scaffold_ids: np.ndarray, positions: np.ndarray,
             final: bool) -> tuple[WindowPlan, int]:
        """Plan over the current buffer; returns (plan_piece, keep_from)."""
        if self.wt == "coordinate":
            piece, keep = self._plan_coordinate(scaffold_ids, positions, final)
        elif self.wt == "sites":
            piece, keep = self._plan_sites(scaffold_ids, positions, final)
        elif self.wt == "predefined":
            piece, keep = self._plan_predefined(scaffold_ids, positions, final)
        else:
            raise ValueError(f"streaming not supported for windType {self.wt!r}")
        if self.wt != "predefined":
            piece.ids = list(range(self.next_id, self.next_id + piece.n_windows))
        self.next_id += piece.n_windows
        return piece, keep

    # ------------------------------------------------------------- helpers

    @staticmethod
    def _empty(wt: str) -> WindowPlan:
        z = np.empty(0, np.int64)
        return WindowPlan(np.empty(0, np.int32), z, z, z, z, wt, [])

    def _plan_coordinate(self, sids, pos, final):
        wsize = self.wind["windSize"]
        step = self.wind["stepSize"]
        scafs, starts, ends, firsts, lasts = [], [], [], [], []
        keep_from = pos.shape[0]
        spans = _scaffold_spans(sids)

        # events: (sid, buffer span or None, scaffold_final).  A None span
        # finalizes a scaffold whose buffered sites were already trimmed
        # (possible when step > windSize leaves trailing gap sites, or when a
        # scaffold ends exactly at a trim point) — its trailing windows are
        # derived from the remembered last position.
        events = []
        if self._cur_sid is not None and \
                (not spans or spans[0][0] != self._cur_sid) and \
                self._next_k is not None:
            events.append((self._cur_sid, None, True))
        for idx, (sid, s0, s1) in enumerate(spans):
            events.append((sid, (s0, s1), final or idx < len(spans) - 1))

        for sid, span, scaffold_final in events:
            if sid != self._cur_sid:
                self._cur_sid = sid
                self._next_k = 0
                self._last_pos = None
            if self._next_k is None:           # scaffold already finalized
                continue
            if span is not None:
                s0, s1 = span
                p = pos[s0:s1]
                p_last = int(p[-1])
                self._last_pos = p_last
            else:
                s0 = s1 = 0
                p = pos[:0]
                p_last = self._last_pos
            if scaffold_final:
                # batch rule: K = max(0, ceil((p_last - wsize) / step))
                K = max(0, -(-(p_last - wsize) // step))
            else:
                # only windows with end < p_last are certainly complete
                K = (p_last - wsize - 1) // step
            if K >= self._next_k:
                k = np.arange(self._next_k, K + 1, dtype=np.int64)
                w_start = 1 + k * step
                w_end = wsize + k * step
                scafs.append(np.full(k.size, sid, dtype=np.int32))
                starts.append(w_start)
                ends.append(w_end)
                firsts.append(np.searchsorted(p, w_start, side="left") + s0)
                lasts.append(np.searchsorted(p, w_end, side="right") + s0)
                self._next_k = K + 1
            if scaffold_final:
                self._next_k = None            # nothing more for this scaffold
            else:
                next_start = 1 + self._next_k * step
                keep_from = s0 + int(np.searchsorted(p, next_start, side="left"))
        if not scafs:
            return self._empty("coordinate"), keep_from
        piece = WindowPlan(np.concatenate(scafs), np.concatenate(starts),
                           np.concatenate(ends), np.concatenate(firsts),
                           np.concatenate(lasts), "coordinate")
        return piece, keep_from

    def _plan_sites(self, sids, pos, final):
        wsites = self.wind["windSize"]
        overlap = self.wind["overlap"]
        max_dist = self.wind["maxDist"]
        min_sites = self.wind["minSites"] or wsites
        scafs, firsts, lasts = [], [], []
        keep_from = pos.shape[0]
        spans = _scaffold_spans(sids)
        for idx, (sid, s0, s1) in enumerate(spans):
            p = pos[s0:s1]
            m = s1 - s0
            last_span = idx == len(spans) - 1
            scaffold_final = final or not last_span
            i = 0
            while i < m:
                if np.isinf(max_dist):
                    j = min(i + wsites, m)
                else:
                    j_cap = int(np.searchsorted(p, p[i] + max_dist, side="right"))
                    j = min(i + wsites, j_cap)
                full = (j - i) == wsites
                if j == m and not full and not scaffold_final:
                    break                      # trailing window needs more data
                at_end = j == m and scaffold_final   # true scaffold end
                if full or at_end:
                    if (j - i) >= min_sites:
                        scafs.append(sid)
                        firsts.append(s0 + i)
                        lasts.append(s0 + j)
                        if at_end:
                            i = m
                            break
                        # trim(leave=overlap); degenerate windows (<= overlap
                        # sites) advance one site — see plan_sites_windows
                        i = j - overlap if (j - i) > overlap else i + 1
                    else:
                        if at_end:
                            i = m
                            break
                        i += 1                 # trim(remove=1), genomics.py:2091
                else:
                    # window capped by maxDist before filling (cap is inside
                    # the buffer, so the decision is final)
                    if (j - i) >= min_sites:
                        scafs.append(sid)
                        firsts.append(s0 + i)
                        lasts.append(s0 + j)
                        i = j - overlap if (j - i) > overlap else i + 1
                    else:
                        i += 1
            if last_span and not final:
                keep_from = s0 + i
        firsts = np.array(firsts, dtype=np.int64)
        lasts = np.array(lasts, dtype=np.int64)
        start = pos[firsts] if firsts.size else np.empty(0, np.int64)
        end = pos[lasts - 1] if lasts.size else np.empty(0, np.int64)
        piece = WindowPlan(np.array(scafs, np.int32), np.asarray(start, np.int64),
                           np.asarray(end, np.int64), firsts, lasts, "sites")
        return piece, keep_from

    def _register_absent(self, scaf: str, name_to_id: dict) -> int:
        """Give a windCoords scaffold that never appears in the data a real
        id so output rows carry its true name (the reference's GenoWindow
        keeps the windCoords scaffold, genomics.py:2135; printing "None"
        would also make different hosts' absent-scaffold rows collide in the
        multi-host writer).  Safe: such rows emit only at EOF, after every
        data scaffold has been assigned."""
        sid = len(self.scaffold_names)
        self.scaffold_names.append(scaf)
        name_to_id[scaf] = sid
        return sid

    def _plan_predefined(self, sids, pos, final):
        name_to_id = {n: i for i, n in enumerate(self.scaffold_names)}
        spans = _scaffold_spans(sids)
        span_by_sid = {sid: (s0, s1) for sid, s0, s1 in spans}
        # scaffolds fully behind the read frontier
        for k, (sid, _, _) in enumerate(spans):
            if final or k < len(spans) - 1:
                self._done_sids.add(sid)
        frontier_sid = spans[-1][0] if spans else self._frontier_sid
        if (self._frontier_sid is not None
                and frontier_sid != self._frontier_sid):
            # the previous frontier scaffold's sites were fully trimmed
            self._done_sids.add(self._frontier_sid)
        self._frontier_sid = frontier_sid
        frontier_pos = int(pos[-1]) if pos.shape[0] else None

        scafs, starts, ends, firsts, lasts, ids = [], [], [], [], [], []
        while self._row_cursor < len(self._rows):
            row = self._rows[self._row_cursor]
            scaf, a, b = row[0], int(row[1]), int(row[2])
            sid = name_to_id.get(scaf, -1)
            if sid < 0 or sid not in span_by_sid:
                if sid >= 0 and sid in self._done_sids:
                    pass        # scaffold seen+trimmed earlier: empty span
                elif not final:
                    break       # not decidable yet: blocks later rows
            else:
                decidable = (sid in self._done_sids
                             or (sid == frontier_sid and frontier_pos > b)
                             or final)
                if not decidable:
                    break
            ids.append(row[3] if len(row) > 3 else "NA")
            if sid < 0:
                sid = self._register_absent(scaf, name_to_id)
            scafs.append(sid)
            starts.append(a)
            ends.append(b)
            if sid in span_by_sid:
                s0, s1 = span_by_sid[sid]
                p = pos[s0:s1]
                firsts.append(s0 + int(np.searchsorted(p, a, side="left")))
                lasts.append(s0 + int(np.searchsorted(p, b, side="right")))
            else:
                firsts.append(0)
                lasts.append(0)
            self._row_cursor += 1

        # first site still needed by any pending row whose scaffold is buffered
        keep_from = pos.shape[0]
        for row in self._rows[self._row_cursor:]:
            sid = name_to_id.get(row[0], -1)
            if sid in span_by_sid:
                s0, s1 = span_by_sid[sid]
                p = pos[s0:s1]
                keep_from = min(keep_from,
                                s0 + int(np.searchsorted(p, int(row[1]), "left")))
        piece = WindowPlan(np.array(scafs, np.int32),
                           np.array(starts, np.int64), np.array(ends, np.int64),
                           np.array(firsts, np.int64), np.array(lasts, np.int64),
                           "predefined", ids)
        return piece, keep_from


def plan_nonoverlapping_sites_windows(scaffold_ids: np.ndarray,
                                      positions: np.ndarray,
                                      wind_sites: float) -> WindowPlan:
    """Consecutive blocks of windSites sites per scaffold (genomics.py:2176-2223);
    windSites=inf reads whole scaffolds (tools genoToPlink usage)."""
    scafs, firsts, lasts = [], [], []
    for sid, s0, s1 in _scaffold_spans(scaffold_ids):
        i = s0
        step = (s1 - s0) if np.isinf(wind_sites) else int(wind_sites)
        while i < s1:
            j = min(i + step, s1)
            scafs.append(sid)
            firsts.append(i)
            lasts.append(j)
            i = j
    firsts = np.array(firsts, dtype=np.int64)
    lasts = np.array(lasts, dtype=np.int64)
    start = positions[firsts] if firsts.size else np.empty(0, np.int64)
    end = positions[lasts - 1] if lasts.size else np.empty(0, np.int64)
    plan = WindowPlan(np.array(scafs, np.int32), np.asarray(start, np.int64),
                      np.asarray(end, np.int64), firsts, lasts, "nonoverlapping")
    plan.ids = list(range(1, plan.n_windows + 1))
    return plan
