"""What the analysis references share: the window plan, the pair counts
and distances of a window, and the table the CSV is compared with.

Semantics are those of genomics_general's popgenWindows.py and genomics.py
(S. H. Martin): a window is reported when it holds at least minSites
sites; the distance of two haplotypes is their share of differing calls
over the sites where both are called; ``-m`` also turns a pair's distance
into NaN where the pair shares fewer than minSites called sites
(groupDistStats); a mean over a block of the distance matrix skips NaN and
is NaN where the share of non-NaN cells is below minData.  Each function
takes the precision to compute in: float64 as the program states, float32
for the control."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MISSING = 4
KEY_COLUMNS = ("scaffold", "start", "end", "mid", "sites")


@dataclass
class Windows:
    start: np.ndarray       # printed start
    end: np.ndarray         # printed end
    first: np.ndarray       # first site (index)
    last: np.ndarray        # one past the last site

    @property
    def n_sites(self) -> np.ndarray:
        return self.last - self.first

    def mid(self, positions: np.ndarray) -> np.ndarray:
        """round(mean of the window's positions), halves to even; NaN when
        empty."""
        out = np.full(self.first.size, np.nan)
        for w, (f, l) in enumerate(zip(self.first, self.last)):
            if l > f:
                out[w] = np.round(positions[f:l].sum() / (l - f))
        return out


def plan(opts: dict, positions: np.ndarray) -> Windows:
    """Coordinate windows over one scaffold's sorted positions: [1 + k*step,
    size + k*step] for k = 0 up to the first window whose end reaches the
    last position."""
    if opts["windType"] != "coordinate":
        raise ValueError(f"no reference plan for windType {opts['windType']!r}")
    size = opts["windSize"]
    step = opts["stepSize"] or size
    last_pos = int(positions[-1])
    k = np.arange(max(0, -(-(last_pos - size) // step)) + 1)
    start = 1 + k * step
    end = size + k * step
    first = np.searchsorted(positions, start, side="left")
    last = np.searchsorted(positions, end, side="right")
    return Windows(start, end, first, last)


@dataclass
class Job:
    """One cell's reference computation."""
    codes: torch.Tensor             # uint8 [sites, haplotypes], 4 = N
    positions: np.ndarray           # int64 [sites]
    scaffold: str
    groups: dict                    # population -> haplotype rows, in -p order
    opts: dict                      # the cell's flags
    dtype: torch.dtype = torch.float64
    cache: dict = field(default_factory=dict)

    @property
    def windows(self) -> Windows:
        if "windows" not in self.cache:
            self.cache["windows"] = plan(self.opts, self.positions)
        return self.cache["windows"]

    @property
    def good(self) -> np.ndarray:
        return self.windows.n_sites >= self.opts["minSites"]

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == torch.float64 else np.float32


def pair_counts(codes: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(differing, shared) called-site counts of every pair of haplotypes
    over ``codes`` [..., sites, H], as [..., H, H] in ``dtype``."""
    called = (codes < MISSING).to(dtype)
    shared = called.transpose(-1, -2) @ called
    onehot = torch.cat([(codes == b).to(dtype) for b in range(4)], dim=-2)
    same = onehot.transpose(-1, -2) @ onehot
    return shared - same, shared


def distances(job: Job, codes: torch.Tensor) -> torch.Tensor:
    """The window's distance matrix [..., H, H] as groupDistStats leaves
    it: NaN where the pair shares fewer than minSites called sites (or
    none) and on the diagonal."""
    diff, shared = pair_counts(codes, job.dtype)
    d = diff / shared
    d = torch.where(shared < job.opts["minSites"],
                    torch.full_like(d, float("nan")), d)
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    return d.masked_fill(eye, float("nan"))


def window_batches(job: Job, budget_bytes: int = 2 << 30):
    """(window indices, codes [B, L, H]) batches of the reported windows,
    each window's sites padded with N to the batch's longest."""
    win = job.windows
    H = job.codes.shape[1]
    idx = np.flatnonzero(job.good)
    longest = int(win.n_sites[idx].max()) if idx.size else 0
    per = 8 * (H * H * 6 + 5 * longest * H)
    b = max(1, budget_bytes // max(per, 1))
    for k in range(0, idx.size, b):
        sel = idx[k:k + b]
        L = int(win.n_sites[sel].max())
        batch = torch.full((sel.size, L, H), MISSING, dtype=torch.uint8,
                           device=job.codes.device)
        for i, w in enumerate(sel):
            f, l = int(win.first[w]), int(win.last[w])
            batch[i, :l - f] = job.codes[f:l]
        yield sel, batch


def block_sums(job: Job) -> tuple[np.ndarray, np.ndarray]:
    """Per reported window, the sums and counts of the non-NaN distances
    of the groupDistStats matrix in each (population, population) block:
    [W, P, P] each, in the job's precision (rows of unreported windows 0)."""
    if "blocks" in job.cache:
        return job.cache["blocks"]
    H = job.codes.shape[1]
    P = len(job.groups)
    member = torch.zeros((P, H), dtype=job.dtype, device=job.codes.device)
    for p, rows in enumerate(job.groups.values()):
        member[p, torch.as_tensor(rows, device=member.device)] = 1
    W = job.windows.first.size
    sums = np.zeros((W, P, P), job.np_dtype)
    counts = np.zeros((W, P, P), job.np_dtype)
    for sel, batch in window_batches(job):
        d = distances(job, batch)
        valid = (~torch.isnan(d)).to(job.dtype)
        sums[sel] = (member @ torch.nan_to_num(d, nan=0.0) @ member.T).cpu().numpy()
        counts[sel] = (member @ valid @ member.T).cpu().numpy()
    job.cache["blocks"] = sums, counts
    return sums, counts


def gated_mean(total, count, size, min_data, dtype):
    """sum / count, NaN where the non-NaN share count / size is below
    minData (genomics.nanmean_min)."""
    total = np.asarray(total, dtype)
    count = np.asarray(count, dtype)
    size = dtype(size)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = total / count
        share = dtype(1) - (size - count) / size
    return np.where(share < dtype(min_data), dtype(np.nan), mean)


def table(job: Job, analyses, modules) -> dict:
    """The expected CSV: its columns, the kind of each (key, int, float),
    and the values of the reported windows, each column a 1-D array."""
    win = job.windows
    good = job.good
    values = {"scaffold": np.array([job.scaffold] * int(good.sum()), object),
              "start": win.start[good], "end": win.end[good],
              "mid": win.mid(job.positions)[good], "sites": win.n_sites[good]}
    kinds = dict.fromkeys(KEY_COLUMNS, "key")
    columns = list(KEY_COLUMNS)
    for name in sorted(analyses, key=lambda a: modules[a].RANK):
        mod = modules[name]
        out = mod.compute(job)
        for col, kind in mod.columns(list(job.groups)):
            columns.append(col)
            kinds[col] = kind
            values[col] = np.asarray(out[col], dtype=np.float64)[good]
    return {"columns": columns, "kinds": kinds, "values": values}
