"""Drive one run of a benchmark copy's cell on the CPU, skipping the
harness's look for a card, optionally with the port broken underneath.

    python drive.py ROOT CELL SEED SECONDS TRACE [FAULT]

ROOT holds ``benchmark/`` and ``BENCHMARK.json``; the port comes from
PYTHONPATH.  Prints run.py's result line.  FAULT is one of FAULTS, or
``slow_input``."""

import importlib.util
import os
import sys
import time

T0 = time.perf_counter()


def _alter(fn):
    """The first value of the first statistic a finalize returns, moved by
    one part in a million."""
    def altered(*a, **kw):
        out = fn(*a, **kw)
        first = next(iter(out))
        out[first] = out[first].copy()
        out[first][0] = out[first][0] * (1 + 1e-6) + 1e-6
        return out
    return altered


def _halve(fn):
    """Each window counted over the first half of its sites only."""
    def halved(alleles, first, n_sites, *a, **kw):
        return fn(alleles, first, n_sites // 2, *a, **kw)
    return halved


def _stale(fn):
    """The device's results left as allocated: every count 0."""
    import numpy as np

    class Stale:
        def __init__(self, h):
            self.h = h

        def collect(self):
            return tuple(np.zeros_like(x) for x in self.h.collect())

    def stale(*a, **kw):
        return Stale(fn(*a, **kw))
    return stale


def apply(fault: str) -> None:
    from benchmark.harness import inputs
    from genomics_general_tpu_torch.kernels import pairdist
    from genomics_general_tpu_torch.stats import popgen
    if fault == "altered":
        popgen.group_dist_stats_from_blocks = _alter(
            popgen.group_dist_stats_from_blocks)
    elif fault == "half":
        pairdist.window_pair_block_stats_dispatch = _halve(
            pairdist.window_pair_block_stats_dispatch)
    elif fault == "stale":
        pairdist.window_pair_block_stats_dispatch = _stale(
            pairdist.window_pair_block_stats_dispatch)
    elif fault == "slow_input":
        make = inputs.make

        def slow(*a, **kw):
            time.sleep(SLOW_INPUT_S)
            return make(*a, **kw)
        inputs.make = slow


FAULTS = ("altered", "half", "stale")
# not a fault: the making of an input slowed, which set-up must not count
SLOW_INPUT_S = 15.0


def main() -> int:
    root, cell, seed, seconds, trace = sys.argv[1:6]
    fault = sys.argv[6] if len(sys.argv) > 6 else ""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "bench_run", os.path.join(root, "benchmark", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    if fault:
        apply(fault)
    from benchmark.harness import cell as harness
    out = harness.run_cell(cell, int(seed), float(seconds), trace == "1",
                           T0, run.log)
    return run.emit(cell, out, trace == "1")


if __name__ == "__main__":
    sys.exit(main())
