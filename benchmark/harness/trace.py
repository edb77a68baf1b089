"""Reading the traced window: the device's activity from torch.profiler,
the program's stage timer (``engine.StageTimer``, its lanes) and its
kernel launch counters (``LAUNCHES`` of each ``kernels`` module)."""

from __future__ import annotations

import contextlib
import importlib
import pkgutil

COPY_PREFIXES = ("Memcpy", "Memset")


def device_events(prof) -> list[tuple[int, str, int, int]]:
    """(device index, name, start ns, duration ns) of every activity the
    profiler saw on a CUDA device: kernels, copies and sets."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
        dur = e.duration_ns() if hasattr(e, "duration_ns") \
            else 1000 * e.duration_us()
        out.append((e.device_index(), e.name(), int(start), int(dur)))
    return out


def _union_ns(spans: list[tuple[int, int]]) -> int:
    total, end = 0, None
    for s, d in sorted(spans):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(events, n_devices: int) -> dict:
    """busy_s: seconds in which some activity ran, each device's union of
    intervals, averaged over the run's ``n_devices``; kernel_s: kernel
    (not copy) seconds summed over devices; ops: seconds by name."""
    per_dev: dict[int, list] = {}
    kernel_ns = 0
    ops: dict[str, int] = {}
    n_kernels = 0
    for dev, name, start, dur in events:
        per_dev.setdefault(dev, []).append((start, dur))
        ops[name] = ops.get(name, 0) + dur
        if not name.startswith(COPY_PREFIXES):
            kernel_ns += dur
            n_kernels += 1
    busy = {str(d): _union_ns(s) / 1e9 for d, s in sorted(per_dev.items())}
    return {"busy_s": sum(busy.values()) / max(n_devices, 1),
            "busy_s_by_device": busy,
            "kernel_s": kernel_ns / 1e9, "kernel_events": n_kernels,
            "ops": {k: v / 1e9 for k, v in ops.items()}}


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over the block, CPU and CUDA activities; yields a
    holder whose ``prof`` is set once the block has ended."""
    holder = type("Traced", (), {"prof": None})()
    if not enabled:
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder.prof = prof


def kernel_modules():
    """The port's kernel modules that count their launches."""
    from genomics_general_tpu_torch import kernels
    mods = []
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        if isinstance(getattr(mod, "LAUNCHES", None), dict):
            mods.append(mod)
    return mods


def reset_launches(mods) -> None:
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def launches(mods) -> dict:
    out = {}
    for mod in mods:
        out.update({k: v for k, v in mod.LAUNCHES.items() if v})
    return out


@contextlib.contextmanager
def stage_timers(enabled: bool):
    """While open, every ``engine.StageTimer`` the program makes is kept
    in the yielded list (the class is swapped for a recording subclass and
    put back on exit)."""
    made: list = []
    if not enabled:
        yield made
        return
    from genomics_general_tpu_torch import engine
    base = engine.StageTimer

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    engine.StageTimer = Recording
    try:
        yield made
    finally:
        engine.StageTimer = base


def lanes(timers) -> tuple[dict, dict]:
    """Stage seconds and lane busy seconds, summed over the timers."""
    stages: dict[str, float] = {}
    lane: dict[str, float] = {}
    for t in timers:
        for name, v in t.t.items():
            stages[name] = stages.get(name, 0.0) + v
            key = t.LANES.get(name, name)
            lane[key] = lane.get(key, 0.0) + v
    return stages, lane
