"""The program's spans and counters (``engine.StageTimer`` under
``--profile``) against the device's trace, on one clock.

Nothing in the harness calls this module yet: ``cell.run_cell`` would
sample :func:`clock_pair` just before and just after its timed window and
add ``record_keys(timers, trace.device_events(prof), clock0, clock1,
n_dev)`` to a traced run's record, where per-layer metric readers read
``span_s``, ``counters`` and ``idle_by_host``.  A program whose timer keeps
no spans gives no keys."""

from __future__ import annotations

import time

ROOT_SPAN = "cli.main"


def clock_pair() -> tuple[int, int]:
    """(time.time_ns(), time.perf_counter_ns()), read back to back: the
    profiler stamps its events on the realtime clock, the program its
    spans on perf_counter."""
    return time.time_ns(), time.perf_counter_ns()


def perf_to_profiler(c0: tuple[int, int], c1: tuple[int, int]):
    """A map of a ``perf_counter_ns`` reading onto the profiler's clock,
    linear between the pairs sampled at the window's start and end (the
    realtime clock may be slewed against the monotonic one)."""
    (w0, p0), (w1, p1) = c0, c1
    off0, off1 = w0 - p0, w1 - p1
    span = max(p1 - p0, 1)
    return lambda p: p + off0 + (off1 - off0) * (p - p0) // span


def busy_intervals(events) -> dict[int, list[tuple[int, int]]]:
    """Each device's activity (``trace.device_events``) joined into
    disjoint (start, end) intervals in ns, in order."""
    per_dev: dict[int, list] = {}
    for dev, _name, start, dur in events:
        per_dev.setdefault(dev, []).append((start, start + dur))
    out = {}
    for dev, spans in sorted(per_dev.items()):
        joined: list[list[int]] = []
        for s, e in sorted(spans):
            if joined and s <= joined[-1][1]:
                joined[-1][1] = max(joined[-1][1], e)
            else:
                joined.append([s, e])
        out[dev] = [(s, e) for s, e in joined]
    return out


def timer_spans(timers) -> list[list]:
    """Every closed span of the timers, one list a timer (pass), as
    (name, thread, start ns, end ns) on perf_counter; empty for a program
    whose timer keeps no spans."""
    return [[(s.name, s.thread, s.start, s.end)
             for s in getattr(t, "spans", ()) if s.end is not None]
            for t in timers]


def span_seconds(passes) -> dict[str, float]:
    """Seconds by span name, summed over the passes and threads."""
    out: dict[str, float] = {}
    for spans in passes:
        for name, _thread, s, e in spans:
            out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def counters(timers) -> dict[str, int]:
    """The timers' counters, summed."""
    out: dict[str, int] = {}
    for t in timers:
        for k, v in getattr(t, "counters", {}).items():
            out[k] = out.get(k, 0) + v
    return out


def host_timeline(spans) -> list[tuple[int, int, str]]:
    """(start, end, name) segments, in order and disjoint, each named by
    the innermost span open over it: ``spans`` are (start, end, name) of
    one thread, nested as a thread's spans are.  Time under no span is
    left out."""
    out: list[tuple[int, int, str]] = []
    stack: list[tuple[int, str]] = []
    t = 0

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            emit(t, end, top)
            t = max(t, end)
        if stack:
            emit(t, s, stack[-1][1])
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        emit(t, end, top)
        t = max(t, end)
    return out


def main_thread_timeline(passes, to_clock) -> list[tuple[int, int, str]]:
    """The timeline of each pass's main thread (the thread of its
    ``cli.main`` span), on the profiler's clock, passes in order."""
    out = []
    for spans in passes:
        roots = [th for name, th, _s, _e in spans if name == ROOT_SPAN]
        if not roots:
            continue
        out += host_timeline([(to_clock(s), to_clock(e), name)
                              for name, th, s, e in spans if th == roots[0]])
    return sorted(out)


def idle_by_host(busy: dict, timeline, lo: int, hi: int,
                 n_devices: int) -> dict[str, float]:
    """Seconds in which a device ran nothing, in [lo, hi), by the host
    span open then (``host_timeline``; ``none`` where none is), summed
    over the devices and divided by ``n_devices`` as ``busy_s`` is.  A
    device with no activity is idle throughout."""
    out: dict[str, float] = {}

    def add(name, ns):
        out[name] = out.get(name, 0.0) + ns / 1e9 / max(n_devices, 1)
    devs = list(busy.values())
    devs += [[]] * max(n_devices - len(devs), 0)
    for intervals in devs:
        idle, t = [], lo
        for s, e in intervals:
            if s > t:
                idle.append((t, min(s, hi)))
            t = max(t, e)
            if t >= hi:
                break
        if t < hi:
            idle.append((t, hi))
        k = 0
        for a, b in idle:
            if b <= a:
                continue
            while k < len(timeline) and timeline[k][1] <= a:
                k += 1
            j, t = k, a
            while j < len(timeline) and timeline[j][0] < b:
                s, e, name = timeline[j]
                if s > t:
                    add("none", s - t)
                lo_, hi_ = max(s, t), min(e, b)
                if hi_ > lo_:
                    add(name, hi_ - lo_)
                t = max(t, hi_)
                j += 1
            if b > t:
                add("none", b - t)
    return out


def record_keys(timers, events, clock0, clock1, n_devices: int) -> dict:
    """A traced run's new record keys: ``span_s`` (seconds by span name,
    summed over the passes), ``counters`` (summed) and, with device
    ``events``, ``idle_by_host`` (each device's idle seconds in the window
    [clock0, clock1] by the innermost span of the main thread, mean over
    the devices); none for timers without spans."""
    passes = timer_spans(timers)
    if not any(passes):
        return {}
    keys = {"span_s": span_seconds(passes), "counters": counters(timers)}
    if events is not None:
        keys["idle_by_host"] = idle_by_host(
            busy_intervals(events),
            main_thread_timeline(passes, perf_to_profiler(clock0, clock1)),
            clock0[0], clock1[0], n_devices)
    return keys
