"""The share of the traced window in which no operation ran on the device
(torch.profiler: each card's busy intervals joined), the mean over the
cards, in %."""


def read(record):
    dev = record.get("device") or {}
    if not dev.get("window_s") or "busy_s" not in dev:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
