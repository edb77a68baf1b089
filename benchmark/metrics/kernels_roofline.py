"""The least time the traced passes' device work needs (roofline.py:
bytes from the cell's inputs and outputs over the HBM rate), over the
device kernel time torch.profiler traced, in %."""

import importlib

from pathlib import Path


def read(record):
    dev = record.get("device") or {}
    if not dev.get("kernel_s") or "work" not in record:
        return None
    roofline = importlib.import_module(
        f"{Path(__file__).resolve().parents[1].name}.roofline")
    return 100.0 * roofline.min_seconds(record["work"]) / dev["kernel_s"]
