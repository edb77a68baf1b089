"""Seconds from the start of the process to the first timed site: imports,
CUDA context, the input (cached or made), the warm pass (host clock)."""


def read(record):
    return record.get("setup_s")
