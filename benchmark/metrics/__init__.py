"""Metric readers, one file a metric, named as in BENCHMARK.json.  Each has
``read(record) -> float | None``: the metric from a run's record (see
harness/cell.py), or None when the record holds nothing to read."""
