"""Each metric reader on a recorded traced run's record (kg3.popdist on
an NVIDIA H100 80GB HBM3 at 700 W, seed 2147484004, 10 s: the record
run.py logs), and on records that hold nothing for it."""

import json
from pathlib import Path

import pytest

from benchmark import roofline
from benchmark.harness import spec, trace

RECORD = json.loads((Path(__file__).parent / "data" /
                     "kg3.popdist.traced.json").read_text())
BENCH = spec.benchmark()


def read(name, record=RECORD):
    return spec.metric_reader(name).read(record)


def test_every_metric_of_benchmark_json_has_a_reader():
    for entry in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(spec.metric_reader(entry["name"]), "read")


def test_lane_shares():
    wall = RECORD["traced_pass_wall_s"]
    for lane in ("parse", "dispatch", "collect"):
        assert read(f"{lane}_busy_pct") == pytest.approx(
            100 * RECORD["lanes"][lane] / wall, rel=1e-15)
    assert read("parse_busy_pct") == pytest.approx(71.3018, abs=1e-4)


def test_launches_per_window_is_a_repeatable_count():
    assert sum(RECORD["launches"].values()) == 114
    assert read("launches_per_window") == 114 / (148 * 2)


def test_roofline_and_idle():
    bytes_ = 2 * (200_000 * 5008 / 4 + 8 * 148 * 25)
    assert roofline.work_bytes(RECORD["work"]) == bytes_
    want = 100 * bytes_ / 3.35e12 / RECORD["device"]["kernel_s"]
    assert read("kernels_roofline") == pytest.approx(want, rel=1e-15)
    assert 0 < read("kernels_roofline") <= 100
    dev = RECORD["device"]
    assert read("device_idle_pct") == pytest.approx(
        100 * (1 - dev["busy_s"] / dev["window_s"]), rel=1e-15)


def test_end_to_end():
    assert read("sites_per_s") == 200_000 * 2 / RECORD["elapsed_s"]
    assert read("setup_s") == RECORD["setup_s"]


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_nothing_to_read_gives_none(name):
    plain = {k: v for k, v in RECORD.items()
             if k not in ("lanes", "launches", "device", "stages")}
    assert read(name, plain) is None


def test_device_busy_joins_each_cards_intervals():
    ev = [(0, "k1", 0, 10), (0, "Memcpy HtoD", 5, 10), (0, "k2", 30, 5),
          (1, "k1", 0, 20), (1, "k1", 100, 1)]
    got = trace.summarize(ev, n_devices=4)
    assert got["busy_s_by_device"] == {"0": 20e-9, "1": 21e-9}
    assert got["busy_s"] == pytest.approx(41e-9 / 4, rel=1e-12)
    assert got["kernel_s"] == pytest.approx(36e-9, rel=1e-12)
    assert got["kernel_events"] == 4
