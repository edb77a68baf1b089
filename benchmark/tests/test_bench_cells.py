"""Each analysis reference against the port's CLI on the CPU, through a
whole run of each cell's flags on a small cohort of its configuration's
shape (``tiny.<cell>``, conftest.py); and set-up that leaves out the
making of the input."""

import time

from conftest import drive
from drive import SLOW_INPUT_S


def test_kg3_cell_is_correct(tiny_bench):
    out = drive(tiny_bench, "tiny.kg3.popdist", seed=2**31 + 5)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["compared"]["max_gap"]["value"] < 6e-11


def test_setup_leaves_out_the_making_of_the_input(tiny_bench):
    """A seed's first run makes its input (slowed here by SLOW_INPUT_S),
    its second finds it in the cache: both report the same set-up, not the
    first one SLOW_INPUT_S longer."""
    seed = 2**31 + 41
    t0 = time.perf_counter()
    made = drive(tiny_bench, "tiny.kg3.popdist", seed=seed,
                 fault="slow_input")
    wall = time.perf_counter() - t0
    cached = drive(tiny_bench, "tiny.kg3.popdist", seed=seed,
                   fault="slow_input")
    assert made["correct"] and cached["correct"]
    first = made["metrics"]["setup_s"]["value"]
    second = cached["metrics"]["setup_s"]["value"]
    assert wall > SLOW_INPUT_S
    assert first < wall - SLOW_INPUT_S
    assert abs(first - second) < SLOW_INPUT_S / 2, (first, second)
