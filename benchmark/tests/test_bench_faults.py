"""A run with the timed path broken underneath comes out not correct:
one fault of each kind the cells can have (drive.FAULTS): an answer
altered where it is produced, half of each window's sites left out, and
the device's results left as allocated."""

import pytest

from conftest import drive

CASES = [("tiny.kg3.popdist", "altered"), ("tiny.kg3.popdist", "half"),
         ("tiny.kg3.popdist", "stale")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny_bench, cell, fault):
    out = drive(tiny_bench, cell, seed=2**31 + 9, fault=fault)
    c = {k: v["value"] for k, v in out["compared"].items()}
    assert out["correct"] is False and out["failed"] > 0
    assert (c["layout_off"]
            or c.get("int_cells_off", 0) or c["nan_cells_off"]
            or c["max_gap"] > out["compared"]["max_gap"]["limit"]), c
