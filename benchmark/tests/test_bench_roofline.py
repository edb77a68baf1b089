"""roofline.py's counts, exactly."""

from benchmark import roofline


def test_bytes_of_a_pass():
    work = {"haplotypes": 5008, "window_sites": 200_000, "stat_values":
            148 * 25, "passes": 1}
    assert roofline.work_bytes(work) == 200_000 * 5008 * 2 / 8 + 8 * 3700
    assert roofline.work_bytes(work) == 250_429_600.0


def test_passes_and_overlap_scale_the_bytes():
    one = {"haplotypes": 145, "window_sites": 1993 * 400,
           "stat_values": 1993 * 3, "passes": 1}
    three = {**one, "passes": 3}
    assert roofline.work_bytes(one) == 1993 * 400 * 145 / 4 + 8 * 5979
    assert roofline.work_bytes(three) == 3 * roofline.work_bytes(one)
    assert roofline.min_seconds(one) == roofline.work_bytes(one) / 3.35e12


def test_peaks_are_the_data_sheet():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT8_OPS_PER_S == 1.979e15
    assert roofline.POWER_LIMIT_W == 700.0
