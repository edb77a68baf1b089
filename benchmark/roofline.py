"""The least device time a cell's work needs, counted from its inputs and
outputs, and the published peaks it is held to.

Peaks: NVIDIA H100 SXM data sheet, dense, at its full 700 W power limit:
3.35 TB/s of HBM3 and 1,979 TOP/s of int8 on the tensor cores (a card set
below 700 W runs slower; the run reports its limit beside the share).

Bytes: each window's sites at 2 bits a haplotype a site (called, and
alternate), read once for every window that covers them, plus the
window's statistics written once at 8 bytes a value.  Operations: none
are counted, as the data sheet gives no rate for the 1-bit products the
pair counts are.  So the bound is the bytes over the HBM rate, and it reads
the same work whatever kernel does it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
POWER_LIMIT_W = 700.0


def work_bytes(work: dict) -> float:
    """Bytes one pass needs to move, times the passes: ``work`` holds
    haplotypes, window_sites (sites summed over the planned windows),
    stat_values (values written) and passes."""
    per_pass = work["window_sites"] * work["haplotypes"] * 2 / 8 \
        + 8 * work["stat_values"]
    return per_pass * work["passes"]


def min_seconds(work: dict) -> float:
    return work_bytes(work) / HBM_BYTES_PER_S
