"""The port's one-transfer flush pair counts (``_fused_flush_pair_counts``:
K20's plain version on the CPU) against the JAX package's
``pairdist._fused_flush_pair_counts`` on the same ``pack_flush_buffer``
bytes: tri-packed counts exactly, in the JAX output type."""

import jax
import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu_torch.kernels import pairdist as port_pair
from genomics_general_tpu_torch.kernels import transfer as port_transfer


def flush(H: int, S: int, seed: int, wp: int, min_bucket: int):
    """Codes -1..3 with multi-allelic sites and an all-missing block;
    windows of 0 and 1 site, overlapping windows, one running to the last
    site, and pad windows W..wp."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, size=(H, S)).astype(np.int8)
    a[rng.random((H, S)) < 0.12] = -1
    a[rng.integers(0, H, S // 3), rng.integers(0, S, S // 3)] = 3
    a[:, 5:9] = -1
    first = np.array([0, 3, 4, 0, S - 7, 2, S - 1], dtype=np.int32)
    n = np.array([S // 2, 0, 1, S, 7, S // 3, 1], dtype=np.int32)
    buf, sp = port_transfer.pack_flush_buffer(a, first, n, wp, min_bucket)
    want, sp_jax = jax_transfer.pack_flush_buffer(a, first, n, wp,
                                                  min_bucket)
    assert sp == sp_jax
    np.testing.assert_array_equal(buf, want)
    return a, first, n, buf, sp


# (H, S, wp, min_bucket, s_max, chunk): the default bucket (aligned
# metadata); a small bucket whose metadata starts unaligned; s_max below a
# window's length (the JAX gather keeps s_max slots); the int32 branch
# (s_max >= 2^16); chunk < wp
CASES = {
    "aligned": (13, 1003, 8, 1 << 16, 1024, 8),
    "unaligned": (13, 37, 8, 8, 64, 8),
    "s_max_cut": (7, 300, 16, 8, 64, 4),
    "int32": (5, 200, 8, 8, 1 << 16, 2),
    "chunked": (20, 517, 16, 8, 1024, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_flush_pair_counts_match_jax(name):
    H, S, wp, min_bucket, s_max, chunk = CASES[name]
    a, first, n, buf, sp = flush(H, S, len(name), wp, min_bucket)
    if name == "unaligned":
        assert (H * (sp // 4 + sp // 8)) % 4
    want = np.asarray(jax_pair._fused_flush_pair_counts(
        jax.device_put(buf), sp, H, wp, s_max, chunk))
    got = port_pair._fused_flush_pair_counts(torch.from_numpy(buf), sp, H,
                                             wp, s_max, chunk)
    T = H * (H + 1) // 2
    assert got.shape == (wp, 2 * T)
    assert got.dtype == (torch.uint16 if s_max < (1 << 16) else torch.int32)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[first.shape[0]:].any()            # pad windows
    assert not got[1].any()                          # the 0-site window


def test_fused_flush_pair_counts_equal_tri_route():
    """On a flush whose windows all fit s_max, the one-transfer counts
    equal the tri route of the same windows (plain K9 + K4 on the unpacked
    matrix) and the JAX gathered counts."""
    H, S, wp = 11, 400, 8
    a, first, n, buf, sp = flush(H, S, 3, wp, 8)
    got = port_pair._fused_flush_pair_counts(torch.from_numpy(buf), sp, H,
                                             wp, 512, wp)
    al, f, k = port_transfer.unpack_flush_buffer(buf, sp, H, wp)
    tri = port_pair.flush_tri_4state(al, f, k, wp, True, 512)
    np.testing.assert_array_equal(got.numpy(), tri.numpy())
    W = first.shape[0]
    gathered = np.asarray(jax_pair._gathered_pair_counts(
        jax.device_put(a), first, n, 512))
    np.testing.assert_array_equal(got.numpy()[:W], gathered)


@pytest.mark.parametrize("chunk", [0, 3])
def test_fused_flush_pair_counts_chunk_must_divide(chunk):
    _, _, _, buf, sp = flush(5, 50, 1, 8, 8)
    with pytest.raises(ValueError, match="divide"):
        port_pair._fused_flush_pair_counts(torch.from_numpy(buf), sp, 5, 8,
                                           64, chunk)
