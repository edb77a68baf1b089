"""Wire v3 in the PyTorch port: the port's packer makes the JAX packer's
bytes, and the port's plain unpack of one buffer equals the JAX unpack."""

import numpy as np
import pytest
import torch

from genomics_general_tpu.kernels import pairdist as jax_pair
from genomics_general_tpu.kernels import transfer as jax_transfer
from genomics_general_tpu_torch.kernels import transfer as port_transfer

from .test_pair_v2 import messy_alleles


def _case(name, rng):
    """(alleles, first, n_sites) for each input pattern."""
    if name == "messy":
        a = messy_alleles(rng, H=14, S=900)
    elif name == "messy_s_mod8":
        a = messy_alleles(rng, H=9, S=1003)
    elif name == "all_missing":
        a = np.full((6, 301), -1, np.int8)
    elif name == "all_monomorphic":
        a = np.full((8, 600), 2, np.int8)
    elif name == "mixed_classes":
        a = messy_alleles(rng, H=12, S=700)
        a[:, 100:150] = -1                                   # all missing
        a[:, 150:250] = 3                                    # clean mono
        a[:, 250:300] = 1
        a[rng.integers(0, 12, 50), np.arange(250, 300)] = -1  # mono + missing
    S = a.shape[1]
    first = np.array([0, S // 4, S // 3, S // 2], np.int32)
    n = np.array([S // 2, S // 2, S - S // 3, S - S // 2], np.int32)
    return a, first, n


CASES = ["messy", "messy_s_mod8", "all_missing", "all_monomorphic",
         "mixed_classes"]


@pytest.mark.parametrize("name", CASES)
def test_pack_matches_jax_bytes(name):
    a, first, n = _case(name, np.random.default_rng(3))
    got = port_transfer.pack_pair_wire_v3(a, first, n, 8)
    want = jax_transfer.pack_pair_wire_v3(a, first, n, 8)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("name", CASES)
def test_plain_unpack_matches_jax(name):
    a, first, n = _case(name, np.random.default_rng(4))
    wp = 8
    buf, SpB, SpC, SpD, ep, _ = jax_transfer.pack_pair_wire_v3(a, first, n,
                                                               wp)
    H = a.shape[0]
    want = jax_transfer.unpack_pair_wire_v3(buf, SpB, SpC, SpD, H, wp, ep)
    wire = port_transfer.from_jax_wire(buf, SpB, SpC, SpD, H, wp, ep)
    got = port_transfer.unpack_pair_wire_v3(wire)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_from_jax_wire_rejects_bad_sizes():
    a, first, n = _case("messy", np.random.default_rng(5))
    buf, SpB, SpC, SpD, ep, _ = jax_transfer.pack_pair_wire_v3(a, first, n, 8)
    with pytest.raises(ValueError):
        port_transfer.from_jax_wire(buf[:-1], SpB, SpC, SpD, a.shape[0], 8,
                                    ep)
    with pytest.raises(ValueError):
        port_transfer.from_jax_wire(buf.view(np.int8), SpB, SpC, SpD,
                                    a.shape[0], 8, ep)


def test_wire_views_share_the_buffer():
    """The kernels read the planes in place: the typed views alias the
    uploaded bytes (no device-side unpack on the kernel path)."""
    a, first, n = _case("messy", np.random.default_rng(6))
    v3 = jax_pair._v3_flush_args(a, first, n)
    buf, SpB, SpC, SpD, H, wp = v3[:6]
    wire = port_transfer.from_jax_wire(buf, SpB, SpC, SpD, H, wp, v3[10])
    base = wire.buf.data_ptr()
    assert wire.cB.data_ptr() == base
    assert wire.meta.data_ptr() - base == H * (SpB + SpC + 2 * SpD) // 8
    assert wire.cD.shape == (H, SpD // 32)
