"""Each generator repeats per seed, with its configuration's shapes."""

import json

import numpy as np
import pytest
import torch

from benchmark.gen import _common as C
from benchmark.harness import spec

CONFIGS = ["kg3_superpops"]


def small(name: str, n_sites: int) -> dict:
    cfg = spec.config(name)
    return {**cfg, "n_sites": n_sites}


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_repeats_per_seed(name):
    cfg = small(name, 5000)
    gen = spec.generator(cfg["generator"])
    seed = 2**31 + 17
    a = torch.cat(list(gen.chunks(cfg, seed, 4500, "cpu")))
    b = torch.cat(list(gen.chunks(cfg, seed, 4500, "cpu")))
    c = torch.cat(list(gen.chunks(cfg, seed + 1, 4500, "cpu")))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert np.array_equal(gen.positions(cfg, seed), gen.positions(cfg, seed))


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_shapes(name):
    cfg = small(name, 5000)
    gen = spec.generator(cfg["generator"])
    H = cfg["n_individuals"] * cfg["ploidy"]
    pieces = list(gen.chunks(cfg, 3, 4500, "cpu"))
    assert [p.shape for p in pieces] == [(C.CHUNK, H), (4500 - C.CHUNK, H)]
    codes = torch.cat(pieces)
    assert codes.dtype == torch.uint8 and int(codes.max()) <= C.MISSING
    pos = gen.positions(cfg, 3)
    assert pos.shape == (5000,) and (np.diff(pos) > 0).all() and pos[0] >= 1
    missing = float((codes == C.MISSING).float().mean())
    assert abs(missing - cfg["missing"]) < 0.005
    groups = C.haplotype_groups(cfg)
    assert groups.shape == (H,)
    sizes = np.bincount(groups) // cfg["ploidy"]
    assert sizes.tolist() == list(cfg["superpopulations"].values())
    assert len({n for n, _ in C.samples(cfg)}) == cfg["n_individuals"]


@pytest.mark.parametrize("name", CONFIGS)
def test_first_sites_do_not_depend_on_length(name):
    cfg = small(name, 9000)
    gen = spec.generator(cfg["generator"])
    long = torch.cat(list(gen.chunks(cfg, 11, 9000, "cpu")))
    short = torch.cat(list(gen.chunks(cfg, 11, 5000, "cpu")))
    assert torch.equal(long[:5000], short)


def test_neutral_spectrum_and_third_alleles():
    cfg = small("kg3_superpops", 4096)
    gen = spec.generator("neutral_drift")
    codes = torch.cat(list(gen.chunks(cfg, 5, 4096, "cpu"))).long()
    alleles = torch.stack([(codes == b).sum(1) for b in range(4)], 1)
    n_alleles = (alleles > 0).sum(1)
    third = float((n_alleles > 2).float().mean())
    assert 0.002 < third < 0.02
    minor = alleles.sort(1, descending=True).values[:, 1]
    # the 1/i spectrum: most sites are rare
    assert float((minor < 50).float().mean()) > 0.5


def test_configs_name_their_cuts():
    for name in CONFIGS:
        cfg = json.loads((spec.ROOT / "configs" / f"{name}.json").read_text())
        assert cfg["reduced"] and all(k in cfg for k in cfg["reduced"])
        assert cfg["assumed"] and cfg["source"]
        assert sum(cfg["superpopulations"].values()) == cfg["n_individuals"]
