"""A cohort under the neutral spectrum with drifted population frequencies.

Each site draws a derived-allele count from P(i) proportional to 1/i over
all haplotypes, each super-population a frequency around it (Balding-
Nichols: Beta(p(1-F)/F, (1-p)(1-F)/F)), and each haplotype its allele from
its super-population's frequency.  A share ``third_allele_sites`` of the
sites also carries a third base among the ancestral carriers, at a
frequency drawn from the same spectrum.  Positions are distinct, uniform
over ``sequence_length``."""

from __future__ import annotations

import numpy as np
import torch

from . import _common as C


def _sites(cfg: dict, seed: int):
    n = cfg["n_sites"]
    H = C.n_haplotypes(cfg)
    rng = C.host_rng(seed, 0)
    pos = np.sort(rng.choice(cfg["sequence_length"], size=n,
                             replace=False)).astype(np.int64) + 1
    p = C.neutral_counts(rng, n, H) / H
    F = cfg["params"]["fst"]
    n_pop = len(cfg["superpopulations"])
    freq = rng.beta((p * (1 - F) / F)[:, None], ((1 - p) * (1 - F) / F)[:, None],
                    size=(n, n_pop))
    anc, der, third = C.other_bases(rng, n)
    tri = rng.random(n) < cfg["params"]["third_allele_sites"]
    q = np.where(tri, C.neutral_counts(rng, n, H) / H, 0.0)
    return pos, freq, anc, der, third, q


def positions(cfg: dict, seed: int) -> np.ndarray:
    return _sites(cfg, seed)[0]


def chunks(cfg: dict, seed: int, n_sites: int, device):
    _, freq, anc, der, third, q = _sites(cfg, seed)
    H = C.n_haplotypes(cfg)
    group = torch.as_tensor(C.haplotype_groups(cfg), device=device)

    def dev(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)
    for k, s0 in enumerate(range(0, n_sites, C.CHUNK)):
        s1 = min(s0 + C.CHUNK, n_sites)
        m = s1 - s0
        g = C.device_rng(device, seed, 1, k)
        u = torch.rand((C.CHUNK, H), generator=g, device=device)[:m]
        v = torch.rand((C.CHUNK, H), generator=g, device=device)[:m]
        miss = C.missing_calls(cfg, g, C.CHUNK, device)
        derived = u < dev(freq[s0:s1], torch.float32)[:, group]
        hit = (v < dev(q[s0:s1], torch.float32)[:, None]) & ~derived
        codes = torch.where(
            derived, dev(der[s0:s1], torch.uint8)[:, None],
            torch.where(hit, dev(third[s0:s1], torch.uint8)[:, None],
                        dev(anc[s0:s1], torch.uint8)[:, None]))
        if miss is not None:
            codes[miss[:m]] = C.MISSING
        yield codes
