"""What the generators share: the sample layout of a configuration, seeding,
and the neutral site-frequency spectrum.

Codes: 0-3 are the bases A, C, G, T and 4 is a missing call (N).  Every
generator draws its site-level parameters for the configuration's whole
``n_sites`` on the host (numpy) and its per-haplotype draws on the device in
pieces of ``CHUNK`` sites, each piece from a torch generator seeded by
(seed, piece): the first n sites of a cell are the same whatever its length,
and the same seed gives the same codes on one kind of device."""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 4096
MISSING = 4


def seed_sequence(seed: int, *key: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % (1 << 64), *key])


def host_rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(seed_sequence(seed, *key))


def device_rng(device, seed: int, *key: int) -> torch.Generator:
    state = int(seed_sequence(seed, *key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def samples(cfg: dict) -> list[tuple[str, str]]:
    """(name, super-population) of each individual, in file order: the
    configuration's population runs one after another."""
    out = []
    for pop, sup, n in cfg["populations"]:
        width = max(3, len(str(n)))
        sep = "-" if pop == sup else ""
        out += [(f"{pop}{sep}{i + 1:0{width}d}", sup) for i in range(n)]
    if len(out) != cfg["n_individuals"]:
        raise ValueError(f"{cfg['name']}: populations hold {len(out)} "
                         f"individuals, n_individuals is {cfg['n_individuals']}")
    return out


def haplotype_groups(cfg: dict) -> np.ndarray:
    """Index (into the configuration's super-populations) of each haplotype
    row, in file order: ``ploidy`` rows an individual."""
    names = list(cfg["superpopulations"])
    per_ind = np.array([names.index(s) for _, s in samples(cfg)])
    return np.repeat(per_ind, cfg["ploidy"])


def n_haplotypes(cfg: dict) -> int:
    return cfg["n_individuals"] * cfg["ploidy"]


def neutral_counts(rng: np.random.Generator, n: int, total: int) -> np.ndarray:
    """``n`` derived-allele counts in 1..total-1 with P(i) proportional to
    1/i (the neutral spectrum)."""
    inv = 1.0 / np.arange(1, total)
    cdf = np.cumsum(inv) / inv.sum()
    k = np.searchsorted(cdf, rng.random(n), side="right") + 1
    return np.minimum(k, total - 1)


def other_bases(rng: np.random.Generator, n: int):
    """(ancestral, derived, third) bases of ``n`` sites, all distinct."""
    anc = rng.integers(0, 4, n)
    der = (anc + rng.integers(1, 4, n)) % 4
    third = (anc + 1) % 4
    third = np.where(third == der, (third + 1) % 4, third)
    third = np.where(third == anc, (third + 1) % 4, third)
    third = np.where(third == der, (third + 1) % 4, third)
    return anc, der, third


def missing_calls(cfg: dict, rng: torch.Generator, rows: int,
                  device) -> torch.Tensor | None:
    """Which calls are N: each individual's call (all its haplotypes) with
    probability ``missing``; None when the configuration has none."""
    p = cfg.get("missing", 0.0)
    if not p:
        return None
    per_ind = torch.rand((rows, cfg["n_individuals"]), generator=rng,
                         device=device) < p
    return per_ind.repeat_interleave(cfg["ploidy"], dim=1)
