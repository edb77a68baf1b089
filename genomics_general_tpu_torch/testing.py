"""Synthetic data generation helpers (vectorized, deterministic).

Used by bench.py and tests to produce realistic multi-population `.geno`
inputs at scale without per-site Python loops.
"""

from __future__ import annotations

import gzip

import numpy as np


def simulate_geno_bytes(n_pops: int = 4, inds_per_pop: int = 5, n_sites: int = 100_000,
                        scaffold_len: int = 10_000_000, n_scaffolds: int = 4,
                        missing: float = 0.05, seed: int = 1234,
                        multiallelic: float = 0.0) -> tuple[bytes, list[str]]:
    """Generate a phased diploid .geno file as bytes (vectorized).

    Population structure: per-site ancestral/derived pair with pop-drifted
    frequencies; ~`missing` of genotypes are N|N.  A `multiallelic`
    fraction of sites also carries a third allele on ~10% of haplotypes
    (0 draws nothing extra: the same bytes as genomics_general_tpu's
    generator).
    Returns (file_bytes, individual_names).
    """
    rng = np.random.default_rng(seed)
    inds = [f"pop{p+1}_ind{j+1}" for p in range(n_pops) for j in range(inds_per_pop)]
    n_ind = len(inds)
    H = n_ind * 2

    per_scaf = n_sites // n_scaffolds
    scafs = []
    positions = []
    for k in range(n_scaffolds):
        m = per_scaf if k < n_scaffolds - 1 else n_sites - per_scaf * (n_scaffolds - 1)
        pos = np.sort(rng.choice(np.arange(1, scaffold_len + 1), size=m, replace=False))
        scafs.append(np.full(m, k))
        positions.append(pos)
    scaf_ids = np.concatenate(scafs)
    positions = np.concatenate(positions)

    anc = rng.integers(0, 4, size=n_sites)
    der = (anc + rng.integers(1, 4, size=n_sites)) % 4
    base_f = rng.beta(0.4, 0.4, size=n_sites)
    pop_shift = rng.normal(0, 0.15, size=(n_sites, n_pops))
    pop_of_hap = np.repeat(np.arange(n_pops), inds_per_pop * 2)
    f_hap = np.clip(base_f[:, None] + pop_shift[:, pop_of_hap], 0, 1)  # [S,H]
    derived = rng.random((n_sites, H)) < f_hap
    codes = np.where(derived, der[:, None], anc[:, None]).astype(np.uint8)  # [S,H]
    if multiallelic:
        third = (anc + 1) % 4
        third = np.where(third == der, (third + 1) % 4, third)
        hit = (rng.random(n_sites) < multiallelic)[:, None] \
            & (rng.random((n_sites, H)) < 0.1)
        codes = np.where(hit, third[:, None], codes).astype(np.uint8)
    base_bytes = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]              # [S,H]

    # missing: whole genotypes (pairs of haplotypes)
    miss = rng.random((n_sites, n_ind)) < missing
    miss2 = np.repeat(miss, 2, axis=1)
    base_bytes = np.where(miss2, ord("N"), base_bytes).astype(np.uint8)

    # genotype block: "X|Y\t" per individual, last field no tab
    block = np.empty((n_sites, n_ind * 4 - 1), dtype=np.uint8)
    block[:, 0::4] = base_bytes[:, 0::2]
    block[:, 1::4] = ord("|")
    block[:, 2::4] = base_bytes[:, 1::2]
    block[:, 3::4] = ord("\t")

    prefixes = [f"scaf{int(s)+1}\t{int(p)}\t".encode()
                for s, p in zip(scaf_ids, positions)]
    block_rows = block.tobytes()
    row_len = block.shape[1]
    lines = [prefixes[i] + block_rows[i * row_len:(i + 1) * row_len]
             for i in range(n_sites)]
    header = ("#CHROM\tPOS\t" + "\t".join(inds)).encode()
    return b"\n".join([header] + lines) + b"\n", inds


def write_geno(path: str, **kwargs) -> list[str]:
    data, inds = simulate_geno_bytes(**kwargs)
    if path.endswith(".gz"):
        # multi-member gzip (~4 MB/member), the shape of real-world
        # tabix-able .geno.gz (bgzip output is multi-member too): readable
        # by any gzip consumer, and lets the native reader decompress
        # members one-shot instead of streaming a single giant member
        step = 4 << 20
        with open(path, "wb") as f:
            for i in range(0, len(data), step):
                f.write(gzip.compress(data[i:i + step],
                                      compresslevel=4, mtime=0))
    else:
        with open(path, "wb") as f:
            f.write(data)
    return inds


def write_pops_file(path: str, inds: list[str]):
    with open(path, "wt") as f:
        for ind in inds:
            f.write(f"{ind}\t{ind.rsplit('_', 1)[0]}\n")
