"""count_genotype_patterns, fasta_transfer, geno_to_eigenstrat,
geno_to_plink, geno_to_seq, geno_to_vcf, jackknife, maf_to_geno,
merge_geno, seq_to_geno, sequence, transfer_scaf_pos and window_stats
through the PyTorch port (GGT_DEVICE=cpu; host-only, no kernel): their 34
goldens byte for byte through ``python -m genomics_general_tpu_torch.cli``
with the JAX tests' arguments (chip_smoke.HOST_GOLDENS, which run T also
runs on the card), the jackknife byte-equal to the JAX CLI, the
small-chunk streaming cases, and io/seqio and io/table held against the
JAX modules on inputs made from a seed."""

import random

import numpy as np
import pytest

from chip_smoke import HOST_GOLDENS, host_cli, host_golden_runs, \
    run_host_golden
from genomics_general_tpu.io import seqio as jax_seqio
from genomics_general_tpu.io import table as jax_table
from genomics_general_tpu_torch.io import seqio as port_seqio
from genomics_general_tpu_torch.io import table as port_table

from .test_streaming_clis import CASES as STREAMING
from .util import REPO, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
CLIS = {"count_genotype_patterns", "fasta_transfer", "geno_to_eigenstrat",
        "geno_to_plink", "geno_to_seq", "geno_to_vcf", "jackknife",
        "maf_to_geno", "merge_geno", "seq_to_geno", "sequence",
        "transfer_scaf_pos", "window_stats"}
GOLDEN_RUNS = sorted(n for n, r in HOST_GOLDENS.items() if r[0] in CLIS)


def test_golden_runs_cover_their_goldens():
    """The 34 goldens of these CLIs, each written by one run."""
    names = [g for n in GOLDEN_RUNS for g in HOST_GOLDENS[n][3]]
    assert len(names) == len(set(names)) == 34
    assert all((G / g).exists() for g in names)


@pytest.mark.parametrize("name", GOLDEN_RUNS)
def test_port_golden(tmp_path, name):
    _, differ = run_host_golden(host_golden_runs(tmp_path)[name], CPU)
    assert differ == []


def test_sequence_fasta_to_phylip_unwrapped(tmp_path):
    """tests/test_sequence.py's last case: its expected output is a data
    file, not a golden."""
    out = tmp_path / "o.phy"
    host_cli("sequence", ["-P", "-l", "0"], CPU, D / "sim_ref.fa", out)
    assert out.read_bytes() == (D / "sim_single.phy").read_bytes()


@pytest.mark.parametrize("args", [
    ["--blockSize", "100000", "--D"],
    ["--blockSize", "250000", "--D"],
    ["--blockSize", "100000", "--mode", "mean", "--statCol", "fd"],
    ["--blockSize", "50000", "--numCol", "ABBA", "--denCol", "BABA"],
], ids=["D", "D_250k", "mean_fd", "ratio"])
def test_jackknife_bytes_equal_jax_cli(tmp_path, args):
    """tests/test_jackknife.py's CLI case and the CLI's other modes on the
    ABBA golden: the port's bytes are the JAX CLI's."""
    args = ["-i", str(G / "abba_coord.csv"), *args]
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    run_cli("genomics_general_tpu.cli.jackknife", args + ["-o", str(want)])
    host_cli("jackknife", args + ["-o", str(got)], CPU)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text().count("\n") == 2


@pytest.mark.parametrize("name,module,make_args,out_names",
                         [c for c in STREAMING if c[0] in
                          ("count_patterns", "eigenstrat", "plink")],
                         ids=["count_patterns", "eigenstrat", "plink"])
def test_small_chunks_output_unchanged(name, module, make_args, out_names,
                                       tmp_path):
    """tests/test_streaming_clis.py's cases of these CLIs through the
    port: 30,000-byte chunks write the bytes of 16 MB ones."""
    cli = module.rsplit(".", 1)[1]

    def run(tag, chunk_bytes):
        prefix = str(tmp_path / tag)
        host_cli(cli, make_args(prefix),
                 {**CPU, "GGT_CHUNK_BYTES": str(chunk_bytes)})
        return {n: (tmp_path / (tag + n)).read_bytes() for n in out_names}

    big, small = run("big_", 16 << 20), run("small_", 30_000)
    assert big == small
    assert all(big.values())


def _fasta(rng, n, width):
    names = [f"s{k}_{rng.integers(1000)}" for k in range(n)]
    out = []
    for name in names:
        seq = "".join(rng.choice(list("ACGTNacgtn-"), rng.integers(0, 300)))
        lines = [seq[i:i + width] for i in range(0, len(seq), width)]
        out.append(f">{name} desc\n" + "\n".join(lines) + "\n")
    return "".join(out)


def _phylip(rng, n_aln, interleave):
    out = []
    for _ in range(n_aln):
        n, L = int(rng.integers(1, 6)), int(rng.integers(1, 90))
        seqs = ["".join(rng.choice(list("ACGTN"), L)) for _ in range(n)]
        out.append(f"{n} {L}")
        step = interleave or L
        for b in range(0, L, step):
            for k, s in enumerate(seqs):
                out.append(f"name{k} {s[b:b + step]}")
    return "\n".join(out) + "\n"


@pytest.mark.parametrize("seed", range(4))
def test_seqio_matches_jax(seed):
    """parse_fasta, parse_phylip (one and several alignments,
    interleaved), haplo_to_phased (ploidy 1, 2 and mixed, with and without
    names, random phase on one seed), make_haploid_names,
    make_phased_names and chunk_indices equal the JAX module's."""
    rng = np.random.default_rng(seed)
    text = _fasta(rng, int(rng.integers(1, 8)), int(rng.integers(1, 70)))
    for upper in (False, True):
        assert port_seqio.parse_fasta(text, upper) == \
            jax_seqio.parse_fasta(text, upper)
    for n_aln, inter in ((1, 0), (1, 7), (3, 0), (2, 5)):
        text = _phylip(rng, n_aln, inter)
        for as_list in (False, True):
            assert port_seqio.parse_phylip(text, as_list) == \
                jax_seqio.parse_phylip(text, as_list)
    for ploidy in (1, 2, [1, 2, 3], [2, 2, 1, 1]):
        n = 6 if isinstance(ploidy, int) else sum(ploidy)
        L = int(rng.integers(1, 40))
        seqs = ["".join(rng.choice(list("ACGTN"), L)) for _ in range(n)]
        names = [f"ind{k}" for k in range(n)]
        for kw in ({}, {"seq_names": names}):
            random.seed(seed)
            want = jax_seqio.haplo_to_phased(seqs, ploidy=ploidy,
                                             random_phase=seed == 3, **kw)
            random.seed(seed)
            got = port_seqio.haplo_to_phased(seqs, ploidy=ploidy,
                                             random_phase=seed == 3, **kw)
            assert got == want
        inds = names[:len(ploidy)] if not isinstance(ploidy, int) else names
        assert port_seqio.make_haploid_names(inds, ploidy) == \
            jax_seqio.make_haploid_names(inds, ploidy)
        assert port_seqio.make_phased_names(names, ploidy) == \
            jax_seqio.make_phased_names(names, ploidy)
    sizes = [int(x) for x in rng.integers(0, 5, 6)]
    assert port_seqio.chunk_indices(sum(sizes), sizes) == \
        jax_seqio.chunk_indices(sum(sizes), sizes)


def _table(rng, path, text_cells):
    cols = ["scaffold", "position"] + [f"c{k}" for k in range(4)]
    lines = ["\t".join(cols)]
    for s in range(3):
        pos = np.sort(rng.choice(100_000, 60, replace=False)) + 1
        for p in pos:
            vals = []
            for _ in range(4):
                r = rng.random()
                if r < 0.1:
                    vals.append(str(rng.choice(["nan", "NA"] + text_cells)))
                elif r < 0.2:
                    vals.append(f"{rng.normal():.3e}")
                else:
                    vals.append(repr(float(np.round(rng.normal(), 6))))
            lines.append("\t".join([f"sc{s}", str(p)] + vals))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("text_cells", [[], ["x", "-"]],
                         ids=["numeric", "text_cells"])
@pytest.mark.parametrize("columns", [None, ["c2", "c0"]],
                         ids=["all", "c2_c0"])
def test_read_numeric_table_matches_jax(tmp_path, text_cells, columns):
    """read_numeric_table on a table made from a seed (NaN, NA, exponents,
    and, on one set, text cells that leave the C fast path), from a path
    and from an open file: names, ids, positions and values equal the JAX
    module's (NaN where it has NaN)."""
    path = tmp_path / "t.tsv"
    _table(np.random.default_rng(len(text_cells)), path, text_cells)
    want = jax_table.read_numeric_table(str(path), columns=columns)
    got = port_table.read_numeric_table(str(path), columns=columns)
    with open(path, "rb") as f:
        got_file = port_table.read_numeric_table(f, columns=columns)
    for res in (got, got_file):
        assert res[0] == want[0] and list(res[3]) == list(want[3])
        for a, b in zip(res[1:3] + res[4:], want[1:3] + want[4:]):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
