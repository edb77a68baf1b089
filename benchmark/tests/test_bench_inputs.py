"""The input files: one gzip stream of the generated text, the pops
file, and the per-seed cache."""

import gzip
import zlib

import numpy as np
import torch

from benchmark.harness import inputs, spec
from conftest import TINY_KG


def test_parallel_gzip_is_one_member(tmp_path):
    pieces = [bytes(np.random.default_rng(i).integers(65, 70, 50_000,
                                                      dtype=np.uint8))
              for i in range(5)]
    s = inputs.GzipStream(tmp_path / "x.gz", threads=3)
    for p in pieces:
        s.write(p)
    s.close()
    raw = (tmp_path / "x.gz").read_bytes()
    d = zlib.decompressobj(wbits=31)
    assert d.decompress(raw) == b"".join(pieces)
    assert d.eof and d.unused_data == b""
    assert gzip.decompress(raw) == b"".join(pieces)


def test_text_of_phased_calls():
    codes = torch.tensor([[0, 1, 4, 3], [2, 2, 0, 1]], dtype=torch.uint8)
    rows = inputs.format_rows(codes, "phased")
    txt = inputs.text("s1", np.array([5, 123]), rows)
    assert txt == b"s1\t5\tA|C\tN|T\ns1\t123\tG|G\tA|C\n"


def tiny_kg(n_sites: int) -> dict:
    return {**spec.config("kg3_superpops"), **TINY_KG, "n_sites": n_sites}


def test_cache_makes_once_and_matches_generator(tmp_path):
    cfg = tiny_kg(3000)
    work = {"sites": 2500}
    logs = []
    a = inputs.get(cfg, work, 9, "cpu", logs.append, cache=tmp_path)
    assert a.made_s is not None and len(logs) == 1
    b = inputs.get(cfg, work, 9, "cpu", logs.append, cache=tmp_path)
    assert b.made_s is None and b.geno == a.geno and len(logs) == 1
    lines = gzip.decompress(a.geno.read_bytes()).decode().splitlines()
    names = lines[0].split("\t")[2:]
    assert len(lines) == 2501 and len(names) == 22
    gen = spec.generator("neutral_drift")
    codes = torch.cat(list(gen.chunks(cfg, 9, 2500, "cpu")))
    pos = gen.positions(cfg, 9)
    for i in (0, 1234, 2499):
        f = lines[1 + i].split("\t")
        assert f[0] == "chr20" and int(f[1]) == pos[i]
        assert "".join(f[2:]).replace("|", "") == \
            "".join("ACGTN"[c] for c in codes[i].tolist())
    pops = a.pops.read_text().splitlines()
    assert [p.split("\t")[0] for p in pops] == names
    assert {p.split("\t")[1] for p in pops} == set(TINY_KG["superpopulations"])


def test_cache_keeps_few_entries(tmp_path):
    cfg = tiny_kg(600)
    work = {"sites": 500}
    for seed in range(inputs.KEEP + 3):
        inputs.get(cfg, work, seed, "cpu", lambda m: None, cache=tmp_path)
    assert len([p for p in tmp_path.iterdir()]) == inputs.KEEP
