"""The port's multi-process pieces against the JAX package's
(GGT_DEVICE=cpu): scaffold ownership, the io/bam and io/tabix copies, the
indexed per-rank input stream, MultiHostWriter with two ranks replayed in
one process, the environment contract of maybe_initialize, real
two-rank gloo collectives (int64 past 2^53, empty and unequal payloads),
and the local launcher's hang protection."""

import gzip
import io
import json
import os
import random
import sys
import time

import numpy as np
import pytest

from genomics_general_tpu.io import bam as jax_bam
from genomics_general_tpu.io import tabix as jax_tabix
from genomics_general_tpu.parallel import multihost as jax_mh
from genomics_general_tpu_torch.io import bam as port_bam
from genomics_general_tpu_torch.io import tabix as port_tabix
from genomics_general_tpu_torch.parallel import launch
from genomics_general_tpu_torch.parallel import multihost as port_mh

from .test_bam_filter import encode_record, write_bam
from .torch_multihost_util import D, rank_envs, run_group

pytestmark = pytest.mark.multihost

SIM1 = D / "sim1.geno.gz"


# ---------------------------------------------------------------- ownership

def test_owner_and_shard_predicate_match_jax():
    rng = random.Random(17)
    names = [f"scaf{k}" for k in range(1, 101)] + \
        [f"chr{k}" for k in range(1, 31)] + \
        ["".join(rng.choice("ACGTxyz_.|0123456789") for _ in range(
            rng.randint(1, 24))) for _ in range(200)] + ["", "ghostA", "é"]
    for n_procs in (1, 2, 3, 4, 7):
        owners = [port_mh.owner(n, n_procs) for n in names]
        assert owners == [jax_mh.owner(n, n_procs) for n in names]
        for rank in range(n_procs):
            port_pred = port_mh.shard_predicate(n_procs, rank)
            jax_pred = jax_mh.shard_predicate(n_procs, rank)
            assert [port_pred(n) for n in names] == \
                [jax_pred(n) for n in names]
        assert set(owners) == set(range(n_procs))


# ---------------------------------------------------------------- io copies

def test_bam_copy_matches_jax(tmp_path):
    """bgzf_compress / bgzf_blocks, and BamReader / BamWriter on a small
    alignment file, byte for byte."""
    for payload in (b"", b"x", bytes(range(256)) * 300):
        assert port_bam.bgzf_compress(payload) == \
            jax_bam.bgzf_compress(payload)
        blob = port_bam.bgzf_compress(payload) + port_bam.BGZF_EOF
        assert list(port_bam.bgzf_blocks(blob)) == \
            list(jax_bam.bgzf_blocks(blob))
    refs = [("chrA", 10000), ("chrB", 5000)]
    recs = [encode_record(0, 100 + 7 * k, f"r{k}", "ACGTN"[k % 5] * 30,
                          [("M", 10), ("I", 2), ("M", 12), ("D", 3),
                           ("S", 6)]) for k in range(40)]
    src = str(tmp_path / "in.bam")
    write_bam(src, refs, recs)
    port_rd, jax_rd = port_bam.BamReader(src), jax_bam.BamReader(src)
    assert port_rd.raw_header == jax_rd.raw_header
    assert port_rd.ref_names == jax_rd.ref_names == ["chrA", "chrB"]
    port_recs, jax_recs = list(port_rd.records()), list(jax_rd.records())
    assert len(port_recs) == 40
    for a, b in zip(port_recs, jax_recs):
        assert (a.ref_id, a.pos, a.read_name, a.flag, a.mapq, a.cigar,
                a.seq, a.raw) == (b.ref_id, b.pos, b.read_name, b.flag,
                                  b.mapq, b.cigar, b.seq, b.raw)
        assert a.aligned_pairs() == b.aligned_pairs()
    for mod, recs_ in ((port_bam, port_recs), (jax_bam, jax_recs)):
        w = mod.BamWriter(str(tmp_path / f"{mod.__name__}.bam"),
                          port_rd.raw_header)
        for r in recs_:
            w.write_record(r)
        w.close()
    assert (tmp_path / f"{port_bam.__name__}.bam").read_bytes() == \
        (tmp_path / f"{jax_bam.__name__}.bam").read_bytes()


@pytest.mark.parametrize("src, preset", [(SIM1, "geno"),
                                         (D / "sim1.vcf.gz", "vcf")],
                         ids=["geno", "vcf"])
def test_tabix_copy_matches_jax(tmp_path, src, preset):
    """bgzip_file and build_index write the JAX package's bytes; the index
    names and region queries agree, and each query returns exactly the
    records of a plain scan of the text."""
    out = {}
    for tag, T in (("port", port_tabix), ("jax", jax_tabix)):
        bgz = tmp_path / f"{tag}.bgz"
        T.bgzip_file(str(src), str(bgz))
        T.build_index(str(bgz), preset=preset)
        out[tag] = bgz
    assert out["port"].read_bytes() == out["jax"].read_bytes()
    assert (tmp_path / "port.bgz.tbi").read_bytes() == \
        (tmp_path / "jax.bgz.tbi").read_bytes()
    bgz = str(out["port"])
    port_idx = port_tabix.TabixIndex(bgz + ".tbi")
    jax_idx = jax_tabix.TabixIndex(bgz + ".tbi")
    assert port_idx.names == jax_idx.names and port_idx.names
    with gzip.open(src, "rb") as f:
        recs = [ln.rstrip(b"\n") for ln in f if not ln.startswith(b"#")]
    chrom0 = port_idx.names[0]
    queries = [(chrom0, 1, 50_000), (chrom0, 20_000, 20_500),
               (port_idx.names[-1], 100_000, 200_000),
               (chrom0, 1, (1 << 62)), ("absent", 1, 1000)]
    for chrom, start, end in queries:
        got = list(port_tabix.region_lines(bgz, chrom, start, end))
        assert got == list(jax_tabix.region_lines(bgz, chrom, start, end))
        plain = [ln for ln in recs if ln.split(b"\t")[0].decode() == chrom
                 and start <= int(ln.split(b"\t")[1]) <= end]
        if preset == "geno":
            assert got == plain
        else:                      # VCF records span their REF allele
            assert set(plain) <= set(got)


def test_indexed_input_stream_matches_jax(tmp_path):
    """Each rank's stream: the header and its owned scaffolds' lines, the
    same bytes as the JAX package's, and every rank's lines together are
    the file's; no index gives (None, None)."""
    bgz = tmp_path / "sim1.geno.bgz"
    port_tabix.bgzip_file(str(SIM1), str(bgz))
    port_tabix.build_index(str(bgz), preset="geno")
    with gzip.open(SIM1, "rb") as f:
        text = f.read()
    header, body = text.split(b"\n", 1)
    parts = []
    for n_procs in (1, 2, 3):
        for rank in range(n_procs):
            streams = {}
            for tag, mh in (("port", port_mh), ("jax", jax_mh)):
                stream, names = mh.indexed_input(
                    str(bgz), mh.shard_predicate(n_procs, rank))
                assert names == ["scaf1", "scaf2"]
                chunks = []
                while True:
                    c = stream.read(4099)
                    if not c:
                        break
                    chunks.append(c)
                streams[tag] = b"".join(chunks)
            assert streams["port"] == streams["jax"]
            assert streams["port"].startswith(header + b"\n")
            if n_procs == 2:
                parts.append(streams["port"][len(header) + 1:])
    assert parts[0] == b""                        # rank 0 owns nothing
    assert b"".join(parts) == body
    assert port_mh.indexed_input(str(SIM1), lambda n: True) == (None, None)
    assert port_mh.indexed_input(None, lambda n: True) == (None, None)


# ---------------------------------------------------------------- the writer

ORDER = ["s1", "s2", "s3", "s4", "s5"]           # s5: rows on no rank
ROWS = {"ghostB": (1, ["ghostB,1\n"]),            # absent from the order
        "s1": (1, [f"s1,{i},{'x' * (i % 7)}\n" for i in range(30)]),
        "s2": (0, [f"s2,{i}\n" for i in range(5)]),
        "s3": (1, [f"s3,{i}\n" for i in range(12)]),
        "s4": (0, [f"s4,{i},{'y' * i}\n" for i in range(9)]),
        "ghostA": (0, ["ghostA,1\n"])}
ONE_PROCESS = "".join(r for s in ORDER + ["ghostA", "ghostB"]
                      for r in ROWS.get(s, (0, []))[1])


class _Sink(io.StringIO):
    def close(self):                              # keep the text readable
        pass


def _blocks(mh, rank):
    w = mh.MultiHostWriter()
    for s, (owner, rows) in ROWS.items():
        if owner == rank:
            for r in rows:
                w.write_row(s, r)
    out = _Sink()
    w.finish(out if rank == 0 else None, "head\n", ORDER)
    return out.getvalue(), w.peak_buffered


def _keyed(mh, rank):
    w = mh.MultiHostWriter()
    for key in range(rank, 40, 2):                # the ranks interleave
        w.write_row("ignored", f"row{key}\n", order_key=39 - key)
    out = _Sink()
    w.finish(out if rank == 0 else None, "head\n", ORDER)
    return out.getvalue(), w.peak_buffered


def _incremental(mh, rank):
    out = _Sink()
    w = mh.MultiHostWriter(incremental_every=2, open_out=lambda: out,
                           header="head\n")
    for s in ("ghostA", "ghostB"):
        if ROWS[s][0] == rank:
            w.write_row(s, ROWS[s][1][0])
    for k, s in enumerate(ORDER):
        owner, rows = ROWS.get(s, (None, []))
        if owner == rank:
            for r in rows:
                w.write_row(s, r)
        w.maybe_gather(k + 1, ORDER)              # scaffold k is done
    w.maybe_gather(len(ORDER), ORDER)
    w.finish(None, "head\n", ORDER)
    return out.getvalue(), w.peak_buffered


def _replay(mh, monkeypatch, script):
    """Two ranks of ``script`` in one process: rank 1 runs first and its
    gather payloads are kept; rank 0's k-th gather returns [its own, rank
    1's k-th].  Both ranks must make the same number of gathers."""
    monkeypatch.setattr(mh.MultiHostWriter, "SEGMENT_RAW", 64)
    sent = []
    monkeypatch.setattr(mh, "process_index", lambda: 1)
    monkeypatch.setattr(mh, "allgather_bytes",
                        lambda p: sent.append(p) or [b"", p])
    text1, peak1 = script(mh, 1)
    replies = iter(sent)
    monkeypatch.setattr(mh, "process_index", lambda: 0)
    monkeypatch.setattr(mh, "allgather_bytes", lambda p: [p, next(replies)])
    text0, peak0 = script(mh, 0)
    assert next(replies, None) is None
    assert text1 == ""
    return text0, len(sent), (peak0, peak1)


@pytest.mark.parametrize("script, expect", [
    (_blocks, "head\n" + ONE_PROCESS),
    (_keyed, "head\n" + "".join(f"row{k}\n" for k in range(39, -1, -1))),
    (_incremental, "head\n" + ONE_PROCESS),
], ids=["blocks", "keyed", "incremental"])
def test_writer_two_ranks_replayed_match_jax(monkeypatch, script, expect):
    """Scaffold blocks (a scaffold no rank saw, two absent from the order),
    keyed rows and incremental rounds: rank 0 writes the one-process
    bytes, as the JAX writer does, after the same gathers."""
    port = _replay(port_mh, monkeypatch, script)
    jax = _replay(jax_mh, monkeypatch, script)
    assert port == jax
    assert port[0] == expect
    assert port[1] == (3 if script is _incremental else 1)


# ------------------------------------------------------- the process group

def test_one_process_without_environment(monkeypatch):
    for k in ("GGT_COORDINATOR", "GGT_NUM_PROCS", "GGT_PROC_ID",
              "GGT_DIST_AUTO"):
        monkeypatch.delenv(k, raising=False)
    port_mh.maybe_initialize()
    monkeypatch.setenv("GGT_NUM_PROCS", "1")
    port_mh.maybe_initialize()
    assert (port_mh.process_count(), port_mh.process_index()) == (1, 0)
    arr = np.arange(6, dtype=np.int64).reshape(2, 3)
    assert port_mh.collective_reduce(arr, "sum") is arr
    assert port_mh.allgather_bytes(b"abc") == [b"abc"]


@pytest.mark.parametrize("env, missing", [
    ({"GGT_NUM_PROCS": "2"}, ["GGT_COORDINATOR", "GGT_PROC_ID"]),
    ({"GGT_NUM_PROCS": "2", "GGT_PROC_ID": "1"}, ["GGT_COORDINATOR"]),
    ({"GGT_COORDINATOR": "127.0.0.1:1"}, ["GGT_NUM_PROCS", "GGT_PROC_ID"]),
    ({"GGT_COORDINATOR": "127.0.0.1:1", "GGT_NUM_PROCS": "2"},
     ["GGT_PROC_ID"]),
], ids=["procs_only", "no_coordinator", "coordinator_only", "no_rank"])
def test_incomplete_environment_raises(monkeypatch, env, missing):
    """Where the JAX package runs one process or fails with a bare
    KeyError, the port refuses with a ValueError naming what is missing."""
    for k in ("GGT_COORDINATOR", "GGT_NUM_PROCS", "GGT_PROC_ID",
              "GGT_DIST_AUTO"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as e:
        port_mh.maybe_initialize()
    for name in missing:
        assert name in str(e.value)
    assert port_mh.process_count() == 1


_COLLECTIVES = r"""
import json, sys
import numpy as np
from genomics_general_tpu_torch.parallel import multihost as mh
mh.maybe_initialize()
r, n = mh.process_index(), mh.process_count()
big = np.array([[2**60 + 3 * r, -(2**55) - r], [r, 2**53 + 1]], np.int64)
small = np.array([5 - r, 2 * r, -7], np.int32)
s32 = mh.collective_reduce(small, "sum")
payloads = {0: b"", 1: bytes(range(256)) * 4 + b"tail", 2: b"\x00" * 3}
res = {"rank": r, "n": n,
       "sum": mh.collective_reduce(big, "sum").tolist(),
       "min": mh.collective_reduce(big, "min").tolist(),
       "i32": [str(s32.dtype), list(s32.shape), s32.tolist()],
       "gather": [b.hex() for b in mh.allgather_bytes(payloads[r])],
       "empty": [b.hex() for b in mh.allgather_bytes(b"")]}
with open(sys.argv[1] + f".{r}", "w") as f:
    json.dump(res, f)
"""


@pytest.mark.parametrize("n", [2, 3])
def test_real_collectives(tmp_path, n):
    """collective_reduce (int64 sum and min, exact past 2^53; int32 comes
    back int32) and allgather_bytes (an empty payload, unequal lengths,
    all empty) over n gloo ranks."""
    out = tmp_path / "res"
    run_group([[sys.executable, "-c", _COLLECTIVES, str(out)]] * n,
              rank_envs(n), tmp_path / "logs", timeout=120)
    big = [np.array([[2**60 + 3 * r, -(2**55) - r], [r, 2**53 + 1]],
                    dtype=object) for r in range(n)]
    want_sum = sum(big[1:], big[0]).tolist()
    want_min = np.minimum.reduce(big).tolist()
    payloads = {0: b"", 1: bytes(range(256)) * 4 + b"tail", 2: b"\x00" * 3}
    for r in range(n):
        res = json.loads((tmp_path / f"res.{r}").read_text())
        assert (res["rank"], res["n"]) == (r, n)
        assert res["sum"] == want_sum and res["min"] == want_min
        assert res["sum"][0][0] == n * 2**60 + 3 * sum(range(n))
        assert res["i32"] == ["int32", [3],
                              [5 * n - sum(range(n)), 2 * sum(range(n)),
                               -7 * n]]
        assert [bytes.fromhex(h) for h in res["gather"]] == \
            [payloads[k] for k in range(n)]
        assert res["empty"] == [""] * n



# ---------------------------------------------------------------- launch

_SLEEP = "import time; time.sleep(120)"
_FAIL = "import sys; print('rank failed', file=sys.stderr); sys.exit(3)"


@pytest.mark.parametrize("scripts, timeout, expect", [
    ([_SLEEP, _FAIL], 200, "process 1 exited 3"),
    ([_SLEEP, _SLEEP], 2, "outlasted 2 s"),
], ids=["one_fails", "deadline"])
def test_run_group_kills_the_rest(tmp_path, scripts, timeout, expect):
    """A rank that fails, or a group past its deadline, ends the group at
    once: a rank left waiting (at a rendezvous whose peer died) is killed,
    not waited for."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=expect):
        launch.run_group([[sys.executable, "-c", c] for c in scripts],
                         [dict(os.environ)] * len(scripts), tmp_path, timeout)
    assert time.monotonic() - t0 < 60


def test_run_group_returns_each_output(tmp_path):
    got = launch.run_group(
        [[sys.executable, "-c", f"import sys; print({k}); "
          f"print({k} * 10, file=sys.stderr)"] for k in range(3)],
        [dict(os.environ)] * 3, tmp_path, 200)
    assert [(o.strip(), e.strip()) for o, e in got] == \
        [("0", "0"), ("1", "10"), ("2", "20")]
