"""parse_vcf, parse_vcfs, tabix_index, vcf_chrom_transfer,
coding_site_types, extract_cds_alignments and filter_sam_by_target_base
through the PyTorch port (GGT_DEVICE=cpu; host-only, no kernel): their 13
goldens byte for byte through ``python -m genomics_general_tpu_torch.cli``
with the JAX tests' arguments (chip_smoke.HOST_GOLDENS), the cases that
have no golden byte-equal to the JAX CLI, io/vcf, io/vcf_fast and cds held
against the JAX modules on inputs made from a seed, and every golden of
tests/golden named by a port test."""

import argparse
import dataclasses
import random

import numpy as np
import pytest

from chip_smoke import HOST_GOLDENS, host_cli, host_golden_runs, \
    run_host_golden
from genomics_general_tpu import cds as jax_cds
from genomics_general_tpu.io import vcf as jax_vcf
from genomics_general_tpu.io import vcf_fast as jax_vcf_fast
from genomics_general_tpu_torch import cds as port_cds
from genomics_general_tpu_torch.cli.parse_vcf import add_args
from genomics_general_tpu_torch.io import tabix as port_tabix
from genomics_general_tpu_torch.io import vcf as port_vcf
from genomics_general_tpu_torch.io import vcf_fast as port_vcf_fast

from .test_bam_filter import encode_record, write_bam
from .test_parse_vcfs import _write_adv_vcf
from .util import REPO, run_cli

D = REPO / "tests" / "data"
G = REPO / "tests" / "golden"
CPU = {"GGT_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}
CLIS = {"parse_vcf", "parse_vcfs", "tabix_index", "vcf_chrom_transfer",
        "coding_site_types", "extract_cds_alignments",
        "filter_sam_by_target_base"}
GOLDEN_RUNS = sorted(n for n, r in HOST_GOLDENS.items() if r[0] in CLIS)
TRANS = str(D / "sim.transfers.txt")


def test_golden_runs_cover_their_goldens():
    """The 13 goldens of these CLIs, each written by one run."""
    names = [g for n in GOLDEN_RUNS for g in HOST_GOLDENS[n][3]]
    assert len(names) == len(set(names)) == 13
    assert all((G / g).exists() for g in names)


@pytest.mark.parametrize("name", GOLDEN_RUNS)
def test_port_golden(tmp_path, name):
    _, differ = run_host_golden(host_golden_runs(tmp_path)[name], CPU)
    assert differ == []


def test_extract_cds_alignments_indexed_matches_golden(tmp_path):
    """With the port's .tbi beside a BGZF geno, extraction reads by region
    and writes the streamed golden (tests/test_cds_tools.py's last case)."""
    bgz = tmp_path / "sim1.geno.bgz"
    port_tabix.bgzip_file(str(D / "sim1.geno.gz"), str(bgz),
                          block_payload=2048)
    port_tabix.build_index(str(bgz), preset="geno")
    out = tmp_path / "o.phy"
    host_cli("extract_cds_alignments", ["--annotation", str(D / "sim.gff3"),
                                        "-g", str(bgz), "-o", str(out)], CPU)
    assert out.read_bytes() == (G / "cds_aln.phy").read_bytes()


@pytest.mark.parametrize("indexed", [False, True],
                         ids=["streamed", "indexed"])
def test_vcf_chrom_transfer_bytes_equal_jax_cli(tmp_path, indexed):
    """tests/test_liftover.py's two vcf_chrom_transfer cases: the port,
    from the plain VCF or from a BGZF copy with its .tbi (many tiny
    blocks), writes the JAX CLI's bytes of the plain VCF."""
    vcf = G / "g2v_basic.vcf"
    want = tmp_path / "jax.vcf"
    run_cli("genomics_general_tpu.cli.vcf_chrom_transfer",
            ["-v", str(vcf), "-t", TRANS, "-o", str(want)])
    if indexed:
        bgz = tmp_path / "in.vcf.gz"
        port_tabix.bgzip_file(str(vcf), str(bgz), block_payload=512)
        port_tabix.build_index(str(bgz), preset="vcf")
        vcf = bgz
    got = tmp_path / "port.vcf"
    host_cli("vcf_chrom_transfer", ["-v", str(vcf), "-t", TRANS,
                                    "-o", str(got)], CPU)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_text().count("\n") > 100


@pytest.mark.parametrize("preset", ["geno", "vcf"])
def test_tabix_index_bytes_equal_jax_cli(tmp_path, preset):
    """bgzip and index through the port's CLI (tests/test_tabix.py's CLI
    case, and a VCF): the .bgz and .tbi bytes are the JAX CLI's, and a
    region read through them is the full scan's."""
    if preset == "geno":
        raw = tmp_path / "x.geno"
        raw.write_text("#CHROM\tPOS\ts1\n" + "".join(
            f"sc\t{p}\tA/A\n" for p in range(5, 30000, 11)))
        chrom, start, end = "sc", 1000, 1100
    else:
        raw = G / "g2v_basic.vcf"
        chrom, start, end = "scaf1", 100_000, 300_000
    files = {}
    for pkg, run in (("jax", lambda a: run_cli(
            "genomics_general_tpu.cli.tabix_index", a)),
                     ("port", lambda a: host_cli("tabix_index", a, CPU))):
        bgz = tmp_path / f"{pkg}.{preset}.bgz"
        run(["bgzip", str(raw), "-o", str(bgz)])
        run(["index", str(bgz), "--preset", preset])
        files[pkg] = [bgz.read_bytes(), (tmp_path / f"{bgz.name}.tbi")
                      .read_bytes()]
    assert files["port"] == files["jax"]
    got = list(port_tabix.region_lines(str(tmp_path / f"port.{preset}.bgz"),
                                       chrom, start, end))
    want = [ln.encode() for ln in raw.read_text().splitlines()
            if ln.split("\t")[0] == chrom
            and start <= int(ln.split("\t")[1]) <= end]
    assert got == want and want


@pytest.mark.parametrize("pure", [True, False], ids=["pure", "default"])
def test_filter_sam_by_target_base_bytes_equal_jax_cli(tmp_path, pure):
    """tests/test_bam_filter.py's BAM through the port (its pure-Python
    path, taken also by default where pysam is missing): the output BAM's
    bytes are the JAX CLI's, both records of r1 and nothing else."""
    from genomics_general_tpu_torch.io.bam import BamReader
    records = [
        encode_record(0, 95, "r1", "TTTTTAGGGG", [("M", 10)]),
        encode_record(0, 95, "r2", "TTTTTGGGGG", [("M", 10)]),
        encode_record(0, 95, "r3", "TTTTTGGGG", [("M", 4), ("D", 2),
                                                 ("M", 5)]),
        encode_record(1, 200, "r4", "ACGTACGTAC", [("M", 10)]),
        encode_record(0, 500, "r1", "CCCCCCCCCC", [("M", 10)]),
    ]
    bam = tmp_path / "in.bam"
    write_bam(str(bam), [("chrA", 10000), ("chrB", 5000)], records)
    targets = tmp_path / "targets.txt"
    targets.write_text("chrA\t101\tA\n")
    args = ["-i", str(bam), "-t", str(targets)] + (["--pure"] if pure else [])
    want, got = tmp_path / "jax.bam", tmp_path / "port.bam"
    run_cli("genomics_general_tpu.cli.filter_sam_by_target_base",
            args + ["-o", str(want)])
    host_cli("filter_sam_by_target_base", args + ["-o", str(got)], CPU)
    assert got.read_bytes() == want.read_bytes()
    recs = list(BamReader(str(got)).records())
    assert [(r.read_name, r.pos) for r in recs] == [("r1", 95), ("r1", 500)]


def _parse_vcfs(tmp_path, files, tag, env, extra):
    out = tmp_path / f"{tag}.geno"
    host_cli("parse_vcfs", [a for f in files for a in ("-i", str(f))]
             + ["-f", str(tmp_path / "g.fai"), "--minQual", "30",
                "-o", str(out), *extra], {**CPU, **env})
    return out.read_bytes()


def test_parse_vcfs_fast_matches_serial(tmp_path):
    """tests/test_parse_vcfs.py:112 through the port: the C multi-file
    merge at -t 1, 2 and 4 (2 KB chunks) writes the serial Python walk's
    bytes for union and intersect, and the JAX CLI's."""
    rng = random.Random(11)
    files = [tmp_path / f"f{k}.vcf" for k in range(1, 4)]
    _write_adv_vcf(files[0], rng, ("c1", "c2", "c4"))
    _write_adv_vcf(files[1], rng, ("c2", "c3", "c4"), samples=("t1",))
    _write_adv_vcf(files[2], rng, ("c1", "c4"), samples=("u1", "u2", "u3"))
    (tmp_path / "g.fai").write_text(
        "c1\t100000\nc2\t100000\nc3\t100000\nc4\t15000\n")
    for method in ("union", "intersect"):
        base = _parse_vcfs(tmp_path, files, "serial", {"GGT_HOST_VCF": "0"},
                           ["-M", method])
        assert base.count(b"\n") > (200 if method == "union" else 1)
        for tag, env, extra in [("t1", {}, ["-t", "1"]),
                                ("t2", {}, ["-t", "2"]),
                                ("t4c", {"GGT_VCF_CHUNK": "2048"},
                                 ["-t", "4"])]:
            got = _parse_vcfs(tmp_path, files, tag, env, ["-M", method,
                                                          *extra])
            assert got == base, (method, tag)
        want = tmp_path / "jax.geno"
        run_cli("genomics_general_tpu.cli.parse_vcfs",
                [a for f in files for a in ("-i", str(f))]
                + ["-f", str(tmp_path / "g.fai"), "--minQual", "30",
                   "-M", method, "-t", "2", "-o", str(want)])
        assert want.read_bytes() == base, method


def test_parse_vcfs_five_file_merge(tmp_path):
    """tests/test_parse_vcfs.py:208 through the port: five files with
    asymmetric scaffold sets; the C merge at -t 2 writes the serial walk's
    bytes for union and intersect, and the JAX CLI's."""
    rng = random.Random(99)
    chrom_sets = [("c1", "c2", "c3"), ("c2", "c4"),
                  ("c1", "c3", "c4", "c5"), ("c5",),
                  ("c1", "c2", "c3", "c4", "c5")]
    files = []
    for i, cs in enumerate(chrom_sets):
        files.append(tmp_path / f"f{i}.vcf")
        _write_adv_vcf(files[-1], rng, cs, n_sites=300,
                       samples=tuple(f"s{i}_{j}" for j in range(i + 1)))
    (tmp_path / "g.fai").write_text(
        "".join(f"c{k}\t100000\n" for k in range(1, 6)))
    for method in ("union", "intersect"):
        fast = _parse_vcfs(tmp_path, files, f"fast_{method}", {},
                           ["-M", method, "-t", "2"])
        slow = _parse_vcfs(tmp_path, files, f"slow_{method}",
                           {"GGT_HOST_VCF": "0"}, ["-M", method, "-t", "2"])
        assert fast == slow, method
        want = tmp_path / f"jax_{method}.geno"
        run_cli("genomics_general_tpu.cli.parse_vcfs",
                [a for f in files for a in ("-i", str(f))]
                + ["-f", str(tmp_path / "g.fai"), "--minQual", "30",
                   "-M", method, "-t", "2", "-o", str(want)])
        assert want.read_bytes() == fast, method
    assert fast.count(b"\n") >= 1


def test_parse_vcf_stdin_and_chunks_match_python(tmp_path):
    """tests/test_parse_vcf.py's stdin case and the leading-zero POS case
    at 48-byte chunks and -t 2, through the port: the C fast path writes
    the per-line Python pipeline's bytes."""
    import gzip
    text = gzip.decompress((D / "sim1.vcf.gz").read_bytes())
    stdin = tmp_path / "in.vcf"
    stdin.write_bytes(text)
    outs = {}
    for tag, env in (("fast", {}), ("slow", {"GGT_HOST_VCF": "0"})):
        outs[tag] = tmp_path / f"{tag}.geno"
        host_cli("parse_vcf", ["-o", str(outs[tag])], {**CPU, **env}, stdin)
    assert outs["fast"].read_bytes() == outs["slow"].read_bytes()
    assert outs["fast"].read_bytes() == (G / "vcf_basic.geno").read_bytes()
    lines = ["chr1\t100\t.\tA\tT\t99\tPASS\t.\tGT\t0/1\t1/1",
             "chr1\t0100\t.\tA\tC\t99\tPASS\t.\tGT\t0/0\t0/1",
             "chr1\t0100\t.\tA\tG\t99\tPASS\t.\tGT\t0/1\t0/1",
             "chr1\t200\t.\tG\tC\t99\tPASS\t.\tGT\t0/0\t1/1"]
    vcf = tmp_path / "zero.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                   "FILTER\tINFO\tFORMAT\ts0\ts1\n" + "\n".join(lines) + "\n")
    got = {}
    for tag, env, extra in (("slow", {"GGT_HOST_VCF": "0"}, []),
                            ("chunks", {"GGT_VCF_CHUNK": "48"}, ["-t", "2"])):
        out = tmp_path / f"zero_{tag}.geno"
        host_cli("parse_vcf", ["-i", str(vcf), "--excludeDuplicates",
                               *extra, "-o", str(out)], {**CPU, **env})
        got[tag] = out.read_bytes()
    assert got["chunks"] == got["slow"]
    assert got["slow"].count(b"\n") == 1 + 3


ALLELE_SETS = ["A", "C", "G", "T", "AC", "AG", "CT", "GT", "ACG", "ACGT",
               "AN", "N"]


def test_cds_matches_jax():
    """translate, possible_codons, possible_aas, syn_non and degeneracy on
    allele sets drawn from a seed (each call twice, the second from the
    memo), and parse_genes, cds_positions, cds_sequence and count_stops on
    the GFF3 and GTF fixtures with sim_ref.fa, equal the JAX module's."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        seq = "".join(rng.choice(list("ACGTN"), int(rng.integers(0, 40))))
        assert port_cds.translate(seq) == jax_cds.translate(seq)
        assert port_cds.translate(seq, "?") == jax_cds.translate(seq, "?")
    triples = [tuple(rng.choice(ALLELE_SETS, 3)) for _ in range(400)]
    for t in triples + triples:
        assert port_cds.possible_codons(*t) == jax_cds.possible_codons(*t)
        assert port_cds.possible_aas(*t) == jax_cds.possible_aas(*t)
        assert port_cds.syn_non(*t) == jax_cds.syn_non(*t)
        assert port_cds.degeneracy(*t) == jax_cds.degeneracy(*t)
    from genomics_general_tpu_torch.io.seqio import parse_fasta
    names, seqs = parse_fasta((D / "sim_ref.fa").read_text())
    ref = dict(zip(names, seqs))
    for fmt in ("gff3", "gtf"):
        lines = (D / f"sim.{fmt}").read_text().splitlines(True)
        for targets in (None, ["mRNA03", "mRNA08"]):
            got = port_cds.parse_genes(lines, fmt, targets)
            assert got == jax_cds.parse_genes(lines, fmt, targets)
            assert got
        for scaf, mrnas in got.items():
            seq_dict = {i + 1: b for i, b in enumerate(ref[scaf])}
            for m in mrnas.values():
                exons = (m["cdsStarts"], m["cdsEnds"], m["strand"])
                for trim in (False, True):
                    assert port_cds.cds_positions(*exons, trim=trim) == \
                        jax_cds.cds_positions(*exons, trim=trim)
                cds = port_cds.cds_sequence(*exons, seq_dict=seq_dict)
                assert cds == jax_cds.cds_sequence(*exons, seq_dict=seq_dict)
                for term in (False, True):
                    assert port_cds.count_stops(cds, term) == \
                        jax_cds.count_stops(cds, term)


GT_FILTERS = [["flag=DP", "min=5", "max=50"],
              ["flag=GQ", "min=30", "gtTypes=Het"],
              ["flag=DP", "max=20", "siteTypes=SNP", "samples=s1,s3"]]


def _vcf_text(rng, n_sites, n_samples, ploidies=(1, 2, 2, 2, 3)):
    head = ["##fileformat=VCFv4.2", "##contig=<ID=c1,length=90000>",
            "##contig=<ID=c2>", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t"
            "INFO\tFORMAT\t" + "\t".join(f"s{k}" for k in range(n_samples))]
    rows, pos = [], 0
    for k in range(n_sites):
        pos += int(rng.integers(0, 3))            # some duplicated positions
        ref = str(rng.choice(["A", "C", "G", "T", "AC", "GTA"]))
        n_alt = int(rng.integers(0, 4))
        alt = ",".join(rng.choice(["A", "C", "G", "T", "TT", "CAG"], n_alt)) \
            if n_alt else "."
        fmt = str(rng.choice(["GT", "GT:DP:GQ", "GT:AD:DP"]))
        samples = []
        for _ in range(n_samples):
            sep = str(rng.choice(["/", "|"]))
            gt = sep.join(str(rng.choice(["0", "1", "2", "3", "."]))
                          for _ in range(int(rng.choice(ploidies))))
            extra = {"GT": [], "GT:DP:GQ": [str(rng.integers(0, 70)),
                                            str(rng.integers(0, 99))],
                     "GT:AD:DP": [f"{rng.integers(9)},{rng.integers(9)}",
                                  str(rng.choice(["12", "."]))]}[fmt]
            samples.append(":".join([gt] + extra))
        qual = str(rng.choice(["50", "10.5", "."]))
        rows.append("\t".join([f"c{1 + k * 2 // n_sites}", str(pos), ".",
                               ref, alt, qual, "PASS", "DP=5;CIGAR=1M",
                               fmt] + samples))
    return "\n".join(head + rows) + "\n"


def _outcome(fn):
    try:
        return fn()
    except Exception as e:                     # noqa: BLE001 - compared
        return type(e).__name__


@pytest.mark.parametrize("seed", range(3))
def test_vcf_parsing_matches_jax(tmp_path, seed):
    """io/vcf on VCF text made from a seed (multi-allelic and indel sites,
    MONO sites, ploidy 1-3, missing alleles, DP/GQ/AD fields): the header,
    parse_vcf_sites with and without duplicates, every site's fields, site
    type and genotypes under 14 option sets (filters, phase, numbers,
    REF-length matching, partial calls, a ploidy table with and without
    mismatch-to-missing) and its DP field equal the JAX module's, as do
    gt_type, simplify_alt, can_float and parse_genotype_filter_arg."""
    rng = np.random.default_rng(seed)
    path = tmp_path / "x.vcf"
    path.write_text(_vcf_text(rng, 150, 5))
    head = port_vcf.get_head_data(str(path))
    assert head == jax_vcf.get_head_data(str(path))
    filters = [port_vcf.parse_genotype_filter_arg(f) for f in GT_FILTERS]
    assert filters == [jax_vcf.parse_genotype_filter_arg(f)
                       for f in GT_FILTERS]
    ploidy = {f"s{k}": 2 for k in range(5)}
    options = [{}, {"withPhase": False}, {"asNumbers": True},
               {"mustMatchREFlen": True}, {"keepPartial": True},
               {"missing": "-"}, {"allowOnly": "ACGT"},
               {"samples": ["s4", "s0"]}, {"ploidyDict": ploidy},
               {"ploidyDict": ploidy, "ploidyMismatchToMissing": True}] + \
        [{"gtFilters": [f]} for f in filters] + [{"gtFilters": filters}]
    lines = path.read_text().splitlines()
    for dedup in (False, True):
        sites = {pkg: list(mod.parse_vcf_sites(
            lines, head["mainHeaders"], excludeDuplicates=dedup,
            parseINFO=True)) for pkg, mod in (("port", port_vcf),
                                               ("jax", jax_vcf))}
        assert len(sites["port"]) == len(sites["jax"]) > 100
        for a, b in zip(sites["port"], sites["jax"]):
            for attr in ("CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                         "FILTER", "INFO", "sampleNames", "genoData",
                         "alleleDict", "lenMatchDict"):
                assert getattr(a, attr) == getattr(b, attr), attr
            assert a.getSiteType() == b.getSiteType()
            for kw in options:
                assert _outcome(lambda: a.getGenotypes(asList=True, **kw)) \
                    == _outcome(lambda: b.getGenotypes(asList=True, **kw))
            assert a.getGenoField("DP") == b.getGenoField("DP")
    for _ in range(100):
        alleles = tuple(rng.choice(["0", "1", "2", "."], rng.integers(1, 4)))
        assert port_vcf.gt_type(alleles) == jax_vcf.gt_type(alleles)
        alt = "".join(rng.choice(list("ACGT"), 6))
        cigar = "".join(f"{rng.integers(1, 4)}{rng.choice(list('MXDI'))}"
                        for _ in range(rng.integers(1, 4)))
        assert port_vcf.simplify_alt(alt, cigar) == \
            jax_vcf.simplify_alt(alt, cigar)
        s = str(rng.choice(["1", "1.5e3", ".", "nan", "x", ""]))
        assert port_vcf.can_float(s) == jax_vcf.can_float(s)


def _args(extra):
    parser = argparse.ArgumentParser()
    add_args(parser)
    return parser.parse_args(extra)


def _opts_fields(opts):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(opts).items()
            if not (isinstance(v, float) and np.isnan(v))}


@pytest.mark.parametrize("extra", [
    [], ["--skipIndels", "--minQual", "30"],
    ["--excludeDuplicates", "--addRefTrack", "-s", "s0,s2"],
    ["--keepPartial", "--ploidyMismatchToMissing", "--missing", "-",
     "--maxREFlen", "2"],
    ["--gtf", "flag=DP", "min=5", "max=50"],
    ["--gtf", "flag=GQ", "min=30", "gtTypes=Het"],
    ["--field", "DP"], ["--outSep", ",,"]],
    ids=["plain", "skip_qual", "dedup_ref", "partial", "gtf", "gtf_types",
         "field", "sep"])
def test_vcf_fast_matches_jax(tmp_path, extra):
    """io/vcf_fast on VCF text made from a seed: ineligible_reason,
    make_opts, text_chunks at 700-byte chunks (plain and gzip) and
    convert_chunk over those chunks (mostly diploid, so most lines stay in
    C), the walk carried from chunk to chunk and bail lines through one
    shared slow_line, equal the JAX module's."""
    import gzip
    text = _vcf_text(np.random.default_rng(len(extra)), 120, 4,
                     (2,) * 19 + (3,))
    path = tmp_path / "x.vcf"
    path.write_text(text)
    gz = tmp_path / "x.vcf.gz"
    gz.write_bytes(gzip.compress(text.encode(), mtime=0))
    args = _args(extra)
    filters = [port_vcf.parse_genotype_filter_arg(g)
               for g in (args.gtf or [])]
    head = port_vcf.get_head_data(str(path))
    samples = args.samples.split(",") if args.samples \
        else head["sampleNames"]
    reason = port_vcf_fast.ineligible_reason(args, filters, len(samples))
    assert reason == jax_vcf_fast.ineligible_reason(args, filters,
                                                    len(samples))
    assert (reason is None) == (extra[:1] not in (["--field"],
                                                  ["--outSep"]) and
                                "gtTypes=Het" not in extra)
    ploidy = {s: 2 for s in head["sampleNames"]}
    opts = {pkg: mod.make_opts(args, filters, head["sampleNames"], samples,
                               ploidy)
            for pkg, mod in (("port", port_vcf_fast), ("jax", jax_vcf_fast))}
    assert _opts_fields(opts["port"]) == _opts_fields(opts["jax"])
    for src in (str(path), str(gz)):
        chunks = [bytes(c) for c in port_vcf_fast.text_chunks(src, 700)]
        assert chunks == [bytes(c)
                          for c in jax_vcf_fast.text_chunks(src, 700)]
        assert len(chunks) > 5 and b"".join(chunks) == text.encode()
    if reason is not None:
        return

    def slow_line(line, prev_name, prev_pos, prev_ptext=None):
        f = line.split(b"\t")
        return b"slow\t" + f[1] + b"\n", f[0], int(f[1]), None

    for pkg, mod in (("port", port_vcf_fast), ("jax", jax_vcf_fast)):
        walk, out = (None, -1, None), []
        for chunk in chunks:
            segs, *walk = mod.convert_chunk(chunk, opts[pkg], walk[0],
                                            walk[1], slow_line, walk[2])
            out.append((segs, tuple(walk)))
        opts[pkg] = out
    assert opts["port"] == opts["jax"]
    rows = [r for segs, _ in opts["port"] for _, d in segs
            for r in bytes(d).splitlines()]
    assert sum(not r.startswith(b"slow") for r in rows) > 30


def test_every_golden_named_by_a_port_test():
    """Each of the 76 files of tests/golden is named by a port test file:
    in its text, or, for the abba, filter and sfs goldens, by the tables
    that parametrize test_torch_abba_windows, test_torch_filter_genotypes
    and test_torch_sfs."""
    from .test_torch_abba_windows import CONFIGS as ABBA
    from .test_torch_filter_genotypes import CONFIGS as FILTER
    from .test_torch_sfs import GOLDENS as SFS
    goldens = sorted(p.name for p in G.iterdir())
    assert len(goldens) == 76
    texts = [p.read_text() for p in (REPO / "tests").glob("test_torch_*.py")
             if p.name != "test_torch_vcf_cds_clis.py"]
    named = {g for g in goldens if any(g in t for t in texts)}
    named |= {g for n in HOST_GOLDENS.values() for g in n[3]}
    named |= {c[0] for c in ABBA}
    named |= {f"filter_{k}.geno" for k in FILTER}
    named |= {f"sfs_{k}_{f}.sfs" for k, (_, files) in SFS.items()
              for f in files}
    assert sorted(set(goldens) - named) == []
