"""VCF parsing: VCF -> .geno conversion machinery.

The port of genomics_general_tpu/io/vcf.py, with the same functions and
results; it launches no kernel.

Host-side re-implementation of the reference VCF layer
(VCF_processing/parseVCF.py): per-site genotype extraction
with the genotype-filter DSL (``flag=DP min=5 max=50 siteTypes=.. gtTypes=..
samples=..``), CIGAR-based ALT simplification for freebayes output
(parseVCF.py:25-46), multi-base expansion, indel skipping via REF-length
matching, and per-(FORMAT, sample-string) memoization (parseVCF.py:90-100).
"""

from __future__ import annotations

import gzip
import re

import numpy as np

re_cigar = re.compile(r"\d+|[MXDI]")
re_phaser = re.compile("[/|]")


def gt_type(alleles) -> str:
    allele_set = set(alleles)
    if len(allele_set) > 1:
        return "Het"
    if "0" in allele_set:
        return "HomRef"
    if "." in allele_set:
        return "Missing"
    return "HomAlt"


def simplify_alt(alt: str, cigar: str, missing: str = "N") -> str:
    l = re_cigar.findall(cigar)
    i = 0
    simp = ""
    try:
        for x in range(0, len(l), 2):
            label = l[x + 1]
            n = int(l[x])
            if label in ("M", "X"):
                simp += alt[i:i + n]
                i += n
            elif label == "I":
                i += n
            elif label == "D":
                simp += missing * n
    except Exception:
        raise ValueError("Malformed CIGAR: " + cigar)
    return simp


class VcfSite:
    __slots__ = ["CHROM", "POS", "ID", "REF", "ALT", "REFlen", "nALT",
                 "lenMatchDict", "QUAL", "FILTER", "INFO", "sampleNames",
                 "genoData", "alleleDict"]

    def __init__(self, elements=None, line=None, headers=None, headerLine=None,
                 precompGenoData=None, parseINFO=False, simplifyALT=False):
        assert (elements is not None or line is not None) and \
            (headers is not None or headerLine is not None)
        if not headers:
            headers = headerLine.split()
        if not elements:
            elements = line.split()
        d = dict(zip(headers, elements))
        self.CHROM = d["#CHROM"]
        self.POS = int(d["POS"])
        self.ID = d["ID"]
        self.REF = d["REF"]
        self.REFlen = len(self.REF)
        self.ALT = d["ALT"].split(",") if d["ALT"] != "." else []
        self.nALT = len(self.ALT)
        self.QUAL = d["QUAL"]
        self.FILTER = d["FILTER"]
        if parseINFO or simplifyALT:
            self.INFO = dict(x.split("=") for x in d["INFO"].split(";") if "=" in x)
        if simplifyALT:
            cigars = self.INFO["CIGAR"].split(",")
            for x in range(self.nALT):
                self.ALT[x] = simplify_alt(self.ALT[x], cigars[x])
        self.alleleDict = dict(zip([str(i) for i in range(self.nALT + 1)],
                                   [self.REF] + self.ALT))
        self.lenMatchDict = {k: len(v) == self.REFlen
                             for k, v in self.alleleDict.items()}
        geno_info_names = d["FORMAT"].split(":")
        self.sampleNames = headers[9:]
        self.genoData = {}
        for sample in self.sampleNames:
            key = (d["FORMAT"], d[sample])
            if precompGenoData is not None and key in precompGenoData:
                self.genoData[sample] = precompGenoData[key]
                continue
            g = dict(zip(geno_info_names, d[sample].split(":")))
            if "GT" in g:
                g["alleles"] = tuple(re_phaser.split(g["GT"]))
                g["phase"] = "|" if "|" in g["GT"] else "/"
            self.genoData[sample] = g
            if precompGenoData is not None and \
                    precompGenoData["__counter__"] < precompGenoData["__maxSize__"]:
                precompGenoData[key] = g
                precompGenoData["__counter__"] += 1

    def getSiteType(self) -> str:
        if len(self.ALT) == 0:
            return "MONO"
        if all(self.lenMatchDict.values()):
            return "SNP"
        return "INDEL"

    def getGenotype(self, sample, gtFilters=(), withPhase=True, asNumbers=False,
                    missing=None, allowOnly=None, mustMatchREFlen=False,
                    keepPartial=False, ploidy=None,
                    ploidyMismatchToMissing=False, expandMulti=False):
        g = self.genoData[sample]
        if missing is None:
            if asNumbers:
                missing = "."
            else:
                missing = "N" if not expandMulti or self.REFlen == 1 \
                    else ["N"] * self.REFlen
        passed = True
        for f in gtFilters:
            if "siteTypes" in f and self.getSiteType() not in f["siteTypes"]:
                continue
            if "gtTypes" in f and gt_type(g["alleles"]) not in f["gtTypes"]:
                continue
            if "samples" in f and sample not in f["samples"]:
                continue
            try:
                values = np.array(g[f["flag"]].split(","), dtype=float)
                passed = bool(np.all(f["min"] <= values) and np.all(values <= f["max"]))
            except Exception:
                passed = False
            if not passed:
                break
        if ploidy is None:
            ploidy = len(g["alleles"])
        elif ploidy != len(g["alleles"]):
            if ploidyMismatchToMissing:
                passed = False
            else:
                raise ValueError(
                    f"Sample {sample} at {self.CHROM}:{self.POS} genotype "
                    f"{g.get('GT')} does not match expected ploidy of {ploidy}")
        if passed:
            if not asNumbers:
                try:
                    alleles = [self.alleleDict[a]
                               if (not mustMatchREFlen or self.lenMatchDict[a])
                               else missing for a in g["alleles"]]
                    if allowOnly:
                        alleles = [a if a in allowOnly else missing for a in alleles]
                    if not keepPartial:
                        alleles = alleles if missing not in alleles \
                            else [missing] * ploidy
                except Exception:
                    alleles = [missing] * ploidy
            else:
                alleles = list(g["alleles"])
        else:
            alleles = [missing] * ploidy
        sep = g["phase"] if withPhase else ""
        if expandMulti:
            return tuple(sep.join(a[i] for a in alleles)
                         for i in range(self.REFlen))
        return sep.join(alleles)

    def getGenotypes(self, gtFilters=(), asList=False, withPhase=True,
                     asNumbers=False, samples=None, missing=None, allowOnly=None,
                     mustMatchREFlen=False, keepPartial=False, ploidyDict=None,
                     ploidyMismatchToMissing=False, expandMulti=False):
        if not samples:
            samples = self.sampleNames
        out = {}
        for s in samples:
            p = ploidyDict[s] if ploidyDict is not None else None
            out[s] = self.getGenotype(
                s, gtFilters=gtFilters, withPhase=withPhase, asNumbers=asNumbers,
                missing=missing, allowOnly=allowOnly,
                mustMatchREFlen=mustMatchREFlen, keepPartial=keepPartial,
                ploidy=p, ploidyMismatchToMissing=ploidyMismatchToMissing,
                expandMulti=expandMulti)
        if asList:
            return [out[s] for s in samples]
        return out

    def getGenoField(self, field, samples=None, missing=None):
        if missing is None:
            missing = "."
        if samples is None:
            samples = self.sampleNames
        return [self.genoData[s].get(field, missing) for s in samples]


def parse_header_lines(fileobj) -> dict:
    out = {"contigs": [], "contigLengths": {}}
    for line in fileobj:
        if isinstance(line, bytes):
            line = line.decode()
        if line.startswith("##contig"):
            body = re.split("<|>", line)[1]
            d = dict(x.split("=", 1) for x in body.split(","))
            out["contigs"].append(d["ID"])
            try:
                out["contigLengths"][d["ID"]] = int(d["length"])
            except (KeyError, ValueError):
                out["contigLengths"][d["ID"]] = None
        if line.startswith("#CHROM"):
            out["mainHead"] = line
            elements = line.split()
            out["sampleNames"] = elements[9:]
            out["nSamples"] = len(out["sampleNames"])
            out["mainHeaders"] = elements
            break
    return out


def get_head_data(path: str) -> dict:
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path, "rt")) as f:
        return parse_header_lines(f)


def parse_vcf_sites(lines, main_headers, precomp=True, precomp_max_size=10000,
                    excludeDuplicates=False, parseINFO=False, simplifyALT=False):
    precomp_data = {"__maxSize__": precomp_max_size, "__counter__": 0} \
        if precomp else None
    last_chrom = last_pos = None
    for elements in lines:
        if isinstance(elements, bytes):
            elements = elements.decode()
        if isinstance(elements, str):
            elements = elements.split()
        if len(elements) == 0 or elements[0][0] == "#":
            continue
        if excludeDuplicates:
            if elements[0] == last_chrom and elements[1] == last_pos:
                continue
            last_chrom, last_pos = elements[0], elements[1]
        yield VcfSite(elements=elements, headers=main_headers,
                      precompGenoData=precomp_data, parseINFO=parseINFO,
                      simplifyALT=simplifyALT)


def can_float(s) -> bool:
    try:
        float(s)
    except (TypeError, ValueError):
        return False
    return True


def parse_genotype_filter_arg(arg) -> dict:
    try:
        d = dict(tuple(i.split("=")) for i in arg)
        for key in d:
            assert key in ["flag", "min", "max", "siteTypes", "gtTypes", "samples"]
        for key in ["siteTypes", "gtTypes", "samples"]:
            if key in d:
                d[key] = d[key].split(",")
        d["min"] = float(d["min"]) if "min" in d else -np.inf
        d["max"] = float(d["max"]) if "max" in d else np.inf
        return d
    except Exception:
        raise ValueError("Bad genotype filter specification. See help.")
