"""Base / genotype encodings shared by the whole engine.

Numeric convention (cf. reference seqNumDict {A:0,C:1,G:2,T:3,N:-999},
genomics.py:33-35): we use int8 codes

    A=0  C=1  G=2  T=3  missing=-1

``code >= 0`` means "called"; this mirrors the reference's ``nanMask =
numArray >= 0`` (genomics.py:834).  A second sentinel, ``POISON=-2``, is used
*transiently* inside the decoders for characters that are not in {A,C,G,T,N}:
the reference makes the whole genotype missing when any allele fails the
seqNumDict lookup (genomics.py:351-352), and the decoders replicate that
before returning (-2 never escapes a public function).

All decode paths are vectorized over numpy uint8 views of the raw text bytes;
no per-site Python loops.
"""

from __future__ import annotations

import numpy as np

MISSING = np.int8(-1)
_POISON = np.int8(-2)

BASES = "ACGT"
BASE_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)

# --- scalar tables (API parity with reference genomics.py:14-35) -------------

# IUPAC ambiguity (diplo) <-> allele-pair tables, genomics.py:14-25.
DIPLOTYPES = ("A", "C", "G", "K", "M", "N", "S", "R", "T", "W", "Y")
PAIRS = ("AA", "CC", "GG", "GT", "AC", "NN", "CG", "AG", "TT", "AT", "CT")
HOMOTYPES = ("A", "C", "G", "N", "N", "N", "N", "N", "T", "N", "N")

IUPAC = ("A", "C", "G", "T", "M", "R", "W", "S", "Y", "K", "V", "H", "D", "B", "N")
ALLTYPES = ("A", "C", "G", "T", "AC", "AG", "AT", "CG", "CT", "GT",
            "ACG", "ACT", "AGT", "CGT", "ACGT")

diploHaploDict = dict(zip(DIPLOTYPES, PAIRS))
haploDiploDict = dict(zip(PAIRS, DIPLOTYPES))
diploHomoDict = dict(zip(DIPLOTYPES, HOMOTYPES))
basesIupacDict = dict(zip(ALLTYPES, IUPAC))
iupacBasesDict = dict(zip(IUPAC, ALLTYPES))

seqNumDict = {"A": 0, "C": 1, "G": 2, "T": 3, "N": -1}
numSeqDict = {0: "A", 1: "C", 2: "G", 3: "T", -1: "N"}

_COMPLEMENT_FROM = "ACGTKMRYVHBDN"
_COMPLEMENT_TO = "TGCAMKYRBDVHN"
complementTrans = str.maketrans(_COMPLEMENT_FROM + _COMPLEMENT_FROM.lower(),
                                _COMPLEMENT_TO + _COMPLEMENT_TO.lower())


def complement(seq: str) -> str:
    return seq.translate(complementTrans)


def revComplement(seq: str) -> str:
    return seq.translate(complementTrans)[::-1]


# --- byte-level lookup tables -------------------------------------------------

def _make_base_lut() -> np.ndarray:
    """uint8 byte -> int8 allele code (A/C/G/T -> 0..3, N -> -1, else POISON)."""
    lut = np.full(256, _POISON, dtype=np.int8)
    for i, b in enumerate(b"ACGT"):
        lut[b] = i
    lut[ord("N")] = MISSING
    return lut


BASE_LUT = _make_base_lut()

# diplo (IUPAC het) byte -> (first, second) allele codes, ordering per PAIRS
# (genomics.py:14-15): K->G,T  M->A,C  S->C,G  R->A,G  W->A,T  Y->C,T.


def _make_diplo_luts() -> tuple[np.ndarray, np.ndarray]:
    lut1 = np.full(256, _POISON, dtype=np.int8)
    lut2 = np.full(256, _POISON, dtype=np.int8)
    for d, pair in zip(DIPLOTYPES, PAIRS):
        a, b = pair
        lut1[ord(d)] = seqNumDict[a] if a != "N" else MISSING
        lut2[ord(d)] = seqNumDict[b] if b != "N" else MISSING
    return lut1, lut2


DIPLO_LUT_1, DIPLO_LUT_2 = _make_diplo_luts()


def _make_diplo_homo_lut() -> np.ndarray:
    """diplo byte -> homozygous allele code; hets/N -> missing (forceHomo via
    diploHomoDict, reference genomics.py:406-408)."""
    lut = np.full(256, _POISON, dtype=np.int8)
    for d, h in zip(DIPLOTYPES, HOMOTYPES):
        lut[ord(d)] = seqNumDict[h] if h != "N" else MISSING
    return lut


DIPLO_HOMO_LUT = _make_diplo_homo_lut()

# numeric code -> base character byte (for re-encoding / writers)
CODE_TO_BYTE = np.full(4, 0, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    CODE_TO_BYTE[_i] = _b


def codes_to_bases(codes: np.ndarray) -> np.ndarray:
    """int8 codes -> uint8 base bytes; anything < 0 becomes b'N'."""
    out = np.full(codes.shape, ord("N"), dtype=np.uint8)
    valid = codes >= 0
    out[valid] = CODE_TO_BYTE[codes[valid]]
    return out


def poison_genotypes(codes: np.ndarray, ploidy_axis_size: int) -> np.ndarray:
    """Replicate reference whole-genotype poisoning (genomics.py:351-352).

    ``codes`` has shape [..., ploidy_axis_size] with per-allele codes that may
    contain ``_POISON``.  Any genotype containing a poisoned allele becomes
    all-missing.  Returns int8 with only values in {-1, 0..3}.
    """
    bad = (codes == _POISON).any(axis=-1, keepdims=True)
    out = np.where(bad, MISSING, codes)
    return out.astype(np.int8, copy=False)


def decode_genotype_fields(gt_bytes: np.ndarray, geno_format: str,
                           ploidy: int) -> np.ndarray:
    """Decode fixed-width genotype fields into haplotype allele codes.

    Parameters
    ----------
    gt_bytes : uint8 array of shape [n_sites, field_width] — the raw bytes of
        one individual's genotype column.
    geno_format : 'phased' | 'pairs' | 'alleles' | 'haplo' | 'diplo'
        Semantics follow reference Genotype / splitSeq (genomics.py:320-331,
        390-396): 'phased' takes characters at even string positions (the
        separators between them are ignored, matching ``list(geno)[::2]``);
        'pairs'/'alleles' take consecutive characters; 'haplo' one character;
        'diplo' expands one IUPAC character to an allele pair.
    ploidy : number of haplotypes to emit for this individual.

    Returns int8 [n_sites, ploidy]; whole genotypes with any invalid character
    become all-missing (see ``poison_genotypes``).
    """
    n, width = gt_bytes.shape
    if geno_format == "phased":
        expected = 2 * ploidy - 1
        if width != expected:
            raise ValueError(
                f"phased genotype field width {width} != {expected} for ploidy {ploidy}")
        codes = BASE_LUT[gt_bytes[:, ::2]]
    elif geno_format in ("pairs", "alleles"):
        if width != ploidy:
            raise ValueError(
                f"{geno_format} genotype field width {width} != ploidy {ploidy}")
        codes = BASE_LUT[gt_bytes]
    elif geno_format == "haplo":
        if width != 1 or ploidy != 1:
            raise ValueError("haplo format requires 1-character fields and ploidy 1")
        codes = BASE_LUT[gt_bytes]
    elif geno_format == "diplo":
        if width != 1:
            raise ValueError("diplo format requires 1-character fields")
        if ploidy == 2:
            codes = np.stack([DIPLO_LUT_1[gt_bytes[:, 0]],
                              DIPLO_LUT_2[gt_bytes[:, 0]]], axis=1)
        elif ploidy == 1:
            # haploid sample in diplo format: force-homo semantics
            # (genomics.py:406-408 forceHomo via diploHomoDict — hets become N)
            lut = np.full(256, _POISON, dtype=np.int8)
            for d, h in zip(DIPLOTYPES, HOMOTYPES):
                lut[ord(d)] = seqNumDict[h] if h != "N" else MISSING
            codes = lut[gt_bytes]
        else:
            raise ValueError("diplo format supports ploidy 1 or 2 only")
    else:
        raise ValueError(f"unknown genoFormat {geno_format!r}")
    return poison_genotypes(codes, codes.shape[-1])


def haploid_names(names: list[str], ploidies: list[int]) -> list[str]:
    """Haplotype names: ind_A, ind_B, ... for ploidy>1; bare name for ploidy 1
    (reference genoToAlignment, genomics.py:1112-1121 / makeHaploidNames:448-453)."""
    out = []
    import string as _string
    for name, p in zip(names, ploidies):
        if p == 1:
            out.append(name)
        else:
            out.extend(name + "_" + letter for letter in _string.ascii_uppercase[:p])
    return out


def alleles_by_freq_ranks(counts: np.ndarray) -> np.ndarray:
    """Rank bases by descending frequency exactly as
    GenomeSite.alleles(byFreq=True) (genomics.py:549-557).

    counts: int [S, 4] per-site base counts.  Returns int8 [S, 4] where
    entry (s, b) is base b's position in the byFreq allele list (absent
    bases get trailing ranks; callers must not use them).

    The reference argsorts the COMPACTED present-allele count vector with
    numpy's default (non-stable) quicksort and reverses it, so tie order is
    an implementation detail of introsort.  The vectorized stable path here
    agrees except on sites with tied present counts; those sites are
    re-ranked individually with the reference's exact recipe.
    """
    counts = np.asarray(counts)
    S = counts.shape[0]
    order = np.argsort(counts, axis=1, kind="stable")[:, ::-1]
    rank = np.empty((S, 4), np.int8)
    np.put_along_axis(rank, order, np.arange(4, dtype=np.int8)[None, :],
                      axis=1)
    # sites with a tie among PRESENT counts need the exact quicksort order
    srt = np.sort(counts, axis=1)
    tied = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] > 0)).any(axis=1)
    for s in np.flatnonzero(tied):
        idx = np.flatnonzero(counts[s] > 0)
        compact = counts[s][idx]
        by_freq = idx[np.argsort(compact)[::-1]]
        r = np.full(4, len(idx), np.int8)
        for pos, b in enumerate(by_freq):
            r[b] = pos
        # absent bases keep arbitrary trailing ranks
        trail = len(idx)
        for b in range(4):
            if counts[s][b] == 0:
                r[b] = trail
                trail += 1
        rank[s] = r
    return rank


def byfreq_allele_order(counts: np.ndarray) -> np.ndarray:
    """Present alleles per site in byFreq order (allele codes, -1 padded),
    i.e. the list GenomeSite.alleles(byFreq=True) would return — same
    quicksort tie semantics as alleles_by_freq_ranks."""
    counts = np.asarray(counts)
    S = counts.shape[0]
    order = np.argsort(-counts.astype(np.int64), axis=1, kind="stable")
    n_present = (counts > 0).sum(axis=1)
    ranked = np.where(np.arange(4)[None, :] < n_present[:, None],
                      order, -1).astype(np.int8)
    srt = np.sort(counts, axis=1)
    tied = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] > 0)).any(axis=1)
    for s in np.flatnonzero(tied):
        idx = np.flatnonzero(counts[s] > 0)
        by_freq = idx[np.argsort(counts[s][idx])[::-1]]
        ranked[s, :len(by_freq)] = by_freq
        ranked[s, len(by_freq):] = -1
    return ranked
