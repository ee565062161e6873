"""Enumerations mirroring the reference's option space.

Whole copy of dashing2_tpu/enums.py (the port never imports the JAX
package). Reference: /root/reference/src/enums.h:27-111 (DataType, SketchSpace,
CountingType, KmerSketchResultType, OutputKind, OutputFormat, Verbosity),
/root/reference/src/cmp_main.h:8-49 (Measure, symmetric(), distance()),
/root/reference/src/enums.cpp:28-37 (to_suffix).
"""

from __future__ import annotations

import enum


class DataType(enum.IntEnum):
    FASTX = 0
    BIGWIG = 1
    BED = 2
    LEAFCUTTER = 3


class SketchSpace(enum.IntEnum):
    SPACE_SET = 0        # MinHash/SetSketch/HLL
    SPACE_MULTISET = 1   # weighted (BagMinHash)
    SPACE_PSET = 2       # ProbMinHash
    SPACE_EDIT_DISTANCE = 3  # OrderMinHash over strings


class CountingType(enum.IntEnum):
    EXACT_COUNTING = 0
    COUNTSKETCH_COUNTING = 1
    COUNTMIN_COUNTING = 2
    CQF_COUNTING = 3


class KmerSketchResultType(enum.IntEnum):
    ONE_PERM = 0
    FULL_SETSKETCH = 1
    FULL_MMER_SET = 2
    FULL_MMER_COUNTDICT = 3
    FULL_MMER_SEQUENCE = 4


class OutputKind(enum.IntEnum):
    SYMMETRIC_ALL_PAIRS = 0
    PHYLIP = 1
    ASYMMETRIC_ALL_PAIRS = 2
    KNN_GRAPH = 3
    NN_GRAPH_THRESHOLD = 4
    PANEL = 5
    DEDUP = 6


class OutputFormat(enum.IntEnum):
    MACHINE_READABLE = 0  # aka BINARY
    HUMAN_READABLE = 1


BINARY = OutputFormat.MACHINE_READABLE


class Measure(enum.IntEnum):
    SIMILARITY = 0             # Jaccard / fraction of shared registers
    CONTAINMENT = 1            # |A & B| / |A|
    SYMMETRIC_CONTAINMENT = 2  # |A & B| / min(|A|, |B|)
    POISSON_LLR = 3            # Mash-style distance transform
    INTERSECTION = 4           # |A & B|
    UNION_SIZE = 5             # |A | B|
    M_EDIT_DISTANCE = 6        # edit distance (OMH space)


MASH_DISTANCE = Measure.POISSON_LLR


def measure_is_symmetric(m: Measure) -> bool:
    """cmp_main.h:38-43 — containment is the one asymmetric measure."""
    return m != Measure.CONTAINMENT


def measure_is_distance(m: Measure) -> bool:
    """cmp_main.h:44-49 — True when larger = farther (sort order flips)."""
    return m not in (
        Measure.UNION_SIZE,
        Measure.INTERSECTION,
        Measure.SIMILARITY,
        Measure.CONTAINMENT,
    )


class Alphabet(enum.IntEnum):
    """Input alphabets (bonsai RollingHashingType; integer codes match
    /root/reference/python/parse.py:8-23)."""

    DNA = 0
    PROTEIN = 1       # raw bytes
    PROTEIN20 = 2     # 20-letter amino acids
    PROTEIN_3BIT = 3  # 8-letter (3-bit) reduced alphabet ("protein8")
    PROTEIN_14 = 4    # 14-letter reduced
    PROTEIN_6 = 5     # 6-letter reduced
    DNA2 = 6
    DNAC = 7


class Verbosity(enum.IntEnum):
    STANDARD = 0
    INFO = 1
    DEBUG = 2
    EXTREME = 3


def to_suffix(sspace: SketchSpace, kmer_result: KmerSketchResultType,
              use128: bool = False) -> str:
    """Sketch-cache filename suffix (enums.cpp:28-37)."""
    if kmer_result in (KmerSketchResultType.ONE_PERM,
                       KmerSketchResultType.FULL_SETSKETCH):
        if sspace == SketchSpace.SPACE_SET:
            return ".opss" if kmer_result == KmerSketchResultType.ONE_PERM else ".ss"
        if sspace == SketchSpace.SPACE_MULTISET:
            return ".bmh"
        if sspace == SketchSpace.SPACE_PSET:
            return ".pmh"
        return ".unknown"
    if kmer_result in (KmerSketchResultType.FULL_MMER_SET,
                       KmerSketchResultType.FULL_MMER_COUNTDICT):
        return ".kmerset" + ("128" if use128 else "64")
    if kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
        return ".mmerseq" + ("128" if use128 else "64")
    return ".unknown_kmer"
