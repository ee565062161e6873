"""K-mer alphabet helpers for the native sketch route.

Copy of the numpy helpers of dashing2_tpu/ops/kmers.py that the native
file driver needs: `alphabet_lut`, `alphabet_size`, `_rolling_table` and
`parse_spacing`. The k-mer encoding itself runs in the JAX package's C++
engine (oph_sketch.cpp), which the port builds and calls.
"""

from __future__ import annotations

import functools

import numpy as np

from ..enums import Alphabet

INVALID = 0xFF  # host-side code for non-alphabet characters


@functools.lru_cache(maxsize=None)
def alphabet_lut(alphabet: Alphabet) -> np.ndarray:
    """256-entry uint8 LUT from ASCII byte to alphabet code (INVALID=255)."""
    lut = np.full(256, INVALID, dtype=np.uint8)
    if alphabet in (Alphabet.DNA, Alphabet.DNAC):
        for i, chars in enumerate("ACGT"):
            lut[ord(chars)] = i
            lut[ord(chars.lower())] = i
        return lut
    if alphabet == Alphabet.DNA2:
        # purine/pyrimidine 1-bit alphabet
        for c in "AGag":
            lut[ord(c)] = 0
        for c in "CTct":
            lut[ord(c)] = 1
        return lut
    aas = "ACDEFGHIKLMNPQRSTVWY"
    if alphabet in (Alphabet.PROTEIN20, Alphabet.PROTEIN):
        groups = list(aas)
    elif alphabet == Alphabet.PROTEIN_3BIT:
        # 8-letter reduced alphabet (3-bit); Murphy-style grouping
        groups = ["AGST", "C", "DENQ", "FWY", "H", "ILMV", "KR", "P"]
    elif alphabet == Alphabet.PROTEIN_14:
        groups = ["A", "C", "DN", "EQ", "FY", "G", "H", "ILMV", "K",
                  "P", "R", "ST", "W", "X"]
    elif alphabet == Alphabet.PROTEIN_6:
        # Murphy 6-letter reduced alphabet
        groups = ["AGPST", "C", "DENQ", "FWY", "HKR", "ILMV"]
    else:
        raise ValueError(f"unknown alphabet {alphabet}")
    for code, grp in enumerate(groups):
        for ch in grp:
            lut[ord(ch)] = code
            lut[ord(ch.lower())] = code
    return lut


def alphabet_size(alphabet: Alphabet) -> int:
    if alphabet in (Alphabet.DNA, Alphabet.DNAC):
        return 4
    if alphabet == Alphabet.DNA2:
        return 2
    return {Alphabet.PROTEIN: 20, Alphabet.PROTEIN20: 20,
            Alphabet.PROTEIN_3BIT: 8, Alphabet.PROTEIN_14: 14,
            Alphabet.PROTEIN_6: 6}[alphabet]


_ROLL_SALT = 0x1F3D5B79A2C4E608


@functools.lru_cache(maxsize=None)
def _rolling_table(alphabet: Alphabet) -> np.ndarray:
    """Per-symbol random u64 table for the cyclic-polynomial rolling hash
    (bns::RollingHasher equivalent for k beyond exact coding)."""
    from .. import hashing as H
    nsym = alphabet_size(alphabet)
    syms = np.arange(nsym, dtype=np.uint64)
    return H.wanghash(syms * np.uint64(0x9E3779B97F4A7C15)
                      ^ np.uint64(_ROLL_SALT))


def parse_spacing(spacing: str, k: int) -> list[int]:
    """Parse the --spacing argument (options.h:488-492): comma-separated
    gaps after each kept position, with <gap>x<count> run-length syntax.
    Returns absolute offsets of the k kept positions."""
    if not spacing:
        return list(range(k))
    gaps: list[int] = []
    for tok in spacing.split(","):
        if "x" in tok:
            g, c = tok.split("x")
            gaps.extend([int(g)] * int(c))
        else:
            gaps.append(int(tok))
    if len(gaps) != k - 1:
        raise ValueError(f"spacing needs k-1={k-1} entries, got {len(gaps)}")
    offsets = [0]
    for g in gaps:
        offsets.append(offsets[-1] + 1 + g)
    return offsets
