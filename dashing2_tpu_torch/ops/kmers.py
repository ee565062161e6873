"""K-mer alphabet helpers for the native sketch route.

Copy of the numpy helpers of dashing2_tpu/ops/kmers.py that the native
file driver needs: `alphabet_lut`, `alphabet_size`, `_rolling_table` and
`parse_spacing`. The k-mer encoding itself runs in the JAX package's C++
engine (oph_sketch.cpp), which the port builds and calls; the
edit-distance space (sketch/omh.py) encodes here: `encode_ascii` on the
host, `dna_kmer_codes` (the JAX package's device function) in torch on
the sketch's device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

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


def encode_ascii(seq, alphabet: Alphabet) -> np.ndarray:
    """Map an ASCII sequence to uint8 codes (INVALID for non-alphabet)."""
    arr = (np.frombuffer(seq, dtype=np.uint8)
           if isinstance(seq, (bytes, bytearray))
           else np.asarray(seq, np.uint8))
    return alphabet_lut(alphabet)[arr]


def dna_kmer_codes(codes: torch.Tensor, k: int, canonicalize: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All k-mer codes of code rows, 2-bit packing, in torch on the codes'
    device (the JAX package's `dna_kmer_codes`, its u64 arithmetic in
    int64 with the same bits): codes uint8 (..., L) -> (kmers int64 (...,
    L-k+1), valid bool (..., L-k+1)). A window that touches an INVALID
    base is not valid (its code is still computed, with the INVALID bases
    as 0). As in the JAX function, the shift-or wraps above k = 32 (the
    low 64 bits are kept) and a code above 3 (a non-DNA alphabet) is
    OR'ed in as it is; canonicalize takes min(forward, reverse
    complement) in the unsigned order, its complement 3 - c wrapping for
    such codes."""
    n = codes.shape[-1] - k + 1
    bad = codes == INVALID
    c64 = torch.where(bad, 0, codes.to(torch.int64))
    fwd = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    rc = torch.zeros_like(fwd) if canonicalize else None
    for j in range(k):
        cj = c64[..., j:j + n]
        fwd = (fwd << 2) | cj
        if canonicalize and 2 * j < 64:
            # a shift by 64 or more gives 0 in XLA
            rc = rc | ((3 - cj) << (2 * j))
    if canonicalize:
        flip = -(1 << 63)            # unsigned order as signed order
        fwd = torch.minimum(fwd ^ flip, rc ^ flip) ^ flip
    return fwd, ~_window_any(bad, k)


def _window_any(flags: torch.Tensor, k: int) -> torch.Tensor:
    """OR of every length-k window along the last axis (out length
    L-k+1)."""
    cs = torch.nn.functional.pad(torch.cumsum(flags, -1, dtype=torch.int64),
                                 (1, 0))
    return cs[..., k:] - cs[..., :-k] > 0
