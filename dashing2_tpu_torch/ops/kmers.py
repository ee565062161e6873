"""K-mer encoding: alphabets, chunking, and the k-mer codes in torch.

Copy of the host helpers of dashing2_tpu/ops/kmers.py (`alphabet_lut`,
`alphabet_size`, `_rolling_table`, `parse_spacing`, `encode_ascii`,
`chunk_halos`, `chunk_codes`, `owned_kmer_range`) and port of its device
functions (`dna_kmer_codes`, `base_b_kmer_codes`, `spaced_kmer_codes`,
`dna_kmer_codes128`, `rolling_hash_codes`, `window_min`,
`minimizer_mask`, `hashed_kmers`) to torch on the codes' device. A u64
travels as the int64 with the same bits (ops/hashes.py): wrapping `*`,
`+`, `^`, `|` and `<<` give the same bits, a logical right shift masks
(`hashes.srl`), and an unsigned compare flips the sign bit first. These
are the plain versions of csrc/oph_rows.cu's encoding stage
(ops/oph_rows.py); the edit-distance space (sketch/omh.py) takes
`dna_kmer_codes`.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..enums import Alphabet
from . import hashes as DH

INVALID = 0xFF  # host-side code for non-alphabet characters
FLIP = -(1 << 63)  # xor into int64 to order u64 bits as signed int64
SMAX = (1 << 63) - 1  # u64 max with its sign bit flipped


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


# ----------------------------------------------------------------------
# Host: chunking with halo
# ----------------------------------------------------------------------

def chunk_halos(k: int, w: int = 0) -> Tuple[int, int]:
    """(left, right) halo widths in bases: k - 1 each, or w - 1 each with
    window minimizers (w > k), so a chunk holds every base its owned
    k-mers and every window containing them touch."""
    if w > k:
        return w - 1, w - 1
    return k - 1, k - 1


def chunk_codes(code_arrays: Sequence[np.ndarray], k: int,
                chunk_len: int = 1 << 16, w: int = 0) -> np.ndarray:
    """Per-sequence code arrays -> (n, left + chunk_len + right) uint8
    chunks: each owns base positions [start, start + chunk_len) of its
    sequence with its halos, INVALID outside the sequence; a sequence
    shorter than k has none. No chunk at all gives one all-INVALID row
    (the JAX function's shape)."""
    h_l, h_r = chunk_halos(k, w)
    width = chunk_len + h_l + h_r
    rows: List[np.ndarray] = []
    for codes in code_arrays:
        L = len(codes)
        if L < k:
            continue
        start = 0
        while start < L - (k - 1):
            lo = start - h_l
            pad_left = max(0, -lo)
            lo = max(lo, 0)
            hi = min(start + chunk_len + h_r, L)
            row = np.full(width, INVALID, dtype=np.uint8)
            seg = codes[lo:hi]
            row[pad_left:pad_left + len(seg)] = seg
            rows.append(row)
            start += chunk_len
    if not rows:
        return np.full((1, width), INVALID, dtype=np.uint8)
    return np.stack(rows)


def owned_kmer_range(k: int, w: int, chunk_len: int) -> Tuple[int, int]:
    """Local k-mer index range [lo, hi) a chunk owns."""
    h_l, _ = chunk_halos(k, w)
    return h_l, h_l + chunk_len


# ----------------------------------------------------------------------
# Device: k-mer codes, in torch on the codes' device
# ----------------------------------------------------------------------

def _clean(codes: torch.Tensor):
    """(INVALID flags, codes as int64 with INVALID as 0)."""
    bad = codes == INVALID
    return bad, torch.where(bad, 0, codes.to(torch.int64))


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
    bad, c64 = _clean(codes)
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
        fwd = torch.minimum(fwd ^ FLIP, rc ^ FLIP) ^ FLIP
    return fwd, ~_window_any(bad, k)


def base_b_kmer_codes(codes: torch.Tensor, k: int, base: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base-b packed k-mers for non-DNA alphabets (no canonicalization):
    acc = acc * base + c over the k bases, wrapping."""
    n = codes.shape[-1] - k + 1
    bad, c64 = _clean(codes)
    acc = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        acc = acc * base + c64[..., j:j + n]
    return acc, ~_window_any(bad, k)


def spaced_kmer_codes(codes: torch.Tensor, offsets: Sequence[int],
                      bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spaced-seed k-mers: the bases at `offsets` (increasing, span =
    offsets[-1] + 1) shifted in `bits` at a time; valid only where every
    base of the span is."""
    span = offsets[-1] + 1
    n = codes.shape[-1] - span + 1
    bad, c64 = _clean(codes)
    acc = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    for off in offsets:
        acc = (acc << bits) | c64[..., off:off + n]
    return acc, ~_window_any(bad, span)


def dna_kmer_codes128(codes: torch.Tensor, k: int, canonicalize: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """128-bit exact DNA k-mer codes for k <= 63 (--long-kmers): (hi, lo,
    valid), canonical = the 128-bit unsigned min of forward and reverse
    complement. Shifts of 64 and more never occur (the JAX function's
    word split)."""
    n = codes.shape[-1] - k + 1
    bad, c64 = _clean(codes)
    z = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                    device=codes.device)
    fhi, flo, rhi, rlo = z, z, z.clone(), z.clone()
    for j in range(k):
        cj = c64[..., j:j + n]
        fhi = (fhi << 2) | DH.srl(flo, 62)
        flo = (flo << 2) | cj
        comp = 3 - cj
        if 2 * j < 64:
            rlo = rlo | (comp << (2 * j))
        else:
            rhi = rhi | (comp << (2 * j - 64))
    valid = ~_window_any(bad, k)
    if not canonicalize:
        return fhi, flo, valid
    rh, fh = rhi ^ FLIP, fhi ^ FLIP
    rc_less = (rh < fh) | ((rh == fh) & ((rlo ^ FLIP) < (flo ^ FLIP)))
    return (torch.where(rc_less, rhi, fhi), torch.where(rc_less, rlo, flo),
            valid)


def _rotl64(x: torch.Tensor, s: int) -> torch.Tensor:
    s %= 64
    if s == 0:
        return x
    return (x << s) | DH.srl(x, 64 - s)


def rolling_hash_codes(codes: torch.Tensor, k: int, canonicalize: bool,
                       alphabet: Alphabet
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic-polynomial rolling hash for unbounded k:
    h_i = XOR_j rotl(T[c_{i+j}], (k-1-j) mod 64); canonical (DNA only)
    with the complement table's mirrored rotations, the unsigned min."""
    table = torch.from_numpy(_rolling_table(alphabet).view(np.int64)).to(
        codes.device)
    n = codes.shape[-1] - k + 1
    bad, safe = _clean(codes)
    t = table[safe]
    fwd = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                      device=codes.device)
    for j in range(k):
        fwd = fwd ^ _rotl64(t[..., j:j + n], (k - 1 - j) % 64)
    if canonicalize and alphabet in (Alphabet.DNA, Alphabet.DNAC):
        tc = table[torch.where(bad, 0, 3 - safe)]
        rc = torch.zeros_like(fwd)
        for j in range(k):
            rc = rc ^ _rotl64(tc[..., j:j + n], j % 64)
        fwd = torch.minimum(fwd ^ FLIP, rc ^ FLIP) ^ FLIP
    return fwd, ~_window_any(bad, k)


def _window_any(flags: torch.Tensor, k: int) -> torch.Tensor:
    """OR of every length-k window along the last axis (out length
    L-k+1)."""
    cs = torch.nn.functional.pad(torch.cumsum(flags, -1, dtype=torch.int64),
                                 (1, 0))
    return cs[..., k:] - cs[..., :-k] > 0


# ----------------------------------------------------------------------
# Device: window minimizers
# ----------------------------------------------------------------------

def _pad(x: torch.Tensor, left: int, right: int, fill) -> torch.Tensor:
    """x padded along the last axis with `fill` (exact for any int64:
    F.pad takes its value as a float)."""
    parts = [x]
    if left:
        parts.insert(0, torch.full(x.shape[:-1] + (left,), fill,
                                   dtype=x.dtype, device=x.device))
    if right:
        parts.append(torch.full(x.shape[:-1] + (right,), fill,
                                dtype=x.dtype, device=x.device))
    return torch.cat(parts, -1) if len(parts) > 1 else x


def window_min(values: torch.Tensor, nwin: int) -> torch.Tensor:
    """Sliding min over windows of `nwin` consecutive int64 values
    (log-step, padded with the int64 max past the end)."""
    x = values
    width = 1
    while width < nwin:
        step = min(width, nwin - width)
        x = torch.minimum(x, _pad(x[..., step:], 0, step, SMAX))
        width += step
    return x[..., :values.shape[-1] - nwin + 1]


def _shift_right(x: torch.Tensor, s: int, out_len: int, fill) -> torch.Tensor:
    """y[..., i] = x[..., i - s] for i in [0, out_len), `fill` outside."""
    return _pad(x, s, max(0, out_len - x.shape[-1] - s), fill)[..., :out_len]


def minimizer_mask(scores: torch.Tensor, valid: torch.Tensor, k: int,
                   w: int) -> torch.Tensor:
    """Mask of the positions selected as the minimum of >= 1 live window
    of w - k + 1 positions (the JAX function, rule for rule): scores are
    u64 (lower wins, invalid positions the u64 max); a window is live
    only where all its positions are valid; position i is selected iff
    it is valid, some live window containing i has its score as minimum,
    and no position in the nwin - 1 before i (the u64 max before the
    start) has an equal score. Rows of fewer than nwin positions hold no
    window and select nothing (the JAX function selects nothing there
    too, or raises where its log-step shifts pass the row's end)."""
    nwin = w - k + 1
    if nwin <= 1:
        return valid
    s = torch.where(valid, scores ^ FLIP, SMAX)
    n = s.shape[-1]
    if n < nwin:
        return torch.zeros_like(valid)
    wmin = window_min(s, nwin)
    wlive = window_min(valid.to(torch.int64), nwin) > 0
    hit = torch.zeros_like(valid)
    for d in range(nwin):
        hit |= (_shift_right(wlive, d, n, False)
                & (_shift_right(wmin, d, n, SMAX) == s))
    prev_eq = torch.zeros_like(valid)
    for d in range(1, nwin):
        prev_eq |= _shift_right(s, d, n, SMAX) == s
    return hit & valid & ~prev_eq


# ----------------------------------------------------------------------
# Full pipeline: chunk codes -> masked hashed k-mers
# ----------------------------------------------------------------------

def hashed_kmers(codes: torch.Tensor, k: int, *, w: int = 0,
                 canonicalize: bool = True,
                 alphabet: Alphabet = Alphabet.DNA, xormask: int = None,
                 seed_is_zero: bool = False, spacing_offsets=None,
                 rolling: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (..., L) uint8 -> (hashed k-mers int64 (u64 bits), valid)
    per position: exact coding for the alphabet (the spaced-seed gather
    with spacing_offsets, the rolling hash with `rolling`), window-w
    lexicographic minimizers when w > k, then the maskfn scrambler (raw
    codes with seed_is_zero). The JAX function without its --entmin
    scores, which no engine reproduces."""
    from .. import hashing as H
    if rolling:
        kmers, valid = rolling_hash_codes(codes, k, canonicalize, alphabet)
    elif spacing_offsets:
        bits = 2 if alphabet in (Alphabet.DNA, Alphabet.DNAC) else \
            max(1, (alphabet_size(alphabet) - 1).bit_length())
        kmers, valid = spaced_kmer_codes(codes, list(spacing_offsets), bits)
    elif alphabet in (Alphabet.DNA, Alphabet.DNAC):
        kmers, valid = dna_kmer_codes(codes, k, canonicalize)
    elif alphabet == Alphabet.DNA2:
        kmers, valid = base_b_kmer_codes(codes, k, 2)
    else:
        kmers, valid = base_b_kmer_codes(codes, k, alphabet_size(alphabet))
    if w > k:
        valid = minimizer_mask(kmers, valid, k, w)
    if seed_is_zero:
        return kmers, valid
    return DH.maskfn(kmers, H.XORMASK if xormask is None else xormask), valid
