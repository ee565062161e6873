"""128-bit exact k-mer keys as numpy structured pairs.

Copy of dashing2_tpu/u128.py (the port never imports the JAX package).
The reference's exact compare paths are templated over __uint128_t
(src/wcompare.cpp:28-51,111 via the .kmerset128 load at
src/cmp_main.cpp:305-352): exact sets and minimizer sequences of
`--long-kmers` keep FULL 128-bit keys, unlike register sketches, where
maskfn truncates to the low word (enums.h:144-148 + oph.h
update(uint64_t)).

In-memory representation: a structured dtype ('hi','lo') of two u64
words. numpy's void comparisons are lexicographic by field order, so
sort / unique / searchsorted / == over this dtype follow exact u128
numeric order, the order the reference's std::sort over __uint128_t
produces. On disk, .kmerset128 and .mmerseq128 files hold
little-endian u128 values (8 bytes lo, then 8 bytes hi per entry); the
helpers below convert between the two layouts.

maskfn(u128) = per-word WangHash after XOR with the 128-bit seed mask
(enums.h:144-148): lo' = WangHash(lo ^ XORMASK),
hi' = WangHash(hi ^ XORMASK2_HI). With seed 0 raw codes flow through,
as on the 64-bit path.

`sort` and `unique_counts` are the port's own: np.sort and np.unique's
results over the structured dtype, by a lexsort of the two words.
"""

from __future__ import annotations

import numpy as np

U128 = np.dtype([("hi", "<u8"), ("lo", "<u8")])


def from_words(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) u64 arrays -> structured u128 array (same shape)."""
    out = np.empty(np.shape(hi), U128)
    out["hi"] = hi
    out["lo"] = lo
    return out


def read_file(path: str) -> np.ndarray:
    """Sorted-or-not .kmerset128 file -> structured u128 array."""
    raw = np.fromfile(path, dtype=np.uint64)
    if len(raw) % 2:
        raise ValueError(f"{path}: odd u64 count for a u128 set")
    pairs = raw.reshape(-1, 2)     # columns: (lo, hi) little-endian
    return from_words(pairs[:, 1], pairs[:, 0])


def write_file(arr: np.ndarray, path: str) -> None:
    """Structured u128 array -> little-endian u128 file bytes."""
    tofile_bytes(arr).tofile(path)


def tofile_bytes(arr: np.ndarray) -> np.ndarray:
    """(n,) structured -> (n, 2) u64 [lo, hi] (the on-disk layout)."""
    out = np.empty((len(arr), 2), np.uint64)
    out[:, 0] = arr["lo"]
    out[:, 1] = arr["hi"]
    return out


def is_u128(arr) -> bool:
    return getattr(arr, "dtype", None) == U128


def sort(arr: np.ndarray) -> np.ndarray:
    """The u128 keys in u128 order (np.sort's result over the structured
    dtype), by one lexsort of the two words: numpy sorts void items
    through a generic comparison, about ten times slower."""
    return arr[np.lexsort((arr["lo"], arr["hi"]))]


def unique_counts(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(distinct keys in u128 order, their counts): np.unique(arr,
    return_counts=True) over the structured dtype, by `sort`."""
    s = sort(arr)
    if not len(s):
        return s, np.zeros(0, np.int64)
    new = np.flatnonzero(np.r_[True, (s["hi"][1:] != s["hi"][:-1])
                               | (s["lo"][1:] != s["lo"][:-1])])
    return s[new], np.diff(np.r_[new, len(s)])


def maskfn_words(hi: np.ndarray, lo: np.ndarray, xormask: int,
                 xormask2_hi: int) -> tuple[np.ndarray, np.ndarray]:
    """Reference u128 maskfn (enums.h:144-148) on u64 word arrays."""
    from . import hashing as H
    return (H.wanghash(np.asarray(hi, np.uint64)
                       ^ np.uint64(xormask2_hi)),
            H.wanghash(np.asarray(lo, np.uint64) ^ np.uint64(xormask)))


def mod_u128(arr: np.ndarray, d: int) -> np.ndarray:
    """(hi*2^64 + lo) % d for structured input, exact (CountSketch
    bucketing over u128 keys, counter.h semantics). Vectorized u64
    arithmetic for d < 2^31 (residues < 2^31 keep every intermediate
    below 2^63); exact object math above."""
    d_ = int(d)
    if d_ < (1 << 31):
        dd = np.uint64(d_)
        r64 = np.uint64((1 << 64) % d_)
        return ((arr["hi"] % dd) * r64 + arr["lo"] % dd) % dd
    hi = arr["hi"].astype(object)
    lo = arr["lo"].astype(object)
    return np.array([(int(h) * (1 << 64) + int(x)) % d_
                     for h, x in zip(hi, lo)], np.uint64)
