"""Edit distances: Myers bit-parallel Levenshtein over the raw sequences
of the edit-distance space, and the O(nm) DP over the token spans of
minimizer sequences (`--seq`).

Port of dashing2_tpu/cmp/editdist.py: `myers_edit_distance` (the Python
big-int recurrence, here the tests' oracle), `myers_batch_native` (the
port's copy of native/myers_ed.cpp, threads over a pair batch),
`span_edit_distance` (the JAX package's numpy prefix-min DP over u64 or
u128 tokens, edit-distance.h:12-57), `mmer_edit_distance_pair` and
`edit_distances_pairs`. A pair list of minimizer sequences runs
`span_edit_distances`: the same DP in native/span_ed.cpp, threads over
the pairs (the JAX package loops over the pairs in Python), the same
integers as `span_edit_distance`. Unlike the JAX package, nothing falls
back to the Python forms: a failed build of a native library raises.

Reference: vendored edlib (src/edlib.cpp, used with EDLIB_TASK_DISTANCE in
NW mode, cmp_core.cpp:331-347), host-side; candidate volumes after LSH
filtering are small.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from ..result import SketchingResult


def myers_edit_distance(a: bytes, b: bytes) -> int:
    """Levenshtein distance (unit costs), Myers' 1999 bit-parallel
    recurrence run on Python big-ints (CPython performs the 64-bit word
    blocking internally, so this is the unblocked textbook form at blocked
    speed)."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    if len(a) > len(b):
        a, b = b, a
    m = len(a)
    peq = {}
    for i, ch in enumerate(a):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    mask = (1 << m) - 1
    last = 1 << (m - 1)
    pv = mask
    mv = 0
    score = m
    for ch in b:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) & mask ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & last:
            score += 1
        elif mh & last:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def span_edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """O(nm) DP over u64 (or u128) token spans (edit-distance.h:12-57),
    one vectorized row per outer token.

    The left-to-right dependency cur[j] = min(tmp[j], cur[j-1] + 1) with
    tmp[j] = min(prev[j] + 1, prev[j-1] + cost_j) unrolls to
    cur[j] = j + min_{l<=j}(tmp[l] - l), a prefix-min scan, so each DP
    row is pure numpy instead of an interpreted inner loop."""
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    if n > m:  # outer loop over the SHORTER sequence: fewer
        a, b = b, a        # interpreted rows, each a wide vectorized op
        n, m = m, n
    prev = np.arange(m + 1, dtype=np.int64)
    ar = np.arange(m + 1, dtype=np.int64)
    tmp = np.empty(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]), out=tmp[1:])
        tmp[0] = i
        prev = ar + np.minimum.accumulate(tmp - ar)
    return int(prev[-1])


def mmer_edit_distance_pair(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """(edit_distance, max_edit_distance) for minimizer sequences
    (wcompare.cpp mmer_edit_distance semantics)."""
    return span_edit_distance(a, b), max(len(a), len(b))


def span_edit_distances(seqs: Sequence[np.ndarray], ia: np.ndarray,
                        ib: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """(P,) int64 `span_edit_distance` of every pair (seqs[ia[p]],
    seqs[ib[p]]) of u64 or u128 token sequences, by native/span_ed.cpp
    fanned across threads (at most 16, as for Myers). Only the sequences
    the pairs name are copied into the call."""
    from .. import u128 as U
    from ..native import load_span_lib
    lib = load_span_lib()
    ia = np.asarray(ia, np.int64)
    ib = np.asarray(ib, np.int64)
    needed, inv = np.unique(np.concatenate([ia, ib]), return_inverse=True)
    parts = [seqs[int(g)] for g in needed]
    offs = np.zeros(len(needed) + 1, np.int64)
    np.cumsum([len(q) for q in parts], out=offs[1:])
    wide = any(U.is_u128(q) for q in parts)
    flat = (np.concatenate(parts) if offs[-1]
            else np.zeros(0, U.U128 if wide else np.uint64))
    if wide:
        lo = np.ascontiguousarray(flat["lo"])
        hi = np.ascontiguousarray(flat["hi"])
    else:
        lo, hi = np.ascontiguousarray(flat, np.uint64), None
    if lo.size == 0:
        lo = np.zeros(1, np.uint64)     # non-null base pointer
        hi = None if hi is None else np.zeros(1, np.uint64)
    ia_l = np.ascontiguousarray(inv[:len(ia)], np.int64)
    ib_l = np.ascontiguousarray(inv[len(ia):], np.int64)
    out = np.empty(len(ia), np.int64)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.span_ed_batch(lo.ctypes.data_as(u64p),
                      hi.ctypes.data_as(u64p) if hi is not None else u64p(),
                      offs.ctypes.data_as(i64p), ia_l.ctypes.data_as(i64p),
                      ib_l.ctypes.data_as(i64p), len(ia), nthreads,
                      out.ctypes.data_as(i64p))
    return out


def myers_batch_native(seqs: Sequence[bytes], ia: np.ndarray,
                       ib: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """Levenshtein distance of every pair (seqs[ia[p]], seqs[ib[p]]), f64,
    by the native blocked-Myers library fanned across threads (at most
    16, as in the JAX package). Only the sequences the pairs name are
    copied into the call."""
    from ..native import load_myers_lib
    lib = load_myers_lib()
    ia = np.asarray(ia, np.int64)
    ib = np.asarray(ib, np.int64)
    needed, inv = np.unique(np.concatenate([ia, ib]), return_inverse=True)
    bufs = [bytes(seqs[int(g)]) for g in needed]
    offsets = np.zeros(len(needed) + 1, np.int64)
    np.cumsum([len(b) for b in bufs], out=offsets[1:])
    concat = np.frombuffer(b"".join(bufs), dtype=np.uint8)
    if concat.size == 0:
        concat = np.zeros(1, np.uint8)  # non-null base pointer
    ia_l = np.ascontiguousarray(inv[:len(ia)], np.int64)
    ib_l = np.ascontiguousarray(inv[len(ia):], np.int64)
    out = np.empty(len(ia), np.int64)
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.myers_batch(concat.ctypes.data_as(u8p),
                    offsets.ctypes.data_as(i64p),
                    ia_l.ctypes.data_as(i64p), ib_l.ctypes.data_as(i64p),
                    len(ia), nthreads, out.ctypes.data_as(i64p))
    return out.astype(np.float64)


def edit_distances_pairs(result: SketchingResult, ia: np.ndarray,
                         ib: np.ndarray) -> np.ndarray:
    """(P,) f64 edit distances of the pairs (ia[p], ib[p]) over the
    result's raw sequences (the edit-distance space keeps them), or else
    over its minimizer sequences (token spans)."""
    if len(ia) == 0:
        return np.zeros(0, np.float64)
    if result.sequences is not None:
        return myers_batch_native(result.sequences, ia, ib)
    if result.mmer_sequences is None:
        raise ValueError("edit distances need the raw sequences (-E) or "
                         "the minimizer sequences (--seq)")
    return span_edit_distances(result.mmer_sequences, ia, ib).astype(
        np.float64)
