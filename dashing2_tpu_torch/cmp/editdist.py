"""Edit distances of the edit-distance space: Myers bit-parallel
Levenshtein over the raw sequences.

Port of dashing2_tpu/cmp/editdist.py's byte-sequence route:
`myers_edit_distance` (the Python big-int recurrence, here the tests'
oracle), `myers_batch_native` (the port's copy of native/myers_ed.cpp,
threads over a pair batch) and `edit_distances_pairs`. Unlike the JAX
package, nothing falls back to the Python recurrence: a failed build of
the native library raises. The u64-span DP over minimizer sequences
(`--seq`) is ROADMAP Queue 1 item 8.

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
    result's raw sequences (the edit-distance space keeps them)."""
    if result.sequences is None:
        raise NotImplementedError(
            "edit distances need the raw sequences, which only a -E sketch "
            "keeps; minimizer sequences (--seq) are not ported (ROADMAP "
            "Queue 1 item 8)")
    if len(ia) == 0:
        return np.zeros(0, np.float64)
    return myers_batch_native(result.sequences, ia, ib)
