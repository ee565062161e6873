"""Host (numpy) one-permutation sketch finalization.

Copy of the host functions of dashing2_tpu/ops/sketch_kernels.py:
`oph_to_sigs`, `oph_cardinality`, `_densify_draw_table` and
`oph_densify_rows`. The register update itself runs in the JAX package's
C++ engine (oph_sketch.cpp); a device sketch kernel is ROADMAP Queue 1
item 6.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import hashing as H

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def oph_to_sigs(regs: np.ndarray) -> np.ndarray:
    """LazyOnePermSetSketch::data() (oph.h:248-263): log-transform raw u64
    registers to f64 signatures; empty (max) and zero registers -> 0.

    sig = (-1 / (m - n_empty)) * log(2^-64 * (max - x + 1)).
    Order-preserving in x, so gt/lt/eq on sigs == on raw registers.
    """
    regs = np.asarray(regs, dtype=np.uint64)
    m = regs.shape[-1]
    out = np.zeros(regs.shape, dtype=np.float64)
    empty = regs == U64MAX
    nempty = empty.sum(axis=-1, keepdims=True)
    mul = -1.0 / np.maximum(m - nempty, 1)
    zero = regs == 0
    live = ~(empty | zero)
    with np.errstate(over="ignore", invalid="ignore"):
        delta = (U64MAX - regs) + np.uint64(1)  # max - x + 1 (wraps iff x==0)
        vals = mul * np.log(delta.astype(np.float64) * 2.0 ** -64)
    out[live] = np.broadcast_to(vals, out.shape)[live]
    return out


def oph_cardinality(regs: np.ndarray) -> np.ndarray:
    """getcard() (oph.h:240-247): m^2 / sum(x * 2^-64)."""
    regs = np.asarray(regs, dtype=np.uint64)
    m = regs.shape[-1]
    s = (regs.astype(np.float64) * 2.0 ** -64).sum(axis=-1)
    with np.errstate(divide="ignore"):
        return np.where(s > 0, m * (m / s), np.inf)


@functools.lru_cache(maxsize=8)
def _densify_draw_table(m: int, depth: int) -> np.ndarray:
    """(depth, m) redraw targets j_t(i) of the per-slot wyhash chain
    (cmp_core.cpp:578-613). The chain seed depends only on the slot
    index, so the draw sequence is identical across sketches and can be
    tabulated once per register count."""
    with np.errstate(over="ignore"):
        seed = np.arange(m, dtype=np.uint64) + np.uint64(H.DENSIFY_OFFSET)
    rows = np.empty((depth, m), np.int64)
    for t in range(depth):
        seed, draw = H.wyhash64_step(seed)
        rows[t] = (draw % np.uint64(m)).astype(np.int64)
    return rows


def oph_densify_rows(sigs: np.ndarray, kmers: np.ndarray | None = None,
                     empty_value=None, block: int = 512) -> np.ndarray:
    """Vectorized optimal densification across ALL sketch rows, in place.

    Bit-exact with the reference's per-row densify (same wyhash redraw
    chain per empty slot, first draw landing on a non-empty register
    wins): the per-slot draw chain is row-independent, so a (depth, m)
    target table is shared by every row and the first hit is a
    vectorized argmax over the chain axis. Rows are processed in blocks
    to bound the gathered candidate tensor; unresolved slots (all
    `depth` draws hit empty registers) re-run with a doubled chain.
    Returns per-row empty counts.
    """
    sigs = np.asarray(sigs)
    N, m = sigs.shape
    if empty_value is None:
        empty_value = (np.uint64(U64MAX) if sigs.dtype == np.uint64
                       else sigs.dtype.type(0))
    isempty = sigs == empty_value
    ne = isempty.sum(axis=1)
    todo = np.nonzero((ne > 0) & (ne < m))[0]
    for s in range(0, len(todo), block):
        rows = todo[s:s + block]
        sub = sigs[rows]                       # original values (sources)
        esub = isempty[rows]
        r_idx, i_idx = np.nonzero(esub)        # empty positions to fill
        depth = 32
        src = np.full(len(r_idx), -1, np.int64)
        unresolved = np.arange(len(r_idx))
        while len(unresolved):
            J = _densify_draw_table(m, depth)  # (depth, m)
            ju = J[:, i_idx[unresolved]]       # (depth, U)
            hit = sub[r_idx[unresolved][None, :], ju] != empty_value
            first = hit.argmax(axis=0)
            ok = hit.any(axis=0)
            src[unresolved[ok]] = ju[first[ok], np.nonzero(ok)[0]]
            unresolved = unresolved[~ok]
            depth *= 2
            if depth > 1 << 20:                # pragma: no cover
                raise RuntimeError("densify chain failed to terminate")
        sigs[rows[r_idx], i_idx] = sub[r_idx, src]
        if kmers is not None:
            # sources are never densified slots (the chain checks the
            # ORIGINAL registers), so in-place kmer assignment is safe
            kmers[rows[r_idx], i_idx] = kmers[rows[r_idx], src]
    return ne
