"""Sketch finalization: one-permutation (host numpy) and CSetSketch
(FullSetSketch, torch on the card).

Copy of the host functions of dashing2_tpu/ops/sketch_kernels.py:
`oph_to_sigs`, `oph_cardinality`, `_densify_draw_table`,
`oph_densify_rows` and `css_cardinality`. The one-permutation register
update itself runs in the port's copy of the JAX package's C++ engine
(oph_sketch.cpp); a device sketch kernel is ROADMAP Queue 1 item 7.

The CSetSketch pass (`_css_pass`, jitted XLA in the JAX package, not
Pallas) is ops/css.py: csrc/css.cu on a CUDA tensor, its plain PyTorch
version on a CPU tensor. `css_sketch_many` batches items (each keeps its
own threshold, cap and top-k) and orders each item's rows on `device`.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from .. import hashing as H
from . import css as CSS
from . import hashes as DH
from .fixedmath import log64

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


# ----------------------------------------------------------------------
# CSetSketch
# ----------------------------------------------------------------------

_GOLD = CSS.GOLD  # 2^64 / golden ratio, register-stride salt


def _css_x1(hashed: torch.Tensor, m: int):
    """Per-item first order statistic and its RNG value.

    rv = CEHasher(h ^ CSS_XOR) (setsketch.h:375); x1 = -log(rv * 2^-64)/m
    (the reference's ev_1). rv == 0 -> x1 = +inf (item never updates).
    The division is a multiplication by the f64 reciprocal of m, as XLA
    compiles the JAX function's division by its static m.
    """
    rv = DH.css_item_hash(hashed)
    u = DH.u64_to_unit_float(rv)
    x1 = torch.where(rv == 0, torch.inf,
                     -log64(torch.clamp(u, min=1e-300)) * (1.0 / m))
    return x1, rv


# one pass's elements: on the CPU the plain pass's (items, rows,
# registers) f64 draws, of which a few such tensors are alive at once; on
# the card the kernel's (items, rows + registers), rows in and registers
# out (the item's hashes and their sort, of its whole width, beside them)
CSS_BATCH_ELEMENTS = 1 << 27


def css_sketch_many(items: Sequence[np.ndarray], m: int, device="cuda",
                    budget: int = CSS_BATCH_ELEMENTS,
                    return_ids: bool = False):
    """CSetSketch registers ((n, m) f64 numpy, +inf where never updated)
    of each item's distinct hashes, and the passes each item took ((n,)
    int32); with return_ids also each register's winner ((n, m) int64,
    the index of the winning hash in the item's input order; 0 for an
    empty item). The JAX host loop `css_sketch`, which
    per item takes n = its hash count, cap = min(n, max(4096, 6m)),
    threshold t = (log(m) + 8) / n, then runs the filtered pass until
    max(registers) <= tcut, with t *= 4 and cap = min(n, 4 cap) between
    passes (64 passes at most). Here the items run in batches on
    `device`, each item keeping its own t, cap and top-k; a pass re-runs
    only the items it left unconverged. A pass draws at most `budget`
    f64 values (one item at least); on the card, where the kernel draws
    without holding the draws, a batch and a pass hold at most `budget`
    (items x (hashes + m)) elements. An empty item's registers are +inf
    after no pass."""
    dev = torch.device(device)
    n_items = len(items)
    regs = np.full((n_items, m), np.inf)
    passes = np.zeros(n_items, np.int32)
    ids = np.zeros((n_items, m), np.int64) if return_ids else None
    cap = max(4096, 6 * m)
    sizes = np.array([len(x) for x in items], np.int64)
    order = [i for i in np.argsort(sizes, kind="stable") if sizes[i]]
    # items of similar size share a batch, which the first pass's rows
    # (at most cap an item; on the card the item's hashes) keep within
    # the budget
    kernel = dev.type == "cuda"
    width = sizes[order] if kernel else np.minimum(sizes[order], cap)
    for grp in _budget_groups(np.arange(len(order)), width, m, budget,
                              kernel):
        batch = [order[i] for i in grp]
        _css_batch([items[i] for i in batch], m, cap, dev, budget,
                   regs, passes, np.asarray(batch), ids)
    if return_ids:
        return regs, passes, ids
    return regs, passes


def _css_batch(items: List[np.ndarray], m: int, cap: int, dev, budget: int,
               regs: np.ndarray, passes: np.ndarray, idx: Sequence[int],
               ids=None):
    """css_sketch_many over one batch, writing the registers and passes
    of item i of the batch to row idx[i] of `regs` and `passes` (and its
    winners, mapped back through the sort's permutation, to `ids`)."""
    n = np.array([len(x) for x in items], np.int64)
    width = int(n.max())
    h = np.zeros((len(items), width), np.uint64)
    for r, x in enumerate(items):
        h[r, :len(x)] = x
    hashed = torch.from_numpy(h.view(np.int64)).to(dev)
    valid = torch.arange(width, device=dev)[None, :] \
        < torch.from_numpy(n).to(dev)[:, None]
    x1, rv = _css_x1(hashed, m)
    x1 = torch.where(valid, x1, torch.inf)
    sx1, perm = torch.sort(x1, dim=1, stable=True)
    srv = torch.gather(rv, 1, perm)
    del hashed, valid, x1, rv
    if ids is None:
        del perm
    kcap = np.minimum(n, cap)
    t = (np.log(m) + 8.0) / np.maximum(n, 1)
    todo = np.arange(len(items))
    for _ in range(64):
        # the pass's rows: the most any unconverged item takes, in
        # groups that keep each pass within the budget
        got_r, got_c, got_w = [], [], []
        for grp in _budget_groups(todo, kcap, m, budget,
                                  dev.type == "cuda"):
            K = int(kcap[grp].max())
            sel = torch.from_numpy(grp).to(dev)
            out = CSS.css_pass(sx1[sel, :K].contiguous(),
                               srv[sel, :K].contiguous(),
                               torch.from_numpy(kcap[grp]).to(dev),
                               torch.from_numpy(t[grp]).to(dev), m,
                               return_ids=ids is not None)
            got_r.append(out[0].cpu().numpy())
            got_c.append(out[1].cpu().numpy())
            if ids is not None:
                # sorted row -> the hash's index in the item's input
                got_w.append(torch.gather(perm[sel], 1, out[2])
                             .cpu().numpy())
        r, c = np.concatenate(got_r), np.concatenate(got_c)
        passes[idx[todo]] += 1
        done = r.max(1) <= c
        regs[idx[todo[done]]] = r[done]
        if ids is not None:
            ids[idx[todo[done]]] = np.concatenate(got_w)[done]
        todo = todo[~done]
        if not len(todo):
            return
        t[todo] *= 4.0
        kcap[todo] = np.minimum(n[todo], kcap[todo] * 4)
    raise RuntimeError("css_sketch failed to converge")


def _budget_groups(todo: np.ndarray, kcap: np.ndarray, m: int, budget: int,
                   kernel: bool = False):
    """Split `todo` (ascending rows) into groups whose (items x rows x m)
    pass (with `kernel`, the card's (items x (rows + m))) stays within
    `budget`, one item at least."""
    s = 0
    while s < len(todo):
        b, top = 1, int(kcap[todo[s]])
        while s + b < len(todo):
            wider = max(top, int(kcap[todo[s + b]]))
            if (b + 1) * (wider + m if kernel else wider * m) > budget:
                break
            b, top = b + 1, wider
        yield todo[s:s + b]
        s += b


def css_cardinality(regs: np.ndarray) -> np.ndarray:
    """CSetSketch::cardinality (setsketch.h:553-561): m / sum(regs)."""
    regs = np.asarray(regs, dtype=np.float64)
    m = regs.shape[-1]
    s = regs.sum(axis=-1)
    with np.errstate(divide="ignore"):
        return np.where(s > 0, m / s, np.inf)
