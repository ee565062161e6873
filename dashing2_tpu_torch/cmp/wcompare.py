"""Exact k-mer set and count-dictionary intersections, in torch, and the
minimizer-sequence comparisons.

Port of dashing2_tpu/cmp/wcompare.py's two engines for in-memory sets
(`--set`, `--countdict`, `cmp --presketched` over `.kmerset64` and
`.kmerset128`):

* `exact_intersections` (and `ExactJoin`, which keeps one column table
  across the row blocks of a job): the vectorized posting-list join. The
  column sets are concatenated and sorted by key once; every row key is
  matched against the table's unique keys (`searchsorted`), each match
  fans out over the columns that hold the key (a ragged expansion), and
  one `bincount` sums the (row, column) contributions. With a count
  dictionary each shared key adds min(count_row, count_col);
* `exact_intersections_pairs`: the JAX `_exact_pairs_device` engine for
  a pair list. The sets sit in a padded (n, L) table on the device, each
  row sorted, made once per result. The JAX engine merges each pair's
  two rows with one sort along the row; here each key of the left row
  is looked up in the right row (one batched `searchsorted`), which
  finds the same shared keys without sorting 2L keys a pair
  (experiments/torch_exact_cpu_costs.py times both). Where the
  padded table would be pathological (the JAX gate: L * n > 2^28, or
  L > 16 times the mean set size) the pairs run a posting join on the
  device instead: every key of a pair's left item is looked up in the
  table of all sets, sorted by (key, item).

Both run where their tensors are: on the card for a CUDA job, on the CPU
for `--device cpu`. The JAX package counts on the host (numpy) on its
CPU backend and for short pair lists; the port has no host route, and
the integers are the same on every route. The JAX engines are numpy and
XLA, not Pallas: there is no TPU kernel behind them.

u128 keys (`--long-kmers`, u128.py), which the JAX package joins on the
host, are rank-encoded once a job (`_ranks128`: a joint sort of the
(hi, lo) pairs on the device, equal keys one rank); both engines then
run on the int64 ranks unchanged, and the integers come out the same.

`mmer_sequence_pairs` compares minimizer sequences (`--seq`): the span
edit distance (cmp/editdist.py, on the host) or the positional hamming
count (`hamming_matches`).

Keys travel as int64 bit patterns. Equality and grouping are the same in
the signed view, and both sides of every `searchsorted` are sorted in
it; no order that reaches the output is taken from it. The pair table
stores each key with its top bit flipped, so that its rows sort as the
keys do unsigned and the pad, u64::max, sorts last. A real key can equal
u64::max (a poly-T k-mer under a zero seed): it is left out of the
lookup and counted apart, as a set holds it at most once.

Counts are summed in int64, exactly. The JAX package sums them in f64,
which is exact while every count is a whole number and an item's counts
sum to less than 2^53: other counts are refused (`_counts_int64`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve, synchronize
from ..result import SketchingResult
from ..timing import span

# ragged-expansion entries one sub-block of the posting join holds at
# once (a sub-block may exceed it by one key's group); about 40 bytes
# of int64 intermediates each
BUDGET = 1 << 26
# keys of the (pairs, L) left rows one block of the padded pair lookup
# takes at once
PAIR_BUDGET = 1 << 26
# u64::max as an int64 bit pattern, and with its top bit flipped (the
# pad of the pair table)
_U64MAX = -1
_PAD = (1 << 63) - 1
_TOP = -(1 << 63)


def hamming_matches(a: np.ndarray, b: np.ndarray) -> float:
    """Equal positions over the overlap plus the length difference
    (hamming_compare, wcompare.cpp:52-55; the streaming hamming_compare_f
    :89-107 computes the same value)."""
    n = min(len(a), len(b))
    return float((a[:n] == b[:n]).sum()) + float(max(len(a), len(b)) - n)


def mmer_sequence_pairs(opts, result: SketchingResult, ia: np.ndarray,
                        ib: np.ndarray) -> np.ndarray:
    """(P,) f64 minimizer-sequence (--seq) comparisons of the pairs
    (ia[p], ib[p]) (cmp_core.cpp:547-553): the exact span edit distance
    under --exact-kmer-dist (the distance under
    --compute-edit-distance, else max_len - distance), positional
    hamming matches otherwise. The distances of the whole list run in
    one native call (cmp/editdist.py `edit_distances_pairs`)."""
    from ..enums import Measure
    from .editdist import edit_distances_pairs
    seqs = result.mmer_sequences
    ia = np.asarray(ia, np.int64)
    ib = np.asarray(ib, np.int64)
    if not opts.exact_kmer_dist:
        return np.array([hamming_matches(seqs[int(i)], seqs[int(j)])
                         for i, j in zip(ia, ib)], np.float64)
    dist = edit_distances_pairs(result, ia, ib)
    if opts.measure == Measure.M_EDIT_DISTANCE:
        return dist
    lens = np.array([len(q) for q in seqs], np.float64)
    return np.maximum(lens[ia], lens[ib]) - dist


def _ranks128(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(K,) int64 ranks of the u128 keys (hi, lo) (int64 bit patterns) on
    their device: equal keys one rank, distinct keys distinct ranks."""
    order = torch.argsort(lo, stable=True)
    order = order[torch.argsort(hi[order], stable=True)]
    h, low = hi[order], lo[order]
    new = torch.ones(len(order), dtype=torch.int64, device=hi.device)
    new[1:] = ((h[1:] != h[:-1]) | (low[1:] != low[:-1])).to(torch.int64)
    ranks = torch.empty_like(order)
    ranks[order] = torch.cumsum(new, 0) - 1
    return ranks


def _counts_int64(counts) -> np.ndarray:
    """Concatenated f64 counts as int64, refusing any that f64 sums could
    not hold exactly."""
    for c in counts:
        c = np.asarray(c, np.float64)
        if not (np.all(c == np.trunc(c)) and np.abs(c).sum() < 2.0 ** 53):
            raise ValueError(
                "count dictionary counts must be whole numbers whose sum "
                "per item is below 2^53")
    return np.concatenate([np.asarray(c, np.float64) for c in counts]
                          ).astype(np.int64)


class DeviceSets:
    """The result's sets on `dev`: keys (K,) int64 in item order (u128
    keys as their ranks), their counts (K,) int64 or None, and the item
    offsets (n + 1,) on the host and on `dev`; `table`, the ExactJoin of
    all items that the pairs' posting join makes on first use. Made once per (result, device) by
    `device_sets`."""

    def __init__(self, result: SketchingResult, dev: torch.device):
        from .. import u128 as U
        sets = result.kmer_sets
        lens = np.array([len(s) for s in sets], np.int64)
        self.offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        self.n = len(sets)
        with span("cmp/exact-h2d"):
            if any(U.is_u128(s) for s in sets):
                keys = (np.concatenate(sets) if self.offs[-1]
                        else np.zeros(0, U.U128))
                self.keys = _ranks128(*(torch.from_numpy(
                    np.ascontiguousarray(keys[w]).view(np.int64)).to(dev)
                    for w in ("hi", "lo")))
            else:
                keys = (np.concatenate([np.asarray(s, np.uint64)
                                        for s in sets])
                        if self.offs[-1] else np.zeros(0, np.uint64))
                self.keys = torch.from_numpy(keys.view(np.int64)).to(dev)
            self.counts = None
            if result.kmer_set_counts is not None:
                self.counts = torch.from_numpy(
                    _counts_int64(result.kmer_set_counts)).to(dev)
            self.offs_t = torch.from_numpy(self.offs).to(dev)
            synchronize(dev)
        self.dev = dev
        self.table: Optional[ExactJoin] = None

    def gather(self, items: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """(keys, position in `items` of each key's item, counts or None)
        of the sets of `items` ((p,) int64 on the device), in their
        order."""
        lo = self.offs_t[items]
        lens = self.offs_t[items + 1] - lo
        total = int(lens.sum())
        owner = torch.repeat_interleave(
            torch.arange(len(items), device=self.dev), lens,
            output_size=total)
        start = torch.cumsum(lens, 0) - lens
        idx = (lo - start)[owner] + torch.arange(total, device=self.dev)
        counts = None if self.counts is None else self.counts[idx]
        return self.keys[idx], owner, counts


def device_sets(result: SketchingResult, dev: torch.device) -> DeviceSets:
    """The result's DeviceSets on `dev`, uploaded once and kept on the
    result (a job's row blocks and a dedup's rounds reuse it)."""
    cache = getattr(result, "_exact_dev_sets", None)
    if cache is None or cache.dev != dev or cache.n != len(result.kmer_sets):
        cache = DeviceSets(result, dev)
        result._exact_dev_sets = cache
    return cache


def _index(items, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(items, np.int64)).to(dev)


class ExactJoin:
    """The posting-list join of row blocks against one column table.

    The columns' keys are sorted once (stable, so each key's group lists
    its columns in order) and kept on the device across blocks. `block`
    counts one row block against every column, or, for a symmetric job
    (whose columns are all items in order), each row against the columns
    after its own item only (the upper triangle; the other entries stay
    0). Each block's ragged expansion runs in sub-blocks of about
    `budget` entries; `subblocks` and `entries` count them over the
    job."""

    def __init__(self, sets: DeviceSets, cols, budget: int = BUDGET):
        dev = sets.dev
        self.sets, self.dev, self.budget = sets, dev, budget
        self.nc = len(cols)
        self.all_items = np.array_equal(cols, np.arange(sets.n))
        self.subblocks = self.entries = 0
        keys, owner, counts = self.sets.gather(_index(cols, dev))
        keys, order = torch.sort(keys, stable=True)
        self.owner = owner[order]
        self.counts = None if counts is None else counts[order]
        K = len(keys)
        new = torch.ones(K, dtype=torch.bool, device=dev)
        new[1:] = keys[1:] != keys[:-1]
        self.gstart = torch.nonzero(new).reshape(-1)
        self.gend = torch.cat([self.gstart[1:],
                               torch.tensor([K], device=dev)])
        self.ukeys = keys[self.gstart]
        # (group, column) of every entry, ascending: the start of a
        # group's columns at or after a given one is one searchsorted
        self.gcol = (torch.cumsum(new, 0) - 1) * self.nc + self.owner

    def block(self, rows, upper: bool = False) -> torch.Tensor:
        """(len(rows), nc) int64 intersection sizes (count sums with a
        count dictionary) of the sets of `rows` against the columns, on
        the device; with `upper`, 0 at and before each row's own item."""
        if upper and not self.all_items:
            raise ValueError("the upper triangle needs every item as a "
                             "column, in order")
        nr, nc, dev = len(rows), self.nc, self.dev
        out = torch.zeros(nr * nc, dtype=torch.int64, device=dev)
        if nr == 0 or nc == 0 or len(self.ukeys) == 0:
            return out.reshape(nr, nc)
        rows_t = _index(rows, dev)
        rk, ro, rc = self.sets.gather(rows_t)
        g = torch.searchsorted(self.ukeys, rk).clamp_(max=len(self.ukeys) - 1)
        hit = self.ukeys[g] == rk
        g, ro = g[hit], ro[hit]
        rc = None if rc is None else rc[hit]
        if upper:
            first = torch.searchsorted(self.gcol, g * nc + rows_t[ro] + 1)
        else:
            first = self.gstart[g]
        glen = self.gend[g] - first
        csum = torch.cumsum(glen, 0)
        total = int(csum[-1]) if len(csum) else 0
        if total == 0:
            return out.reshape(nr, nc)
        # sub-block edges: the first match whose running total reaches
        # each multiple of the budget
        nsub = -(-total // self.budget)
        edges = torch.searchsorted(csum, torch.arange(
            1, nsub, device=dev, dtype=torch.int64) * self.budget)
        edges = [0] + edges.tolist() + [len(g)]
        ends = csum[torch.tensor(edges[1:], device=dev) - 1].tolist()
        done = 0
        for h0, h1, end in zip(edges[:-1], edges[1:], ends):
            if h1 <= h0:
                continue
            nt = end - done
            gl = glen[h0:h1]
            rep = torch.repeat_interleave(
                torch.arange(h1 - h0, device=dev), gl, output_size=nt)
            within = (torch.arange(nt, device=dev)
                      - (csum[h0:h1] - gl - done)[rep])
            src = first[h0:h1][rep] + within
            flat = ro[h0:h1][rep] * nc + self.owner[src]
            if rc is None:
                out += torch.bincount(flat, minlength=nr * nc)
            else:
                out.index_add_(0, flat, torch.minimum(rc[h0:h1][rep],
                                                      self.counts[src]))
            done = end
            self.subblocks += 1
            self.entries += nt
        return out.reshape(nr, nc)


def exact_intersections(result: SketchingResult, rows, cols,
                        device="cuda", budget: int = BUDGET) -> np.ndarray:
    """(len(rows), len(cols)) f64 intersection sizes of the exact sets of
    items `rows` against those of items `cols` (with a count dictionary,
    the sums of min(count_row, count_col) over shared keys), joined on
    `device`: dashing2_tpu/cmp/wcompare.py::exact_intersections."""
    join = ExactJoin(device_sets(result, resolve(device)), cols, budget)
    return join.block(rows).cpu().numpy().astype(np.float64)


class PaddedSets:
    """The sets as a padded (n, L) int64 table on the device for the pair
    lookup: each key with its top bit flipped, each row sorted, padded
    with u64::max (flipped: int64 max); the counts in the same places;
    and each item's count of the u64::max key apart (0 where it lacks
    it; 1 for a plain set). `None` from `padded_sets` where the table
    would be pathological."""

    def __init__(self, sets: DeviceSets, L: int):
        n, dev = sets.n, sets.dev
        lens = sets.offs_t[1:] - sets.offs_t[:-1]
        K = len(sets.keys)
        owner = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                        output_size=K)
        at = owner * L + torch.arange(K, device=dev) - sets.offs_t[owner]
        keys = torch.full((n * L,), _PAD, dtype=torch.int64, device=dev)
        keys[at] = sets.keys ^ _TOP
        self.keys, order = torch.sort(keys.reshape(n, L), dim=1)
        self.counts = None
        if sets.counts is not None:
            counts = torch.ones(n * L, dtype=torch.int64, device=dev)
            counts[at] = sets.counts
            self.counts = counts.reshape(n, L).gather(1, order)
        is_max = sets.keys == _U64MAX
        self.max_count = torch.zeros(n, dtype=torch.int64, device=dev)
        self.max_count[owner[is_max]] = (
            torch.ones_like(owner[is_max]) if sets.counts is None
            else sets.counts[is_max])


def padded_sets(result: SketchingResult, dev: torch.device
                ) -> Optional[PaddedSets]:
    """The result's PaddedSets on `dev`, made once and kept on it, or
    None where L * n > 2^28 or L > 16 times the mean set size (the JAX
    `_device_sets_cache` gate)."""
    sets = device_sets(result, dev)
    cache = getattr(result, "_exact_padded", None)
    if cache is not None and cache[0] is sets:
        return cache[1]
    lens = np.diff(sets.offs)
    L = max(1, int(lens.max())) if len(lens) else 1
    pathological = (L * sets.n > (1 << 28)
                    or (lens.mean() > 0 and L > 16 * lens.mean()))
    padded = None if pathological else PaddedSets(sets, L)
    result._exact_padded = (sets, padded)
    return padded


def _pairs_lookup(padded: PaddedSets, ia: torch.Tensor, ib: torch.Tensor,
                  budget: int) -> torch.Tensor:
    """Per pair, every key of the left row looked up in the right row: a
    key found there (not the pad) is a shared key; the u64::max key is
    added apart."""
    L = padded.keys.shape[1]
    step = max(1, budget // L)
    out = torch.empty(len(ia), dtype=torch.int64, device=ia.device)
    for s in range(0, len(ia), step):
        a, b = ia[s:s + step], ib[s:s + step]
        ka, kb = padded.keys[a], padded.keys[b]
        at = torch.searchsorted(kb, ka).clamp_(max=L - 1)
        found = (kb.gather(1, at) == ka) & (ka != _PAD)
        if padded.counts is None:
            isz = found.sum(1)
        else:
            isz = torch.where(found, torch.minimum(
                padded.counts[a], padded.counts[b].gather(1, at)), 0).sum(1)
        out[s:s + step] = isz + torch.minimum(padded.max_count[a],
                                              padded.max_count[b])
    return out


def _pairs_posting(sets: DeviceSets, ia: torch.Tensor, ib: torch.Tensor,
                   budget: int) -> torch.Tensor:
    """Per pair, every key of the left item looked up in the table of all
    sets sorted by (key, item): the (group, item) of the right item found
    there is a shared key. Pairs run in chunks of about `budget` keys."""
    dev = sets.dev
    if sets.table is None:
        sets.table = ExactJoin(sets, np.arange(sets.n))
    table = sets.table
    out = torch.zeros(len(ia), dtype=torch.int64, device=dev)
    if len(table.ukeys) == 0:
        return out
    lens = sets.offs_t[ia + 1] - sets.offs_t[ia]
    csum = torch.cumsum(lens, 0)
    total = int(csum[-1]) if len(csum) else 0
    nsub = -(-total // budget)
    edges = ([0] + torch.searchsorted(csum, torch.arange(
        1, max(nsub, 1), device=dev, dtype=torch.int64) * budget).tolist()
        + [len(ia)])
    for p0, p1 in zip(edges[:-1], edges[1:]):
        if p1 <= p0:
            continue
        keys, owner, counts = sets.gather(ia[p0:p1])
        g = torch.searchsorted(table.ukeys, keys).clamp_(
            max=len(table.ukeys) - 1)
        hit = table.ukeys[g] == keys
        want = g * sets.n + ib[p0:p1][owner]
        at = torch.searchsorted(table.gcol, want).clamp_(
            max=len(table.gcol) - 1)
        found = hit & (table.gcol[at] == want)
        if counts is None:
            add = found.to(torch.int64)
        else:
            add = torch.where(found, torch.minimum(counts,
                                                   table.counts[at]), 0)
        out[p0:p1].index_add_(0, owner, add)
    return out


def exact_intersections_pairs(result: SketchingResult, ia, ib,
                              device="cuda",
                              budget: int = PAIR_BUDGET) -> np.ndarray:
    """(P,) f64 intersection sizes (count sums with a count dictionary)
    of the exact sets of items ia[p] and ib[p], on `device`, for lists of
    any length: dashing2_tpu/cmp/wcompare.py::exact_intersections_pairs.
    The padded pair lookup, or where its table would be pathological the
    posting join."""
    dev = resolve(device)
    if len(ia) == 0:
        return np.zeros(0, np.float64)
    ia_t, ib_t = _index(ia, dev), _index(ib, dev)
    padded = padded_sets(result, dev)
    if padded is None:
        isz = _pairs_posting(device_sets(result, dev), ia_t, ib_t, budget)
    else:
        isz = _pairs_lookup(padded, ia_t, ib_t, budget)
    return isz.cpu().numpy().astype(np.float64)
