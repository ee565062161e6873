"""Interval inputs: BED, BigWig and LeafCutter sketchers.

Port of dashing2_tpu/sketch/intervals.py. Reference: src/bedsketch.cpp
(per-base items ``chrhash ^ position``, weight 1 or 1/(stop-start) with
--normalize-intervals), src/bwsketch.cpp (per-base items weighted by the
track's value), src/lfsketch.cpp (one sketch per sample column; items
are splice-site string hashes weighted by counts, optionally normalised
by their denominators).

The expansion of intervals into per-base items and the exact per-item
weight sums run in numpy on the host, as in the JAX package and in the
same order, so the f64 sums that feed the log-weights are its bits. Set
space: one-permutation items go through the native update over
pre-hashed items (oph_sketch.cpp `oph_update_hashed`, on the host);
FullSetSketch items are each item's distinct items, drawn by
ops/sketch_kernels.py::css_sketch_many on `device`. Weighted spaces
(-B, -P): each item's distinct items and weight sums, drawn by
sketch/weighted.py (csrc/weighted_draws.cu on the card). Unlike the JAX
package, which sketches one item at a time, the items are prepared first
(in a pool of -p threads when -p > 1) and handed to the draws in batches
of up to BATCH_POSITIONS distinct items, so that one launch serves many
files; items are independent, so the registers are the same.

Every row is f64: one-permutation registers as their -log signatures,
CSetSketch registers (+inf written as 0) and weighted sample values.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from .. import hashing as H
from ..config import Dashing2Options
from ..device import resolve
from ..enums import SketchSpace
from ..io.fastx import xopen
from ..ops import sketch_kernels as SK
from ..result import SketchingResult
from ..timing import span

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3

# distinct items the prepared items of one batch of draws hold together
# (16 bytes each on the host for the weighted spaces)
BATCH_POSITIONS = 1 << 26

Slabs = Iterator[Tuple[np.ndarray, np.ndarray]]


def string_hash64(s: str) -> int:
    h = _FNV_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return int(H.wanghash(np.uint64(h)))


def _expand_interval_arrays(chrh: np.ndarray, starts: np.ndarray,
                            stops: np.ndarray, weights: np.ndarray,
                            slab: int = 1 << 22) -> Slabs:
    """Array form of _expand_intervals: (chrhash u64, start i64,
    stop i64, weight f64) arrays -> slabs of (items u64, weights f64),
    item = chrhash ^ position per base."""
    lens = np.maximum(stops - starts, 0)
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    begins = ends - lens
    for lo in range(0, total, slab):
        hi = min(lo + slab, total)
        pos = np.arange(lo, hi, dtype=np.int64)
        iid = np.searchsorted(ends, pos, side="right")
        base = starts[iid] + (pos - begins[iid])
        items = chrh[iid] ^ base.astype(np.uint64)
        yield items, weights[iid]


def _expand_intervals(intervals: List[Tuple[int, int, int, float]],
                      slab: int = 1 << 22) -> Slabs:
    """(chrhash, start, stop, weight) list -> slabs of
    (items u64, weights f64): item = chrhash ^ position per base."""
    if not intervals:
        return
    arr = np.array([(c, s, e, w) for (c, s, e, w) in intervals],
                   dtype=np.float64)
    chrh = np.array([c for (c, s, e, w) in intervals], dtype=np.uint64)
    yield from _expand_interval_arrays(
        chrh, arr[:, 1].astype(np.int64), arr[:, 2].astype(np.int64),
        arr[:, 3], slab)


def _aggregate_key(items: np.ndarray, ws: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sort-aggregate (items, weights) -> (unique sorted items, sums)."""
    order = np.argsort(items, kind="stable")
    si, sw = items[order], np.asarray(ws, np.float64)[order]
    heads = np.concatenate([[True], si[1:] != si[:-1]])
    gid = np.cumsum(heads) - 1
    uniq = si[heads]
    wsum = np.zeros(len(uniq))
    np.add.at(wsum, gid, sw)
    return uniq, wsum


def _aggregate_stream(slabs: Slabs, compact_at: int = 1 << 24
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-item weight sums over an (items, weights) slab stream
    (Counter semantics) at O(distinct items) memory: each slab is
    aggregated on arrival and the running parts compact whenever their
    total length exceeds `compact_at`."""
    parts: List[Tuple[np.ndarray, np.ndarray]] = []
    held = 0
    for items, w in slabs:
        if not len(items):
            continue
        u, s = _aggregate_key(np.asarray(items, np.uint64), w)
        parts.append((u, s))
        held += len(u)
        if held > compact_at and len(parts) > 1:
            u, s = _aggregate_key(
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
            parts = [(u, s)]
            held = len(u)
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0)
    if len(parts) == 1:
        return parts[0]
    return _aggregate_key(np.concatenate([p[0] for p in parts]),
                          np.concatenate([p[1] for p in parts]))


def _distinct(items: np.ndarray) -> np.ndarray:
    """np.unique(items): the distinct items, sorted. By a stable sort
    (numpy's timsort, which takes the runs of consecutive positions
    whole and, unlike np.unique, runs in parallel in -p threads)."""
    s = np.sort(items, kind="stable")
    if len(s) < 2:
        return s
    return s[np.concatenate([[True], s[1:] != s[:-1]])]


def _prepare_item(opts: Dashing2Options, slabs: Slabs):
    """One item's (item, weight) stream -> what its row needs: ("row",
    signatures, cardinality) for a one-permutation item (sketched here,
    on the host), ("css", distinct items) for a FullSetSketch one,
    ("w", distinct items, weight sums) for a weighted one (the JAX
    `_sketch_item_stream` up to its draws)."""
    m = opts.sketchsize
    ct = opts.count_threshold
    if opts.sspace == SketchSpace.SPACE_SET:
        if ct > 1:
            # per-item multiplicity threshold (FullSetSketch(ct, m),
            # bedsketch.cpp:11 / OPSetSketch::set_mincount,
            # bwsketch.cpp:81): an item needs >= ct base-updates before
            # it is admitted to the set; occurrences count, not weights
            uniq, cnt = _aggregate_stream(
                (items, np.ones(len(items))) for items, _w in slabs)
            uniq = uniq[cnt >= ct]
            slabs = iter([(uniq, np.ones(len(uniq)))])
        if opts.one_perm:
            from ..native import load_oph_lib
            lib = load_oph_lib()
            u64p = ctypes.POINTER(ctypes.c_uint64)
            oph_xor = (int(H.mt19937_64_first(H.OPH_DEFAULT_SEED))
                       ^ H.CEIXOR_OPH) & 0xFFFFFFFFFFFFFFFF
            regs = np.full((1, m), SK.U64MAX, np.uint64)
            for items, _w in slabs:
                items = np.ascontiguousarray(items, np.uint64)
                lib.oph_update_hashed(
                    items.ctypes.data_as(u64p), len(items), oph_xor, m,
                    regs.ctypes.data_as(u64p),
                    ctypes.POINTER(ctypes.c_uint32)())
            return ("row", SK.oph_to_sigs(regs)[0],
                    float(SK.oph_cardinality(regs)[0]))
        allitems = [i for i, _ in slabs]
        items = (np.concatenate(allitems) if allitems
                 else np.zeros(0, np.uint64))
        return ("css", _distinct(items))
    # weighted spaces: aggregate exact counts first (Counter semantics)
    uniq, wsum = _aggregate_stream(slabs)
    if ct > 1:
        keep = wsum >= ct
        uniq, wsum = uniq[keep], wsum[keep]
    return ("w", uniq, wsum)


def _draw_batch(opts: Dashing2Options, batch, sigs: np.ndarray,
                cards: np.ndarray, dev) -> None:
    """The draws of a batch of prepared (row index, payload) items on
    `dev`, into their rows of `sigs` and `cards`."""
    rows = [i for i, _ in batch]
    if opts.sspace == SketchSpace.SPACE_SET:
        items = [p[1] for _, p in batch]
        with span("sketch/css"):
            regs, _ = SK.css_sketch_many(items, opts.sketchsize, dev)
        sigs[rows] = np.where(np.isfinite(regs), regs, 0.0)
        for r, reg, it in zip(rows, regs, items):
            cards[r] = float(SK.css_cardinality(reg)) if len(it) else 0.0
        return
    from .weighted import bagminhash_many, probminhash_many
    fn = (bagminhash_many if opts.sspace == SketchSpace.SPACE_MULTISET
          else probminhash_many)
    with span("sketch/weighted"):
        s, c = fn([p[1] for _, p in batch], [p[2] for _, p in batch],
                  opts.sketchsize, dev)
    sigs[rows] = s
    cards[rows] = c


def _sketch_items(opts: Dashing2Options,
                  makers: Sequence[Callable[[], Slabs]], device
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Signatures ((n, m) f64) and cardinalities of the items whose
    (item, weight) streams `makers` open: each item prepared on the host
    (-p threads when -p > 1), the draws of the FullSetSketch and weighted
    items in batches of up to BATCH_POSITIONS distinct items on
    `device`."""
    from .core import in_order
    n, m = len(makers), opts.sketchsize
    sigs = np.zeros((n, m), np.float64)
    cards = np.zeros(n, np.float64)
    dev = None if opts.one_perm else resolve(device)

    def prepare(make):
        with span("sketch/intervals"):
            return _prepare_item(opts, make())
    batch: List[Tuple[int, tuple]] = []
    held = 0
    calls = (functools.partial(prepare, make) for make in makers)
    for i, prep in enumerate(in_order(calls, opts.nthreads, n)):
        if prep[0] == "row":
            sigs[i], cards[i] = prep[1], prep[2]
            continue
        batch.append((i, prep))
        held += len(prep[1])
        if held >= BATCH_POSITIONS:
            _draw_batch(opts, batch, sigs, cards, dev)
            batch, held = [], 0
    if batch:
        _draw_batch(opts, batch, sigs, cards, dev)
    return sigs, cards


def _parse_bed(path: str, opts: Dashing2Options
               ) -> List[Tuple[int, int, int, float]]:
    out = []
    with xopen(path) as f:
        for raw in f:
            line = raw.decode() if isinstance(raw, bytes) else raw
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(f"Malformed BED line: {line!r}")
            chrom = parts[0]
            if opts.trim_chr and chrom.lower().startswith("chr"):
                chrom = chrom[3:]
            start, stop = int(parts[1]), int(parts[2])
            w = 1.0 / (stop - start) if (opts.bed_normalize
                                         and stop > start) else 1.0
            out.append((string_hash64(chrom), start, stop, w))
    return out


def _bed_slabs(opts: Dashing2Options, group: str) -> Slabs:
    intervals: List[Tuple[int, int, int, float]] = []
    for path in group.split():
        intervals.extend(_parse_bed(path, opts))
    return _expand_intervals(intervals)


def sketch_bed(opts: Dashing2Options, groups: Sequence[str],
               device="cuda") -> SketchingResult:
    """BED files: one item per group (its paths' intervals together)."""
    if opts.sspace > SketchSpace.SPACE_PSET:
        raise ValueError("Can't do edit distance for BED files")
    if opts.bed_normalize and opts.sspace == SketchSpace.SPACE_SET:
        raise ValueError("Can't normalize BED rows in set space; use "
                         "--multiset or --prob")
    res = SketchingResult(names=list(groups))
    res.signatures, res.cardinalities = _sketch_items(
        opts, [lambda g=g: _bed_slabs(opts, g) for g in groups], device)
    return res


def _bw_block_slabs(opts: Dashing2Options, readers,
                    chrom_ids=None) -> Slabs:
    """Stream (items, weights) slabs from BigWig readers, one data block
    at a time: memory stays O(block + slab), never O(intervals).
    chrom_ids: optional per-reader chrom-id filter sets (the by-chrom
    path). Zero-valued intervals only drop out of the WEIGHTED spaces;
    the reference's set-space path updates every base unconditionally
    (DO_FOR_UNWEIGHTED_SKETCH ignores the value, bwsketch.cpp:116-123)."""
    keep_zero = opts.sspace == SketchSpace.SPACE_SET
    for ri, r in enumerate(readers):
        want = None if chrom_ids is None else chrom_ids[ri]
        # per-chrom queries iterate R-tree leaves per id (libBigWig
        # overlap-query shape); whole-file iterates once in file order
        block_iter = (r.iter_blocks() if want is None else
                      (blk for cid in sorted(want)
                       for blk in r.iter_blocks(chrom_id=cid)))
        hash_cache: Dict[int, int] = {}
        for cid, starts, ends, vals in block_iter:
            chrom = r.chroms.get(cid)
            if chrom is None:
                continue
            ch = hash_cache.get(cid)
            if ch is None:
                cname = chrom[3:] if (opts.trim_chr
                                      and chrom.lower().startswith(
                                          "chr")) else chrom
                ch = int(string_hash64(cname))
                hash_cache[cid] = ch
            w = vals.astype(np.float64)
            if not keep_zero:
                nz = w != 0
                if not nz.all():
                    starts, ends, w = starts[nz], ends[nz], w[nz]
            if not len(starts):
                continue
            chrh = np.full(len(starts), ch, np.uint64)
            yield from _expand_interval_arrays(
                chrh, starts.astype(np.int64), ends.astype(np.int64), w)


def _bw_item(opts: Dashing2Options, group: str, sets=None) -> Slabs:
    """One BigWig item's stream: the group's tracks (restricted to one
    chromosome's ids per track with `sets`), its readers closed at the
    end."""
    from ..io.bigwig import BigWigReader
    readers = [BigWigReader(p) for p in group.split()]
    try:
        yield from _bw_block_slabs(opts, readers, sets)
    finally:
        for r in readers:
            r.close()


def sketch_bigwig(opts: Dashing2Options, groups: Sequence[str],
                  device="cuda") -> SketchingResult:
    """BigWig coverage tracks: items chrhash^pos weighted by track value
    (bwsketch.cpp:112-119). With --by-chrom, one entry per chromosome is
    appended per group (sketch_core.cpp:65-94), in the order of the
    trimmed chromosome names."""
    from ..io.bigwig import BigWigReader
    names: List[str] = []
    makers: List[Callable[[], Slabs]] = []
    for group in groups:
        if not opts.by_chrom:
            names.append(group)
            makers.append(lambda g=group: _bw_item(opts, g))
            continue
        # trimmed name -> (display name, per-reader chrom ids)
        readers = [BigWigReader(p) for p in group.split()]
        try:
            per: Dict[str, Tuple[str, List[set]]] = {}
            for ri, r in enumerate(readers):
                for cid, chrom in r.chroms.items():
                    cname = chrom[3:] if (
                        opts.trim_chr
                        and chrom.lower().startswith("chr")) else chrom
                    disp, sets = per.setdefault(
                        cname, (chrom, [set() for _ in readers]))
                    sets[ri].add(cid)
        finally:
            for r in readers:
                r.close()
        for _key, (disp, sets) in sorted(per.items()):
            names.append(f"{group}:{disp}")
            makers.append(lambda g=group, s=sets: _bw_item(opts, g, s))
    res = SketchingResult(names=names)
    res.signatures, res.cardinalities = _sketch_items(opts, makers, device)
    return res


def _leafcutter_file(opts: Dashing2Options, path: str
                     ) -> Tuple[List[str], List[Dict[int, float]]]:
    """A LeafCutter perind counts file -> its sample names and each
    sample's {splice-site hash: weight} (lfsketch.cpp:41-125). Values
    are "num/denom"; with --normalize-intervals the weight is num/denom,
    else num."""
    with xopen(path) as f:
        header = f.readline()
        if isinstance(header, bytes):
            header = header.decode()
        sample_names = header.split()[1:] if header.split() else []
        nsamples = len(sample_names)
        per_sample: List[Dict[int, float]] = [dict() for _ in
                                              range(nsamples)]
        for raw in f:
            line = raw.decode() if isinstance(raw, bytes) else raw
            parts = line.split()
            if not parts:
                continue
            # splice site = everything before the THIRD colon
            # (lfsketch.cpp:86-90): the 4th field is the per-run
            # leafcutter cluster id, which must NOT participate or
            # identical junctions from different runs hash apart
            site = parts[0]
            ncol = 0
            for ci, chch in enumerate(site):
                if chch == ":":
                    ncol += 1
                    if ncol == 3:
                        site = site[:ci]
                        break
            if opts.trim_chr and site.lower().startswith("chr"):
                site = site[3:]
            sh = string_hash64(site)
            for si, tok in enumerate(parts[1:nsamples + 1]):
                if "/" in tok:
                    num_s, den_s = tok.split("/")
                    num = float(num_s)
                    den = float(den_s) if den_s else 1.0
                else:
                    num, den = float(tok), 1.0
                if num == 0:
                    continue
                w = num / den if opts.bed_normalize else num
                d = per_sample[si]
                d[sh] = d.get(sh, 0.0) + w
    return sample_names, per_sample


def _dict_slabs(d: Dict[int, float]) -> Slabs:
    items = np.fromiter(d.keys(), dtype=np.uint64, count=len(d))
    ws = np.fromiter(d.values(), dtype=np.float64, count=len(d))
    return iter([(items, ws)]) if len(items) else iter([])


def sketch_leafcutter(opts: Dashing2Options, groups: Sequence[str],
                      device="cuda") -> SketchingResult:
    """LeafCutter perind counts: one sketch per sample column of every
    file (lfsketch.cpp:41-125), named "<sample>:<file prefix>"."""
    names: List[str] = []
    makers: List[Callable[[], Slabs]] = []
    for group in groups:
        for path in group.split():
            with span("sketch/read"):
                sample_names, per_sample = _leafcutter_file(opts, path)
            # file prefix for sample name disambiguation (lfsketch.cpp:25-33)
            pref = path
            for cut in ("_perind", ".count", "_"):
                pos = path.find(cut)
                if pos != -1:
                    pref = path[:pos]
                    break
            for si, sname in enumerate(sample_names):
                names.append(f"{sname}:{pref}")
                makers.append(lambda d=per_sample[si]: _dict_slabs(d))
    res = SketchingResult(names=names)
    res.signatures, res.cardinalities = _sketch_items(opts, makers, device)
    return res
