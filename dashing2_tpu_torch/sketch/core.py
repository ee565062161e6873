"""Sketch orchestration: FASTA/FASTQ files -> SketchingResult.

Port of the routes of dashing2_tpu/sketch/core.py behind a
`sketch_fastx` entry:

* the native file driver (`_native_mode`, `_hash_kwargs`,
  `_finalize_one_perm`, `_try_native_files`) for one-permutation jobs
  over whole plain or gzip files: the C++ engine (oph_sketch.cpp
  `oph_sketch_files`) reads, encodes, hashes and bucket-mins whole path
  groups on host cores (with -s/-N the registers' k-mer ids and
  multiplicities too, which only one-permutation jobs have; with
  --filterset its probe);
* the chunked route (`_sketch_chunked`, the ONE_PERM branch of the JAX
  `_sketch_fastx_core`) for the one-permutation jobs the file driver
  declines: --parse-by-seq (one item a record), FASTA --by-chrom and
  .xz/.bz2 inputs. `_load_items` reads the items, `_iter_chunk_batches`
  cuts their records into chunk rows with halos, and
  ops/oph_rows.py::oph_rows computes each batch's registers on the
  device (csrc/oph_rows.cu on the card, the port of the JAX package's
  device OPH engine); batches merge as `_merge_oph` does;
* the generic route's counting stream for the jobs the file driver
  declines, FullSetSketch (--full-setsketch, with --setsketch-ab or
  --fastcmp-bytes/-shorts/-words quantised on the host),
  --count-threshold > 1, the weighted sketches (-B, -P) and the exact
  k-mer sets (--set) and count dictionaries (--countdict): `_load_items`
  reads each item (a group, or a record with --parse-by-seq; the native
  reader, or the Python parser for .xz/.bz2), `_native_hash_codes_list`
  hashes it (oph_sketch.cpp `hash_rows_native`, with the filterset's
  probe; with --long-kmers exact sets `_native_hash_codes_list128`, the
  full 128-bit keys of `hash_rows_native128`, u128.py), np.unique
  counts it (in a pool with -p > 1; with -c in the weighted spaces a
  CountSketch over a batch of items at a time, csrc/countsketch.cu on
  the card); then
  ops/sketch_kernels.py::css_sketch_many draws the CSetSketch
  registers (csrc/css.cu on the card), sketch/weighted.py the weighted
  ones (csrc/weighted_draws.cu), or the distinct hashes (and their
  counts) are the result;
* the minimizer sequences (--seq, `_sketch_seq`, the FULL_MMER_SEQUENCE
  branch of the JAX `_sketch_fastx_core`): the chunked route's rows, each
  batch through ops/oph_rows.py::hash_rows on the device
  (csrc/oph_rows.cu's `hash_rows` entry on the card), each item's kept
  tokens in row order (with --long-kmers full 128-bit keys), then
  --hp-compress on the host;
* the edit-distance space (-E, with or without --parse-by-seq):
  `_load_raw` reads each record with the Python parser, keeps its raw
  bytes in an io/seqstore.py SequenceStore (the JAX `_load_items`), and
  sketch/omh.py draws the OrderMinHash registers (csrc/omh.cu on the
  card), the base count as the cardinality (the JAX
  `_sketch_fastx_core` branch, dashing2_tpu/sketch/core.py:1047-1059).

--filterset (`_filterset_array`) applies on every route but -E, as in
the JAX package. --entmin, which no route covers, raises
NotImplementedError naming its ROADMAP Queue 1 item (`_unsupported`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, TypeVar)

import numpy as np
import torch

from .. import hashing as H
from ..config import Dashing2Options
from ..device import resolve
from ..enums import Alphabet, KmerSketchResultType, SketchSpace
from ..io import fastx, mmvec
from ..ops import kmers as K
from ..ops import oph_rows as OR
from ..ops import sketch_kernels as SK
from ..result import SketchingResult
from ..timing import add_span, span

DOWNSAMPLE_SALT = OR.DOWNSAMPLE_SALT
T = TypeVar("T")
U64MAX = SK.U64MAX
# the encoding of a job (native/oph_sketch.cpp enum Mode): the same
# selection for the native engine and csrc/oph_rows.cu
_native_mode = OR.encoding
# the u64 the OPH bucket hash xors in (its seed's first draw ^ CEIXOR)
_OPH_XOR = (H.mt19937_64_first(H.OPH_DEFAULT_SEED) ^ H.CEIXOR_OPH) \
    & 0xFFFFFFFFFFFFFFFF
# input bytes above which the chunked route reads items as it reaches
# them (the JAX `_should_stream` default) instead of all at once
STREAM_BYTES = 2 << 30
# codes a chunk batch holds: the card's kernel, or the plain version on
# the CPU (whose int64 intermediates take about 100 bytes a position)
BATCH_CODES = {"cuda": 1 << 26, "cpu": 1 << 19}


def _hash_kwargs(opts: Dashing2Options, chunk_len: int) -> dict:
    spacing = (tuple(K.parse_spacing(opts.spacing, opts.k))
               if opts.spacing else None)
    limit = opts.nremper128 if opts.use128 else opts.nremper64
    rolling = opts.k > limit and not spacing
    return dict(
        k=opts.k, w=opts.w, canon=opts.canonicalize, alphabet=opts.alphabet,
        entmin=opts.entmin, xormask=opts.xormask,
        seed_is_zero=False,
        downsample_threshold=opts.downsample_threshold(),
        chunk_len=chunk_len,
        span=(spacing[-1] + 1) if spacing else opts.k,
        spacing_offsets=spacing,
        rolling=rolling,
        use128=opts.use128 and opts.alphabet in (Alphabet.DNA,
                                                 Alphabet.DNAC),
    )


def _finalize_one_perm(opts: Dashing2Options, res: SketchingResult,
                       regs, counts, n: int, m: int) -> SketchingResult:
    """ONE_PERM finalization: cardinalities and -log signatures (in row
    blocks into a RAM-or-memmap matrix so peak temp memory stays bounded
    for huge N, mm::vector semantics); with -s the registers' k-mer ids
    (the inverse of the register hash, 0 for an empty register), with -N
    their multiplicities."""
    res.cardinalities = SK.oph_cardinality(regs)
    sigs = mmvec.alloc((n, m), np.float64, opts.sig_ram_limit)
    for s in range(0, n, 4096):
        sigs[s:s + 4096] = SK.oph_to_sigs(regs[s:s + 4096])
    res.signatures = sigs
    if opts.save_kmers:
        ids64 = H.oph_hash_inverse(regs)
        ids64[regs == U64MAX] = 0
        res.kmers = ids64
    if opts.save_kmercounts:
        res.kmercounts = counts.astype(np.float32)
    return res


# the weighted sketch spaces: -B (BagMinHash) and -P (ProbMinHash)
_WEIGHTED = (SketchSpace.SPACE_MULTISET, SketchSpace.SPACE_PSET)


# configurations no route covers: the reason, and the ROADMAP Queue 1
# item that ports it
def _unsupported(opts: Dashing2Options) -> List[str]:
    """Reasons the port cannot sketch this job (empty if it can)."""
    why = []
    if opts.entmin and opts.sspace != SketchSpace.SPACE_EDIT_DISTANCE:
        why.append("--entmin, whose entropy scores go through a libm log2 "
                   "that no engine reproduces bit for bit (item 7)")
    return why


def _full128(hkw: dict) -> bool:
    """Keys are full 128-bit (--long-kmers with a DNA alphabet, neither
    the rolling hash nor spaced seeds): the exact sets and minimizer
    sequences keep them (u128.py), register sketches their low word."""
    return bool(hkw["use128"] and not hkw["rolling"]
                and not hkw["spacing_offsets"])


def _exact128_keys(opts: Dashing2Options) -> bool:
    """The JAX `_exact128_keys`: --long-kmers with a DNA alphabet, the
    gate of the u128 cache and file layouts."""
    return bool(opts.use128 and opts.alphabet in (Alphabet.DNA,
                                                  Alphabet.DNAC))


def _exact_sets(opts: Dashing2Options) -> bool:
    """--set or --countdict: the result is each item's distinct hashes."""
    return opts.kmer_result in (KmerSketchResultType.FULL_MMER_SET,
                                KmerSketchResultType.FULL_MMER_COUNTDICT)


def _counting_route(opts: Dashing2Options) -> bool:
    """The jobs the JAX file driver declines and its generic route counts
    (dashing2_tpu/sketch/core.py:923-927, 1066-1072): FullSetSketch,
    --count-threshold > 1, which ends in FullSetSketch too, the weighted
    sketches and the exact k-mer sets and count dictionaries."""
    return (opts.kmer_result == KmerSketchResultType.FULL_SETSKETCH
            or opts.count_threshold > 1 or _exact_sets(opts)
            or opts.sspace in _WEIGHTED)


def sketch_fastx(opts: Dashing2Options, groups: Sequence[str],
                 device="cuda") -> SketchingResult:
    """Sketch FASTA/FASTQ inputs. `groups`: one item per entry; an entry
    may contain several space-separated paths sketched jointly
    (d2.h:52-71); with --parse-by-seq each record is an item, named by
    its record. One-permutation jobs run the native file driver over
    plain and gzip files, the chunked route on `device` otherwise
    (--parse-by-seq, --by-chrom, .xz/.bz2); FullSetSketch,
    --count-threshold > 1 and -B/-P the counting route, whose CSetSketch
    or weighted draws run on `device` (a CUDA request without a card
    raises; nothing falls back). --set and --countdict count on the host
    and touch no device. --seq hashes its rows on `device`. -E draws
    OrderMinHash registers on `device`.
    With --cache (outside --parse-by-seq and -E, as in the JAX package)
    each item's artifact is loaded where it exists and written where it
    does not (`_sketch_cached`)."""
    why = _unsupported(opts)
    if why:
        raise NotImplementedError(
            "not ported: " + ", ".join(why) + " (ROADMAP Queue 1)")
    if not any(g.split() for g in groups):
        raise ValueError("no input files")
    if opts.cache_sketches and not opts.parse_by_seq \
            and opts.sspace != SketchSpace.SPACE_EDIT_DISTANCE:
        return _sketch_cached(opts, groups, device)
    return _sketch_routes(opts, groups, device)


def _sketch_routes(opts: Dashing2Options, groups: Sequence[str], device
                   ) -> SketchingResult:
    """`sketch_fastx` without the cache: the route of the job."""
    if opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE:
        return _sketch_edit(opts, groups, device)
    if opts.kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
        return _sketch_seq(opts, groups, device)
    if _exact_sets(opts):
        return _sketch_exact(opts, groups)
    if opts.sspace in _WEIGHTED:
        return _sketch_weighted(opts, groups, device)
    if _counting_route(opts):
        return _sketch_counted(opts, groups, device)
    if opts.parse_by_seq or opts.by_chrom or any(
            p.endswith((".xz", ".bz2")) for g in groups for p in g.split()):
        # the jobs the JAX file driver declines
        # (dashing2_tpu/sketch/core.py:923-931)
        return _sketch_chunked(opts, groups, device)
    return _sketch_files(opts, groups)


def _native_encoding(hkw: dict):
    """(mode, base, bits, offsets pointer, offset count, rolling-table
    pointer, canon): `_native_mode`'s encoding as the native engine's
    arguments (each pointer keeps its array alive)."""
    mode, base, bits, offsets, roll_table, canon = _native_mode(hkw)
    i32p = ctypes.POINTER(ctypes.c_int32)
    off_p, noff = i32p(), 0
    if offsets is not None:
        off_p = np.ascontiguousarray(offsets, np.int32).ctypes.data_as(i32p)
        noff = len(offsets)
    roll_p, _ = _u64p(roll_table)
    return mode, base, bits, off_p, noff, roll_p, canon


def _u64p(arr: Optional[np.ndarray]):
    """(ctypes u64 pointer, length) of a u64 array, (NULL, 0) for None."""
    u64p = ctypes.POINTER(ctypes.c_uint64)
    if arr is None or not len(arr):
        return u64p(), 0
    return arr.ctypes.data_as(u64p), len(arr)


def _sketch_files(opts: Dashing2Options, groups: Sequence[str]
                  ) -> SketchingResult:
    """The native file driver (`_try_native_files`): read, encode, hash
    and bucket-min whole path groups in C++."""
    hkw = _hash_kwargs(opts, 1 << 15)
    paths: List[str] = []
    item_of: List[int] = []
    for i, g in enumerate(groups):
        for p in g.split():
            paths.append(p)
            item_of.append(i)
    from ..native import load_oph_lib
    lib = load_oph_lib()

    n, m = len(groups), opts.sketchsize
    regs = mmvec.alloc((n, m), np.uint64, opts.sig_ram_limit, fill=U64MAX)
    want_counts = bool(opts.save_kmercounts)
    counts = (mmvec.alloc((n, m), np.uint32, opts.sig_ram_limit, fill=0)
              if want_counts else None)
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    mode, base, bits, off_p, noff, roll_p, canon = _native_encoding(hkw)
    span_len = hkw.get("span") or hkw["k"]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    fs = _filterset_array(opts)
    fs_p, fs_len = _u64p(fs)
    cpaths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    items32 = np.ascontiguousarray(item_of, np.int32)
    lut = K.alphabet_lut(opts.alphabet).tobytes()
    nthreads = opts.nthreads if opts.nthreads > 0 else 0
    with span("sketch/native-files"):
        rc = lib.oph_sketch_files(
            cpaths, items32.ctypes.data_as(i32p), len(paths), n, lut,
            hkw["k"], hkw["w"], int(canon), int(hkw["seed_is_zero"]),
            hkw["xormask"], _OPH_XOR,
            int(ds), hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
            DOWNSAMPLE_SALT, m, nthreads,
            mode, base, bits, off_p, noff, roll_p, fs_p, fs_len,
            span_len, regs.ctypes.data_as(u64p),
            counts.ctypes.data_as(u32p) if want_counts else u32p())
    if rc < 0:
        raise OSError(f"failed to read {paths[-int(rc) - 1]}")
    res = SketchingResult(names=list(groups))
    with span("sketch/finalize"):
        return _finalize_one_perm(opts, res, regs, counts, n, m)


# ----------------------------------------------------------------------
# items: file groups or records
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _Item:
    """One sketchable item: a file group or a single record."""
    name: str
    codes: List[np.ndarray]


def _load_items(opts: Dashing2Options, groups: Sequence[str]
                ) -> Iterator[_Item]:
    """The items, alphabet-encoded, each read when it is reached (the JAX
    `_load_items` and `_iter_items_lazy` outside the edit-distance
    space): with --parse-by-seq one item a record, named by its record;
    otherwise one a group, its records' codes in a list."""
    for group in groups:
        t0 = time.perf_counter()
        codes = []
        for path in group.split():
            for name, c in fastx.read_encoded(path, opts.alphabet):
                if opts.parse_by_seq:
                    add_span("sketch/read", time.perf_counter() - t0)
                    yield _Item(name=name, codes=[c])
                    t0 = time.perf_counter()
                else:
                    codes.append(c)
        add_span("sketch/read", time.perf_counter() - t0)
        if not opts.parse_by_seq:
            yield _Item(name=group, codes=codes)


def _should_stream(groups: Sequence[str]) -> bool:
    """Read items as they are reached instead of all at once: above
    STREAM_BYTES of input (the reference's per-file streaming with
    O(file) buffers, fastxsketch.cpp:302-424)."""
    total = 0
    for g in groups:
        for path in g.split():
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        if total > STREAM_BYTES:
            return True
    return False


def _count_records(groups: Sequence[str]) -> List[str]:
    """The record names of --parse-by-seq, a first pass over the inputs
    when the items stream (the reference's two-pass design,
    fastxsketchbyseq.cpp:146-171)."""
    return [name for group in groups for path in group.split()
            for name, _ in fastx.read_fastx(path)]


def _auto_chunk_len(items: Sequence[_Item]) -> int:
    """Smallest power-of-two chunk covering the longest record, in
    [4096, 32768] (the JAX package's choice: chunk edges then fall where
    its route puts them)."""
    longest = max((len(c) for it in items for c in it.codes), default=0)
    cl = 4096
    while cl < longest and cl < (1 << 15):
        cl <<= 1
    return cl


def _iter_chunk_batches(opts: Dashing2Options, items: Iterable[_Item],
                        chunk_len: int, batch_codes: int
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(rows (R, L) uint8, item index (R,) int32) batches of about
    `batch_codes` codes: each item's records cut into chunk rows with
    halos (`kmers.chunk_codes`), in item order; an item's rows may span
    batches."""
    spacing = (K.parse_spacing(opts.spacing, opts.k)
               if opts.spacing else None)
    span_len = (spacing[-1] + 1) if spacing else opts.k
    halo_w = opts.w if opts.w > span_len else 0
    h_l, h_r = K.chunk_halos(span_len, halo_w)
    rows_per_batch = max(1, batch_codes // (chunk_len + h_l + h_r))
    buf: List[np.ndarray] = []
    ids: List[np.ndarray] = []
    held = 0
    for idx, item in enumerate(items):
        t0 = time.perf_counter()
        if any(len(c) >= span_len for c in item.codes):
            rows = K.chunk_codes(item.codes, span_len, chunk_len=chunk_len,
                                 w=halo_w)
            buf.append(rows)
            ids.append(np.full(len(rows), idx, np.int32))
            held += len(rows)
        add_span("sketch/chunk", time.perf_counter() - t0)
        while held >= rows_per_batch:
            t0 = time.perf_counter()
            rows, rid = np.concatenate(buf), np.concatenate(ids)
            out = (rows[:rows_per_batch], rid[:rows_per_batch])
            buf, ids = [rows[rows_per_batch:]], [rid[rows_per_batch:]]
            held -= rows_per_batch
            add_span("sketch/chunk", time.perf_counter() - t0)
            yield out
    if held:
        yield np.concatenate(buf), np.concatenate(ids)


def _merge_oph(regs_a, counts_a, regs_b, counts_b):
    """Merge two OPH partials: min registers; counts follow the winning
    side and add when both sides hold the same min (streaming semantics,
    oph.h:206-210)."""
    take_b = regs_b < regs_a
    tie = regs_b == regs_a
    regs = np.where(take_b, regs_b, regs_a)
    counts = np.where(tie, counts_a + counts_b,
                      np.where(take_b, counts_b, counts_a))
    return regs, counts


def _chunked_items(opts: Dashing2Options, groups: Sequence[str]
                   ) -> Tuple[List[str], Iterable[_Item], int]:
    """(names, items, chunk length) of the chunked routes: the items
    read as they are reached above STREAM_BYTES of input (the records'
    names from a first pass), with chunks of 2^15; else all at once, the
    chunk length from the longest record."""
    if _should_stream(groups):
        names = (_count_records(groups) if opts.parse_by_seq
                 else list(groups))
        return names, _load_items(opts, groups), 1 << 15
    items = list(_load_items(opts, groups))
    return [it.name for it in items], items, _auto_chunk_len(items)


def _device_filterset(opts: Dashing2Options, dev: torch.device
                      ) -> Optional[torch.Tensor]:
    """`_filterset_array` as int64 bits on `dev`, or None."""
    fs = _filterset_array(opts)
    return (torch.from_numpy(fs.view(np.int64)).to(dev)
            if fs is not None and len(fs) else None)


def _sketch_chunked(opts: Dashing2Options, groups: Sequence[str], device
                    ) -> SketchingResult:
    """The one-permutation jobs the file driver declines: the ONE_PERM
    branch of the JAX `_sketch_fastx_core`
    (dashing2_tpu/sketch/core.py:1076-1229). Items' records are cut into
    chunk rows (the chunk length the JAX package picks, from the longest
    record), batches of rows go to `device`, ops/oph_rows.py computes
    their items' registers (and with -N their counts) there, and the
    host merges each batch into the items' rows (a register is a min, a
    count follows its min). With the filterset's probe on the device."""
    from ..io.prefetch import prefetch
    dev = resolve(device)
    names, items, chunk_len = _chunked_items(opts, groups)
    n, m = len(names), opts.sketchsize
    hkw = _hash_kwargs(opts, chunk_len)
    fs_dev = _device_filterset(opts, dev)
    want_counts = bool(opts.save_kmercounts)
    regs = mmvec.alloc((n, m), np.uint64, opts.sig_ram_limit, fill=U64MAX)
    counts = (mmvec.alloc((n, m), np.uint32, opts.sig_ram_limit, fill=0)
              if want_counts else None)
    for rows, rid in prefetch(_iter_chunk_batches(
            opts, items, chunk_len, BATCH_CODES[dev.type])):
        with span("sketch/oph-rows"):
            i0, i1 = int(rid[0]), int(rid[-1]) + 1
            r, c = OR.oph_rows(torch.from_numpy(rows).to(dev),
                               torch.from_numpy(rid - i0).to(dev), i1 - i0,
                               m, hkw, fs_dev, want_counts)
            r = r.cpu().numpy().view(np.uint64)
            if want_counts:
                regs[i0:i1], counts[i0:i1] = _merge_oph(
                    regs[i0:i1], counts[i0:i1], r,
                    c.cpu().numpy().view(np.uint32))
            else:
                np.minimum(regs[i0:i1], r, out=regs[i0:i1])
    res = SketchingResult(names=names)
    with span("sketch/finalize"):
        return _finalize_one_perm(opts, res, regs, counts, n, m)


def _sketch_seq(opts: Dashing2Options, groups: Sequence[str], device
                ) -> SketchingResult:
    """--seq: each item's minimizer sequence, the FULL_MMER_SEQUENCE
    branch of the JAX `_sketch_fastx_core`
    (dashing2_tpu/sketch/core.py:1237-1285). The chunked route's rows
    (`_chunked_items`, `_iter_chunk_batches`), each batch through
    ops/oph_rows.py::hash_rows on `device` (minimizers, ownership,
    downsampling, the filterset's probe); each row's kept tokens come
    back in position order with the row's count, and join their item's
    sequence in row order. With --long-kmers (`_full128`) the tokens are
    full 128-bit keys (u128.py). --hp-compress then drops each token
    equal to the one before it. The cardinality is the sequence's
    length."""
    from .. import u128 as U
    from ..io.prefetch import prefetch
    dev = resolve(device)
    names, items, chunk_len = _chunked_items(opts, groups)
    n = len(names)
    hkw = _hash_kwargs(opts, chunk_len)
    full = _full128(hkw)
    x2 = opts.xormask2_hi if full else None
    fs_dev = _device_filterset(opts, dev)
    acc: List[List[np.ndarray]] = [[] for _ in range(n)]
    for rows, rid in prefetch(_iter_chunk_batches(
            opts, items, chunk_len, BATCH_CODES[dev.type])):
        with span("sketch/hash-rows"):
            lo, hi, cnt = OR.hash_rows(torch.from_numpy(rows).to(dev), hkw,
                                       fs_dev, x2)
            lo = lo.cpu().numpy().view(np.uint64)
            if full:
                lo = U.from_words(hi.cpu().numpy().view(np.uint64), lo)
            cnt = cnt.cpu().numpy()
            # rows arrive in item order: each item's tokens are one run
            first = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]])
            ends = np.cumsum(cnt)[np.r_[first[1:], len(rid)] - 1]
            for item, a, b in zip(rid[first], np.r_[0, ends[:-1]], ends):
                acc[item].append(lo[a:b])
    empty = np.zeros(0, U.U128 if full else np.uint64)
    seqs = []
    for parts in acc:
        hv = np.concatenate(parts) if parts else empty
        if opts.homopolymer_compress_minimizers and len(hv):
            hv = hv[np.r_[True, hv[1:] != hv[:-1]]]
        seqs.append(hv)
    res = SketchingResult(names=names)
    res.mmer_sequences = seqs
    res.cardinalities = np.array([len(q) for q in seqs], np.float64)
    return res


def _native_oph_rows(lib, chunks: np.ndarray, hkw: dict, m: int,
                     want_counts: bool, filterset: Optional[np.ndarray] = None,
                     nthreads: int = 0):
    """(registers (R, m) u64, counts (R, m) u32) of each chunk row, on
    host cores by the native engine (oph_rows_native; the JAX package's
    `_native_oph_rows`): a second reference for ops/oph_rows.py, which
    `sketch_fastx` never routes to."""
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    R, L = chunks.shape
    regs = np.empty((R, m), np.uint64)
    counts = np.zeros((R, m), np.uint32)
    span_len = hkw.get("span") or hkw["k"]
    lo, hi = K.owned_kmer_range(span_len, hkw["w"], hkw["chunk_len"])
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    mode, base, bits, off_p, noff, roll_p, canon = _native_encoding(hkw)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    fs_p, fs_len = _u64p(filterset)
    lib.oph_rows_native(
        chunks.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), R, L,
        hkw["k"], hkw["w"], int(canon), int(hkw["seed_is_zero"]),
        hkw["xormask"], _OPH_XOR, int(ds),
        hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF, DOWNSAMPLE_SALT,
        lo, hi, m, nthreads, mode, base, bits, off_p, noff, roll_p, fs_p,
        fs_len, span_len, regs.ctypes.data_as(u64p),
        counts.ctypes.data_as(u32p) if want_counts else u32p())
    return regs, counts


def merge_rows(regs: np.ndarray, counts: np.ndarray, row_item: np.ndarray,
               n: int):
    """Rows' registers and counts -> their items' (n, m), the rows in item
    order: the min of the item's rows, and the counts of the rows that
    hold it, summed (the merge of `_merge_oph`); items without rows stay
    empty."""
    if len(row_item) and (np.diff(row_item) < 0).any():
        raise ValueError("rows must be in item order")
    out = np.full((n, regs.shape[1]), U64MAX, np.uint64)
    cnt = np.zeros(out.shape, np.uint32)
    if not len(row_item):
        return out, cnt
    starts = np.flatnonzero(np.r_[True, row_item[1:] != row_item[:-1]])
    mins = np.minimum.reduceat(regs, starts, axis=0)
    held = regs == np.repeat(mins, np.diff(np.r_[starts, len(row_item)]),
                             axis=0)
    out[row_item[starts]] = mins
    cnt[row_item[starts]] = np.add.reduceat(
        np.where(held, counts, 0).astype(np.uint32), starts, axis=0)
    return out, cnt


# ----------------------------------------------------------------------
# the filterset
# ----------------------------------------------------------------------

def _filterset_array(opts: Dashing2Options) -> Optional[np.ndarray]:
    """The sorted distinct u64 hashes --filterset excludes (d2.cpp:45-98;
    the JAX `_filterset_array`), None without one. A `:suffix` other than
    'k'/'K' marks the file as a raw binary u64 list (e.g. a -s
    artifact's ids) taken as it is; otherwise it is a FASTA whose records'
    k-mers are hashed exactly like the data (the job's encoding,
    minimizers and scramble, without downsampling), here by the native
    engine (hash_rows_native)."""
    if not opts.filterset_path:
        return None
    arg = opts.filterset_path
    i = arg.rfind(":")
    if i != -1:
        path, suffix = arg[:i], arg[i + 1:]
        if suffix[:1].upper() != "K":
            with fastx.xopen(path) as f:
                raw = np.frombuffer(f.read(), dtype=np.uint64)
            return np.unique(raw)
        arg = path
    sub = dataclasses.replace(opts, filterset_path="",
                              kmer_downsample_frac=1.0)
    from ..native import load_oph_lib
    lib = load_oph_lib()
    hkw = _hash_kwargs(sub, 1 << 15)
    hashes = [_native_hash_codes_list(lib, [codes], hkw)
              for _, codes in fastx.read_encoded(arg, opts.alphabet)]
    if not hashes:
        return None
    return np.unique(np.concatenate(hashes))


# ----------------------------------------------------------------------
# the counting route: hash, count, then FullSetSketch
# ----------------------------------------------------------------------

def _native_hash_codes_list(lib, codes_list, hkw: dict,
                            filterset: Optional[np.ndarray] = None
                            ) -> np.ndarray:
    """Compact valid scrambled k-mer hashes for a list of RECORD code
    arrays, computed on host by the native engine (hash_rows_native),
    those in the sorted `filterset` dropped. Records are padded into
    bucketed power-of-two rows (one record per row — per-record
    semantics identical to the chunked device path)."""
    span_len = hkw.get("span") or hkw["k"]
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    mode, base, bits, off_p, noff, roll_p, canon = _native_encoding(hkw)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fs_p, fs_len = _u64p(filterset)
    buckets: dict = {}
    for c in codes_list:
        if len(c) < span_len:
            continue
        L = 256
        while L < len(c):
            L <<= 1
        buckets.setdefault(L, []).append(c)
    parts: List[np.ndarray] = []
    for L, recs in sorted(buckets.items()):
        rcap = max(1, (32 << 20) // L)
        for s in range(0, len(recs), rcap):
            grp = recs[s:s + rcap]
            rows = np.full((len(grp), L), K.INVALID, np.uint8)
            for r, c in enumerate(grp):
                rows[r, :len(c)] = c
            npos = L - span_len + 1
            out = np.empty(len(grp) * npos, np.uint64)
            cnt = lib.hash_rows_native(
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                len(grp), L, hkw["k"], hkw["w"], int(canon),
                int(hkw["seed_is_zero"]), hkw["xormask"], int(ds),
                hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
                DOWNSAMPLE_SALT, mode, base, bits, off_p, noff,
                roll_p, fs_p, fs_len, span_len,
                out.ctypes.data_as(u64p))
            parts.append(out[:cnt].copy())
    if not parts:
        return np.zeros(0, np.uint64)
    return np.concatenate(parts)


def _native_hash_codes_list128(lib, codes_list, hkw: dict,
                               xormask2_hi: int,
                               filterset: Optional[np.ndarray] = None
                               ) -> np.ndarray:
    """u128 variant of `_native_hash_codes_list` (the JAX function of
    that name): the compact FULL masked (hi', lo') keys of the records
    (the u128 maskfn of enums.h:144-148) as a structured u128 array,
    by `hash_rows_native128`; the minimizer, downsample and filterset
    gates of `_hash_chunk_batch128`, which read the masked low word."""
    from .. import u128 as U
    k = hkw["k"]
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fs_p, fs_len = _u64p(filterset)
    buckets: dict = {}
    for c in codes_list:
        if len(c) < k:
            continue
        L = 256
        while L < len(c):
            L <<= 1
        buckets.setdefault(L, []).append(c)
    parts: List[np.ndarray] = []
    for L, recs in sorted(buckets.items()):
        rcap = max(1, (32 << 20) // L)
        for s in range(0, len(recs), rcap):
            grp = recs[s:s + rcap]
            rows = np.full((len(grp), L), K.INVALID, np.uint8)
            for r, c in enumerate(grp):
                rows[r, :len(c)] = c
            npos = L - k + 1
            out_hi = np.empty(len(grp) * npos, np.uint64)
            out_lo = np.empty(len(grp) * npos, np.uint64)
            cnt = lib.hash_rows_native128(
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                len(grp), L, k, hkw["w"], int(hkw["canon"]),
                int(hkw["seed_is_zero"]), hkw["xormask"],
                xormask2_hi & 0xFFFFFFFFFFFFFFFF, int(ds),
                hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
                DOWNSAMPLE_SALT, fs_p, fs_len,
                out_hi.ctypes.data_as(u64p), out_lo.ctypes.data_as(u64p))
            parts.append(U.from_words(out_hi[:cnt], out_lo[:cnt]))
    if not parts:
        return np.zeros(0, U.U128)
    return np.concatenate(parts)


def _thresholded(opts: Dashing2Options, u: np.ndarray, c: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The items seen at least --count-threshold times (u64 keys as
    u64; u128 keys stay structured)."""
    from .. import u128 as U
    if opts.count_threshold > 1:
        keep = c >= opts.count_threshold
        u, c = u[keep], c[keep]
    if not U.is_u128(u):
        u = u.astype(np.uint64, copy=False)
    return u, c.astype(np.float64, copy=False)


def _count_one(opts: Dashing2Options, hv: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct hashes (sorted u64, or u128 keys in u128 order) and
    their counts (f64), those seen fewer than --count-threshold times
    dropped."""
    from .. import u128 as U
    t0 = time.perf_counter()
    u, c = (U.unique_counts(hv) if U.is_u128(hv)
            else np.unique(hv, return_counts=True))
    add_span("sketch/count", time.perf_counter() - t0)
    return _thresholded(opts, u, c)


def in_order(calls: Iterable[Callable[[], T]], nthreads: int,
             n: int) -> Iterator[T]:
    """The results of `n` zero-argument calls, in order: run in a pool of
    `nthreads` threads when nthreads > 1 and n > 1 (numpy releases the GIL
    in its sorts), with at most 2 * nthreads calls in flight; the next
    call is taken from `calls` (which may do work of its own, in this
    thread) only when one is free."""
    if nthreads <= 1 or n <= 1:
        for call in calls:
            yield call()
        return
    pending: List = []
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        for call in calls:
            pending.append(pool.submit(call))
            while len(pending) > 2 * nthreads:
                yield pending.pop(0).result()
        for fut in pending:
            yield fut.result()


def _count_stream(opts: Dashing2Options, groups: Sequence[str],
                  names: Optional[List[str]] = None,
                  device=torch.device("cpu")
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each item's distinct hashes and their counts: native hashing item
    by item (with the filterset's probe; the full 128-bit keys of
    --long-kmers exact sets), counting in a pool of -p threads when -p >
    1. With -c in a weighted space the items' streams are counted in
    batches instead (`_count_sketched`). The items' names are appended
    to `names`."""
    from ..native import load_oph_lib
    lib = load_oph_lib()
    hkw = _hash_kwargs(opts, 1 << 15)
    fs = _filterset_array(opts)
    exact128 = _exact_sets(opts) and _full128(hkw)

    def streams():
        for item in _load_items(opts, groups):
            if names is not None:
                names.append(item.name)
            with span("sketch/hash"):
                hv = (_native_hash_codes_list128(lib, item.codes, hkw,
                                                 opts.xormask2_hi, fs)
                      if exact128 else
                      _native_hash_codes_list(lib, item.codes, hkw, fs))
            yield hv
    if opts.cssize > 0 and opts.sspace in _WEIGHTED:
        return _count_sketched(opts, streams(), device)
    calls = (functools.partial(_count_one, opts, hv) for hv in streams())
    n = 2 if opts.parse_by_seq else len(groups)   # more than one item?
    return list(in_order(calls, opts.nthreads, n))


def _count_sketched(opts: Dashing2Options, streams: Iterable[np.ndarray],
                    device) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The CountSketches of the items' hash streams, in item order (with
    -c in a weighted space, enums.h:44-57, counter.h): bucket h % c gains
    +1 where h is odd and -1 where it is even; an item's entries are its
    non-zero buckets' indices, their weights |bucket|. The streams are
    gathered into batches of up to CS.BATCH_HASHES hashes (an item longer
    than that alone), each batch counted by one ops/countsketch.py call
    on `device` (csrc/countsketch.cu on the card, its plain version on
    the CPU) in this thread, then --count-threshold applied item by
    item."""
    from ..ops import countsketch as CS
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    batch: List[np.ndarray] = []

    def flush():
        t0 = time.perf_counter()
        out.extend(_thresholded(opts, u, c) for u, c in
                   CS.countsketch_many(batch, opts.cssize, device))
        add_span("sketch/count", time.perf_counter() - t0)
        batch.clear()
    size = 0
    for hv in streams:
        if batch and size + len(hv) > CS.BATCH_HASHES:
            flush()
            size = 0
        batch.append(hv)
        size += len(hv)
    if batch:
        flush()
    return out


def _sketch_counted(opts: Dashing2Options, groups: Sequence[str],
                    device) -> SketchingResult:
    """The JAX generic route's counting stream and FullSetSketch
    finalization (dashing2_tpu/sketch/core.py:1287-1498): each item's
    distinct hashes, CSetSketch registers (+inf written as 0) and
    m / sum(registers), an empty item's cardinality 0; with
    --setsketch-ab or --fastcmp-bytes/-shorts/-words the registers are
    quantised on the host, with the harmonic-mean cardinality."""
    names: List[str] = []
    uniq = [u for u, _ in _count_stream(opts, groups, names)]
    n, m = len(names), opts.sketchsize
    dev = resolve(device)
    with span("sketch/css"):
        regs, _ = SK.css_sketch_many(uniq, m, dev)
    res = SketchingResult(names=names)
    with span("sketch/finalize"):
        sigs = mmvec.alloc((n, m), np.float64, opts.sig_ram_limit)
        cards = np.empty(n, dtype=np.float64)
        for i, u in enumerate(uniq):
            sigs[i] = np.where(np.isfinite(regs[i]), regs[i], 0.0)
            cards[i] = SK.css_cardinality(regs[i]) if len(u) else 0.0
        if not opts.sketch_compressed_set:
            res.signatures = sigs
            res.cardinalities = cards
            return res
        # --setsketch-ab / --fastcmp-{bytes,shorts,words}: quantize to the
        # fixed (a, b) registers directly. Quantizing the exact CSetSketch
        # registers is identical to sketching into quantized registers
        # (CSetSketch::to_setsketch, setsketch.h:325-333).
        from ..cmp.core import _QLUT
        a_, b_ = opts.compressed_a, opts.compressed_b
        q = _QLUT[opts.fd_level]
        logbinv = 1.0 / np.log1p(b_ - 1.0)
        with np.errstate(divide="ignore"):
            kq = np.clip(np.floor(1.0 - np.log(np.maximum(sigs, 1e-300)
                                               / a_) * logbinv),
                         0, int(q) + 1)
        kq = np.where(sigs <= 0, 0, kq)
        dt = {0.5: np.uint8, 1.0: np.uint8, 2.0: np.uint16,
              4.0: np.uint32, 8.0: np.uint64}[opts.fd_level]
        res.signatures = kq.astype(dt)
        # harmonic-mean cardinality over quantized registers
        # (SetSketch::cardinality, setsketch.h:773-777)
        num = m * (1.0 - 1.0 / b_) * logbinv / a_
        res.cardinalities = num / np.power(b_, -kq).sum(axis=1)
    return res


def _sketch_exact(opts: Dashing2Options, groups: Sequence[str]
                  ) -> SketchingResult:
    """The JAX generic route's exact finalization
    (dashing2_tpu/sketch/core.py:1445-1455): --set keeps each item's
    distinct sorted hashes (u128 keys with --long-kmers), with their
    number as the cardinality;
    --countdict also keeps their counts, with their sum as the
    cardinality. An item shorter than k has an empty set."""
    names: List[str] = []
    counted = _count_stream(opts, groups, names)
    res = SketchingResult(names=names)
    res.kmer_sets = [u for u, _ in counted]
    if opts.kmer_result == KmerSketchResultType.FULL_MMER_COUNTDICT:
        res.kmer_set_counts = [c for _, c in counted]
        res.cardinalities = np.array([c.sum() for _, c in counted],
                                     np.float64)
    else:
        res.cardinalities = np.array([len(u) for u, _ in counted],
                                     np.float64)
    return res


def _sketch_weighted(opts: Dashing2Options, groups: Sequence[str],
                     device) -> SketchingResult:
    """The JAX generic route's weighted finalization
    (dashing2_tpu/sketch/core.py:1457-1464): -B BagMinHash (ICWS) or -P
    ProbMinHash registers of each item's distinct hashes (or CountSketch
    buckets) and their counts, drawn on `device` (csrc/weighted_draws.cu
    on the card), with the total weight as the cardinality."""
    from .weighted import bagminhash_many, probminhash_many
    fn = (bagminhash_many if opts.sspace == SketchSpace.SPACE_MULTISET
          else probminhash_many)
    names: List[str] = []
    dev = resolve(device)
    counted = _count_stream(opts, groups, names, dev)
    with span("sketch/weighted"):
        sigs, cards = fn([u for u, _ in counted], [c for _, c in counted],
                         opts.sketchsize, dev)
    res = SketchingResult(names=names)
    res.signatures = sigs
    res.cardinalities = cards
    return res


# ----------------------------------------------------------------------
# the edit-distance space (-E): OrderMinHash registers
# ----------------------------------------------------------------------

def _load_raw(opts: Dashing2Options, groups: Sequence[str]):
    """(names, codes, store): the JAX `_load_items` with raw sequences
    kept (dashing2_tpu/sketch/core.py:315-350). Every record is read by
    the Python parser and its bytes kept in a SequenceStore (RAM below
    2 Gbp, an unlinked temp file above; --seqs-in-ram pins RAM). With
    --parse-by-seq each record is an item (named by its record);
    otherwise each group is one item, its records' codes and bytes
    concatenated (k-mers then span the record boundaries)."""
    from ..io.seqstore import SequenceStore
    store = SequenceStore(in_ram=opts.seqs_in_ram)
    names: List[str] = []
    codes: List[np.ndarray] = []
    with span("sketch/read"):
        for group in groups:
            if opts.parse_by_seq:
                for path in group.split():
                    for name, seq in fastx.read_fastx(path):
                        store.append(bytes(seq))
                        names.append(name)
                        codes.append(K.encode_ascii(seq, opts.alphabet))
                continue
            parts, raws = [], []
            for path in group.split():
                for _, seq in fastx.read_fastx(path):
                    parts.append(K.encode_ascii(seq, opts.alphabet))
                    raws.append(bytes(seq))
            store.append(b"".join(raws))
            names.append(group)
            codes.append(np.concatenate(parts) if parts
                         else np.zeros(0, np.uint8))
    return names, codes, store


def _sketch_edit(opts: Dashing2Options, groups: Sequence[str],
                 device) -> SketchingResult:
    """OrderMinHash signatures (u64 in the f64 signature slot) over the
    raw sequences, drawn on `device`; the base count as the
    cardinality; the sequences kept for exact edit distances and
    --greedy ...f."""
    from .omh import omh_sketch_many
    names, codes, store = _load_raw(opts, groups)
    dev = resolve(device)
    with span("sketch/omh"):
        sigs = omh_sketch_many(codes, opts.k, opts.sketchsize, device=dev)
    res = SketchingResult(names=names)
    res.signatures = sigs.view(np.float64)
    res.cardinalities = np.array([len(c) for c in codes], np.float64)
    res.sequences = store
    return res


# ----------------------------------------------------------------------
# --cache: per-item artifacts (checkpoint/restart)
# ----------------------------------------------------------------------

# register dtype of a sketch-compressed FullSetSketch cache, by --fastcmp
_CACHE_DTYPES = {0.5: np.uint8, 1.0: np.uint8, 2.0: np.uint16,
                 4.0: np.uint32, 8.0: np.uint64}


def _counts_dest(keys_dest: str) -> str:
    """<keys path minus its suffix>.kmercounts.f64: the reference's
    destkmercounts naming (fastxsketch.cpp:314-318)."""
    return keys_dest[:keys_dest.rfind(".")] + ".kmercounts.f64"


def _write_kmer_set(keys: np.ndarray, path: str,
                    card: Optional[float] = None) -> None:
    """An exact set's or minimizer sequence's cache (fastxsketch.cpp:
    467-489, 526-553): the f64 cardinality (sets only; a sequence's file
    is headerless), then the u64 keys raw or the u128 keys little-endian
    (lo, hi)."""
    from .. import u128 as U
    with open(path, "wb") as f:
        if card is not None:
            np.float64(card).tofile(f)
        if U.is_u128(keys):
            U.tofile_bytes(np.asarray(keys, U.U128)).tofile(f)
        else:
            np.ascontiguousarray(keys, np.uint64).tofile(f)


def _read_kmer_set(opts: Dashing2Options, path: str,
                   beside: Sequence[str] = (), with_card: bool = True):
    """(cardinality, keys) of an exact set's cache, or with `with_card`
    False the keys of a (headerless) minimizer sequence's: u64, or u128
    keys (`_exact128_keys`). The JAX package streams a u64 set from its
    file (io/diskset.py) where it and the files `beside` it hold more
    than --sig-ram-limit bytes, which is not ported."""
    from .. import u128 as U
    u128 = _exact128_keys(opts)
    if with_card and not u128 and sum(
            os.path.getsize(p) for p in (path, *beside)) \
            > opts.sig_ram_limit:
        raise NotImplementedError(
            f"{path}: exact-set caches larger than --sig-ram-limit are "
            "streamed from their files in the JAX package, which is not "
            "ported (ROADMAP Queue 1 item 8)")
    off = 8 if with_card else 0
    raw = np.fromfile(path, dtype=np.uint64, offset=off)
    if u128:
        if len(raw) % 2:
            raise ValueError(f"{path}: odd u64 count for u128 keys")
        pairs = raw.reshape(-1, 2)
        raw = U.from_words(pairs[:, 1], pairs[:, 0])
    if not with_card:
        return raw
    return float(np.fromfile(path, np.float64, count=1)[0]), raw


def _load_cached(opts: Dashing2Options, group: str, dest: str, sig_dt,
                 want_kmers: bool):
    """(cardinality, payload) of the item's artifact, or None for a miss
    (a missing, short or unreadable file): the registers with their
    `.kmers.u64`/`.kmercounts.f32` siblings, an exact set's keys, a
    count dictionary's keys and `.kmercounts.f64` counts, or a minimizer
    sequence (its length the cardinality)."""
    from ..io import formats
    from ..io.cache import makedest
    kres = opts.kmer_result
    try:
        if kres == KmerSketchResultType.FULL_MMER_COUNTDICT:
            kpath = makedest(opts, group, iskmer=True)
            cpath = _counts_dest(kpath)
            if not (os.path.isfile(kpath) and os.path.isfile(cpath)):
                return None
            card, keys = _read_kmer_set(opts, kpath, (cpath,))
            counts = np.fromfile(cpath, dtype=np.float64)
            return (card, (keys, counts)) if len(keys) == len(counts) \
                else None
        if not os.path.isfile(dest):
            return None
        if kres == KmerSketchResultType.FULL_MMER_SET:
            return _read_kmer_set(opts, dest)
        if kres == KmerSketchResultType.FULL_MMER_SEQUENCE:
            seq = _read_kmer_set(opts, dest, with_card=False)
            return float(len(seq)), seq
        card, regs = formats.read_sketch_cache(dest, dtype=sig_dt)
        m = opts.sketchsize
        kk = cc = None
        if want_kmers and opts.save_kmers:
            kk = np.fromfile(dest + ".kmers.u64", dtype=np.uint64)
        if want_kmers and opts.save_kmercounts:
            cc = np.fromfile(dest + ".kmercounts.f32", dtype=np.float32)
        if len(regs) != m or any(x is not None and len(x) != m
                                 for x in (kk, cc)):
            return None
        return card, (regs, kk, cc)
    except (OSError, ValueError):
        return None


def _sketch_cached(opts: Dashing2Options, groups: Sequence[str], device
                   ) -> SketchingResult:
    """--cache (the JAX `_sketch_fastx_cached`,
    dashing2_tpu/sketch/core.py:518-696; fastxsketch.cpp:313-380,461-524):
    probe every item's artifact (io/cache.py::makedest, under --outprefix
    when given) and load the hits; sketch the misses through the routes
    above; assemble the result in input order; write each miss's
    artifact (a write that fails is skipped). Artifacts: the registers
    (.opss/.ss/.bmh/.pmh: f64, or the quantised width of a
    sketch-compressed FullSetSketch), with -s/-N in set space their
    `.kmers.u64`/`.kmercounts.f32`, an exact set's `.kmerset64` (u128
    keys: `.kmerset128`), a count dictionary's keys and
    `.kmercounts.f64`, a minimizer sequence's `.mmerseq64`
    (`.mmerseq128`)."""
    from ..io import formats
    from ..io.cache import makedest
    kres = opts.kmer_result
    exact = _exact_sets(opts)
    seq = kres == KmerSketchResultType.FULL_MMER_SEQUENCE
    m, n = opts.sketchsize, len(groups)
    sig_dt = (_CACHE_DTYPES[opts.fd_level] if opts.sketch_compressed_set
              else np.float64)
    # -s/-N artifacts ride the cache of one-permutation set sketches (the
    # other spaces' routes keep no k-mers); a register file without them
    # is a miss
    want_kmers = (kres == KmerSketchResultType.ONE_PERM
                  and opts.sspace == SketchSpace.SPACE_SET
                  and (opts.save_kmers or opts.save_kmercounts))
    dests = [makedest(opts, g) for g in groups]
    with span("sketch/cache-load"):
        loaded = {}
        for i, (g, dest) in enumerate(zip(groups, dests)):
            got = _load_cached(opts, g, dest, sig_dt, want_kmers)
            if got is not None:
                loaded[i] = got
    pending = [g for i, g in enumerate(groups) if i not in loaded]
    sub = _sketch_routes(opts, pending, device) if pending else None
    res = SketchingResult(names=list(groups))
    res.cardinalities = np.zeros(n, np.float64)
    if exact:
        res.kmer_sets = [None] * n
        if kres == KmerSketchResultType.FULL_MMER_COUNTDICT:
            res.kmer_set_counts = [None] * n
    elif seq:
        res.mmer_sequences = [None] * n
    else:
        res.signatures = np.zeros((n, m), sig_dt)
        if want_kmers and opts.save_kmers:
            res.kmers = np.zeros((n, m), np.uint64)
        if want_kmers and opts.save_kmercounts:
            res.kmercounts = np.zeros((n, m), np.float32)
    si = 0
    t0 = time.perf_counter()
    for i in range(n):
        if i in loaded:
            res.cardinalities[i], payload = loaded[i]
            if kres == KmerSketchResultType.FULL_MMER_COUNTDICT:
                res.kmer_sets[i], res.kmer_set_counts[i] = payload
            elif exact:
                res.kmer_sets[i] = payload
            elif seq:
                res.mmer_sequences[i] = payload
            else:
                regs, kk, cc = payload
                res.signatures[i] = regs
                if kk is not None:
                    res.kmers[i] = kk
                if cc is not None:
                    res.kmercounts[i] = cc
            continue
        res.cardinalities[i] = sub.cardinalities[si]
        if exact:
            res.kmer_sets[i] = sub.kmer_sets[si]
            if res.kmer_set_counts is not None:
                res.kmer_set_counts[i] = sub.kmer_set_counts[si]
        elif seq:
            res.mmer_sequences[i] = sub.mmer_sequences[si]
        else:
            res.signatures[i] = sub.signatures[si]
            if res.kmers is not None:
                res.kmers[i] = sub.kmers[si]
            if res.kmercounts is not None:
                res.kmercounts[i] = sub.kmercounts[si]
        si += 1
        dest = dests[i]
        try:
            if kres == KmerSketchResultType.FULL_MMER_COUNTDICT:
                kdest = makedest(opts, groups[i], iskmer=True)
                _write_kmer_set(res.kmer_sets[i], kdest,
                                res.cardinalities[i])
                res.kmer_set_counts[i].astype(np.float64).tofile(
                    _counts_dest(kdest))
            elif exact:
                _write_kmer_set(res.kmer_sets[i], dest, res.cardinalities[i])
            elif seq:
                _write_kmer_set(res.mmer_sequences[i], dest)
            else:
                formats.write_sketch_cache(dest, res.cardinalities[i],
                                           res.signatures[i])
                if res.kmers is not None:
                    res.kmers[i].tofile(dest + ".kmers.u64")
                if res.kmercounts is not None:
                    res.kmercounts[i].tofile(dest + ".kmercounts.f32")
        except OSError:
            pass
    if pending:
        add_span("sketch/cache-write", time.perf_counter() - t0)
    return res
