"""Sketch orchestration: FASTA/FASTQ files -> SketchingResult.

Port of two routes of dashing2_tpu/sketch/core.py behind a
`sketch_fastx` entry:

* the native file driver (`_native_oph_supported`, `_native_mode`,
  `_hash_kwargs`, `_finalize_one_perm`, `_try_native_files`) for
  one-permutation jobs: the C++ engine (oph_sketch.cpp
  `oph_sketch_files`) reads, encodes, hashes and bucket-mins whole path
  groups on host cores (with -s/-N the registers' k-mer ids and
  multiplicities too, which only these jobs have);
* the generic route's counting stream for the jobs the file driver
  declines, FullSetSketch (--full-setsketch, with --setsketch-ab or
  --fastcmp-bytes/-shorts/-words quantised on the host),
  --count-threshold > 1, the weighted sketches (-B, -P) and the exact
  k-mer sets (--set) and count dictionaries (--countdict): `_load_items`
  reads each group (the native reader, or the Python parser for
  .xz/.bz2), `_native_hash_codes_list` hashes it (oph_sketch.cpp
  `hash_rows_native`), np.unique counts it (a CountSketch with -c in
  the weighted spaces; in a pool with -p > 1); then
  ops/sketch_kernels.py::css_sketch_many draws the CSetSketch
  registers on the card, sketch/weighted.py the weighted ones
  (csrc/weighted_draws.cu), or the distinct hashes (and their counts)
  are the result;
* the edit-distance space (-E, with or without --parse-by-seq):
  `_load_raw` reads each record with the Python parser, keeps its raw
  bytes in an io/seqstore.py SequenceStore (the JAX `_load_items`), and
  sketch/omh.py draws the OrderMinHash registers (csrc/omh.cu on the
  card), the base count as the cardinality (the JAX
  `_sketch_fastx_core` branch, dashing2_tpu/sketch/core.py:1047-1059).

Every other configuration raises NotImplementedError naming the
ROADMAP Queue 1 item that ports it (`_unsupported`).
"""

from __future__ import annotations

import ctypes
import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np

from .. import hashing as H
from ..config import Dashing2Options
from ..device import resolve
from ..enums import Alphabet, KmerSketchResultType, SketchSpace
from ..io import fastx, mmvec
from ..ops import kmers as K
from ..ops import sketch_kernels as SK
from ..result import SketchingResult
from ..timing import add_span, span

DOWNSAMPLE_SALT = 0x6F22B7A19E5F3D71
T = TypeVar("T")
U64MAX = SK.U64MAX


def _native_oph_supported(hkw: dict) -> bool:
    """Config coverage of the native host OPH sketcher: every sketch
    config except --entmin (whose entropy scores go through log2 and
    division, not bit-reproducible between libms)."""
    if hkw["entmin"]:
        return False
    if hkw["rolling"] or hkw["spacing_offsets"]:
        return True
    if hkw["use128"]:
        return 1 <= hkw["k"] <= 63
    if hkw["alphabet"] in (Alphabet.DNA, Alphabet.DNAC):
        return 1 <= hkw["k"] <= 32
    # base-b exact coding: non-rolling implies k is within the
    # alphabet's 64-bit capacity (config.use_rolling_hash)
    return hkw["k"] >= 1


# native/oph_sketch.cpp enum Mode
_NAT_DNA, _NAT_BASEB, _NAT_SPACED, _NAT_ROLL, _NAT_DNA128 = range(5)


def _native_mode(hkw: dict):
    """(mode, base, bits, offsets, roll_table, canon_eff): the native
    engine's encoding selection, mirroring the JAX package's k-mer
    routing exactly."""
    alpha = hkw["alphabet"]
    is_dna = alpha in (Alphabet.DNA, Alphabet.DNAC)
    base = K.alphabet_size(alpha)
    canon = bool(hkw["canon"])
    if hkw["use128"] and not hkw["rolling"] and not hkw["spacing_offsets"]:
        return _NAT_DNA128, base, 2, None, None, canon
    if hkw["rolling"]:
        # canonical only for DNA (kmers.rolling_hash_codes)
        return (_NAT_ROLL, base, 2, None,
                K._rolling_table(alpha), canon and is_dna)
    if hkw["spacing_offsets"]:
        bits = 2 if is_dna else max(1, (base - 1).bit_length())
        return (_NAT_SPACED, base, bits,
                np.asarray(hkw["spacing_offsets"], np.int32), None, False)
    if is_dna:
        return _NAT_DNA, 4, 2, None, None, canon
    return _NAT_BASEB, base, 2, None, None, False


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


# configurations neither route covers: the reason, and the ROADMAP Queue 1
# item that ports it
def _unsupported(opts: Dashing2Options, groups: Sequence[str]) -> List[str]:
    """Reasons the port cannot sketch this job (empty if it can)."""
    why = []
    hkw = _hash_kwargs(opts, 1 << 15)
    edit = opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE
    if opts.by_chrom or (opts.parse_by_seq and not edit):
        why.append("--parse-by-seq/--by-chrom (item 7)")
    if opts.kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
        why.append("--seq (item 8)")
    if _exact_sets(opts) and hkw["use128"] and not hkw["rolling"] \
            and not hkw["spacing_offsets"]:
        why.append("--long-kmers exact sets, u128 keys (item 8)")
    if opts.entmin:
        why.append("--entmin (item 7)")
    if opts.filterset_path:
        why.append("--filterset (item 7)")
    if opts.cache_sketches:
        why.append("--cache (item 6)")
    if why or edit:
        # the edit-distance space encodes in numpy at any k and reads
        # every input with the Python parser
        return why
    if not _native_oph_supported(hkw):
        why.append(f"k={opts.k} with this alphabet (item 7)")
    if not _counting_route(opts) and any(
            p.endswith((".xz", ".bz2")) for g in groups for p in g.split()):
        # the JAX package sketches them on its chunked device engines
        why.append(".xz/.bz2 inputs of a one-permutation job (item 7)")
    return why


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
    (d2.h:52-71). One-permutation jobs run the native file driver;
    FullSetSketch, --count-threshold > 1 and -B/-P the counting route,
    whose CSetSketch or weighted draws run on `device` (a CUDA request
    without a card raises; nothing falls back). --set and --countdict
    count on the host and touch no device. -E draws OrderMinHash
    registers on `device` (one item a record with --parse-by-seq)."""
    why = _unsupported(opts, groups)
    if why:
        raise NotImplementedError(
            "not ported: " + ", ".join(why) + " (ROADMAP Queue 1)")
    if not any(g.split() for g in groups):
        raise ValueError("no input files")
    if opts.sspace == SketchSpace.SPACE_EDIT_DISTANCE:
        return _sketch_edit(opts, groups, device)
    if _exact_sets(opts):
        return _sketch_exact(opts, groups)
    if opts.sspace in _WEIGHTED:
        return _sketch_weighted(opts, groups, device)
    if _counting_route(opts):
        return _sketch_counted(opts, groups, device)
    return _sketch_files(opts, groups)


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
    oph_xor = int(H.mt19937_64_first(H.OPH_DEFAULT_SEED)) ^ H.CEIXOR_OPH
    mode, base, bits, offsets, roll_table, canon = _native_mode(hkw)
    span_len = hkw.get("span") or hkw["k"]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    off_p, noff = i32p(), 0
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, np.int32)
        off_p, noff = offsets.ctypes.data_as(i32p), len(offsets)
    roll_p = u64p()
    if roll_table is not None:
        roll_table = np.ascontiguousarray(roll_table, np.uint64)
        roll_p = roll_table.ctypes.data_as(u64p)
    cpaths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    items32 = np.ascontiguousarray(item_of, np.int32)
    lut = K.alphabet_lut(opts.alphabet).tobytes()
    nthreads = opts.nthreads if opts.nthreads > 0 else 0
    with span("sketch/native-files"):
        rc = lib.oph_sketch_files(
            cpaths, items32.ctypes.data_as(i32p), len(paths), n, lut,
            hkw["k"], hkw["w"], int(canon), int(hkw["seed_is_zero"]),
            hkw["xormask"], oph_xor & 0xFFFFFFFFFFFFFFFF,
            int(ds), hkw["downsample_threshold"] & 0xFFFFFFFFFFFFFFFF,
            DOWNSAMPLE_SALT, m, nthreads,
            mode, base, bits, off_p, noff, roll_p, u64p(), 0,
            span_len, regs.ctypes.data_as(u64p),
            counts.ctypes.data_as(u32p) if want_counts else u32p())
    if rc < 0:
        raise OSError(f"failed to read {paths[-int(rc) - 1]}")
    res = SketchingResult(names=list(groups))
    with span("sketch/finalize"):
        return _finalize_one_perm(opts, res, regs, counts, n, m)


# ----------------------------------------------------------------------
# the counting route: hash, count, then FullSetSketch
# ----------------------------------------------------------------------

def _load_items(opts: Dashing2Options, groups: Sequence[str]
                ) -> Iterator[List[np.ndarray]]:
    """Each group's records, alphabet-encoded, read when the group is
    reached (the JAX `_load_items` and `_iter_items_lazy`, without
    --parse-by-seq and the edit-distance space, which the port does not
    run)."""
    for group in groups:
        codes = []
        with span("sketch/read"):
            for path in group.split():
                for _, c in fastx.read_encoded(path, opts.alphabet):
                    codes.append(c)
        yield codes


def _native_hash_codes_list(lib, codes_list, hkw: dict) -> np.ndarray:
    """Compact valid scrambled k-mer hashes for a list of RECORD code
    arrays, computed on host by the native engine (hash_rows_native).
    Records are padded into bucketed power-of-two rows (one record per
    row — per-record semantics identical to the chunked device path)."""
    span_len = hkw.get("span") or hkw["k"]
    ds = hkw["downsample_threshold"] < (1 << 64) - 1
    mode, base, bits, offsets, roll_table, canon = _native_mode(hkw)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    off_p, noff = i32p(), 0
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, np.int32)
        off_p, noff = offsets.ctypes.data_as(i32p), len(offsets)
    roll_p = u64p()
    if roll_table is not None:
        roll_table = np.ascontiguousarray(roll_table, np.uint64)
        roll_p = roll_table.ctypes.data_as(u64p)
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
                roll_p, u64p(), 0, span_len,
                out.ctypes.data_as(u64p))
            parts.append(out[:cnt].copy())
    if not parts:
        return np.zeros(0, np.uint64)
    return np.concatenate(parts)


def _count_one(opts: Dashing2Options, hv: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct hashes (sorted u64) and their counts (f64), those seen
    fewer than --count-threshold times dropped. With -c (--countsketch-size)
    in a weighted space, a CountSketch's (enums.h:44-57, counter.h) instead:
    bucket h % c gains +1 where h is odd and -1 where it is even; the
    items are the non-zero buckets' indices, their weights |bucket| (the
    JAX CPU route's host CountSketch; its sums of +-1 are exact in f64 in
    any order)."""
    t0 = time.perf_counter()
    if opts.cssize > 0 and opts.sspace in _WEIGHTED:
        idx = (hv % np.uint64(opts.cssize)).astype(np.int64)
        sign = np.where((hv & np.uint64(1)).astype(bool), 1.0, -1.0)
        buckets = np.bincount(idx, weights=sign, minlength=opts.cssize)
        nz = np.nonzero(buckets)[0]
        u, c = nz.astype(np.uint64), np.abs(buckets[nz])
    else:
        u, c = np.unique(hv, return_counts=True)
    if opts.count_threshold > 1:
        keep = c >= opts.count_threshold
        u, c = u[keep], c[keep]
    add_span("sketch/count", time.perf_counter() - t0)
    return u.astype(np.uint64), c.astype(np.float64)


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


def _count_stream(opts: Dashing2Options, groups: Sequence[str]
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each item's distinct hashes and their counts: native hashing item
    by item, counting in a pool of -p threads when -p > 1."""
    from ..native import load_oph_lib
    lib = load_oph_lib()
    hkw = _hash_kwargs(opts, 1 << 15)

    def calls():
        for codes in _load_items(opts, groups):
            with span("sketch/hash"):
                hv = _native_hash_codes_list(lib, codes, hkw)
            yield functools.partial(_count_one, opts, hv)
    return list(in_order(calls(), opts.nthreads, len(groups)))


def _sketch_counted(opts: Dashing2Options, groups: Sequence[str],
                    device) -> SketchingResult:
    """The JAX generic route's counting stream and FullSetSketch
    finalization (dashing2_tpu/sketch/core.py:1287-1498): each item's
    distinct hashes, CSetSketch registers (+inf written as 0) and
    m / sum(registers), an empty item's cardinality 0; with
    --setsketch-ab or --fastcmp-bytes/-shorts/-words the registers are
    quantised on the host, with the harmonic-mean cardinality."""
    n, m = len(groups), opts.sketchsize
    uniq = [u for u, _ in _count_stream(opts, groups)]
    dev = resolve(device)
    with span("sketch/css"):
        regs, _ = SK.css_sketch_many(uniq, m, dev)
    res = SketchingResult(names=list(groups))
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
    distinct sorted hashes, with their number as the cardinality;
    --countdict also keeps their counts, with their sum as the
    cardinality. An item shorter than k has an empty set."""
    counted = _count_stream(opts, groups)
    res = SketchingResult(names=list(groups))
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
    counted = _count_stream(opts, groups)
    dev = resolve(device)
    with span("sketch/weighted"):
        sigs, cards = fn([u for u, _ in counted], [c for _, c in counted],
                         opts.sketchsize, dev)
    res = SketchingResult(names=list(groups))
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
