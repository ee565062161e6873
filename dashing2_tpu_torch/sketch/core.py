"""Sketch orchestration: FASTA/FASTQ files -> SketchingResult.

Port of the native file-driver route of dashing2_tpu/sketch/core.py:
`_native_oph_supported`, `_native_mode`, `_hash_kwargs`,
`_finalize_one_perm` and `_try_native_files`, behind a `sketch_fastx`
entry. The JAX package's C++ engine (oph_sketch.cpp `oph_sketch_files`)
reads, encodes, hashes and bucket-mins whole path groups on host cores;
its registers are bit-identical to the JAX package's device engines.

Every configuration the file driver does not cover raises
NotImplementedError instead of taking another route: --entmin,
--parse-by-seq/--by-chrom, non-ONE_PERM results, --count-threshold > 1,
.xz/.bz2 inputs, filtersets, --cache, and the k-mer artifacts
(--save-kmers/--save-kmercounts). A device sketch kernel is ROADMAP
Queue 1 item 6.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np

from .. import hashing as H
from ..config import Dashing2Options
from ..enums import Alphabet, KmerSketchResultType, SketchSpace
from ..io import mmvec
from ..ops import kmers as K
from ..ops import sketch_kernels as SK
from ..result import SketchingResult
from ..timing import span

DOWNSAMPLE_SALT = 0x6F22B7A19E5F3D71
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
                       regs, n: int, m: int) -> SketchingResult:
    """ONE_PERM finalization: cardinalities and -log signatures (in row
    blocks into a RAM-or-memmap matrix so peak temp memory stays bounded
    for huge N, mm::vector semantics)."""
    res.cardinalities = SK.oph_cardinality(regs)
    sigs = mmvec.alloc((n, m), np.float64, opts.sig_ram_limit)
    for s in range(0, n, 4096):
        sigs[s:s + 4096] = SK.oph_to_sigs(regs[s:s + 4096])
    res.signatures = sigs
    return res


def _unsupported(opts: Dashing2Options, groups: Sequence[str]) -> List[str]:
    """Reasons the file driver cannot sketch this job (empty if it can)."""
    why = []
    if opts.parse_by_seq or opts.by_chrom:
        why.append("--parse-by-seq/--by-chrom")
    if opts.sspace != SketchSpace.SPACE_SET \
            or opts.kmer_result != KmerSketchResultType.ONE_PERM:
        why.append("sketches other than one-permutation SetSketch")
    if opts.count_threshold > 1:
        why.append("--count-threshold")
    if opts.entmin:
        why.append("--entmin")
    if opts.filterset_path:
        why.append("--filterset")
    if opts.cache_sketches:
        why.append("--cache")
    if opts.save_kmers or opts.save_kmercounts:
        why.append("--save-kmers/--save-kmercounts")
    if any(p.endswith((".xz", ".bz2")) for g in groups for p in g.split()):
        why.append(".xz/.bz2 inputs")
    return why


def sketch_fastx(opts: Dashing2Options, groups: Sequence[str]
                 ) -> SketchingResult:
    """Sketch FASTA/FASTQ inputs with the native file driver. `groups`:
    one item per entry; an entry may contain several space-separated
    paths sketched jointly (d2.h:52-71)."""
    why = _unsupported(opts, groups)
    hkw = _hash_kwargs(opts, 1 << 15)
    if not why and not _native_oph_supported(hkw):
        why.append(f"k={opts.k} with this alphabet")
    if why:
        raise NotImplementedError(
            "the port sketches only what the native file driver covers; "
            "not ported: " + ", ".join(why) + " (ROADMAP Queue 1 item 6)")
    paths: List[str] = []
    item_of: List[int] = []
    for i, g in enumerate(groups):
        for p in g.split():
            paths.append(p)
            item_of.append(i)
    if not paths:
        raise ValueError("no input files")
    from ..native import load_oph_lib
    lib = load_oph_lib()

    n, m = len(groups), opts.sketchsize
    regs = mmvec.alloc((n, m), np.uint64, opts.sig_ram_limit, fill=U64MAX)
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
            span_len, regs.ctypes.data_as(u64p), u32p())
    if rc < 0:
        raise OSError(f"failed to read {paths[-int(rc) - 1]}")
    res = SketchingResult(names=list(groups))
    with span("sketch/finalize"):
        return _finalize_one_perm(opts, res, regs, n, m)
