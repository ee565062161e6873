"""Run configuration, mirroring Dashing2Options / Dashing2DistOptions.

Whole copy of dashing2_tpu/config.py (the port never imports the JAX
package).

Reference: /root/reference/src/d2.h:91-237 (Dashing2Options),
/root/reference/src/cmp_main.h:52-129 (Dashing2DistOptions + validate()).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from . import hashing
from .enums import (
    Alphabet,
    CountingType,
    DataType,
    KmerSketchResultType,
    Measure,
    OutputFormat,
    OutputKind,
    SketchSpace,
    to_suffix,
)

# Maximum k expressible exactly per alphabet in a 64-bit word
# (bonsai RHTraits; documented in options.h:484 usage text:
# "31 for DNA, 14 for --protein, 22 for --protein8, 24 for --protein6").
_NREMPER64 = {
    Alphabet.DNA: 31,       # 2 bits/base, one slot reserved for multi-kmer windows
    Alphabet.PROTEIN: 8,    # raw bytes
    Alphabet.PROTEIN20: 14,
    Alphabet.PROTEIN_3BIT: 22,
    Alphabet.PROTEIN_14: 16,
    Alphabet.PROTEIN_6: 24,
    Alphabet.DNA2: 63,
    Alphabet.DNAC: 31,
}


def nremperres64(alphabet: Alphabet) -> int:
    return _NREMPER64[alphabet]


def nremperres128(alphabet: Alphabet) -> int:
    # Twice the 64-bit capacity plus the one reserved slot recovered.
    return _NREMPER64[alphabet] * 2 + (1 if alphabet in (Alphabet.DNA, Alphabet.DNAC) else 0)


@dataclasses.dataclass
class Dashing2Options:
    """Sketching options (d2.h:91-237)."""

    k: int = 31
    w: int = -1  # window size; <= k means every k-mer is used
    alphabet: Alphabet = Alphabet.DNA
    sspace: SketchSpace = SketchSpace.SPACE_SET
    dtype: DataType = DataType.FASTX
    use128: bool = False
    spacing: str = ""
    canonicalize: bool = True
    kmer_result: KmerSketchResultType = KmerSketchResultType.ONE_PERM

    parse_by_seq: bool = False
    trim_chr: bool = True
    sketchsize: int = 1024
    count_threshold: float = 0.0
    by_chrom: bool = False
    bed_normalize: bool = False
    cssize: int = 0          # count-min sketch size; 0 = exact counting
    save_kmers: bool = False
    save_kmercounts: bool = False
    homopolymer_compress_minimizers: bool = False
    cache_sketches: bool = False
    outprefix: str = ""
    kmer_downsample_frac: float = 1.0
    seedseed: int = 0
    fd_level: float = 8.0    # bytes per register for comparisons (RegT=f64)
    truncation_method: int = 0  # <=0: setsketch quantization; >0: b-bit
    nthreads: int = 0
    compressed_a: float = -1.0
    compressed_b: float = -1.0
    fasta_dedup: bool = False
    exhaustive_dedup: bool = False
    entmin: bool = False
    filterset_path: str = ""
    verbosity: int = 0
    executor: str = "auto"   # "auto" | "device" | "host" (numpy fallback)
    # RAM budget for the signature matrix before spilling to a disk-backed
    # memmap (mm::vector threshold, mmvec.h:54; --sig-ram-limit
    # options.h:392-394). Default 20 GiB like the reference.
    sig_ram_limit: int = 20 << 30
    # Runtime analogue of the reference's RegT=float build
    # (-DSKETCH_FLOAT_TYPE=float, enums.h:14-17): full-register
    # comparisons run on f32-rounded signatures as ordered u32 bit
    # patterns (~1.4x faster compare matrices, half the compare traffic).
    regt32: bool = False
    # keep raw sequences in RAM regardless of size (--seqs-in-ram; the
    # default spills past 2 Gbp like tmpseqs.h / fastxsketchbyseq.cpp:172)
    seqs_in_ram: bool = False

    # derived
    xormask: int = hashing.XORMASK
    xormask2_hi: int = hashing.XORMASK2_HI
    sketch_compressed_set: bool = False

    def __post_init__(self):
        if self.w <= 0:
            self.w = self.k
        if self.seedseed:
            self.xormask, self.xormask2_hi = hashing.seed_mask(self.seedseed)
        if self.alphabet != Alphabet.DNA:
            self.canonicalize = False
        if self.spacing:
            self.canonicalize = False
        self.sketch_compressed_set = self.sketch_compressed()

    # ------------------------------------------------------------------
    def sketch_compressed(self) -> bool:
        return min(self.compressed_a, self.compressed_b) > 0.0

    @property
    def nremper64(self) -> int:
        return nremperres64(self.alphabet)

    @property
    def nremper128(self) -> int:
        return nremperres128(self.alphabet)

    @property
    def use_rolling_hash(self) -> bool:
        """k beyond the exact-coding capacity switches to rolling hashing."""
        limit = self.nremper128 if self.use128 else self.nremper64
        return self.k > limit or bool(self.spacing)

    @property
    def counting_type(self) -> CountingType:
        return (CountingType.COUNTMIN_COUNTING if self.cssize > 0
                else CountingType.EXACT_COUNTING)

    @property
    def one_perm(self) -> bool:
        return (self.kmer_result == KmerSketchResultType.ONE_PERM
                and self.sspace == SketchSpace.SPACE_SET)

    def suffix(self) -> str:
        return to_suffix(self.sspace, self.kmer_result, self.use128)

    def downsample_threshold(self) -> int:
        """sampler_threshold_ = ceil(2^64 * frac)  (d2.h:170-175)."""
        if self.kmer_downsample_frac >= 1.0:
            return (1 << 64) - 1
        return int(math.ceil(((1 << 64) - 1) * self.kmer_downsample_frac))

    def validate(self) -> None:
        if self.k <= 0:
            raise ValueError("k must be positive")
        if self.sketchsize <= 0:
            raise ValueError("sketchsize must be positive")
        if self.sketchsize & 1:
            # OPH requires an even m (oph.h:145-146)
            self.sketchsize += 1
        if not (0.0 <= self.kmer_downsample_frac <= 1.0):
            raise ValueError("downsample fraction must be in [0, 1]")


@dataclasses.dataclass
class Dashing2DistOptions(Dashing2Options):
    """Distance/comparison options (cmp_main.h:52-129)."""

    output_kind: OutputKind = OutputKind.SYMMETRIC_ALL_PAIRS
    output_format: OutputFormat = OutputFormat.HUMAN_READABLE
    num_neighbors: int = -1
    min_similarity: float = -1.0
    measure: Measure = Measure.SIMILARITY
    outfile_path: str = ""
    exact_kmer_dist: bool = False
    refine_exact: bool = False
    cmp_batch_size: int = 0
    nLSH: int = 2
    maxcand: int = -1
    index_save: str = ""      # write the LSH index after build (.ssi =
    index_load: str = ""      # reference gz layout, else native)

    def __post_init__(self):
        super().__post_init__()
        if self.fd_level < 0:
            self.fd_level = 8.0
        fd = self.fd_level
        if fd not in (0.5, 1.0, 2.0, 4.0, 8.0):
            raise ValueError("fd_level (--fastcmp) must be 0.5, 1, 2, 4, or 8")
        if self.kmer_result >= KmerSketchResultType.FULL_MMER_SET:
            self.exact_kmer_dist = True
        if self.nLSH < 1:
            self.nLSH = 1
        self.validate_dist()

    def validate_dist(self) -> None:
        self.validate()
        if self.num_neighbors > 0 and self.min_similarity > 0:
            raise ValueError("Pick either top-k or minimum similarity, not both")
        if self.sspace in (SketchSpace.SPACE_PSET, SketchSpace.SPACE_EDIT_DISTANCE):
            if self.measure in (Measure.INTERSECTION, Measure.UNION_SIZE):
                # cmp_main.h:105-112 — normalized sketches can't estimate sizes
                self.measure = Measure.SIMILARITY
        if self.sspace == SketchSpace.SPACE_EDIT_DISTANCE and self.measure not in (
            Measure.SIMILARITY, Measure.M_EDIT_DISTANCE
        ):
            self.measure = Measure.M_EDIT_DISTANCE
        if self.entmin and self.use128:
            # the 128-bit exact-code path has no entropy scoring; failing
            # loudly beats silently handing back lexicographic minimizers
            raise ValueError(
                "--entmin is not supported with --long-kmers (the 128-bit "
                "k-mer path selects lexicographic minimizers only)")
        if self.sketch_compressed_set:
            if self.kmer_result != KmerSketchResultType.FULL_SETSKETCH:
                raise ValueError("--setsketch-ab requires FullSetSketch")
            if self.compressed_b < 1.0:
                raise ValueError("setsketch base b must be >= 1")
            if self.compressed_a <= 0.0:
                raise ValueError("setsketch offset a must be > 0")

    @property
    def compressed_dtype(self) -> Optional[np.dtype]:
        if self.fd_level >= 8.0 and not self.sketch_compressed_set:
            return None
        return {0.5: np.dtype(np.uint8), 1.0: np.dtype(np.uint8),
                2.0: np.dtype(np.uint16), 4.0: np.dtype(np.uint32),
                8.0: np.dtype(np.uint64)}[self.fd_level]
