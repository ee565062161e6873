"""SketchingResult: the container flowing from sketching to comparison.

Port of dashing2_tpu/result.py::SketchingResult, cut to the members the
port fills: names, cardinalities, signatures (f64 one-permutation or
FullSetSketch registers, or the u8/u16/u32 registers a sketch-compressed
FullSetSketch job quantised), (optionally) k-mer ids and their counts
(-s/-N of one-permutation jobs), and the exact k-mer
sets of `--set`/`--countdict` jobs (each item's distinct u64 hashes,
or with `--long-kmers` u128 keys (u128.py), sorted, with their f64
counts for a count dictionary), the minimizer sequences of `--seq`
jobs (each item's kept tokens in sequence order, u64 or u128), and the raw
sequences of an edit-distance (`-E`) job, which its exact edit
distances and `--greedy ...f` read (a list, or an io/seqstore.py
SequenceStore). The system has no
weights; the sketches are its state, and `from_reference` carries them
over from the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SketchingResult:
    names: List[str] = dataclasses.field(default_factory=list)
    cardinalities: Optional[np.ndarray] = None        # (N,) f64
    signatures: Optional[np.ndarray] = None           # (N, m) f64
    kmers: Optional[np.ndarray] = None                # (N, m) u64
    kmercounts: Optional[np.ndarray] = None           # (N, m) f32
    kmer_sets: Optional[List[np.ndarray]] = None      # N sorted u64 sets
    kmer_set_counts: Optional[List[np.ndarray]] = None  # N f64 counts
    mmer_sequences: Optional[List[np.ndarray]] = None   # N token streams
    sequences: Optional[Sequence[bytes]] = None       # N raw (-E)
    nq: int = 0  # number of query items (PANEL); stored at the tail

    @property
    def n(self) -> int:
        return len(self.names)

    def nqueries(self) -> int:
        return self.nq


def _copy(a) -> Optional[np.ndarray]:
    return None if a is None else np.array(a, copy=True)


def _copy_list(arrs) -> Optional[List[np.ndarray]]:
    return None if arrs is None else [_copy(a) for a in arrs]


def from_reference(ref) -> SketchingResult:
    """Copy a dashing2_tpu.result.SketchingResult (or anything with its
    attribute names) into the port's container: one-permutation or
    FullSetSketch signatures of any register dtype, exact k-mer sets
    and their counts, minimizer sequences, or edit-distance registers
    with their raw sequences (carried as a list of bytes), with their
    cardinalities. Arrays are copied, so the port's in-place
    densification never touches the reference's data.
    The ordered-register cache that the reference's full-register
    comparison leaves on its result (`_ordered_cache`: (regt32, bits)) is
    carried too, so both packages compare the same register bits."""
    res = SketchingResult(names=list(ref.names),
                          cardinalities=_copy(ref.cardinalities),
                          signatures=_copy(ref.signatures),
                          kmers=_copy(ref.kmers),
                          kmer_sets=_copy_list(ref.kmer_sets),
                          kmer_set_counts=_copy_list(ref.kmer_set_counts),
                          mmer_sequences=_copy_list(
                              getattr(ref, "mmer_sequences", None)),
                          nq=int(ref.nq))
    seqs = getattr(ref, "sequences", None)
    if seqs is not None:
        res.sequences = [bytes(s) for s in seqs]
    cache = getattr(ref, "_ordered_cache", None)
    if cache is not None:
        res._ordered_cache = (bool(cache[0]), _copy(cache[1]))
    return res
