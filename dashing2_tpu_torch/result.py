"""SketchingResult: the container flowing from sketching to comparison.

Port of dashing2_tpu/result.py::SketchingResult, cut to the members the
one-permutation slice fills: names, cardinalities, f64 signatures and
(optionally) k-mer ids. The system has no weights; the sketches are its
state, and `from_reference` carries them over from the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SketchingResult:
    names: List[str] = dataclasses.field(default_factory=list)
    cardinalities: Optional[np.ndarray] = None        # (N,) f64
    signatures: Optional[np.ndarray] = None           # (N, m) f64
    kmers: Optional[np.ndarray] = None                # (N, m) u64
    nq: int = 0  # number of query items (PANEL); stored at the tail

    @property
    def n(self) -> int:
        return len(self.names)

    def nqueries(self) -> int:
        return self.nq


def _copy(a) -> Optional[np.ndarray]:
    return None if a is None else np.array(a, copy=True)


def from_reference(ref) -> SketchingResult:
    """Copy a dashing2_tpu.result.SketchingResult (or anything with its
    attribute names) into the port's container. Arrays are copied, so the
    port's in-place densification never touches the reference's data."""
    return SketchingResult(names=list(ref.names),
                           cardinalities=_copy(ref.cardinalities),
                           signatures=_copy(ref.signatures),
                           kmers=_copy(ref.kmers),
                           nq=int(ref.nq))
