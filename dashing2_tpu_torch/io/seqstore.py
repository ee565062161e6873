"""Sequence store with RAM-or-disk spill (tmpseqs.h equivalent).

Copy of dashing2_tpu/io/seqstore.py.

Reference: src/tmpseqs.h:24 (Seqs: spill sequences to a temp file, read
back through mmap windows) with automatic RAM residence below 2 Gbp
(src/fastxsketchbyseq.cpp:172-177) or when --seqs-in-ram is set. Used by
the edit-distance space, which needs raw sequences for exact alignment
after LSH candidate generation.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

RAM_THRESHOLD = 2 << 30  # 2 Gbp, fastxsketchbyseq.cpp:172-177


class SequenceStore:
    """Append-only, index-readable store of byte sequences. Stays in RAM
    until `threshold` cumulative bytes, then spills everything to an
    unlinked temp file and serves reads by seek."""

    def __init__(self, in_ram: bool = False,
                 threshold: Optional[int] = None) -> None:
        if threshold is None:
            threshold = RAM_THRESHOLD  # read at call time (testable)
        self._ram: Optional[List[bytes]] = []
        self._threshold = float("inf") if in_ram else threshold
        self._total = 0
        self._file = None
        self._offsets: List[int] = [0]

    def __len__(self) -> int:
        return (len(self._ram) if self._ram is not None
                else len(self._offsets) - 1)

    def append(self, seq: bytes) -> None:
        self._total += len(seq)
        if self._ram is not None and self._total > self._threshold:
            self._spill()
        if self._ram is not None:
            self._ram.append(seq)
        else:
            self._file.seek(0, os.SEEK_END)
            self._file.write(seq)
            self._offsets.append(self._offsets[-1] + len(seq))

    def _spill(self) -> None:
        fd, path = tempfile.mkstemp(prefix="d2tpu_seqs_", suffix=".bin")
        self._file = os.fdopen(fd, "w+b")
        os.unlink(path)
        for s in self._ram:
            self._file.write(s)
            self._offsets.append(self._offsets[-1] + len(s))
        self._ram = None

    def __getitem__(self, i: int) -> bytes:
        if self._ram is not None:
            return self._ram[i]
        lo, hi = self._offsets[i], self._offsets[i + 1]
        self._file.seek(lo)
        return self._file.read(hi - lo)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
