"""BigWig reader (replaces the libBigWig C dependency).

Copy of dashing2_tpu/io/bigwig.py (numpy, zlib and the standard library
only). Implements what bwsketch needs (reference call sites:
src/bwsketch.cpp:61-119): the chromosome list and iteration over data
intervals (start, end, value), whole-file or per chromosome. Parses the
kent BigWig format directly: header (magic 0x888FFC26), chrom B+ tree,
and the main data section's R-tree leaves -> zlib-compressed blocks of
bedGraph/varStep/fixedStep items.

Streaming and vectorized: the file is memory-mapped (RSS grows only with
touched pages), block payloads are decompressed one at a time, and item
decoding is np.frombuffer over the whole block, so multi-GB BigWigs
sketch under an O(block) memory envelope; per-chromosome iteration
filters R-tree leaves by chrom-id range exactly like libBigWig's overlap
queries (bwsketch.cpp:61-119 walks chroms one at a time).
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0

# R-tree leaf entry: (start_chrom, start_base, end_chrom, end_base,
# data offset, data size)
_Leaf = Tuple[int, int, int, int, int, int]


class BigWigReader:
    """Streaming random-access BigWig: header + chrom tree + R-tree leaf
    index parsed up front (small), data blocks decoded on demand."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._data = mmap.mmap(self._f.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except (ValueError, OSError):   # zero-length or unmappable
            self._data = self._f.read()
        data = self._data
        magic = struct.unpack_from("<I", data, 0)[0]
        if magic == BIGWIG_MAGIC:
            self.bo = "<"
        elif struct.unpack_from(">I", data, 0)[0] == BIGWIG_MAGIC:
            self.bo = ">"
        else:
            raise ValueError(f"{path}: not a BigWig file")
        (magic, self.version, _zoom, chrom_tree_off, _full_data_off,
         full_index_off, _fc, _dfc, _asql, _tso,
         self.uncompress_buf_size, _res) = struct.unpack_from(
            self.bo + "IHHQQQHHQQIQ", data, 0)
        self.chroms, self.chrom_sizes = _read_chrom_tree(
            data, chrom_tree_off, self.bo)
        self.leaves: List[_Leaf] = _rtree_leaves(data, full_index_off,
                                                 self.bo)

    def close(self):
        if getattr(self, "_data", None) is not None:
            if isinstance(self._data, mmap.mmap):
                self._data.close()
            self._data = None
        if getattr(self, "_f", None) is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def iter_blocks(self, chrom_id: Optional[int] = None
                    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray,
                                        np.ndarray]]:
        """Yield (chrom_id, starts u32, ends u32, values f32) per data
        block, in file order. chrom_id filters to leaves overlapping
        that chromosome (libBigWig per-chrom query semantics); each
        block carries a single chromosome in its header."""
        fd = self._f.fileno() if self._f is not None else None
        for (sc, _ss, ec, _ee, off, size) in self.leaves:
            if chrom_id is not None and not (sc <= chrom_id <= ec):
                continue
            # pread, not the mmap: block payloads are the bulk of the
            # file, and resident mmap pages would grow max-RSS with
            # corpus size; pread keeps the envelope O(block) (the
            # kernel page cache still amortizes repeat reads)
            raw = (os.pread(fd, size, off) if fd is not None
                   else self._data[off:off + size])
            if self.uncompress_buf_size > 0:
                raw = zlib.decompress(raw)
            out = _decode_block(raw, self.bo)
            if out is None:
                continue
            cid, starts, ends, vals = out
            if chrom_id is not None and cid != chrom_id:
                continue
            yield cid, starts, ends, vals


def _decode_block(raw: bytes, bo: str
                  ) -> Optional[Tuple[int, np.ndarray, np.ndarray,
                                      np.ndarray]]:
    """One decompressed data block -> (chrom_id, starts, ends, values),
    decoded with np.frombuffer (no per-item struct.unpack)."""
    (chrom_id, start, _end, step, span, btype, _res, count) = \
        struct.unpack_from(bo + "IIIIIBBH", raw, 0)
    if count == 0:
        z = np.zeros(0, np.uint32)
        return chrom_id, z, z, np.zeros(0, np.float32)
    e = bo if bo == ">" else "<"
    if btype == 1:      # bedGraph
        rec = np.frombuffer(raw, dtype=np.dtype(
            [("s", e + "u4"), ("e", e + "u4"), ("v", e + "f4")]),
            count=count, offset=24)
        return chrom_id, rec["s"], rec["e"], rec["v"]
    if btype == 2:      # variable step
        rec = np.frombuffer(raw, dtype=np.dtype(
            [("s", e + "u4"), ("v", e + "f4")]), count=count, offset=24)
        starts = rec["s"]
        return chrom_id, starts, starts + np.uint32(span), rec["v"]
    if btype == 3:      # fixed step
        vals = np.frombuffer(raw, dtype=e + "f4", count=count,
                             offset=24)
        starts = (np.uint32(start)
                  + np.arange(count, dtype=np.uint32) * np.uint32(step))
        return chrom_id, starts, starts + np.uint32(span), vals
    return None


def _read_chrom_tree(data, off: int, bo: str):
    magic, block_size, key_size, val_size, item_count, _res = \
        struct.unpack_from(bo + "IIIIQQ", data, off)
    if magic != CHROM_TREE_MAGIC:
        raise ValueError("bad chrom B+ tree magic")
    chroms: Dict[int, str] = {}
    sizes: Dict[str, int] = {}

    def node(noff: int):
        isleaf, _pad, count = struct.unpack_from(bo + "BBH", data, noff)
        p = noff + 4
        if isleaf:
            for _ in range(count):
                key = bytes(data[p:p + key_size]).split(b"\0")[0].decode()
                cid, csize = struct.unpack_from(bo + "II", data,
                                                p + key_size)
                chroms[cid] = key
                sizes[key] = csize
                p += key_size + val_size
        else:
            for _ in range(count):
                child = struct.unpack_from(bo + "Q", data,
                                           p + key_size)[0]
                node(child)
                p += key_size + 8
    node(off + 32)
    return chroms, sizes


def _rtree_leaves(data, off: int, bo: str) -> List[_Leaf]:
    magic = struct.unpack_from(bo + "I", data, off)[0]
    if magic != RTREE_MAGIC:
        raise ValueError("bad R tree magic")
    leaves: List[_Leaf] = []

    def node(noff: int):
        isleaf, _pad, count = struct.unpack_from(bo + "BBH", data, noff)
        p = noff + 4
        if isleaf:
            for _ in range(count):
                leaves.append(struct.unpack_from(bo + "IIIIQQ", data, p))
                p += 32
        else:
            for _ in range(count):
                child = struct.unpack_from(bo + "IIIIQ", data, p)[4]
                node(child)
                p += 24
    node(off + 48)
    return leaves
