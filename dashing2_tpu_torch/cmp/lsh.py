"""LSH index over sketch registers (SetSketchIndex equivalent).

Copy of dashing2_tpu/cmp/lsh.py (numpy, with the port's own hashing.py):
`LSHIndex.build`, `candidate_pairs`, `intra_candidates`, `save`/`load`
(the native gzip format) and `save_ssi`/`load_ssi` (the reference's gz
layout), byte for byte and candidate for candidate the JAX package's,
in register mode and in the bottom-k mode over exact k-mer sets
(`--set`, `--countdict`; `--long-kmers` u128 keys bucket on their low
word) and minimizer sequences (`--seq`): items sharing a bottom-k hash
are candidates. Left out: the multi-host column shards (ROADMAP Queue 1
item 9) and the incremental insert/query interface, which no job
calls.

Reference: src/ssi.h:40-539. Structure kept: nLSH tables, table i groups
``nperhashes[i]`` registers per key over ``nperrows[i]`` subtables
(contiguous register groups first, pseudo-randomly sampled groups beyond
m/g — ssi.h:369-392); shape heuristics from cmp_core.cpp:757-770.

Keys for ALL items and subtables are computed as one vectorized hash
pass over the register matrix (wanghash chain instead of the reference's
CEHasher/XXH64 mixes — candidate sets are a retrieval heuristic, not an
output format). Bucket construction is sort/group on the key arrays
instead of mutex-striped hash maps. Candidate generation for
all-items-vs-all is a per-subtable self-join: items sharing a key become
candidate pairs, ranked by the number of shared buckets, scanning
most-specific tables first with a per-item cap — the vectorized
counterpart of query_candidates' early-stop walk (ssi.h:394-448).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import hashing as H

_KEYSALT = 0x94D049BB133111EB


def lsh_table_shapes(nLSH: int, m: int) -> Tuple[List[int], List[int]]:
    """nperhashes / nperrows heuristics (cmp_core.cpp:757-770)."""
    nperhashes: List[int] = []
    while len(nperhashes) < nLSH:
        i = len(nperhashes)
        nperhashes.append(1 << i if i < 3 else i * 2)
    nperrows = []
    for nh in nperhashes:
        nperrows.append(m // nh if nh <= 2 else m * 8 // nh)
    return nperhashes, nperrows


def _expand_runs(payload: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray, cap: int) -> np.ndarray:
    """All within-run (min, max) payload pairs over run-length segments
    of a sorted stream, runs truncated at `cap`, expansion grouped by
    run length (no per-bucket Python loop — SURVEY P9). Returns an
    (npairs, 2) int64 array, possibly empty. candidate_pairs keeps an
    inline variant of this loop because its per-item saturation counts
    must accumulate in the historical per-length-group order."""
    big = lens >= 2
    starts, lens = starts[big], np.minimum(lens[big], cap)
    chunks = []
    for L in np.unique(lens):
        s_l = starts[lens == L]
        x, y = np.triu_indices(int(L), k=1)
        a = payload[s_l[:, None] + x[None, :]].reshape(-1)
        b = payload[s_l[:, None] + y[None, :]].reshape(-1)
        chunks.append(np.stack([np.minimum(a, b), np.maximum(a, b)], 1))
    if not chunks:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(chunks)


def _group_indices(m: int, g: int, nsub: int, table_idx: int) -> np.ndarray:
    """(nsub, g) register indices per subtable: contiguous groups while
    they fit, then wyhash-sampled groups (ssi.h:379-392 fallback)."""
    out = np.empty((nsub, g), dtype=np.int64)
    ncontig = m // g
    for j in range(min(nsub, ncontig)):
        out[j] = np.arange(j * g, (j + 1) * g)
    for j in range(ncontig, nsub):
        seed = np.uint64((((table_idx << 32) ^ (table_idx >> 32)) | j)
                         & 0xFFFFFFFFFFFFFFFF)
        idxs = np.empty(g, dtype=np.int64)
        for r in range(g):
            seed, draw = H.wyhash64_step(seed)
            idxs[r] = int(draw % np.uint64(m))
        out[j] = idxs
    return out


def _keys_for_table(regs64: np.ndarray, gidx: np.ndarray) -> np.ndarray:
    """Vectorized subtable keys: (N, nsub) u64 from (N, m) u64 registers.

    key = fold of wanghash over the group's registers (order-sensitive).
    """
    gathered = regs64[:, gidx]               # (N, nsub, g)
    acc = np.full(gathered.shape[:2], _KEYSALT, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for r in range(gathered.shape[2]):
            acc = H.wanghash(acc ^ gathered[:, :, r])
    return acc


def registers_as_u64(data: np.ndarray) -> np.ndarray:
    """Any register representation -> u64 key source."""
    if data.dtype == np.float64:
        return data.view(np.uint64)
    return data.astype(np.uint64)




def cap_per_item(ia: np.ndarray, ib: np.ndarray, counts: np.ndarray,
                 max_per_item: int):
    """Keep each item's max_per_item highest-count pairs (deterministic
    lexsort ranking; shared by single-host and merged multi-host runs)."""
    if max_per_item <= 0 or not len(ia):
        return ia, ib, counts
    keep = np.zeros(len(ia), dtype=bool)
    for side in (ia, ib):
        order = np.lexsort((-counts, side))
        sside = side[order]
        first = np.concatenate([[True], sside[1:] != sside[:-1]])
        rank = np.arange(len(sside)) - np.maximum.accumulate(
            np.where(first, np.arange(len(sside)), 0))
        keep[order[rank < max_per_item]] = True
    return ia[keep], ib[keep], counts[keep]


@dataclasses.dataclass
class LSHIndex:
    """Precomputed keys (dense form, for all-pairs candidate generation),
    or each item's bottom-k hashes (`bottomk`, exact-set mode), or, for an
    index read by load_ssi, the reference file's bucket maps
    (`buckets`)."""

    m: int
    nperhashes: List[int]
    nperrows: List[int]
    group_indices: List[np.ndarray]
    keys: List[np.ndarray]          # per table: (N, nsub) u64
    # load_ssi buckets: per (table, subtable) dict key -> list of ids
    buckets: List[List[Dict[int, List[int]]]] = None  # type: ignore
    # bottom-k mode: per item, its u64 hashes (None in register mode)
    bottomk: Optional[List[np.ndarray]] = None

    @property
    def bottomk_mode(self) -> bool:
        return self.bottomk is not None

    @classmethod
    def build(cls, registers: np.ndarray, nLSH: int,
              bottomk: Optional[Sequence[np.ndarray]] = None
              ) -> "LSHIndex":
        """registers: (N, m) register matrix (f64 sigs or compressed
        ints); or `bottomk`, each item's u64 bottom-k hashes, for the
        exact-set index (ssi.h's bottom-k mode)."""
        if bottomk is not None:
            # u128 keys: bucket on the LOW word of the (full-128-bit
            # ordered) bottom-k keys. Candidate generation only: items
            # sharing a full key share its low word (no false negatives);
            # a low-word collision adds a spurious candidate, removed by
            # the exact refinement that follows every candidate stage
            from .. import u128 as U
            return cls(m=0, nperhashes=[], nperrows=[], group_indices=[],
                       keys=[], bottomk=[h["lo"] if U.is_u128(h) else h
                                         for h in bottomk])
        regs64 = registers_as_u64(registers)
        m = regs64.shape[1]
        nperhashes, nperrows = lsh_table_shapes(nLSH, m)
        gidx = [_group_indices(m, g, ns, i)
                for i, (g, ns) in enumerate(zip(nperhashes, nperrows))]
        keys = [_keys_for_table(regs64, gi) for gi in gidx]
        return cls(m=m, nperhashes=nperhashes, nperrows=nperrows,
                   group_indices=gidx, keys=keys)

    # ------------------------------------------------------------------
    def candidate_pairs(self, max_per_item: int,
                        bucket_cap: int = 256
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All-items candidate generation (vectorized self-join).

        Returns (ids_a, ids_b, shared_count) with a < b, ranked per item
        by shared-bucket count during selection. Buckets larger than
        bucket_cap are truncated (the reference's per-item early stop
        bounds work the same way).
        """
        if getattr(self, "_loaded_total", None) is not None:
            # load_ssi index: only the bucket maps exist (the file
            # stores no key matrices) — candidates walk them directly
            return self._candidate_pairs_from_buckets(max_per_item,
                                                      bucket_cap)
        if self.bottomk_mode:
            return self._candidate_pairs_bottomk(max_per_item, bucket_cap)
        pair_chunks = []
        N = self.keys[0].shape[0] if self.keys else 0
        # per-item saturation: once an item has gathered enough raw
        # candidates from the more-specific tables, later pairs touching
        # only saturated items are dropped — the vectorized counterpart
        # of query_candidates' early stop (ssi.h:427-445), and the thing
        # that keeps clustered corpora from emitting O(N * bucket^2) rows
        sat_at = max(max_per_item, 1) * 4 if max_per_item > 0 else None
        cand_count = np.zeros(N, np.int64)
        # most-specific table first (reference scans last table first)
        for t in range(len(self.keys) - 1, -1, -1):
            keys = self.keys[t]            # (N, nsub)
            nsub = keys.shape[1]
            for j in range(nsub):
                if sat_at is not None and (cand_count >= sat_at).all():
                    break
                col = keys[:, j]
                order = np.argsort(col, kind="stable")
                sk = col[order]
                # vectorized bucket self-join: run-length segment the
                # sorted keys, cap run lengths, and emit all
                # within-bucket pairs grouped by run length (no Python
                # per-bucket loop — SURVEY P9 sort-based construction)
                starts = np.nonzero(np.concatenate(
                    [[True], sk[1:] != sk[:-1]]))[0]
                lens = np.diff(np.concatenate([starts, [len(sk)]]))
                big = lens >= 2
                starts, lens = starts[big], np.minimum(lens[big],
                                                       bucket_cap)
                for L in np.unique(lens):
                    s_l = starts[lens == L]          # (nb,) buckets of len L
                    ii0, jj0 = np.triu_indices(int(L), k=1)
                    a = order[s_l[:, None] + ii0[None, :]].reshape(-1)
                    b = order[s_l[:, None] + jj0[None, :]].reshape(-1)
                    lo = np.minimum(a, b)
                    hi = np.maximum(a, b)
                    if sat_at is not None:
                        need = (cand_count[lo] < sat_at) | \
                               (cand_count[hi] < sat_at)
                        lo, hi = lo[need], hi[need]
                        np.add.at(cand_count, lo, 1)
                        np.add.at(cand_count, hi, 1)
                    if len(lo):
                        pair_chunks.append(np.stack([lo, hi], axis=1))
        if not pair_chunks:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        allp = np.concatenate(pair_chunks)
        N = self.keys[0].shape[0]
        codes = allp[:, 0].astype(np.int64) * N + allp[:, 1]
        uniq, counts = np.unique(codes, return_counts=True)
        ia = uniq // N
        ib = uniq % N
        return cap_per_item(ia, ib, counts, max_per_item)

    def _candidate_pairs_bottomk(self, max_per_item: int, bucket_cap: int):
        """Exact-mode candidates: items sharing bottom-k hashes
        (ssi.h:213-254), one lexsort over the concatenated (hash, owner)
        stream and a run-length bucket expansion."""
        N = len(self.bottomk)
        sizes = np.array([len(h) for h in self.bottomk], np.int64)
        z = np.zeros(0, np.int64)
        if sizes.sum() == 0:
            return z, z, z
        keys = np.concatenate([np.asarray(h, np.uint64)
                               for h in self.bottomk])
        owner = np.repeat(np.arange(N, dtype=np.int64), sizes)
        order = np.lexsort((owner, keys))
        sk, so = keys[order], owner[order]
        starts = np.nonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))[0]
        lens = np.diff(np.concatenate([starts, [len(sk)]]))
        allp = _expand_runs(so, starts, lens, bucket_cap)
        allp = allp[allp[:, 0] != allp[:, 1]]
        if not len(allp):
            return z, z, z
        codes, counts = np.unique(allp[:, 0] * N + allp[:, 1],
                                  return_counts=True)
        return cap_per_item(codes // N, codes % N, counts, max_per_item)

    def intra_candidates(self, items: np.ndarray, bucket_cap: int = 64
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate pairs WITHIN an item subset: (lo, hi) position pairs
        (lo < hi, positions into `items`) that share at least one subtable
        key. One lexsort over all (subtable, key) cells of the chunk —
        the vectorized form of inserting the chunk then querying it."""
        items = np.asarray(items, dtype=np.int64)
        C = len(items)
        if C < 2:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cols = []  # flattened (cell_id, key) streams per table
        pos = []
        keyparts = []
        base = 0
        for keys in self.keys:
            nsub = keys.shape[1]
            keyparts.append(keys[items].reshape(-1))  # ONE gather
            cols.append((np.tile(np.arange(nsub, dtype=np.int64), C)
                         + base))
            base += nsub
            pos.append(np.repeat(np.arange(C, dtype=np.int64), nsub))
        keyflat = np.concatenate(keyparts)
        cellflat = np.concatenate(cols)
        posflat = np.concatenate(pos)
        order = np.lexsort((posflat, keyflat, cellflat))
        sk = keyflat[order]
        sc = cellflat[order]
        sp = posflat[order]
        brk = np.concatenate([[True], (sk[1:] != sk[:-1])
                              | (sc[1:] != sc[:-1])])
        starts = np.nonzero(brk)[0]
        lens = np.diff(np.concatenate([starts, [len(sk)]]))
        allp = _expand_runs(sp, starts, lens, bucket_cap)
        if not len(allp):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        codes = np.unique(allp[:, 0] * C + allp[:, 1])
        return codes // C, codes % C

    # ------------------------------------------------------------------
    # (de)serialization (ssi.h:454-532 gz round-trip equivalent)
    # ------------------------------------------------------------------
    _MAGIC = b"D2TPULSH"

    def save(self, path: str) -> None:
        """Write the index to a gzip file: shape params, per-table group
        indices, and the dense key matrices; in bottom-k mode the item
        count, each item's hash count, then its hashes."""
        import gzip
        import struct
        with gzip.open(path, "wb") as f:
            f.write(self._MAGIC)
            nt = len(self.keys)
            N = self.keys[0].shape[0] if nt else 0
            if self.bottomk_mode:
                N = len(self.bottomk)
            f.write(struct.pack("<qqqq", self.m, nt, N,
                                int(self.bottomk_mode)))
            if self.bottomk_mode:
                sizes = np.array([len(h) for h in self.bottomk], np.int64)
                f.write(sizes.tobytes())
                for h in self.bottomk:
                    f.write(np.ascontiguousarray(h, np.uint64).tobytes())
                return
            for t in range(nt):
                g, ns = self.nperhashes[t], self.nperrows[t]
                f.write(struct.pack("<qq", g, ns))
                f.write(np.ascontiguousarray(
                    self.group_indices[t], dtype=np.int64).tobytes())
                f.write(np.ascontiguousarray(
                    self.keys[t], dtype=np.uint64).tobytes())

    def save_ssi(self, path: str, key_bits: int = 32,
                 id_bits: int = 32) -> None:
        """Write the index in the REFERENCE's gz layout
        (sketch::lsh::SetSketchIndex::write, ssi.h:454-484):
        total_ids u64, n_subtables u64, per-subtable map count u64,
        regs_per_reg u64 each, is_bottomk u8, is_locked u8, then per
        (subtable, map): bucket count u64 and per bucket
        (ids_count u64, key, ids...). The reference's default build
        instantiates SetSketchIndex<LSHIDType=u32, LSHIDType> —
        key_bits/id_bits=32 match it (its -DLSHIDTYPE=uint64_t build
        is 64/64). Our u64 bucket keys truncate to key_bits for the
        file: key collisions merge buckets, which only ADDS candidate
        co-membership — the same semantics the reference's 32-bit key
        space has natively. Buckets are written key-sorted (the
        reference's flat_hash_map order is arbitrary; readers don't
        depend on it)."""
        import gzip
        import struct
        kd = np.dtype(f"<u{key_bits // 8}")
        idd = np.dtype(f"<u{id_bits // 8}")
        with gzip.open(path, "wb") as f:
            if self.bottomk_mode:
                # one subtable of one map: every item's bottom-k hashes
                n = len(self.bottomk)
                f.write(struct.pack("<QQQQ", n, 1, 1, 1))
                f.write(bytes([1, 0]))
                sizes = np.array([len(h) for h in self.bottomk])
                keys = np.concatenate(
                    [np.asarray(h, np.uint64) for h in self.bottomk]
                    if n else [np.zeros(0, np.uint64)]).astype(kd)
                owner = np.repeat(np.arange(n), sizes)
                self._write_ssi_map(f, keys, owner, kd, idd)
                return
            nt = len(self.keys)
            n = self.keys[0].shape[0] if nt else 0
            f.write(struct.pack("<QQ", n, nt))
            for t in range(nt):
                f.write(struct.pack("<Q", self.keys[t].shape[1]))
            for t in range(nt):
                f.write(struct.pack("<Q", self.nperhashes[t]))
            f.write(bytes([0, 0]))
            owner = np.arange(n)
            for t in range(nt):
                for j in range(self.keys[t].shape[1]):
                    self._write_ssi_map(
                        f, self.keys[t][:, j].astype(kd), owner, kd,
                        idd)

    @staticmethod
    def _write_ssi_map(f, keys: np.ndarray, owner: np.ndarray, kd, idd):
        import struct
        order = np.argsort(keys, kind="stable")
        sk, so = keys[order], owner[order]
        starts = np.nonzero(np.concatenate([[True],
                                            sk[1:] != sk[:-1]]))[0] \
            if len(sk) else np.zeros(0, np.int64)
        lens = np.diff(np.concatenate([starts, [len(sk)]])).astype(
            np.int64)
        f.write(struct.pack("<Q", len(starts)))
        for s, ln in zip(starts, lens):
            f.write(struct.pack("<Q", int(ln)))
            f.write(sk[s:s + 1].astype(kd).tobytes())
            f.write(so[s:s + ln].astype(idd).tobytes())

    @classmethod
    def load_ssi(cls, path: str, key_bits: int = 32,
                 id_bits: int = 32) -> "LSHIndex":
        """Read the reference gz layout (SetSketchIndex(gzFile),
        ssi.h:485-532) into a buckets-backed index: candidate
        generation walks the loaded maps directly
        (_candidate_pairs_from_buckets); the dense key matrices cannot
        be reconstructed (the file stores only buckets), so the
        key-matrix self-join path is unavailable on a loaded index."""
        import gzip
        import struct
        kd = np.dtype(f"<u{key_bits // 8}")
        idd = np.dtype(f"<u{id_bits // 8}")
        ksz, isz = kd.itemsize, idd.itemsize
        with gzip.open(path, "rb") as f:
            total_ids, nms = struct.unpack("<QQ", f.read(16))
            map_counts = [struct.unpack("<Q", f.read(8))[0]
                          for _ in range(nms)]
            rpr = [struct.unpack("<Q", f.read(8))[0]
                   for _ in range(nms)]
            ibk, _locked = f.read(1)[0], f.read(1)[0]
            buckets = []
            for t in range(nms):
                tmaps = []
                for _j in range(map_counts[t]):
                    sz = struct.unpack("<Q", f.read(8))[0]
                    mp = {}
                    for _k in range(sz):
                        psz = struct.unpack("<Q", f.read(8))[0]
                        key = int(np.frombuffer(f.read(ksz), kd)[0])
                        ids = np.frombuffer(f.read(isz * psz), idd
                                            ).astype(np.int64)
                        mp[key] = ids.tolist()
                    tmaps.append(mp)
                buckets.append(tmaps)
        # a bottom-k index's candidates come from its one map, too
        idx = cls(m=0, nperhashes=list(rpr),
                  nperrows=list(map_counts), group_indices=[],
                  keys=[], buckets=buckets, bottomk=[] if ibk else None)
        idx._loaded_total = total_ids
        return idx

    def _candidate_pairs_from_buckets(self, max_per_item: int,
                                      bucket_cap: int = 256):
        """Candidate generation over loaded bucket maps (load_ssi):
        same (ids_a, ids_b, shared_count) contract and ranking as
        candidate_pairs — co-membership counted over every (subtable,
        map) bucket, runs capped at bucket_cap."""
        n = int(getattr(self, "_loaded_total", 0))
        members = []
        starts = []
        lens = []
        off = 0
        for tmaps in self.buckets or []:
            for mp in tmaps:
                for ids in mp.values():
                    if len(ids) >= 2:
                        members.append(np.asarray(ids, np.int64))
                        starts.append(off)
                        lens.append(len(ids))
                        off += len(ids)
        if not members:
            z = np.zeros(0, np.int64)
            return z, z, z
        payload = np.concatenate(members)
        allp = _expand_runs(payload, np.asarray(starts, np.int64),
                            np.asarray(lens, np.int64), bucket_cap)
        allp = allp[allp[:, 0] != allp[:, 1]]
        if not len(allp):
            z = np.zeros(0, np.int64)
            return z, z, z
        n = max(n, int(allp.max()) + 1)
        codes, counts = np.unique(allp[:, 0] * n + allp[:, 1],
                                  return_counts=True)
        ia, ib = codes // n, codes % n
        return cap_per_item(ia, ib, counts, max_per_item)

    @classmethod
    def load(cls, path: str) -> "LSHIndex":
        import gzip
        import struct
        with gzip.open(path, "rb") as f:
            if f.read(8) != cls._MAGIC:
                raise ValueError(f"{path}: not a dashing2-tpu LSH index")
            m, nt, N, bk = struct.unpack("<qqqq", f.read(32))
            if bk:
                sizes = np.frombuffer(f.read(8 * N), np.int64)
                bottomk = [np.frombuffer(f.read(8 * int(s)), np.uint64
                                         ).copy() for s in sizes]
                return cls(m=m, nperhashes=[], nperrows=[],
                           group_indices=[], keys=[], bottomk=bottomk)
            nperhashes, nperrows, gidx, keys = [], [], [], []
            for _ in range(nt):
                g, ns = struct.unpack("<qq", f.read(16))
                nperhashes.append(g)
                nperrows.append(ns)
                gidx.append(np.frombuffer(f.read(8 * ns * g), np.int64
                                          ).reshape(ns, g).copy())
                keys.append(np.frombuffer(f.read(8 * N * ns), np.uint64
                                          ).reshape(N, ns).copy())
        return cls(m=m, nperhashes=nperhashes, nperrows=nperrows,
                   group_indices=gidx, keys=keys)


def default_candidates(nitems: int, maxcand_global: int = -1) -> int:
    """dedup_core.cpp:16-23 heuristics."""
    if maxcand_global > 0:
        return maxcand_global
    if nitems <= 10000:
        return max(nitems // 50, int(np.ceil(np.sqrt(nitems))), 3)
    if nitems <= 1000000:
        return int(np.ceil(np.cbrt(nitems)))
    return int(np.ceil(np.log(nitems) ** 3))
