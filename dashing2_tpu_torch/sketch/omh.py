"""OrderMinHash: LSH sketches for edit distance over sequences.

Port of dashing2_tpu/sketch/omh.py (the edit-distance space, `-E`):
`omh_sketch_many` (its constants are in ops/omh.py); the k-mers
(ops/kmers.py `dna_kmer_codes`) and their occurrence ranks
(`occurrence_ranks`, the JAX `_occurrence_ranks` of every sequence at
once) are computed in torch on the sketch's device, the registers in
ops/omh.py (csrc/omh.cu on the card, its plain version on the CPU).
Each of the m registers selects the ell (default 2) k-mer occurrences
with the smallest register-keyed hashes of (k-mer, occurrence index),
then hashes them in sequence order (Marcais, DeBlasio, Pandey,
Kingsford 2019, "Locality-sensitive hashing for the edit distance");
ops/omh.py states the rule to the bit.

The JAX package pads each sequence's positions to a power-of-two bucket
and stacks a bucket into one vmapped call; the padding only adds invalid
positions, which never win, so here a batch is ragged: the sequences'
positions back to back with their offsets.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import kmers as K
from ..ops import omh as OP

# positions in one call of omh_registers, and the scratch it may hold
# (pieces x ell x m x 16 bytes)
BATCH_POSITIONS = 1 << 25
BATCH_SCRATCH = 1 << 30


def stream_offsets(lens: Sequence[int], k: int) -> np.ndarray:
    """(n + 1,) int64 host offsets of the sequences' windows, back to
    back (none for a sequence shorter than k)."""
    npos = np.maximum(np.asarray(lens, np.int64) - k + 1, 0)
    offsets = np.zeros(len(npos) + 1, np.int64)
    np.cumsum(npos, out=offsets[1:])
    return offsets


def _streams(codes_list: Sequence[np.ndarray], k: int, dev: torch.device):
    """(kmers int64, occ int64, valid bool, offsets int64) on `dev` of the
    sequences, back to back: every sequence's windows from one
    dna_kmer_codes pass over their concatenated codes (a window is taken
    only inside its sequence), and their occurrence ranks."""
    lens = np.array([len(c) for c in codes_list], np.int64)
    offsets = stream_offsets(lens, k)
    npos = np.diff(offsets)
    cstart = np.concatenate([[0], np.cumsum(lens)[:-1]])
    codes = torch.from_numpy(np.concatenate(
        [np.asarray(c, np.uint8) for c in codes_list])).to(dev)
    km_all, va_all = K.dna_kmer_codes(codes, k)
    at = torch.from_numpy(np.repeat(cstart - offsets[:-1], npos)).to(dev) \
        + torch.arange(int(offsets[-1]), device=dev)
    kmers, valid = km_all[at], va_all[at]
    offsets_t = torch.from_numpy(offsets).to(dev)
    occ = occurrence_ranks(torch.where(valid, kmers, 0), offsets_t,
                           torch.from_numpy(npos).to(dev))
    return kmers, occ, valid, offsets_t


def occurrence_ranks(vals: torch.Tensor, offsets: torch.Tensor,
                     sizes: torch.Tensor) -> torch.Tensor:
    """occ[p] = the number of earlier positions of p's sequence with the
    same value (the JAX package's `_occurrence_ranks`, which the JAX
    engine takes over np.where(valid, kmers, 0): an invalid window counts
    as k-mer 0), for every sequence at once, sequence i at
    [offsets[i], offsets[i + 1]) (sizes its lengths): a stable sort by
    value, then a stable sort by sequence, puts each (sequence, value)
    group in position order."""
    dev = vals.device
    item = torch.repeat_interleave(
        torch.arange(len(sizes), device=dev), sizes)
    o1 = torch.sort(vals, stable=True).indices
    order = o1[torch.sort(item[o1], stable=True).indices]
    sv, si = vals[order], item[order]
    idx = torch.arange(len(vals), device=dev)
    heads = torch.ones_like(idx, dtype=torch.bool)
    heads[1:] = (sv[1:] != sv[:-1]) | (si[1:] != si[:-1])
    start = torch.cummax(torch.where(heads, idx, 0), 0).values
    occ = torch.empty_like(idx)
    occ[order] = idx - start
    return occ


def _batches(lens: List[int], k: int, m: int, ell: int):
    """Consecutive index ranges of the sequences long enough to sketch,
    each within BATCH_POSITIONS positions and BATCH_SCRATCH bytes of
    piece scratch (a longer sequence goes alone)."""
    cur: List[int] = []
    pos = scratch = 0
    for i, n in enumerate(lens):
        if n < k:
            continue
        p = n - k + 1
        s = -(-p // OP.PIECE) * ell * m * 16
        if cur and (pos + p > BATCH_POSITIONS
                    or scratch + s > BATCH_SCRATCH):
            yield cur
            cur, pos, scratch = [], 0, 0
        cur.append(i)
        pos += p
        scratch += s
    if cur:
        yield cur


def omh_sketch_many(codes_list: Sequence[np.ndarray], k: int, m: int,
                    ell: int = 2, device="cpu") -> np.ndarray:
    """(len(codes_list), m) u64 signatures (no canonicalization: edit
    distance is strand-specific); a sequence shorter than k has an
    all-zero row. The registers are computed on `device` (a torch.device
    or its name), in ragged batches."""
    dev = torch.device(device)
    out = np.zeros((len(codes_list), m), dtype=np.uint64)
    for grp in _batches([len(c) for c in codes_list], k, m, ell):
        codes = [codes_list[i] for i in grp]
        pieces = OP.piece_table(stream_offsets(
            [len(c) for c in codes], k), dev) if dev.type == "cuda" else None
        sig = OP.omh_registers(*_streams(codes, k, dev), m, ell,
                               pieces=pieces)
        out[np.asarray(grp)] = sig.cpu().numpy().view(np.uint64)
    return out
