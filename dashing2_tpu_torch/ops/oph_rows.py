"""One-permutation registers of chunk rows: k-mer codes, minimizers,
masks and the per-item bucket-min in one pass.

Port of the JAX package's device OPH engine, the XLA function
`_fused_oph_fn` (dashing2_tpu/sketch/core.py:146): `_hash_chunk_batch`
(:59) fused with an OPH row engine (`oph_sketch_segments`,
dashing2_tpu/ops/sketch_kernels.py:57, and its dense/sort/rot twins,
which give the same bytes). That engine is XLA, not Pallas. Here one
CUDA source, csrc/oph_rows.cu, computes it for a batch of rows;
`oph_rows_plain` is its plain PyTorch version (the JAX functions
rule for rule, in torch int64 on any device: ops/kmers.py for the codes
and minimizers, a `scatter_reduce` min on sign-flipped ids, then a count
pass); the wrapper `oph_rows` chooses by the tensors' device, as
ops/omh.py does.

The kernel rolls each code along its row (a thread a run of positions,
the row staged in shared memory) and hashes the valid positions on full
warps; `rolled_codes_plain` is the plain version of that rolling, which
the CPU tests hold to ops/kmers.py's codes and the JAX package's.

What it computes, for rows of alphabet codes (INVALID = 0xFF outside a
sequence or at a non-alphabet base), each row a chunk of one item:

* per position, the k-mer code of the job's encoding (`encoding`: 2-bit
  DNA, base-b, spaced seeds, the rolling hash, or the low word of the
  128-bit code) and its validity (no INVALID in its span);
* with w > k, window minimizers (`kmers.minimizer_mask`);
* the maskfn scramble, the chunk's ownership window, the downsample
  test and the filterset probe (a sorted u64 list; a member is dropped);
* per item, register id % m = the least id = oph_hash(hashed) over its
  rows' surviving positions (2^64 - 1 where none falls), and on request
  its count, the number of those positions whose id equals it.

Rows may be split or ordered in any way among batches: a register is a
min, a count the multiplicity of the final min (the caller merges
batches as `_merge_oph` does).

`hash_rows` is the same source's second entry, the port of the XLA
engines `_hash_chunk_batch` and `_hash_chunk_batch128`
(dashing2_tpu/sketch/core.py:59, :103) as the `--seq` route calls them:
the stages above up to the masks, then each row's surviving positions'
masked tokens (with `--long-kmers`, full 128-bit keys: the masked high
word too) in position order, with the row's count of them. Its plain
versions are `hash_chunk_batch` and `hash_chunk_batch128`, compacted by
a torch mask. On the card the kernel compacts them itself: a block a
row segment writes its segment's tokens in order to a range of a slab
it reserves, with the segment's count; a second entry moves each
segment's tokens to its offset, the exclusive scan of the counts.
`window_select_plain` and `compact_plain` are the plain models of the
kernel's window stage and of that compaction, which the CPU tests hold
to `kmers.minimizer_mask`, the JAX package's and `hash_rows_plain`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import hashing as H
from ..enums import Alphabet
from . import hashes as DH
from . import kmers as K
from .gtlt import LaunchCount

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "oph_rows.cu")

DOWNSAMPLE_SALT = 0x6F22B7A19E5F3D71
U64_ALL = (1 << 64) - 1

# csrc/oph_rows.cu enum Mode (the native engine's, native/oph_sketch.cpp)
DNA, BASEB, SPACED, ROLL, DNA128 = range(5)
MAX_OFFSETS = 256            # spaced-seed offsets the kernel's Params hold
MAX_SYMBOLS = 32             # rolling-table entries the kernel's Params hold
THREADS = 128                # threads a block, csrc/oph_rows.cu
RING = 64                    # keys a warp's ring holds, csrc/oph_rows.cu
SMEM_SM = 233472             # shared memory of an SM (1 KB a block reserved)
SMEM_LIMIT = SMEM_SM - 1024  # dynamic shared memory a block may use
# blocks an SM that a staged block's geometry tries to leave room for,
# in order (experiments/torch_kernel_turns.py `hash_rows`)
SHARES = (8, 4, 2, 1)
MAX_SLOTS = 1 << 15          # staged slots a 16-bit index holds
# m up to which the bucket-min runs in a block's shared memory (both
# forms timed on the H100 by experiments/oph_rows_turns.py)
SMEM_BUCKETS_MAX_M = 8192

launches = LaunchCount()
# hash_rows: two launches a call, the tokens (C entry `hash_rows`) and
# their placement (`hash_place`); two more where the slab overflowed
hash_launches = LaunchCount()


def encoding(hkw: dict):
    """(mode, base, bits, offsets, roll_table, canon_eff): the encoding
    `_hash_chunk_batch` and `kmers.hashed_kmers` route a job to (the JAX
    package's `_native_mode`). Canonical only for DNA, and never for
    spaced seeds or base-b codes."""
    alpha = hkw["alphabet"]
    is_dna = alpha in (Alphabet.DNA, Alphabet.DNAC)
    base = K.alphabet_size(alpha)
    canon = bool(hkw["canon"])
    if hkw["use128"] and not hkw["rolling"] and not hkw["spacing_offsets"]:
        return DNA128, base, 2, None, None, canon
    if hkw["rolling"]:
        return (ROLL, base, 2, None, K._rolling_table(alpha),
                canon and is_dna)
    if hkw["spacing_offsets"]:
        bits = 2 if is_dna else max(1, (base - 1).bit_length())
        return (SPACED, base, bits,
                np.asarray(hkw["spacing_offsets"], np.int32), None, False)
    if is_dna:
        return DNA, 4, 2, None, None, canon
    return BASEB, base, 2, None, None, False


def hash_chunk_batch(codes: torch.Tensor, hkw: dict,
                     filterset: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the JAX `_hash_chunk_batch` (without --entmin):
    codes (R, L) uint8 -> (hashed int64 (R, npos), valid bool (R,
    npos)), npos = L - span + 1. `filterset`: sorted u64 bits (int64),
    or None."""
    k, w = hkw["k"], hkw["w"]
    span = hkw.get("span") or k
    if hkw["use128"] and not hkw["rolling"] and not hkw["spacing_offsets"]:
        hi, lo, valid = K.dna_kmer_codes128(codes, k, hkw["canon"])
        hashed = lo if hkw["seed_is_zero"] else DH.maskfn(lo, hkw["xormask"])
        if w > k:
            valid = K.minimizer_mask(DH.srl(hi, 1) ^ lo, valid, k, w)
    else:
        hashed, valid = K.hashed_kmers(
            codes, k, w=w, canonicalize=hkw["canon"],
            alphabet=hkw["alphabet"], xormask=hkw["xormask"],
            seed_is_zero=hkw["seed_is_zero"],
            spacing_offsets=hkw["spacing_offsets"], rolling=hkw["rolling"])
    lo, hi = K.owned_kmer_range(span, w, hkw["chunk_len"])
    pos = torch.arange(hashed.shape[-1], device=codes.device)
    valid = valid & (pos >= lo) & (pos < hi)
    ds = hkw["downsample_threshold"]
    if ds < U64_ALL:
        valid = valid & DH.u64_lt(
            DH.wanghash(hashed ^ DH.s64(DOWNSAMPLE_SALT)), ds)
    if filterset is not None and filterset.numel():
        fs = filterset ^ K.FLIP
        at = torch.searchsorted(fs, (hashed ^ K.FLIP).contiguous())
        at = at.clamp_(max=fs.numel() - 1)
        valid = valid & (fs[at] != (hashed ^ K.FLIP))
    return hashed, valid


def hash_chunk_batch128(codes: torch.Tensor, hkw: dict, xormask2_hi: int,
                        filterset: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the JAX `_hash_chunk_batch128`: codes (R, L)
    uint8 -> (hi', lo' int64 (R, npos), valid bool (R, npos)), npos =
    L - k + 1, (hi', lo') the u128 maskfn of the canonical 128-bit code
    (lo' = wanghash(lo ^ xormask), hi' = wanghash(hi ^ xormask2_hi); the
    raw code with a zero seed). Minimizers score (hi >> 1) ^ lo; the
    downsample test and the filterset probe read the masked low word."""
    k, w = hkw["k"], hkw["w"]
    hi, lo, valid = K.dna_kmer_codes128(codes, k, hkw["canon"])
    if hkw["seed_is_zero"]:
        mhi, mlo = hi, lo
    else:
        mlo = DH.maskfn(lo, hkw["xormask"])
        mhi = DH.maskfn(hi, xormask2_hi)
    if w > k:
        valid = K.minimizer_mask(DH.srl(hi, 1) ^ lo, valid, k, w)
    own_lo, own_hi = K.owned_kmer_range(k, w, hkw["chunk_len"])
    pos = torch.arange(mlo.shape[-1], device=codes.device)
    valid = valid & (pos >= own_lo) & (pos < own_hi)
    ds = hkw["downsample_threshold"]
    if ds < U64_ALL:
        valid = valid & DH.u64_lt(
            DH.wanghash(mlo ^ DH.s64(DOWNSAMPLE_SALT)), ds)
    if filterset is not None and filterset.numel():
        fs = filterset ^ K.FLIP
        at = torch.searchsorted(fs, (mlo ^ K.FLIP).contiguous())
        at = at.clamp_(max=fs.numel() - 1)
        valid = valid & (fs[at] != (mlo ^ K.FLIP))
    return mhi, mlo, valid


def _check_codes(codes: torch.Tensor,
                 filterset: Optional[torch.Tensor]) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 2 \
            or not codes.is_contiguous():
        raise ValueError("codes must be a contiguous (R, L) uint8 tensor")
    if filterset is not None and filterset.device != codes.device:
        raise ValueError("codes and filterset on different devices")
    if filterset is not None and (filterset.dtype != torch.int64
                                  or filterset.dim() != 1
                                  or not filterset.is_contiguous()):
        raise ValueError("the filterset must be a contiguous 1-d int64 "
                         "tensor of sorted u64 bits")


def check_rows(codes: torch.Tensor, row_item: torch.Tensor, n_items: int,
               m: int, filterset: Optional[torch.Tensor]) -> None:
    _check_codes(codes, filterset)
    if row_item.dtype != torch.int32 or row_item.shape != codes.shape[:1] \
            or not row_item.is_contiguous():
        raise ValueError("row_item must be a contiguous (R,) int32 tensor")
    if row_item.device != codes.device:
        raise ValueError("codes and row items on different devices")
    if not 1 <= m < 1 << 31 or n_items < 0:
        raise ValueError(f"m={m}, n_items={n_items} out of range")


def oph_rows_plain(codes: torch.Tensor, row_item: torch.Tensor,
                   n_items: int, m: int, hkw: dict,
                   filterset: Optional[torch.Tensor] = None,
                   want_counts: bool = False):
    """Plain PyTorch version of `oph_rows`, on the tensors' device: the
    JAX `_hash_chunk_batch`, then `oph_sketch_segments` as a
    scatter_reduce min over (item, bucket) segments of the sign-flipped
    ids and a count of the ids equal to their segment's min."""
    check_rows(codes, row_item, n_items, m, filterset)
    hashed, valid = hash_chunk_batch(codes, hkw, filterset)
    valid &= (row_item >= 0)[:, None]
    ids = DH.oph_hash(hashed[valid])
    item = row_item.to(torch.int64)[:, None].expand_as(valid)[valid]
    seg = item * m + DH.u64_mod(ids, m)
    regs = torch.full((n_items * m,), K.SMAX, dtype=torch.int64,
                      device=codes.device)
    regs.scatter_reduce_(0, seg, ids ^ K.FLIP, "amin")
    regs ^= K.FLIP
    counts = None
    if want_counts:
        hit = ids == regs[seg]
        counts = torch.bincount(seg[hit], minlength=n_items * m).to(
            torch.int32).view(n_items, m)
    return regs.view(n_items, m), counts


def rolled_codes_plain(codes: torch.Tensor, hkw: dict, run: int,
                       start: int = 0):
    """Plain version of csrc/oph_rows.cu's rolling, for the tests: codes
    (R, L) uint8 -> (score, key, valid) per position (int64 u64 bits,
    bool; (R, L - span + 1)), each computed as a thread of the kernel
    computes it. The positions are cut into runs of `run` from `start`
    (and a first run [0, start)); a run's first window is pushed base by
    base, then each step pushes one base, as `Roller::push` does: the
    encoding's recurrence with no branch, its validity the count of
    valid bases since the last INVALID one; an INVALID base shifts into
    the 2-bit codes as it is (its complement as 0) and resets the
    base-b and rolling ones; past a run's end INVALID is pushed. Where
    no code is valid, score 2^64 - 1 and key 0. `hkw` as for
    `oph_rows`, without minimizers (the scores feed
    `kmers.minimizer_mask`)."""
    mode, base, bits, offsets, table, canon = encoding(hkw)
    k = hkw["k"]
    span = hkw.get("span") or k
    R, L = codes.shape
    npos = L - span + 1
    dev = codes.device
    starts = ([0] if start > 0 else []) + list(range(start, npos, run))
    rs = torch.tensor(starts, dtype=torch.int64, device=dev)
    rl = torch.tensor(starts[1:] + [npos], dtype=torch.int64,
                      device=dev) - rs
    c64 = codes.to(torch.int64)
    T = (None if table is None else
         torch.from_numpy(np.asarray(table).view(np.int64)).to(dev))
    bpow = DH.s64(pow(base, k - 1, 1 << 64))

    def mask(nbits):
        return -1 if nbits >= 64 else (1 << max(nbits, 0)) - 1
    lmask, hmask = mask(2 * k), mask(2 * k - 64)
    kr = 32 if mode == DNA else 64          # bases a complement holds
    sh = 2 * (min(k, kr) - 1)               # its newest base's shift

    def at(x):          # the bases at columns x (0 outside the row)
        inside = (x >= 0) & (x < L)
        return torch.where(inside[None, :], c64[:, x.clamp(0, L - 1)], 0)

    z = torch.zeros((R, len(starts)), dtype=torch.int64, device=dev)
    v, rc, vhi, rchi, n = z, z, z, z, z

    def push(x, active):
        nonlocal v, rc, vhi, rchi, n
        c = torch.where(active[None, :], at(x), K.INVALID)
        inv = c == K.INVALID
        full = n >= k
        n = torch.where(inv, 0, n + 1)
        if mode in (DNA, DNA128):
            # INVALID shifts in as it is (its bits leave the window
            # before the count reaches k); its complement as 0
            if k <= kr:
                cr = c
            else:
                cr = torch.where(active[None, :] & (x >= k - kr)[None, :],
                                 at(x - (k - kr)), K.INVALID)
            comp = ((~cr) & 3) << (sh % 64)
            if mode == DNA:
                v = ((v << 2) | c) & lmask
                rc = DH.srl(rc, 2) | comp
            else:
                vhi = ((vhi << 2) | DH.srl(v, 62)) & hmask
                v = ((v << 2) | c) & lmask
                rc, rchi = DH.srl(rc, 2) | (rchi << 62), DH.srl(rchi, 2)
                if sh < 64:
                    rc = rc | comp
                else:
                    rchi = rchi | comp
        elif mode == BASEB:
            co = torch.where(full & active[None, :], at(x - k), 0)
            v = torch.where(inv, 0, (v - co * bpow) * base + c)
        elif mode == ROLL:
            cc = torch.where(inv, 0, c)
            co = torch.where(full & active[None, :], at(x - k), 0)
            out = torch.where(full, K._rotl64(T[co], k % 64), 0)
            v = torch.where(inv, 0, K._rotl64(v, 1) ^ T[cc] ^ out)
            if canon:
                rc = torch.where(inv, 0, K._rotl64(
                    torch.where(full, rc ^ T[3 - co], rc), 63)
                    ^ K._rotl64(T[3 - cc], (k - 1) % 64))

    score = torch.full((R, npos), -1, dtype=torch.int64, device=dev)
    key = torch.zeros((R, npos), dtype=torch.int64, device=dev)
    valid = torch.zeros((R, npos), dtype=torch.bool, device=dev)
    for j in range(span - 1):
        push(rs + j, rl > 0)
    for t in range(int(rl.max())):
        act = t < rl
        q = rs + t
        push(q + span - 1, act)
        ok = act[None, :] & (n >= span)
        if mode in (DNA, ROLL):
            kq = torch.where(DH.u64_lt(rc, v), rc, v) if canon else v
            sq = kq
        elif mode == DNA128:
            less = (DH.u64_lt(rchi, vhi) | ((rchi == vhi) & DH.u64_lt(rc, v))
                    ) if canon else torch.zeros_like(ok)
            hi, kq = torch.where(less, rchi, vhi), torch.where(less, rc, v)
            sq = DH.srl(hi, 1) ^ kq
        elif mode == BASEB:
            kq = sq = v
        else:
            kq = torch.zeros_like(v)
            for o in offsets:
                kq = (kq << bits) | at(q + int(o))
            sq = kq
        cols = q[act]
        score[:, cols] = torch.where(ok, sq, -1)[:, act]
        key[:, cols] = torch.where(ok, kq, 0)[:, act]
        valid[:, cols] = ok[:, act]
    return score, key, valid


def _u64_le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ~DH.u64_lt(b, a)


def window_select_plain(score: torch.Tensor, valid: torch.Tensor,
                        nwin: int, seg: int, own_lo: int, own_hi: int
                        ) -> torch.Tensor:
    """Plain model of csrc/oph_rows.cu's window stage, for the tests:
    score (R, npos) int64 u64 bits and valid bool -> bool (R, npos), the
    owned positions ([own_lo, own_hi)) that the minimizer rule keeps
    (before downsampling and the filterset), computed as the kernel's
    blocks compute them. The owned positions are cut into segments of
    `seg`; a segment scores its positions with h = nwin - 1 more on each
    side (the u64 max and invalid outside the row). Its windows' slots
    are cut into chunks of nwin: backwards over a chunk, each slot's
    suffix minimum with its leftmost argmin and whether the suffix is
    all valid; forwards over the next chunk, the prefix minimum; window
    j (slots [j, j + h]) is live where both parts are all valid, and its
    leftmost argmin is the suffix's where the suffix's minimum is at
    most the prefix's. Each live window's argmin is a candidate where it
    is owned, and only the candidates take the tie test: kept where no
    score in the h slots before it is equal. Without minimizers the
    valid owned positions."""
    R, npos = score.shape
    dev = score.device
    lo, hi = max(own_lo, 0), min(own_hi, npos)
    keep = torch.zeros((R, npos), dtype=torch.bool, device=dev)
    if hi <= lo:
        return keep
    if nwin <= 1:
        keep[:, lo:hi] = valid[:, lo:hi]
        return keep
    N, h = nwin, nwin - 1
    s_all = torch.where(valid, score, -1)
    rows = torch.arange(R, device=dev)[:, None]
    for p0 in range(lo, hi, seg):
        p1 = min(p0 + seg, hi)
        no = p1 - p0
        nwt = no + h                        # windows: slots [0, nwt)
        nch = -(-nwt // N)
        E = (nch + 1) * N
        pos = p0 - h + torch.arange(E, device=dev)
        inside = (pos >= 0) & (pos < min(npos, p1 + h))
        at = pos.clamp(0, npos - 1)
        sc = torch.where(inside[None], s_all[:, at], -1)
        va = inside[None] & valid[:, at]
        cur, cva = sc[:, :nch * N].view(R, nch, N), va[:, :nch * N].view(
            R, nch, N)
        nxt, nva = sc[:, N:].view(R, nch, N), va[:, N:].view(R, nch, N)
        start = torch.arange(nch, device=dev)[None, :] * N
        shape = (R, nch)
        best = torch.full(shape, -1, dtype=torch.int64, device=dev)
        bi = torch.full(shape, N - 1, dtype=torch.int64, device=dev)
        ok = torch.ones(shape, dtype=torch.bool, device=dev)
        s_idx = torch.empty((R, nch, N), dtype=torch.int64, device=dev)
        s_ok = torch.empty((R, nch, N), dtype=torch.bool, device=dev)
        for i in range(N - 1, -1, -1):      # suffix minima
            v = cur[..., i]
            take = _u64_le(v, best)         # ties: the leftmost
            best = torch.where(take, v, best)
            bi = torch.where(take, i, bi)
            ok = ok & cva[..., i]
            s_idx[..., i], s_ok[..., i] = bi, ok
        pb = torch.full(shape, -1, dtype=torch.int64, device=dev)
        pi = torch.zeros(shape, dtype=torch.int64, device=dev)
        pok = torch.ones(shape, dtype=torch.bool, device=dev)
        cand = torch.zeros((R, E), dtype=torch.bool, device=dev)
        for t in range(N):
            if t > 0:                       # the next chunk's prefix
                v = nxt[..., t - 1]
                take = DH.u64_lt(v, pb)
                pb = torch.where(take, v, pb)
                pi = torch.where(take, t - 1, pi)
                pok = pok & nva[..., t - 1]
            live = s_ok[..., t] & pok & (start + t < nwt)
            si = s_idx[..., t]
            sv = torch.gather(cur, 2, si[..., None])[..., 0]
            q = torch.where(_u64_le(sv, pb), start + si, start + N + pi)
            live &= (q >= h) & (q < h + no)
            cand[rows.expand_as(q)[live], q[live]] = True
        r_i, q_i = cand.nonzero(as_tuple=True)
        v = sc[r_i, q_i]
        dup = torch.zeros_like(r_i, dtype=torch.bool)
        for d in range(1, h + 1):           # the tie test, candidates only
            dup |= sc[r_i, q_i - d] == v
        keep[r_i[~dup], p0 + q_i[~dup] - h] = True
    return keep


def compact_plain(keep: torch.Tensor, tokens: torch.Tensor, seg: int,
                  own_lo: int, own_hi: int, order=None):
    """Plain model of hash_rows' compaction on the card, for the tests:
    keep bool and tokens int64 (R, npos) -> (the kept tokens in
    row-major order, per-row counts int64 (R,)). Each segment of `seg`
    owned positions of a row (a block) counts its kept positions and
    reserves a range of a slab from a cursor, in `order` (a permutation
    of the R x nseg segments: the order the blocks reach their atomicAdd;
    row-major where None), and writes its tokens there in position
    order; the exclusive scan of the counts in row-major order gives
    each segment's offset, where its tokens move (`hash_place`); a
    row's count is the sum of its segments'. Kept positions outside
    [own_lo, own_hi) are never seen."""
    R, npos = keep.shape
    lo, hi = max(own_lo, 0), min(own_hi, npos)
    bounds = [(p0, min(p0 + seg, hi)) for p0 in range(lo, hi, seg)]
    nseg = len(bounds)
    parts = [tokens[r, p0:p1][keep[r, p0:p1]] for r in range(R)
             for p0, p1 in bounds]
    counts = torch.tensor([len(x) for x in parts], dtype=torch.int64)
    slab = torch.empty(int(counts.sum()), dtype=torch.int64)
    starts = torch.empty_like(counts)
    cursor = 0
    for b in (range(R * nseg) if order is None else order):
        starts[b] = cursor
        slab[cursor:cursor + len(parts[b])] = parts[b]
        cursor += len(parts[b])
    offsets = torch.cumsum(counts, 0) - counts
    out = torch.empty_like(slab)
    for b in range(R * nseg):
        n, a, at = int(counts[b]), int(starts[b]), int(offsets[b])
        out[at:at + n] = slab[a:a + n]
    per_row = (counts.view(R, nseg).sum(1) if nseg
               else torch.zeros(R, dtype=torch.int64))
    return out, per_row


class Params(ctypes.Structure):
    """csrc/oph_rows.cu `Params`, field for field."""
    _fields_ = [(f, ctypes.c_int64) for f in (
                    "R", "W", "npos", "own_lo", "own_hi", "m", "fs_len",
                    "seg", "nseg")] \
        + [(f, ctypes.c_uint64) for f in (
            "xormask", "oph_xor", "ds_threshold", "ds_salt", "bpow")] \
        + [("roll", ctypes.c_uint64 * MAX_SYMBOLS)] \
        + [(f, ctypes.c_int32) for f in (
            "mode", "k", "span", "nwin", "canon", "seed_is_zero",
            "downsample", "base", "bits", "noff", "run", "smem_buckets")] \
        + [("offsets", ctypes.c_int32 * MAX_OFFSETS),
           ("xormask2_hi", ctypes.c_uint64), ("full_key", ctypes.c_int32)]


def _align16(x: int) -> int:
    return (x + 15) & ~15


def use_smem_buckets(m: int) -> bool:
    """Whether the bucket-min runs in a block's shared memory (m <=
    SMEM_BUCKETS_MAX_M) or as a read-tested global atomicMin a
    position; m = 0 for hash_rows, which has no buckets."""
    return 0 < m <= SMEM_BUCKETS_MAX_M


def smem_bytes(seg: int, span: int, nwin: int, m: int, words: int = 1,
               stream: bool = False) -> int:
    """Dynamic shared memory of a block (csrc/oph_rows.cu `layout`): the
    warps' rings, the rolling table, the warps' extents of codes, the
    block scan's words, the shared buckets; where the block stages its
    scores (minimizers, or `stream`: hash_rows) the scores of seg +
    2 (nwin - 1) slots (with `words` = 2, the 128-bit code, its keys'
    low words too), their 16-bit indices, validity and, with
    minimizers, candidate flags; and the staged codes."""
    h = nwin - 1 if nwin > 1 else 0
    staged = nwin > 1 or stream
    E = seg + 2 * h if staged else 0
    nstage = _align16((E if staged else seg) + span - 1 + 32)
    at = 8 * (THREADS // 32) * RING + 8 * MAX_SYMBOLS + 8 * (THREADS // 32) \
        + 16 + (8 * m if use_smem_buckets(m) else 0) + 8 * words * E + 2 * E
    return _align16(_align16(at) + nstage + E + (E if nwin > 1 else 0))


def run_length(n: int) -> int:
    """The least 4 * odd >= n: a thread's run of positions, so that the
    32 lanes of a warp, `run` bytes apart, read 32 distinct banks."""
    r = 4 * -(-n // 4)
    return r + 4 if (r // 4) % 2 == 0 else r


def geometry(span: int, nwin: int, m: int, words: int = 1,
             stream: bool = False) -> Tuple[int, int, int]:
    """(run, seg, shared bytes) of the kernel's blocks: the longest run
    of rolled positions a thread takes and a block's owned positions.
    oph_rows without minimizers: runs of at least span + 4 (32 to 252:
    on the H100, k = 31, 36 beat 20-28 and 68-132, whose warm-up is
    shorter but whose blocks keep fewer warps busy;
    experiments/oph_rows_turns.py) and 128 runs a segment. Where the
    block stages its scores (minimizers, and every hash_rows job,
    `stream`; `words` 2 for the 128-bit code's keys): 128 runs a block,
    the segment what they cover less the h = nwin - 1 halo slots on each
    side, the runs the longest 4 x odd from (span - 1) / 2 (a warm-up
    of at most two pushes a position) up to 4 span whose block leaves
    room for the most blocks of SHARES on its SM. On the H100 the warps
    an SM hide the rolling's latency more than long runs save warm-up
    (experiments/torch_kernel_turns.py `hash_rows`, the by-record
    corpus): -k 15 -w 31 runs of 12 or 20 (ten or six blocks an SM)
    1.74 ms, 28 (four) 1.93, 36-44 (three) 2.25-2.36, 60 (two) 3.32,
    76-100 (one) 6.10-6.35; full keys -k 40 -w 60 runs of 20 (four)
    2.58-2.60, 12 (seven, a warm-up of 39 bases) 2.88-2.89, 28 (three)
    3.91, 36 (two) 3.62, 44 (one) 6.41."""
    if nwin <= 1 and not stream:
        run = run_length(min(max(span + 4, 32), 252))
        seg = THREADS * run
        smem = smem_bytes(seg, span, nwin, m)
        if smem > SMEM_LIMIT:
            raise ValueError(f"span {span}: the kernel's staged codes do "
                             "not fit in a block's shared memory")
        return run, seg, smem
    h = nwin - 1 if nwin > 1 else 0
    longest = run_length(max(4 * span, 12))
    shortest = min(run_length(max(-(-(span - 1) // 2), 1)), longest)
    for n in SHARES:
        # alone on an SM, any run that fits
        for run in range(longest, 3 if n == 1 else shortest - 1, -8):
            seg = THREADS * run - 2 * h
            if 0 < seg and seg + 2 * h < MAX_SLOTS:
                smem = smem_bytes(seg, span, nwin, m, words, stream)
                if smem <= SMEM_SM // n - 1024:
                    return run, seg, smem
    raise ValueError(f"w: {nwin} windows of the kernel do not fit in a "
                     "block's shared memory")


def kernel_params(hkw: dict, R: int, L: int, m: int, fs_len: int,
                  seed: int = H.OPH_DEFAULT_SEED,
                  xormask2_hi: Optional[int] = None) -> Params:
    """The kernel's Params for a batch of R rows of L codes: m registers
    an item, or m = 0 for hash_rows (with `xormask2_hi`, its full
    128-bit keys)."""
    mode, base, bits, offsets, table, canon = encoding(hkw)
    k, w = hkw["k"], hkw["w"]
    span = hkw.get("span") or k
    nwin = w - k + 1 if w > k else 1
    full = xormask2_hi is not None
    run, seg, _ = geometry(span, nwin, m, 2 if mode == DNA128 else 1,
                           stream=m == 0)
    p = Params()
    lo, hi = K.owned_kmer_range(span, w, hkw["chunk_len"])
    p.R, p.W, p.npos, p.own_lo, p.own_hi = R, L, L - span + 1, lo, hi
    p.m, p.fs_len, p.seg = m, fs_len, seg
    p.xormask = hkw["xormask"] & U64_ALL
    p.oph_xor = DH.oph_xor(seed) & U64_ALL
    p.ds_threshold = hkw["downsample_threshold"] & U64_ALL
    p.ds_salt = DOWNSAMPLE_SALT
    p.bpow = pow(base, k - 1, 1 << 64)
    if table is not None:
        if len(table) > MAX_SYMBOLS:
            raise ValueError("alphabet too large for the kernel")
        for i, t in enumerate(table):
            p.roll[i] = int(t)
    if offsets is not None:
        if len(offsets) > MAX_OFFSETS:
            raise ValueError(f"{len(offsets)} spaced-seed offsets: the "
                             f"kernel takes at most {MAX_OFFSETS}")
        for i, o in enumerate(offsets):
            p.offsets[i] = int(o)
        p.noff = len(offsets)
    p.mode, p.k, p.span, p.nwin = mode, k, span, nwin
    p.canon, p.seed_is_zero = int(canon), int(hkw["seed_is_zero"])
    p.downsample = int(hkw["downsample_threshold"] < U64_ALL)
    p.base, p.bits = base, bits
    p.run, p.smem_buckets = run, int(use_smem_buckets(m))
    p.full_key = int(full)
    p.xormask2_hi = (xormask2_hi or 0) & U64_ALL
    return p


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/oph_rows.cu, with its
    `oph_rows`, `hash_rows` and `hash_place` entries; raises when nvcc is missing or
    the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("oph_rows", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p = ctypes.c_void_p
        lib.oph_rows.restype = ctypes.c_int
        lib.oph_rows.argtypes = [ctypes.POINTER(Params), p, p, p, p, p, p]
        ll = ctypes.c_longlong
        lib.hash_rows.restype = ctypes.c_int
        lib.hash_rows.argtypes = [ctypes.POINTER(Params), p, p, p, p, p, ll,
                                  p, p, p, p]
        lib.hash_place.restype = ctypes.c_int
        lib.hash_place.argtypes = [ll, p, p, p, p, p, ll, p, p, p]
        lib._sigs_set = True
    return lib


def oph_rows(codes: torch.Tensor, row_item: torch.Tensor, n_items: int,
             m: int, hkw: dict, filterset: Optional[torch.Tensor] = None,
             want_counts: bool = False):
    """Rows of codes -> (registers (n_items, m) int64 (u64 bits, 2^64 - 1
    where empty), counts (n_items, m) int32 or None), on the tensors'
    device. codes (R, L) uint8; row_item (R,) int32, the row's item in
    [0, n_items) or -1 for a row to skip; `hkw` the JAX package's
    `_hash_kwargs`; filterset sorted u64 bits (int64) or None. The CUDA
    kernel for CUDA tensors (asynchronous, on the current stream), the
    plain version for CPU tensors."""
    check_rows(codes, row_item, n_items, m, filterset)
    if codes.device.type == "cpu":
        return oph_rows_plain(codes, row_item, n_items, m, hkw, filterset,
                              want_counts)
    if codes.device.type != "cuda":
        raise ValueError(f"no oph_rows for device {codes.device}")
    dev = codes.device
    R, L = codes.shape
    fs_len = 0 if filterset is None else int(filterset.numel())
    params = kernel_params(hkw, R, L, m, fs_len)
    lib = load_kernel()
    regs = torch.full((n_items, m), -1, dtype=torch.int64, device=dev)
    counts = (torch.zeros((n_items, m), dtype=torch.int32, device=dev)
              if want_counts else None)
    with torch.cuda.device(dev):
        err = lib.oph_rows(
            ctypes.byref(params), codes.data_ptr(), row_item.data_ptr(),
            filterset.data_ptr() if fs_len else None, regs.data_ptr(),
            counts.data_ptr() if want_counts else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"oph_rows kernel launch failed: CUDA error {err}")
    launches.launches += 1
    return regs, counts


def hash_rows_plain(codes: torch.Tensor, hkw: dict,
                    filterset: Optional[torch.Tensor] = None,
                    xormask2_hi: Optional[int] = None):
    """Plain version of `hash_rows`, on the tensors' device:
    `hash_chunk_batch` (with `xormask2_hi`, `hash_chunk_batch128`), then
    the surviving tokens taken by a mask in row-major order."""
    _check_hash_rows(codes, hkw, filterset, xormask2_hi)
    if xormask2_hi is None:
        lo, valid = hash_chunk_batch(codes, hkw, filterset)
        hi = None
    else:
        hi, lo, valid = hash_chunk_batch128(codes, hkw, xormask2_hi,
                                            filterset)
    return (lo[valid], None if hi is None else hi[valid],
            valid.sum(1, dtype=torch.int64))


def _check_hash_rows(codes: torch.Tensor, hkw: dict,
                     filterset: Optional[torch.Tensor],
                     xormask2_hi: Optional[int]) -> None:
    _check_codes(codes, filterset)
    if codes.shape[1] < (hkw.get("span") or hkw["k"]):
        raise ValueError("rows shorter than the k-mer span")
    if xormask2_hi is not None and encoding(hkw)[0] != DNA128:
        raise ValueError("full 128-bit keys need the 128-bit DNA code "
                         "(--long-kmers, k <= 64, no spacing)")


def segments(p: Params) -> int:
    """Segments a row of a launch (the C entries' `nseg`): its owned
    positions cut into p.seg."""
    lo, hi = max(p.own_lo, 0), min(p.own_hi, p.npos)
    return -(-(hi - lo) // p.seg) if p.R > 0 and hi > lo else 0


def token_capacity(p: Params) -> int:
    """Tokens the slab of a hash_rows launch holds at first: every owned
    position without minimizers; with them 2.5 / (nwin + 1) of the owned
    positions (random minimizers keep about 2 / (nwin + 1) of the valid
    ones) and 4096 more, at most every owned one. A batch that keeps
    more runs again with room for all (`hash_rows`)."""
    lo, hi = max(p.own_lo, 0), min(p.own_hi, p.npos)
    owned = p.R * max(hi - lo, 0)
    if p.nwin <= 1:
        return owned
    return min(owned, 5 * owned // (2 * (p.nwin + 1)) + 4096)


def hash_rows(codes: torch.Tensor, hkw: dict,
              filterset: Optional[torch.Tensor] = None,
              xormask2_hi: Optional[int] = None):
    """Rows of codes -> (tokens (T,) int64 u64 bits, high words (T,)
    int64 or None, per-row counts (R,) int64), on the tensors' device:
    each row's owned positions that survive minimizers, downsampling and
    the filterset, their masked tokens in row-major order (the row's
    positions in order), as the JAX `_hash_chunk_batch` computes them
    and the `--seq` route keeps them; with `xormask2_hi` (the 128-bit
    DNA code only) the full keys of `_hash_chunk_batch128`, whose masked
    high words come second. codes (R, L) uint8; `hkw` the JAX package's
    `_hash_kwargs`; filterset sorted u64 bits (int64) or None. The plain
    version for CPU tensors. For CUDA tensors csrc/oph_rows.cu: the
    `hash_rows` launch writes each segment's tokens in order to a range
    of a slab of `token_capacity` tokens, with the segment's count and
    the range's start; an exclusive scan of the counts (torch) gives
    each segment's offset, and the `hash_place` launch moves the tokens
    there. One host sync: the read of the tokens' total. A batch whose
    tokens overflow the slab (the total past its capacity) runs both
    launches again with a slab of that total. Scratch: the slab and the
    output, each the capacity's tokens (two words a token for full
    keys), and three int64 a segment."""
    if codes.device.type == "cpu":
        return hash_rows_plain(codes, hkw, filterset, xormask2_hi)
    if codes.device.type != "cuda":
        raise ValueError(f"no hash_rows for device {codes.device}")
    _check_hash_rows(codes, hkw, filterset, xormask2_hi)
    dev = codes.device
    R, L = codes.shape
    full = xormask2_hi is not None
    words = 2 if full else 1
    fs_len = 0 if filterset is None else int(filterset.numel())
    params = kernel_params(hkw, R, L, 0, fs_len, xormask2_hi=xormask2_hi)
    nseg = segments(params)
    if nseg == 0:
        def none():
            return torch.empty(0, dtype=torch.int64, device=dev)
        return (none(), none() if full else None,
                torch.zeros(R, dtype=torch.int64, device=dev))
    lib = load_kernel()
    counts = torch.empty(R * nseg, dtype=torch.int64, device=dev)
    starts = torch.empty_like(counts)
    cursor = torch.empty(1, dtype=torch.int64, device=dev)
    cap = token_capacity(params)

    def ptr(t: torch.Tensor, i: int):
        return t[i].data_ptr() if i < t.shape[0] else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        while True:
            slab = torch.empty((words, cap), dtype=torch.int64, device=dev)
            err = lib.hash_rows(
                ctypes.byref(params), codes.data_ptr(), None,
                filterset.data_ptr() if fs_len else None, ptr(slab, 0),
                ptr(slab, 1), cap, counts.data_ptr(), starts.data_ptr(),
                cursor.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"hash_rows kernel launch failed: CUDA "
                                   f"error {err}")
            hash_launches.launches += 1
            offsets = torch.cumsum(counts, 0).sub_(counts)
            out = torch.empty_like(slab)
            err = lib.hash_place(
                R * nseg, counts.data_ptr(), starts.data_ptr(),
                offsets.data_ptr(), ptr(slab, 0), ptr(slab, 1), cap,
                ptr(out, 0), ptr(out, 1), stream)
            if err != 0:
                raise RuntimeError(f"hash_place kernel launch failed: CUDA "
                                   f"error {err}")
            hash_launches.launches += 1
            per_row = counts.view(R, nseg).sum(1)
            total = int(cursor)
            if total <= cap:
                break
            cap = total
            del slab, out
    return (out[0, :total], out[1, :total] if full else None, per_row)
