"""OrderMinHash registers: each sequence's k-mer stream reduced to m
registers, each the hash of the ell k-mers that register selects, taken
in sequence order.

Port of the XLA engine of the JAX package's edit-distance space,
dashing2_tpu/sketch/omh.py `_omh_registers` (a jitted scan over chunks
of 8192 positions, `lax.top_k` per chunk and a carry) and its vmapped
batch `_omh_registers_batch`. That engine is XLA, not Pallas. Here one
CUDA source, csrc/omh.cu, selects and folds a whole ragged batch of
sequences in one call; its plain PyTorch version, `omh_registers_plain`,
runs the same rule in torch int64 on any device, and the wrapper
`omh_registers` chooses by the tensors' device, as ops/gtlt.py does.

The rule, read from the JAX engine (`lax.top_k` keeps the lower index of
equal values, and its carry sits ahead of each chunk):

* position p of a sequence has the keyed word w = kmer ^ occ * G1
  (occ: the number of earlier positions with the same k-mer, an invalid
  window counting as k-mer 0) and, for register r, the key
  wanghash(w ^ (r * G2 + SALT)), a u64;
* a register keeps the ell positions of least (f64(key), position)
  among the valid windows whose key rounds to an f64 below 2^64 (the
  JAX engine ranks f64 keys, rounded to nearest, ties to even); a slot
  no such position fills is a phantom (key 2^64 - 1, position 0);
* the winners are put in position order, a phantom after a real winner
  at position 0 and before every later one (the JAX engine's stable
  argsort over a carry in key order), and folded: sig = SALT, then
  sig = wanghash(sig ^ sel ^ (e + 1) * G1) for e < ell, with sel the
  winner's k-mer, or INVALID_CODE for a phantom;
* a sequence with no position (shorter than k) has register 0.

Streams are ragged: kmers, occ and valid hold the sequences' positions
back to back, sequence i at [offsets[i], offsets[i + 1]); the JAX
engine's padding to power-of-two buckets only adds invalid positions,
which never win. A stream is selected in pieces of PIECE positions
whose ell best (f64 key, position) merge in order, earlier pieces
winning ties: the same rule.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from . import hashes as DH
from .gtlt import LaunchCount

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "omh.cu")

_G1 = 0x9E3779B97F4A7C15
_G2 = 0xC2B2AE3D27D4EB4F
_SALT = 0x165667B19E3779F9
_INVALID_CODE = 0x5851F42D4C957F2D   # fold sentinel for unfilled slots

# the bits of the f64 2^64: no key that rounds to it is selected
F_EMPTY = 0x43F0000000000000
# positions of one piece (one block of the kernel, one step of the plain
# version)
PIECE = 8192
KERNEL_ELL = 2                       # the one depth the kernel is built for
# (positions x registers) keys the plain version evaluates at once
_PLAIN_CHUNK = {"cuda": 1 << 24, "cpu": 1 << 20}

launches = LaunchCount()


def check_streams(kmers: torch.Tensor, occ: torch.Tensor,
                  valid: torch.Tensor, offsets: torch.Tensor, m: int,
                  ell: int) -> None:
    if kmers.dtype != torch.int64 or occ.dtype != torch.int64 \
            or valid.dtype != torch.bool or offsets.dtype != torch.int64:
        raise TypeError("kmers, occ and offsets int64 and valid bool "
                        f"expected, got {kmers.dtype}, {occ.dtype}, "
                        f"{valid.dtype}, {offsets.dtype}")
    if kmers.dim() != 1 or kmers.shape != occ.shape \
            or kmers.shape != valid.shape or offsets.dim() != 1 \
            or offsets.shape[0] < 2:
        raise ValueError("kmers, occ and valid must be (total,) and "
                         "offsets (items + 1,)")
    if not all(t.is_contiguous() for t in (kmers, occ, valid, offsets)):
        raise ValueError("streams must be contiguous")
    if len({kmers.device, occ.device, valid.device, offsets.device}) != 1:
        raise ValueError("streams on different devices")
    if not 1 <= m < 1 << 23:
        raise ValueError(f"m={m} out of range")
    if ell < 1:
        raise ValueError(f"ell={ell} out of range")


def _rounded_bits(key: torch.Tensor) -> torch.Tensor:
    """The bits of the u64 `key` rounded to nearest f64 (ties to even),
    as int64: the high word times 2^32 is exact, the sum with the low
    word rounds once. The bits of a non-negative f64 order as its
    value."""
    hi = DH.srl(key, 32).to(torch.float64) * 4294967296.0
    return (hi + (key & 0xFFFFFFFF).to(torch.float64)).view(torch.int64)


def _select(f: torch.Tensor, pos: torch.Tensor, ell: int):
    """The ell least (f, position) of each row of (m, c) candidates, in
    that order; f >= F_EMPTY marks an empty slot (position then 0)."""
    f = f.clone()
    big = torch.iinfo(torch.int64).max
    out_f, out_p = [], []
    for _ in range(ell):
        fmin = f.amin(1, keepdim=True)
        pmin = torch.where(f == fmin, pos, big).amin(1, keepdim=True)
        empty = fmin >= F_EMPTY
        out_f.append(torch.where(empty, F_EMPTY, fmin))
        out_p.append(torch.where(empty, 0, pmin))
        f = torch.where((f == fmin) & (pos == pmin), big, f)
    return torch.cat(out_f, 1), torch.cat(out_p, 1)


def _fold(kmers: torch.Tensor, start: int, bf: torch.Tensor,
          bp: torch.Tensor) -> torch.Tensor:
    """(m, ell) winners in (f, position) order -> (m,) registers: the
    winners in position order (a phantom after a real winner at position
    0, before every later one), folded with wanghash."""
    real = bf < F_EMPTY
    order = torch.sort(torch.where(real, 2 * bp, 1), dim=1,
                       stable=True).indices
    real = real.gather(1, order)
    bp = bp.gather(1, order)
    sel = torch.where(real, kmers[start + bp],
                      DH.s64(_INVALID_CODE))
    sig = torch.full((bf.shape[0],), DH.s64(_SALT), dtype=torch.int64,
                     device=bf.device)
    for e in range(bf.shape[1]):
        sig = DH.wanghash(sig ^ sel[:, e] ^ DH.s64((e + 1) * _G1))
    return sig


def omh_registers_plain(kmers: torch.Tensor, occ: torch.Tensor,
                        valid: torch.Tensor, offsets: torch.Tensor,
                        m: int, ell: int, piece: int = PIECE
                        ) -> torch.Tensor:
    """Plain PyTorch version of `omh_registers`, on the tensors' device:
    every item's stream in pieces of `piece` positions (each in chunks of
    at most _PLAIN_CHUNK keys), the ell best of a piece selected after
    the best carried from the earlier ones, then the fold."""
    check_streams(kmers, occ, valid, offsets, m, ell)
    dev = kmers.device
    off = offsets.cpu().tolist()
    n = len(off) - 1
    out = torch.zeros((n, m), dtype=torch.int64, device=dev)
    rk = torch.arange(m, dtype=torch.int64, device=dev) * DH.s64(_G2) \
        + DH.s64(_SALT)
    keyed = torch.where(valid, kmers ^ (occ * DH.s64(_G1)), 0)
    step = max(1, min(piece, _PLAIN_CHUNK.get(dev.type, 1 << 20) // m))
    for i in range(n):
        s, e = off[i], off[i + 1]
        if e == s:
            continue
        bf = torch.full((m, ell), F_EMPTY, dtype=torch.int64, device=dev)
        bp = torch.zeros((m, ell), dtype=torch.int64, device=dev)
        for p0 in range(s, e, piece):
            p1 = min(p0 + piece, e)
            # the piece's own best, chunk by chunk
            pf, pp = None, None
            for c in range(p0, p1, step):
                ce = min(c + step, p1)
                f = _rounded_bits(DH.wanghash(keyed[None, c:ce]
                                              ^ rk[:, None]))
                f = torch.where(valid[None, c:ce], f, F_EMPTY)
                pos = torch.arange(c - s, ce - s, device=dev).expand(m, -1)
                if pf is not None:
                    f, pos = torch.cat([pf, f], 1), torch.cat([pp, pos], 1)
                pf, pp = _select(f, pos, ell)
            # earlier pieces first: they win ties
            bf, bp = _select(torch.cat([bf, pf], 1),
                             torch.cat([bp, pp], 1), ell)
        out[i] = _fold(kmers, s, bf, bp)
    return out


def pieces(offsets: np.ndarray, piece: int = PIECE):
    """(table, piece offsets) of the kernel's pieces, from the host's
    item offsets: table (pieces, 3) int64 rows (first position, end
    position, first position within its item), item i's pieces at
    [poff[i], poff[i + 1]); an item with no position has none."""
    offsets = np.asarray(offsets, np.int64)
    sizes = np.diff(offsets)
    count = -(-sizes // piece)
    poff = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(count, out=poff[1:])
    item = np.repeat(np.arange(len(sizes)), count)
    rel = (np.arange(int(poff[-1])) - poff[item]) * piece
    beg = offsets[item] + rel
    end = np.minimum(beg + piece, offsets[item + 1])
    return np.stack([beg, end, rel], 1), poff


def piece_table(offsets: np.ndarray, device) -> tuple:
    """`pieces` of the host's item offsets, on `device`: the argument
    `pieces` of omh_registers."""
    table, poff = pieces(offsets)
    return (torch.from_numpy(table.reshape(-1)).to(device),
            torch.from_numpy(poff).to(device))


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/omh.cu; raises when
    nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("omh", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.omh_registers.restype = i
        lib.omh_registers.argtypes = [p, p, p, p, i, p, p, ctypes.c_int64,
                                      i, i, p, p, p, p]
        lib._sigs_set = True
    return lib


def omh_registers(kmers: torch.Tensor, occ: torch.Tensor,
                  valid: torch.Tensor, offsets: torch.Tensor, m: int,
                  ell: int, pieces=None) -> torch.Tensor:
    """Items' k-mer streams -> (items, m) int64 registers (u64 bits), on
    the tensors' device. kmers (total,) int64 u64 k-mer codes, occ
    (total,) int64 occurrence ranks and valid (total,) bool hold the
    items' streams back to back, item i at [offsets[i], offsets[i + 1]).
    ell must be KERNEL_ELL. The CUDA kernel for CUDA tensors
    (asynchronous, on the current stream), the plain version for CPU
    tensors. `pieces`, the kernel's `piece_table` of these offsets, lets
    a caller that holds the offsets on the host spare the wrapper their
    copy to the host (a synchronisation)."""
    check_streams(kmers, occ, valid, offsets, m, ell)
    if ell != KERNEL_ELL:
        raise ValueError(f"ell={ell}: omh_registers is built for ell = "
                         f"{KERNEL_ELL} only")
    if kmers.device.type == "cpu":
        return omh_registers_plain(kmers, occ, valid, offsets, m, ell)
    if kmers.device.type != "cuda":
        raise ValueError(f"no omh_registers for device {kmers.device}")
    n = offsets.shape[0] - 1
    dev = kmers.device
    tab, po = pieces if pieces is not None else piece_table(
        offsets.cpu().numpy(), dev)
    if po.shape != (n + 1,) or po.device != dev or tab.device != dev:
        raise ValueError("pieces do not match the offsets")
    npieces = tab.shape[0] // 3
    lib = load_kernel()
    part_f = torch.empty((max(npieces, 1), ell, m), dtype=torch.int64,
                         device=dev)
    part_p = torch.empty_like(part_f)
    sig = torch.empty((n, m), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.omh_registers(
            kmers.data_ptr(), occ.data_ptr(), valid.data_ptr(),
            offsets.data_ptr(), n, tab.data_ptr(), po.data_ptr(), npieces,
            m, ell, part_f.data_ptr(), part_p.data_ptr(), sig.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"omh kernel launch failed: CUDA error {err}")
    launches.launches += 1
    return sig
