"""Weighted-sketch draws: each item's (hash, log-weight) stream reduced to
m registers, the winner of each register and its sample value.

Port of the JAX package's weighted engine (dashing2_tpu/sketch/weighted.py:
`_icws_rt`, `_rows_kernel`, and the host row merge of
`_sketch_many_streams`). That engine is XLA, not Pallas: a jitted scan
over 32-position chunks of (rows, 2048) row batches. Here one CUDA
kernel, csrc/weighted_draws.cu, draws and reduces a whole batch of items
in one launch; its plain PyTorch version, `weighted_draws_plain`, runs
the same arithmetic in torch on any device, and the wrapper
`weighted_draws` chooses by the tensors' device, as ops/gtlt.py does.

A draw of register j for position p of an item (hash h, f32 log-weight
w): with keyed(s) = wanghash(h ^ (j * GOLD + s)) and unit32(u) =
max(f32(u * 2^-64), 1e-30) (u64 -> f64 -> f32, rounded twice),

* ICWS (`-B`): r = -(log u1 + log u2), lnc = log(-(log u3 + log u4)),
  t = floor(w / r + beta), key = fma(-r, t - beta, lnc) - r (XLA
  contracts the product into the subtraction), and the sample value is
  keyed by (h, int32(t)); beta = f32(keyed(S5) * 2^-64) is not clamped;
* ProbMinHash (`-P`): key = -log(u1) * exp(-w), the sample value keyed
  by h alone;

with `log` and `exp` the port's fixed f32 sequences (ops/fixedmath.py),
which are XLA's CPU `jnp.log`/`jnp.exp` bit for bit. A position whose
log-weight is not finite (a weight of 0 or less, -inf) is masked as in
the JAX engine (`live = isfinite(lnw)`): it draws with w = 0 and its key
is +inf, so it never wins. A register keeps the least key. As in the JAX engine, the stream is cut into rows of
ROW_L = 2048 positions: inside a row the least order-preserving key bits
win, ties going to the first position (so -0.0 beats +0.0 there); rows
merge in order by f32 `<`, so an earlier row keeps an equal key (also
+0.0 against -0.0). The sample value is an f32 in [0, 1); an empty item
has key +inf, winner 0 and value 0, and so has an item whose every
position is masked.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import hashes as DH
from .fixedmath import exp32, fma32, log32
from .gtlt import LaunchCount

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "weighted_draws.cu")

_S1 = 0xA24BAED4963EE407
_S2 = 0x9FB21C651E98DF25
_S3 = 0xE7037ED1A0B428DB
_S4 = 0x8EBC6AF09C88C6E3
_S5 = 0x589965CC75374CC3
_SVAL = 0xC2B2AE3D27D4EB4F
_GOLD = 0x9E3779B97F4A7C15

ROW_L = 2048
KINDS = ("icws", "pmh")
_TINY = 1e-30
# (positions x registers) draws the plain version evaluates at once: on
# the card a row of 2048 positions at m = 1024; on the CPU at most 32768,
# which torch runs on one thread (see fixedmath._CPU_CHUNK)
_PLAIN_CHUNK = {"cuda": 1 << 21, "cpu": 1 << 15}

launches = LaunchCount()


def _unit32(u: torch.Tensor) -> torch.Tensor:
    return DH.u64_to_unit_float(u).to(torch.float32)


def _int32_sat(t: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA (and CUDA's __float2int_rz) convert: toward
    zero, saturating, NaN to 0."""
    big = t >= 2147483648.0
    low = t < -2147483648.0
    ti = torch.where(big | low | torch.isnan(t), torch.zeros_like(t),
                     t).to(torch.int32)
    ti = torch.where(big, torch.full_like(ti, 2147483647), ti)
    return torch.where(low, torch.full_like(ti, -2147483648), ti)


def _sval(kind: str, h: torch.Tensor, t) -> torch.Tensor:
    """The sample value of a draw: keyed by (h, int32(t)) for ICWS, by h
    for ProbMinHash."""
    if kind == "icws":
        tb = _int32_sat(t).to(torch.int64) * DH.s64(_GOLD)
        x = h ^ tb ^ DH.s64(_SVAL)
    else:
        x = h ^ DH.s64(_SVAL)
    return _unit32(DH.wanghash(x))


def _icws_rt(kind: str, h: torch.Tensor, lnw32: torch.Tensor,
             j: torch.Tensor):
    """The draw math on broadcast operands: h int64 (u64 bits), lnw32 f32
    log-weight, j int64 register term (register * GOLD). Returns (key
    f32, t f32 or None): the key (+inf where lnw32 is not finite) and,
    for ICWS, the t its sample value is keyed by."""
    live = torch.isfinite(lnw32)
    lnw32 = torch.where(live, lnw32, torch.zeros_like(lnw32))
    inf = torch.tensor(float("inf"), dtype=torch.float32,
                       device=lnw32.device)

    def keyed(salt):
        return DH.wanghash(h ^ (j + DH.s64(salt)))

    def unit(salt):
        return _unit32(keyed(salt)).clamp_(min=_TINY)

    if kind == "icws":
        r = -(log32(unit(_S1)) + log32(unit(_S2)))
        lnc = log32(-(log32(unit(_S3)) + log32(unit(_S4))))
        beta = _unit32(keyed(_S5))
        t = torch.floor(lnw32 / r + beta)
        key = fma32(-r, t - beta, lnc) - r
        return torch.where(live, key, inf), t
    u = unit(_S1)
    return torch.where(live, -log32(u) * exp32(-lnw32), inf), None


def _ordered(key: torch.Tensor) -> torch.Tensor:
    """f32 keys -> int64 holding their order-preserving u32 bits (the
    JAX engine's packing: ~bits for a set sign, bits | 2^31 else)."""
    kb = key.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(kb >> 31 != 0, kb ^ 0xFFFFFFFF, kb | 0x80000000)


def check_streams(kind: str, hashes: torch.Tensor, lnw: torch.Tensor,
                  offsets: torch.Tensor, m: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if hashes.dtype != torch.int64 or lnw.dtype != torch.float32 \
            or offsets.dtype != torch.int64:
        raise TypeError("hashes int64, lnw float32 and offsets int64 "
                        f"expected, got {hashes.dtype}, {lnw.dtype}, "
                        f"{offsets.dtype}")
    if hashes.dim() != 1 or hashes.shape != lnw.shape \
            or offsets.dim() != 1 or offsets.shape[0] < 2:
        raise ValueError("hashes and lnw must be (total,) and offsets "
                         "(items + 1,)")
    if not (hashes.is_contiguous() and lnw.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("streams must be contiguous")
    if len({hashes.device, lnw.device, offsets.device}) != 1:
        raise ValueError("streams on different devices")
    if not 1 <= m < 1 << 24:
        raise ValueError(f"m={m} out of range")


def weighted_draws_plain(kind: str, hashes: torch.Tensor,
                         lnw: torch.Tensor, offsets: torch.Tensor, m: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain PyTorch version of `weighted_draws`, on the tensors' device:
    every row of ROW_L positions of every item is drawn for all m
    registers (in chunks of at most _PLAIN_CHUNK draws), reduced to its
    least packed (key bits, position), and the rows merged in order."""
    check_streams(kind, hashes, lnw, offsets, m)
    dev = hashes.device
    off = offsets.cpu().tolist()
    n = len(off) - 1
    key = torch.full((n, m), float("inf"), dtype=torch.float32, device=dev)
    pos = torch.zeros((n, m), dtype=torch.int64, device=dev)
    j = torch.arange(m, dtype=torch.int64, device=dev) * DH.s64(_GOLD)
    for i in range(n):
        for s in range(off[i], off[i + 1], ROW_L):
            e = min(s + ROW_L, off[i + 1])
            rowbest = None
            step = max(1, _PLAIN_CHUNK.get(dev.type, 1 << 15) // m)
            for c in range(s, e, step):
                ce = min(c + step, e)
                k, _ = _icws_rt(kind, hashes[c:ce, None],
                                lnw[c:ce, None], j[None, :])
                # the key bits offset by 2^31, so that int64 order is
                # the unsigned order of the packed (bits, position)
                packed = ((_ordered(k) - (1 << 31)) << 32) | torch.arange(
                    c - off[i], ce - off[i], device=dev)[:, None]
                cmin = packed.amin(0)
                rowbest = cmin if rowbest is None else torch.minimum(
                    rowbest, cmin)
            top = (rowbest >> 32) + (1 << 31)
            kb = torch.where(top >> 31 != 0, top & 0x7FFFFFFF,
                             top ^ 0xFFFFFFFF)
            rk = kb.to(torch.int32).view(torch.float32)
            better = rk < key[i]
            key[i] = torch.where(better, rk, key[i])
            pos[i] = torch.where(better, rowbest & 0xFFFFFFFF, pos[i])
    # a register no row won (an empty item, or one whose positions are
    # all masked) keeps key +inf, winner 0 and value 0, as the JAX
    # engine's host merge leaves it
    won = key != float("inf")
    if not bool(won.any()):
        return key, pos.to(torch.int32), torch.zeros_like(key)
    start = torch.tensor(off[:-1], dtype=torch.int64, device=dev)[:, None]
    at = torch.where(won, start + pos, torch.zeros_like(pos))
    h, w = hashes[at], lnw[at]
    _, t = _icws_rt(kind, h, w, j[None, :])
    val = torch.where(won, _sval(kind, h, t), torch.zeros_like(key))
    return key, pos.to(torch.int32), val


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/weighted_draws.cu;
    raises when nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("weighted_draws", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.weighted_draws.restype = i
        lib.weighted_draws.argtypes = [i, p, p, p, i, i, p, p, p, p]
        lib._sigs_set = True
    return lib


def weighted_draws(kind: str, hashes: torch.Tensor, lnw: torch.Tensor,
                   offsets: torch.Tensor, m: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Items' streams -> (key f32, winner int32, value f32), (items, m)
    each, on the tensors' device. hashes (total,) int64 u64 bits and lnw
    (total,) f32 log-weights hold the items' streams back to back, item i
    at [offsets[i], offsets[i + 1]); the winner is a position within its
    item. The CUDA kernel for CUDA tensors (asynchronous, on the current
    stream), the plain version for CPU tensors."""
    check_streams(kind, hashes, lnw, offsets, m)
    if hashes.device.type == "cpu":
        return weighted_draws_plain(kind, hashes, lnw, offsets, m)
    if hashes.device.type != "cuda":
        raise ValueError(f"no weighted_draws for device {hashes.device}")
    n = offsets.shape[0] - 1
    if n > 65535:
        raise ValueError(f"{n} items in one launch; the grid holds 65535")
    lib = load_kernel()
    dev = hashes.device
    key = torch.empty((n, m), dtype=torch.float32, device=dev)
    win = torch.empty((n, m), dtype=torch.int32, device=dev)
    val = torch.empty((n, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.weighted_draws(
            KINDS.index(kind), hashes.data_ptr(), lnw.data_ptr(),
            offsets.data_ptr(), n, m, key.data_ptr(), win.data_ptr(),
            val.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"weighted_draws kernel launch failed: CUDA "
                           f"error {err}")
    launches.launches += 1
    return key, win, val
