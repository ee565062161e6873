"""The CSetSketch (FullSetSketch) pass: each item's rows, ascending in x1,
reduced to m registers, their winning rows and the item's cutoff.

Port of the JAX package's CSetSketch pass, the XLA function `_css_pass`
(dashing2_tpu/ops/sketch_kernels.py:622; its host loop `css_sketch`
:658). That engine is XLA, not Pallas. Here one CUDA source,
csrc/css.cu, draws and reduces a whole batch of items in one launch;
`css_pass_plain` is its plain PyTorch version (torch int64/f64 on any
device), and the wrapper `css_pass` chooses by the tensors' device, as
ops/weighted_draws.py does. `css_walk_plain` is the early-exit walk in
plain torch, a row at a time or, as the kernel takes it, 32 rows a step:
the tests hold it to the full pass bit for bit, and it counts the draws
the walk evaluates. `lane_slot_ratio` and `step_slot_ratio` say, from
those counts, how many lane slots a schedule spends per evaluated draw.

What a pass computes, per item (the JAX `_css_pass`): of its k smallest
x1 (sx1 ascending, srv the rows' RNG values), the rows with x1 <=
threshold are kept; tcut is the least x1 of the k that is not kept
(+inf if all k are kept; rows beyond k do not count); each kept row d
draws e[d, j] = x1[d] - log(u(wanghash(rv[d] ^ j * GOLD))) for every
register j, except e[d, idx0] = x1[d] with idx0 = wyhash(rv[d]) mod m;
a register is the least e of the kept rows (+inf if none), its winner
the first row of equal minima (0 where no row is kept). u is the u64's
correctly rounded f64 times 2^-64, clamped to at least 1e-300; the log
is ops/fixedmath.py's `log64`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import hashes as DH
from .fixedmath import log64
from .gtlt import LaunchCount

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "css.cu")

GOLD = 0x9E3779B97F4A7C15  # 2^64 / golden ratio, register-stride salt
M_MAX = 65535 * 128        # the most registers a pass takes
LANES = 32                 # rows a step of csrc/css.cu's walk (a warp)

launches = LaunchCount()


def check_pass(sx1: torch.Tensor, srv: torch.Tensor, k: torch.Tensor,
               threshold: torch.Tensor, m: int) -> None:
    if sx1.dtype != torch.float64 or srv.dtype != torch.int64 \
            or k.dtype != torch.int64 or threshold.dtype != torch.float64:
        raise TypeError("sx1 float64, srv int64, k int64 and threshold "
                        f"float64 expected, got {sx1.dtype}, {srv.dtype}, "
                        f"{k.dtype}, {threshold.dtype}")
    if sx1.dim() != 2 or sx1.shape != srv.shape or sx1.shape[1] < 1 \
            or k.shape != (sx1.shape[0],) \
            or threshold.shape != (sx1.shape[0],):
        raise ValueError("sx1 and srv must be (B, K >= 1), k and threshold "
                         "(B,)")
    if not all(t.is_contiguous() for t in (sx1, srv, k, threshold)):
        raise ValueError("css_pass operands must be contiguous")
    if len({sx1.device, srv.device, k.device, threshold.device}) != 1:
        raise ValueError("css_pass operands on different devices")
    if not 1 <= m <= M_MAX:
        raise ValueError(f"m={m} out of range")


def _first_register(srv: torch.Tensor, m: int) -> torch.Tensor:
    """Each row's register that takes x1 itself: wyhash(rv) mod m."""
    _, draw = DH.wyhash64_step(srv)
    return DH.u64_mod(draw, m)


def _draws(srv: torch.Tensor, sx1: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m) draws x1 - log(u) of rows (...,), computed as -log + x1
    (the same IEEE sum), with x1 at the row's first register."""
    j = torch.arange(m, dtype=torch.int64, device=sx1.device) * DH.s64(GOLD)
    e = srv[..., None] ^ j
    DH.wanghash_(e)
    u = DH.u64_to_unit_float(e)
    del e
    e = log64(u.clamp_(min=1e-300)).neg_().add_(sx1[..., None])
    del u
    e.scatter_(-1, _first_register(srv, m)[..., None], sx1[..., None])
    return e


def _tcut(sx1: torch.Tensor, k: torch.Tensor, threshold: torch.Tensor):
    """(kept (B, K) bool, tcut (B,) f64) of the pass."""
    K = sx1.shape[1]
    sel = torch.arange(K, device=sx1.device)[None, :] < k[:, None]
    keep = sel & (sx1 <= threshold[:, None])
    tcut = torch.where(keep | ~sel, torch.inf, sx1).amin(1)
    return keep, tcut


def css_pass_plain(sx1: torch.Tensor, srv: torch.Tensor, k: torch.Tensor,
                   threshold: torch.Tensor, m: int, return_ids: bool = False):
    """Plain PyTorch version of `css_pass`, on the tensors' device: every
    row of every item drawn for all m registers at once ((B, K, m) f64),
    the dropped rows masked, then the least and its first row."""
    check_pass(sx1, srv, k, threshold, m)
    keep, tcut = _tcut(sx1, k, threshold)
    e = _draws(srv, sx1, m)
    e.masked_fill_(~keep[:, :, None], torch.inf)
    if return_ids:
        return e.amin(1), tcut, e.argmin(1)
    return e.amin(1), tcut


def css_walk_plain(sx1: torch.Tensor, srv: torch.Tensor, k: torch.Tensor,
                   threshold: torch.Tensor, m: int, step: int = 1):
    """The early-exit walk in plain PyTorch: rows in ascending order,
    `step` at a time (1: the walk a row at a time; LANES: csrc/css.cu's,
    a warp's lanes across the rows of a step). A register evaluates a step
    while the step's first row is kept and its x1 is below the register's
    least draw (no draw of that row or a later one can beat it); a step's
    least, at its first row among equal draws, replaces the register's
    only when strictly below it. Returns (registers, tcut, winners,
    draws): the pass's three results (the full pass's, bit for bit, since
    every draw of a row is at least its x1) and, per (item, register), the
    kept rows the walk evaluated."""
    check_pass(sx1, srv, k, threshold, m)
    keep, tcut = _tcut(sx1, k, threshold)
    B, K = sx1.shape
    dev = sx1.device
    best = torch.full((B, m), torch.inf, dtype=torch.float64, device=dev)
    row = torch.zeros((B, m), dtype=torch.int64, device=dev)
    live = torch.ones((B, m), dtype=torch.bool, device=dev)
    draws = torch.zeros((B, m), dtype=torch.int64, device=dev)
    for d in range(0, K, step):
        live &= keep[:, d, None] & (sx1[:, d, None] < best)
        if not bool(live.any()):
            break
        kept = keep[:, d:d + step]
        e = _draws(srv[:, d:d + step], sx1[:, d:d + step], m)
        e.masked_fill_(~kept[:, :, None], torch.inf)
        least, at = e.amin(1), e.argmin(1)
        better = live & (least < best)
        best = torch.where(better, least, best)
        row = torch.where(better, at + d, row)
        draws += live * kept.sum(1, keepdim=True)
    return best, tcut, row, draws


def lane_slot_ratio(draws: torch.Tensor, lanes: int = LANES) -> float:
    """Lane slots per evaluated draw of the thread-per-register walk (the
    PR 18 kernel's schedule), from `draws` (items, m), the rows each
    register's walk evaluates: `lanes` consecutive registers of an item
    share a warp (or a block), which runs until its longest walk ends.
    lanes x (sum over groups of the longest walk) / (sum of walks); the
    registers past m in the last group walk nothing."""
    B, m = draws.shape
    pad = -m % lanes
    g = torch.nn.functional.pad(draws, (0, pad)).reshape(B, -1, lanes)
    total = int(draws.sum())
    return lanes * int(g.amax(2).sum()) / total if total else 1.0


def step_slot_ratio(draws: torch.Tensor, lanes: int = LANES) -> float:
    """Lane slots per evaluated draw of csrc/css.cu's walk, from the same
    `draws` (items, m) of the row-at-a-time walk: a register of n >= 1
    rows takes ceil(n / lanes) steps of `lanes` lane slots each."""
    n = draws[draws > 0]
    total = int(n.sum())
    steps = int(((n + lanes - 1) // lanes).sum())
    return lanes * steps / total if total else 1.0


def walk_draws(sx1: torch.Tensor, k: torch.Tensor, threshold: torch.Tensor,
               regs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows `css_walk_plain` evaluates per (item, register), from a
    pass's registers and winners: every row up to the winner, and the
    kept rows after it whose x1 is below the register (rows ascend, so
    those are a prefix), none where no row is kept."""
    keep, _ = _tcut(sx1, k, threshold)
    kept = keep.sum(1, keepdim=True)
    below = torch.searchsorted(sx1, regs.contiguous(), side="left")
    n = torch.maximum(ids + 1, below).clamp_(max=kept)
    return torch.where(torch.isinf(regs), torch.zeros_like(n), n)


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/css.cu; raises when nvcc
    is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("css", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.css_pass.restype = i
        lib.css_pass.argtypes = [p, p, p, p, ll, ll, i, p, p, p, p]
        lib._sigs_set = True
    return lib


def css_pass(sx1: torch.Tensor, srv: torch.Tensor, k: torch.Tensor,
             threshold: torch.Tensor, m: int, return_ids: bool = False
             ) -> Tuple[torch.Tensor, ...]:
    """One filtered CSetSketch pass over B items: sx1, srv (B, K) x1 and
    rv of each item's rows in ascending x1; k (B,) the rows each item
    takes (<= K); threshold (B,) f64. Returns (registers (B, m) f64, tcut
    (B,) f64) and with return_ids the winning rows ((B, m) int64). The
    CUDA kernel for CUDA tensors (asynchronous, on the current stream),
    the plain version for CPU tensors."""
    check_pass(sx1, srv, k, threshold, m)
    if sx1.device.type == "cpu":
        return css_pass_plain(sx1, srv, k, threshold, m, return_ids)
    if sx1.device.type != "cuda":
        raise ValueError(f"no css_pass for device {sx1.device}")
    lib = load_kernel()
    dev = sx1.device
    B, K = sx1.shape
    regs = torch.empty((B, m), dtype=torch.float64, device=dev)
    tcut = torch.empty(B, dtype=torch.float64, device=dev)
    ids = (torch.empty((B, m), dtype=torch.int64, device=dev)
           if return_ids else None)
    with torch.cuda.device(dev):
        err = lib.css_pass(
            sx1.data_ptr(), srv.data_ptr(), k.data_ptr(),
            threshold.data_ptr(), B, K, m, regs.data_ptr(), tcut.data_ptr(),
            ids.data_ptr() if return_ids else None,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"css_pass kernel launch failed: CUDA error {err}")
    launches.launches += 1
    if return_ids:
        return regs, tcut, ids
    return regs, tcut
