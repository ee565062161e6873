"""Equal-, greater- and less-register counts over a list of item pairs.

The counterpart of the JAX package's pair-list engines
(dashing2_tpu/cmp/core.py::_pair_counts_fn and _pair_counts_swar_fn),
which the neighbour graphs' refinement and the greedy dedup rounds call
through `measure_pairs`. Those engines are XLA, not Pallas: there is no
TPU kernel to port. `pair_counts` is plain PyTorch and runs where its
tensors are: on the card for a CUDA job, on the CPU for `--device cpu`.
It gathers the pairs' rows and compares them in blocks of BLOCK pairs, as
the JAX engines scan theirs, so the gathered rows stay bounded.

Registers travel as the count kernels take them (cmp/core.py::
_device_regs, nibbles unpacked): uint8 (u8 and nibbles), int16 holding
u16 bit patterns, int64 holding u32 values or u64 bit patterns. Every
kind compares in unsigned order.
"""

from __future__ import annotations

from typing import Tuple

import torch

# pairs gathered and compared at once (the JAX engines' scan block)
BLOCK = 8192
# the signed view of the top bit: x ^ _TOP orders signed as x does unsigned
_TOP = -(1 << 63)


def _values(regs: torch.Tensor) -> torch.Tensor:
    """Registers as values that compare in unsigned order."""
    if regs.dtype == torch.int16:
        return regs.to(torch.int32) & 0xFFFF
    if regs.dtype == torch.int64:
        return regs ^ _TOP
    if regs.dtype != torch.uint8:
        raise TypeError(f"registers must be uint8, int16 (u16 bit patterns) "
                        f"or int64, got {regs.dtype}")
    return regs


def pair_counts(regs: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                block: int = BLOCK
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(n, m) registers and (P,) int64 row indices on the registers'
    device -> (eq, gt, lt), (P,) int32 each: for pair p, the registers of
    row ia[p] equal to, greater than and less than those of row ib[p]."""
    if regs.dim() != 2:
        raise ValueError(f"registers must be (n, m), got {tuple(regs.shape)}")
    if ia.shape != ib.shape or ia.dim() != 1:
        raise ValueError(f"index vectors differ: {tuple(ia.shape)} and "
                         f"{tuple(ib.shape)}")
    if ia.device != regs.device or ib.device != regs.device:
        raise ValueError(f"registers on {regs.device}, indices on "
                         f"{ia.device} and {ib.device}")
    x = _values(regs)
    npairs, m = ia.shape[0], regs.shape[1]
    eq = torch.empty(npairs, dtype=torch.int32, device=regs.device)
    gt = torch.empty_like(eq)
    for s in range(0, npairs, block):
        a = x[ia[s:s + block]]
        b = x[ib[s:s + block]]
        eq[s:s + block] = (a == b).sum(1, dtype=torch.int32)
        gt[s:s + block] = (a > b).sum(1, dtype=torch.int32)
    return eq, gt, m - eq - gt
