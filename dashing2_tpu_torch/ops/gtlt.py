"""All-pairs greater- and less-register counts over 64-bit registers.

Port of two TPU kernels of dashing2_tpu/ops/pallas_cmp.py, the engines
of the default full-register comparison (no `--fastcmp`):

* `gtlt_self_counts` replaces the kernel inside `_tri_gtlt_call`
  (`gtlt_self_pallas`): all pairs of one register matrix, upper tiles
  only, lt = gt^T;
* `gtlt_counts` replaces `_gtlt_kernel` (`gtlt_pallas`): the full
  rectangle of two register matrices, as the JAX package's generic
  row-block route (`cmp/core.py::_gtlt_u64`) uses it.

Both launch csrc/gtlt.cu, one CUDA source with two schedules, built and
bound as ops/nibble_tri.py's tri_eq.cu is; its source note says what
bounds it. Registers travel as torch int64 tensors holding the u64 bit
patterns (torch has few uint64 operations): the kernel reads them as
unsigned, and the plain versions compare `x ^ (1 << 63)` as signed,
which keeps the unsigned order of any 64-bit pattern.

Each wrapper chooses by the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "gtlt.cu")

# the signed view of the top bit: x ^ _TOP orders signed as x does unsigned
_TOP = -(1 << 63)
# bool elements the plain versions materialise per compare
_PLAIN_CHUNK = 1 << 26
_MAX_ROW_TILES = 65535            # the rectangular grid's y extent


class LaunchCount:
    """Launches of one CUDA entry since the last reset (a plain integer,
    so a run can show that its main path went through the kernel)."""

    def __init__(self) -> None:
        self.launches = 0

    def reset_launches(self) -> None:
        self.launches = 0


self_launches = LaunchCount()     # gtlt_self_counts
rect_launches = LaunchCount()     # gtlt_counts


def check_regs(regs: torch.Tensor) -> None:
    if regs.dtype != torch.int64:
        raise TypeError(f"registers must be int64 (u64 bit patterns), got "
                        f"{regs.dtype}")
    if regs.dim() != 2 or regs.shape[0] < 1 or regs.shape[1] < 1:
        raise ValueError(f"registers must be (n >= 1, m >= 1), got "
                         f"{tuple(regs.shape)}")
    if regs.shape[1] >= 1 << 16:
        raise ValueError(f"u16 counts overflow at m={regs.shape[1]} >= 65536")
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous")


def _gt_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(na, nb) int32 #{r : a[i, r] > b[j, r]} in unsigned order, row
    chunks of a against all of b so that each compare holds at most
    _PLAIN_CHUNK booleans."""
    x = a ^ _TOP
    y = (b ^ _TOP)[None]
    rows = max(1, _PLAIN_CHUNK // (b.shape[0] * b.shape[1]))
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                      device=a.device)
    for r0 in range(0, a.shape[0], rows):
        out[r0:r0 + rows] = (x[r0:r0 + rows, None] > y).sum(
            -1, dtype=torch.int32)
    return out


def gtlt_self_counts_plain(regs: torch.Tensor) -> torch.Tensor:
    """(n, m) int64 registers -> (n, n) u16 gt counts in plain torch:
    gt[i, j] = #{r : reg r of row i > reg r of row j} (unsigned), so
    gt[j, i] is the lt count of the pair (i, j)."""
    check_regs(regs)
    return _gt_plain(regs, regs).to(torch.uint16)


def gtlt_counts_plain(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(na, m) and (nb, m) int64 registers -> (gt, lt), (na, nb) u16
    each, in plain torch (unsigned order)."""
    _check_pair(a, b)
    return (_gt_plain(a, b).to(torch.uint16),
            _gt_plain(b, a).T.contiguous().to(torch.uint16))


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    check_regs(a)
    check_regs(b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"register counts differ: {a.shape[1]} and "
                         f"{b.shape[1]}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/gtlt.cu; raises when
    nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("gtlt", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gtlt_self_counts_u16.restype = i
        lib.gtlt_self_counts_u16.argtypes = [p, i, i, p, p]
        lib.gtlt_counts_u16.restype = i
        lib.gtlt_counts_u16.argtypes = [p, i, p, i, i, p, p, p]
        lib._sigs_set = True
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def gtlt_self_counts(regs: torch.Tensor) -> torch.Tensor:
    """(n, m) int64 registers -> (n, n) u16 on the tensor's device: gt at
    (i, j) and lt at (j, i) for every pair i < j (lt = gt^T), 0 on the
    diagonal. The CUDA kernel for a CUDA tensor (asynchronous, on the
    current stream), the plain version for a CPU tensor."""
    check_regs(regs)
    if regs.device.type == "cpu":
        return gtlt_self_counts_plain(regs)
    if regs.device.type != "cuda":
        raise ValueError(f"no gtlt_self_counts for device {regs.device}")
    lib = load_kernel()
    n, m = regs.shape
    out = torch.empty((n, n), dtype=torch.uint16, device=regs.device)
    with torch.cuda.device(regs.device):
        err = lib.gtlt_self_counts_u16(regs.data_ptr(), n, m, out.data_ptr(),
                                       _stream(regs.device))
    if err != 0:
        raise RuntimeError(f"gtlt_self kernel launch failed: CUDA error {err}")
    self_launches.launches += 1
    return out


def gtlt_counts(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(na, m) and (nb, m) int64 registers -> (gt, lt), (na, nb) u16 each,
    on the tensors' device: the CUDA kernel for CUDA tensors
    (asynchronous, on the current stream), the plain version for CPU
    tensors."""
    _check_pair(a, b)
    if a.device.type == "cpu":
        return gtlt_counts_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no gtlt_counts for device {a.device}")
    na, m = a.shape
    nb = b.shape[0]
    if -(-na // 64) > _MAX_ROW_TILES:
        raise ValueError(f"na={na} needs more than {_MAX_ROW_TILES} row "
                         "tiles; split the rows")
    lib = load_kernel()
    gt = torch.empty((na, nb), dtype=torch.uint16, device=a.device)
    lt = torch.empty((na, nb), dtype=torch.uint16, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.gtlt_counts_u16(a.data_ptr(), na, b.data_ptr(), nb, m,
                                  gt.data_ptr(), lt.data_ptr(),
                                  _stream(a.device))
    if err != 0:
        raise RuntimeError(f"gtlt kernel launch failed: CUDA error {err}")
    rect_launches.launches += 1
    return gt, lt
