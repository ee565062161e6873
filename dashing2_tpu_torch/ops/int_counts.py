"""All-pairs equal-, greater- and less-register counts over u8, u16 and u32
registers (the `--fastcmp 1`, `2` and `4` comparisons).

Port of the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_int_counts_kernel
(with `_int_counts_call` and `counts_int_pallas`, reached from
dashing2_tpu/cmp/core.py::_counts_int):

* `int_counts_self(regs, mode)`: all pairs of one register matrix, upper
  tiles only, as one (n, n) u16 matrix: mode "eq" holds the eq counts
  (mirrored), mode "gtlt" gt at (i, j) and lt at (j, i) (lt = gt^T);
* `int_counts(a, b)`: the full rectangle (eq, gt, lt) of two register
  matrices, what `counts_int_pallas` computes; it serves the row blocks
  above SELF_MAX.

u8 and u16 registers launch csrc/int_counts.cu, one CUDA source templated
on the register width, built and bound as ops/nibble_tri.py's tri_eq.cu
is; its source note says what bounds it. Registers travel as torch
uint8 (u8) or int16 holding the u16 bit patterns; the plain versions
compare the u16 values widened to int32. u32 registers travel as int64
(widened, as `counts_int_pallas` widens them and hands them to
`gtlt_pallas`) and go to ops/gtlt.py's kernels, with eq = m - gt - lt.

Each wrapper chooses by the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import gtlt as G
from .gtlt import LaunchCount
from .nibble_tri import packed_words

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "int_counts.cu")

# register bits per torch type the CUDA kernel takes
_WIDTH = {torch.uint8: 8, torch.int16: 16}
_MODES = {"eq": 0, "gtlt": 1}
# bool elements the plain versions materialise per compare
_PLAIN_CHUNK = 1 << 26
_MAX_ROW_TILES = 65535            # the rectangular grid's y extent

self_launches = LaunchCount()     # int_counts_self
rect_launches = LaunchCount()     # int_counts


def check_regs(regs: torch.Tensor) -> None:
    if regs.dtype not in (torch.uint8, torch.int16, torch.int64):
        raise TypeError(f"registers must be uint8 (u8), int16 (u16 bit "
                        f"patterns) or int64 (u32), got {regs.dtype}")
    if regs.dim() != 2 or regs.shape[0] < 1 or regs.shape[1] < 1:
        raise ValueError(f"registers must be (n >= 1, m >= 1), got "
                         f"{tuple(regs.shape)}")
    if regs.shape[1] >= 1 << 16:
        raise ValueError(f"u16 counts overflow at m={regs.shape[1]} >= 65536")
    if not regs.is_contiguous():
        raise ValueError("registers must be contiguous")


def _check_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    check_regs(a)
    check_regs(b)
    if a.dtype != b.dtype or a.shape[1] != b.shape[1]:
        raise ValueError(f"operands differ: {a.dtype} {tuple(a.shape)} and "
                         f"{b.dtype} {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be 'eq' or 'gtlt', got {mode!r}")


def _values(regs: torch.Tensor) -> torch.Tensor:
    """Registers as values that compare in unsigned order."""
    if regs.dtype == torch.int16:
        return regs.to(torch.int32) & 0xFFFF
    return regs


def _counts_plain(a: torch.Tensor, b: torch.Tensor, with_gt: bool):
    """(eq, gt or None), (na, nb) int32 each, in row chunks of a against
    all of b so that each compare holds at most _PLAIN_CHUNK booleans."""
    x, y = _values(a), _values(b)[None]
    rows = max(1, _PLAIN_CHUNK // (b.shape[0] * b.shape[1]))
    eq = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                     device=a.device)
    gt = torch.empty_like(eq) if with_gt else None
    for r0 in range(0, a.shape[0], rows):
        xs = x[r0:r0 + rows, None]
        eq[r0:r0 + rows] = (xs == y).sum(-1, dtype=torch.int32)
        if with_gt:
            gt[r0:r0 + rows] = (xs > y).sum(-1, dtype=torch.int32)
    return eq, gt


def _eq_of_gt(gt: torch.Tensor, m: int) -> torch.Tensor:
    """(n, n) eq counts from gtlt_self_counts' matrix (lt = gt^T)."""
    g = gt.to(torch.int32)
    return (m - g - g.T).to(torch.uint16)


def int_counts_self_plain(regs: torch.Tensor, mode: str) -> torch.Tensor:
    """(n, m) registers -> (n, n) u16 in plain torch: mode "eq" the eq
    counts; mode "gtlt" gt[i, j] = #{r : reg r of row i > reg r of row j}
    (unsigned), so gt[j, i] is the lt count of the pair (i, j)."""
    check_regs(regs)
    _check_mode(mode)
    if regs.dtype == torch.int64:
        gt = G.gtlt_self_counts_plain(regs)
        return gt if mode == "gtlt" else _eq_of_gt(gt, regs.shape[1])
    eq, gt = _counts_plain(regs, regs, mode == "gtlt")
    return (eq if mode == "eq" else gt).to(torch.uint16)


def int_counts_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(na, m) and (nb, m) registers -> (eq, gt, lt), (na, nb) u16 each,
    in plain torch (unsigned order)."""
    _check_pair(a, b)
    m = a.shape[1]
    if a.dtype == torch.int64:
        gt, lt = G.gtlt_counts_plain(a, b)
        eq = m - gt.to(torch.int32) - lt.to(torch.int32)
        return eq.to(torch.uint16), gt, lt
    eq, gt = _counts_plain(a, b, True)
    return (eq.to(torch.uint16), gt.to(torch.uint16),
            (m - eq - gt).to(torch.uint16))


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/int_counts.cu; raises
    when nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("int_counts", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int_counts_self_u16.restype = i
        lib.int_counts_self_u16.argtypes = [p, i, i, i, i, i, p, p]
        lib.int_counts_u16.restype = i
        lib.int_counts_u16.argtypes = [p, i, p, i, i, i, i, p, p, p, p]
        lib._sigs_set = True
    return lib


def _words(regs: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The rows' bytes padded with zero registers to whole u32 words,
    4-byte aligned, and the words per row."""
    words = packed_words(regs.view(torch.uint8))
    return words, words.shape[1] // 4


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def int_counts_self(regs: torch.Tensor, mode: str) -> torch.Tensor:
    """(n, m) registers -> (n, n) u16 on the tensor's device: mode "eq"
    the eq count at (i, j) and (j, i); mode "gtlt" gt at (i, j) and lt
    at (j, i) for every pair i < j (lt = gt^T, 0 on the diagonal). The
    CUDA kernel for a CUDA tensor (asynchronous, on the current stream),
    the plain version for a CPU tensor; int64 (u32) registers go to
    gtlt_self_counts."""
    check_regs(regs)
    _check_mode(mode)
    if regs.dtype == torch.int64:
        gt = G.gtlt_self_counts(regs)
        return gt if mode == "gtlt" else _eq_of_gt(gt, regs.shape[1])
    if regs.device.type == "cpu":
        return int_counts_self_plain(regs, mode)
    if regs.device.type != "cuda":
        raise ValueError(f"no int_counts_self for device {regs.device}")
    lib = load_kernel()
    n, m = regs.shape
    words, wpr = _words(regs)
    out = torch.empty((n, n), dtype=torch.uint16, device=regs.device)
    with torch.cuda.device(regs.device):
        err = lib.int_counts_self_u16(words.data_ptr(), n, wpr, m,
                                      _WIDTH[regs.dtype], _MODES[mode],
                                      out.data_ptr(), _stream(regs.device))
    if err != 0:
        raise RuntimeError(f"int_counts_self kernel launch failed: CUDA "
                           f"error {err}")
    self_launches.launches += 1
    return out


def int_counts(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(na, m) and (nb, m) registers -> (eq, gt, lt), (na, nb) u16 each,
    on the tensors' device: the CUDA kernel for CUDA tensors
    (asynchronous, on the current stream), the plain version for CPU
    tensors; int64 (u32) registers go to gtlt_counts."""
    _check_pair(a, b)
    m = a.shape[1]
    if a.dtype == torch.int64:
        gt, lt = G.gtlt_counts(a, b)
        eq = m - gt.to(torch.int32) - lt.to(torch.int32)
        return eq.to(torch.uint16), gt, lt
    if a.device.type == "cpu":
        return int_counts_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no int_counts for device {a.device}")
    na, nb = a.shape[0], b.shape[0]
    if -(-na // 64) > _MAX_ROW_TILES:
        raise ValueError(f"na={na} needs more than {_MAX_ROW_TILES} row "
                         "tiles; split the rows")
    lib = load_kernel()
    wa, wpr = _words(a)
    wb, _ = _words(b)
    eq, gt, lt = (torch.empty((na, nb), dtype=torch.uint16, device=a.device)
                  for _ in range(3))
    with torch.cuda.device(a.device):
        err = lib.int_counts_u16(wa.data_ptr(), na, wb.data_ptr(), nb, wpr,
                                 m, _WIDTH[a.dtype], eq.data_ptr(),
                                 gt.data_ptr(), lt.data_ptr(),
                                 _stream(a.device))
    if err != 0:
        raise RuntimeError(f"int_counts kernel launch failed: CUDA error "
                           f"{err}")
    rect_launches.launches += 1
    return eq, gt, lt
