"""All-pairs equal and greater-register counts over packed 4-bit registers.

Port of the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_tri_comb_kernel
(reached through tri_counts_tiles(want_gtlt=True) from
dashing2_tpu/cmp/core.py::_self_matrix_fn_m, the `--fastcmp 0.5` a/b
route; counts_nibble_tri_self is its full-matrix form). The Hopper
kernel is csrc/tri_comb.cu, built and bound as ops/nibble_tri.py's
tri_eq.cu is, and run on tri_eq.cu's engine: like the TPU kernel it
contracts the one-hot of the rows' registers against the combined
encoding [b == v] - 128 [b < v] of the columns' on the matrix units
(mma.sync) and decodes eq and gt from each chunk's partial eq - 128 gt.
`combined_fragment_words` models the B words it builds (once per block,
into a table in shared memory) and `decode_partials` its decode; its
source note says what bounds it.

`tri_comb_counts` chooses by the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs `tri_comb_counts_plain`. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np
import torch

from .nibble_tri import check_packed, packed_words

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "tri_comb.cu")

# launches of the CUDA kernel since the last reset (a plain integer, so a
# run can show that its main path went through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def tri_comb_counts_plain(packed: torch.Tensor, m: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, m/2) u8 packed nibbles -> (eq, gt), (n, n) u16 each, in plain
    torch: gt[i, j] = #{r : reg r of row i > reg r of row j}.

    The one-hot products of the JAX package's `_nibble_mxu`:
    eq = sum_v oh_v @ oh_v^T and gt = sum_v oh_v @ [regs < v]^T with
    oh_v = [regs == v], in f32 on the tensor's device, chunked over
    registers so each operand holds at most 2^24 values. Exact: the
    inputs are 0/1 and every partial sum is an integer <= m < 2^24. It
    turns `torch.backends.cuda.matmul.allow_tf32` off for its duration
    (and restores it), so the products on the card run in full f32."""
    check_packed(packed, m)
    n = packed.shape[0]
    dev = packed.device
    regs = torch.cat([packed & 0xF, packed >> 4], dim=1)      # (n, m)
    chunk = max(1, min(m, (16 << 20) // n))
    eq = torch.zeros((n, n), dtype=torch.float32, device=dev)
    gt = torch.zeros((n, n), dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for v in range(16):
            for r0 in range(0, m, chunk):
                blk = regs[:, r0:r0 + chunk]
                oh = (blk == v).to(torch.float32)
                eq.addmm_(oh, oh.T)
                if v:                     # [regs < 0] is empty
                    gt.addmm_(oh, (blk < v).to(torch.float32).T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return (eq.to(torch.int32).to(torch.uint16),
            gt.to(torch.int32).to(torch.uint16))


def combined_fragment_words(nibbles, t: int) -> np.ndarray:
    """The u32 fragment words csrc/tri_comb.cu builds from 4-bit column
    registers b (its table's entries) for the lanes with t = lane & 3 of
    an mma.sync m16n8k32 B fragment: bytes q = 0..3 for levels v = 4t + q of the register's
    combined row [b == v] - 128 [b < v], that is 1 where v == b, 0x80
    where v > b, else 0.

    With s = 8 (b - 4t) the kernel takes PTX shl.b32(0x80808001, s),
    which is 0 for s >= 32 (the group's levels all below b), and ors in
    0x80808080 where s < 0 (all above b). The argument broadcasts; the
    result has its shape."""
    s = 8 * (np.asarray(nibbles, dtype=np.int64) - 4 * int(t))
    low = np.left_shift(np.int64(0x80808001), np.clip(s, 0, 31)) & 0xFFFFFFFF
    return np.where(s < 0, 0x80808080,
                    np.where(s < 32, low, 0)).astype(np.uint32)


def decode_partials(partial) -> Tuple[np.ndarray, np.ndarray]:
    """(eq, gt) of a chunk's partials eq - 128 gt, as csrc/tri_comb.cu
    and the TPU kernel decode them: gt = (127 - partial) >> 7 and eq =
    partial + (gt << 7). Exact while eq <= 127, so a chunk holds at most
    127 registers."""
    p = np.asarray(partial, dtype=np.int64)
    gt = (127 - p) >> 7
    return p + (gt << 7), gt


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/tri_comb.cu; raises
    when nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("tri_comb", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        lib.tri_comb_counts_u16.restype = ctypes.c_int
        lib.tri_comb_counts_u16.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib._sigs_set = True
    return lib


def tri_comb_counts(packed: torch.Tensor, m: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, m/2) u8 packed nibbles -> (eq, gt), (n, n) u16 each, on the
    tensor's device: the CUDA kernel for a CUDA tensor (asynchronous, on
    the current stream), the plain version for a CPU tensor. eq is
    symmetric and gt[j, i] = m - eq[i, j] - gt[i, j] (the lt count)."""
    global launches
    check_packed(packed, m)
    if packed.device.type == "cpu":
        return tri_comb_counts_plain(packed, m)
    if packed.device.type != "cuda":
        raise ValueError(f"no tri_comb_counts for device {packed.device}")
    lib = load_kernel()
    n = packed.shape[0]
    words = packed_words(packed, 16)          # 16-byte cp.async rows
    eq = torch.empty((n, n), dtype=torch.uint16, device=packed.device)
    gt = torch.empty((n, n), dtype=torch.uint16, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = lib.tri_comb_counts_u16(words.data_ptr(), n,
                                      words.shape[1] // 4, m,
                                      eq.data_ptr(), gt.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tri_comb kernel launch failed: CUDA error {err}")
    launches += 1
    return eq, gt
