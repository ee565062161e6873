"""All-pairs equal-register counts over packed 4-bit registers.

Port of the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_tri_eq_kernel
(reached through tri_counts_tiles(want_gtlt=False) from
dashing2_tpu/cmp/core.py::_self_counts_fn_m). The Hopper kernel is
csrc/tri_eq.cu, compiled with nvcc for sm_90a into a shared library with
a plain C interface and bound with ctypes. Like the TPU kernel it
contracts an int8 one-hot of the registers on the matrix units
(mma.sync), but it builds the one-hot in registers from the packed
nibbles; `onehot_fragment_words` models the words it builds. Its source
note says what bounds it (N(N+1)/2 x 16m int8 MACs).

`tri_eq_counts` chooses by the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs `tri_eq_counts_plain`. There
is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "tri_eq.cu")

# launches of the CUDA kernel since the last reset (a plain integer, so a
# run can show that its main path went through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def check_packed(packed: torch.Tensor, m: int) -> None:
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed registers must be uint8, got {packed.dtype}")
    if packed.dim() != 2 or packed.shape[0] < 1:
        raise ValueError(f"packed registers must be (n >= 1, m/2), got "
                         f"{tuple(packed.shape)}")
    if m <= 0 or m % 2 or packed.shape[1] != m // 2:
        raise ValueError(f"packed rows hold {packed.shape[1]} bytes; "
                         f"m={m} needs m/2")
    if m >= 1 << 16:
        raise ValueError(f"u16 counts overflow at m={m} >= 65536")
    if not packed.is_contiguous():
        raise ValueError("packed registers must be contiguous")


def tri_eq_counts_plain(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(n, m/2) u8 packed nibbles -> (n, n) u16 eq counts in plain torch.

    eq = sum_v onehot_v(A) @ onehot_v(A)^T with onehot_v(A) = [A == v],
    in f32 on the tensor's device, chunked over registers so each one-hot
    operand holds at most 2^24 values. Exact: the inputs are 0/1 and every
    partial sum is an integer <= m < 2^24. It turns
    `torch.backends.cuda.matmul.allow_tf32` off for its duration (and
    restores it), so the products on the card run in full f32."""
    check_packed(packed, m)
    n = packed.shape[0]
    dev = packed.device
    regs = torch.cat([packed & 0xF, packed >> 4], dim=1)      # (n, m)
    chunk = max(1, min(m, (16 << 20) // n))
    eq = torch.zeros((n, n), dtype=torch.float32, device=dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for v in range(16):
            for r0 in range(0, m, chunk):
                oh = (regs[:, r0:r0 + chunk] == v).to(torch.float32)
                eq.addmm_(oh, oh.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return eq.to(torch.int32).to(torch.uint16)


def onehot_fragment_words(nibbles, t: int, pad=False) -> np.ndarray:
    """The u32 fragment words csrc/tri_eq.cu builds from 4-bit registers
    for the lanes with t = lane & 3 of an mma.sync m16n8k32 fragment:
    bytes k = 4t..4t+3 of the register's one-hot row, that is
    1 << 8 (nib - 4t) where 4t <= nib < 4t + 4, else 0.

    The kernel shifts 1 by (8 nib) ^ (32 t | 128 pad) with PTX shl.b32,
    which gives 0 for any shift of 32 or more: bits 5-6 of 8 nib are
    nib >> 2, so the xor leaves 8 (nib & 3) where nib >> 2 == t and 32 or
    more elsewhere, and a pad register (`pad`, the A side's bytes at or
    past m/2) shifts by 128 or more. Both arguments broadcast; the result
    has their shape."""
    nib = np.asarray(nibbles, dtype=np.int64)
    s = (8 * nib) ^ (32 * int(t) | 128 * np.asarray(pad, dtype=np.int64))
    return np.where(s < 32, np.left_shift(1, np.minimum(s, 31)),
                    0).astype(np.uint32)


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/tri_eq.cu; raises when
    nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("tri_eq", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        lib.tri_eq_counts_u16.restype = ctypes.c_int
        lib.tri_eq_counts_u16.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib._sigs_set = True
    return lib


def packed_words(packed: torch.Tensor, align: int = 4) -> torch.Tensor:
    """Rows padded with zero bytes to whole multiples of `align` bytes (u32
    words by default; zero pad nibbles are never unequal or greater),
    `align`-byte aligned."""
    mb = packed.shape[1]
    wb = -(-mb // align) * align
    if wb != mb or packed.data_ptr() % align:
        padded = torch.zeros((packed.shape[0], wb), dtype=torch.uint8,
                             device=packed.device)
        padded[:, :mb] = packed
        packed = padded
    return packed


def tri_eq_counts(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(n, m/2) u8 packed nibbles -> (n, n) u16 eq counts, on the
    tensor's device: the CUDA kernel for a CUDA tensor (asynchronous, on
    the current stream), the plain version for a CPU tensor."""
    global launches
    check_packed(packed, m)
    if packed.device.type == "cpu":
        return tri_eq_counts_plain(packed, m)
    if packed.device.type != "cuda":
        raise ValueError(f"no tri_eq_counts for device {packed.device}")
    lib = load_kernel()
    n = packed.shape[0]
    words = packed_words(packed, 16)          # 16-byte cp.async rows
    out = torch.empty((n, n), dtype=torch.uint16, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = lib.tri_eq_counts_u16(words.data_ptr(), n,
                                    words.shape[1] // 4, m,
                                    out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tri_eq kernel launch failed: CUDA error {err}")
    launches += 1
    return out
