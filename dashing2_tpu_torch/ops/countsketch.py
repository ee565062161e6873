"""The CountSketch of `-c` (--countsketch-size) in the weighted spaces.

Port of the JAX package's device CountSketch, the XLA function
`_countsketch_device` (dashing2_tpu/ops/sketch_kernels.py:724) with its
host side `countsketch_counts` (:744). That engine is XLA, not Pallas.
Here csrc/countsketch.cu accumulates the buckets with int32 atomics;
`countsketch_buckets_plain` is its plain PyTorch version (an int64
`index_add_` of the signs, on any device), and the wrapper
`countsketch_buckets` chooses by the tensor's device, as ops/css.py
does. `countsketch_counts` compacts the buckets to the result.

What it computes (counter.h; enums.h:44-57): bucket h mod cssize (the
u64's modulo) gains +1 where the hash h is odd and -1 where it is even;
the result is the ascending ids of the non-zero buckets and their |sum|
as f64. Integer sums are exact in any order.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from . import hashes as DH
from .gtlt import LaunchCount

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "countsketch.cu")

# the JAX engine's int32 bucket ids and cumsum: streams and bucket counts
# below 2^31
LIMIT = 1 << 31

launches = LaunchCount()


def check_stream(hv: torch.Tensor, cssize: int) -> None:
    if hv.dtype != torch.int64 or hv.dim() != 1:
        raise TypeError(f"hashes must be a (n,) int64 tensor (u64 bits), "
                        f"got {hv.dtype} {tuple(hv.shape)}")
    if hv.shape[0] >= LIMIT:
        raise ValueError(f"{hv.shape[0]} hashes: the CountSketch's int32 "
                         "sums hold streams below 2^31")
    if not hv.is_contiguous():
        raise ValueError("hashes must be contiguous")
    if not 1 <= cssize < LIMIT:
        raise ValueError(f"cssize={cssize} out of range [1, 2^31)")


def countsketch_buckets_plain(hv: torch.Tensor, cssize: int) -> torch.Tensor:
    """Plain PyTorch version of `countsketch_buckets` ((cssize,) int64)."""
    check_stream(hv, cssize)
    idx = DH.u64_mod(hv, cssize)
    sign = torch.where((hv & 1) != 0, 1, -1)
    out = torch.zeros(cssize, dtype=torch.int64, device=hv.device)
    return out.index_add_(0, idx, sign)


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/countsketch.cu; raises
    when nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("countsketch", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p = ctypes.c_void_p
        lib.countsketch.restype = ctypes.c_int
        lib.countsketch.argtypes = [p, ctypes.c_longlong,
                                    ctypes.c_ulonglong, p, p]
        lib._sigs_set = True
    return lib


def countsketch_buckets(hv: torch.Tensor, cssize: int) -> torch.Tensor:
    """The cssize signed bucket sums of the hash stream hv ((n,) int64,
    u64 bits), on its device: int32 from the CUDA kernel for a CUDA
    tensor (asynchronous, on the current stream), int64 from the plain
    version for a CPU tensor."""
    check_stream(hv, cssize)
    if hv.device.type == "cpu":
        return countsketch_buckets_plain(hv, cssize)
    if hv.device.type != "cuda":
        raise ValueError(f"no countsketch for device {hv.device}")
    lib = load_kernel()
    dev = hv.device
    out = torch.zeros(cssize, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.countsketch(hv.data_ptr(), hv.shape[0], cssize,
                              out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"countsketch kernel launch failed: CUDA error "
                           f"{err}")
    launches.launches += 1
    return out


def countsketch_counts(hv: torch.Tensor, cssize: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids of the non-zero buckets, ascending int64; their |sum| f64) of
    the CountSketch of hv, on its device (the JAX `countsketch_counts`)."""
    b = countsketch_buckets(hv, cssize)
    nz = torch.nonzero(b).squeeze(1)
    return nz, b[nz].abs().to(torch.float64)
