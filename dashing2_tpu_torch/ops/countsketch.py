"""The CountSketch of `-c` (--countsketch-size) in the weighted spaces.

Port of the JAX package's device CountSketch, the XLA function
`_countsketch_device` (dashing2_tpu/ops/sketch_kernels.py:724) with its
host side `countsketch_counts` (:744). That engine is XLA, not Pallas.

What it computes (counter.h; enums.h:44-57): in each hash stream, bucket
h mod cssize (the u64's modulo) gains +1 where the hash h is odd and -1
where it is even; the result is the ascending ids of the non-zero
buckets and their |sum|. Integer sums are exact in any order.

`countsketch_batch` takes a batch of streams at once (their hashes
concatenated, and their offsets) and chooses by the hashes' device, as
ops/css.py does: csrc/countsketch.cu (one launch sequence a batch, with
no cssize-sized array) for a CUDA tensor, `countsketch_batch_plain` (the
JAX engine's algorithm: one sort of (stream, bucket) keys, then run
sums) for a CPU tensor. `countsketch_many` is the host side of a batch
of numpy streams (one upload, one call, the results copied back), and
`countsketch_counts` a batch of one.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import hashes as DH
from .gtlt import LaunchCount

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "countsketch.cu")

# the JAX engine's int32 bucket ids and cumsum, and the kernel's int32
# positions and sums: batches and bucket counts below 2^31
LIMIT = 1 << 31
# hashes a batch of `countsketch_many`'s callers (sketch/core.py), in the
# style of ops/sketch_kernels.py CSS_BATCH_ELEMENTS
BATCH_HASHES = 1 << 27

launches = LaunchCount()


def check_batch(hv: torch.Tensor, offsets: torch.Tensor, cssize: int) -> None:
    """Raises unless hv is a contiguous (n,) int64 tensor with n < 2^31,
    offsets a CPU (S + 1,) int64 tensor from 0 to n, non-decreasing, and
    cssize in [1, 2^31)."""
    if hv.dtype != torch.int64 or hv.dim() != 1:
        raise TypeError(f"hashes must be a (n,) int64 tensor (u64 bits), "
                        f"got {hv.dtype} {tuple(hv.shape)}")
    if hv.shape[0] >= LIMIT:
        raise ValueError(f"{hv.shape[0]} hashes: the CountSketch's int32 "
                         "sums and positions hold batches below 2^31")
    if not hv.is_contiguous():
        raise ValueError("hashes must be contiguous")
    if not 1 <= cssize < LIMIT:
        raise ValueError(f"cssize={cssize} out of range [1, 2^31)")
    if (offsets.dtype != torch.int64 or offsets.dim() != 1
            or offsets.shape[0] < 1 or offsets.device.type != "cpu"):
        raise TypeError(f"offsets must be a CPU (S + 1,) int64 tensor, got "
                        f"{offsets.dtype} {tuple(offsets.shape)} on "
                        f"{offsets.device}")
    o = offsets.numpy()
    if o[0] != 0 or o[-1] != hv.shape[0] or (o[1:] < o[:-1]).any():
        raise ValueError("offsets must rise from 0 to the number of hashes")


def countsketch_batch_plain(hv: torch.Tensor, offsets: torch.Tensor,
                            cssize: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `countsketch_batch`, on hv's device: the
    (stream, bucket) keys sorted, the signs summed over each run of equal
    keys (an int64 cumsum read at the run ends), the zero sums dropped.
    O(n log n), with no cssize-sized array."""
    check_batch(hv, offsets, cssize)
    dev, n = hv.device, hv.shape[0]
    lengths = (offsets[1:] - offsets[:-1]).to(dev)
    sid = torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=dev), lengths)
    key = sid * cssize + DH.u64_mod(hv, cssize)
    skey, perm = torch.sort(key)
    cs = torch.cumsum(torch.where((hv[perm] & 1) != 0, 1, -1), 0)
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = skey[1:] != skey[:-1]
    ends = torch.nonzero(last).squeeze(1)
    csum = cs[ends]
    sums = torch.diff(csum, prepend=csum.new_zeros(1))
    keep = sums != 0
    keys, sums = skey[ends][keep], sums[keep].abs()
    counts = torch.bincount(keys // cssize, minlength=lengths.shape[0])
    out = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    out[:keys.shape[0], 0] = (keys % cssize).to(torch.int32)
    out[:keys.shape[0], 1] = sums.to(torch.int32)
    return out, counts


def load_kernel() -> ctypes.CDLL:
    """Build (once per source hash) and load csrc/countsketch.cu; raises
    when nvcc is missing or the build fails."""
    from ..native import build_shared, nvcc_command
    lib = build_shared("countsketch", [SOURCE], nvcc_command(SOURCE))
    if not getattr(lib, "_sigs_set", False):
        p, ll, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
        lib.countsketch_scratch_ints.restype = ll
        lib.countsketch_scratch_ints.argtypes = [ll, ctypes.c_int]
        lib.countsketch_batch.restype = ctypes.c_int
        lib.countsketch_batch.argtypes = [p, ll, p, ctypes.c_int, ull, ull,
                                          p, p, p, p]
        lib._sigs_set = True
    return lib


def countsketch_batch(hv: torch.Tensor, offsets: torch.Tensor, cssize: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CountSketches of a batch of S hash streams: hv (n,) int64 (u64
    bits), stream s its hashes offsets[s]:offsets[s + 1] (a CPU (S + 1,)
    int64 tensor). Returns (out, counts) on hv's device: out (n, 2)
    int32, whose first counts.sum() rows are the streams' non-zero
    buckets (id, |sum|), ascending in each stream, stream after stream
    (the rows past them are unspecified), and counts (S,) int64. A CUDA
    tensor launches csrc/countsketch.cu (asynchronous, on the current
    stream; out is a view of one buffer that also holds the kernel's
    scratch), a CPU tensor runs the plain version."""
    check_batch(hv, offsets, cssize)
    if hv.device.type == "cpu":
        return countsketch_batch_plain(hv, offsets, cssize)
    if hv.device.type != "cuda":
        raise ValueError(f"no countsketch for device {hv.device}")
    lib = load_kernel()
    dev, n, S = hv.device, hv.shape[0], offsets.shape[0] - 1
    # one allocation (int32 words): the counts and offsets (int64), the
    # rows, the scratch
    head = 4 * S + 2
    buf = torch.empty(head + 2 * n + (
        lib.countsketch_scratch_ints(n, S) if S else 0), dtype=torch.int32,
        device=dev)
    counts = buf[:2 * S].view(torch.int64)
    out = buf[head:head + 2 * n].view(n, 2)
    if S == 0:
        return out, counts
    off = buf[2 * S:head].view(torch.int64)
    off.copy_(offsets, non_blocking=True)
    scratch = buf[head + 2 * n:]
    with torch.cuda.device(dev):
        err = lib.countsketch_batch(
            hv.data_ptr(), n, off.data_ptr(), S, cssize,
            ((1 << 64) - 1) // cssize, scratch.data_ptr(), out.data_ptr(),
            counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"countsketch kernel launch failed: CUDA error "
                           f"{err}")
    launches.launches += 1
    return out, counts


def countsketch_many(streams: Sequence[np.ndarray], cssize: int,
                     device="cpu") -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each u64 stream's (ids of its non-zero buckets, ascending u64;
    their |sum| f64), from one `countsketch_batch` call on `device`: the
    streams concatenated and uploaded once, the counts and then the
    non-zero rows (as an id row and a sum row) copied back."""
    offsets = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=offsets[1:])
    hv = torch.from_numpy(np.concatenate(streams).view(np.int64)
                          if streams else np.zeros(0, np.int64))
    out, counts = countsketch_batch(hv.to(device), torch.from_numpy(offsets),
                                    cssize)
    counts = counts.cpu().numpy()
    ends = np.cumsum(counts)
    # ids and sums as two contiguous rows, for the host's conversions
    cols = out[:int(ends[-1]) if len(ends) else 0].t().contiguous().cpu()
    ids = cols[0].numpy().astype(np.uint64)
    sums = cols[1].numpy().astype(np.float64)
    return [(ids[e - k:e], sums[e - k:e]) for k, e in zip(counts, ends)]


def countsketch_counts(hv: torch.Tensor, cssize: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids of the non-zero buckets, ascending int64; their |sum| f64) of
    the CountSketch of one stream hv, on its device (the JAX
    `countsketch_counts`): a batch of one."""
    out, counts = countsketch_batch(
        hv, torch.tensor([0, hv.shape[0]], dtype=torch.int64), cssize)
    k = int(counts[0])
    return out[:k, 0].to(torch.int64), out[:k, 1].to(torch.float64)
