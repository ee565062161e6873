"""The CountSketch of `-c` in the port (ops/countsketch.py), on the CPU.

The plain version against the JAX package's device engine
`countsketch_counts` (a sort of the bucket ids with the signs riding
along and an int32 cumsum), exactly: ids and |sums| over random streams,
streams whose repeats cancel to zero buckets, u64 hashes >= 2^63 and
the empty stream, at cssize in {1, 7, 2^20}. Integer sums: tolerance
zero. The wrapper refuses streams of 2^31 hashes or more, bucket counts
outside [1, 2^31) and devices other than the CPU and the card.
"""

import numpy as np
import pytest
import torch

from dashing2_tpu.ops import sketch_kernels as JSK
from dashing2_tpu_torch.ops import countsketch as CS


def _stream(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if kind == "high":
        return rng.integers(1 << 63, 1 << 64, n, dtype=np.uint64)
    # repeats: each hash with its neighbour of the other parity in the
    # same bucket cancels
    base = rng.integers(0, 1 << 62, n // 2, dtype=np.uint64) * np.uint64(2)
    return rng.permutation(np.concatenate([base, base + np.uint64(1),
                                           base[: n // 8]]))


@pytest.mark.parametrize("cssize", [1, 7, 1 << 20])
@pytest.mark.parametrize("kind", ["random", "high", "cancel"])
@pytest.mark.parametrize("n", [1, 1000, 50000])
def test_plain_equals_jax(cssize, kind, n):
    hv = _stream(kind, n, seed=n + cssize)
    want_ids, want_sums = JSK.countsketch_counts(hv, cssize)
    ids, sums = CS.countsketch_counts(torch.from_numpy(hv.view(np.int64)),
                                      cssize)
    np.testing.assert_array_equal(ids.numpy().astype(np.uint64), want_ids)
    assert sums.dtype == torch.float64
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    b = CS.countsketch_buckets_plain(torch.from_numpy(hv.view(np.int64)),
                                     cssize).numpy()
    idx = (hv % np.uint64(cssize)).astype(np.int64)
    sign = np.where((hv & np.uint64(1)).astype(bool), 1, -1)
    np.testing.assert_array_equal(b, np.bincount(idx, weights=sign,
                                                 minlength=cssize))


def test_empty_stream():
    ids, sums = CS.countsketch_counts(torch.zeros(0, dtype=torch.int64), 7)
    want_ids, want_sums = JSK.countsketch_counts(np.zeros(0, np.uint64), 7)
    assert ids.numel() == sums.numel() == len(want_ids) == len(want_sums) \
        == 0


def test_countsketch_refusals():
    big = torch.zeros(1, dtype=torch.int64).expand(1 << 31)
    with pytest.raises(ValueError, match="2\\^31"):
        CS.countsketch_buckets(big, 7)
    hv = torch.arange(10, dtype=torch.int64)
    for cssize in (0, 1 << 31):
        with pytest.raises(ValueError, match="cssize"):
            CS.countsketch_buckets(hv, cssize)
    with pytest.raises(TypeError):
        CS.countsketch_buckets(hv.to(torch.int32), 7)
    with pytest.raises(ValueError, match="no countsketch"):
        CS.countsketch_buckets(torch.empty(5, dtype=torch.int64,
                                           device="meta"), 7)
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            CS.load_kernel()
