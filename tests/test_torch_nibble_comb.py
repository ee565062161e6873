"""Port parity: ops/nibble_comb.py against the JAX package's nibble
eq/gt count engines.

The same seeded packed registers go to the port's `tri_comb_counts` (on
CPU tensors: its plain PyTorch version) and to the JAX package's
triangular Pallas kernel `_tri_comb_kernel` (through
`counts_nibble_tri_self`, interpret mode on the CPU, as
tests/test_pallas_native.py runs it) and its XLA one-hot form
(`_nibble_mxu`). Counts are integers: tolerance zero. The CUDA kernel
itself is held against the plain version on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.ops.pallas_cmp import _nibble_mxu, counts_nibble_tri_self
from dashing2_tpu_torch.ops import nibble_comb as NC


def _packed(n: int, m: int, seed: int) -> np.ndarray:
    """(n, m/2) packed nibbles with an identical pair and constant rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint8)
    if n >= 2:
        a[n - 1] = a[0]          # identical rows
    if n >= 4:
        a[1] = 0x00              # all registers 0
        a[2] = 0xFF              # all registers 15
    return a


def _unpacked(a: np.ndarray) -> np.ndarray:
    # the JAX path's register order: lo nibbles, then hi nibbles
    return np.concatenate([a & 0xF, a >> 4], axis=1)


def _counts(a: np.ndarray, m: int):
    eq, gt = NC.tri_comb_counts(torch.from_numpy(a), m)
    assert eq.dtype == gt.dtype == torch.uint16
    assert eq.shape == gt.shape == (a.shape[0], a.shape[0])
    return eq.numpy().astype(np.int64), gt.numpy().astype(np.int64)


@pytest.mark.parametrize("n,m", [(300, 128), (512, 64), (300, 30),
                                 (63, 64), (2, 64)])
def test_plain_counts_match_pallas_comb_kernel(n, m):
    a = _packed(n, m, seed=n * 1000 + m)
    eq, gt = _counts(a, m)
    want_eq, want_gt, want_lt = counts_nibble_tri_self(
        jnp.asarray(_unpacked(a)), bm=128)
    np.testing.assert_array_equal(eq, np.asarray(want_eq))
    np.testing.assert_array_equal(gt, np.asarray(want_gt))
    np.testing.assert_array_equal(m - eq - gt, np.asarray(want_lt))


@pytest.mark.parametrize("m", [30, 64, 128])
@pytest.mark.parametrize("n", [1, 2, 63, 300])
def test_plain_counts_match_nibble_mxu(n, m):
    a = _packed(n, m, seed=7 + n * 1000 + m)
    eq, gt = _counts(a, m)
    u = jnp.asarray(_unpacked(a))
    want_eq, want_gt, _ = _nibble_mxu(u, u, want_gtlt=True)
    np.testing.assert_array_equal(eq, np.asarray(want_eq))
    np.testing.assert_array_equal(gt, np.asarray(want_gt))
    # the kernel's mirrored store: eq symmetric, gt^T is the lt count
    np.testing.assert_array_equal(eq, eq.T)
    np.testing.assert_array_equal(gt.T, m - eq - gt)
    assert (np.diag(eq) == m).all() and (np.diag(gt) == 0).all()


def test_constant_rows_count_every_register():
    """The all-15 row is greater than the all-0 row in every register."""
    m = 64
    eq, gt = _counts(_packed(8, m, seed=3), m)
    assert gt[2, 1] == m and gt[1, 2] == 0 and eq[1, 2] == 0


def test_cpu_tensor_takes_plain_version_without_launching():
    NC.reset_launches()
    a = torch.from_numpy(_packed(5, 64, seed=3))
    got = NC.tri_comb_counts(a, 64)
    want = NC.tri_comb_counts_plain(a, 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert NC.launches == 0


def test_wrapper_rejects_bad_inputs():
    a = torch.from_numpy(_packed(4, 64, seed=4))
    with pytest.raises(TypeError):
        NC.tri_comb_counts(a.to(torch.int16), 64)
    with pytest.raises(ValueError):
        NC.tri_comb_counts(a, 66)                    # m/2 != row bytes
    with pytest.raises(ValueError):
        NC.tri_comb_counts(a[:, ::2], 32)            # not contiguous
    with pytest.raises(ValueError):
        NC.tri_comb_counts(torch.zeros((2, 1 << 15), dtype=torch.uint8),
                           1 << 16)                  # u16 overflow
    with pytest.raises(ValueError):
        NC.tri_comb_counts(a.to("meta"), 64)         # neither cpu nor cuda
