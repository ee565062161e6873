"""Port parity: ops/nibble_tri.py against the JAX package's nibble
eq-count engines.

The same seeded packed registers go to the port's `tri_eq_counts` (on
CPU tensors: its plain PyTorch version) and to the JAX package's
triangular Pallas kernel (`eq_nibble_tri_self`, interpret mode on the
CPU) and its XLA one-hot form (`_nibble_mxu`). Counts are integers:
tolerance zero. The CUDA kernel itself is held against the plain version
on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.ops.pallas_cmp import _nibble_mxu, eq_nibble_tri_self
from dashing2_tpu_torch.ops import nibble_tri as NT


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


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("n", [1, 2, 63, 300])
def test_plain_counts_match_pallas_tri_kernel(n, m):
    a = _packed(n, m, seed=n * 1000 + m)
    got = NT.tri_eq_counts(torch.from_numpy(a), m)
    assert got.dtype == torch.uint16 and got.shape == (n, n)
    want = np.asarray(eq_nibble_tri_self(jnp.asarray(_unpacked(a)), bm=128))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("n", [1, 2, 63, 300])
def test_plain_counts_match_nibble_mxu(n, m):
    a = _packed(n, m, seed=7 + n * 1000 + m)
    got = NT.tri_eq_counts(torch.from_numpy(a), m)
    u = jnp.asarray(_unpacked(a))
    want, _, _ = _nibble_mxu(u, u, want_gtlt=False)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want))
    assert (np.diag(got.numpy()) == m).all()


def test_cpu_tensor_takes_plain_version_without_launching():
    NT.reset_launches()
    a = torch.from_numpy(_packed(5, 64, seed=3))
    assert torch.equal(NT.tri_eq_counts(a, 64), NT.tri_eq_counts_plain(a, 64))
    assert NT.launches == 0


def test_wrapper_rejects_bad_inputs():
    a = torch.from_numpy(_packed(4, 64, seed=4))
    with pytest.raises(TypeError):
        NT.tri_eq_counts(a.to(torch.int16), 64)
    with pytest.raises(ValueError):
        NT.tri_eq_counts(a, 66)                      # m/2 != row bytes
    with pytest.raises(ValueError):
        NT.tri_eq_counts(a[:, ::2], 32)              # not contiguous
    with pytest.raises(ValueError):
        NT.tri_eq_counts(torch.zeros((2, 1 << 15), dtype=torch.uint8),
                         1 << 16)                    # u16 overflow
    with pytest.raises(ValueError):
        NT.tri_eq_counts(a.to("meta"), 64)           # neither cpu nor cuda


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dashing2_tpu_torch.device import resolve
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve("cuda")
