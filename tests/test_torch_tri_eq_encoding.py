"""The one-hot fragment bytes of csrc/tri_eq.cu, modelled on the CPU.

`onehot_fragment_words` gives the u32 words the kernel builds in
registers for each lane group t = lane & 3 of an mma.sync m16n8k32
fragment. From seeded packed nibbles at m in {30, 62, 1024}, rows are
staged as the wrapper pads them (zero bytes up to a 16-byte multiple) and
reassembled from the words, byte k = 32 j + 16 h + 4 t + q of a row being
byte q of lane group t's word for the nibble h of packed byte j:

* the bytes of the m registers equal the JAX package's int8 one-hot
  operand `enc_onehot_T` (transposed), with its register-major
  k = 16 r + v mapped to the packed order (r = j + h m/2);
* every A-side word of a pad register is zero, for every t;
* the product of the A rows (pad masked) and the B rows (pad bytes zero,
  unmasked) is `tri_eq_counts_plain`, with the diagonal m.

Integers throughout: tolerance zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.ops.pallas_cmp import enc_onehot_T
from dashing2_tpu_torch.ops import nibble_tri as NT

MS = [30, 62, 1024]


def _packed(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint8)
    a[n - 1] = a[0]
    a[1] = 0x00
    a[2] = 0xFF
    return a


def _rows(packed: np.ndarray, m: int, mask_pad: bool) -> np.ndarray:
    """(n, 32 rb) u8 one-hot rows as the kernel's fragments hold them,
    over the wrapper's 16-byte rows of rb bytes."""
    n, mb = packed.shape
    rb = -(-mb // 16) * 16
    staged = np.zeros((n, rb), np.uint8)
    staged[:, :mb] = packed
    pad = (np.arange(rb) >= mb)[None, :] & mask_pad
    rows = np.zeros((n, rb, 2, 4, 4), np.uint8)       # (row, j, h, t, q)
    for h, nib in enumerate((staged & 0xF, staged >> 4)):
        for t in range(4):
            w = NT.onehot_fragment_words(nib, t, pad)
            for q in range(4):
                rows[:, :, h, t, q] = (w >> (8 * q)) & 0xFF
    return rows.reshape(n, 32 * rb)


@pytest.mark.parametrize("m", MS)
def test_fragment_bytes_equal_enc_onehot_T(m):
    n = 9
    a = _packed(n, m, seed=m)
    got = _rows(a, m, mask_pad=True)
    unpacked = np.concatenate([a & 0xF, a >> 4], axis=1)
    want = np.asarray(enc_onehot_T(jnp.asarray(unpacked))).T   # (n, 16m)
    mb = m // 2
    # kernel byte 32 j + 16 h + v holds register j + h m/2, level v
    j, h, v = np.meshgrid(np.arange(mb), np.arange(2), np.arange(16),
                          indexing="ij")
    kern = (32 * j + 16 * h + v).reshape(-1)
    ref = (16 * (j + h * mb) + v).reshape(-1)
    np.testing.assert_array_equal(got[:, kern], want[:, ref].astype(np.uint8))
    assert (got[:, :32 * mb].reshape(n, m, 16).sum(2) == 1).all()


@pytest.mark.parametrize("m", MS)
def test_pad_registers_give_zero_words(m):
    mb = m // 2
    rb = -(-mb // 16) * 16
    nibs = np.arange(16)
    for t in range(4):
        assert (NT.onehot_fragment_words(nibs, t, pad=True) == 0).all()
        live = NT.onehot_fragment_words(nibs, t)
        assert (live != 0).sum() == 4           # nibbles 4t..4t+3
    rows = _rows(_packed(5, m, seed=m + 1), m, mask_pad=True)
    assert (rows[:, 32 * mb:] == 0).all()
    assert rows.shape[1] == 32 * rb


@pytest.mark.parametrize("m", MS)
def test_fragment_product_is_plain_eq_counts(m):
    n = 40
    a = _packed(n, m, seed=2 * m)
    arows = _rows(a, m, mask_pad=True).astype(np.int64)
    brows = _rows(a, m, mask_pad=False).astype(np.int64)
    if m % 32:
        # the B side alone counts its zero pad nibbles as matches
        assert (brows @ brows.T).diagonal().min() > m
    eq = arows @ brows.T
    want = NT.tri_eq_counts_plain(torch.from_numpy(a), m).numpy()
    np.testing.assert_array_equal(eq, want.astype(np.int64))
    assert (eq.diagonal() == m).all()
