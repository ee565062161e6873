"""The fragment bytes and the per-chunk decode of csrc/tri_comb.cu,
modelled on the CPU.

`combined_fragment_words` gives the u32 B words the kernel builds in
registers for each lane group t = lane & 3 of an mma.sync m16n8k32
fragment, `onehot_fragment_words` (ops/nibble_tri.py) its A words, and
`decode_partials` its decode. From seeded packed nibbles at m in {30, 62,
126, 128, 130, 1024}, rows are staged as the wrapper pads them (zero
bytes up to a 16-byte multiple) and reassembled from the words, byte
k = 32 j + 16 h + 4 t + q of a row being byte q of lane group t's word
for the nibble h of packed byte j:

* the B bytes of the m registers equal the JAX package's int8 combined
  operand `enc_combined_T` (transposed; -128 is the byte 0x80), with its
  register-major k = 16 r + v mapped to the packed order (r = j + h m/2);
* the product of the A rows (pad masked) and the B rows, taken chunk by
  chunk over the kernel's CHUNK packed bytes (read from its source) and
  decoded as the kernel decodes, is `tri_comb_counts_plain` (eq and gt),
  with the diagonal eq = m and gt = 0;
* CHUNK is at most 63 packed bytes (127 registers), and a chunk of 128
  equal registers decodes wrong, so the limit is real.

Integers throughout: tolerance zero.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.ops.pallas_cmp import enc_combined_T
from dashing2_tpu_torch.ops import nibble_comb as NC
from dashing2_tpu_torch.ops import nibble_tri as NT

MS = [30, 62, 126, 128, 130, 1024]


def _chunk_bytes() -> int:
    with open(NC.SOURCE) as f:
        found = re.findall(r"constexpr int CHUNK = (\d+);", f.read())
    assert len(found) == 1, found
    return int(found[0])


def _packed(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint8)
    a[n - 1] = a[0]
    a[1] = 0x00
    a[2] = 0xFF
    a[3] = 0x77
    return a


def _rows(packed: np.ndarray, word) -> np.ndarray:
    """(n, 32 rb) u8 rows as the kernel's fragments hold them, over the
    wrapper's 16-byte rows of rb bytes; word(nibbles, t, pad) gives the
    u32 words of lane group t."""
    n, mb = packed.shape
    rb = -(-mb // 16) * 16
    staged = np.zeros((n, rb), np.uint8)
    staged[:, :mb] = packed
    pad = (np.arange(rb) >= mb)[None, :]
    rows = np.zeros((n, rb, 2, 4, 4), np.uint8)       # (row, j, h, t, q)
    for h, nib in enumerate((staged & 0xF, staged >> 4)):
        for t in range(4):
            w = word(nib, t, pad)
            for q in range(4):
                rows[:, :, h, t, q] = (w >> (8 * q)) & 0xFF
    return rows.reshape(n, 32 * rb)


def _a_rows(packed):
    return _rows(packed, NT.onehot_fragment_words)


def _b_rows(packed):
    return _rows(packed, lambda nib, t, pad: NC.combined_fragment_words(nib, t))


def _chunked_counts(arows, brows, chunk: int):
    """The kernel's arithmetic: per chunk of `chunk` packed bytes
    (32 chunk k), partial = A B^T in s32, decoded and summed."""
    a = arows.astype(np.int64)
    b = brows.view(np.int8).astype(np.int64)
    n, k = a.shape
    eq = np.zeros((n, n), np.int64)
    gt = np.zeros((n, n), np.int64)
    for k0 in range(0, k, 32 * chunk):
        partial = a[:, k0:k0 + 32 * chunk] @ b[:, k0:k0 + 32 * chunk].T
        assert np.abs(partial).max() < 1 << 31
        e, g = NC.decode_partials(partial)
        eq += e
        gt += g
    return eq, gt


@pytest.mark.parametrize("m", MS)
def test_b_fragment_bytes_equal_enc_combined_T(m):
    n = 9
    a = _packed(n, m, seed=m)
    got = _b_rows(a)
    unpacked = np.concatenate([a & 0xF, a >> 4], axis=1)
    want = np.asarray(enc_combined_T(jnp.asarray(unpacked))).T  # (n, 16m)
    mb = m // 2
    # kernel byte 32 j + 16 h + v holds register j + h m/2, level v
    j, h, v = np.meshgrid(np.arange(mb), np.arange(2), np.arange(16),
                          indexing="ij")
    kern = (32 * j + 16 * h + v).reshape(-1)
    ref = (16 * (j + h * mb) + v).reshape(-1)
    np.testing.assert_array_equal(got[:, kern].view(np.int8),
                                  want[:, ref].astype(np.int8))
    # one 1 per register, at its level, and 0x80 at every level above
    regs = got[:, :32 * mb].reshape(n, m, 16)
    kernel_order = np.stack([a & 0xF, a >> 4], axis=2).reshape(n, m)
    assert ((regs == 1).sum(2) == 1).all()
    np.testing.assert_array_equal((regs == 0x80).sum(2), 15 - kernel_order)


@pytest.mark.parametrize("m", MS)
def test_chunk_products_decode_to_plain_counts(m):
    n = 40
    a = _packed(n, m, seed=2 * m)
    eq, gt = _chunked_counts(_a_rows(a), _b_rows(a), _chunk_bytes())
    want_eq, want_gt = NC.tri_comb_counts_plain(torch.from_numpy(a), m)
    np.testing.assert_array_equal(eq, want_eq.numpy().astype(np.int64))
    np.testing.assert_array_equal(gt, want_gt.numpy().astype(np.int64))
    assert (eq.diagonal() == m).all() and (gt.diagonal() == 0).all()
    assert gt[3, 1] == m and gt[1, 2] == 0 and gt[2, 3] == m  # 7 > 0, 15 > 7
    np.testing.assert_array_equal(gt.T, m - eq - gt)


def test_chunk_constant_is_at_most_63_packed_bytes():
    chunk = _chunk_bytes()
    assert 4 <= chunk <= 63 and chunk % 4 == 0
    with open(NC.SOURCE) as f:
        assert "static_assert(2 * CHUNK <= 127" in f.read()


@pytest.mark.parametrize("m", [256, 1024])
def test_128_register_chunk_of_equal_registers_decodes_wrong(m):
    """Rows whose registers are all equal give eq = 2 x chunk in every
    chunk: right at the kernel's chunk, wrong at 64 packed bytes."""
    a = np.full((4, m // 2), 0x55, np.uint8)
    a[2:] = 0xAA
    arows, brows = _a_rows(a), _b_rows(a)
    eq, gt = _chunked_counts(arows, brows, _chunk_bytes())
    assert eq[0, 1] == m and gt[0, 1] == 0 and gt[2, 0] == m
    eq, gt = _chunked_counts(arows, brows, 63)
    assert eq[0, 1] == m and gt[2, 0] == m
    eq, gt = _chunked_counts(arows, brows, 64)
    assert eq[0, 1] != m and gt[0, 1] != 0
    assert eq[0, 1] == 0 and gt[0, 1] == -(m // 128)
