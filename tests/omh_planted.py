"""Planted OrderMinHash streams for the port's tests (no jax here).

Each item is (kmers u64, occ int64, valid bool). Keys are planted by
inverting wanghash: position p gets, for register r, the key K when its
k-mer is wanghash^-1(K) ^ (r * G2 + SALT) ^ occ[p] * G1.

* ties: register 3 keys 2^54 + 2 (rounds half to even onto 2^54),
  2^54 + 1, 2^54 (exact), 2^54 + 1 and 2^54 + 6 (half to even onto
  2^54 + 8) at positions 5, 10, 20, 30, 35, an invalid window at 7 with
  key 5: the f64 ties go to the lower positions, 5 and 10;
* rounds-up: every key of register 0 rounds to 2^64 (2^64 - 1, 2^64 -
  1024, and keys between): both slots phantoms;
* one winner: register 0's only eligible key (2^64 - 1025, onto 2^64 -
  2048) at position 0, or at position 9: the phantom after, or before,
  the real winner;
* one valid window, no valid window, and a random stream of 3000
  positions with repeated k-mers.
"""

import numpy as np

from dashing2_tpu_torch import hashing as H
from dashing2_tpu_torch.ops.omh import _G1, _G2, _SALT

M64 = (1 << 64) - 1


def _key_word(r: int, key: int, occ: int) -> int:
    w = int(H.wanghash_inverse(np.uint64(key))) ^ ((r * _G2 + _SALT) & M64)
    return w ^ ((occ * _G1) & M64)


def _item(rng, n: int):
    kmers = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    occ = rng.integers(0, 3, n).astype(np.int64)
    return kmers, occ, np.ones(n, bool)


def planted_items(seed: int = 5):
    rng = np.random.default_rng(seed)
    items = []
    km, occ, va = _item(rng, 40)
    for p, key in ((5, (1 << 54) + 2), (10, (1 << 54) + 1),
                   (20, 1 << 54), (30, (1 << 54) + 1),
                   (35, (1 << 54) + 6), (7, 5)):
        km[p] = _key_word(3, key, int(occ[p]))
    va[7] = False
    items.append((km, occ, va))
    km, occ, va = _item(rng, 50)
    for p in range(50):
        key = (1 << 64) - (1024 if p == 49 else 1 + 21 * p)
        km[p] = _key_word(0, key, int(occ[p]))
    items.append((km, occ, va))
    for at in (0, 9):
        km, occ, va = _item(rng, 20)
        for p in range(20):
            key = (1 << 64) - 1025 if p == at else (1 << 64) - 1 - p
            km[p] = _key_word(0, key, int(occ[p]))
        items.append((km, occ, va))
    km, occ, va = _item(rng, 5)
    va[[0, 1, 3, 4]] = False
    items.append((km, occ, va))
    km, occ, va = _item(rng, 6)
    va[:] = False
    items.append((km, occ, va))
    km = rng.integers(0, 50, 3000).astype(np.uint64)
    occ = np.zeros(3000, np.int64)
    for v in np.unique(km):
        at = np.flatnonzero(km == v)
        occ[at] = np.arange(len(at))
    va = rng.random(3000) > 0.05
    items.append((km, occ, va))
    return items


def ragged(items):
    """(kmers, occ, valid, offsets) numpy arrays of the items back to
    back."""
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum([len(k) for k, _, _ in items], out=offsets[1:])
    return (np.concatenate([k for k, _, _ in items]),
            np.concatenate([o for _, o, _ in items]),
            np.concatenate([v for _, _, v in items]), offsets)
