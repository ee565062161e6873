"""Host-side (numpy) 64-bit hash functions: the ground truth.

Whole copy of dashing2_tpu/hashing.py (numpy only; the port never
imports the JAX package). These replicate the hash chain the reference
applies to k-mers, validated against the published algorithms.

Functions and constants:
- Thomas Wang's 64-bit mix (invertible), used as ``sketch::hash::WangHash``
  (reference call sites: src/enums.h:136-153 maskfn/invmaskfn).
- XORMASK global k-mer scrambler + seed_mask (src/enums.cpp:131-140).
- CEI invertible mixers (xor / multiply fusions) used by the OPH bucket
  hasher (src/oph.h:44-89 BHasher/DHasher) and the CSetSketch item RNG
  (src/setsketch.h:375 — CEHasher; the bonsai `sketch` submodule is absent
  from the reference checkout, so the fused constant chain is reconstructed
  from the commented-out alias in src/oph.h:36-40).
- wyhash64 stateless PRNG step (aesctr/wy.h API, used for densification
  src/cmp_core.cpp:594-597, downsampling src/d2.h:176-179, register→sig
  hashing).
- std::mt19937_64 first-output (DHasher seed derivation, src/oph.h:59).

All array functions take/return ``np.uint64`` arrays and wrap modulo 2^64.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
_M64 = (1 << 64) - 1

# Global k-mer xor mask (enums.cpp:131-132).
XORMASK = 0x724526E320F9967D
XORMASK2_HI = 12499408336417088522  # == 0xAD7A27DF55DBCC0A

# OPH constants (oph.h:46, :142).
CEIXOR_OPH = 0x533F8C2151B20F97
OPH_DEFAULT_SEED = 0x321B919A61CB41F7

# CEHasher fused chain (see module docstring).
CEH_A = 0x533F8C2151B20F97
CEH_B = 0x9A98567ED20C127D
CEH_C = 0x691A9D706391077A

# CSetSketch item-hash xor constant (setsketch.h:375).
CSS_XOR = 0xB2069FC679A8DA0B

# reg2sig xor constant (cmp_core.cpp:23-27).
REG2SIG_XOR = 0x0A3407FB23CD20EF

# densify rng offset (cmp_core.cpp:594).
DENSIFY_OFFSET = 0x05BF2B8BDF07C06C

# wyhash64 constants (wy.h / lemire testingRNG wyhash64).
WY_INC = 0x60BEE2BEE120FC15
WY_M1 = 0xA3B195354A39B70D
WY_M2 = 0x1B03738712FAD5C9


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=U64)


def _inv_mult(c: int) -> int:
    return pow(c, -1, 1 << 64)


def _invert_xorshift_right(y: np.ndarray, s: int) -> np.ndarray:
    x = y.copy()
    for _ in range(-(-64 // s)):
        x = y ^ (x >> U64(s))
    return x


def wanghash(x) -> np.ndarray:
    """Thomas Wang's 64-bit integer hash (invertible)."""
    x = _u64(x)
    with np.errstate(over="ignore"):
        x = (~x) + (x << U64(21))
        x = x ^ (x >> U64(24))
        x = (x + (x << U64(3))) + (x << U64(8))  # * 265
        x = x ^ (x >> U64(14))
        x = (x + (x << U64(2))) + (x << U64(4))  # * 21
        x = x ^ (x >> U64(28))
        x = x + (x << U64(31))
    return x


_INV_2P31P1 = _inv_mult((1 << 31) + 1)
_INV_21 = _inv_mult(21)
_INV_265 = _inv_mult(265)
_INV_2P21M1 = _inv_mult((1 << 21) - 1)


def wanghash_inverse(y) -> np.ndarray:
    y = _u64(y)
    with np.errstate(over="ignore"):
        x = y * U64(_INV_2P31P1)              # invert x += x << 31
        x = _invert_xorshift_right(x, 28)
        x = x * U64(_INV_21)                  # invert x *= 21
        x = _invert_xorshift_right(x, 14)
        x = x * U64(_INV_265)                 # invert x *= 265
        x = _invert_xorshift_right(x, 24)
        # invert x = (~x0) + (x0 << 21)  ==  x0 * (2^21 - 1) - 1
        x = (x + U64(1)) * U64(_INV_2P21M1)
    return x


def maskfn(x, xormask: int = XORMASK) -> np.ndarray:
    """The global invertible k-mer scrambler: WangHash(x ^ XORMASK)
    (enums.h:136-140)."""
    return wanghash(_u64(x) ^ U64(xormask))


def invmaskfn(y, xormask: int = XORMASK) -> np.ndarray:
    return wanghash_inverse(y) ^ U64(xormask)


def seed_mask(seed: int) -> tuple[int, int]:
    """Derive (XORMASK, XORMASK2_HI) from a user seed (enums.cpp:133-140).

    seed == 0 disables masking entirely.
    """
    if seed == 0:
        return 0, 0
    lo = int(wanghash(np.uint64(seed)))
    hi = int(wanghash(np.uint64(lo)))
    return lo, hi


def cehasher(x) -> np.ndarray:
    """Fused invertible mixer: ((x ^ A) * B) ^ C."""
    x = _u64(x)
    with np.errstate(over="ignore"):
        return ((x ^ U64(CEH_A)) * U64(CEH_B)) ^ U64(CEH_C)


_INV_CEH_B = _inv_mult(CEH_B)


def cehasher_inverse(y) -> np.ndarray:
    y = _u64(y)
    with np.errstate(over="ignore"):
        return ((y ^ U64(CEH_C)) * U64(_INV_CEH_B)) ^ U64(CEH_A)


def mt19937_64_first(seed: int) -> int:
    """First output of std::mt19937_64 seeded with `seed` (oph.h:59)."""
    n = 312
    mt = [0] * n
    mt[0] = seed & _M64
    f = 6364136223846793005
    for i in range(1, n):
        mt[i] = (f * (mt[i - 1] ^ (mt[i - 1] >> 62)) + i) & _M64
    # one twist step producing state[0]'s successor
    mm = 156
    matrix_a = 0xB5026F5AA96619E9
    upper = 0xFFFFFFFF80000000
    lower = 0x7FFFFFFF
    x = (mt[0] & upper) | (mt[1] & lower)
    xA = x >> 1
    if x & 1:
        xA ^= matrix_a
    y = mt[mm] ^ xA
    # temper
    y ^= (y >> 29) & 0x5555555555555555
    y ^= (y << 17) & 0x71D67FFFEDA60000
    y ^= (y << 37) & 0xFFF7EEE000000000
    y ^= y >> 43
    return y & _M64


def oph_hash(x, seed: int = OPH_DEFAULT_SEED) -> np.ndarray:
    """The OPH bucket hasher DHasher (oph.h:55-89):
    WangHash(CEIXOR(x ^ mt19937_64(seed)())) with CEIXOR constant
    0x533f8c2151b20f97."""
    s = mt19937_64_first(seed)
    return wanghash(_u64(x) ^ U64(s) ^ U64(CEIXOR_OPH))


def oph_hash_inverse(y, seed: int = OPH_DEFAULT_SEED) -> np.ndarray:
    s = mt19937_64_first(seed)
    return wanghash_inverse(_u64(y)) ^ U64(CEIXOR_OPH) ^ U64(s)


def wyhash64_step(seed) -> tuple[np.ndarray, np.ndarray]:
    """One wyhash64_stateless step. Returns (new_seed, output)."""
    seed = _u64(seed)
    with np.errstate(over="ignore"):
        seed = seed + U64(WY_INC)
        hi, lo = _mul64(seed, U64(WY_M1))
        m1 = hi ^ lo
        hi, lo = _mul64(m1, U64(WY_M2))
        return seed, hi ^ lo


def _mul64(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Full 64x64 -> 128 multiply via 32-bit halves; returns (hi, lo)."""
    a = _u64(a)
    b = _u64(b)
    mask = U64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        a0 = a & mask
        a1 = a >> U64(32)
        b0 = b & mask
        b1 = b >> U64(32)
        p00 = a0 * b0
        p01 = a0 * b1
        p10 = a1 * b0
        p11 = a1 * b1
        mid = (p00 >> U64(32)) + (p10 & mask) + (p01 & mask)
        lo = (p00 & mask) | (mid << U64(32))
        hi = p11 + (p10 >> U64(32)) + (p01 >> U64(32)) + (mid >> U64(32))
    return hi, lo


def mulhi64(a, b) -> np.ndarray:
    return _mul64(a, b)[0]


def reg2sig(reg_bits) -> np.ndarray:
    """Hash a register's raw 64-bit pattern to a signature
    (cmp_core.cpp:19-37, 8-byte RegT case)."""
    return wanghash(_u64(reg_bits) ^ U64(REG2SIG_XOR))


def css_item_hash(ids) -> np.ndarray:
    """First RNG value the CSetSketch derives from an item
    (setsketch.h:375)."""
    return cehasher(_u64(ids) ^ U64(CSS_XOR))
