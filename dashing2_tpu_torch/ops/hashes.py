"""Device (torch) forms of the 64-bit hash chain, in int64.

Port of the native-u64 forms of dashing2_tpu/ops/hashes.py (`wanghash`,
`maskfn`, `cehasher`, `oph_hash`, `css_item_hash`, `mulhi_u64`,
`wyhash64_step`, `u64_to_unit_float`). torch has few uint64 ops, so a u64 travels as the
int64 with the same bits: wrapping `*`, `+`, `^`, `~` and `<<` give the
same bits in two's complement; a logical right shift masks off the sign
bits the arithmetic shift copies in (`srl`); the high word of a 64x64
product is built from 32-bit limbs (`mulhi_u64`); and the unsigned value
becomes an f64 in one rounding (`u64_to_unit_float`). Every function
runs on whatever device its tensor lies on, the same code on the CPU and
on the card (tests/test_torch_fss.py holds them bit for bit against
dashing2_tpu_torch.hashing and the JAX package).
"""

from __future__ import annotations

import functools

import torch

from .. import hashing as H

_M32 = 0xFFFFFFFF


def s64(x: int) -> int:
    """The int64 with the bits of the u64 `x`."""
    x &= 0xFFFFFFFFFFFFFFFF
    return x - (1 << 64) if x >> 63 else x


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def wanghash(x: torch.Tensor) -> torch.Tensor:
    x = (~x) + (x << 21)
    x = x ^ srl(x, 24)
    x = x * 265
    x = x ^ srl(x, 14)
    x = x * 21
    x = x ^ srl(x, 28)
    return x + (x << 31)


def wanghash_(x: torch.Tensor) -> torch.Tensor:
    """wanghash in place (x is overwritten and returned): the card's
    FullSetSketch draws run it over (items, rows, m) tensors."""
    y = x << 21
    x.bitwise_not_().add_(y)
    del y
    for s, mul in ((24, 265), (14, 21), (28, 1)):
        x.bitwise_xor_(srl(x, s))
        if mul != 1:
            x.mul_(mul)
    return x.add_(x << 31)


def maskfn(x: torch.Tensor, xormask: int = H.XORMASK) -> torch.Tensor:
    """WangHash(x ^ XORMASK): the global k-mer scrambler (enums.h:136)."""
    return wanghash(x ^ s64(xormask))


@functools.lru_cache(maxsize=None)
def oph_xor(seed: int = H.OPH_DEFAULT_SEED) -> int:
    """The u64 the OPH bucket hash xors in before its WangHash (cached:
    the Mersenne Twister's first draw costs about 0.1 ms in Python, once
    a seed rather than once a kernel launch)."""
    return H.mt19937_64_first(seed) ^ H.CEIXOR_OPH


def oph_hash(x: torch.Tensor, seed: int = H.OPH_DEFAULT_SEED
             ) -> torch.Tensor:
    """OPH bucket hash (oph.h:55-89): WangHash(x ^ mt_seed ^ CEIXOR)."""
    return wanghash(x ^ s64(oph_xor(seed)))


def u64_lt(a: torch.Tensor, b) -> torch.Tensor:
    """a < b in the unsigned order of the u64 bits held in int64."""
    flip = -(1 << 63)
    if isinstance(b, int):
        return (a ^ flip) < s64(b ^ (1 << 63))
    return (a ^ flip) < (b ^ flip)


def cehasher(x: torch.Tensor) -> torch.Tensor:
    return ((x ^ s64(H.CEH_A)) * s64(H.CEH_B)) ^ s64(H.CEH_C)


def css_item_hash(ids: torch.Tensor) -> torch.Tensor:
    """CSetSketch per-item RNG seed (setsketch.h:375)."""
    return cehasher(ids ^ s64(H.CSS_XOR))


def mulhi_u64(a: torch.Tensor, b: int) -> torch.Tensor:
    """High 64 bits of the full product of u64 `a` and the constant `b`,
    from 32-bit limbs (each limb product fits 64 unsigned bits, which
    int64 holds with wrap-around)."""
    a0, a1 = a & _M32, srl(a, 32)
    b0, b1 = b & _M32, b >> 32
    p00, p01, p10, p11 = a0 * b0, a0 * s64(b1), a1 * s64(b0), a1 * s64(b1)
    mid = srl(p00, 32) + (p10 & _M32) + (p01 & _M32)
    return p11 + srl(p10, 32) + srl(p01, 32) + srl(mid, 32)


def wyhash64_step(seed: torch.Tensor):
    """One wyhash64_stateless step; returns (new_seed, output)."""
    seed = seed + s64(H.WY_INC)
    m1 = mulhi_u64(seed, H.WY_M1) ^ (seed * s64(H.WY_M1))
    return seed, mulhi_u64(m1, H.WY_M2) ^ (m1 * s64(H.WY_M2))


def u64_mod(x: torch.Tensor, m: int) -> torch.Tensor:
    """x mod m of the u64 `x`, for 1 <= m < 2^31."""
    if m & (m - 1) == 0:
        return x & (m - 1)
    hi, lo = srl(x, 32), x & _M32
    return ((hi % m) * ((1 << 32) % m) + lo % m) % m


def u64_to_unit_float(x: torch.Tensor) -> torch.Tensor:
    """x * 2^-64 in f64, as C++ `double(x) * 0x1p-64`: the high word
    times 2^32 is exact, the sum with the low word rounds once (to
    nearest, ties to even), so the f64 is the u64's correctly rounded
    value; the power-of-two scale is exact."""
    hi = srl(x, 32).to(torch.float64) * 4294967296.0
    return (hi + (x & _M32).to(torch.float64)) * (2.0 ** -64)
