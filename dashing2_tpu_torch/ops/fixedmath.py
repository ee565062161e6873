"""The port's own f32 `log`/`exp` and f64 `log`: fixed sequences of IEEE
operations, so that one input gives one output on every device.

A library's transcendental functions differ between devices and even
between code paths of one device: CUDA's `logf` and torch's CPU `log`
disagree in the last bit, and which of its implementations torch's CPU
kernel takes can depend on the tensor's layout and the process's state.
Registers chosen as an argmin over keys built from them would then depend
on where they were computed. The functions here are written out as
range reduction, polynomial and reconstruction, each step one rounded
IEEE operation of the stated width; every fused multiply-add is explicit
(`fma32`), so the bits are the same in eager torch on the CPU or the
card and in csrc/weighted_draws.cu, which repeats the same sequence with
`__fmaf_rn`/`__fmul_rn`/`__fadd_rn` (nvcc would otherwise contract).

* `log32` and `exp32` are the sequences XLA's CPU backend emits for
  f32 `log` and `exp` (Eigen's `plog_float` with its split x^3
  polynomial, and the Cephes-form `pexp_float`), with the multiply-adds
  LLVM contracts there (a product with one use added to something);
  they give `jnp.log`/`jnp.exp` bit for bit on the JAX CPU backend
  (tests/test_torch_weighted.py, over 10^7 values of the weighted
  sketches' operand ranges). XLA's CPU runtime flushes subnormal
  results to zero; these do not, so `exp32` of x < -87.33 (a subnormal
  result) differs. The weighted sketches never reach it.
* `log64` is fdlibm's `__ieee754_log` (no table; within an ulp of the C
  library's log), the f64 log of the CSetSketch draws
  (ops/sketch_kernels.py). The JAX package's XLA calls the C library's
  `log` there, so registers stay within a few ulp of it; what this
  gives is that the port's own registers no longer depend on the device
  or the process (torch's CPU log did, and broke the order of equal
  draws across items).
"""

from __future__ import annotations

import numpy as np
import torch

f32 = torch.float32
f64 = torch.float64


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """f32 fused multiply-add fma(a, b, c) of f32 values, correctly
    rounded, in eager torch on any device. The product of two f32 values
    is exact in f64, and the f64 sum s rounds once. Rounding s to f32
    gives the exact a*b + c's f32 unless s landed exactly on an f32
    rounding boundary (a midpoint between two f32 values, or below the
    f32 normals, where the boundaries sit elsewhere): only there, TwoSum
    gives the sum's rounding error, and rounding s to odd (moving an
    inexact s with an even last bit one f64 ulp towards the exact value)
    makes the one f32 rounding that of a*b + c (53 >= 24 + 2 bits). Every
    step is one IEEE f64 operation, so the bits do not depend on the
    device."""
    a, b, c = (x.to(f64) for x in (a, b, c))
    p = a * b
    s = p + c
    tie = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) \
        | (s.abs() < 2.0 ** -126)
    if bool(tie.any()):
        z = s - p
        err = (p - (s - z)) + (c - z)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                             torch.full_like(s, float("-inf")))
        s = torch.where(tie & (err != 0) & even, torch.nextafter(s, toward),
                        s)
    return s.to(f32)


def _c32(bits: int) -> float:
    """The f32 with these bits, as a Python float (exact)."""
    return float(np.array(bits, np.uint32).view(np.float32))


# log32: Eigen plog_float's constants, by their bits
_MIN_NORMAL = _c32(0x00800000)
_SQRTHF = _c32(0x3F3504F3)
_LOG_P = [_c32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,
                            0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
                            0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LN2_HI = _c32(0x3F318000)          # 0.693359375, 9 significant bits
_LN2_LO = _c32(0xB95E8083)          # -2.12194440e-4
# exp32: Cephes pexp_float's
_EXP_LO, _EXP_HI = _c32(0xC2AF999A), _c32(0x42B1999A)   # -87.8, 88.8
_LOG2E = _c32(0x3FB8AA3B)
_EXP_P = [_c32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908,
                            0x3D2AA9C1, 0x3E2AAAAA)]


def _k(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, x)


# elements of a CPU tensor these functions evaluate at once: torch runs
# an op of at most 32768 elements on one thread, so processes that share
# the cores (test workers) do not wait on each other's thread barriers (a
# larger chunk ran 100x slower in six such processes), and the
# intermediates stay in the caches; the card takes the whole tensor
_CPU_CHUNK = 1 << 15


def _chunked(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over a contiguous x, in chunks of _CPU_CHUNK elements on the CPU
    (elementwise, so the same bits)."""
    x = x.contiguous()
    if x.device.type != "cpu" or x.numel() <= _CPU_CHUNK:
        return fn(x)
    flat = x.view(-1)
    out = torch.empty_like(flat)
    for s in range(0, flat.numel(), _CPU_CHUNK):
        out[s:s + _CPU_CHUNK] = fn(flat[s:s + _CPU_CHUNK])
    return out.view(x.shape)


def log32(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log, XLA's CPU sequence (`_log32`)."""
    return _chunked(_log32, x.to(f32))


def exp32(x: torch.Tensor) -> torch.Tensor:
    """f32 natural exp, XLA's CPU sequence (`_exp32`)."""
    return _chunked(_exp32, x.to(f32))


def _log32(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log, XLA's CPU sequence. x < 0 or NaN gives NaN, 0
    gives -inf, +inf gives +inf; a subnormal x is taken as the smallest
    normal (XLA's runtime reads it as 0)."""
    xc = torch.where(x > _MIN_NORMAL, x, _k(_MIN_NORMAL, x))
    bits = xc.view(torch.int32)
    # exponent and mantissa in [0.5, 1)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    mant = ((bits & -2139095041) | 0x3F000000).view(f32)
    small = mant < _SQRTHF
    t = mant - 1.0
    e = e - small.to(f32)
    t = t + torch.where(small, mant, torch.zeros_like(mant))
    t2 = t * t
    t3 = t2 * t
    p = _LOG_P
    y = fma32(t, _k(p[0], t), _k(p[1], t))
    y1 = fma32(t, _k(p[3], t), _k(p[4], t))
    y2 = fma32(t, _k(p[6], t), _k(p[7], t))
    y = fma32(y, t, _k(p[2], t))
    y1 = fma32(y1, t, _k(p[5], t))
    y2 = fma32(y2, t, _k(p[8], t))
    y = fma32(y, t3, y1)
    y = fma32(y, t3, y2)
    y = fma32(y, t3, e * _LN2_LO)
    # 0.5 t^2 and ln2_hi e are exact products, so these two multiply-adds
    # (fused in XLA's code) round once either way
    r = (t - 0.5 * t2) + y
    r = r + _LN2_HI * e
    r = torch.where(x > 0, r, _k(float("nan"), r))
    r = torch.where(x == 0, _k(float("-inf"), r), r)
    return torch.where(x == float("inf"), x, r)


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """f32 natural exp, XLA's CPU sequence: x clamped to [-87.8, 88.8],
    n = floor(x log2(e) + 1/2) clamped to [-127, 127], a degree-7
    polynomial of the reduced argument, times 2^n built from its bits
    (NaN stays NaN)."""
    x = torch.where(x < _EXP_LO, _k(_EXP_LO, x), x)
    x = torch.where(x > _EXP_HI, _k(_EXP_HI, x), x)
    n = torch.floor(fma32(x, _k(_LOG2E, x), _k(0.5, x)))
    n = n.clamp(-127.0, 127.0)
    # ln2_hi n is exact (9 + 7 bits), the subtraction rounds once
    z = x - _LN2_HI * n
    z = fma32(-_k(_LN2_LO, n), n, z)
    p = _EXP_P
    y = fma32(z, _k(p[0], z), _k(p[1], z))
    for c in p[2:] + [0.5]:
        y = fma32(y, z, _k(c, z))
    y = fma32(y, z * z, z) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(f32)
    return y * pow2


# log64: fdlibm e_log.c
_LN2_HI64 = 6.93147180369123816490e-01     # 3fe62e42 fee00000
_LN2_LO64 = 1.90821492927058770002e-10     # 3dea39ef 35793c76
_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)


def log64(x: torch.Tensor) -> torch.Tensor:
    """f64 natural log of positive, normal, finite f64 values (the
    CSetSketch draws clamp theirs to at least 1e-300) (`_log64`)."""
    return _chunked(_log64, x.to(f64))


def _log64(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's `__ieee754_log` as one branch-free sequence of IEEE f64
    operations:
    x = 2^k (1 + f) with 1 + f in [sqrt(2)/2, sqrt(2)), s = f / (2 + f),
    a degree-14 polynomial in s, and k ln2 added in two parts. fdlibm's
    shortcuts for k = 0, f = 0 and |f| < 2^-20 are left out: the first
    two give the same bits as the general form, the last is within an
    ulp of it (tests/test_torch_weighted.py holds the result within an
    ulp of the C library's log)."""
    bits = x.view(torch.int64)
    hx = bits >> 32
    k = (hx >> 20) - 1023
    hx &= 0x000FFFFF
    i = (hx + 0x95F64) & 0x100000
    k += i >> 20
    # x or x/2, normalised into [sqrt(2)/2, sqrt(2)), minus 1
    f = (((hx | (i ^ 0x3FF00000)) << 32) | (bits & 0xFFFFFFFF)).view(f64)
    f -= 1.0
    big = ((hx - 0x6147A) | (0x6B851 - hx)) > 0
    del bits, i, hx
    dk = k.to(f64)
    del k
    s = f / (f + 2.0)
    z = s * s
    w = z * z
    R = z * (_LG[0] + w * (_LG[2] + w * (_LG[4] + w * _LG[6])))
    R += w * (_LG[1] + w * (_LG[3] + w * _LG[5]))
    del z, w
    lo = dk * _LN2_LO64
    hfsq = 0.5 * f * f
    # |f| >= 0.1716 or so: f - (hfsq - s (hfsq + R)); else f - s (f - R)
    r = torch.where(big, hfsq - (s * (hfsq + R) + lo), s * (f - R) - lo)
    return dk * _LN2_HI64 - (r - f)
