"""Estimators on integer register-count tensors, in torch.

Port of dashing2_tpu/cmp/estimators.py's f32 estimators, every measure:

* `bbit_measures32` for b-bit registers of every width (eq counts);
* `compressed_ab_measures32` for SetSketch a/b-quantised registers (gt
  and lt counts; nibbles in the product form, u8/u16/u32 in the
  complement form), with the host constants it needs
  (`optimal_parameters`, `gb_bit_table`, `ab_tables`) and `fma32`;
* `full_setsketch_measures32` for full 64-bit registers (gt and lt
  counts, the default mode);
* `equality_measures32` for full registers compared for equality (eq
  counts, `--bbit-sigs` without `--fastcmp`).

Each follows one JAX route by its `fused` flag: fused=True the jitted
self-pairs route (64 <= n <= SELF_MAX), where XLA rewrites a division by
a constant into a product with its f32 reciprocal and contracts some
adds of products into fused multiply-adds; fused=False the numpy route
(n < 64, and n > SELF_MAX on the CPU), where every f32 operation rounds.
A division by a per-pair value is IEEE division on every route.

The measures other than SIMILARITY and POISSON_LLR take the pair's f32
cardinalities: lh (the row item) and rh (the column item), broadcast
against the counts. The reference's asymmetric quirk is kept: full
registers divide CONTAINMENT by the column's cardinality, the
compressed and equality estimators by the row's. POISSON_LLR depends on
the counts alone; its f32 `log1p` is `log1p32`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..enums import Measure

# the largest f32: NaN and inf values are emitted as it (cmp_core.cpp:573)
FINF = float(np.finfo(np.float32).max)

CARD_MEASURES = (Measure.INTERSECTION, Measure.UNION_SIZE,
                  Measure.CONTAINMENT, Measure.SYMMETRIC_CONTAINMENT)


def _const(x: float, dev: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _finite(ret: torch.Tensor) -> torch.Tensor:
    """NaN and inf -> FINF."""
    return torch.where(torch.isfinite(ret), ret, _const(FINF, ret.device))


def _cards(measure: Measure, lh, rh, dev: torch.device):
    """The pair's cardinalities as f32 tensors on `dev` (None for the
    measures that do not read them)."""
    if measure not in CARD_MEASURES:
        return None, None
    if lh is None or rh is None:
        raise ValueError(f"{measure.name} needs the pair's cardinalities")
    return (torch.as_tensor(lh).to(dev, torch.float32),
            torch.as_tensor(rh).to(dev, torch.float32))


def _check_measure(measure: Measure) -> None:
    if measure not in CARD_MEASURES + (Measure.SIMILARITY,
                                        Measure.POISSON_LLR):
        raise ValueError(f"measure {measure.name} invalid here")


def log1p32(x: torch.Tensor, fused: bool) -> torch.Tensor:
    """f32 log1p of f32 values, on the host, as one JAX route has it:

    * fused=False, its numpy route: numpy's own f32 `np.log1p`, which is
      that route's function on its own inputs (bit for bit);
    * fused=True, its jitted route: XLA's CPU log1p is its own
      approximation, which neither numpy nor torch reproduces; the port
      takes the f64 log1p rounded once to f32, within 2 ulp of both JAX
      routes (README "Documented deviations"; tests/test_torch_measures.py
      holds the bound).

    The epilogues call it only to build tables over the counts on the
    host (cmp/core.py::measure_table), so the card gathers these bits."""
    a = x.detach().cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        y = (np.log1p(a.astype(np.float64)).astype(np.float32) if fused
             else np.log1p(a))
    return torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(x.device)


def _poisson(ok: torch.Tensor, arg: torch.Tensor, k: int,
             fused: bool) -> torch.Tensor:
    """where(ok, log1p(arg) * f32(-1/k), inf)."""
    pm = _const(float(np.float32(-1.0 / max(1, k))), arg.device)
    return torch.where(ok, log1p32(arg, fused) * pm,
                       _const(float("inf"), arg.device))


def bbit_measures32(eqc: torch.Tensor, m: int, fd_level: float,
                    measure: Measure, fused: bool = True, lh=None, rh=None,
                    k: int = 31) -> torch.Tensor:
    """f32 b-bit estimator of integer eq counts with the JAX package's
    bits. The JAX source writes sim = max(0, (eqc * 2^b - m) / den) with
    den = f32(m * (2^b - 1)); which bits come out depends on the route:

    * fused=True, its jitted routes (the self-pairs routes and the
      counts-pull table, 64 <= n <= SELF_MAX): den is a constant of the
      traced graph and XLA's algebraic simplifier rewrites the division
      into a multiplication by its f32 reciprocal, which differs from
      the IEEE quotient by one ulp for about 60% of counts. The port
      computes that product: r = f32(1 / den) is one IEEE division on
      the host, and the multiply is one correctly rounded operation;
    * fused=False, its numpy epilogue (the generic row-block route:
      n < 64, and n > SELF_MAX on its CPU backend): one IEEE f32
      division by den.

    eqc * 2^b is exact (a power-of-two scale), so eqc * 2^b - m is one
    correctly rounded subtraction on every route (a fused multiply-add
    gives the same), and the product or quotient is one more; eager
    torch gives the same bits on the CPU and on the card.

    The cardinality measures divide (lh + rh) by 1 + sim, per pair;
    POISSON_LLR takes log1p((sim - 1) / (1 + sim)), with sim - 1 from
    the exact integer (eqc - m) * 2^b."""
    _check_measure(measure)
    bits = int(fd_level * 8)
    den = np.float32(np.float64(m) * (np.ldexp(1.0, bits) - 1.0))
    dev = eqc.device
    zero, one = _const(0.0, dev), _const(1.0, dev)
    scale = _const(float(1 << bits), dev)
    e = eqc.to(torch.float32)
    num = e * scale - _const(float(m), dev)
    if fused:
        r = _const(float(np.float32(1.0) / den), dev)
        sim = torch.maximum(zero, num * r)
    else:
        sim = torch.maximum(zero, num / _const(float(den), dev))
    if measure == Measure.SIMILARITY:
        return sim
    if measure == Measure.POISSON_LLR:
        d = (e - _const(float(m), dev)) * scale
        simm1 = torch.minimum(zero, d * r if fused
                              else d / _const(float(den), dev))
        return _finite(_poisson(sim > 0, simm1 / (one + sim), k, fused))
    lh, rh = _cards(measure, lh, rh, dev)
    isz = torch.maximum((lh + rh) / (one + sim), zero)
    if measure == Measure.INTERSECTION:
        ret = isz
    elif measure == Measure.UNION_SIZE:
        ret = lh + rh - isz
    elif measure == Measure.CONTAINMENT:
        ret = isz * sim / lh
    else:
        ret = isz * sim / torch.minimum(lh, rh)
    return _finite(ret)


def optimal_parameters(minreg: float, maxreg: float, q: float
                       ) -> Tuple[float, float]:
    """SetSketch (b, a) for a register value range (setsketch.cpp:7-10):
    b = exp(log(max/min)/q), a = max/b."""
    if maxreg < minreg:
        minreg, maxreg = maxreg, minreg
    b = float(np.exp(np.log(maxreg / minreg) / q))
    a = maxreg / b
    return b, a


def gb_bit_table(b: float, m: int) -> np.ndarray:
    """(2, nbits) f32 constants of the bit-selected g_b power: row 0 holds
    c_k = b^(-2^k / m), row 1 the complements 1 - c_k; computed in f64
    on the host and rounded once to f32."""
    nbits = max(1, int(m).bit_length())
    pows = np.array([np.power(np.float64(b), -(float(1 << k) / m))
                     for k in range(nbits)], dtype=np.float64)
    return np.stack([pows.astype(np.float32),
                     (1.0 - pows).astype(np.float32)])


def _pow_b_neg32(counts: np.ndarray, table: np.ndarray) -> np.ndarray:
    """b^(-c/m) for integer counts as the f32 bit-product of row 0 of
    gb_bit_table, multiplied in ascending bit order."""
    c = counts.astype(np.int32)
    r = np.full(c.shape, np.float32(1.0), dtype=np.float32)
    one = np.float32(1.0)
    row = table[0]
    for k in range(table.shape[-1]):
        bit = ((c >> k) & 1).astype(bool)
        r = r * np.where(bit, row[k], one)
    return r


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """f32 fused multiply-add fma(a, b, c) of f32 values, correctly
    rounded, in eager torch on any device. The product of two f32 values
    is exact in f64; TwoSum gives the f64 sum and its rounding error;
    rounding that sum to odd (moving an inexact sum with an even last bit
    one f64 ulp towards the exact value) before the cast to f32 makes the
    one f32 rounding that of the exact a*b + c (53 >= 24 + 2 bits), with
    no double rounding. Every step is one IEEE f64 operation, so the
    bits do not depend on the device."""
    a, b, c = (x.to(torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _one_minus_pow_b32(counts: np.ndarray, table: np.ndarray,
                       fused: bool) -> np.ndarray:
    """q = 1 - b^(-c/m) for integer counts by the complement recurrence
    q' = q + u_k (1 - q) over the set bits of c in ascending order (row 1
    of gb_bit_table), as the JAX package's `_one_minus_pow_b32`. fused
    gives its jitted bits, where XLA contracts each step into
    fma(u_k, 1 - q, q); otherwise every operation rounds to f32, as its
    numpy route does. A step over a clear bit adds 0 either way."""
    c = counts.astype(np.int32)
    q = np.zeros(c.shape, np.float32)
    one, zero = np.float32(1.0), np.float32(0.0)
    for k in range(table.shape[-1]):
        uk = np.where(((c >> k) & 1).astype(bool), table[1][k], zero)
        if fused:
            q = fma32(torch.from_numpy(uk), torch.from_numpy(one - q),
                      torch.from_numpy(q)).numpy()
        else:
            q = q + uk * (one - q)
    return q


def ab_tables(m: int, table: np.ndarray, gbinv: np.float32,
              gb_form: str, fused: bool):
    """(u, B), (m+1,) f32 each over every count c: u[c] = 1 - b^(-c/m) in
    the JAX package's `gb_form` ('product': 1 minus the bit-product of
    row 0 of gb_bit_table; 'complement': the recurrence over row 1,
    fused or not), and B[c] = f32(u[c] * gbinv).

    In the product form, fused gives the jitted bits: XLA contracts the
    last factor's multiply into the `1 -`, u[c] = fma(-r, c_top, 1),
    where r is the rounded product over the lower bits and c_top the top
    bit's factor (1 where that bit of c is clear). At m a power of two
    the top bit is set only at c = m, where both forms agree; at other m
    they differ in the last bit for some counts."""
    c = np.arange(m + 1)
    if gb_form == "product" and fused:
        top = table.shape[-1] - 1
        r = _pow_b_neg32(c, table[:, :top])
        ctop = np.where(((c >> top) & 1).astype(bool), table[0][top],
                        np.float32(1.0)).astype(np.float32)
        u = fma32(torch.from_numpy(-r), torch.from_numpy(ctop),
                  torch.ones(m + 1, dtype=torch.float32)).numpy()
    elif gb_form == "product":
        u = np.float32(1.0) - _pow_b_neg32(c, table)
    elif gb_form == "complement":
        u = _one_minus_pow_b32(c, table, fused)
    else:
        raise ValueError(f"unknown gb_form {gb_form!r}")
    return u, (u * np.float32(gbinv)).astype(np.float32)


def compressed_ab_measures32(gtc: torch.Tensor, ltc: torch.Tensor, m: int,
                             b: float, fd_level: float, measure: Measure,
                             table: np.ndarray = None,
                             gbinv: np.float32 = None,
                             fused: bool = True,
                             gb_form: str = "product", lh=None, rh=None,
                             k: int = 31) -> torch.Tensor:
    """f32 a/b SetSketch estimator of integer (gt, lt) counts with the
    JAX package's bits. The JAX source writes

        alpha = u[gt] * gbinv,  beta = u[lt] * gbinv,  ab = alpha + beta
        sim = max(0, 1 - ab),   u[c] = 1 - b^(-c/m)

    with u in one of two f32 forms (ab_tables): the bit-product for
    nibbles (gb_form='product'), the complement recurrence for u8, u16
    and u32 registers (gb_form='complement'). Its docstring calls the
    product form FMA-immune. It is not, and which bits come out depends
    on the JAX route:

    * fused=True, the jitted self-pairs route (64 <= n <= SELF_MAX on one
      device): XLA contracts the sum into one fused multiply-add,
      fma(u[gt], gbinv, beta), so u[gt] * gbinv is never rounded and the
      value is NOT symmetric in (gt, lt) in its last bit; in the
      complement form it also contracts every step of the recurrence.
      The port computes both with fma32. The caller passes gt for the
      multiplied operand and lt for the addend.
    * fused=False, the JAX package's numpy epilogue (the generic
      row-block route: n < 64, and n > SELF_MAX on its CPU backend):
      every operation rounds to f32; alpha and beta are added, symmetric
      in (gt, lt).

    The cardinality measures scale sim by mu = lh + rh where ab >= 1,
    else max((lh + rh) / (2 - ab), 0); the jitted route contracts
    UNION_SIZE's `lh + rh - sim * mu` into fma(-sim, mu, lh + rh).
    POISSON_LLR takes log1p(-ab / (2 - ab)). Over every (gt, lt) in
    [0, m]^2 each form
    equals the JAX route's bits (tests/test_torch_ab_epilogue.py,
    tests/test_torch_measures.py). `table` and `gbinv` default to
    gb_bit_table(b, m) and f32(1 / (1 - 1/b)), as cmp/core.py::_gb_args
    builds them."""
    _check_measure(measure)
    if fd_level >= 8.0:
        raise NotImplementedError(
            "full-width a/b registers are not ported (ROADMAP Queue 1 "
            "item 6)")
    if table is None:
        table = gb_bit_table(b, m)
        gbinv = np.float32(1.0 / (1.0 - 1.0 / np.float64(b)))
    u, B = ab_tables(m, table, gbinv, gb_form, fused)
    dev = gtc.device
    b32 = torch.from_numpy(B).to(dev)
    if fused:
        u32 = torch.from_numpy(u).to(dev)
        ab = fma32(u32[gtc.long()], _const(float(gbinv), dev),
                   b32[ltc.long()])
    else:
        ab = b32[gtc.long()] + b32[ltc.long()]
    zero, one, two = (_const(x, dev) for x in (0.0, 1.0, 2.0))
    ret = torch.maximum(one - ab, zero)
    if measure == Measure.SIMILARITY:
        return ret
    if measure == Measure.POISSON_LLR:
        return _finite(_poisson(ret > 0, -ab / (two - ab), k, fused))
    lh, rh = _cards(measure, lh, rh, dev)
    mu = torch.where(ab >= one, lh + rh,
                     torch.maximum((lh + rh) / (two - ab), zero))
    if measure == Measure.INTERSECTION:
        ret = ret * mu
    elif measure == Measure.UNION_SIZE:
        ret = (fma32(-ret, mu, lh + rh) if fused else lh + rh - ret * mu)
    elif measure == Measure.CONTAINMENT:
        ret = ret * mu / lh
    else:
        ret = ret * mu / torch.minimum(lh, rh)
    return _finite(ret)


def full_setsketch_measures32(gtc: torch.Tensor, ltc: torch.Tensor, m: int,
                              measure: Measure, fused: bool = True,
                              lh=None, rh=None, k: int = 31
                              ) -> torch.Tensor:
    """f32 estimator of integer (gt, lt) counts of full registers, with
    the JAX package's bits. The JAX source writes

        s = f32(gt + lt) * f32(1/m),  eq = 1 - s,
        sim = 0 where eq <= 1e-15 (or eq <= 0), else eq

    and the value depends only on c = gt + lt, which is summed first,
    and on the cardinalities. For m a power of two, c * f32(1/m) is
    exact and every route gives the same bits. For other m the JAX route
    decides:

    * fused=True, the jitted self-pairs routes (64 <= n <= SELF_MAX, one
      device or the multi-device mesh): XLA contracts `1 - s` into one
      fused multiply-add, fma(-c, f32(1/m), 1), so the product is never
      rounded. The port computes f32(1 - f64(c) * f64(f32(1/m))): with
      c <= m < 2^16 and a 24-bit reciprocal above 2^-16, the product
      and the difference are exact in f64 (both fit in 41 significant
      bits), so the one rounding is the cast to f32, which is the fma's.
      At c = m the
      fma leaves a residue of either sign (2.2e-8 at m = 100, -2.4e-8 at
      m = 300); a negative one becomes 0, a positive one stays.
    * fused=False, the JAX package's numpy epilogue (the generic row-block
      route: n < 64, and N > SELF_MAX on its CPU backend): s is rounded
      to f32, then 1 - s; c = m gives exactly 0.

    The union ucard = max((lh + rh) / (2 - s), 0) and the intersection
    ucard * sim; POISSON_LLR takes log1p(-s / (2 - s)). Where eq <= 0
    every measure is 0 and POISSON_LLR inf. In those graphs s has more
    than one use, and XLA contracts neither `1 - s` nor `2 - s`: the
    jitted route rounds s as the numpy route does. It contracts
    `lh + rh - isz` of UNION_SIZE into fma(-ucard, sim, lh + rh).

    Over every c in [0, m] both forms equal those JAX routes bit for bit
    (tests/test_torch_full.py, tests/test_torch_measures.py). The JAX
    package's own (m+1) table (cmp/core.py::_sim_table, its counts-pull
    route) follows neither rule: XLA fused it at m in {1000, 1023} and
    not at {100, 200, 300}.

    Eager torch rounds every operation, on the CPU and on the card
    alike."""
    _check_measure(measure)
    dev = gtc.device
    c = gtc.to(torch.int32) + ltc.to(torch.int32)
    recip = float(np.float32(1.0 / m))
    zero, one, two = (_const(x, dev) for x in (0.0, 1.0, 2.0))
    if fused and measure == Measure.SIMILARITY:
        eq = (1.0 - c.to(torch.float64) * recip).to(torch.float32)
        return torch.where(eq <= _const(1e-15, dev), zero, eq)
    s = c.to(torch.float32) * _const(recip, dev)
    eq = one - s
    two_s = two - s
    eqv = torch.where(eq <= _const(1e-15, dev), zero, eq)
    if measure == Measure.SIMILARITY:
        return eqv
    dead = eq <= zero
    inf = _const(float("inf"), dev)
    if measure == Measure.POISSON_LLR:
        ret = _poisson(eqv > zero, -s / two_s, k, fused)
        return _finite(torch.where(dead, inf, ret))
    lh, rh = _cards(measure, lh, rh, dev)
    ucard = torch.maximum((lh + rh) / two_s, zero)
    isz = ucard * eqv
    if measure == Measure.INTERSECTION:
        ret = isz
    elif measure == Measure.UNION_SIZE:
        ret = (fma32(-ucard, eqv, lh + rh) if fused else lh + rh - isz)
    elif measure == Measure.CONTAINMENT:
        ret = isz / rh
    else:
        ret = isz / torch.minimum(lh, rh)
    return _finite(torch.where(dead, zero, ret))


def equality_measures32(eqc: torch.Tensor, m: int, measure: Measure,
                        fused: bool = True, lh=None, rh=None,
                        k: int = 31) -> torch.Tensor:
    """f32 equality-fraction estimator of integer eq counts (full
    registers compared for equality: `--bbit-sigs` without `--fastcmp`),
    with the JAX package's bits. The JAX source writes

        sim = f32(eqc) * f32(1/m),  ucard = max((lh + rh) / (1 + sim), 0)

    with the intersection sim * ucard; POISSON_LLR takes
    log1p(simm1 / (1 + sim)), simm1 = (f32(eqc) - m) * f32(1/m). The
    product with the reciprocal is in the source, so both routes round it
    alike (sim has more than one use, and XLA does not contract
    `1 + sim`); fused=True gives the jitted route's one contraction,
    `lh + rh - sim * ucard` into fma(-sim, ucard, lh + rh)."""
    _check_measure(measure)
    dev = eqc.device
    recip = _const(float(np.float32(1.0 / m)), dev)
    zero, one = _const(0.0, dev), _const(1.0, dev)
    e = eqc.to(torch.float32)
    sim = e * recip
    if measure == Measure.SIMILARITY:
        return sim
    one_sim = one + sim
    if measure == Measure.POISSON_LLR:
        simm1 = (e - _const(float(m), dev)) * recip
        return _finite(_poisson(sim > zero, simm1 / one_sim, k, fused))
    lh, rh = _cards(measure, lh, rh, dev)
    ucard = torch.maximum((lh + rh) / one_sim, zero)
    if measure == Measure.INTERSECTION:
        ret = sim * ucard
    elif measure == Measure.UNION_SIZE:
        ret = (fma32(-sim, ucard, lh + rh) if fused
               else lh + rh - sim * ucard)
    elif measure == Measure.CONTAINMENT:
        ret = sim * ucard / lh
    else:
        ret = sim * ucard / torch.minimum(lh, rh)
    return _finite(ret)
