"""Similarity estimators on integer register-count tensors, in torch.

Port of dashing2_tpu/cmp/estimators.py for Measure.SIMILARITY, the one
measure the port emits:

* `bbit_measures32` for b-bit registers (eq counts);
* `compressed_ab_measures32` for SetSketch a/b-quantised nibbles (gt and
  lt counts), with the host numpy constants it needs
  (`optimal_parameters`, `gb_bit_table`, `_pow_b_neg32`);
* `full_setsketch_measures32` for full 64-bit registers (gt and lt
  counts, the default mode).

The other measures divide by per-pair cardinalities and are ROADMAP
Queue 1 item 4.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..enums import Measure


def bbit_measures32(eqc: torch.Tensor, m: int, fd_level: float,
                    measure: Measure) -> torch.Tensor:
    """f32 b-bit similarity of integer eq counts, with the JAX package's
    bits: max(0, (eqc * 2^b - m) * r), r = f32(1 / (m * (2^b - 1))).

    The JAX source writes `/ den`, but den is a constant of the traced
    graph and XLA's algebraic simplifier rewrites division by a constant
    into multiplication by its f32 reciprocal; the JAX package's
    similarity table (cmp/core.py::_sim_table) therefore holds the
    product, which differs from the IEEE quotient by one ulp for about
    60% of counts. The port computes that product: r is one IEEE f32
    division done on the host, eqc * 2^b - m is exact (an integer below
    2^24), and the multiply is one correctly rounded IEEE operation on
    the CPU and on the card alike, so the bits match on every device."""
    if measure != Measure.SIMILARITY:
        raise NotImplementedError(
            f"{measure.name} on b-bit registers is not ported "
            "(ROADMAP Queue 1 item 4)")
    bits = int(fd_level * 8)
    den = np.float32(np.float64(m) * (np.ldexp(1.0, bits) - 1.0))
    recip = float(np.float32(1.0) / den)
    dev = eqc.device

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)
    num = eqc.to(torch.float32) * f32(float(1 << bits)) - f32(float(m))
    return torch.maximum(f32(0.0), num * f32(recip))


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


def compressed_ab_measures32(gtc: torch.Tensor, ltc: torch.Tensor, m: int,
                             b: float, fd_level: float, measure: Measure,
                             table: np.ndarray = None,
                             gbinv: np.float32 = None,
                             fused: bool = True) -> torch.Tensor:
    """f32 a/b SetSketch similarity of integer (gt, lt) counts with the
    JAX package's bits (its product form, gb_form='product'). The JAX
    source writes

        alpha = u[gt] * gbinv,  beta = u[lt] * gbinv,  ab = alpha + beta
        sim = max(0, 1 - ab),   u[c] = 1 - b^(-c/m) (f32 bit-product)

    and its docstring calls the form FMA-immune. It is not, and which
    bits come out depends on the JAX route:

    * fused=True, the jitted self-pairs route (64 <= n): XLA contracts
      the sum into one fused multiply-add, fma(u[gt], gbinv, beta), so
      u[gt] * gbinv is never rounded and the value is NOT symmetric in
      (gt, lt) in its last bit. The port computes
      ab = f32(f64(u[gt]) * f64(gbinv) + f64(beta)): the product of two
      f32 values is exact in f64, the sum is rounded to f64 and then to
      f32, and over every (gt, lt) in [0, m]^2 that equals the JAX
      package's bits (tests/test_torch_ab_epilogue.py). The caller passes
      gt for the row item (the multiplied operand) and lt = the column
      item's gt (the addend).
    * fused=False, the JAX package's numpy epilogue (the generic
      row-block route, n < 64): alpha and beta are each rounded to f32
      and then added, symmetric in (gt, lt).

    Eager torch never contracts, so the same code gives the same bits on
    the CPU and on the card. `table` and `gbinv` default to
    gb_bit_table(b, m) and f32(1 / (1 - 1/b)), as cmp/core.py::_gb_args
    builds them."""
    if measure != Measure.SIMILARITY:
        raise NotImplementedError(
            f"{measure.name} on a/b registers is not ported "
            "(ROADMAP Queue 1 item 4)")
    if fd_level >= 8.0:
        raise NotImplementedError(
            "full-width a/b registers are not ported (ROADMAP Queue 1 "
            "item 5)")
    if table is None:
        table = gb_bit_table(b, m)
        gbinv = np.float32(1.0 / (1.0 - 1.0 / np.float64(b)))
    # (m+1,) f32 tables over every count, each step one f32 rounding as
    # in the JAX graph: u[c] = 1 - b^(-c/m), B[c] = u[c] * gbinv
    u = np.float32(1.0) - _pow_b_neg32(np.arange(m + 1), table)
    B = (u * np.float32(gbinv)).astype(np.float32)
    dev = gtc.device
    if fused:
        u64 = torch.from_numpy(u.astype(np.float64)).to(dev)
        b64 = torch.from_numpy(B.astype(np.float64)).to(dev)
        g64 = torch.tensor(float(gbinv), dtype=torch.float64, device=dev)
        ab = (u64[gtc.long()] * g64 + b64[ltc.long()]).to(torch.float32)
    else:
        b32 = torch.from_numpy(B).to(dev)
        ab = b32[gtc.long()] + b32[ltc.long()]
    return torch.clamp_min(torch.tensor(1.0, dtype=torch.float32,
                                        device=dev) - ab, 0.0)


def full_setsketch_measures32(gtc: torch.Tensor, ltc: torch.Tensor, m: int,
                              measure: Measure, fused: bool = True
                              ) -> torch.Tensor:
    """f32 similarity of integer (gt, lt) counts of full registers, with
    the JAX package's bits. The JAX source writes

        s = f32(gt + lt) * f32(1/m),  eq = 1 - s,
        sim = 0 where eq <= 1e-15 (or eq <= 0), else eq

    and the value depends only on c = gt + lt, which is summed first.
    For m a power of two, c * f32(1/m) is exact and every route gives the
    same bits. For other m the JAX route decides:

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

    Over every c in [0, m] both forms equal those JAX routes bit for bit
    (tests/test_torch_full.py). The JAX package's own (m+1) table
    (cmp/core.py::_sim_table, its counts-pull route) follows neither
    rule: XLA fused it at m in {1000, 1023} and not at {100, 200, 300}.

    Eager torch rounds every operation, on the CPU and on the card
    alike."""
    if measure != Measure.SIMILARITY:
        raise NotImplementedError(
            f"{measure.name} on full registers is not ported (ROADMAP "
            "Queue 1 item 4)")
    dev = gtc.device
    c = gtc.to(torch.int32) + ltc.to(torch.int32)
    recip = float(np.float32(1.0 / m))

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)
    if fused:
        eq = (1.0 - c.to(torch.float64) * recip).to(torch.float32)
    else:
        eq = f32(1.0) - c.to(torch.float32) * f32(recip)
    return torch.where(eq <= f32(1e-15), f32(0.0), eq)
