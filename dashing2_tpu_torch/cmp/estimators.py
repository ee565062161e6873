"""Similarity estimators on integer register-count tensors, in torch.

Port of dashing2_tpu/cmp/estimators.py::bbit_measures32 for
Measure.SIMILARITY, the one measure the slice emits. The other measures
divide by per-pair cardinalities and are ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

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
