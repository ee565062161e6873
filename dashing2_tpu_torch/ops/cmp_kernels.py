"""Host-side helpers of the register comparisons.

Port of dashing2_tpu/ops/cmp_kernels.py::f64_to_ordered_u64. For
non-negative IEEE doubles the total order of values equals the unsigned
order of their bit patterns, so signatures are compared as u64 words:
exact greater/less counts with no floating-point compares.
"""

from __future__ import annotations

import numpy as np


def f64_to_ordered_u64(x: np.ndarray) -> np.ndarray:
    """Bitcast non-negative f64 -> u64 preserving order (a view of a
    contiguous f64 array, so no copy); raises on a negative value."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    if np.signbit(x).any():
        raise ValueError("ordered bitcast requires non-negative values")
    return x.view(np.uint64)
