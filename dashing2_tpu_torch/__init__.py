"""dashing2_tpu_torch: the PyTorch/CUDA port of dashing2_tpu.

A second package beside the JAX one (dashing2_tpu/, which stays the
reference). It imports torch and never jax or dashing2_tpu: the JAX-free
host modules it needs are copies, and the C++ sources it builds are read
by path. Every kernel that the JAX package wrote in Pallas for the TPU
becomes a kernel written by hand for Hopper (csrc/), with a plain
PyTorch version beside it in the same module.

The first slice is the north-star job
`sketch -k 31 -S 1024 --fastcmp 0.5 --bbit-sigs --binary-output --cmpout`:
native host sketching, b-bit nibble compression, the triangular
equal-register counts kernel (csrc/tri_eq.cu) and the similarity table.
"""

from .config import Dashing2DistOptions, Dashing2Options
from .enums import Measure, OutputFormat, OutputKind

__version__ = "0.1.0"

__all__ = [
    "Dashing2Options",
    "Dashing2DistOptions",
    "Measure",
    "OutputFormat",
    "OutputKind",
    "__version__",
]
