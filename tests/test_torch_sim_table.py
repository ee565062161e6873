"""Port parity: the (m+1)-entry similarity table, bit for bit.

The port builds cmp/core.py::sim_table in torch; the JAX package builds
`_sim_table` with one XLA graph. Both must hold the same f32 bits for
every eq count (tolerance zero, compared as u32 patterns).
"""

import numpy as np
import pytest
import torch

from dashing2_tpu.cmp.core import _sim_table
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.cmp.estimators import bbit_measures32
from dashing2_tpu_torch.enums import Measure


@pytest.mark.parametrize("m", [64, 256, 1024, 4096])
def test_sim_table_bits_equal_jax(m):
    want = np.asarray(_sim_table("nibble-bbit", m, 31, 0.5), np.float32)
    got = PC.sim_table("nibble-bbit", m, 0.5, "cpu")
    assert got.dtype == torch.float32 and got.shape == (m + 1,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_table_is_the_epilogue_on_count_matrices():
    """Gathering the table at counts == the estimator on the counts."""
    m = 256
    rng = np.random.default_rng(0)
    eqc = torch.from_numpy(rng.integers(0, m + 1, size=(17, 23)))
    table = PC.sim_table("nibble-bbit", m, 0.5, "cpu")
    direct = bbit_measures32(eqc, m, 0.5, Measure.SIMILARITY)
    np.testing.assert_array_equal(table[eqc].numpy().view(np.uint32),
                                  direct.numpy().view(np.uint32))


def test_other_measures_and_kinds_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bbit_measures32(torch.arange(5), 4, 0.5, Measure.POISSON_LLR)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PC.sim_table("nibble-ab", 64, 0.5, "cpu")
