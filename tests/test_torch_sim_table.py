"""Port parity: the (m+1)-entry b-bit similarity tables, bit for bit.

The port builds cmp/core.py::sim_table in torch; the JAX package builds
`_sim_table` with one XLA graph, and its jitted self-pairs routes run the
same epilogue over count matrices. The fused table must hold their f32
bits for every eq count, and the unfused one the bits of the JAX numpy
epilogue (its route below n = 64 and above SELF_MAX: one IEEE division
where the jitted routes multiply by the reciprocal), for nibble, u8, u16
and u32 registers (tolerance zero, compared as u32 patterns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.cmp import estimators as JE
from dashing2_tpu.cmp.core import _sim_table, _tiled_epilogue
from dashing2_tpu.enums import Measure as JMeasure
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


@pytest.mark.parametrize("m", [64, 256, 300, 1024])
@pytest.mark.parametrize("fd", [0.5, 1.0, 2.0, 4.0])
def test_bbit_tables_equal_jax_routes(fd, m):
    kind = "nibble-bbit" if fd == 0.5 else "bbit"
    eqc = np.arange(m + 1, dtype=np.int32)
    fused = PC.sim_table(kind, m, fd, "cpu", fused=True).numpy()
    plain = PC.sim_table(kind, m, fd, "cpu", fused=False).numpy()
    one = jnp.ones(m + 1)
    tiled = jax.jit(lambda c: _tiled_epilogue(
        kind, m, JMeasure.SIMILARITY, 31, fd, c, None, one, one, 1.0))(
            jnp.asarray(np.tile(eqc, (3, 1))))
    for want in (_sim_table(kind, m, 31, fd), np.asarray(tiled)[1]):
        np.testing.assert_array_equal(fused.view(np.uint32),
                                      np.asarray(want, np.float32)
                                      .view(np.uint32))
    numpy_route = JE.bbit_measures32(eqc, m, fd, 1.0, 1.0,
                                     JMeasure.SIMILARITY, 31)
    np.testing.assert_array_equal(plain.view(np.uint32),
                                  numpy_route.view(np.uint32))
    if fd == 0.5:
        # the two JAX routes' bits differ for nibbles at every m here
        # (and for some m at the other widths), so each route needs its
        # own form
        assert (fused.view(np.uint32) != plain.view(np.uint32)).any()


def test_table_is_the_epilogue_on_count_matrices():
    """Gathering the table at counts == the estimator on the counts."""
    m = 256
    rng = np.random.default_rng(0)
    eqc = torch.from_numpy(rng.integers(0, m + 1, size=(17, 23)))
    for fused in (True, False):
        table = PC.sim_table("nibble-bbit", m, 0.5, "cpu", fused)
        direct = bbit_measures32(eqc, m, 0.5, Measure.SIMILARITY, fused)
        np.testing.assert_array_equal(table[eqc].numpy().view(np.uint32),
                                      direct.numpy().view(np.uint32))


def test_other_measures_and_kinds_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bbit_measures32(torch.arange(5), 4, 0.5, Measure.POISSON_LLR)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PC.sim_table("nibble-ab", 64, 0.5, "cpu")
