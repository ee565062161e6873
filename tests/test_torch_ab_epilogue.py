"""Port parity: the a/b epilogues and their constants, bit for bit.

The port's `compressed_ab_measures32` (torch) must give the JAX package's
f32 bits on every count pair (gt, lt) in [0, m]^2, with b calibrated by
`optimal_parameters` on a real job's sketches:

* nibbles (product form), fused=True against the JAX function jitted, as
  the JAX self-pairs route runs it (XLA contracts its sum into one fma,
  and at m not a power of two the last factor of the bit-product into
  the `1 -`);
  fused=False against the JAX function on numpy, as the JAX row-block
  route runs it for n < 64;
* u8, u16 and u32 registers (complement form): the (m+1) table
  u[c] = 1 - b^(-c/m) against the JAX recurrence jitted (each step
  contracted into an fma) and on numpy, at the b of a real fd = 1, 2
  and 4 job; the whole value against the JAX jitted epilogue over a
  count matrix with lt = gt^T, as its self-pairs routes build it, on
  both sides of its 4096-row scan threshold (the fma multiplies the
  column's count below it, the row's above), and against its numpy
  form.

The host constants (`optimal_parameters`, `gb_bit_table`, `_gb_args`)
and `make_compressed`'s a/b registers (data, a, b) must equal the JAX
package's. Tolerance zero everywhere (f32 compared as u32 patterns).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.cmp import core as JC
from dashing2_tpu.cmp import estimators as JE
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.enums import Measure as JMeasure
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.cmp import estimators as PE
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import from_reference
from dashing2_tpu_torch.sketch.core import sketch_fastx


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("ab_job")
    return write_corpus(str(d / "fa"), seed=404, n_ancestors=8,
                        n_mutants=10, length=3000)


def _ab_opts(m: int, cls=Dashing2DistOptions):
    return cls(k=31, sketchsize=m, fd_level=0.5)


@pytest.fixture(scope="module")
def job_b(paths):
    """m -> the b that make_compressed calibrates on the job's sketches."""
    out = {}
    for m in (30, 64, 100, 128, 1000, 1024):
        creps, _ = PC._prep(_ab_opts(m), sketch_fastx(_ab_opts(m), paths))
        out[m] = creps.b
    return out


def _all_pairs(m: int):
    c = np.arange(m + 1, dtype=np.int32)
    return np.meshgrid(c, c, indexing="ij")


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("m", [30, 64, 100, 128, 1000, 1024])
def test_fused_epilogue_bits_equal_jitted_jax(job_b, m):
    b = max(job_b[m], 1.0 + 1e-9)
    assert 1.01 < b < 10.0
    table, gbinv = PC._gb_args(b, m)
    gt, lt = _all_pairs(m)
    one = jnp.ones((1, 1), jnp.float64)
    want = jax.jit(lambda g, l, t, gi: JE.compressed_ab_measures32(
        g, l, m, b, 0.5, one, one, JMeasure.SIMILARITY, 31, xp=jnp,
        table=t, gbinv=gi, gb_form="product"))(
            jnp.asarray(gt), jnp.asarray(lt), table, gbinv)
    got = PE.compressed_ab_measures32(
        torch.from_numpy(gt), torch.from_numpy(lt), m, b, 0.5,
        Measure.SIMILARITY, table, gbinv)
    assert got.dtype == torch.float32 and got.shape == gt.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("m", [64, 128, 1024])
def test_numpy_form_epilogue_bits_equal_jax_numpy(job_b, m):
    b = max(job_b[m], 1.0 + 1e-9)
    gt, lt = _all_pairs(m)
    want = JE.compressed_ab_measures32(gt, lt, m, b, 0.5, 1.0, 1.0,
                                       JMeasure.SIMILARITY, 31)
    got = PE.compressed_ab_measures32(
        torch.from_numpy(gt), torch.from_numpy(lt), m, b, 0.5,
        Measure.SIMILARITY, fused=False)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fused_form_is_not_symmetric():
    """The contracted sum rounds differently when (gt, lt) swap: a
    'compute one triangle, mirror it' epilogue would break parity."""
    m = 1024
    gt, lt = _all_pairs(m)
    v = PE.compressed_ab_measures32(torch.from_numpy(gt),
                                    torch.from_numpy(lt), m, 1.0733, 0.5,
                                    Measure.SIMILARITY).numpy()
    assert (_bits(v) != _bits(v.T)).any()


@pytest.mark.parametrize("lo,hi", [(1e-9, 3e-4), (0.5, 0.25), (2.0, 2.0),
                                   (1e-300, 1.0)])
def test_optimal_parameters_equal_jax(lo, hi):
    assert PE.optimal_parameters(lo, hi, 15.4) == \
        JE.optimal_parameters(lo, hi, 15.4)


@pytest.mark.parametrize("m", [30, 64, 256, 1024, 4096])
@pytest.mark.parametrize("b", [1.0000001, 1.0571, 1.0733, 2.68])
def test_gb_tables_equal_jax(m, b):
    np.testing.assert_array_equal(_bits(PE.gb_bit_table(b, m)),
                                  _bits(JE.gb_bit_table(b, m)))
    (pt, pg), (jt, jg) = PC._gb_args(b, m), JC._gb_args(b, m)
    np.testing.assert_array_equal(_bits(pt), _bits(jt))
    assert pg.dtype == np.float32 and _bits(pg) == _bits(jg)
    c = np.arange(m + 1)
    np.testing.assert_array_equal(_bits(PE._pow_b_neg32(c, pt)),
                                  _bits(JE._pow_b_neg32(c, jt)))


@pytest.mark.parametrize("m", [64, 256])
def test_make_compressed_ab_equals_jax(paths, m, monkeypatch):
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(_ab_opts(m, JOptions), paths)
    jax_creps, _ = JC._prep(_ab_opts(m, JOptions), ref)
    port_creps, _ = PC._prep(_ab_opts(m), sketch_fastx(_ab_opts(m), paths))
    carried = PC.creps_from_reference(jax_creps)
    for c in (port_creps, carried):
        assert c.nibble_packed and c.truncation == 0
        assert (c.a, c.b) == (jax_creps.a, jax_creps.b)
        np.testing.assert_array_equal(c.data, jax_creps.data)
    assert PC._representation(_ab_opts(m), from_reference(ref),
                              port_creps)[0] == "nibble-ab"


def test_other_measures_are_not_ported():
    c = torch.arange(5)
    with pytest.raises(ValueError, match="invalid"):
        PE.compressed_ab_measures32(c, c, 4, 1.07, 0.5,
                                    Measure.M_EDIT_DISTANCE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PE.compressed_ab_measures32(c, c, 4, 1.07, 8.0, Measure.SIMILARITY)


WIDE = (1.0, 2.0, 4.0)


@pytest.fixture(scope="module")
def wide_b(paths):
    """fd -> the b that make_compressed calibrates on the job's sketches
    at m = 256 (b depends on the register range and q, not on m)."""
    out = {}
    for fd in WIDE:
        opts = Dashing2DistOptions(k=31, sketchsize=256, fd_level=fd)
        out[fd] = PC._prep(opts, sketch_fastx(opts, paths))[0].b
    return out


@pytest.mark.parametrize("m", [256, 1024])
@pytest.mark.parametrize("fd", WIDE)
def test_complement_table_bits_equal_jax(wide_b, fd, m):
    b = max(wide_b[fd], 1.0 + 1e-9)
    assert 1.0 < b < 1.2
    table, gbinv = PC._gb_args(b, m)
    c = np.arange(m + 1, dtype=np.int32)
    jitted = jax.jit(lambda cc, t: JE._one_minus_pow_b32(cc, t, jnp))(
        jnp.asarray(c), table)
    for fused, want in ((True, jitted), (False, JE._one_minus_pow_b32(c,
                                                                   table))):
        u, B = PE.ab_tables(m, table, gbinv, "complement", fused)
        assert u.dtype == B.dtype == np.float32 and u.shape == (m + 1,)
        np.testing.assert_array_equal(_bits(u), _bits(want))
        np.testing.assert_array_equal(_bits(B), _bits(u * gbinv))


def _gt_matrix(m: int, n: int) -> np.ndarray:
    """(n, n) gt counts, lt = gt^T, holding every (gt, lt) in [0, m]^2 at
    (i, m + 1 + j) = (i, j)."""
    gt = np.zeros((n, n), np.int32)
    c = np.arange(m + 1, dtype=np.int32)
    gt[:m + 1, m + 1:2 * m + 2] = c[:, None]
    gt[m + 1:2 * m + 2, :m + 1] = c[:, None]
    return gt


@pytest.mark.parametrize("m,n", [(256, "whole"), (300, "whole"),
                                 (256, "scan")])
@pytest.mark.parametrize("fd", WIDE)
def test_complement_epilogue_bits_equal_jax_routes(wide_b, fd, m, n):
    rows = 2 * m + 2 if n == "whole" else 4224
    assert (rows > PC._TILED_ROWS) == (n == "scan")
    b = max(wide_b[fd], 1.0 + 1e-9)
    table, gbinv = PC._gb_args(b, m)
    cnt = _gt_matrix(m, rows)
    fn = JC._counts_epilogue_fn("ab", m, JMeasure.SIMILARITY, 31, fd)
    want = np.asarray(fn(jnp.asarray(cnt), np.ones(rows), np.float64(b),
                         table, gbinv))[:m + 1, m + 1:2 * m + 2]
    gt, lt = _all_pairs(m)
    args = (gt, lt) if n == "scan" else (lt, gt)
    got = PE.compressed_ab_measures32(
        *(torch.from_numpy(x) for x in args), m, b, fd, Measure.SIMILARITY,
        table, gbinv, True, "complement")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    other = PE.compressed_ab_measures32(
        *(torch.from_numpy(x) for x in args[::-1]), m, b, fd,
        Measure.SIMILARITY, table, gbinv, True, "complement")
    assert (_bits(other.numpy()) != _bits(want)).any()
    if n == "whole":
        want = JE.compressed_ab_measures32(gt, lt, m, b, fd, 1.0, 1.0,
                                           JMeasure.SIMILARITY, 31,
                                           gb_form="complement")
        got = PE.compressed_ab_measures32(
            torch.from_numpy(gt), torch.from_numpy(lt), m, b, fd,
            Measure.SIMILARITY, table, gbinv, False, "complement")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fma32_is_one_rounding():
    """fma32 against exact rational arithmetic on values where a rounded
    product, or a sum rounded twice, would differ."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    a = rng.random(2000).astype(np.float32)
    b = (rng.random(2000) * 1e3).astype(np.float32)
    c = (rng.random(2000) * 1e-3).astype(np.float32)
    got = PE.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        near = sorted((np.nextafter(lo, np.float32(-np.inf)), lo,
                       np.nextafter(lo, np.float32(np.inf))),
                      key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.uint32)) & 1))
        assert g == near[0]
