"""Port parity: ops/int_counts.py against the JAX package's u8/u16/u32
count engines.

The same seeded registers (with planted identical rows, equal registers,
all-zero and all-max rows, and values on both sides of the top bit) go to
the port's `int_counts` and `int_counts_self` (on CPU tensors: their plain
PyTorch versions; u32 registers through ops/gtlt.py) and to the JAX
package's Pallas kernel `_int_counts_kernel` through `counts_int_pallas`,
in interpret mode on the CPU as tests/test_pallas_native.py runs it
(u32 goes to `gtlt_pallas` there). Counts are integers: tolerance zero.
The CUDA kernel itself is held against the plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from dashing2_tpu.ops.pallas_cmp import counts_int_pallas
from dashing2_tpu_torch.ops import gtlt as G
from dashing2_tpu_torch.ops import int_counts as IC

TYPES = {"u8": np.uint8, "u16": np.uint16, "u32": np.uint32}


def _regs(n: int, m: int, dt, seed: int) -> np.ndarray:
    """(n, m) registers of type dt with planted structure."""
    top = np.iinfo(dt).max
    rng = np.random.default_rng(seed)
    a = rng.integers(0, int(top) + 1, size=(n, m), dtype=np.uint64).astype(dt)
    if n >= 2:
        a[n - 1] = a[0]                            # identical rows
        a[1, ::3] = a[0, ::3]                      # equal registers
    if n >= 5:
        a[2] = 0
        a[3] = top                                 # all-max row
        half = (int(top) + 1) // 2
        a[4, 0::2] = half                          # top bit alone ...
        a[4, 1::2] = half - 1                      # ... and just below it
    return a


def _t(a: np.ndarray) -> torch.Tensor:
    """Registers as the port's wrappers take them."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16))
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.uint64).view(np.int64))
    return torch.from_numpy(a)


def _u16(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint16
    return x.numpy().astype(np.int64)


def _naive(a: np.ndarray, b: np.ndarray):
    x, y = a.astype(np.int64)[:, None], b.astype(np.int64)[None]
    return (x == y).sum(2), (x > y).sum(2), (x < y).sum(2)


@pytest.mark.parametrize("na,nb,m", [(17, 9, 96), (9, 70, 30), (64, 5, 33),
                                     (3, 130, 7)])
@pytest.mark.parametrize("dt", sorted(TYPES))
def test_plain_counts_match_counts_int_pallas(dt, na, nb, m):
    a = _regs(na, m, TYPES[dt], seed=na * 100 + m)
    b = _regs(nb, m, TYPES[dt], seed=nb * 100 + m + 1)
    b[:, ::4] = a[0, ::4]
    got = IC.int_counts(_t(a), _t(b))
    want = counts_int_pallas(a, b, tm=8, tn=128)
    for g, w in zip(got, want):
        assert g.shape == (na, nb)
        np.testing.assert_array_equal(_u16(g), np.asarray(w))


@pytest.mark.parametrize("n,m", [(1, 64), (2, 30), (63, 64), (129, 30),
                                 (200, 33)])
@pytest.mark.parametrize("dt", sorted(TYPES))
def test_plain_self_counts_match_counts_int_pallas(dt, n, m):
    a = _regs(n, m, TYPES[dt], seed=3 * n + m)
    eq_want, gt_want, lt_want = (np.asarray(x) for x in
                                 counts_int_pallas(a, a, tm=8, tn=128))
    eq = _u16(IC.int_counts_self(_t(a), "eq"))
    gt = _u16(IC.int_counts_self(_t(a), "gtlt"))
    np.testing.assert_array_equal(eq, eq_want)
    np.testing.assert_array_equal(gt, gt_want)
    # the kernel's layout: lt of the pair (i, j) sits at (j, i)
    np.testing.assert_array_equal(gt.T, lt_want)
    assert (np.diag(eq) == m).all() and (np.diag(gt) == 0).all()


@pytest.mark.parametrize("dt", sorted(TYPES))
def test_planted_rows_count_every_register(dt):
    m = 64
    a = _regs(8, m, TYPES[dt], seed=5)
    gt = _u16(IC.int_counts_self(_t(a), "gtlt"))
    eq = _u16(IC.int_counts_self(_t(a), "eq"))
    assert gt[3, 2] == m and gt[2, 3] == 0            # all max vs all zero
    assert eq[0, 7] == m and gt[0, 7] == gt[7, 0] == 0  # identical rows
    assert gt[4, 2] == m and gt[3, 4] == m            # top bit, and below
    # the top-bit half of row 4 against itself shifted by one register
    b = a[4:5, np.r_[1:m, 0]].copy()
    e, g, lt = IC.int_counts(_t(a[4:5].copy()), _t(b))
    assert (_u16(e), _u16(g), _u16(lt)) == (0, m // 2, m // 2)


def test_plain_chunks_agree_with_one_pass(monkeypatch):
    """Row chunks of the plain version (a few rows per compare) give the
    counts of one unchunked compare."""
    a, b = _regs(37, 30, np.uint16, 8), _regs(11, 30, np.uint16, 9)
    want = _naive(a, b)
    monkeypatch.setattr(IC, "_PLAIN_CHUNK", 3 * 11 * 30)
    for g, w in zip(IC.int_counts(_t(a), _t(b)), want):
        np.testing.assert_array_equal(_u16(g), w)
    np.testing.assert_array_equal(_u16(IC.int_counts_self(_t(a), "eq")),
                                  _naive(a, a)[0])


def test_cpu_tensors_take_plain_versions_without_launching():
    for c in (IC.self_launches, IC.rect_launches, G.self_launches,
              G.rect_launches):
        c.reset_launches()
    for dt in TYPES.values():
        a, b = _t(_regs(5, 64, dt, 3)), _t(_regs(6, 64, dt, 4))
        for mode in ("eq", "gtlt"):
            assert torch.equal(IC.int_counts_self(a, mode),
                               IC.int_counts_self_plain(a, mode))
        assert all(torch.equal(x, y) for x, y in
                   zip(IC.int_counts(a, b), IC.int_counts_plain(a, b)))
    assert (IC.self_launches.launches, IC.rect_launches.launches,
            G.self_launches.launches, G.rect_launches.launches) == (0,) * 4


def test_wrappers_reject_bad_inputs():
    a = _t(_regs(4, 64, np.uint8, 4))
    with pytest.raises(TypeError):
        IC.int_counts_self(a.to(torch.int32), "eq")    # no such width
    with pytest.raises(ValueError):
        IC.int_counts_self(a, "gt")                    # no such mode
    with pytest.raises(ValueError):
        IC.int_counts_self(a[:, ::2], "eq")            # not contiguous
    with pytest.raises(ValueError):
        IC.int_counts_self(a[:0], "eq")                # no rows
    with pytest.raises(ValueError):
        IC.int_counts_self(torch.zeros((2, 1 << 16), dtype=torch.uint8),
                           "eq")
    with pytest.raises(ValueError):
        IC.int_counts(a, a[:, :32].contiguous())       # m differs
    with pytest.raises(ValueError):
        IC.int_counts(a, a.to(torch.int16))            # widths differ
    with pytest.raises(ValueError):
        IC.int_counts_self(a.to("meta"), "eq")         # neither cpu nor cuda
    with pytest.raises(ValueError):
        IC.int_counts(a, a.to("meta"))                 # devices differ
