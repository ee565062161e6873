"""Port parity: ops/gtlt.py against the JAX package's u64 gt/lt engines.

The same seeded u64 registers (with the top bit set in about half of
them, planted equal registers, identical rows, all-zero and all-ones
rows, and the 2^63 - 1 / 2^63 boundary) go to the port's `gtlt_counts`
and `gtlt_self_counts` (on CPU tensors: their plain PyTorch versions)
and to the JAX package's Pallas kernels `_gtlt_kernel` (through
`gtlt_pallas`) and the kernel inside `_tri_gtlt_call` (through
`gtlt_self_pallas`), both in interpret mode on the CPU as
tests/test_pallas_native.py runs them, and to its XLA engine
`count_gtlt`. Counts are integers: tolerance zero. The CUDA kernels
themselves are held against the plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from dashing2_tpu.ops.cmp_kernels import count_gtlt
from dashing2_tpu.ops.pallas_cmp import gtlt_pallas, gtlt_self_pallas
from dashing2_tpu_torch.ops import gtlt as G

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _regs(n: int, m: int, seed: int) -> np.ndarray:
    """(n, m) u64 registers with planted structure."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, size=(n, m), dtype=np.uint64)
    if n >= 2:
        a[n - 1] = a[0]                       # identical rows
        a[1, ::3] = a[0, ::3]                 # equal registers
    if n >= 5:
        a[2] = 0
        a[3] = U64_MAX
        a[4, 0::2] = np.uint64(1 << 63)       # top bit alone ...
        a[4, 1::2] = np.uint64((1 << 63) - 1)  # ... and just below it
    return a


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int64))


def _naive(a: np.ndarray, b: np.ndarray):
    return ((a[:, None, :] > b[None]).sum(2), (a[:, None, :] < b[None]).sum(2))


def _u16(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.uint16
    return x.numpy().astype(np.int64)


@pytest.mark.parametrize("na,nb,m", [(20, 13, 64), (9, 70, 30), (64, 5, 100)])
def test_plain_counts_match_gtlt_pallas(na, nb, m):
    a = _regs(na, m, seed=na * 100 + m)
    b = _regs(nb, m, seed=nb * 100 + m + 1)
    b[:, ::4] = a[0, ::4]
    gt, lt = G.gtlt_counts(_t(a), _t(b))
    want_gt, want_lt = gtlt_pallas(a, b, tm=8, tn=128)
    np.testing.assert_array_equal(_u16(gt), np.asarray(want_gt))
    np.testing.assert_array_equal(_u16(lt), np.asarray(want_lt))


@pytest.mark.parametrize("n,m", [(1, 64), (2, 30), (63, 64), (129, 30),
                                 (200, 128)])
def test_plain_self_counts_match_gtlt_self_pallas(n, m):
    a = _regs(n, m, seed=3 * n + m)
    got = _u16(G.gtlt_self_counts(_t(a)))
    want_gt, want_lt = gtlt_self_pallas(a, t=64)
    np.testing.assert_array_equal(got, np.asarray(want_gt))
    # the kernel's layout: lt of the pair (i, j) sits at (j, i)
    np.testing.assert_array_equal(got.T, np.asarray(want_lt))
    assert (np.diag(got) == 0).all()


@pytest.mark.parametrize("m", [30, 64, 256, 1024])
@pytest.mark.parametrize("n", [1, 2, 63, 129])
def test_plain_counts_match_count_gtlt(n, m):
    a = _regs(n, m, seed=7 * n + m)
    b = _regs(n + 3, m, seed=7 * n + m + 1)
    gt, lt = G.gtlt_counts(_t(a), _t(b))
    want_gt, want_lt = count_gtlt(a, b)
    np.testing.assert_array_equal(_u16(gt), np.asarray(want_gt))
    np.testing.assert_array_equal(_u16(lt), np.asarray(want_lt))
    self_gt = _u16(G.gtlt_self_counts(_t(a)))
    want_gt, want_lt = count_gtlt(a, a)
    np.testing.assert_array_equal(self_gt, np.asarray(want_gt))
    np.testing.assert_array_equal(self_gt.T, np.asarray(want_lt))


def test_planted_rows_count_every_register():
    m = 64
    a = _regs(8, m, seed=5)
    gt = _u16(G.gtlt_self_counts(_t(a)))
    assert gt[3, 2] == m and gt[2, 3] == 0            # all ones vs all zero
    assert gt[0, 7] == gt[7, 0] == 0                  # identical rows
    assert gt[4, 2] == m and gt[3, 4] == m            # 2^63 and 2^63 - 1
    # the top-bit half of row 4 against itself shifted by one register
    b = a[4:5, np.r_[1:m, 0]].copy()
    g, lt = G.gtlt_counts(_t(a[4:5].copy()), _t(b))
    assert (_u16(g), _u16(lt)) == (m // 2, m // 2)


def test_plain_chunks_agree_with_one_pass(monkeypatch):
    """Row chunks of the plain version (a few rows per compare) give the
    counts of one unchunked compare."""
    a, b = _regs(37, 30, seed=8), _regs(11, 30, seed=9)
    want = _naive(a, b)
    monkeypatch.setattr(G, "_PLAIN_CHUNK", 3 * 11 * 30)
    gt, lt = G.gtlt_counts(_t(a), _t(b))
    np.testing.assert_array_equal(_u16(gt), want[0])
    np.testing.assert_array_equal(_u16(lt), want[1])
    np.testing.assert_array_equal(_u16(G.gtlt_self_counts(_t(a))),
                                  _naive(a, a)[0])


def test_cpu_tensors_take_plain_versions_without_launching():
    G.self_launches.reset_launches()
    G.rect_launches.reset_launches()
    a, b = _t(_regs(5, 64, seed=3)), _t(_regs(6, 64, seed=4))
    assert torch.equal(G.gtlt_self_counts(a), G.gtlt_self_counts_plain(a))
    assert all(torch.equal(x, y) for x, y in
               zip(G.gtlt_counts(a, b), G.gtlt_counts_plain(a, b)))
    assert G.self_launches.launches == 0 and G.rect_launches.launches == 0


def test_wrappers_reject_bad_inputs():
    a = _t(_regs(4, 64, seed=4))
    with pytest.raises(TypeError):
        G.gtlt_self_counts(a.to(torch.float64))
    with pytest.raises(ValueError):
        G.gtlt_self_counts(a[:, ::2])                  # not contiguous
    with pytest.raises(ValueError):
        G.gtlt_self_counts(a[:0])                      # no rows
    with pytest.raises(ValueError):
        G.gtlt_self_counts(torch.zeros((2, 1 << 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        G.gtlt_counts(a, a[:, :32].contiguous())       # m differs
    with pytest.raises(ValueError):
        G.gtlt_self_counts(a.to("meta"))               # neither cpu nor cuda
    with pytest.raises(ValueError):
        G.gtlt_counts(a, a.to("meta"))                 # devices differ
