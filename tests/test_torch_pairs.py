"""Port parity for the pair-list measures (`measure_pairs`), on the CPU.

The neighbour graphs refine their LSH candidates and the greedy dedup
resolves its rounds through `measure_pairs`: counts for an explicit list
of item pairs, then the measure. The same seeded sketches and pair
lists (with pairs of an item with itself and repeated pairs) go through
the JAX package's function and the port's, for every register kind and
every measure, on both of the JAX package's count routes: its host route
(the default on its CPU backend) and its device engines
(DASHING2_TPU_PAIR_DEVICE=force). Both end in its numpy epilogue; the
port's values must equal them bit for bit.

`pair_counts` itself must equal a direct numpy count for every register
type, in unsigned order.
"""

import numpy as np
import pytest
import torch

from dashing2_tpu.cmp import core as JC
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.enums import Measure as JMeasure
from dashing2_tpu.result import SketchingResult as JResult
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.ops.pair_counts import pair_counts
from dashing2_tpu_torch.result import from_reference

KINDS = {
    "nibble-bbit": dict(fd_level=0.5, truncation_method=1),
    "nibble-ab": dict(fd_level=0.5),
    "u8-bbit": dict(fd_level=1.0, truncation_method=1),
    "u8-ab": dict(fd_level=1.0),
    "u16-bbit": dict(fd_level=2.0, truncation_method=1),
    "u16-ab": dict(fd_level=2.0),
    "u32-bbit": dict(fd_level=4.0, truncation_method=1),
    "u32-ab": dict(fd_level=4.0),
    "full": dict(),
    "eqfull": dict(truncation_method=1),
}
MEASURES = ["SIMILARITY", "INTERSECTION", "UNION_SIZE", "CONTAINMENT",
            "SYMMETRIC_CONTAINMENT", "POISSON_LLR"]
ROUTES = {"host": {}, "device": {"DASHING2_TPU_PAIR_DEVICE": "force"}}


def _sketches(n: int, m: int, seed: int) -> JResult:
    rng = np.random.default_rng(seed)
    base = rng.exponential(size=(n // 4 + 1, m))
    sigs = base[rng.integers(0, len(base), n)]
    sigs = np.where(rng.random((n, m)) < 0.15,
                    rng.exponential(size=(n, m)), sigs)
    res = JResult(names=[f"s{i}" for i in range(n)])
    res.signatures = sigs
    res.cardinalities = rng.uniform(1e3, 1e5, n)
    return res


def _pairs(n: int, npairs: int, seed: int):
    """Seeded pairs with i == j pairs and repeated pairs among them."""
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, n, npairs)
    ib = rng.integers(0, n, npairs)
    ib[:20] = ia[:20]                     # an item with itself
    ia[20:40], ib[20:40] = ia[40:60], ib[40:60]     # repeats
    ia[60:80], ib[60:80] = ib[40:60], ia[40:60]     # repeats, swapped
    return ia, ib


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("msr", MEASURES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_measure_pairs_equal_jax(kind, msr, route, monkeypatch):
    n, m = 150, 100
    ref = _sketches(n, m, seed=len(kind))
    port_res = from_reference(ref)
    kw = dict(k=31, sketchsize=m, **KINDS[kind])
    jopts = JOptions(**kw, measure=JMeasure[msr])
    popts = Dashing2DistOptions(**kw, measure=Measure[msr])
    ia, ib = _pairs(n, 3000, seed=m)
    for key, val in ROUTES[route].items():
        monkeypatch.setenv(key, val)
    jcreps, ref = JC._prep(jopts, ref)
    want = JC.measure_pairs(jopts, ref, jcreps, ia, ib)
    pcreps, port_res = PC._prep(popts, port_res)
    got = PC.measure_pairs(popts, port_res, pcreps, ia, ib, device="cpu")
    assert got.dtype == np.float32 and got.shape == (len(ia),)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if msr == "SIMILARITY":
        assert (got[:20] == got[:20].max()).all() and got.min() < 0.2
    # a second call serves the same registers from the result's cache
    cached = port_res._pair_dev_cache
    again = PC.measure_pairs(popts, port_res, pcreps, ib, ia, device="cpu")
    assert port_res._pair_dev_cache is cached
    if msr in ("SIMILARITY", "INTERSECTION", "UNION_SIZE",
               "SYMMETRIC_CONTAINMENT", "POISSON_LLR") \
            and not kind.endswith("-ab"):
        np.testing.assert_array_equal(again, got)


def test_measure_pairs_of_an_empty_list():
    ref = from_reference(_sketches(10, 64, 1))
    opts = Dashing2DistOptions(k=31, sketchsize=64)
    creps, ref = PC._prep(opts, ref)
    out = PC.measure_pairs(opts, ref, creps, np.zeros(0, np.int64),
                           np.zeros(0, np.int64), device="cpu")
    assert out.shape == (0,) and out.dtype == np.float32


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.uint64])
def test_pair_counts_equal_numpy(dt):
    rng = np.random.default_rng(7)
    n, m = 50, 37
    top = int(np.iinfo(dt).max)
    a = rng.integers(0, top, size=(n, m), dtype=np.uint64, endpoint=True
                     ).astype(dt)
    a[1] = top
    a[2] = 0
    a[3, ::2] = a[4, ::2]
    ia, ib = _pairs(n, 20001, seed=3)      # more than two blocks
    regs = torch.from_numpy(a.view({np.uint8: np.uint8, np.uint16: np.int16,
                                    np.uint64: np.int64}[dt]))
    eq, gt, lt = pair_counts(regs, torch.from_numpy(ia),
                             torch.from_numpy(ib), block=8192)
    x, y = a[ia], a[ib]
    np.testing.assert_array_equal(eq.numpy(), (x == y).sum(1))
    np.testing.assert_array_equal(gt.numpy(), (x > y).sum(1))
    np.testing.assert_array_equal(lt.numpy(), (x < y).sum(1))
    assert eq.dtype == gt.dtype == lt.dtype == torch.int32


def test_pair_counts_rejects_mixed_devices_and_shapes():
    regs = torch.zeros((4, 8), dtype=torch.uint8)
    i = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        pair_counts(regs, i, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        pair_counts(regs.to(torch.float32), i, i)
