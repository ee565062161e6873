"""The CSetSketch pass of the port (ops/css.py), on the CPU.

* `css_pass_plain` against the JAX `_css_pass` over the same hashes, at
  m in {64, 1024}, items of 1 to 7000 hashes (below and above the
  pass's cap of max(4096, 6m) rows) and thresholds that keep every row
  or cut the rows: the registers and the cutoff within CSS_ULP ulp (the
  port's own f64 log against XLA's, README "Documented deviations"),
  the winners (mapped to the hash's index) equal.
* `css_walk_plain`, the early-exit walk in plain torch, equal bit for
  bit to the full pass (registers, cutoff, winners), on planted items:
  duplicate rows (equal draws, the first row wins), caps below the row
  count, thresholds inside the rows, an item with no row kept;
  `walk_draws` gives the walk's own count of evaluated rows.
* The same a row at a time and 32 rows a step (csrc/css.cu's schedule)
  on tests/css_planted.py's rows: equal rows across a step boundary and
  within a step, own-row hits on a step's first and last lane, caps of
  0, 1, 33 and 95 rows; the planted winners win. The step walk's draws
  are the row walk's rounded up to whole steps (within the kept rows).
* `lane_slot_ratio` and `step_slot_ratio` against direct loops.
* The early exit's premise: -log64(u) >= 0 for u at 1, its 2^20 nearest
  f64 neighbours below 1, 2^-64, 1e-300 and 10^6 values spread over
  (0, 1), so every draw of a row is at least its x1.
* The wrapper without a card: a CUDA request raises (the kernel cannot
  build, the device cannot be reached), another device is refused.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.ops import sketch_kernels as JSK
from dashing2_tpu_torch.ops import css as CSS
from dashing2_tpu_torch.ops import sketch_kernels as SK
from dashing2_tpu_torch.ops.fixedmath import log64

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from css_planted import planted_rows  # noqa: E402

# the port's f64 log against XLA's CPU log (the C library's)
CSS_ULP = 4


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a.view(np.int64) - b.view(np.int64))
    return np.where(a == b, 0, d)


def _rows(hashes: np.ndarray, m: int):
    """(sx1, srv, perm) of one item's hashes, as css_sketch_many orders
    them: x1 ascending, the lower index first among equal x1."""
    x1, rv = SK._css_x1(torch.from_numpy(hashes.view(np.int64)), m)
    sx1, perm = torch.sort(x1, stable=True)
    return sx1, rv[perm], perm


@pytest.mark.parametrize("m,n,cut", [
    (64, 1, False), (64, 300, False), (64, 3000, True), (64, 7000, False),
    (64, 7000, True), (1024, 5, False), (1024, 2000, True),
    (1024, 7000, False)])
def test_plain_pass_matches_jax(m, n, cut):
    rng = np.random.default_rng(m * 7 + n)
    hashes = np.unique(rng.integers(0, 1 << 64, n, dtype=np.uint64))
    hashes = rng.permutation(hashes)
    cap = min(len(hashes), max(4096, 6 * m))
    t = (np.log(m) + 8.0) / len(hashes)
    if cut:
        # a threshold inside the kept rows: a cutoff below +inf
        t /= 16.0
    want_r, want_c, want_w = JSK._css_pass(
        jnp.asarray(hashes), jnp.ones(len(hashes), bool), m=m, cap=cap,
        threshold=jnp.float64(t))
    sx1, srv, perm = _rows(hashes, m)
    got_r, got_c, got_w = CSS.css_pass_plain(
        sx1[None, :cap].contiguous(), srv[None, :cap].contiguous(),
        torch.tensor([cap]), torch.tensor([t], dtype=torch.float64), m,
        return_ids=True)
    assert _ulps(got_r[0].numpy(), np.asarray(want_r)).max() <= CSS_ULP
    assert _ulps(got_c.numpy(), np.asarray(want_c)).max() <= CSS_ULP
    assert not cut or np.isfinite(float(want_c))
    np.testing.assert_array_equal(perm[got_w[0]].numpy(),
                                  np.asarray(want_w))


def _planted_batch(m: int, seed: int):
    """(sx1, srv, k, threshold) of five items with duplicate rows, caps
    below the width, thresholds inside the rows and no row kept."""
    rng = np.random.default_rng(seed)
    width = 600
    items = []
    for i in range(5):
        h = rng.integers(0, 1 << 64, width - 40 * i, dtype=np.uint64)
        h[5:15] = h[0]                  # equal rows: equal draws
        items.append(h)
    sx1 = torch.full((5, width), torch.inf, dtype=torch.float64)
    srv = torch.zeros((5, width), dtype=torch.int64)
    for i, h in enumerate(items):
        a, b, _ = _rows(h, m)
        sx1[i, :len(h)], srv[i, :len(h)] = a, b
    k = torch.tensor([width, 300, 37, width - 160, 1])
    base = (np.log(m) + 8.0) / width
    threshold = torch.tensor([1e300, base, base / 8.0, float(sx1[3, 99]),
                              float(sx1[4, 0]) / 2.0], dtype=torch.float64)
    return sx1, srv, k, threshold


@pytest.mark.parametrize("m", [1, 7, 64, 130])
def test_early_exit_walk_equals_full_pass(m):
    sx1, srv, k, t = _planted_batch(m, seed=m)
    full = CSS.css_pass_plain(sx1, srv, k, t, m, return_ids=True)
    walk = CSS.css_walk_plain(sx1, srv, k, t, m)
    for got, want in zip(walk[:3], full):
        assert torch.equal(got, want)
    regs, tcut, ids, draws = walk
    assert torch.isinf(regs[4]).all() and not ids[4].any()
    assert float(tcut[4]) == float(sx1[4, 0]) and not draws[4].any()
    assert float(tcut[3]) == float(sx1[3, 100])
    assert torch.isinf(tcut[0])
    kept = torch.tensor([600, 300, 37, 100, 0])
    assert (draws.amax(1) <= kept).all()
    # the walk stops early: fewer draws than kept rows on the wide items
    assert (draws[0].sum() < 600 * m) or m == 1
    assert torch.equal(CSS.walk_draws(sx1, k, t, regs, ids), draws)


def test_early_exit_walk_on_the_sketch_route():
    """Rows as css_sketch_many builds them (batched, padded with +inf),
    at the first pass's threshold and cap: walk == full pass."""
    m = 64
    rng = np.random.default_rng(4)
    hs = [rng.integers(0, 1 << 64, n, dtype=np.uint64)
          for n in (5000, 300, 40)]
    width = max(len(h) for h in hs)
    sx1 = torch.full((3, width), torch.inf, dtype=torch.float64)
    srv = torch.zeros((3, width), dtype=torch.int64)
    for i, h in enumerate(hs):
        a, b, _ = _rows(h, m)
        sx1[i, :len(h)], srv[i, :len(h)] = a, b
    n = np.array([len(h) for h in hs])
    cap = min(width, max(4096, 6 * m))
    k = torch.from_numpy(np.minimum(n, cap))
    t = torch.from_numpy((np.log(m) + 8.0) / n)
    sx1, srv = sx1[:, :cap].contiguous(), srv[:, :cap].contiguous()
    full = CSS.css_pass_plain(sx1, srv, k, t, m, return_ids=True)
    walk = CSS.css_walk_plain(sx1, srv, k, t, m)
    for got, want in zip(walk[:3], full):
        assert torch.equal(got, want)
    assert torch.equal(CSS.walk_draws(sx1, k, t, walk[0], walk[2]),
                       walk[3])
    assert walk[3][0].float().mean() < float(k[0])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int64) if x.is_floating_point() else x


@pytest.mark.parametrize("m", [1, 7, 33, 64, 130, 1024])
def test_step_walk_on_planted_rows(m):
    """Rows planted where the kernel's 32-row steps meet: the row walk
    and the step walk equal the full pass bit for bit (registers, tcut,
    winners), and the planted winners win."""
    (sx1, srv, k, t), winners = planted_rows(m, seed=m + 21)
    full = CSS.css_pass_plain(sx1, srv, k, t, m, return_ids=True)
    rows = CSS.css_walk_plain(sx1, srv, k, t, m)
    steps = CSS.css_walk_plain(sx1, srv, k, t, m, step=CSS.LANES)
    for f, r, s in zip(full, rows[:3], steps[:3]):
        assert torch.equal(_bits(r), _bits(f))
        assert torch.equal(_bits(s), _bits(f))
    regs, tcut, ids = full
    for (i, j), d in winners.items():
        assert int(ids[i, j]) == d and regs[i, j] == sx1[i, d], (i, j, d)
    if m >= 64:
        # every tie and lane hit planted, in items 0, 3 (k = 33: row 32,
        # a step's first lane, is the last kept) and 5 (71 rows kept)
        assert {d for (i, _), d in winners.items() if i == 0} \
            == {0, 31, 40, 63, 95, 96, 127}
        assert {d for (i, _), d in winners.items() if i == 3} == {0, 31}
        assert {d for (i, _), d in winners.items() if i == 5} \
            == {0, 31, 40, 63}
    # no kept row (k = 0): +inf and row 0; k = 1: every register row 0
    assert torch.isinf(regs[1]).all() and not ids[1].any()
    assert torch.isfinite(regs[2]).all() and not ids[2].any()
    assert torch.isinf(tcut[:5]).all() and float(tcut[5]) == float(sx1[5, 71])
    n = CSS.walk_draws(sx1, k, t, regs, ids)
    assert torch.equal(rows[3], n)
    kept = CSS._tcut(sx1, k, t)[0].sum(1, keepdim=True)
    whole = torch.minimum((n + CSS.LANES - 1) // CSS.LANES * CSS.LANES, kept)
    assert torch.equal(steps[3], whole)
    assert (steps[3] > 0).sum() == (n > 0).sum()


def _lane_slots_loop(draws: np.ndarray, lanes: int) -> float:
    slots = 0
    for item in draws:
        for g in range(0, len(item), lanes):
            slots += lanes * int(item[g:g + lanes].max())
    return slots / int(draws.sum())


def _step_slots_loop(draws: np.ndarray, lanes: int) -> float:
    slots = total = 0
    for n in draws.ravel():
        if n > 0:
            slots += lanes * -(-int(n) // lanes)
            total += int(n)
    return slots / total


@pytest.mark.parametrize("m,lanes", [(64, 32), (100, 32), (1024, 128),
                                     (7, 32)])
def test_slot_ratios_match_loops(m, lanes):
    rng = np.random.default_rng(m + lanes)
    draws = rng.geometric(1.0 / m, size=(5, m)).astype(np.int64)
    draws[1, : m // 2] = 0
    t = torch.from_numpy(draws)
    assert CSS.lane_slot_ratio(t, lanes) == pytest.approx(
        _lane_slots_loop(draws, lanes), rel=1e-12)
    assert CSS.step_slot_ratio(t, lanes) == pytest.approx(
        _step_slots_loop(draws, lanes), rel=1e-12)
    assert CSS.lane_slot_ratio(t, lanes) >= 1.0
    assert CSS.lane_slot_ratio(torch.zeros((2, m), dtype=torch.int64)) \
        == 1.0


def test_negative_log_is_never_negative():
    """-log64(u) >= 0 over (0, 1]: at 1, its 2^20 nearest neighbours
    below, 2^-64 (the least nonzero unit float), 1e-300 (the clamp) and
    10^6 values spread over the range."""
    near = 1.0 - np.arange(2 ** 20, dtype=np.float64) * 2.0 ** -53
    assert near[0] == 1.0 and near[1] == np.nextafter(1.0, 0.0)
    rng = np.random.default_rng(0)
    spread = np.exp(-rng.uniform(0, 690, 10 ** 6))
    u = np.concatenate([near, [2.0 ** -64, 1e-300], spread,
                        rng.uniform(0.5, 1.0, 10 ** 6)])
    neg = -log64(torch.from_numpy(u)).numpy()
    assert (neg >= 0).all()
    assert neg[0] == 0.0 and (neg[1:2 ** 20] > 0).all()
    # so a draw is at least its x1, with the draws' own IEEE sum
    x1 = rng.uniform(0, 1e-3, len(u))
    assert ((neg + x1) >= x1).all()


def test_css_pass_without_a_card():
    """On a machine without a card a CUDA request raises: the kernel does
    not build (no nvcc) and css_sketch_many cannot reach the device;
    tensors on another device are refused. The CPU takes the plain
    version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(Exception):
        CSS.load_kernel()
    items = [np.arange(1, 100, dtype=np.uint64)]
    with pytest.raises((RuntimeError, AssertionError)):
        SK.css_sketch_many(items, 64, "cuda")
    meta = [torch.empty((2, 3), dtype=torch.float64, device="meta"),
            torch.empty((2, 3), dtype=torch.int64, device="meta"),
            torch.empty(2, dtype=torch.int64, device="meta"),
            torch.empty(2, dtype=torch.float64, device="meta")]
    with pytest.raises(ValueError, match="no css_pass"):
        CSS.css_pass(*meta, 64)
    before = CSS.launches.launches
    sx1, srv, k, t = _planted_batch(16, seed=1)
    got = CSS.css_pass(sx1, srv, k, t, 16, return_ids=True)
    want = CSS.css_pass_plain(sx1, srv, k, t, 16, return_ids=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert CSS.launches.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "k", "m"])
def test_css_pass_checks_its_operands(bad):
    sx1, srv, k, t = _planted_batch(8, seed=2)
    m = 8
    if bad == "dtype":
        sx1 = sx1.float()
    elif bad == "shape":
        srv = srv[:, :10]
    elif bad == "k":
        k = k[:3]
    else:
        m = 0
    with pytest.raises((TypeError, ValueError)):
        CSS.css_pass(sx1, srv, k, t, m)
