"""Planted CSetSketch pass operands for the port's tests (no jax here).

`planted_rows(m, seed)` gives (sx1, srv, k, threshold), CPU tensors of
seven items of 160 rows, and the winners planted in them. csrc/css.cu
walks a register's rows 32 at a time (a warp's lanes across a step), so
the rows are planted where its steps meet:

* equal rows (the same rv and x1, so equal draws for every register) at
  31/32 and 63/64, across a step boundary, and at 40/41, within a step;
* own-row hits on a step's first and last lane, rows 0, 95, 96 and 127:
  each planted row (and the first of each equal pair) owns a register
  (wyhash(rv) mod m) that no earlier row owns, so that register's least
  draw is that row's x1 itself, at that row (at the first of a pair);
* caps k of 160, 0, 1, 33 and 95 rows, a threshold that keeps 71 rows
  (the kept prefix ends inside a step), and one item of rows made from
  random hashes as css_sketch_many makes them (x1 ascending, the pass's
  threshold: walks that stop early), with rows 31 and 32 equal.

Items 0-5 have x1 = 2^-10 + d 2^-40 at row d (equal rows equal): their
walks do not stop early, so every planted row is reached. A row owns a
register only where one is left (none for m = 1 past row 0).
"""

import numpy as np
import torch

from dashing2_tpu_torch.ops import sketch_kernels as SK
from dashing2_tpu_torch.ops.css import _first_register

WIDTH = 160
PAIRS = ((31, 32), (40, 41), (63, 64))
HITS = (0, 95, 96, 127)
CAPS = (WIDTH, 0, 1, 33, 95, WIDTH)


def _own(rv: int, m: int) -> int:
    return int(_first_register(torch.tensor([rv], dtype=torch.int64), m))


def _planted_item(rng, m: int):
    """(x1, rv, {register: winning row}) of one item of WIDTH rows."""
    x1 = 2.0 ** -10 + np.arange(WIDTH) * 2.0 ** -40
    rv = rng.integers(-(1 << 63), 1 << 63, WIDTH, dtype=np.int64)
    firsts = {p[0] for p in PAIRS} | set(HITS)
    owned, wins = set(), {}
    for d in range(WIDTH):
        if any(d == b for _, b in PAIRS):
            a = d - 1
            x1[d], rv[d] = x1[a], rv[a]
            continue
        if d in firsts and len(owned) < m:
            while _own(int(rv[d]), m) in owned:
                rv[d] = rng.integers(-(1 << 63), 1 << 63, dtype=np.int64)
            wins[_own(int(rv[d]), m)] = d
        owned.add(_own(int(rv[d]), m))
    return x1, rv, wins


def planted_rows(m: int, seed: int):
    """((sx1, srv, k, threshold), winners): the operands of one pass at
    m registers, CPU tensors (7 items x WIDTH rows), and a dict
    {(item, register): row} of the planted winners whose rows are kept."""
    rng = np.random.default_rng(seed)
    sx1 = np.empty((7, WIDTH))
    srv = np.empty((7, WIDTH), np.int64)
    winners = {}
    t = np.full(7, 1e300)
    for i in range(6):
        sx1[i], srv[i], wins = _planted_item(rng, m)
        if i == 5:
            t[i] = sx1[i, 70]
        for j, d in wins.items():
            if d < CAPS[i] and sx1[i, d] <= t[i]:
                winners[(i, j)] = d
    h = rng.integers(0, 1 << 64, WIDTH, dtype=np.uint64)
    x1, rv = SK._css_x1(torch.from_numpy(h.view(np.int64)), m)
    order = torch.sort(x1, stable=True)[1]
    sx1[6], srv[6] = x1[order].numpy(), rv[order].numpy()
    sx1[6, 32], srv[6, 32] = sx1[6, 31], srv[6, 31]
    t[6] = (np.log(m) + 8.0) / WIDTH
    k = torch.tensor(CAPS + (WIDTH,))
    return (torch.from_numpy(sx1), torch.from_numpy(srv), k,
            torch.from_numpy(t)), winners
