"""The CountSketch of `-c` in the port (ops/countsketch.py), on the CPU.

* The plain version against the JAX package's device engine
  `countsketch_counts` (a sort of the bucket ids with the signs riding
  along and an int32 cumsum), exactly: ids and |sums| over random
  streams, streams whose repeats cancel to zero buckets, u64 hashes >=
  2^63 and the empty stream, alone and in batches that mix them with
  empty streams, at cssize in {1, 7, 2^20, 2^31 - 1}. Integer sums:
  tolerance zero.
* A model of csrc/countsketch.cu's plan in torch (each stream's shift,
  the bins' counts and starts, the packed entries in any order within a
  bin, the dense and the table form with its range splits, the
  placement), its constants read from the source, against the plain
  version on tests/countsketch_planted.py's batches; and the kernel's
  modulo by a reciprocal against ops/hashes.py `u64_mod`.
* The wrapper refuses batches of 2^31 hashes or more, bucket counts
  outside [1, 2^31), offsets that do not rise from 0 to n, and devices
  other than the CPU and the card.
"""

import bisect
import os
import re
import sys

import numpy as np
import pytest
import torch

from dashing2_tpu.ops import sketch_kernels as JSK
from dashing2_tpu_torch.ops import countsketch as CS
from dashing2_tpu_torch.ops import hashes as DH

sys.path.insert(0, os.path.dirname(__file__))
from countsketch_planted import C31, planted_batches  # noqa: E402

_SRC = open(CS.SOURCE).read()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC).group(1))


BIN_TARGET, DENSE_TARGET = _const("BIN_TARGET"), _const("DENSE_TARGET")
DENSE_SHIFT, DENSE_RATIO = _const("DENSE_SHIFT"), _const("DENSE_RATIO")
DENSE_MAX = 1 << DENSE_SHIFT
TABLE_FILL = _const("TABLE_FILL")


def _stream(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 1 << 64, n, dtype=np.uint64)
    if kind == "high":
        return rng.integers(1 << 63, 1 << 64, n, dtype=np.uint64)
    # repeats: each hash with its neighbour of the other parity in the
    # same bucket cancels
    base = rng.integers(0, 1 << 62, n // 2, dtype=np.uint64) * np.uint64(2)
    return rng.permutation(np.concatenate([base, base + np.uint64(1),
                                           base[: n // 8]]))


def _batch(streams, cssize):
    """countsketch_many's inputs as tensors: (hv, offsets)."""
    offsets = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=offsets[1:])
    hv = np.concatenate(streams) if streams else np.zeros(0, np.uint64)
    return torch.from_numpy(hv.view(np.int64)), torch.from_numpy(offsets)


def _dense(hv: np.ndarray, cssize: int):
    """(ids, |sums|) of the dense bucket array (np.bincount)."""
    idx = (hv % np.uint64(cssize)).astype(np.int64)
    sign = np.where((hv & np.uint64(1)).astype(bool), 1, -1)
    b = np.bincount(idx, weights=sign, minlength=cssize)
    nz = np.flatnonzero(b)
    return nz.astype(np.uint64), np.abs(b[nz])


@pytest.mark.parametrize("cssize", [1, 7, 1 << 20])
@pytest.mark.parametrize("kind", ["random", "high", "cancel"])
@pytest.mark.parametrize("n", [1, 1000, 50000])
def test_plain_equals_jax(cssize, kind, n):
    hv = _stream(kind, n, seed=n + cssize)
    want_ids, want_sums = JSK.countsketch_counts(hv, cssize)
    ids, sums = CS.countsketch_counts(torch.from_numpy(hv.view(np.int64)),
                                      cssize)
    np.testing.assert_array_equal(ids.numpy().astype(np.uint64), want_ids)
    assert sums.dtype == torch.float64
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    # the same stream between empty ones, against the dense bucket array
    (u0, c0), (u, c), (u1, c1) = CS.countsketch_many(
        [hv[:0], hv, hv[:0]], cssize)
    assert len(u0) == len(u1) == len(c0) == len(c1) == 0
    dense_ids, dense_sums = _dense(hv, cssize)
    np.testing.assert_array_equal(u, dense_ids)
    np.testing.assert_array_equal(c, dense_sums)


@pytest.mark.parametrize("cssize", [1, 7, 1 << 20, C31])
def test_batch_plain_equals_jax(cssize):
    """A batch of every kind and length between empty streams: each
    stream's ids and sums == the JAX engine's on it alone."""
    streams = [np.zeros(0, np.uint64)]
    for kind in ("random", "high", "cancel"):
        for n in (1, 1000, 50000):
            streams += [_stream(kind, n, seed=7 * n + len(kind)),
                        np.zeros(0, np.uint64)]
    got = CS.countsketch_many(streams, cssize)
    assert len(got) == len(streams)
    for hv, (u, c) in zip(streams, got):
        if len(hv) == 0:
            assert len(u) == len(c) == 0
            continue
        want_ids, want_sums = JSK.countsketch_counts(hv, cssize)
        np.testing.assert_array_equal(u, want_ids)
        assert c.dtype == np.float64
        np.testing.assert_array_equal(c, want_sums)


def test_empty_stream():
    ids, sums = CS.countsketch_counts(torch.zeros(0, dtype=torch.int64), 7)
    want_ids, want_sums = JSK.countsketch_counts(np.zeros(0, np.uint64), 7)
    assert ids.numel() == sums.numel() == len(want_ids) == len(want_sums) \
        == 0
    assert CS.countsketch_many([], 7) == []


def test_countsketch_refusals():
    big = torch.zeros(1, dtype=torch.int64).expand(1 << 31)
    offsets = torch.tensor([0, 1 << 31])
    with pytest.raises(ValueError, match="2\\^31"):
        CS.countsketch_batch(big, offsets, 7)
    hv = torch.arange(10, dtype=torch.int64)
    ten = torch.tensor([0, 10])
    for cssize in (0, 1 << 31):
        with pytest.raises(ValueError, match="cssize"):
            CS.countsketch_batch(hv, ten, cssize)
    with pytest.raises(TypeError):
        CS.countsketch_batch(hv.to(torch.int32), ten, 7)
    with pytest.raises(ValueError, match="contiguous"):
        CS.countsketch_batch(torch.arange(20)[::2], ten, 7)
    for bad in (torch.tensor([1, 10]), torch.tensor([0, 9]),
                torch.tensor([0, 6, 4, 10])):
        with pytest.raises(ValueError, match="offsets"):
            CS.countsketch_batch(hv, bad, 7)
    with pytest.raises(TypeError, match="offsets"):
        CS.countsketch_batch(hv, ten.to(torch.int32), 7)
    with pytest.raises(ValueError, match="no countsketch"):
        CS.countsketch_counts(torch.empty(5, dtype=torch.int64,
                                          device="meta"), 7)
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            CS.load_kernel()


# ----------------------------------------------------------------------
# a model of csrc/countsketch.cu's plan
# ----------------------------------------------------------------------

def stream_shift(n: int, c: int):
    """(shift, bins) of a stream of n hashes (the kernel's
    `stream_shift`)."""
    if n <= 0:
        return 0, 0
    dense = n * DENSE_RATIO >= c
    t = max(1, n // (DENSE_TARGET if dense else BIN_TARGET))
    s = 0
    while (c + (1 << s) - 1) >> s > t:
        s += 1
    if dense and s > DENSE_SHIFT:
        s = DENSE_SHIFT
    return s, (c + (1 << s) - 1) >> s


def mod_model(x: np.ndarray, c: int) -> np.ndarray:
    """The kernel's `mod_c`: umulhi(x, floor((2^64 - 1) / c)), the
    remainder estimate and two conditional subtractions, in u64 numpy."""
    m32 = np.uint64(0xFFFFFFFF)
    m = np.uint64(((1 << 64) - 1) // c)
    xl, xh = x & m32, x >> np.uint64(32)
    ml, mh = m & m32, m >> np.uint64(32)
    ll, lh, hl, hh = xl * ml, xl * mh, xh * ml, xh * mh
    mid = (ll >> np.uint64(32)) + (lh & m32) + (hl & m32)
    q = hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) \
        + (mid >> np.uint64(32))
    with np.errstate(over="ignore"):
        r = x - q * np.uint64(c)
    for _ in range(2):
        r = np.where(r >= np.uint64(c), r - np.uint64(c), r)
    return r


def _table_ranges(off, sign, lo, hi, stats):
    """The sparse form over the offsets in [lo, hi): [(offset, sum)]
    ascending, the range split in halves while it holds more than
    TABLE_FILL distinct offsets."""
    sel = (off >= lo) & (off < hi)
    keys, inv = torch.unique(off[sel], return_inverse=True)
    if keys.numel() > TABLE_FILL:
        stats["splits"] += 1
        mid = lo + (hi - lo) // 2
        return (_table_ranges(off, sign, lo, mid, stats)
                + _table_ranges(off, sign, mid, hi, stats))
    sums = torch.zeros(keys.numel(), dtype=torch.int64).index_add_(
        0, inv, sign[sel])
    keep = sums != 0
    return list(zip(keys[keep].tolist(), sums[keep].tolist()))


def plan_model(streams, c: int, seed: int):
    """(rows (K, 2), counts (S,), stats) of the kernel's plan over a
    batch, in torch on the CPU; the entries within a bin in a random
    order (a generator seeded with `seed`), as the scatter's atomics
    leave them."""
    lens = [len(s) for s in streams]
    plan = [stream_shift(n, c) for n in lens]
    shifts = torch.tensor([p[0] for p in plan], dtype=torch.int64)
    binbase = [0]
    for _, nbins in plan:
        binbase.append(binbase[-1] + nbins)
    nb = binbase[-1]
    assert nb <= len(streams) + sum(lens) // 1024 + 2   # the scratch's bins
    hv = torch.from_numpy(np.concatenate(streams).view(np.int64))
    sid = torch.repeat_interleave(torch.arange(len(streams)),
                                  torch.tensor(lens, dtype=torch.int64))
    b = DH.u64_mod(hv, c)
    sh = shifts[sid]
    local = b >> sh
    gbin = torch.tensor(binbase[:-1], dtype=torch.int64)[sid] + local
    packed = ((b - (local << sh)) << 1) | (hv & 1)
    assert bool((packed < (1 << 32)).all())
    counts = torch.bincount(gbin, minlength=nb)
    starts = [0] + torch.cumsum(counts, 0).tolist()
    perm = torch.randperm(len(gbin), generator=torch.Generator().manual_seed(
        seed))
    entries = packed[perm[torch.sort(gbin[perm], stable=True).indices]]
    stats = {"dense": 0, "sparse": 0, "splits": 0, "forms": ""}
    pairs, nnz = [], []
    for bn in range(nb):
        s = bisect.bisect_right(binbase, bn) - 1
        ent = entries[starts[bn]:starts[bn + 1]]
        E = len(ent)
        base = (bn - binbase[s]) << int(shifts[s])
        R = min(1 << int(shifts[s]), c - base)
        off, sign = ent >> 1, torch.where((ent & 1) != 0, 1, -1)
        if E and R <= DENSE_MAX and R <= E * DENSE_RATIO:
            stats["dense"] += 1
            stats["forms"] += "d"
            hist = torch.zeros(R, dtype=torch.int64).index_add_(0, off, sign)
            nz = torch.nonzero(hist).squeeze(1)
            got = list(zip(nz.tolist(), hist[nz].tolist()))
        elif E:
            stats["sparse"] += 1
            stats["forms"] += "s"
            got = _table_ranges(off, sign, 0, R, stats)
        else:
            stats["forms"] += "-"
            got = []
        nnz.append(len(got))
        pairs += [(base + k, abs(v)) for k, v in got]
    outpos = [0]
    for k in nnz:
        outpos.append(outpos[-1] + k)
    per_stream = np.array([outpos[binbase[i + 1]] - outpos[binbase[i]]
                           for i in range(len(streams))], np.int64)
    return np.array(pairs, np.int64).reshape(-1, 2), per_stream, stats


PLANTED = planted_batches()


@pytest.mark.parametrize("case", range(len(PLANTED)),
                         ids=[p[0] for p in PLANTED])
def test_plan_model_equals_plain(case):
    name, streams, c = PLANTED[case]
    rows, counts, stats = plan_model(streams, c, case)
    hv, offsets = _batch(streams, c)
    out, want_counts = CS.countsketch_batch(hv, offsets, c)
    np.testing.assert_array_equal(counts, want_counts.numpy())
    np.testing.assert_array_equal(rows, out[:len(rows)].numpy())
    assert len(rows) == int(want_counts.sum())
    ends = np.cumsum(counts)
    per = [rows[e - k:e] for k, e in zip(counts, ends)]
    for s, r in zip(streams, per):
        ids, sums = _dense(s, c) if c < 1 << 24 else (None, None)
        if ids is not None:
            np.testing.assert_array_equal(r[:, 0].astype(np.uint64), ids)
            np.testing.assert_array_equal(r[:, 1], sums)
    # the planted turns of the plan are where they were put
    if name.startswith("repeat"):
        shift, _ = stream_shift(len(streams[0]), c)
        assert shift == (DENSE_SHIFT if name == "repeat-dense" else 25)
        assert stats["dense" if name == "repeat-dense" else "sparse"] >= 1
        hot = 0x9E3779B97F4A7C15 % c
        assert dict(map(tuple, rows))[hot] >= 100000 - 2000
    if name.startswith("cancel-edges"):
        got = dict(map(tuple, rows))
        firsts = [49152] if name.endswith("dense") else [0, 1 << 30]
        lasts = [65535] if name.endswith("dense") else [(1 << 30) - 1, C31 - 1]
        for f, la in zip(firsts, lasts):
            assert f not in got and la not in got
            assert got[f + 1] == 2 and got[la - 1] == 3
        assert stats["dense" if name.endswith("dense") else "sparse"] >= 1
    if name == "ragged":
        assert stream_shift(len(streams[0]), c) == (DENSE_SHIFT, 62)
        got = dict(map(tuple, per[0]))
        assert (got[0], got[999424], got[c - 1]) == (3, 2, 5)
        assert stats["forms"][61] == "d"
        assert per[1].tolist() == [[c - 1, 1]]
    if name == "form-edge":
        # each stream's first bin: 1,023 entries sparse, 1,024 and 1,025
        # dense (the other bins hold about 1,024 each)
        assert stream_shift(65536, c) == (DENSE_SHIFT, 64)
        for i, (e0, s) in enumerate(zip((1023, 1024, 1025), streams)):
            assert int(((s % np.uint64(c)) < np.uint64(16384)).sum()) == e0
            assert stats["forms"][64 * i] == ("s" if e0 < 1024 else "d")
    if name.startswith("stream-edge"):
        shift, nb = stream_shift(4096, c)
        assert (shift, nb) == ((DENSE_SHIFT, 4) if c == 65536 else (15, 3))
        assert stats["sparse" if c == 65537 else "dense"] >= 1
    if name == "table-edge":
        assert stream_shift(4096, c) == (29, 4)
        # 4,096 keys fit, 4,097 split once, 20,000 down to 2^12-wide ranges
        one = [plan_model([s], c, 1)[2]["splits"] for s in streams]
        assert one[0] == 0 and one[1] >= 1 and one[2] > one[1]
    if name.startswith("mixed"):
        assert counts[[0, 2, 3, 6]].tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("c", [1, 2, 3, 7, 1 << 20, 1000003, (1 << 31) - 2,
                               C31])
def test_fast_mod_model_equals_u64_mod(c):
    """The kernel's modulo by a reciprocal (mod_model) == u64_mod at 0,
    2^64 - 1, multiples of c and their neighbours, and 10^6 random
    hashes."""
    rng = np.random.default_rng(c)
    top = (1 << 64) - 1
    q = np.concatenate([rng.integers(0, top // c, 1000, dtype=np.uint64),
                        np.array([0, 1, top // c], np.uint64)])
    mult = q * np.uint64(c)
    with np.errstate(over="ignore"):
        x = np.concatenate([
            np.array([0, 1, top, top - 1, 1 << 63, (1 << 63) - 1],
                     np.uint64),
            mult, mult + np.uint64(1), mult - np.uint64(1),
            rng.integers(0, 1 << 64, 1000000, dtype=np.uint64)])
    want = DH.u64_mod(torch.from_numpy(x.view(np.int64)), c).numpy()
    np.testing.assert_array_equal(mod_model(x, c).astype(np.int64), want)
    np.testing.assert_array_equal(want, (x % np.uint64(c)).astype(np.int64))
