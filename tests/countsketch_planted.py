"""Planted CountSketch batches for the port's tests (no jax here).

`planted_batches()` gives (name, streams, cssize) triples: lists of u64
hash streams, each batch counted by one `countsketch_batch` call.
csrc/countsketch.cu cuts a stream's buckets into bins of 2^shift buckets
(the shift from the stream's length n and cssize: at most 16,384 buckets
a bin where n * 16 >= cssize, a dense stream, else bins of about 1,024
hashes) and counts each bin in one of two forms (a dense histogram where
its R buckets hold at least R / 16 entries and R <= 16,384, else a hash
table of at most 4,096 keys a range and a sort), so the streams are
planted where its plan turns:

* `repeat-dense`, `repeat-sparse`: one hash repeated 10^5 times among
  2,000 others (at cssize 2^20 a dense stream's bin of 16,384 buckets;
  at 2^31 - 1 a sparse stream's bin of 2^25 buckets);
* `cancel-edges`: a bin's first and last bucket each get as many odd as
  even hashes, so their sums are 0, and their neighbours +2 and -3: bin
  3 of a dense stream at cssize 2^20 - 1 (buckets 49,152-65,535) and
  bin 0 of a sparse one at 2^31 - 1 (buckets 0 to 2^30 - 1), whose bin
  1 is one bucket short of its range;
* `ragged`: cssize 1,000,003 (prime: the last bin, from 999,424, shorter
  than its 16,384), sums of +3 in bucket 0, +2 at the last bin's first
  bucket and -5 in bucket cssize - 1, and a second stream of one hash in
  that bucket;
* `form-edge`: a dense stream (65,536 hashes at cssize 2^20, bins of
  16,384 buckets) whose first bin holds 1,023, 1,024 or 1,025 entries;
* `stream-edge`: 4,096 hashes at cssize 65,536 (n * 16 = cssize: dense)
  and 65,537 (sparse);
* `table-edge`: 4,096, 4,097 and 20,000 distinct buckets in one bin's
  range (bin 0 of 2^29 buckets at cssize 2^31 - 1), the last two past
  the table's 4,096 keys, so their ranges split;
* `mixed`: empty streams between streams of 1, 1,000 and 50,000 random
  hashes, at cssize 1, 7, 2^20 and 2^31 - 1.
"""

import numpy as np

C31 = (1 << 31) - 1


def _rand(rng, n: int) -> np.ndarray:
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


def in_buckets(rng, buckets, cssize: int, odd=None) -> np.ndarray:
    """One hash in each of `buckets` (h mod cssize); with `odd` given (an
    odd cssize), each hash odd or even as it says."""
    b = np.asarray(buckets, dtype=np.uint64)
    q = rng.integers(0, (1 << 62) // cssize, len(b), dtype=np.uint64)
    h = q * np.uint64(cssize) + b
    if odd is not None:
        assert cssize % 2 == 1
        # h + cssize keeps the bucket and flips the parity
        want = np.broadcast_to(np.asarray(odd, dtype=bool), h.shape)
        h = np.where(((h & np.uint64(1)) == 1) != want, h + np.uint64(cssize),
                     h)
    return h


def _rand_avoiding(rng, n: int, cssize: int, buckets) -> np.ndarray:
    """n random hashes, none of them in `buckets`."""
    h = _rand(rng, n)
    return h[~np.isin(h % np.uint64(cssize), np.asarray(buckets, np.uint64))]


def _edges(rng, first: int, last: int, cssize: int) -> np.ndarray:
    """first and last: one odd and one even hash each (sum 0); first + 1:
    two odd (+2); last - 1: three even (-3)."""
    return np.concatenate([
        in_buckets(rng, [first, first, last, last], cssize,
                   [True, False, True, False]),
        in_buckets(rng, [first + 1] * 2, cssize, True),
        in_buckets(rng, [last - 1] * 3, cssize, False)])


def planted_batches():
    rng = np.random.default_rng(2027)
    out = []
    for name, c in (("repeat-dense", 1 << 20), ("repeat-sparse", C31)):
        s = np.concatenate([_rand(rng, 2000),
                            np.full(100000, 0x9E3779B97F4A7C15, np.uint64)])
        out.append((name, [rng.permutation(s)], c))
    c_dense = (1 << 20) - 1
    out.append(("cancel-edges-dense", [rng.permutation(np.concatenate([
        _rand_avoiding(rng, 120000, c_dense, [49152, 49153, 65534, 65535]),
        _edges(rng, 49152, 65535, c_dense)]))], c_dense))
    edges = [0, 1, (1 << 30) - 2, (1 << 30) - 1, 1 << 30, (1 << 30) + 1,
             C31 - 2, C31 - 1]
    out.append(("cancel-edges-sparse", [rng.permutation(np.concatenate([
        _rand_avoiding(rng, 3000, C31, edges),
        _edges(rng, 0, (1 << 30) - 1, C31),
        _edges(rng, 1 << 30, C31 - 1, C31)]))], C31))
    c = 1000003
    out.append(("ragged", [rng.permutation(np.concatenate([
        _rand_avoiding(rng, 70000, c, [0, 999424, c - 1]),
        in_buckets(rng, [0] * 3 + [999424] * 2, c, True),
        in_buckets(rng, [c - 1] * 5, c, False)])),
        in_buckets(rng, [c - 1], c, True)], c))
    c = 1 << 20
    streams = []
    for e0 in (1023, 1024, 1025):
        first = in_buckets(rng, rng.integers(0, 16384, e0), c)
        rest = in_buckets(rng, rng.integers(16384, c, 65536 - e0), c)
        streams.append(rng.permutation(np.concatenate([first, rest])))
    out.append(("form-edge", streams, c))
    for c in (65536, 65537):
        out.append((f"stream-edge-{c}", [_rand(rng, 4096)], c))
    streams = [rng.permutation(np.arange(1, d + 1, dtype=np.uint64) * 3)
               for d in (4096, 4097, 20000)]
    out.append(("table-edge", streams, C31))
    for c in (1, 7, 1 << 20, C31):
        lens = (0, 1, 0, 0, 1000, 50000, 0, 1)
        out.append((f"mixed-{c}", [_rand(rng, n) for n in lens], c))
    return out
