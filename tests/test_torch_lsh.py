"""Port parity for the LSH index (cmp/lsh.py), on the CPU.

Over the same seeded signatures, for nLSH in {1, 2, 4}, the port's index
must hold the JAX package's table shapes, group indices and keys, and
give its candidate pairs (with their shared-bucket counts, per-item cap
and saturation) and intra-round candidates. `save` and `save_ssi` must
write the JAX package's bytes (compared after gzip, whose header carries
a time stamp), and each file must load back into an index that gives the
same candidates in both packages. The same holds for the bottom-k index
over exact k-mer sets (`--set`, `--countdict`).
"""

import gzip

import numpy as np
import pytest

from dashing2_tpu.cmp import lsh as JL
from dashing2_tpu_torch.cmp import lsh as PL


def _signatures(n: int, m: int, seed: int) -> np.ndarray:
    """Families of f64 signatures: rows of one family share about 70% of
    their registers, so the index has buckets of every size."""
    rng = np.random.default_rng(seed)
    base = rng.exponential(size=(n // 8 + 1, m))
    sigs = base[rng.integers(0, len(base), n)]
    return np.where(rng.random((n, m)) < 0.3,
                    rng.exponential(size=(n, m)), sigs)


@pytest.fixture(scope="module", params=[1, 2, 4])
def indexes(request):
    sigs = _signatures(400, 64, seed=request.param)
    return (request.param, JL.LSHIndex.build(sigs, request.param),
            PL.LSHIndex.build(sigs.copy(), request.param))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_keys_equal_jax(indexes):
    nlsh, jidx, pidx = indexes
    assert (pidx.m, pidx.nperhashes, pidx.nperrows) == \
        (jidx.m, jidx.nperhashes, jidx.nperrows)
    assert len(pidx.keys) == nlsh
    _same(pidx.group_indices, jidx.group_indices)
    _same(pidx.keys, jidx.keys)


@pytest.mark.parametrize("cap", [0, 3, 35])
def test_candidate_pairs_equal_jax(indexes, cap):
    _, jidx, pidx = indexes
    got = pidx.candidate_pairs(max_per_item=cap)
    _same(got, jidx.candidate_pairs(max_per_item=cap))
    assert len(got[0]) > 100 and (got[0] < got[1]).all()


def test_intra_candidates_equal_jax(indexes):
    _, jidx, pidx = indexes
    items = np.random.default_rng(5).permutation(400)[:256]
    got = pidx.intra_candidates(items)
    _same(got, jidx.intra_candidates(items))
    assert len(got[0]) > 0


def _raw(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("suffix", ["idx", "ssi"])
def test_saved_index_bytes_equal_jax_and_round_trip(indexes, suffix,
                                                    tmp_path):
    _, jidx, pidx = indexes
    p, j = str(tmp_path / f"port.{suffix}"), str(tmp_path / f"jax.{suffix}")
    if suffix == "ssi":
        pidx.save_ssi(p)
        jidx.save_ssi(j)
        loaded = PL.LSHIndex.load_ssi(p), JL.LSHIndex.load_ssi(j)
    else:
        pidx.save(p)
        jidx.save(j)
        loaded = PL.LSHIndex.load(p), JL.LSHIndex.load(j)
    assert _raw(p) == _raw(j)
    want = jidx.candidate_pairs(max_per_item=35)
    if suffix == "ssi":
        # a loaded .ssi keeps bucket maps only; its candidates come from
        # them (32-bit keys), in both packages alike
        want = loaded[1].candidate_pairs(max_per_item=35)
    else:
        _same(loaded[0].keys, pidx.keys)
    _same(loaded[0].candidate_pairs(max_per_item=35), want)


def _bottomk_lists(n: int, k: int, seed: int):
    """Each item's first k u64 hashes (sorted), items of a family
    sharing most of them, one item empty and u64::max in a few."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 62, size=600, dtype=np.uint64) * 4
    pool[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    out = []
    for i in range(n):
        fam = i % 12
        s = np.unique(rng.choice(pool[fam * 40:fam * 40 + 80], size=60))
        out.append(s[:k] if i != 7 else s[:0])
    return out


@pytest.mark.parametrize("cap", [0, 3, 35])
def test_bottom_k_candidates_equal_jax(cap):
    bk = _bottomk_lists(300, 16, seed=cap)
    got = PL.LSHIndex.build(np.zeros((0, 0)), 2, bottomk=bk)
    want = JL.LSHIndex.build(np.zeros((0, 0)), 2, bottomk=bk)
    assert got.bottomk_mode and want.bottomk_mode
    pairs = got.candidate_pairs(max_per_item=cap)
    _same(pairs, want.candidate_pairs(max_per_item=cap))
    assert len(pairs[0]) > 100 and (pairs[0] < pairs[1]).all()


@pytest.mark.parametrize("suffix", ["idx", "ssi"])
def test_bottom_k_indexes_bytes_equal_jax_and_round_trip(suffix, tmp_path):
    """An exact-set (bottom-k) index writes the JAX package's bytes in
    both formats and loads back into the same candidates in both
    packages (a loaded .ssi from its one map of 32-bit keys)."""
    bk = _bottomk_lists(200, 12, seed=9)
    pidx = PL.LSHIndex.build(np.zeros((0, 0)), 2, bottomk=bk)
    jidx = JL.LSHIndex.build(np.zeros((0, 0)), 2, bottomk=bk)
    p, j = str(tmp_path / f"port.{suffix}"), str(tmp_path / f"jax.{suffix}")
    if suffix == "ssi":
        pidx.save_ssi(p)
        jidx.save_ssi(j)
        loaded = PL.LSHIndex.load_ssi(p), JL.LSHIndex.load_ssi(j)
    else:
        pidx.save(p)
        jidx.save(j)
        loaded = PL.LSHIndex.load(p), JL.LSHIndex.load(j)
        _same(loaded[0].bottomk, bk)
    assert _raw(p) == _raw(j)
    assert loaded[0].bottomk_mode
    _same(loaded[0].candidate_pairs(max_per_item=35),
          loaded[1].candidate_pairs(max_per_item=35))


@pytest.mark.parametrize("n", [50, 9999, 10001, 2_000_000])
def test_default_candidates_equal_jax(n):
    assert PL.default_candidates(n) == JL.default_candidates(n)
    assert PL.default_candidates(n, 7) == 7
