"""Port parity for u128 exact sets (`--set`/`--countdict --long-kmers`),
on the CPU.

* `hash_chunk_batch128` (ops/oph_rows.py) against the JAX package's
  `_hash_chunk_batch128` in every case: a zero seed and a seed, w = k
  and w > k, downsampling, a filterset of masked low words; integers
  equal exactly;
* u128.py against the JAX package's: the file layout and `mod_u128`;
* the counting route's u128 sets (`sketch_fastx`) against the JAX
  package's, keys, counts and cardinalities;
* cmp/wcompare.py's joins on u128 keys (rank-encoded) against the JAX
  package's host posting joins: all pairs, blocks, pair lists;
* the CLI bytes against dashing2_tpu.cli: `--set`/`--countdict -k 40
  -2` all pairs in every measure, a `-Q` panel, `--topk`, `--greedy`,
  `--cache` cold then warm (`.kmerset128`), and `cmp --presketched`
  over the JAX package's `.kmerset128` files.
Tolerance zero throughout.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu import u128 as JU
from dashing2_tpu.cmp import wcompare as JW
from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.enums import KmerSketchResultType as JKres
from dashing2_tpu.result import SketchingResult as JResult
from dashing2_tpu.sketch import core as JC
from dashing2_tpu_torch import cli
from dashing2_tpu_torch import u128 as U
from dashing2_tpu_torch.cmp import wcompare as W
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import KmerSketchResultType
from dashing2_tpu_torch.io.corpus import (edited_sequences, write_corpus,
                                          write_fasta)
from dashing2_tpu_torch.ops import oph_rows as OR
from dashing2_tpu_torch.result import from_reference
from dashing2_tpu_torch.sketch import core as PC


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(list file, genome paths, by-record FASTA): 8 genomes of 3 kb in
    families, 16 records of 300-3,000 bp with N runs."""
    d = tmp_path_factory.mktemp("u128")
    paths = write_corpus(str(d / "fa"), seed=41, n_ancestors=2,
                         n_mutants=4, length=3000)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    fa = write_fasta(str(d / "recs.fa"), edited_sequences(
        42, 4, 4, length=(300, 3000), n_every=3))
    return str(lst), paths, fa


# (k, w, zero seed, seed, downsample, filterset)
CASES128 = {
    "k40": (40, 40, False, 0, 1.0, False),
    "k40-zero": (40, 40, True, 0, 1.0, False),
    "k40-w60": (40, 60, False, 0, 1.0, False),
    "k40-w60-zero": (40, 60, True, 0, 1.0, False),
    "k33-seed": (33, 33, False, 17, 1.0, False),
    "k50-w70-seed-ds": (50, 70, False, 5, 0.3, False),
    "k40-fs": (40, 40, False, 0, 1.0, True),
    "k63-w90-ds-fs": (63, 90, False, 2, 0.6, True),
}


@pytest.mark.parametrize("case", sorted(CASES128))
def test_hash_chunk_batch128_matches_jax(corpus, case):
    k, w, zero, seed, ds, use_fs = CASES128[case]
    opts = Dashing2Options(k=k, w=w, use128=True, seedseed=seed,
                           kmer_downsample_frac=ds, parse_by_seq=True)
    items = list(PC._load_items(opts, [corpus[2]]))
    hkw = dict(PC._hash_kwargs(opts, 2048), seed_is_zero=zero)
    rows = np.concatenate([r for r, _ in PC._iter_chunk_batches(
        opts, items, 2048, 1 << 30)])
    fs = None
    if use_fs:
        _, lo, v = OR.hash_chunk_batch128(torch.from_numpy(rows), hkw,
                                          opts.xormask2_hi)
        fs = np.unique(lo[v].numpy().view(np.uint64))[::3].copy()
    jhi, jlo, jv = JC._hash_chunk_batch128(
        jnp.asarray(rows),
        jnp.asarray(fs if fs is not None else np.zeros(1, np.uint64)),
        k=k, w=w, canon=True, xormask=opts.xormask,
        xormask2_hi=opts.xormask2_hi, seed_is_zero=zero,
        downsample_threshold=hkw["downsample_threshold"],
        use_filterset=use_fs, chunk_len=2048)
    hi, lo, v = OR.hash_chunk_batch128(
        torch.from_numpy(rows), hkw, opts.xormask2_hi,
        None if fs is None else torch.from_numpy(fs.view(np.int64)))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    vv = v.numpy()
    np.testing.assert_array_equal(hi.numpy().view(np.uint64)[vv],
                                  np.asarray(jhi)[vv])
    np.testing.assert_array_equal(lo.numpy().view(np.uint64)[vv],
                                  np.asarray(jlo)[vv])
    assert 0 < vv.sum() < vv.size


def test_u128_module_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, 500, dtype=np.uint64)
    a, ja = U.from_words(hi, lo), JU.from_words(hi, lo)
    assert a.tobytes() == ja.tobytes()
    np.testing.assert_array_equal(U.tofile_bytes(a), JU.tofile_bytes(ja))
    U.write_file(a, str(tmp_path / "x"))
    assert U.read_file(str(tmp_path / "x")).tobytes() == \
        JU.read_file(str(tmp_path / "x")).tobytes()
    for d in (7, 1 << 20, (1 << 31) - 1, (1 << 31) + 11, 1 << 40):
        np.testing.assert_array_equal(U.mod_u128(a, d), JU.mod_u128(ja, d))
    for got, want in zip(U.maskfn_words(hi, lo, 5, 9),
                         JU.maskfn_words(hi, lo, 5, 9)):
        np.testing.assert_array_equal(got, want)
    assert U.is_u128(a) and not U.is_u128(hi)
    # the port's lexsort forms of np.sort and np.unique, with repeats
    a = U.from_words(hi[rng.integers(0, 30, 2000)] % np.uint64(3),
                     lo[rng.integers(0, 30, 2000)])
    assert U.sort(a).tobytes() == np.sort(a).tobytes()
    u, c = np.unique(a, return_counts=True)
    gu, gc = U.unique_counts(a)
    assert gu.tobytes() == u.tobytes() and np.array_equal(gc, c)


@pytest.mark.parametrize("by_seq", [False, True])
@pytest.mark.parametrize("kres", ["set", "countdict"])
@pytest.mark.parametrize("kw", [dict(k=40), dict(k=40, w=60),
                                dict(k=36, count_threshold=2)])
def test_u128_sets_match_jax(corpus, kres, kw, by_seq):
    lst, paths, fa = corpus
    groups = [fa] if by_seq else paths
    jk = (JKres.FULL_MMER_SET if kres == "set"
          else JKres.FULL_MMER_COUNTDICT)
    want = JC.sketch_fastx(JOptions(kmer_result=jk, use128=True,
                                    parse_by_seq=by_seq, **kw), groups)
    got = PC.sketch_fastx(Dashing2Options(
        kmer_result=KmerSketchResultType(int(jk)), use128=True,
        parse_by_seq=by_seq, **kw), groups, device="cpu")
    assert got.names == want.names
    for g, w in zip(got.kmer_sets, want.kmer_sets):
        assert U.is_u128(g) and g.tobytes() == w.tobytes()
    if kres == "countdict":
        for g, w in zip(got.kmer_set_counts, want.kmer_set_counts):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)


def _u128_sets(n: int, seed: int, weighted: bool):
    """n sorted u128 sets by family from a shared pool whose keys share
    low words in pairs (and high words in pairs), so that a join on
    either word alone would count wrongly; the JAX and port results."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 64, 800, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, 800, dtype=np.uint64)
    lo[1::2] = lo[::2]
    hi[2::4] = hi[::4]
    pool = np.unique(U.from_words(hi, lo))
    sets, counts = [], []
    for i in range(n):
        fam = (i // 4) % 4
        picks = pool[fam * 150:fam * 150 + 300]
        s = np.unique(rng.choice(picks, int(rng.integers(0, 120))))
        sets.append(s)
        counts.append(rng.integers(1, 30, len(s)).astype(np.float64))
    jres = JResult(names=[str(i) for i in range(n)], kmer_sets=sets,
                   kmer_set_counts=counts if weighted else None)
    return jres, from_reference(jres)


@pytest.mark.parametrize("budget", [W.BUDGET, 53])
@pytest.mark.parametrize("weighted", [False, True])
def test_u128_joins_match_jax(weighted, budget):
    jres, res = _u128_sets(23, 5 + weighted, weighted)
    n = len(res.kmer_sets)
    rows, cols = np.arange(3, 17), np.arange(n)
    want = JW.exact_intersections(jres, rows, cols)
    got = W.exact_intersections(res, rows, cols, device="cpu",
                                budget=budget)
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    join = W.ExactJoin(W.device_sets(res, torch.device("cpu")),
                       np.arange(n), budget)
    up = join.block(rows, upper=True).numpy()
    full = JW.exact_intersections(jres, rows, np.arange(n))
    np.testing.assert_array_equal(
        up, full * (np.arange(n)[None, :] > rows[:, None]))
    rng = np.random.default_rng(9)
    ia = rng.integers(0, n, 300)
    ib = rng.integers(0, n, 300)
    want = JW.exact_intersections_pairs(jres, ia, ib)
    np.testing.assert_array_equal(
        W.exact_intersections_pairs(res, ia, ib, device="cpu",
                                    budget=budget), want)
    # the posting join, which the pair lists take where the padded
    # table would be pathological
    sets = W.device_sets(res, torch.device("cpu"))
    np.testing.assert_array_equal(W._pairs_posting(
        sets, torch.from_numpy(ia), torch.from_numpy(ib), budget).numpy(),
        want)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, capsys):
    res = []
    for tag, fn, extra in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, [])):
        out = tmp_path / f"{tag}.out"
        rc = fn(argv + ["--cmpout", str(out)] + extra)
        capsys.readouterr()
        res.append((rc, _read(out) if out.exists() else None))
    return res


U128_JOBS = {
    "set": ["--set"],
    "set-mash": ["--set", "--mash-distance"],
    "set-containment-asym": ["--set", "--containment",
                             "--asymmetric-all-pairs"],
    "set-symcontain-tsv": ["--set", "--symmetric-containment"],
    "set-intersection-phylip": ["--set", "--intersection", "--phylip"],
    "set-union": ["--set", "--union-size"],
    "countdict": ["--countdict"],
    "countdict-containment": ["--countdict", "--containment"],
    "set-topk": ["--set", "--topk", "3"],
    "countdict-topk": ["--countdict", "--topk", "3"],
    "set-threshold": ["--set", "-T", "0.2"],
    "countdict-greedy": ["--countdict", "--greedy", "0.3"],
}


@pytest.mark.parametrize("job", sorted(U128_JOBS))
def test_u128_cli_matches_jax(corpus, job, tmp_path, capsys):
    lst, _, _ = corpus
    binary = [] if job.endswith(("tsv", "phylip")) else ["--binary-output"]
    port, jax = _both(["sketch", "-k", "40", "-2"] + U128_JOBS[job] + binary
                      + ["-F", lst], tmp_path, capsys)
    assert port == jax and port[0] == 0 and port[1]


def test_u128_panel_matches_jax(corpus, tmp_path, capsys):
    lst, paths, _ = corpus
    refs, queries = tmp_path / "r.txt", tmp_path / "q.txt"
    refs.write_text("\n".join(paths[:6]) + "\n")
    queries.write_text("\n".join(paths[6:]) + "\n")
    port, jax = _both(["sketch", "--countdict", "-k", "40", "-2",
                       "--binary-output", "-F", str(refs), "-Q",
                       str(queries)], tmp_path, capsys)
    assert port == jax and len(port[1]) == 6 * 2 * 4


@pytest.mark.parametrize("kres", ["--set", "--countdict"])
def test_u128_cache_and_presketched_match_jax(corpus, kres, tmp_path,
                                              capsys):
    """--cache: the port's cold artifacts (.kmerset128, a count
    dictionary's keys and .kmercounts.f64) equal the JAX CLI's, the warm
    runs of both read them to the cold bytes; `cmp --presketched` over
    the .kmerset128 files gives the JAX CLI's bytes."""
    lst, _, _ = corpus
    outs = []
    for tag, fn, extra in (("p", cli.main, ["--device", "cpu"]),
                           ("j", jax_cli.main, []),
                           ("p", cli.main, ["--device", "cpu"]),
                           ("j", jax_cli.main, [])):
        d = tmp_path / tag
        os.makedirs(d, exist_ok=True)
        out = tmp_path / f"o{len(outs)}"
        assert fn(["sketch", kres, "-k", "40", "-2", "--binary-output",
                   "--cache", "--outprefix", str(d), "-F", lst,
                   "--cmpout", str(out)] + extra) == 0
        outs.append(_read(out))
    capsys.readouterr()
    assert outs[0] == outs[1] == outs[2] == outs[3] and outs[0]
    files = sorted(os.listdir(tmp_path / "p"))
    assert files == sorted(os.listdir(tmp_path / "j"))
    assert sum(f.endswith(".kmerset128") for f in files) == 8
    for f in files:
        assert _read(tmp_path / "p" / f) == _read(tmp_path / "j" / f)
    sets = [str(tmp_path / "j" / f) for f in files
            if f.endswith(".kmerset128")]
    for flags in ([], ["--containment"], ["--topk", "2"]):
        port, jax = _both(["cmp", "--presketched", "--binary-output"]
                          + flags + sets, tmp_path, capsys)
        assert port == jax and port[0] == 0 and port[1]
