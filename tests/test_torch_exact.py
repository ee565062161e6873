"""Port parity for exact k-mer sets and count dictionaries (`--set`,
`--countdict`), on the CPU.

* The counting route's result: each item's distinct sorted hashes, their
  counts and the cardinalities (the set size, or the sum of the counts)
  equal the JAX package's `sketch_fastx`, with `-m 2` and with an item
  shorter than k (an empty set);
* cmp/wcompare.py's torch engines on CPU tensors against the JAX
  package's numpy joins (dashing2_tpu/cmp/wcompare.py), unweighted and
  weighted, over seeded sets that share keys by family, with the
  u64::max key in some sets (a pair where both hold it, pairs where one
  does), empty sets, and budgets that split the expansion into many
  sub-blocks: `exact_intersections`, the upper triangle of `ExactJoin`,
  and `exact_intersections_pairs` on both its routes (the padded lookup
  and the posting join), with counts that are not whole numbers refused;
* the CLI bytes of `--set` and `--countdict` jobs with every measure, in
  binary, TSV and PHYLIP, the asymmetric square, `-Q` panels and `-c`
  (which changes nothing), against dashing2_tpu.cli (`cmp` over FASTA:
  tests/test_torch_presketched.py).

The JAX package counts on the host on its CPU backend, so the reference
integers come from its numpy joins, which give the integers of its
device engine too. Tolerance zero: equal integers and equal f32 bytes.
"""

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import wcompare as JW
from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.enums import KmerSketchResultType as JKres
from dashing2_tpu.result import SketchingResult as JResult
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import wcompare as W
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import KmerSketchResultType
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import SketchingResult, from_reference
from dashing2_tpu_torch.sketch.core import sketch_fastx

U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
# items holding the u64::max key, and empty items, of the seeded sets
HAS_MAX = (0, 3, 6)
EMPTY = (4, 7)


def _sets(n: int, seed: int, weighted: bool, big: int = 0):
    """n sorted u64 sets drawn by family from a shared key pool (so that
    items of a family share most keys, and neighbouring families some),
    with u64::max, 0 and 2^63 in the pool, u64::max in the HAS_MAX items
    only, the EMPTY items empty, and with `big` item 1 holding `big`
    keys (a padded table more than 16 times the mean); counts 1-49."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 63, size=3000, dtype=np.uint64) * 2 + 1
    pool[:3] = [U64MAX, 0, np.uint64(1 << 63)]
    sets, counts = [], []
    for i in range(n):
        fam = (i // 5) % 10
        picks = pool[fam * 200:fam * 200 + 400]
        s = np.unique(rng.choice(picks, size=int(rng.integers(20, 200))))
        s = s[s != U64MAX]
        if i in HAS_MAX:
            s = np.append(s, U64MAX)
        if i in EMPTY:
            s = s[:0]
        if big and i == 1:
            s = np.unique(np.concatenate([s, pool[:big]]))
        sets.append(s)
        counts.append(rng.integers(1, 50, size=len(s)).astype(np.float64))
    if not weighted:
        counts = None
    jres = JResult(names=[str(i) for i in range(n)], kmer_sets=sets,
                   kmer_set_counts=counts)
    return jres, from_reference(jres)


@pytest.mark.parametrize("budget", [W.BUDGET, 97, 1])
@pytest.mark.parametrize("weighted", [False, True])
def test_exact_intersections_equal_jax(weighted, budget):
    jres, pres = _sets(40, seed=1, weighted=weighted)
    rows = np.arange(40)
    want = JW.exact_intersections(jres, rows, rows)
    got = W.exact_intersections(pres, rows, rows, device="cpu",
                                budget=budget)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert want[0, 3] > 0 and (want[list(EMPTY)] == 0).all()
    # a rectangle of repeated and unordered items
    r = np.array([5, 3, 3, 0, 39, 7])
    c = np.array([9, 0, 4, 3, 12, 12, 1])
    np.testing.assert_array_equal(
        W.exact_intersections(pres, r, c, device="cpu", budget=budget),
        JW.exact_intersections(jres, r, c))


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_join_upper_triangle(weighted):
    """A symmetric job's block counts each row against the columns after
    its own item only, in sub-blocks, and leaves the others 0."""
    jres, pres = _sets(40, seed=2, weighted=weighted)
    cols = np.arange(40)
    want = JW.exact_intersections(jres, cols, cols)
    join = W.ExactJoin(W.device_sets(pres, W.resolve("cpu")), cols,
                       budget=50)
    above = cols[None, :] > cols[:, None]
    for start in (0, 9, 33):
        rows = np.arange(start, min(start + 16, 40))
        got = join.block(rows, upper=True).numpy()
        np.testing.assert_array_equal(got, np.where(above[rows],
                                                    want[rows], 0))
    assert join.subblocks > 3 and join.entries > 0


@pytest.mark.parametrize("budget", [W.PAIR_BUDGET, 300])
@pytest.mark.parametrize("route", ["lookup", "posting"])
@pytest.mark.parametrize("weighted", [False, True])
def test_exact_intersections_pairs_equal_jax(weighted, route, budget,
                                             monkeypatch):
    jres, pres = _sets(40, seed=3, weighted=weighted)
    if route == "posting":
        monkeypatch.setattr(W, "padded_sets", lambda result, dev: None)
    rng = np.random.default_rng(4)
    ia = np.concatenate([[0, 0, 3, 4, 4, 1, 6, 2],
                         rng.integers(0, 40, 300)])
    ib = np.concatenate([[3, 1, 0, 7, 1, 1, 6, 0],
                         rng.integers(0, 40, 300)])
    want = JW.exact_intersections_pairs(jres, ia, ib)
    got = W.exact_intersections_pairs(pres, ia, ib, device="cpu",
                                      budget=budget)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # both hold u64::max, one does, an empty pair, an empty item
    assert want[0] > 0 and want[3] == 0 and want[4] == 0
    sets = jres.kmer_sets
    assert want[0] == np.intersect1d(sets[0], sets[3]).size or weighted


def test_pathological_padding_takes_the_posting_join():
    """One set 16 times the mean: no padded table; the pairs still equal
    the JAX package's."""
    jres, pres = _sets(30, seed=5, weighted=True, big=2900)
    assert W.padded_sets(pres, W.resolve("cpu")) is None
    ia, ib = np.triu_indices(30, k=1)
    np.testing.assert_array_equal(
        W.exact_intersections_pairs(pres, ia, ib, device="cpu"),
        JW.exact_intersections_pairs(jres, ia, ib))


def test_counts_that_are_not_whole_numbers_are_refused():
    res = SketchingResult(names=["a", "b"],
                          kmer_sets=[np.arange(3, dtype=np.uint64)] * 2,
                          kmer_set_counts=[np.array([1.0, 2.5, 3.0])] * 2)
    with pytest.raises(ValueError, match="whole numbers"):
        W.exact_intersections(res, [0], [1], device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("exact")
    paths = write_corpus(str(d / "fa"), seed=41, n_ancestors=2,
                         n_mutants=10, length=2500)
    short = d / "short.fa"
    short.write_text(">short\nACGTACGTAC\n")
    paths.insert(5, str(short))       # an item shorter than k: empty set
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


KRES = {"set": (KmerSketchResultType.FULL_MMER_SET, JKres.FULL_MMER_SET),
        "countdict": (KmerSketchResultType.FULL_MMER_COUNTDICT,
                      JKres.FULL_MMER_COUNTDICT)}


@pytest.mark.parametrize("threshold", [0, 2])
@pytest.mark.parametrize("kres", sorted(KRES))
def test_exact_sketch_equals_jax(corpus, kres, threshold):
    _, paths = corpus
    kw = dict(k=31, count_threshold=threshold)
    got = sketch_fastx(Dashing2Options(kmer_result=KRES[kres][0], **kw),
                       paths)
    want = jax_sketch_fastx(JOptions(kmer_result=KRES[kres][1], **kw), paths)
    assert got.signatures is None
    assert len(got.kmer_sets) == len(want.kmer_sets) == len(paths)
    for g, w in zip(got.kmer_sets, want.kmer_sets):
        assert g.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)
    assert got.cardinalities[5] == 0
    if kres == "set":
        assert got.kmer_set_counts is None
        return
    for g, w in zip(got.kmer_set_counts, want.kmer_set_counts):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


MEASURES = {"similarity": [], "mash": ["--mash-distance"],
            "containment": ["--containment"],
            "symcontain": ["--symmetric-containment"],
            "intersection": ["--intersection"], "union": ["--union-size"]}
FORMATS = {"binary": ["--binary-output"], "tsv": [], "phylip": ["--phylip"],
           "asym": ["--asymmetric-all-pairs", "--binary-output"]}


def _both(argv, tmp_path, capsys=None):
    got, want = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    assert cli.main(argv + ["--cmpout", got, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--cmpout", want]) == 0
    return _read(got), _read(want)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("msr", sorted(MEASURES))
@pytest.mark.parametrize("kres", ["--set", "--countdict"])
def test_cli_exact_bytes_equal_jax(corpus, kres, msr, fmt, tmp_path):
    lst, paths = corpus
    got, want = _both(["sketch", "-k", "31", kres, "-F", lst]
                      + MEASURES[msr] + FORMATS[fmt], tmp_path)
    assert got == want
    n = len(paths)
    if fmt == "binary":
        assert len(got) == 4 * n * (n - 1) // 2
    elif fmt == "asym":
        assert len(got) == 4 * n * n


@pytest.mark.parametrize("flags", [["--set"], ["--countdict", "--containment"],
                                   ["--set", "--mash-distance", "--phylip"]])
def test_cli_exact_panel_equal_jax(corpus, flags, tmp_path):
    lst, paths = corpus
    refs, queries = tmp_path / "refs.txt", tmp_path / "q.txt"
    refs.write_text("\n".join(paths[:-4]) + "\n")
    queries.write_text("\n".join(paths[-4:] + paths[:1]) + "\n")
    got, want = _both(["sketch", "-k", "31", "--binary-output", "-F",
                       str(refs), "-Q", str(queries)] + flags, tmp_path)
    assert got == want
    mat = np.frombuffer(got, np.float32).reshape(len(paths) - 4, 5)
    if flags == ["--set"]:
        assert mat[0, 4] == 1.0      # the last query is the first reference


@pytest.mark.parametrize("kres", ["--set", "--countdict"])
def test_countsketch_size_changes_nothing(corpus, kres, tmp_path):
    """-c sizes the count sketch of -B/-P only: a --set/--countdict job
    with it writes the JAX bytes, and those of the job without it."""
    lst, _ = corpus
    argv = ["sketch", "-k", "31", kres, "--binary-output", "-F", lst]
    got, want = _both(argv + ["-c", "1000"], tmp_path)
    assert got == want
    plain = str(tmp_path / "plain.out")
    assert cli.main(argv + ["--cmpout", plain, "--device", "cpu"]) == 0
    assert got == _read(plain)


def test_sketch_output_file_is_not_written_for_exact_sets(corpus, tmp_path):
    """`-o` writes the stacked signatures, which exact sets do not have,
    in both packages."""
    lst, _ = corpus
    for main, sig in ((cli.main, tmp_path / "p.sig"),
                      (jax_cli.main, tmp_path / "j.sig")):
        extra = ["--device", "cpu"] if main is cli.main else []
        assert main(["sketch", "-k", "31", "--set", "-o", str(sig),
                     "-F", lst] + extra) == 0
        assert not sig.exists()
