"""Port parity for minimizer sequences (`--seq`), on the CPU.

* `hash_rows` (ops/oph_rows.py; its plain versions on CPU tensors)
  against the JAX package's `_hash_chunk_batch` and
  `_hash_chunk_batch128` compacted as its `--seq` route compacts them:
  the kept tokens of every row in order, with and without minimizers, a
  seed, downsampling and a filterset, u64 and full u128 keys;
* `span_edit_distance` against the JAX function on random token arrays
  of lengths 0-300 (u64 and u128, with repeats), and
  `span_edit_distances` (native/span_ed.cpp) against both;
* `sketch_fastx` --seq results (tokens, dtypes, cardinalities) against
  the JAX package's;
* the CLI bytes against dashing2_tpu.cli: `--seq` with `-o` (the stacked
  sequences and their .names.txt) and `--cmpout` in binary, TSV and the
  asymmetric square, with `-w`, `--hp-compress`, `--long-kmers`,
  `--parse-by-seq`, `--compute-edit-distance`, a `-Q` panel, `--topk`,
  `-T`, `--greedy`, and `--cache` cold then warm (`.mmerseq64`,
  `.mmerseq128`); `printmin` text of u64 and u128 files; `cmp
  --presketched` over `.mmerseq64` without counts and `.mmerseq128`
  files the JAX package's cache wrote.
Tolerance zero throughout: equal integers and equal bytes.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import editdist as JED
from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.enums import KmerSketchResultType as JKres
from dashing2_tpu.sketch import core as JC
from dashing2_tpu_torch import cli
from dashing2_tpu_torch import u128 as U
from dashing2_tpu_torch.cmp import editdist as ED
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import KmerSketchResultType
from dashing2_tpu_torch.io.corpus import (edited_sequences, write_corpus,
                                          write_fasta)
from dashing2_tpu_torch.ops import kmers as K
from dashing2_tpu_torch.ops import oph_rows as OR
from dashing2_tpu_torch.sketch import core as PC

SEQ = KmerSketchResultType.FULL_MMER_SEQUENCE


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(list file, genome paths, by-record FASTA) of a small seeded
    corpus: 6 genomes of 3 kb, and 24 records of 200-2,500 bp with N
    runs."""
    d = tmp_path_factory.mktemp("seq")
    paths = write_corpus(str(d / "fa"), seed=31, n_ancestors=2,
                         n_mutants=3, length=3000)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    fa = write_fasta(str(d / "recs.fa"), edited_sequences(
        32, 4, 6, length=(200, 2500), n_every=5))
    return str(lst), paths, fa


# ----------------------------------------------------------------------
# hash_rows' plain versions against the JAX engines
# ----------------------------------------------------------------------

# (options, full 128-bit keys, zero seed, filterset)
HASH_CASES = {
    "k15": (dict(k=15), False, False, False),
    "k15-w31": (dict(k=15, w=31), False, False, False),
    "k15-w31-zero": (dict(k=15, w=31), False, True, False),
    "k21-w40-ds-fs": (dict(k=21, w=40, kmer_downsample_frac=0.5,
                           seedseed=3), False, False, True),
    "roll-k40-w60": (dict(k=40, w=60), False, False, False),
    "u128-k40": (dict(k=40, use128=True), True, False, False),
    "u128-k40-w60": (dict(k=40, w=60, use128=True), True, False, False),
    "u128-k40-w60-zero": (dict(k=40, w=60, use128=True), True, True, False),
    "u128-k33-seed-ds-fs": (dict(k=33, w=45, use128=True, seedseed=9,
                                 kmer_downsample_frac=0.4), True, False,
                            True),
}


def _rows(opts, fa):
    items = list(PC._load_items(opts, [fa]))
    chunk_len = 1024        # short chunks: every halo and owner edge
    hkw = PC._hash_kwargs(opts, chunk_len)
    rows = np.concatenate([r for r, _ in PC._iter_chunk_batches(
        opts, items, chunk_len, 1 << 30)])
    return rows, hkw


@pytest.mark.parametrize("case", sorted(HASH_CASES))
def test_hash_rows_plain_matches_jax(corpus, case):
    """hash_rows on CPU tensors == the JAX engine's (hashed, valid), or
    (hi', lo', valid), compacted row by row, as the JAX `--seq` route
    keeps them; the rows' counts are the valid positions'."""
    kw, full, zero, use_fs = HASH_CASES[case]
    opts = Dashing2Options(parse_by_seq=True, **kw)
    rows, hkw = _rows(opts, corpus[2])
    hkw = dict(hkw, seed_is_zero=zero)
    fs = None
    if use_fs:
        lo, _ = OR.hash_chunk_batch(torch.from_numpy(rows), hkw)
        hv = np.unique(lo.numpy().reshape(-1).view(np.uint64))
        fs = hv[::4].copy()
    fs_j = jnp.asarray(fs if fs is not None else np.zeros(1, np.uint64))
    if full:
        jhi, jlo, jv = JC._hash_chunk_batch128(
            jnp.asarray(rows), fs_j, k=hkw["k"], w=hkw["w"],
            canon=hkw["canon"], xormask=hkw["xormask"],
            xormask2_hi=opts.xormask2_hi, seed_is_zero=zero,
            downsample_threshold=hkw["downsample_threshold"],
            use_filterset=use_fs, chunk_len=hkw["chunk_len"])
        jhi, jlo, jv = (np.asarray(x) for x in (jhi, jlo, jv))
    else:
        jlo, jv = JC._hash_chunk_batch(jnp.asarray(rows), fs_j,
                                       use_filterset=use_fs, **hkw)
        jlo, jv = np.asarray(jlo), np.asarray(jv)
    fs_t = None if fs is None else torch.from_numpy(fs.view(np.int64))
    lo, hi, cnt = OR.hash_rows(torch.from_numpy(rows), hkw, fs_t,
                               opts.xormask2_hi if full else None)
    np.testing.assert_array_equal(lo.numpy().view(np.uint64), jlo[jv])
    np.testing.assert_array_equal(cnt.numpy(), jv.sum(1))
    assert (hi is None) == (not full)
    if full:
        np.testing.assert_array_equal(hi.numpy().view(np.uint64), jhi[jv])
        # and the 128-bit plain version, uncompacted
        mhi, mlo, v = OR.hash_chunk_batch128(torch.from_numpy(rows), hkw,
                                             opts.xormask2_hi, fs_t)
        np.testing.assert_array_equal(v.numpy(), jv)
    assert 0 < len(lo) < jv.size


def test_hash_rows_refuses_full_keys_outside_the_128bit_code():
    opts = Dashing2Options(k=15)
    hkw = PC._hash_kwargs(opts, 1024)
    codes = torch.full((2, 100), K.INVALID, dtype=torch.uint8)
    with pytest.raises(ValueError, match="128-bit"):
        OR.hash_rows(codes, hkw, None, 5)
    lo, hi, cnt = OR.hash_rows(codes, hkw)
    assert hi is None and cnt.tolist() == [0, 0] and len(lo) == 0


# ----------------------------------------------------------------------
# span edit distances
# ----------------------------------------------------------------------

def _token_pairs(seed: int, wide: bool):
    """Random token arrays of lengths 0-300 drawn from a small alphabet
    (repeats, shared runs), pairs of one length apart and of very
    different lengths."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 1 << 64, 12, dtype=np.uint64)
    alpha_hi = rng.integers(0, 1 << 64, 12, dtype=np.uint64)
    out = []
    for la, lb in [(0, 0), (0, 5), (7, 0), (1, 1), (40, 41), (300, 3),
                   (150, 160), (299, 300), (64, 64), (200, 120)]:
        ia = rng.integers(0, 12, la)
        ib = np.concatenate([ia[:lb // 2], rng.integers(0, 12, lb - lb // 2)])
        if wide:
            # equal low words, unequal high words in some places
            hb = np.where(rng.random(len(ib)) < 0.1, (ib + 1) % 12, ib)
            a = U.from_words(alpha_hi[ia], alpha[ia])
            b = U.from_words(alpha_hi[hb], alpha[ib])
        else:
            a, b = alpha[ia], alpha[ib]
        out.append((a, b))
    return out


@pytest.mark.parametrize("wide", [False, True])
def test_span_edit_distance_matches_jax(wide):
    """The numpy DP == the JAX function, and the native batch == both."""
    pairs = _token_pairs(11 + wide, wide)
    want = [JED.span_edit_distance(a, b) for a, b in pairs]
    assert [ED.span_edit_distance(a, b) for a, b in pairs] == want
    assert [ED.mmer_edit_distance_pair(a, b) for a, b in pairs] == [
        JED.mmer_edit_distance_pair(a, b) for a, b in pairs]
    seqs = [s for ab in pairs for s in ab]
    ia = np.arange(0, len(seqs), 2)
    ib = ia + 1
    got = ED.span_edit_distances(seqs, np.r_[ia, ib], np.r_[ib, ia],
                                 nthreads=3)
    assert got.tolist() == want + want
    assert any(0 < w < 300 for w in want)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("exact,measure", [(True, "SIMILARITY"),
                                           (True, "M_EDIT_DISTANCE"),
                                           (False, "SIMILARITY")])
def test_mmer_sequence_pairs_matches_jax(wide, exact, measure):
    """wcompare.mmer_sequence_pairs (the native DP batch, or the
    positional hamming count without --exact-kmer-dist) == the JAX
    function's values, pair for pair; hamming_matches == the JAX
    function's."""
    from dashing2_tpu.cmp import wcompare as JW
    from dashing2_tpu.config import Dashing2DistOptions as JDist
    from dashing2_tpu.enums import Measure as JMeasure
    from dashing2_tpu.result import SketchingResult as JResult
    from dashing2_tpu_torch.cmp import wcompare as W
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.result import from_reference
    seqs = [s for ab in _token_pairs(21 + wide, wide) for s in ab]
    jres = JResult(names=[str(i) for i in range(len(seqs))],
                   mmer_sequences=seqs)
    jopts = JDist(kmer_result=JKres.FULL_MMER_SEQUENCE,
                  measure=JMeasure[measure])
    opts = Dashing2DistOptions(kmer_result=SEQ, measure=Measure[measure])
    jopts.exact_kmer_dist = opts.exact_kmer_dist = exact
    rng = np.random.default_rng(4)
    ia = rng.integers(0, len(seqs), 60)
    ib = rng.integers(0, len(seqs), 60)
    want = JW.mmer_sequence_pairs(jopts, jres, ia, ib)
    got = W.mmer_sequence_pairs(opts, from_reference(jres), ia, ib)
    np.testing.assert_array_equal(got, want)
    assert [W.hamming_matches(seqs[i], seqs[j]) for i, j in zip(ia, ib)] \
        == [JW.hamming_matches(seqs[i], seqs[j]) for i, j in zip(ia, ib)]


# ----------------------------------------------------------------------
# sketching and the CLI against the JAX package
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(k=15, w=31),
                                dict(k=13, w=21,
                                     homopolymer_compress_minimizers=True),
                                dict(k=40, w=60, use128=True),
                                dict(k=40, w=50)])
@pytest.mark.parametrize("by_seq", [False, True])
def test_seq_sketch_matches_jax(corpus, kw, by_seq):
    lst, paths, fa = corpus
    groups = [fa] if by_seq else paths
    want = JC.sketch_fastx(JOptions(kmer_result=JKres.FULL_MMER_SEQUENCE,
                                    parse_by_seq=by_seq, **kw), groups)
    got = PC.sketch_fastx(Dashing2Options(kmer_result=SEQ,
                                          parse_by_seq=by_seq, **kw),
                          groups, device="cpu")
    assert got.names == want.names
    assert len(got.mmer_sequences) == len(want.mmer_sequences)
    for g, w in zip(got.mmer_sequences, want.mmer_sequences):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, capsys, outs=(".out",)):
    """Both CLIs over argv ('@' in an argument becomes each side's
    prefix); [(exit code, bytes of each output)], port then JAX."""
    res = []
    for tag, fn, extra in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, [])):
        pre = str(tmp_path / tag)
        rc = fn([a.replace("@", pre) for a in argv] + extra)
        capsys.readouterr()
        res.append((rc, [_read(pre + o) if os.path.exists(pre + o) else None
                         for o in outs]))
    return res


SEQ_JOBS = {
    "bin-o": (["-k", "15", "-w", "31", "--binary-output", "-o", "@.seq"],
              (".out", ".seq", ".seq.names.txt")),
    "tsv": (["-k", "15", "-w", "31"], (".out",)),
    "asym": (["-k", "15", "-w", "31", "--asymmetric-all-pairs",
              "--binary-output"], (".out",)),
    "edit": (["-k", "15", "-w", "31", "--compute-edit-distance",
              "--asymmetric-all-pairs", "--binary-output"], (".out",)),
    "exact-flag": (["-k", "15", "-w", "31", "--exact-kmer-dist",
                    "--phylip"], (".out",)),
    "hp": (["-k", "13", "-w", "21", "--hp-compress", "--binary-output",
            "-o", "@.seq"], (".out", ".seq")),
    "u128": (["-k", "40", "-w", "60", "--long-kmers", "--binary-output",
              "-o", "@.seq"], (".out", ".seq", ".seq.names.txt")),
    "u128-nomini": (["-k", "33", "-2", "--binary-output"], (".out",)),
    "topk": (["-k", "15", "-w", "31", "--topk", "3", "--binary-output"],
             (".out",)),
    "topk-u128-text": (["-k", "40", "-w", "60", "-2", "--topk", "2"],
                       (".out",)),
    "threshold": (["-k", "15", "-w", "31", "-T", "0.1"], (".out",)),
    "greedy": (["-k", "15", "-w", "31", "--greedy", "0.2"], (".out",)),
}


@pytest.mark.parametrize("by_seq", [False, True])
@pytest.mark.parametrize("job", sorted(SEQ_JOBS))
def test_seq_cli_matches_jax(corpus, job, by_seq, tmp_path, capsys):
    lst, paths, fa = corpus
    flags, outs = SEQ_JOBS[job]
    inputs = ["--parse-by-seq", fa] if by_seq else ["-F", lst]
    port, jax = _both(["sketch", "--seq", "--cmpout", "@.out"] + flags
                      + inputs, tmp_path, capsys, outs)
    assert port == jax
    assert port[0] == 0 and all(port[1])


def test_seq_panel_matches_jax(corpus, tmp_path, capsys):
    lst, paths, _ = corpus
    refs, queries = tmp_path / "r.txt", tmp_path / "q.txt"
    refs.write_text("\n".join(paths[:4]) + "\n")
    queries.write_text("\n".join(paths[4:]) + "\n")
    port, jax = _both(["sketch", "--seq", "-k", "15", "-w", "31",
                       "--binary-output", "--cmpout", "@.out", "-F",
                       str(refs), "-Q", str(queries)], tmp_path, capsys)
    assert port == jax and port[0] == 0 and len(port[1][0]) == 4 * 4 * 2


@pytest.mark.parametrize("wide", [False, True])
def test_seq_cache_cold_then_warm(corpus, wide, tmp_path, capsys):
    """--cache: the port writes each genome's .mmerseq64 (.mmerseq128)
    beside --outprefix cold, the JAX CLI's warm run reads them, and the
    port's warm run gives the bytes of both cold runs."""
    lst, _, _ = corpus
    flags = ["sketch", "--seq", "-k", "15", "-w", "31", "--binary-output",
             "--cache", "--outprefix", str(tmp_path / "c"), "-F", lst]
    if wide:
        flags[2:6] = ["-k", "40", "-w", "60", "--long-kmers"]
    os.makedirs(tmp_path / "c")
    outs = []
    for fn, extra in ((cli.main, ["--device", "cpu"]), (jax_cli.main, []),
                      (cli.main, ["--device", "cpu"])):
        out = tmp_path / f"o{len(outs)}"
        assert fn(flags + ["--cmpout", str(out)] + extra) == 0
        outs.append(_read(out))
    capsys.readouterr()
    suffix = ".mmerseq128" if wide else ".mmerseq64"
    files = sorted(os.listdir(tmp_path / "c"))
    assert len(files) == 6 and all(f.endswith(suffix) for f in files)
    assert outs[0] == outs[1] == outs[2] and outs[0]
    # the JAX CLI's cold run writes the same artifacts
    os.makedirs(tmp_path / "j")
    jflags = [a if a != str(tmp_path / "c") else str(tmp_path / "j")
              for a in flags]
    assert jax_cli.main(jflags + ["--cmpout", str(tmp_path / "oj")]) == 0
    for f in files:
        assert _read(tmp_path / "c" / f) == _read(tmp_path / "j" / f)


@pytest.mark.parametrize("wide", [False, True])
def test_printmin_matches_jax(corpus, wide, tmp_path, capsys):
    lst, _, fa = corpus
    seq = str(tmp_path / "m.seq")
    flags = (["-k", "40", "-w", "60", "-2"] if wide
             else ["-k", "15", "-w", "31"])
    assert cli.main(["sketch", "--seq", "--parse-by-seq", "-o", seq, fa,
                     "--device", "cpu"] + flags) == 0
    texts = []
    for fn in (cli.main, jax_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(["printmin", seq]) == 0
        texts.append(buf.getvalue())
    capsys.readouterr()
    assert texts[0] == texts[1]
    assert texts[0].count("\n") == 24 and len(texts[0]) > 1000


@pytest.mark.parametrize("flags", [[], ["--mash-distance"],
                                   ["--topk", "2"]])
@pytest.mark.parametrize("wide", [False, True])
def test_presketched_mmerseq_matches_jax(corpus, wide, flags, tmp_path,
                                         capsys):
    """cmp --presketched over the JAX package's .mmerseq64 (no counts
    file: a minimizer sequence) and .mmerseq128 cache files."""
    lst, paths, _ = corpus
    kflags = (["-k", "40", "-w", "60", "-2"] if wide
              else ["-k", "15", "-w", "31"])
    assert jax_cli.main(["sketch", "--seq", "--cache", "--outprefix",
                         str(tmp_path), "-F", lst] + kflags) == 0
    files = sorted(str(tmp_path / f) for f in os.listdir(tmp_path)
                   if f.endswith((".mmerseq64", ".mmerseq128")))
    assert len(files) == 6
    port, jax = _both(["cmp", "--presketched", "--binary-output",
                       "--cmpout", "@.out"] + flags + files, tmp_path,
                      capsys)
    assert port == jax and port[0] == 0 and port[1][0]
