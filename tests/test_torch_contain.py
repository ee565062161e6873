"""Port parity for `sketch -s/-N` (the .kmer64 k-mer database and its
counts) and the contain subcommand, on the CPU, against the JAX package
run in the same process. Mirrors tests/test_subcommands.py's
save-kmers/contain cases at a small size:

* `sketch -s -N -o db`: the stacked signatures, db.kmer64 and
  db.kmercounts.f64 byte for byte (with --seed, -k 21, a window, and
  `-S` not a power of two); -s/-N on a job other than one-permutation
  writes neither, in both packages; with -s, the comparison of b-bit
  and equality-compared registers over the saved k-mer ids;
* `contain db.kmer64 queries...`: binary (to a file and to stdout) and
  text output byte for byte, queries as paths and through -F (CRLF),
  a query shorter than k, a multi-file query;
* the torch lookup (`KmerLookup`) against the JAX package's numpy
  lookup on keys at and above 2^63, a key held by many references and
  many times by one, in sub-blocks of a few entries.
"""

import os

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import contain as PCT
from dashing2_tpu_torch.io import formats
from dashing2_tpu_torch.io.corpus import write_corpus


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    d = tmp_path_factory.mktemp("contain")
    paths = write_corpus(str(d / "fa"), seed=23, n_ancestors=2,
                         n_mutants=3, length=3000)
    short = d / "short.fa"
    short.write_text(">short\nACGTACGTAC\n")
    return paths, str(short)


def _files(d) -> dict:
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _sketch_both(flags, paths, tmp_path):
    out = {}
    for tag, main, extra in (("p", cli.main, ["--device", "cpu"]),
                             ("j", jax_cli.main, [])):
        d = tmp_path / tag
        d.mkdir()
        assert main(["sketch"] + flags + ["-o", str(d / "db")] + paths
                    + extra) == 0
        out[tag] = _files(d)
    return out["p"], out["j"]


DB_FLAGS = {"k31": ["-S", "128", "-s", "-N"],
            "k21-seed": ["-k", "21", "-S", "100", "-s", "-N", "--seed",
                         "7"],
            "window": ["-k", "15", "-w", "25", "-S", "64", "-s"],
            "counts-only": ["-S", "64", "-N"]}


@pytest.mark.parametrize("name", sorted(DB_FLAGS))
def test_save_kmers_bytes_equal_jax(genomes, name, tmp_path):
    paths, _ = genomes
    got, want = _sketch_both(DB_FLAGS[name], paths, tmp_path)
    assert got == want
    flags = DB_FLAGS[name]
    assert ("db.kmer64" in got) == ("-s" in flags)
    assert ("db.kmercounts.f64" in got) == ("-N" in flags)
    if "-s" in flags:
        db = formats.read_kmer_db(str(tmp_path / "p" / "db.kmer64"))
        assert db.kmers.shape == (len(paths), db.sketchsize)
        want_k = int(flags[flags.index("-k") + 1]) if "-k" in flags else 31
        assert db.k == want_k


@pytest.mark.parametrize("flags", [["-B"], ["--full-setsketch"]])
def test_save_kmers_only_for_one_permutation(genomes, flags, tmp_path):
    paths, _ = genomes
    got, want = _sketch_both(flags + ["-S", "64", "-s", "-N"], paths[:3],
                             tmp_path)
    assert sorted(got) == sorted(want) == ["db", "db.names.txt"]


SAVED_CMP = {"eqfull": ["--bbit-sigs"],
             "nibble-bbit": ["--fastcmp", "0.5", "--bbit-sigs"],
             "u8-bbit": ["--fastcmp", "1", "--bbit-sigs"],
             "full": [], "u16-ab-panel": ["--fastcmp", "2", "-Q", "@Q"]}


@pytest.mark.parametrize("name", sorted(SAVED_CMP))
def test_save_kmers_comparisons_equal_jax(genomes, name, tmp_path):
    """With -s the saved k-mer ids are what b-bit and equality-compared
    registers compare (the JAX package's `_representation` and
    `make_compressed`); the other kinds compare the registers. Bytes
    equal the JAX CLI's."""
    paths, _ = genomes
    q = tmp_path / "q.txt"
    q.write_text("\n".join(paths[:2]) + "\n")
    flags = [str(q) if f == "@Q" else f for f in SAVED_CMP[name]]
    outs = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jax_cli.main, [])):
        out = tmp_path / f"{len(outs)}.bin"
        assert main(["sketch", "-k", "21", "-S", "128", "-s",
                     "--binary-output", "--cmpout", str(out)] + flags
                    + paths[2:] + extra) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


@pytest.fixture(scope="module")
def db(genomes, tmp_path_factory):
    paths, _ = genomes
    d = tmp_path_factory.mktemp("db")
    assert jax_cli.main(["sketch", "-k", "21", "-S", "128", "-s", "-o",
                         str(d / "db")] + paths) == 0
    return str(d / "db.kmer64")


def _contain_both(argv, tmp_path, capsys=None):
    out = []
    for tag, main, extra in (("p", cli.main, ["--device", "cpu"]),
                             ("j", jax_cli.main, [])):
        o = tmp_path / f"{tag}.out"
        a = [x.replace("@OUT", str(o)) for x in argv]
        assert main(["contain"] + a + extra) == 0
        if capsys is not None:
            out.append(capsys.readouterr().out)
        else:
            out.append(o.read_bytes())
    return out


CONTAIN = {"binary": ["--binary-output", "--cmpout", "@OUT"],
           "binary-o": ["--binary-output", "-o", "@OUT"],
           "text": ["--cmpout", "@OUT"]}


@pytest.mark.parametrize("form", sorted(CONTAIN))
def test_contain_bytes_equal_jax(genomes, db, form, tmp_path):
    paths, short = genomes
    queries = [paths[0], paths[4], short, " ".join(paths[1:3])]
    got, want = _contain_both(CONTAIN[form] + [db] + queries, tmp_path)
    assert got == want
    if form != "text":
        res = formats.read_contain(str(tmp_path / "p.out"))
        cov = res["coverage_matrix"]
        assert cov.shape == (4, len(paths))
        assert cov[0, 0] > 0.95 and (cov[2] == 0).all()
        assert 0.9 < res["depth_matrix"][0, 0] < 2.0
    else:
        assert got.startswith(b"#Dashing2 contain")


def test_contain_queries_via_ffile(genomes, db, tmp_path):
    paths, _ = genomes
    qf = tmp_path / "queries.txt"
    qf.write_text(paths[0] + "\r\n" + paths[1] + "\n")
    got, want = _contain_both(["--binary-output", "--cmpout", "@OUT", "-F",
                               str(qf), db], tmp_path)
    assert got == want
    assert formats.read_contain(str(tmp_path / "p.out"))[
        "coverage_matrix"].shape == (2, len(paths))


@pytest.mark.parametrize("binary", [True, False])
def test_contain_to_stdout_equal_jax(genomes, db, binary, tmp_path, capfd):
    paths, _ = genomes
    flags = ["--binary-output"] if binary else []
    got = []
    for main, extra in ((cli.main, ["--device", "cpu"]),
                        (jax_cli.main, [])):
        assert main(["contain"] + flags + [db, paths[2]] + extra) == 0
        got.append(capfd.readouterr().out)
    assert got[0] == got[1] and len(got[0]) > 0


def test_contain_arity(tmp_path, capsys):
    assert cli.main(["contain", "--device", "cpu"]) == 1
    assert "kmer64 database" in capsys.readouterr().err


def _numpy_lookup(kmers: np.ndarray, hv: np.ndarray):
    """The JAX package's numpy lookup (dashing2_tpu/cmp/contain.py)."""
    nitems, m = kmers.shape
    flat = kmers.reshape(-1)
    owners = np.repeat(np.arange(nitems, dtype=np.int64), m)
    order = np.argsort(flat, kind="stable")
    sk, so = flat[order], owners[order]
    uniq, counts = np.unique(hv, return_counts=True)
    pos = np.minimum(np.searchsorted(sk, uniq), len(sk) - 1)
    hit = sk[pos] == uniq
    uniq, counts, pos = uniq[hit], counts[hit], pos[hit]
    lens = np.searchsorted(sk, uniq, side="right") - pos
    total = int(lens.sum())
    starts = np.repeat(pos, lens)
    within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
    own = so[starts + within]
    return (np.bincount(own, minlength=nitems),
            np.bincount(own, weights=np.repeat(counts, lens).astype(
                np.float64), minlength=nitems))


@pytest.mark.parametrize("block", [1, 7, 1 << 26])
def test_lookup_equals_numpy(block, monkeypatch):
    monkeypatch.setattr(PCT, "EXPAND_BLOCK", block)
    rng = np.random.default_rng(31)
    nitems, m = 9, 40
    pool = rng.integers(0, 1 << 64, 150, dtype=np.uint64)
    pool[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    kmers = rng.choice(pool, (nitems, m))
    kmers[3, :10] = 0                       # empty registers' key, repeated
    kmers[:, 0] = pool[2]                   # a key every reference holds
    hv = np.concatenate([rng.choice(pool, 400),
                         rng.integers(0, 1 << 64, 50, dtype=np.uint64),
                         np.zeros(3, np.uint64)])
    matches, sums = PCT.KmerLookup(kmers, "cpu").match(hv)
    want_m, want_s = _numpy_lookup(kmers, hv)
    np.testing.assert_array_equal(matches, want_m)
    np.testing.assert_array_equal(sums.astype(np.float64), want_s)
    assert matches.dtype == sums.dtype == np.int64
    empty_m, empty_s = PCT.KmerLookup(kmers, "cpu").match(
        np.zeros(0, np.uint64))
    assert not empty_m.any() and not empty_s.any()
