"""Port parity for the `cmp`/`dist` subcommand, on the CPU.

* `cmp --presketched` over the port's own `-o` output (stacked
  signatures with their .names.txt: one-permutation full registers and
  b-bit nibbles, FullSetSketch): the bytes of the `sketch` job that
  wrote the file, and the bytes of the JAX CLI's `cmp --presketched`
  over the same file; with `-Q` stacked queries, where nq counts the
  items of the query files (as tests/test_subcommands.py:456-480).
* Over the single sketch caches the JAX package writes with `--cache`
  (.opss, .ss, .bmh, .pmh): the JAX CLI's bytes.
* Over the exact k-mer set caches the JAX package writes with `--cache`
  for `--set` and `--countdict` (.kmerset64: an f64 cardinality, then the
  keys), and over seeded .mmerseq64 token files with their
  <stem>kmercounts.f64 counts (count dictionaries): the JAX CLI's bytes
  for all-pairs, panel and neighbour jobs; counts that are not whole
  numbers are refused by name.
* u128 exact sets and minimizer sequences (.kmerset128, .mmerseq128,
  .mmerseq64 without counts): the JAX CLI's bytes (seeded files; the
  JAX package's cache files in tests/test_torch_seq.py and
  test_torch_u128.py). Sets larger than --sig-ram-limit (which the JAX
  package streams from the file) raise, naming ROADMAP Queue 1 item 8.
* `cmp` over FASTA inputs without --cmpout writes to stdout: the JAX
  CLI's bytes.
Tolerance zero throughout.
"""

import glob

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu_torch import cli
from dashing2_tpu_torch import u128 as U
from dashing2_tpu_torch.io.corpus import write_corpus


@pytest.fixture(scope="module", params=[20, 70])
def corpus(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"pre_{n}")
    paths = write_corpus(str(d / "fa"), seed=n + 5, n_ancestors=n // 10,
                         n_mutants=10, length=2500)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# the sketch job's flags, and the cmp job's (the stacked file carries no
# sketch type: --full says it holds FullSetSketch registers)
STACKED = {
    "oneperm-full": ([], []),
    "oneperm-nibble-bbit": (["--fastcmp", "0.5", "--bbit-sigs"],
                            ["--fastcmp", "0.5", "--bbit-sigs"]),
    "oneperm-u8-ab-phylip": (["--fastcmp", "1", "--phylip"],
                             ["--fastcmp", "1", "--phylip"]),
    "fss": (["--full-setsketch"], ["--full"]),
    "fss-containment": (["--full-setsketch", "--containment"],
                        ["--full", "--containment"]),
}


@pytest.mark.parametrize("kind", sorted(STACKED))
def test_presketched_stacked_equals_sketch_and_jax(corpus, kind, tmp_path,
                                                   monkeypatch):
    lst, _ = corpus
    sk_flags, cmp_flags = STACKED[kind]
    fmt = [] if "--phylip" in sk_flags else ["--binary-output"]
    sig, sk = str(tmp_path / "s.sig"), str(tmp_path / "sk.out")
    assert cli.main(["sketch", "-k", "31", "-S", "256", "-o", sig,
                     "--cmpout", sk, "-F", lst, "--device", "cpu"]
                    + sk_flags + fmt) == 0
    argv = ["cmp", "-k", "31", "--presketched", sig] + cmp_flags + fmt
    got, want = str(tmp_path / "c.out"), str(tmp_path / "j.out")
    assert cli.main(argv + ["--cmpout", got, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", want]) == 0
    assert _read(got) == _read(sk)
    assert _read(got) == _read(want)


@pytest.mark.parametrize("flags", [[], ["--fastcmp", "1", "--bbit-sigs"]])
def test_presketched_panel_stacked_queries(corpus, flags, tmp_path,
                                           monkeypatch):
    """-Q over stacked files: the queries are the items of the query
    files, not one a file. The JAX CLI runs its fused panel engine
    (`swar`, one device), the route the port's panels follow for
    64 <= n <= 16384 (n = references + queries)."""
    _, paths = corpus
    refs, qs = str(tmp_path / "refs.sig"), str(tmp_path / "qs.sig")
    base = ["sketch", "-k", "31", "-S", "256", "--device", "cpu"]
    assert cli.main(base + ["-o", refs] + paths[:-3]) == 0
    assert cli.main(base + ["-o", qs] + paths[-3:] + paths[:1]) == 0
    qlist = tmp_path / "q.txt"
    qlist.write_text(f"{qs}\n")
    argv = ["cmp", "--presketched", "-k", "31", "--binary-output", "-Q",
            str(qlist), refs] + flags
    got, want = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    assert cli.main(argv + ["--cmpout", got, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_KERNEL", "swar")
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", want]) == 0
    mat = np.fromfile(got, np.float32).reshape(len(paths) - 3, 4)
    assert mat[0, 3] == 1.0          # the last query is the first reference
    assert _read(got) == _read(want)


# the JAX sketch job that writes the caches, and the suffix they take
CACHES = {".opss": [], ".ss": ["--full-setsketch"], ".bmh": ["--multiset"],
          ".pmh": ["--prob"]}


@pytest.mark.parametrize("suffix", sorted(CACHES))
def test_presketched_caches_written_by_jax(corpus, suffix, tmp_path,
                                           monkeypatch):
    _, paths = corpus
    d = tmp_path / "cache"
    d.mkdir()
    assert jax_cli.main(["sketch", "-k", "31", "-S", "128", "--cache",
                         "--outprefix", str(d)] + CACHES[suffix]
                        + paths) == 0
    caches = sorted(glob.glob(str(d / f"*{suffix}")))
    assert len(caches) == len(paths)
    argv = ["cmp", "-k", "31", "--presketched", "--binary-output"] + caches
    got, want = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    assert cli.main(argv + ["--cmpout", got, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", want]) == 0
    n = len(paths)
    assert len(_read(got)) == 4 * n * (n - 1) // 2
    assert _read(got) == _read(want)


# the flags of the JAX sketch job that writes .kmerset64 caches, and of
# the cmp jobs over them
EXACT_CACHES = {"set": ["--set"], "countdict": ["--countdict"]}
EXACT_JOBS = {"similarity": [], "mash-phylip": ["--mash-distance",
                                                "--phylip"],
              "containment-asym": ["--containment", "--asymmetric-all-pairs"],
              "topk": ["--topk", "3"], "greedy": ["--greedy", "0.3"]}


@pytest.mark.parametrize("job", sorted(EXACT_JOBS))
@pytest.mark.parametrize("cache", sorted(EXACT_CACHES))
def test_presketched_kmerset64_written_by_jax(corpus, cache, job, tmp_path,
                                              monkeypatch):
    _, paths = corpus
    d = tmp_path / "cache"
    d.mkdir()
    assert jax_cli.main(["sketch", "-k", "31", "--cache", "--outprefix",
                         str(d)] + EXACT_CACHES[cache] + paths) == 0
    caches = sorted(glob.glob(str(d / "*.kmerset64")))
    assert len(caches) == len(paths)
    fmt = [] if "--phylip" in EXACT_JOBS[job] else ["--binary-output"]
    argv = (["cmp", "-k", "31", "--presketched"] + EXACT_JOBS[job] + fmt
            + caches)
    got, want = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    assert cli.main(argv + ["--cmpout", got, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--cmpout", want]) == 0
    assert _read(got) == _read(want)
    if job == "similarity":
        n = len(paths)
        assert len(_read(got)) == 4 * n * (n - 1) // 2


def _mmerseq_dicts(d, n: int, whole: bool = True):
    """n seeded token streams (repeats included) with their counts."""
    rng = np.random.default_rng(n)
    files = []
    for i in range(n):
        tokens = rng.integers(0, 400 + 50 * (i % 3), size=300
                              ).astype(np.uint64) << np.uint64(40)
        p = d / f"m{i:02d}.mmerseq64"
        tokens.tofile(p)
        counts = rng.integers(1, 9, size=300).astype(np.float64)
        if not whole:
            counts[5] += 0.5
        counts.tofile(d / f"m{i:02d}kmercounts.f64")
        files.append(str(p))
    return files


@pytest.mark.parametrize("flags", [[], ["--union-size"],
                                   ["--greedy", "0.2"]])
def test_presketched_mmerseq64_count_dictionaries(flags, tmp_path):
    files = _mmerseq_dicts(tmp_path, 12)
    argv = ["cmp", "-k", "31", "--presketched", "--binary-output"] + flags
    got, want = str(tmp_path / "p.bin"), str(tmp_path / "j.bin")
    assert cli.main(argv + files + ["--cmpout", got, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + files + ["--cmpout", want]) == 0
    assert _read(got) == _read(want)


def test_presketched_counts_that_are_not_whole_numbers_raise(tmp_path,
                                                             capsys):
    files = _mmerseq_dicts(tmp_path, 3, whole=False)
    rc = cli.main(["cmp", "--presketched", "--cmpout",
                   str(tmp_path / "o.bin"), "--device", "cpu"] + files)
    assert rc == 1
    assert "whole numbers" in capsys.readouterr().err


def test_presketched_kmerset64_above_the_ram_limit_raises(tmp_path, capsys):
    path = tmp_path / "x.kmerset64"
    np.zeros(4, np.uint64).tofile(path)
    rc = cli.main(["cmp", "--presketched", "--sig-ram-limit", "16",
                   "--cmpout", str(tmp_path / "o.bin"), str(path), str(path),
                   "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "ROADMAP Queue 1 item 8" in err and "sig-ram-limit" in err


@pytest.mark.parametrize("suffix", [".kmerset128", ".mmerseq64",
                                    ".mmerseq128"])
def test_presketched_exact_inputs_raise(suffix, tmp_path, capsys):
    """u128 keys, and minimizer sequences (a .mmerseq64 file without its
    counts), load since the minimizer-sequence slice: three seeded files
    of the kind (keys from a shared pool: a .kmerset128 set sorted after
    its f64 cardinality, a sequence's tokens in stream order with
    repeats) compare to the JAX CLI's bytes, all pairs and --topk."""
    rng = np.random.default_rng(len(suffix))
    pool = rng.integers(0, 1 << 64, (40, 2), dtype=np.uint64)
    files = []
    for i in range(3):
        pick = pool[rng.integers(0, 40, 60 + 9 * i)]
        path = tmp_path / f"x{i}{suffix}"
        with open(path, "wb") as f:
            keys = U.from_words(pick[:, 0], pick[:, 1])
            if suffix == ".kmerset128":
                np.float64(0.0).tofile(f)
                U.tofile_bytes(np.unique(keys)).tofile(f)
            elif suffix == ".mmerseq64":
                pick[:, 1].tofile(f)
            else:
                U.tofile_bytes(keys).tofile(f)
        files.append(str(path))
    for flags in ([], ["--topk", "1"]):
        outs = []
        for tag, fn, extra in (("p", cli.main, ["--device", "cpu"]),
                               ("j", jax_cli.main, [])):
            out = tmp_path / f"{tag}.bin"
            assert fn(["cmp", "--presketched", "--binary-output",
                       "--cmpout", str(out)] + flags + files + extra) == 0
            outs.append(_read(out))
        capsys.readouterr()
        assert outs[0] == outs[1] and outs[0]


@pytest.mark.parametrize("flags", [["--full-setsketch"],
                                   ["--fastcmp", "0.5", "--bbit-sigs"],
                                   ["--countdict", "--mash-distance"],
                                   ["--set"]])
def test_cmp_fasta_to_stdout(corpus, flags, tmp_path, capsysbinary):
    lst, paths = corpus
    argv = ["-k", "31", "-S", "256", "--binary-output", "-F", lst] + flags
    assert cli.main(["cmp"] + argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr().out
    want = str(tmp_path / "j.bin")
    assert jax_cli.main(["dist"] + argv + ["--cmpout", want]) == 0
    n = len(paths)
    assert len(got) == 4 * n * (n - 1) // 2
    assert got == _read(want)
