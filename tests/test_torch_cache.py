"""--cache and --outprefix in the port (io/cache.py, sketch/core.py
`_sketch_cached`), on the CPU, against the JAX package.

* `makedest` against the JAX `makedest` over a grid of options: every
  part of the name (seed, canonical, spacing, sketch size, k, w, count
  threshold, counting type and size, a/b/fd of a sketch-compressed set
  sketch, space or result type, alphabet, suffix), --outprefix, the
  count dictionary's keys path, an item of several paths.
* The CLI (`--device cpu`) against the JAX CLI, for the one-permutation
  (`-o`, and with `-s -N`), `--full-setsketch`, `--fastcmp-bytes`,
  `--set`, `--countdict`, `-B` and `-P -c` jobs and a `cmp` job: a cold
  run writes the JAX run's cache files under the same names, and the
  same output bytes; a warm run loads every artifact and sketches
  nothing; a run with a third of the artifacts deleted sketches exactly
  those items, in input order, rewrites the deleted files and gives the
  same bytes; the port's warm run over the JAX package's cache gives
  them too. Every byte equal, except FullSetSketch registers (`.ss`
  files and `-o`): within CSS_ULP ulp (the port's own f64 log, README
  "Documented deviations"), their comparison bytes equal.
* --outprefix alone writes nothing and changes no byte; --cache without
  it writes beside the inputs; an exact-set cache above --sig-ram-limit,
  which the JAX package streams from its file, is refused naming its
  ROADMAP item.
"""

import itertools
import os
import shutil

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu import config as JC
from dashing2_tpu import enums as JEN
from dashing2_tpu.io.cache import makedest as jax_makedest
from dashing2_tpu_torch import cli
from dashing2_tpu_torch import config as PC
from dashing2_tpu_torch import enums as PEN
from dashing2_tpu_torch.io.cache import makedest
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.sketch import core

# the port's f64 log against XLA's CPU log (the C library's)
CSS_ULP = 4

SPACES = ("SPACE_SET", "SPACE_MULTISET", "SPACE_PSET")
RESULTS = ("ONE_PERM", "FULL_SETSKETCH", "FULL_MMER_SET",
           "FULL_MMER_COUNTDICT")


def _opts(pkg, **kw):
    """Options of one package from enum names and plain values."""
    cfg, en = (JC, JEN) if pkg == "jax" else (PC, PEN)
    kw = dict(kw)
    kw["sspace"] = en.SketchSpace[kw.get("sspace", "SPACE_SET")]
    kw["kmer_result"] = en.KmerSketchResultType[
        kw.get("kmer_result", "ONE_PERM")]
    kw["alphabet"] = en.Alphabet[kw.get("alphabet", "DNA")]
    return cfg.Dashing2Options(**kw)


GRID = [dict(sspace=s, kmer_result=r, **extra) for s, r, extra in
        itertools.product(SPACES, RESULTS, [
            dict(),
            dict(k=21, w=40, seedseed=7, outprefix="/cache/dir"),
            dict(k=17, spacing="2x3", canonicalize=False, cssize=1000),
            dict(count_threshold=2.5, alphabet="PROTEIN", k=7,
                 compressed_a=20.0, compressed_b=1.2, fd_level=1.0),
            dict(count_threshold=3, use128=True, sketchsize=2000,
                 outprefix="rel")])]


@pytest.mark.parametrize("case", range(len(GRID)))
def test_makedest_equals_jax(case):
    kw = GRID[case]
    for path in ("/data/g1.fa", "rel/g2.fna.gz /data/g3.fa"):
        for iskmer in (False, True):
            assert makedest(_opts("port", **kw), path, iskmer) \
                == jax_makedest(_opts("jax", **kw), path, iskmer)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache_corpus")
    paths = write_corpus(str(d / "fa"), seed=3, n_ancestors=3,
                         n_mutants=3, length=3000)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


# the jobs: argv after the subcommand, and whether the registers are
# FullSetSketch f64 (within CSS_ULP ulp of the JAX package's)
JOBS = {
    "oph": (["-k", "21", "-S", "64"], False),
    "oph-save-kmers": (["-k", "21", "-S", "64", "-s", "-N"], False),
    "fss": (["-k", "21", "-S", "64", "--full-setsketch"], True),
    "fss-bytes": (["-k", "21", "-S", "64", "--full-setsketch",
                   "--fastcmp-bytes"], False),
    "set": (["-k", "21", "--set"], False),
    "countdict": (["-k", "21", "--countdict"], False),
    "bmh": (["-k", "21", "-S", "64", "-B"], False),
    "pmh-countsketch": (["-k", "21", "-S", "64", "-P", "-c", "1000"],
                        False),
}


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a.view(np.int64) - b.view(np.int64))
    return np.where(a == b, 0, d)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _same(a: bytes, b: bytes, fss: bool, header: int) -> bool:
    """Equal bytes, or for FullSetSketch f64 the same length and every
    f64 after `header` bytes within CSS_ULP ulp (the header exact)."""
    if a == b or not fss:
        return a == b
    if len(a) != len(b) or a[:header] != b[:header]:
        return False
    x = np.frombuffer(a[header:], np.float64)
    y = np.frombuffer(b[header:], np.float64)
    return bool(_ulps(x, y).max() <= CSS_ULP)


def _run(fn, sub, flags, lst, d, out, extra=()):
    argv = [sub] + flags + ["--cache", "--outprefix", str(d),
                            "--binary-output", "--cmpout", str(out)]
    if sub == "sketch":
        argv += ["-o", str(out) + ".sig"]
    assert fn(argv + ["-F", lst] + list(extra)) == 0
    return open(out, "rb").read()


@pytest.mark.parametrize("job,sub", [(j, "sketch") for j in sorted(JOBS)]
                         + [(j, "cmp") for j in ("oph", "fss", "countdict")])
def test_cache_cold_warm_partial_equal_jax(corpus, job, sub, tmp_path,
                                           monkeypatch):
    lst, paths = corpus
    flags, fss = JOBS[job]
    pd, jd = tmp_path / "port", tmp_path / "jax"
    pd.mkdir()
    jd.mkdir()
    cpu = ["--device", "cpu"]
    calls = []
    real = core._sketch_routes

    def counted(opts, groups, device):
        calls.append(list(groups))
        return real(opts, groups, device)
    monkeypatch.setattr(core, "_sketch_routes", counted)

    cold = _run(cli.main, sub, flags, lst, pd, tmp_path / "p0", cpu)
    assert calls == [paths]
    want = _run(jax_cli.main, sub, flags, lst, jd, tmp_path / "j0")
    assert cold == want
    if sub == "sketch" and job not in ("set", "countdict"):
        a = open(str(tmp_path / "p0") + ".sig", "rb").read()
        b = open(str(tmp_path / "j0") + ".sig", "rb").read()
        assert _same(a, b, fss, 16 + 8 * len(paths))
    mine, theirs = _files(pd), _files(jd)
    assert list(mine) == list(theirs)
    assert len(mine) >= len(paths)
    for name in mine:
        assert _same(mine[name], theirs[name], fss, 8), name

    calls.clear()
    warm = _run(cli.main, sub, flags, lst, pd, tmp_path / "p1", cpu)
    assert calls == [] and warm == cold
    assert _files(pd) == mine

    gone = paths[::3]
    for name in mine:
        if any(name.startswith(os.path.basename(p) + ".") for p in gone):
            os.remove(pd / name)
    assert len(_files(pd)) < len(mine)
    partial = _run(cli.main, sub, flags, lst, pd, tmp_path / "p2", cpu)
    assert calls == [gone] and partial == cold
    assert _files(pd) == mine
    if sub == "sketch" and job not in ("set", "countdict"):
        assert open(str(tmp_path / "p2") + ".sig", "rb").read() \
            == open(str(tmp_path / "p0") + ".sig", "rb").read()

    calls.clear()
    over_jax = _run(cli.main, sub, flags, lst, jd, tmp_path / "p3", cpu)
    assert calls == [] and over_jax == cold


def test_outprefix_alone_writes_nothing(corpus, tmp_path):
    lst, _ = corpus
    d = tmp_path / "prefix"
    d.mkdir()
    outs = []
    for tag, fn, extra in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, [])):
        out = tmp_path / f"{tag}.bin"
        assert fn(["sketch", "-k", "21", "-S", "64", "--full-setsketch",
                   "--outprefix", str(d), "--binary-output", "--cmpout",
                   str(out), "-F", lst] + extra) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert os.listdir(d) == []


def test_cache_beside_the_inputs(corpus, tmp_path):
    """Without --outprefix the artifacts go beside each input, under the
    JAX package's names."""
    _, paths = corpus
    names = {}
    for tag, fn, extra in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, [])):
        d = tmp_path / tag
        d.mkdir()
        local = []
        for p in paths[:3]:
            shutil.copy(p, d)
            local.append(str(d / os.path.basename(p)))
        out = tmp_path / f"{tag}.bin"
        assert fn(["sketch", "-k", "21", "-S", "64", "--cache",
                   "--binary-output", "--cmpout", str(out)] + local
                  + extra) == 0
        names[tag] = sorted(set(os.listdir(d))
                            - {os.path.basename(p) for p in paths})
        assert len(names[tag]) == 3
        for f in names[tag]:
            names[tag + f] = (d / f).read_bytes()
    assert names["port"] == names["jax"]
    for f in names["port"]:
        assert names["port" + f] == names["jax" + f]


def test_exact_cache_above_the_ram_limit_is_refused(corpus, tmp_path,
                                                     capsys):
    """The JAX package streams an exact-set cache larger than
    --sig-ram-limit from its file; the port refuses it by name."""
    lst, paths = corpus
    d = tmp_path / "c"
    d.mkdir()
    argv = ["sketch", "-k", "21", "--set", "--cache", "--outprefix",
            str(d), "--binary-output", "--cmpout", str(tmp_path / "o"),
            "-F", lst, "--device", "cpu"]
    assert cli.main(argv) == 0
    capsys.readouterr()
    assert cli.main(argv + ["--sig-ram-limit", "64"]) == 1
    assert "item 8" in capsys.readouterr().err
