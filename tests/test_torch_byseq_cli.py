"""Port parity for the chunked route's jobs through the CLI, on the CPU:
the port's `sketch` (`--device cpu`) against dashing2_tpu.cli with the
same argv, byte for byte.

* `--parse-by-seq` (one item a record of a multi-FASTA of edited
  families with N runs and records shorter than k): all pairs with full
  registers, b-bit nibbles and in TSV; a `-Q` panel (-Q counts query
  lines, here files, as in the JAX CLI); `--topk 5`; `--greedy 0.3`;
  `-o` with its `.names.txt`; `-s`/`-N` (`<-o>.kmer64`,
  `<-o>.kmercounts.f64`);
* `--filterset`, a FASTA and a raw u64 list (`:b`), with and without
  `--parse-by-seq`, and on the file driver (plain files);
* FASTA `--by-chrom` (the JAX CLI sketches the files as without it, on
  its chunked route) and `.xz`/`.bz2` inputs, whose bytes equal the
  plain files';
* `--full-setsketch`, `--set` and `-B` with `--parse-by-seq` (the
  counting routes, one item a record), also with `--filterset`.

Tolerance zero: equal bytes.
"""

import bz2
import lzma

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.io.corpus import (edited_sequences, write_corpus,
                                          write_fasta)
from dashing2_tpu_torch.sketch import core as PC

K = ["-k", "21", "-S", "64"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("byseq")
    recs = edited_sequences(21, 6, 5, length=(200, 1500), n_every=4,
                            polya_every=7)
    recs += [("short1", b"ACGTACGTAC"), ("short2", b"")]
    fa = write_fasta(str(d / "seqs.fa"), recs)
    q = write_fasta(str(d / "q.fa"), edited_sequences(22, 2, 2,
                                                      length=(200, 900)))
    refs, queries = d / "refs.txt", d / "queries.txt"
    refs.write_text(fa + "\n")
    queries.write_text(q + "\n")
    filt = write_fasta(str(d / "filter.fa"), [
        ("f0", recs[0][1][:400]), ("f1", recs[11][1][50:500])])
    raw = str(d / "filter.u64")
    PC._filterset_array(Dashing2Options(k=21, filterset_path=filt)).tofile(
        raw)
    genomes = write_corpus(str(d / "g"), seed=21, n_ancestors=2,
                           n_mutants=3, length=3000)
    packed = []
    for p, (suffix, opener) in zip(genomes[:4], ((".xz", lzma.open),
                                                 (".bz2", bz2.open),
                                                 (".xz", lzma.open),
                                                 ("", None))):
        if opener is None:
            packed.append(p)
            continue
        with open(p, "rb") as f, opener(p + suffix, "wb") as g:
            g.write(f.read())
        packed.append(p + suffix)
    return {"fa": fa, "refs": str(refs), "queries": str(queries),
            "filter": filt, "raw": raw + ":b", "genomes": genomes,
            "packed": packed}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, files=("out",)):
    """Run both CLIs; {file: (port bytes, JAX bytes)} for `files`
    (`out` is --cmpout; others are paths the argv names by tag)."""
    got = {}
    for tag, fn, extra in (("p", cli.main, ["--device", "cpu"]),
                           ("j", jax_cli.main, [])):
        d = tmp_path / tag
        d.mkdir(parents=True)
        full = [str(d / a[1:]) if a.startswith("@") else a for a in argv]
        assert fn(full + ["--cmpout", str(d / "out")] + extra) == 0
        got[tag] = {f: _read(d / f) for f in files}
    return {f: (got["p"][f], got["j"][f]) for f in files}


def _inputs(inputs, keys):
    out = []
    for k in keys:
        v = inputs[k]
        out.extend(v if isinstance(v, list) else [v])
    return out


JOBS = {
    "byseq-full": (["--parse-by-seq", "--binary-output"], ["fa"]),
    "byseq-bbit": (["--parse-by-seq", "--fastcmp", "0.5", "--bbit-sigs",
                    "--binary-output"], ["fa"]),
    "byseq-tsv": (["--parse-by-seq", "--fastcmp", "1"], ["fa"]),
    "byseq-panel": (["--parse-by-seq", "--binary-output", "-F", "@refs",
                     "-Q", "@queries"], []),
    "byseq-topk": (["--parse-by-seq", "--topk", "5", "--binary-output"],
                   ["fa"]),
    "byseq-greedy": (["--parse-by-seq", "--greedy", "0.3"], ["fa"]),
    "filterset-byseq": (["--parse-by-seq", "--filterset", "@filter",
                         "--binary-output"], ["fa"]),
    "filterset-raw-byseq": (["--parse-by-seq", "--filterset", "@raw",
                             "--binary-output"], ["fa"]),
    "filterset-files": (["--filterset", "@filter", "--binary-output"],
                        ["genomes"]),
    "filterset-raw-files": (["--filterset", "@raw", "--fastcmp", "0.5",
                             "--bbit-sigs", "--binary-output"], ["genomes"]),
    "by-chrom": (["--by-chrom", "--binary-output"], ["genomes"]),
    "xz-bz2": (["--binary-output"], ["packed"]),
    "xz-bz2-by-chrom-byseq": (["--by-chrom", "--parse-by-seq",
                               "--binary-output"], ["packed"]),
    "fss-byseq": (["--full-setsketch", "--parse-by-seq",
                   "--binary-output"], ["fa"]),
    "set-byseq": (["--set", "--parse-by-seq", "--binary-output"], ["fa"]),
    "set-byseq-filterset": (["--set", "--parse-by-seq", "--filterset",
                             "@filter", "--binary-output"], ["fa"]),
    "bmh-byseq": (["-B", "--parse-by-seq", "--binary-output"], ["fa"]),
    "bmh-filterset-xz": (["-B", "--filterset", "@filter",
                          "--binary-output"], ["packed"]),
}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_job_equals_jax(inputs, job, tmp_path):
    flags, keys = JOBS[job]
    for tag in ("refs", "queries", "filter", "raw"):
        # an input of the fixture, not a file of the run
        flags = [inputs[tag] if f == f"@{tag}" else f for f in flags]
    got, want = _both(["sketch"] + K + flags + _inputs(inputs, keys),
                      tmp_path)["out"]
    assert got == want and len(got) > 0


def test_filters_change_the_output(inputs, tmp_path):
    """The filter's k-mers occur in the corpus: the job's bytes change."""
    plain = _both(["sketch"] + K + ["--parse-by-seq", "--binary-output",
                                    inputs["fa"]], tmp_path / "a")["out"]
    filt = _both(["sketch"] + K + ["--parse-by-seq", "--binary-output",
                                   "--filterset", inputs["filter"],
                                   inputs["fa"]], tmp_path / "b")["out"]
    assert plain[0] != filt[0]


def test_xz_bz2_equal_plain_files(inputs, tmp_path):
    """Compressed inputs give the plain files' bytes (the file driver)."""
    plain = inputs["genomes"][:4]
    outs = []
    for i, files in enumerate((plain, inputs["packed"])):
        out = tmp_path / f"o{i}"
        assert cli.main(["sketch"] + K + ["--binary-output", "--cmpout",
                                          str(out), "--device", "cpu"]
                        + files) == 0
        outs.append(_read(out))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("extra", [["-o", "@sig"],
                                   ["-s", "-N", "-o", "@db"]])
def test_written_sketches_equal_jax(inputs, extra, tmp_path):
    """`-o` (stacked registers and `.names.txt`, the record names), and
    `-s -N` (`.kmer64` ids and `.kmercounts.f64` counts)."""
    stem = extra[-1][1:]
    files = ["out", stem, stem + ".names.txt"]
    if "-s" in extra:
        files += [stem + ".kmer64", stem + ".kmercounts.f64"]
    got = _both(["sketch"] + K + ["--parse-by-seq", "--binary-output"]
                + extra + [inputs["fa"]], tmp_path, files)
    for f, (g, w) in got.items():
        assert g == w and len(g) > 0, f
    names = got[stem + ".names.txt"][0].decode()
    assert "fam0_0" in names and "short1" in names
    if "-s" in extra:
        counts = np.frombuffer(got[stem + ".kmercounts.f64"][0], np.float64)
        assert counts.max() >= 1


def test_byseq_items_are_records(inputs, tmp_path):
    """One item a record: 32 records, the pairs of all of them."""
    got, _ = _both(["sketch"] + K + ["--parse-by-seq", "--binary-output",
                                     inputs["fa"]], tmp_path)["out"]
    assert len(got) == 4 * 32 * 31 // 2
