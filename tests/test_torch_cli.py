"""Port parity for the whole of the slices: the `--fastcmp 0.5` flag sets
and the default full-register job through both CLIs, on the CPU.

`sketch -k 31 -S 256 --fastcmp 0.5`, with --bbit-sigs (b-bit nibbles)
and without (SetSketch a/b nibbles), and `sketch -k 31 -S 256` (full
registers, no --fastcmp), over seeded FASTA runs through
dashing2_tpu_torch.cli.main(..., "--device", "cpu") and through
dashing2_tpu.cli.main, on the JAX package's default CPU route and on its
accelerator route (counts pull where the kind allows it + upper
trapezoids, one device). The output bytes must be equal (tolerance
zero). The JAX package's sketches also go through `from_reference` into
the port's `pairwise_matrix`, whose blocks must equal the JAX
function's.

The port runs on one card, so it is held to the JAX package's
single-device routes. For a/b nibbles the JAX bytes depend on the device
count: its multi-device route contracts the epilogue's fused multiply-add
on the other operand (fma(u[lt], g, B[gt]) where one device gives
fma(u[gt], g, B[lt]); see dashing2_tpu_torch/cmp/estimators.py), so the
a/b cases run the JAX package with DASHING2_TPU_MULTICHIP=0 on the test
suite's 8-device CPU mesh. For full registers at m = 256 every JAX route
gives the same bits (tests/test_torch_full.py adds its one-device and
row-block routes, and holds each route's bits at other m).
"""

import os

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import from_reference

NORTH_STAR = ["sketch", "-k", "31", "-S", "256", "--fastcmp", "0.5",
              "--bbit-sigs"]
# the flag sets: argv, the options they build, and the environment that
# keeps the JAX package on a single-device route where its bits need it
FLAGS = {
    "bbit": (NORTH_STAR, dict(fd_level=0.5, truncation_method=1), {}),
    "ab": (NORTH_STAR[:-1], dict(fd_level=0.5, truncation_method=0),
           {"DASHING2_TPU_MULTICHIP": "0"}),
    "full": (NORTH_STAR[:5], dict(fd_level=8.0, truncation_method=0), {}),
}
NIBBLE_FLAGS = ["ab", "bbit"]
JAX_ROUTES = {
    "default": {},
    "accelerator": {"DASHING2_TPU_PULL_COUNTS": "force",
                    "DASHING2_TPU_UPPER": "force",
                    "DASHING2_TPU_MULTICHIP": "0"},
}
FORMATS = {"binary": ["--binary-output"], "phylip": ["--phylip"],
           "tsv": []}


@pytest.fixture(scope="module", params=[70, 300])
def corpus(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"cli_{n}")
    paths = write_corpus(str(d / "fa"), seed=n, n_ancestors=n // 10,
                         n_mutants=10, length=2500)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_cli_output_bytes_equal_jax(corpus, flags, fmt, route, tmp_path,
                                    monkeypatch):
    lst, paths = corpus
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    argv = FLAGS[flags][0] + FORMATS[fmt] + ["-F", lst]
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    for key, val in {**JAX_ROUTES[route], **FLAGS[flags][2]}.items():
        monkeypatch.setenv(key, val)
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    got, want = _read(out_port), _read(out_jax)
    if fmt == "binary":
        n = len(paths)
        assert len(got) == 4 * n * (n - 1) // 2
        vals = np.frombuffer(got, np.float32)
        assert np.isfinite(vals).all() and vals.min() >= 0 \
            and vals.max() <= 1 and vals.max() > 0.5
    assert got == want


def test_sketch_outfile_bytes_equal_jax(corpus, tmp_path):
    lst, _ = corpus
    p, j = str(tmp_path / "port.sigs"), str(tmp_path / "jax.sigs")
    assert cli.main(NORTH_STAR + ["-o", p, "-F", lst, "--device", "cpu"]) == 0
    assert jax_cli.main(NORTH_STAR + ["-o", j, "-F", lst]) == 0
    assert _read(p) == _read(j)
    assert _read(p + ".names.txt") == _read(j + ".names.txt")


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_pairwise_blocks_from_reference_equal_jax(corpus, flags, route,
                                                  monkeypatch):
    lst, paths = corpus
    kw = dict(k=31, sketchsize=256, **FLAGS[flags][1])
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    port_res = from_reference(ref)
    for key, val in {**JAX_ROUTES[route], **FLAGS[flags][2]}.items():
        monkeypatch.setenv(key, val)
    got = list(PC.pairwise_matrix(Dashing2DistOptions(**kw), port_res,
                                  block=64, device="cpu"))
    want = list(JC.pairwise_matrix(JOptions(**kw), ref, block=64))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("flags", NIBBLE_FLAGS)
def test_compressed_registers_equal_jax(corpus, flags, monkeypatch):
    _, paths = corpus
    kw = dict(k=31, sketchsize=256, **FLAGS[flags][1])
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    port_creps, _ = PC._prep(Dashing2DistOptions(**kw), from_reference(ref))
    jax_creps, _ = JC._prep(JOptions(**kw), ref)
    carried = PC.creps_from_reference(jax_creps)
    assert carried.nibble_packed and port_creps.nibble_packed
    for c in (port_creps, carried):
        np.testing.assert_array_equal(c.data, jax_creps.data)
        assert (c.a, c.b, c.truncation) == \
            (jax_creps.a, jax_creps.b, jax_creps.truncation)


# options the port has run since the chunked route (ROADMAP item 7):
# their cases below hold the port to the JAX CLI instead of a refusal
RUN_NOW = ("--filterset", "--by-chrom", "--parse-by-seq", "--outprefix",
           "--cache", "--seq", "--hp-compress")


# genomes a --seq job compares: the JAX package computes every
# minimizer-sequence distance in a numpy row loop (2,470 tokens a genome
# at k = 31), so these jobs take the first few genomes of the corpus
SEQ_GENOMES = 6


def _inputs(argv, lst, paths):
    """The job's inputs: the corpus list, or for --seq its first
    SEQ_GENOMES genomes."""
    return paths[:SEQ_GENOMES] if "--seq" in argv else ["-F", lst]


def _run_both(argv, tmp_path, capsys):
    """Both CLIs over the same argv (with --device cpu for the port):
    [(exit code, output bytes or None, error message)] port, then JAX."""
    outs = []
    for tag, fn, extra in (("port", cli.main, ["--device", "cpu"]),
                           ("jax", jax_cli.main, [])):
        out = tmp_path / f"{tag}.out"
        rc = fn(argv + ["--cmpout", str(out)] + extra)
        err = capsys.readouterr().err
        outs.append((rc, _read(out) if out.exists() else None,
                     err.split("error: ", 1)[-1] if rc else ""))
    return outs


@pytest.mark.parametrize("extra", [
    ["--filterset", "fs.txt"], ["--outprefix", "p"],
    ["--leafcutter", "--by-chrom"],
    ["--cache"], ["--warm-only", "8"], ["--seq"],
    ["--hp-compress"],
    # the edit-distance options run only with -E
    ["--compute-edit-distance"], ["--exact-kmer-dist"],
])
def test_cli_rejects_options_outside_the_slice(corpus, extra, tmp_path,
                                               capsys):
    """Options outside the slice exit 2 and write nothing. --filterset
    (here a genome of the corpus as the filter FASTA) and --by-chrom
    (with --leafcutter over FASTA inputs, which both CLIs fail to parse
    alike) run since the chunked route, --outprefix and --cache (the
    port's cold run beside the inputs, then the JAX CLI's warm one)
    since the cache, --seq and --hp-compress (which only --seq reads)
    since the minimizer sequences: the JAX CLI's exit code, bytes and
    error message."""
    lst, paths = corpus
    if any(flag in extra for flag in RUN_NOW):
        argv = NORTH_STAR + [paths[0] if a == "fs.txt" else a
                             for a in extra] + _inputs(extra, lst, paths)
        port, jax = _run_both(argv, tmp_path, capsys)
        assert port == jax
        assert extra[0] not in ("--filterset", "--cache") \
            or (port[0] == 0 and port[1])
        return
    with pytest.raises(SystemExit) as e:
        cli.main(NORTH_STAR + extra + ["--cmpout", str(tmp_path / "o"),
                                       "-F", lst, "--device", "cpu"])
    assert e.value.code == 2
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("argv", [
    ["sketch", "-S", "256", "--bed", "--by-chrom"],   # BigWig only
    ["sketch", "-S", "256", "--parse-by-seq"],
    ["sketch", "-S", "256", "--bbit-sigs", "--save-kmers", "--entmin"],
    ["cmp", "-S", "256", "--seq"],
    ["sketch", "-S", "256", "--fastcmp", "1", "--containment",
     "-c", "1000", "--prob", "--save-kmers", "--hp-compress"],
])
def test_cli_rejects_other_comparisons(corpus, argv, tmp_path, capsys):
    """Jobs outside the slice exit 2. `--bed --by-chrom` (--by-chrom is
    ignored for BED, as in the JAX CLI; FASTA inputs fail to parse as
    BED in both) and `--parse-by-seq` (one item a record) run since the
    chunked route, `cmp --seq` and `--hp-compress` since the minimizer
    sequences: the JAX CLI's exit code, bytes and error message."""
    lst, paths = corpus
    if any(flag in argv for flag in RUN_NOW):
        port, jax = _run_both(argv + _inputs(argv, lst, paths), tmp_path,
                              capsys)
        assert port == jax
        assert not ({"--parse-by-seq", "--seq"} & set(argv)) \
            or (port[0] == 0 and port[1])
        return
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--cmpout", str(tmp_path / "o"), "-F", lst,
                         "--device", "cpu"])
    assert e.value.code == 2


def test_pairwise_rejects_routes_outside_the_slice(corpus, monkeypatch):
    _, paths = corpus
    kw = dict(k=31, sketchsize=256, fd_level=0.5, truncation_method=1)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    # m >= 65536 (u16 counts) stays outside the port, with or without
    # queries; a panel (nq > 0) of m < 65536 runs, (nf, nq) per block
    for nq in (0, 3):
        res = from_reference(ref)
        res.nq = nq
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            next(PC.pairwise_matrix(Dashing2DistOptions(
                **{**kw, "sketchsize": 1 << 16},
                measure=Measure.POISSON_LLR), res, device="cpu"))
    res = from_reference(ref)
    res.nq = 3
    blocks = list(PC.pairwise_matrix(Dashing2DistOptions(
        k=31, sketchsize=256, fd_level=1.0, measure=Measure.CONTAINMENT),
        res, device="cpu"))
    assert sum(b.shape[0] for _, b in blocks) == len(paths) - 3
    assert all(b.shape[1] == 3 for _, b in blocks)
    # so do equality-compared saved k-mers (--save-kmers): the k-mer ids,
    # densified with the registers, are what compares equal, as in the
    # JAX package (ids from a small alphabet, so that the counts differ
    # from the registers')
    ids = np.random.default_rng(3).integers(
        0, 4, ref.signatures.shape).astype(np.uint64)
    kmers = from_reference(ref)
    kmers.kmers = ids.copy()
    ref.kmers = ids.copy()
    kw = dict(k=31, sketchsize=256, truncation_method=1)
    got = list(PC.pairwise_matrix(Dashing2DistOptions(**kw), kmers,
                                  block=64, device="cpu"))
    want = list(JC.pairwise_matrix(JOptions(**kw), ref, block=64))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    regs_only = from_reference(ref)
    regs_only.kmers = None
    plain = list(PC.pairwise_matrix(Dashing2DistOptions(**kw), regs_only,
                                    block=64, device="cpu"))
    assert not all(np.array_equal(g, p) for (_, g), (_, p)
                   in zip(got, plain))


@pytest.fixture(scope="module")
def corpus70(tmp_path_factory):
    """The smallest corpus of the module with n >= 64, where both
    packages take their fused (jitted) epilogue route."""
    d = tmp_path_factory.mktemp("cli_ab_m")
    paths = write_corpus(str(d / "fa"), seed=70, n_ancestors=7,
                         n_mutants=10, length=2500)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


@pytest.mark.parametrize("m", [30, 100])
def test_nibble_ab_bytes_equal_jax_at_m_not_power_of_two(corpus70, m,
                                                         tmp_path,
                                                         monkeypatch):
    """At m not a power of two the JAX jitted route contracts the last
    factor of the a/b bit-product into its `1 -`; the port's bytes must
    follow (cmp/estimators.py::ab_tables)."""
    lst, paths = corpus70
    assert len(paths) >= PC.FUSED_MIN_N
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5",
            "--binary-output", "-F", lst]
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    got, want = _read(out_port), _read(out_jax)
    n = len(paths)
    assert len(got) == 4 * n * (n - 1) // 2
    assert got == want
