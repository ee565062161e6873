"""Port parity for the LSH neighbour jobs, on the CPU.

`sketch --topk k`, `-T t`, `--greedy t` and `--greedy te` over seeded
FASTA runs go through dashing2_tpu_torch.cli.main(..., "--device",
"cpu") and through dashing2_tpu.cli.main, in binary (CSR) and human
form, for full, nibble, u8 and u16 registers and a distance measure; the
output bytes must be equal. So must those of `--index-save` (the index
file too) and `--index-load`, in the native and the `.ssi` format, and
of `--refine-exact` over compressed registers (refined on the full
registers). The port must also reproduce the JAX package's goldens
tests/goldens/knn.bin and dedup.bin, and its `build_exact_lists` and
`dedup_core` (with another round size) must give the JAX package's
lists and clusters.
"""

import copy
import gzip
import hashlib
import os
import sys

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.cmp import graph as JG
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.enums import KmerSketchResultType as JKres
from dashing2_tpu.enums import OutputKind as JKind
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.cmp import graph as PG
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import KmerSketchResultType, OutputKind
from dashing2_tpu_torch.io import formats
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import from_reference

HERE = os.path.dirname(os.path.abspath(__file__))
# the compressed registers of an exact-set job: none
C_EMPTY = PC.CompressedReps(data=None)
SKETCH = ["sketch", "-k", "31", "-S", "256"]
JOBS = {
    "topk-full": ["--topk", "5"],
    "topk-nibble-bbit": ["--topk", "5", "--fastcmp", "0.5", "--bbit-sigs"],
    "thresh-u8-ab": ["-T", "0.2", "--fastcmp", "1"],
    "thresh-mash": ["-T", "0.03", "--mash-distance"],
    "greedy-full": ["--greedy", "0.3"],
    "greedy-u16-bbit": ["--greedy", "0.4", "--fastcmp", "2", "--bbit-sigs"],
    "greedy-e-nibble-ab": ["--greedy", "0.3e", "--fastcmp", "0.5"],
    "refine-exact-nibble-ab": ["--topk", "5", "--fastcmp", "0.5",
                               "--refine-exact"],
    "refine-exact-full": ["--topk", "5", "--refine-exact"],
    "topk-set": ["--topk", "5", "--set"],
    "topk-countdict-S16": ["--topk", "5", "--countdict", "-S", "16"],
    "thresh-set-containment": ["-T", "0.3", "--set", "--containment"],
    "thresh-countdict-mash": ["-T", "0.03", "--countdict",
                              "--mash-distance"],
    "greedy-set": ["--greedy", "0.3", "--set"],
    "greedy-e-countdict": ["--greedy", "0.3e", "--countdict"],
}
FORMATS = {"binary": ["--binary-output"], "human": []}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph")
    paths = write_corpus(str(d / "fa"), seed=31, n_ancestors=12,
                         n_mutants=10, length=2500)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, port_extra=(), jax_extra=()):
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + list(port_extra) + ["--cmpout", out_port,
                                               "--device", "cpu"]) == 0
    assert jax_cli.main(argv + list(jax_extra) + ["--cmpout", out_jax]) == 0
    return _read(out_port), _read(out_jax)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("job", sorted(JOBS))
def test_cli_graph_bytes_equal_jax(corpus, job, fmt, tmp_path):
    lst, paths = corpus
    got, want = _both(SKETCH + JOBS[job] + FORMATS[fmt] + ["-F", lst],
                      tmp_path)
    assert got == want
    if fmt == "binary" and not job.startswith("greedy"):
        out = tmp_path / "port.out"
        indptr, indices, data = formats.read_knn_csr(str(out))
        assert len(indptr) == len(paths) + 1 and len(indices) > len(paths)
        assert np.isfinite(data).all()
    elif fmt == "binary":
        nclusters, nnz = np.frombuffer(got[:16], np.uint64)
        assert 1 < nclusters < len(paths) and nnz == len(paths)


@pytest.mark.parametrize("suffix", ["idx", "ssi"])
def test_cli_index_save_and_load_equal_jax(corpus, suffix, tmp_path):
    _index_save_and_load(corpus, suffix, [], tmp_path)


@pytest.mark.parametrize("suffix", ["idx", "ssi"])
@pytest.mark.parametrize("kres", ["--set", "--countdict"])
def test_cli_exact_index_save_and_load_equal_jax(corpus, kres, suffix,
                                                 tmp_path):
    """The bottom-k index of exact sets and count dictionaries."""
    _index_save_and_load(corpus, suffix, [kres], tmp_path)


def _index_save_and_load(corpus, suffix, flags, tmp_path):
    lst, _ = corpus
    argv = SKETCH + ["--topk", "5", "--binary-output", "-F", lst] + flags
    pidx, jidx = str(tmp_path / f"p.{suffix}"), str(tmp_path / f"j.{suffix}")
    built, want = _both(argv, tmp_path, ["--index-save", pidx],
                        ["--index-save", jidx])
    assert built == want
    with gzip.open(pidx) as f, gzip.open(jidx) as g:
        assert f.read() == g.read()
    loaded, want = _both(argv, tmp_path, ["--index-load", pidx],
                         ["--index-load", jidx])
    assert loaded == want
    if suffix == "idx":
        assert loaded == built


@pytest.mark.parametrize("exact", [["--set"], ["--countdict"]])
def test_refine_exact_over_full_registers_and_exact_sets(corpus, exact,
                                                         tmp_path):
    """--refine-exact over full registers or exact sets changes no
    measure: the bytes of the job without it, and the JAX package's."""
    lst, _ = corpus
    for extra in ([], exact):
        argv = SKETCH + ["--topk", "5", "--binary-output", "-F", lst] + extra
        got, want = _both(argv + ["--refine-exact"], tmp_path)
        assert got == want
        plain = str(tmp_path / "plain.out")
        assert cli.main(argv + ["--cmpout", plain, "--device", "cpu"]) == 0
        assert got == _read(plain)


def _reproduce_jax_golden(name, tmp_path):
    sys.path.insert(0, HERE)
    try:
        from golden_configs import CONFIGS, LENGTH, N_GENOMES
        from make_fixtures import make
    finally:
        sys.path.remove(HERE)
    make(str(tmp_path), n_genomes=N_GENOMES, length=LENGTH, seed=42)
    args, _ = CONFIGS[name]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli.main(list(args) + ["--device", "cpu"]) == 0
        got = _read(name)
    finally:
        os.chdir(cwd)
    want = _read(os.path.join(HERE, "goldens", name))
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest()


@pytest.mark.parametrize("name", ["knn.bin", "dedup.bin"])
def test_port_reproduces_jax_graph_goldens(name, tmp_path):
    _reproduce_jax_golden(name, tmp_path)


@pytest.fixture(scope="module")
def sketched(corpus):
    """The corpus' sketches from the JAX package, and the port's copy."""
    _, paths = corpus
    os.environ["DASHING2_TPU_NATIVE_FILES"] = "force"
    try:
        ref = jax_sketch_fastx(JOptions(k=31, sketchsize=256), paths)
    finally:
        del os.environ["DASHING2_TPU_NATIVE_FILES"]
    return ref


@pytest.mark.parametrize("kw", [dict(num_neighbors=4),
                                dict(min_similarity=0.25, fd_level=1.0)])
def test_build_exact_lists_equal_jax(sketched, kw):
    popts = Dashing2DistOptions(k=31, sketchsize=256,
                                output_kind=OutputKind.KNN_GRAPH, **kw)
    jopts = JOptions(k=31, sketchsize=256, output_kind=JKind.KNN_GRAPH, **kw)
    pres = from_reference(sketched)
    pcreps, pres = PC._prep(popts, pres)
    jres = copy.deepcopy(sketched)       # a copy the JAX side may densify
    jcreps, jres = JC._prep(jopts, jres)
    got = PG.build_exact_lists(popts, pres, pcreps, device="cpu")
    assert got == JG.build_exact_lists(jopts, jres, jcreps)
    assert sum(map(len, got)) > len(got)


@pytest.mark.parametrize("exhaustive", [False, True])
def test_dedup_core_round_size_equal_jax(sketched, exhaustive, monkeypatch):
    kw = dict(k=31, sketchsize=256, fd_level=0.5, truncation_method=1,
              min_similarity=0.3, exhaustive_dedup=exhaustive)
    popts = Dashing2DistOptions(output_kind=OutputKind.DEDUP, **kw)
    jopts = JOptions(output_kind=JKind.DEDUP, **kw)
    pcreps, pres = PC._prep(popts, from_reference(sketched))
    jcreps, jres = JC._prep(jopts, copy.deepcopy(sketched))
    monkeypatch.setenv("DASHING2_TPU_DEDUP_CHUNK", "17")
    got = PG.dedup_core(popts, pres, pcreps, chunk=17, device="cpu")
    assert got == JG.dedup_core(jopts, jres, jcreps)
    assert 1 < len(got[0]) < pres.n


@pytest.fixture(scope="module")
def exact_sketched(corpus):
    """The corpus' count dictionaries from the JAX package."""
    _, paths = corpus
    return jax_sketch_fastx(JOptions(
        k=31, kmer_result=JKres.FULL_MMER_COUNTDICT), paths)


@pytest.mark.parametrize("weighted", [False, True])
def test_exact_set_lists_and_dedup_equal_jax(exact_sketched, weighted,
                                            monkeypatch):
    """build_exact_lists (every pair refined on the exact joins) and
    dedup_core with another round size, over exact sets and count
    dictionaries carried from the JAX package."""
    kres = ("FULL_MMER_COUNTDICT" if weighted else "FULL_MMER_SET")
    ref = copy.deepcopy(exact_sketched)
    if not weighted:
        ref.kmer_set_counts = None
        ref.cardinalities = np.array([len(s) for s in ref.kmer_sets],
                                     np.float64)
    kw = dict(k=31, num_neighbors=4)
    popts = Dashing2DistOptions(kmer_result=KmerSketchResultType[kres],
                                output_kind=OutputKind.KNN_GRAPH, **kw)
    jopts = JOptions(kmer_result=JKres[kres], output_kind=JKind.KNN_GRAPH,
                     **kw)
    pres = from_reference(ref)
    got = PG.build_exact_lists(popts, pres, C_EMPTY, device="cpu")
    assert got == JG.build_exact_lists(jopts, ref, JC.CompressedReps(None))
    assert sum(map(len, got)) > len(got)
    kw = dict(k=31, min_similarity=0.3)
    popts = Dashing2DistOptions(kmer_result=KmerSketchResultType[kres],
                                output_kind=OutputKind.DEDUP, **kw)
    jopts = JOptions(kmer_result=JKres[kres], output_kind=JKind.DEDUP, **kw)
    monkeypatch.setenv("DASHING2_TPU_DEDUP_CHUNK", "17")
    got = PG.dedup_core(popts, pres, C_EMPTY, chunk=17, device="cpu")
    assert got == JG.dedup_core(jopts, ref, JC.CompressedReps(None))
    assert 1 < len(got[0]) < pres.n

