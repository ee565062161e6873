"""Port parity for the whole slice: the north-star flags through both
CLIs, on the CPU.

`sketch -k 31 -S 256 --fastcmp 0.5 --bbit-sigs` over seeded FASTA runs
through dashing2_tpu_torch.cli.main(..., "--device", "cpu") and through
dashing2_tpu.cli.main, on the JAX package's default CPU route and on its
accelerator route (counts pull + upper trapezoids, one device). The
output bytes must be equal (tolerance zero). The JAX package's sketches
also go through `from_reference` into the port's `pairwise_matrix`,
whose blocks must equal the JAX function's.
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
def test_cli_output_bytes_equal_jax(corpus, fmt, route, tmp_path,
                                    monkeypatch):
    lst, paths = corpus
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    argv = NORTH_STAR + FORMATS[fmt] + ["-F", lst]
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    for key, val in JAX_ROUTES[route].items():
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
def test_pairwise_blocks_from_reference_equal_jax(corpus, route,
                                                  monkeypatch):
    lst, paths = corpus
    kw = dict(k=31, sketchsize=256, fd_level=0.5, truncation_method=1)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    port_res = from_reference(ref)
    for key, val in JAX_ROUTES[route].items():
        monkeypatch.setenv(key, val)
    got = list(PC.pairwise_matrix(Dashing2DistOptions(**kw), port_res,
                                  block=64, device="cpu"))
    want = list(JC.pairwise_matrix(JOptions(**kw), ref, block=64))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_compressed_registers_equal_jax(corpus, monkeypatch):
    _, paths = corpus
    kw = dict(k=31, sketchsize=256, fd_level=0.5, truncation_method=1)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    port_creps, _ = PC._prep(Dashing2DistOptions(**kw), from_reference(ref))
    jax_creps, _ = JC._prep(JOptions(**kw), ref)
    carried = PC.creps_from_reference(jax_creps)
    assert carried.nibble_packed and port_creps.nibble_packed
    np.testing.assert_array_equal(port_creps.data, jax_creps.data)
    np.testing.assert_array_equal(carried.data, jax_creps.data)


@pytest.mark.parametrize("extra", [
    ["--topk", "3"], ["--greedy", "0.8"], ["--mash-distance"],
    ["--cache"], ["-Q", "q.txt"], ["--asymmetric-all-pairs"],
    ["--full-setsketch"],
])
def test_cli_rejects_options_outside_the_slice(corpus, extra, tmp_path):
    lst, _ = corpus
    with pytest.raises(SystemExit) as e:
        cli.main(NORTH_STAR + extra + ["--cmpout", str(tmp_path / "o"),
                                       "-F", lst, "--device", "cpu"])
    assert e.value.code == 2
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("argv", [
    ["sketch", "-S", "256", "--fastcmp", "0.5"],        # nibble a/b
    ["sketch", "-S", "256", "--fastcmp", "1", "--bbit-sigs"],
    ["sketch", "-S", "256"],                            # full registers
    ["cmp", "-S", "256", "--fastcmp", "0.5", "--bbit-sigs"],
])
def test_cli_rejects_other_comparisons(corpus, argv, tmp_path):
    lst, _ = corpus
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--cmpout", str(tmp_path / "o"), "-F", lst,
                         "--device", "cpu"])
    assert e.value.code == 2


def test_pairwise_rejects_routes_outside_the_slice(corpus, monkeypatch):
    _, paths = corpus
    kw = dict(k=31, sketchsize=256, fd_level=0.5, truncation_method=1)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    bad = [Dashing2DistOptions(**kw, measure=Measure.POISSON_LLR),
           Dashing2DistOptions(k=31, sketchsize=256, fd_level=0.5)]
    for opts in bad:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            next(PC.pairwise_matrix(opts, from_reference(ref),
                                    device="cpu"))
    one = from_reference(ref)
    one.names, one.signatures = one.names[:1], one.signatures[:1]
    one.cardinalities = one.cardinalities[:1]
    with pytest.raises(NotImplementedError, match="2 <= n"):
        next(PC.pairwise_matrix(Dashing2DistOptions(**kw), one,
                                device="cpu"))
