"""Port parity for the asymmetric all-pairs output, the one-input job and
the nibble row-block route, on the CPU.

* `--asymmetric-all-pairs`: the "Asymmetric pairwise" TSV header with
  full rows, and the row-major (N, N) f32 binary, byte for byte with
  dashing2_tpu.cli on one JAX device, at n = 70 (jitted route) and
  n = 20 (numpy route), for CONTAINMENT (the asymmetric measure: full
  registers divide by the column's cardinality, the compressed kinds by
  the row's; the nibble a/b value multiplies its own gt in the fused
  multiply-add on both sides of the diagonal) and for other measures;
* n = 1: exit 0 and the JAX CLI's bytes in binary, PHYLIP and TSV;
* the row-block route (the port's SELF_MAX monkeypatched to 0, the JAX
  package's DASHING2_TPU_SELF_MAX=0, --batch-size 64): packed nibbles
  unpacked once on the device and one int_counts launch per row block,
  symmetric and asymmetric, byte for byte with the JAX numpy route;
* `_unpack_nibbles` equals the JAX package's (spilled a/b nibbles
  included), and int_counts on the unpacked registers equals the JAX
  counts.

Tolerance zero (POISSON_LLR on the jitted route: tests/test_torch_measures.py).
"""

import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.ops.int_counts import int_counts

SKETCH = ["sketch", "-k", "31", "-S", "256"]
FLAGS = {"nibble-bbit": ["--fastcmp", "0.5", "--bbit-sigs"],
         "nibble-ab": ["--fastcmp", "0.5"],
         "u8-ab": ["--fastcmp", "1"],
         "u16-bbit": ["--fastcmp", "2", "--bbit-sigs"],
         "full": [], "eqfull": ["--bbit-sigs"]}
FORMATS = {"binary": ["--binary-output"], "tsv": [], "phylip": ["--phylip"]}
ONE_DEVICE = {"DASHING2_TPU_MULTICHIP": "0"}


def _write(d, n: int, seed: int):
    paths = write_corpus(str(d / "fa"), seed=seed,
                         n_ancestors=max(1, n // 10), n_mutants=min(n, 10),
                         length=2500)
    assert len(paths) == n
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), n


@pytest.fixture(scope="module", params=[20, 70])
def corpus(request, tmp_path_factory):
    n = request.param
    return _write(tmp_path_factory.mktemp(f"asym_{n}"), n, seed=n + 21)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, monkeypatch, env=None):
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    for key, val in {**ONE_DEVICE, **(env or {})}.items():
        monkeypatch.setenv(key, val)
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    return _read(out_port), _read(out_jax)


ASYM = {"containment-full": ("full", "--containment"),
        "containment-nibble-ab": ("nibble-ab", "--containment"),
        "containment-u16-bbit": ("u16-bbit", "--containment"),
        "union-u8-ab": ("u8-ab", "--union-size"),
        "intersection-eqfull": ("eqfull", "--intersection"),
        "similarity-nibble-bbit": ("nibble-bbit", None)}


@pytest.mark.parametrize("fmt", ["binary", "tsv"])
@pytest.mark.parametrize("case", sorted(ASYM))
def test_asymmetric_bytes_equal_jax(corpus, case, fmt, tmp_path,
                                    monkeypatch):
    lst, n = corpus
    kind, flag = ASYM[case]
    argv = (SKETCH + FLAGS[kind] + ([flag] if flag else [])
            + ["--asymmetric-all-pairs"] + FORMATS[fmt] + ["-F", lst])
    got, want = _both(argv, tmp_path, monkeypatch)
    if fmt == "binary":
        mat = np.frombuffer(got, np.float32).reshape(n, n)
        assert np.isfinite(mat).all()
        if flag == "--containment":
            # containment is not symmetric: the cardinalities differ
            assert (mat != mat.T).any()
        elif flag is None:
            np.testing.assert_array_equal(np.diag(mat), 1.0)
    else:
        lines = got.decode().splitlines()
        assert lines[0] == "#Dashing2 Asymmetric pairwise Output"
        assert len(lines) == 3 + n
        assert all(len(ln.split("\t")) == n + 1 for ln in lines[3:])
    assert got == want


@pytest.fixture(scope="module")
def one_input(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("one"), 1, seed=5)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("kind", ["nibble-bbit", "nibble-ab", "full"])
def test_one_input_bytes_equal_jax(one_input, kind, fmt, tmp_path,
                                   monkeypatch):
    """n = 1: the JAX generic loop yields one 1-row block; the symmetric
    emitters write no value (an empty binary file, one PHYLIP row, the
    TSV header and one row with its placeholder)."""
    lst, _ = one_input
    argv = SKETCH + FLAGS[kind] + FORMATS[fmt] + ["-F", lst]
    got, want = _both(argv, tmp_path, monkeypatch)
    assert got == want
    if fmt == "binary":
        assert got == b""
    elif fmt == "tsv":
        assert got.decode().splitlines()[-1].endswith("\t-")


ROW_BLOCK = {"nibble-bbit": "--mash-distance", "nibble-ab": "--intersection",
             "eqfull": "--union-size", "u16-bbit": "--symmetric-containment"}


@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("kind", sorted(ROW_BLOCK))
def test_row_block_route_bytes_equal_jax(corpus, kind, asym, tmp_path,
                                         monkeypatch):
    """SELF_MAX = 0: one int_counts launch per 64-row block against the
    columns it needs (the rows from its start on, or all of them for the
    asymmetric square) and the JAX numpy row-block epilogue's bytes."""
    lst, n = corpus
    argv = (SKETCH + FLAGS[kind] + [ROW_BLOCK[kind], "--binary-output",
                                    "--batch-size", "64", "-F", lst]
            + (["--asymmetric-all-pairs"] if asym else []))
    calls, counts = [], PC.int_counts

    def spy(a, b):
        calls.append((a.shape, b.shape))
        return counts(a, b)
    monkeypatch.setattr(PC, "int_counts", spy)
    monkeypatch.setattr(PC, "SELF_MAX", 0)
    got, want = _both(argv, tmp_path, monkeypatch,
                      {"DASHING2_TPU_SELF_MAX": "0"})
    m = 256
    assert [(a[0], b[0]) for a, b in calls] == \
        [(min(64, n - s), n if asym else n - s) for s in range(0, n, 64)]
    # nibbles arrive unpacked: one u8 register per column
    assert all(a[1] == b[1] == m for a, b in calls)
    assert len(got) == 4 * (n * n if asym else n * (n - 1) // 2)
    assert got == want


@pytest.mark.parametrize("bbit", [True, False])
def test_unpacked_nibbles_and_counts_equal_jax(bbit, tmp_path, monkeypatch):
    """The device unpack (low nibbles first) and the rectangular counts on
    the unpacked registers equal the JAX package's, including a/b
    nibbles whose value 16 spilled into the neighbouring nibble."""
    paths = write_corpus(str(tmp_path / "fa"), seed=8, n_ancestors=3,
                         n_mutants=6, length=2500)
    kw = dict(k=31, sketchsize=256, fd_level=0.5,
              truncation_method=1 if bbit else 0)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    creps, _ = JC._prep(JOptions(**kw), jax_sketch_fastx(JOptions(**kw),
                                                         paths))
    packed = creps.data.copy()
    packed[0, :4] = [0x10, 0xFF, 0x01, 0xF0]     # spilled and edge bytes
    got = PC._unpack_nibbles(torch.from_numpy(packed))
    want = JC._unpack_nibbles(packed)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    eq, gt, lt = int_counts(got[:5], got)
    jeq, jgt, jlt = JC._counts_int(want[:5], want, want_gtlt=True)
    for g, w in ((eq, jeq), (gt, jgt), (lt, jlt)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
