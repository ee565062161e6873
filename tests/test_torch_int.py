"""Port parity for the `--fastcmp 1`, `2` and `4` all-pairs jobs (u8, u16
and u32 registers, b-bit with --bbit-sigs and SetSketch a/b without),
and for every flag set the port runs at small n, on the CPU.

`sketch -k 31 -S 256 --fastcmp {1,2,4} [--bbit-sigs]` over seeded FASTA
runs through dashing2_tpu_torch.cli.main(..., "--device", "cpu") and
through dashing2_tpu.cli.main; the output bytes must be equal (tolerance
zero):

* at n = 70 and 300, binary and PHYLIP, on the JAX package's default CPU
  route (the tests' 8-device mesh) and on its accelerator route (counts
  pull where the kind allows it + upper trapezoids, one device). Unlike
  the nibble a/b kind (tests/test_torch_cli.py), the wide a/b kinds give
  the same bytes on the mesh and on one device at these n: both
  multiply lt in the epilogue's fused multiply-add
  (cmp/core.py::_epilogue);
* on the row-block route (the port's SELF_MAX monkeypatched to 0, the
  JAX package's DASHING2_TPU_SELF_MAX=0), with one int_counts launch per
  row block;
* at n = 20 and n = 2, below the JAX package's jitted routes (its numpy
  epilogues), for every flag set the port runs, the nibble and
  full-register ones included.

`make_compressed` must give the JAX package's registers (data, a, b,
truncation) for each width, and `creps_from_reference` must carry them
across.
"""

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import from_reference

SKETCH = ["sketch", "-k", "31", "-S", "256"]
ONE_DEVICE = {"DASHING2_TPU_MULTICHIP": "0"}
# the new flag sets (argv after SKETCH), and every flag set the port runs
# with the JAX environment each needs, for the small-n cases
WIDTHS = {f"{fd}-{kind}": (["--fastcmp", fd] + (["--bbit-sigs"]
                                               if kind == "bbit" else []), {})
          for fd in ("1", "2", "4") for kind in ("bbit", "ab")}
ALL_FLAGS = {**WIDTHS,
             "0.5-bbit": (["--fastcmp", "0.5", "--bbit-sigs"], {}),
             "0.5-ab": (["--fastcmp", "0.5"], ONE_DEVICE),
             "full": ([], {})}
JAX_ROUTES = {
    "default": {},
    "accelerator": {"DASHING2_TPU_PULL_COUNTS": "force",
                    "DASHING2_TPU_UPPER": "force",
                    "DASHING2_TPU_MULTICHIP": "0"},
}
FORMATS = {"binary": ["--binary-output"], "phylip": ["--phylip"]}


def _write(d, n: int, seed: int):
    paths = write_corpus(str(d / "fa"), seed=seed,
                         n_ancestors=max(1, n // 10),
                         n_mutants=min(n, 10), length=2500)
    assert len(paths) == n
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


@pytest.fixture(scope="module", params=[70, 300])
def corpus(request, tmp_path_factory):
    n = request.param
    return _write(tmp_path_factory.mktemp(f"int_{n}"), n, seed=n + 4)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, monkeypatch, env):
    """(port bytes, JAX bytes) of one argv; the JAX package runs under
    `env`."""
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    return _read(out_port), _read(out_jax)


def _check_binary(got: bytes, n: int) -> None:
    assert len(got) == 4 * n * (n - 1) // 2
    vals = np.frombuffer(got, np.float32)
    assert np.isfinite(vals).all() and vals.min() >= 0 and vals.max() <= 1


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("flags", sorted(WIDTHS))
def test_cli_output_bytes_equal_jax(corpus, flags, fmt, route, tmp_path,
                                    monkeypatch):
    lst, paths = corpus
    extra, env = WIDTHS[flags]
    argv = SKETCH + extra + FORMATS[fmt] + ["-F", lst]
    got, want = _both(argv, tmp_path, monkeypatch,
                      {**JAX_ROUTES[route], **env})
    if fmt == "binary":
        _check_binary(got, len(paths))
        assert np.frombuffer(got, np.float32).max() > 0.5
    assert got == want


@pytest.mark.parametrize("flags", sorted(WIDTHS))
def test_row_block_route_bytes_equal_jax(corpus, flags, tmp_path,
                                         monkeypatch):
    """SELF_MAX = 0: one int_counts launch per 64-row block against the
    rows from its start on, and the JAX package's numpy row-block
    epilogue's bytes."""
    lst, paths = corpus
    n = len(paths)
    extra, env = WIDTHS[flags]
    argv = SKETCH + extra + ["--binary-output", "--batch-size", "64",
                             "-F", lst]
    calls, counts = [], PC.int_counts

    def spy(a, b):
        calls.append((a.shape[0], b.shape[0]))
        return counts(a, b)
    monkeypatch.setattr(PC, "int_counts", spy)
    monkeypatch.setattr(PC, "SELF_MAX", 0)
    got, want = _both(argv, tmp_path, monkeypatch,
                      {"DASHING2_TPU_SELF_MAX": "0", **env})
    assert calls == [(min(64, n - s), n - s) for s in range(0, n, 64)]
    _check_binary(got, n)
    assert got == want


@pytest.fixture(scope="module", params=[2, 20])
def small_corpus(request, tmp_path_factory):
    n = request.param
    return _write(tmp_path_factory.mktemp(f"small_{n}"), n, seed=n)


@pytest.mark.parametrize("flags", sorted(ALL_FLAGS))
def test_small_n_bytes_equal_jax(small_corpus, flags, tmp_path,
                                 monkeypatch):
    """n < 64: the JAX package's generic row-block route and its numpy
    epilogues (b-bit: one IEEE division, not the jitted routes' product
    with the reciprocal)."""
    lst, paths = small_corpus
    extra, env = ALL_FLAGS[flags]
    argv = SKETCH + extra + ["--binary-output", "-F", lst]
    got, want = _both(argv, tmp_path, monkeypatch, env)
    _check_binary(got, len(paths))
    assert got == want


@pytest.mark.parametrize("truncation", [1, 0])
@pytest.mark.parametrize("fd", [1.0, 2.0, 4.0])
def test_compressed_registers_equal_jax(corpus, fd, truncation, monkeypatch):
    _, paths = corpus
    kw = dict(k=31, sketchsize=256, fd_level=fd,
              truncation_method=truncation)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    port_creps, port_res = PC._prep(Dashing2DistOptions(**kw),
                                    from_reference(ref))
    jax_creps, _ = JC._prep(JOptions(**kw), ref)
    carried = PC.creps_from_reference(jax_creps)
    want_type = {1.0: np.uint8, 2.0: np.uint16, 4.0: np.uint32}[fd]
    assert jax_creps.data.dtype == want_type
    for c in (port_creps, carried):
        assert c.data.dtype == want_type and not c.nibble_packed
        np.testing.assert_array_equal(c.data, jax_creps.data)
        assert (c.a, c.b, c.truncation) == \
            (jax_creps.a, jax_creps.b, jax_creps.truncation)
    kind, _ = PC._representation(Dashing2DistOptions(**kw), port_res,
                                 port_creps)
    assert kind == ("bbit" if truncation else "ab")
    if truncation:
        # the top bits of reg2sig: 6 of them for u8
        assert int(port_creps.data.max()) < (64 if fd == 1.0 else 1 << 62)
    else:
        assert port_creps.b > 1.0 and port_creps.a > 0.0
