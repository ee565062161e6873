"""Port parity for the panel jobs (`-Q`: references x queries), on the CPU.

The same seeded sketches go through the JAX package's `pairwise_matrix`
and the port's, for every register kind (nibble b-bit and a/b, u8, u16
and u32 b-bit and a/b, full registers, and full registers compared for
equality) and the measures SIMILARITY, CONTAINMENT, UNION_SIZE and
POISSON_LLR, at three sizes:

* n = 40 (30 references, 10 queries): below 64 both packages take the
  numpy row-block route, whose epilogue rounds every step;
* n = 120 (90 x 30): the JAX package's fused panel engine
  (`_panel_matrix_fn_m`), forced on its CPU backend for every kind with
  DASHING2_TPU_KERNEL=swar and held to one device with
  DASHING2_TPU_MULTICHIP=0 (the tests' 8-device mesh would take its
  sharded panel engine);
* the a/b kinds at 4200 references x 8 queries, m = 64: above 4096 rows
  the JAX `_tiled_epilogue` scans 1024-row tiles, so which count its
  fused multiply-add takes is held there too.

Values must be equal bit for bit, except POISSON_LLR on the fused route,
whose f32 log1p may differ by up to 3 ulp (README "Documented
deviations"). The port's blocks cover exactly the reference rows, nq
values wide, and its rectangles launch no self-pairs kernel.

The CLI's binary and TSV panel output must equal the JAX CLI's byte for
byte over seeded FASTA corpora of n = 40 and 80 (its measures leave out
POISSON_LLR, whose fused-route bits are the deviation above).
"""

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.enums import Measure as JMeasure
from dashing2_tpu.result import SketchingResult as JResult
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import from_reference

# register kinds: the options each is built from
KINDS = {
    "nibble-bbit": dict(fd_level=0.5, truncation_method=1),
    "nibble-ab": dict(fd_level=0.5),
    "u8-bbit": dict(fd_level=1.0, truncation_method=1),
    "u8-ab": dict(fd_level=1.0),
    "u16-bbit": dict(fd_level=2.0, truncation_method=1),
    "u16-ab": dict(fd_level=2.0),
    "u32-bbit": dict(fd_level=4.0, truncation_method=1),
    "u32-ab": dict(fd_level=4.0),
    "full": dict(),
    "eqfull": dict(truncation_method=1),
}
AB_KINDS = ["nibble-ab", "u8-ab", "u16-ab", "u32-ab"]
MEASURES = ["SIMILARITY", "CONTAINMENT", "UNION_SIZE", "POISSON_LLR"]
# (references, queries, m) per size
SIZES = {"numpy": (30, 10, 64), "fused": (90, 30, 64),
         "scan": (4200, 8, 64)}
FUSED_ENV = {"DASHING2_TPU_KERNEL": "swar", "DASHING2_TPU_MULTICHIP": "0"}
POISSON_ULP = 3


def _sketches(nf: int, nq: int, m: int, seed: int) -> JResult:
    """Seeded f64 signatures in families (a quarter as many ancestors as
    rows, about 15% of each row's registers redrawn), so that pairs span
    similarities from 0 to 1, and cardinalities of 1e3-1e5."""
    rng = np.random.default_rng(seed)
    n = nf + nq
    base = rng.exponential(size=(n // 4 + 1, m))
    sigs = base[rng.integers(0, len(base), n)]
    redraw = rng.random((n, m)) < 0.15
    sigs = np.where(redraw, rng.exponential(size=(n, m)), sigs)
    res = JResult(names=[f"s{i}" for i in range(n)])
    res.signatures = sigs
    res.cardinalities = rng.uniform(1e3, 1e5, n)
    res.nq = nq
    return res


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.uint32).astype(np.int64)
                  - b.view(np.uint32).astype(np.int64))


def _compare(kind: str, msr: str, size: str, monkeypatch):
    nf, nq, m = SIZES[size]
    ref = _sketches(nf, nq, m, seed=nf + len(kind))
    port_res = from_reference(ref)
    kw = dict(k=31, sketchsize=m, **KINDS[kind])
    if size != "numpy":
        for key, val in FUSED_ENV.items():
            monkeypatch.setenv(key, val)
    want = list(JC.pairwise_matrix(JOptions(**kw, measure=JMeasure[msr]),
                                   ref, block=64))
    launches = []
    for name in ("tri_eq_counts", "tri_comb_counts", "int_counts_self"):
        monkeypatch.setattr(PC, name, lambda *a, name=name: launches.append(
            name))
    got = list(PC.pairwise_matrix(
        Dashing2DistOptions(**kw, measure=Measure[msr]), port_res,
        block=64, device="cpu"))
    assert not launches
    assert [s for s, _ in got] == list(range(0, nf, 64))
    assert [s for s, _ in want] == [s for s, _ in got]
    g = np.concatenate([b for _, b in got])
    w = np.concatenate([b for _, b in want])
    assert g.dtype == np.float32 and g.shape == w.shape == (nf, nq)
    assert np.isfinite(g).all()
    if msr == "SIMILARITY":
        assert g.max() > 0.5 and g.min() < 0.2
    if msr == "POISSON_LLR" and size != "numpy":
        assert _ulps(g, w).max() <= POISSON_ULP
    else:
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("msr", MEASURES)
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("size", ["numpy", "fused"])
def test_panel_values_equal_jax(size, kind, msr, monkeypatch):
    _compare(kind, msr, size, monkeypatch)


@pytest.mark.parametrize("msr", MEASURES)
@pytest.mark.parametrize("kind", AB_KINDS)
def test_panel_above_4096_references_equal_jax(kind, msr, monkeypatch):
    """4200 references: the JAX epilogue's 1024-row scan. The fused
    panel engine multiplies the reference's count at every row count
    (cmp/core.py::_epilogue)."""
    _compare(kind, msr, "scan", monkeypatch)


def test_panel_rows_are_one_rectangle_per_block(monkeypatch):
    """Each reference row block is one int_counts launch against all the
    queries (gtlt_counts behind it for u32, u64 and eqfull)."""
    nf, nq, m = 150, 20, 64
    ref = _sketches(nf, nq, m, seed=1)
    calls, counts = [], PC.int_counts

    def spy(a, b):
        calls.append((a.shape[0], b.shape[0]))
        return counts(a, b)
    monkeypatch.setattr(PC, "int_counts", spy)
    for kind in ("nibble-ab", "u8-bbit", "full"):
        calls.clear()
        blocks = list(PC.pairwise_matrix(
            Dashing2DistOptions(k=31, sketchsize=m, **KINDS[kind]),
            from_reference(ref), block=64, device="cpu"))
        assert calls == [(64, nq), (64, nq), (22, nq)], kind
        assert [b.shape for _, b in blocks] == [(64, nq), (64, nq),
                                                (22, nq)]


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

CLI_FLAGS = {
    "nibble-bbit": ["--fastcmp", "0.5", "--bbit-sigs"],
    "nibble-ab": ["--fastcmp", "0.5"],
    "full": [],
    "u8-ab-containment": ["--fastcmp", "1", "--containment"],
    "u16-bbit": ["--fastcmp", "2", "--bbit-sigs"],
    "eqfull-symcontain": ["--bbit-sigs", "--symmetric-containment"],
}
FORMATS = {"binary": ["--binary-output"], "tsv": []}


@pytest.fixture(scope="module", params=[40, 80])
def panel_corpus(request, tmp_path_factory):
    """Seeded FASTA runs split into references and queries (every fifth
    item a query, so each query has siblings among the references)."""
    n = request.param
    d = tmp_path_factory.mktemp(f"panel_{n}")
    paths = write_corpus(str(d / "fa"), seed=n + 7, n_ancestors=n // 10,
                         n_mutants=10, length=2500)
    refs = [p for i, p in enumerate(paths) if i % 5]
    queries = paths[::5]
    (d / "refs.txt").write_text("\n".join(refs) + "\n")
    (d / "queries.txt").write_text("\n".join(queries) + "\n")
    return str(d / "refs.txt"), str(d / "queries.txt"), len(refs), \
        len(queries)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("flags", sorted(CLI_FLAGS))
def test_cli_panel_bytes_equal_jax(panel_corpus, flags, fmt, tmp_path,
                                   monkeypatch):
    refs, queries, nf, nq = panel_corpus
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    argv = ["sketch", "-k", "31", "-S", "256"] + CLI_FLAGS[flags] \
        + FORMATS[fmt] + ["-F", refs, "-Q", queries]
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    for key, val in FUSED_ENV.items():
        monkeypatch.setenv(key, val)
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    with open(out_port, "rb") as f:
        got = f.read()
    with open(out_jax, "rb") as f:
        want = f.read()
    if fmt == "binary":
        assert len(got) == 4 * nf * nq
    else:
        lines = got.decode().splitlines()
        assert lines[0] == "#Dashing2 Panel (Query/Refernce) Output"
        assert len(lines) == 3 + nf
        assert all(len(ln.split("\t")) == nq + 1 for ln in lines[3:])
    assert got == want


def test_cli_pairlist_bytes_equal_jax(panel_corpus, tmp_path):
    """--pairlist: the unique paths its lines name, in first-seen order,
    compared all-pairs, as the JAX CLI does; paths beside it are an
    error in both."""
    refs, queries, _, _ = panel_corpus
    with open(refs) as f:
        paths = f.read().split()
    pl = tmp_path / "pairs.txt"
    pl.write_text("".join(f"{paths[i]} {paths[(3 * i + 1) % len(paths)]}\n"
                          for i in range(len(paths))))
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    argv = ["sketch", "-k", "31", "-S", "256", "--binary-output",
            "--pairlist", str(pl)]
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    with open(out_port, "rb") as f, open(out_jax, "rb") as g:
        got, want = f.read(), g.read()
    n = len(paths)
    assert len(got) == 4 * n * (n - 1) // 2 and got == want
    assert cli.main(argv + [paths[0], "--cmpout", out_port,
                            "--device", "cpu"]) == 1
