"""Port parity for every measure of the all-pairs jobs: SIMILARITY,
INTERSECTION, UNION_SIZE, CONTAINMENT, SYMMETRIC_CONTAINMENT and
POISSON_LLR (`--mash-distance`), on the CPU.

* Estimator level, for every kind (nibble b-bit and a/b, u8/u16/u32
  b-bit and a/b, full registers, equality-compared full registers) and
  both JAX routes: every count (every (gt, lt) pair for the a/b kinds) at
  m = 64, and a seeded sample at m = 1000, against a seeded cardinality
  grid with equal, zero and very unequal cardinalities. The JAX function
  runs jitted as its self-pairs route runs it (`_tiled_epilogue` over
  count matrices and the rows' and columns' cardinalities) and on numpy
  as its row-block route runs it; the port's estimator gives the bits of
  the route it is asked for. Tolerance zero, except POISSON_LLR on the
  jitted route: XLA's log1p is its own approximation, and the port's
  (f64 log1p rounded once to f32) stays within 3 ulp of it, the JAX
  routes' own disagreement (README "Documented deviations").
* The POISSON_LLR tables over every count at m in {256, 1000, 1024}:
  the numpy-route table equals the JAX numpy route bit for bit, the
  fused table is within 3 ulp of the JAX jitted route.
* CLI level: `sketch -k 31 -S 256` with each measure flag, through
  dashing2_tpu_torch.cli.main(..., "--device", "cpu") and
  dashing2_tpu.cli.main on one JAX device, in binary and TSV, at n = 70
  (the jitted route) and n = 20 (the numpy route): equal bytes
  (POISSON_LLR at n = 70: within 3 ulp); every kind at n = 70 with
  `--containment`; `--bbit-sigs` without `--fastcmp` (equality-compared
  full registers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.cmp import estimators as JE
from dashing2_tpu.enums import Measure as JMeasure
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.cmp import estimators as PE
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.result import SketchingResult

MEASURES = [m.name for m in (Measure.SIMILARITY, Measure.INTERSECTION,
                             Measure.UNION_SIZE, Measure.CONTAINMENT,
                             Measure.SYMMETRIC_CONTAINMENT,
                             Measure.POISSON_LLR)]
# kind -> (JAX kind, fd, SetSketch b of a realistic job (a/b kinds))
KINDS = {
    "nibble-bbit": ("nibble-bbit", 0.5, None),
    "nibble-ab": ("nibble-ab", 0.5, 1.0733),
    "u8-bbit": ("bbit", 1.0, None), "u16-bbit": ("bbit", 2.0, None),
    "u32-bbit": ("bbit", 4.0, None),
    "u8-ab": ("ab", 1.0, 1.0571), "u16-ab": ("ab", 2.0, 1.0002),
    "u32-ab": ("ab", 4.0, 1.0 + 2.7e-9),
    "full": ("full", 8.0, None), "eqfull": ("eqfull", 8.0, None),
}
# the JAX routes' own disagreement on POISSON_LLR (f32 log1p)
POISSON_ULP = 3


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _ulps(a, b) -> np.ndarray:
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


def _cards(n: int, seed: int) -> np.ndarray:
    """Seeded f64 cardinalities: zeros, ones, tiny and huge values next to
    ordinary ones, so that pairs are equal, 0 or very unequal."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, 1.0, 3.0, 2500.0, 2500.0, 1e9, 4.5e6,
                        12345.678])
    c = rng.uniform(1.0, 1e7, n)
    pick = rng.random(n) < 0.5
    c[pick] = rng.choice(special, int(pick.sum()))
    return c


def _counts(kind: str, m: int, seed: int):
    """(c1, c2) int32 count matrices: eq counts (c2 None) or (gt, lt). At
    m = 64 every count, every (gt, lt) pair for the a/b kinds; otherwise
    a seeded 96 x 96 sample."""
    rng = np.random.default_rng(seed)
    if m == 64:
        c = np.arange(m + 1, dtype=np.int32)
        if KINDS[kind][0] in ("ab", "nibble-ab"):
            return np.repeat(c[:, None], m + 1, 1), np.repeat(c[None], m + 1,
                                                              0)
        if kind == "full":
            return c[:, None] // 2 + np.zeros((1, m + 1), np.int32), \
                (c[None] + 1) // 2 + np.zeros((m + 1, 1), np.int32)
        return (c[:, None] + c[None]) % (m + 1), None
    if KINDS[kind][0] in ("bbit", "nibble-bbit", "eqfull"):
        return rng.integers(0, m + 1, (96, 96)).astype(np.int32), None
    gt = rng.integers(0, m + 1, (96, 96)).astype(np.int32)
    lt = (rng.random((96, 96)) * (m + 1 - gt)).astype(np.int32)
    return gt, lt


def _jax_jitted(kind, m, msr, c1, c2, lh, rh):
    jkind, fd, b = KINDS[kind]
    bf = b or 1.0 + 1e-9
    gbt, gbinv = JC._gb_args(bf, m)
    f = jax.jit(lambda a, bb, x, y: JC._tiled_epilogue(
        jkind, m, JMeasure[msr], 31, fd, a, bb, x, y, bf, (gbt, gbinv)))
    return np.asarray(f(jnp.asarray(c1),
                        None if c2 is None else jnp.asarray(c2),
                        jnp.asarray(lh), jnp.asarray(rh)))


def _jax_numpy(kind, m, msr, c1, c2, lh, rh):
    jkind, fd, b = KINDS[kind]
    jm, x, y = JMeasure[msr], lh[:, None], rh[None, :]
    if jkind in ("bbit", "nibble-bbit"):
        return JE.bbit_measures32(c1, m, fd, x, y, jm, 31)
    if jkind == "eqfull":
        return JE.equality_measures32(c1, m, x, y, jm, 31)
    if jkind == "full":
        return JE.full_setsketch_measures32(c1, c2, m, x, y, jm, 31)
    return JE.compressed_ab_measures32(
        c1, c2, m, b, fd, x, y, jm, 31,
        gb_form="product" if jkind == "nibble-ab" else "complement")


def _port(kind, m, msr, c1, c2, lh, rh, fused):
    jkind, fd, b = KINDS[kind]
    t = torch.from_numpy
    x = t(lh.astype(np.float32))[:, None]
    y = t(rh.astype(np.float32))[None, :]
    pm = Measure[msr]
    if jkind in ("bbit", "nibble-bbit"):
        out = PE.bbit_measures32(t(c1), m, fd, pm, fused, x, y)
    elif jkind == "eqfull":
        out = PE.equality_measures32(t(c1), m, pm, fused, x, y)
    elif jkind == "full":
        out = PE.full_setsketch_measures32(t(c1), t(c2), m, pm, fused, x, y)
    else:
        table, gbinv = PC._gb_args(b, m)
        out = PE.compressed_ab_measures32(
            t(c1), t(c2), m, b, fd, pm, table, gbinv, fused,
            "product" if jkind == "nibble-ab" else "complement", x, y)
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("m", [64, 1000])
@pytest.mark.parametrize("msr", MEASURES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_estimators_bits_equal_jax_routes(kind, msr, m):
    c1, c2 = _counts(kind, m, seed=m)
    lh, rh = _cards(c1.shape[0], 1), _cards(c1.shape[1], 2)
    rh[:c1.shape[0] // 2] = lh[:c1.shape[0] // 2]     # equal pairs
    numpy_route = _jax_numpy(kind, m, msr, c1, c2, lh, rh)
    got = _port(kind, m, msr, c1, c2, lh, rh, fused=False)
    assert got.shape == numpy_route.shape
    np.testing.assert_array_equal(_bits(got), _bits(numpy_route))
    jitted = _jax_jitted(kind, m, msr, c1, c2, lh, rh)
    got = _port(kind, m, msr, c1, c2, lh, rh, fused=True)
    if msr == "POISSON_LLR":
        assert _ulps(got, jitted).max() <= POISSON_ULP
    else:
        np.testing.assert_array_equal(_bits(got), _bits(jitted))
    if msr == "CONTAINMENT":
        # the grid reaches a 0 denominator (FINF) and disjoint pairs (0)
        assert (got == np.finfo(np.float32).max).any() and (got == 0).any()


@pytest.mark.parametrize("m", [256, 1000, 1024])
@pytest.mark.parametrize("kind", ["nibble-bbit", "u8-bbit", "nibble-ab",
                                  "u16-ab", "full", "eqfull"])
def test_poisson_tables_over_every_count(kind, m):
    """The POISSON_LLR tables the epilogue gathers from, over every count
    (every (gt, lt) pair for the a/b kinds): the numpy-route table is
    the JAX numpy route's bits, the fused one within POISSON_ULP of the
    JAX jitted route."""
    jkind, fd, b = KINDS[kind]
    c = np.arange(m + 1, dtype=np.int32)
    one = np.ones(m + 1)
    ab_args = None
    if jkind.endswith("ab"):
        c1, c2 = np.repeat(c[:, None], m + 1, 1), np.repeat(c[None], m + 1, 0)
        table, gbinv = PC._gb_args(b, m)
        ab_args = (b, table, gbinv, "product" if jkind == "nibble-ab"
                   else "complement")
    elif jkind == "full":
        c1, c2 = c[None], np.zeros((1, m + 1), np.int32)
    else:
        c1, c2 = c[None], None
    for fused in (False, True):
        got = PC.measure_table(jkind, m, fd, Measure.POISSON_LLR, 31, "cpu",
                               fused, ab_args).numpy()
        rows, cols = c1.shape
        if fused:
            want = _jax_jitted(kind, m, "POISSON_LLR", c1, c2, one[:rows],
                               one[:cols])
            assert _ulps(got, want.reshape(-1)).max() <= POISSON_ULP
        else:
            want = _jax_numpy(kind, m, "POISSON_LLR", c1, c2, one[:rows],
                              one[:cols])
            np.testing.assert_array_equal(_bits(got), _bits(want.reshape(-1)))
        assert np.isinf(got).sum() == 0 and (got > 0).any()


@pytest.mark.filterwarnings("ignore:divide by zero")
def test_log1p32_forms():
    x = torch.tensor([-1.0, -0.5, -1e-7, 0.0, 1e-3], dtype=torch.float32)
    plain = PE.log1p32(x, fused=False).numpy()
    np.testing.assert_array_equal(_bits(plain), _bits(np.log1p(x.numpy())))
    fused = PE.log1p32(x, fused=True).numpy()
    want = np.log1p(x.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_bits(fused), _bits(want))
    assert fused[0] == -np.inf and fused[3] == 0


@pytest.mark.parametrize("n", [20, 70])
def test_ab_poisson_without_table_equals_table(n, monkeypatch):
    """Above (m+1)^2 = _AB_TABLE_MAX the a/b POISSON_LLR epilogue runs the
    estimator per block instead of gathering from its table: the same
    bits, on both routes."""
    rng = np.random.default_rng(n)
    m = 256
    cards, sigs = rng.uniform(1e3, 1e5, n), rng.exponential(size=(n, m))
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               measure=Measure.POISSON_LLR)

    def run():
        res = SketchingResult(names=[f"s{i}" for i in range(n)],
                              cardinalities=cards.copy(),
                              signatures=sigs.copy())
        return np.concatenate([b for _, b in PC.pairwise_matrix(
            opts, res, block=32, device="cpu")])
    table = run()
    monkeypatch.setattr(PC, "_AB_TABLE_MAX", 0)
    np.testing.assert_array_equal(_bits(run()), _bits(table))
    assert np.isfinite(table).all() and (table > 0).any()


def test_cardinality_measures_need_cardinalities():
    with pytest.raises(ValueError, match="cardinalities"):
        PE.bbit_measures32(torch.arange(5), 4, 0.5, Measure.CONTAINMENT)


SKETCH = ["sketch", "-k", "31", "-S", "256"]
FLAGS = {"nibble-bbit": ["--fastcmp", "0.5", "--bbit-sigs"],
         "nibble-ab": ["--fastcmp", "0.5"],
         "u8-bbit": ["--fastcmp", "1", "--bbit-sigs"],
         "u8-ab": ["--fastcmp", "1"],
         "u16-bbit": ["--fastcmp", "2", "--bbit-sigs"],
         "u16-ab": ["--fastcmp", "2"],
         "u32-bbit": ["--fastcmp", "4", "--bbit-sigs"],
         "u32-ab": ["--fastcmp", "4"],
         "full": [], "eqfull": ["--bbit-sigs"]}
# measure flag -> the kind its CLI case runs
MEASURE_FLAGS = {"--intersection": "nibble-ab", "--union-size": "full",
                 "--containment": "u16-bbit",
                 "--symmetric-containment": "u32-ab",
                 "--mash-distance": "nibble-bbit", "--bbit-sigs": "eqfull"}
FORMATS = {"binary": ["--binary-output"], "tsv": []}
# the JAX package's single-device routes (the port runs on one card)
ONE_DEVICE = {"DASHING2_TPU_MULTICHIP": "0"}


@pytest.fixture(scope="module", params=[20, 70])
def corpus(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"measures_{n}")
    paths = write_corpus(str(d / "fa"), seed=n + 9, n_ancestors=n // 10,
                         n_mutants=10, length=2500)
    assert len(paths) == n
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), n


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, monkeypatch):
    out_port, out_jax = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + ["--cmpout", out_port, "--device", "cpu"]) == 0
    for key, val in ONE_DEVICE.items():
        monkeypatch.setenv(key, val)
    assert jax_cli.main(argv + ["--cmpout", out_jax]) == 0
    return _read(out_port), _read(out_jax)


def _values(out: bytes, fmt: str) -> np.ndarray:
    """The f32 values of a binary or symmetric TSV output."""
    if fmt == "binary":
        return np.frombuffer(out, np.float32)
    vals = []
    for line in out.decode().splitlines()[3:]:
        vals += [np.float32(v) for v in line.split("\t")[1:] if v != "-"]
    return np.array(vals, np.float32)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("flag", sorted(MEASURE_FLAGS))
def test_measure_bytes_equal_jax(corpus, flag, fmt, tmp_path, monkeypatch):
    lst, n = corpus
    kind = MEASURE_FLAGS[flag]
    extra = FLAGS[kind] + ([flag] if flag != "--bbit-sigs" else [])
    argv = SKETCH + extra + FORMATS[fmt] + ["-F", lst]
    got, want = _both(argv, tmp_path, monkeypatch)
    vals = _values(got, fmt)
    assert vals.size == n * (n - 1) // 2 and np.isfinite(vals).all()
    if flag == "--mash-distance" and n >= PC.FUSED_MIN_N:
        # the jitted route's log1p: within the documented bound
        ref = _values(want, fmt)
        assert _ulps(vals, ref).max() <= POISSON_ULP
        assert (vals >= 0).all() and (vals < 0.5).any()
    else:
        assert got == want


def test_every_kind_containment_bytes_equal_jax(corpus, tmp_path,
                                                 monkeypatch):
    """CONTAINMENT is the asymmetric measure (full registers divide by the
    column's cardinality, the others by the row's): every kind's bytes."""
    lst, n = corpus
    for kind in sorted(FLAGS):
        argv = SKETCH + FLAGS[kind] + ["--containment", "--binary-output",
                                       "-F", lst]
        got, want = _both(argv, tmp_path, monkeypatch)
        assert len(got) == 4 * n * (n - 1) // 2
        assert got == want, kind


def poisson_ulp_report(ms=(256, 1000, 1024)) -> None:
    """Print, for every kind and m, the largest ulp distance over every
    count between the port's POISSON_LLR tables and the JAX routes (the
    numbers README "Documented deviations" cites):

        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_measures.py
    """
    for kind in sorted(KINDS):
        jkind, fd, b = KINDS[kind]
        for m in ms:
            c = np.arange(m + 1, dtype=np.int32)
            one = np.ones(m + 1)
            ab_args = None
            if jkind.endswith("ab"):
                c1 = np.repeat(c[:, None], m + 1, 1)
                c2 = np.repeat(c[None], m + 1, 0)
                table, gbinv = PC._gb_args(b, m)
                ab_args = (b, table, gbinv, "product"
                           if jkind == "nibble-ab" else "complement")
            elif jkind == "full":
                c1, c2 = c[None], np.zeros((1, m + 1), np.int32)
            else:
                c1, c2 = c[None], None
            rows, cols = c1.shape
            jit = _jax_jitted(kind, m, "POISSON_LLR", c1, c2, one[:rows],
                              one[:cols]).reshape(-1)
            host = _jax_numpy(kind, m, "POISSON_LLR", c1, c2, one[:rows],
                              one[:cols]).reshape(-1)
            fused, plain = (PC.measure_table(
                jkind, m, fd, Measure.POISSON_LLR, 31, "cpu", f,
                ab_args).numpy() for f in (True, False))
            print(f"{kind:12s} m={m:5d}: fused table vs JAX jitted "
                  f"{_ulps(fused, jit).max()} ulp "
                  f"({int((_ulps(fused, jit) > 0).sum())} of {jit.size}); "
                  f"numpy table vs JAX numpy {_ulps(plain, host).max()}; "
                  f"JAX jitted vs JAX numpy {_ulps(jit, host).max()}")


if __name__ == "__main__":
    poisson_ulp_report()
