"""Port parity for the default full-register job (no `--fastcmp`).

* The (m+1) SIMILARITY table over c = gt + lt, in both forms of
  estimators.full_setsketch_measures32, equals the JAX package's
  epilogue on every route, bit for bit over every c in [0, m]: the fused
  form its jitted self-pairs routes (the multi-device mesh's
  `_counts_epilogue_fn`, one device's `_tiled_epilogue`), the unfused
  form its numpy row-block route; at m a power of two both forms and the
  JAX counts-pull table agree.
* The port's `pairwise_matrix` equals the JAX package's block for block
  at m = 200 (where the forms differ) on each route it mirrors.
* The CLI's bytes on the self-pairs route and forced onto the row-block
  route (the port's SELF_MAX monkeypatched) equal the JAX package's on
  one device (DASHING2_TPU_MULTICHIP=0) and on its row-block route
  (DASHING2_TPU_SELF_MAX=0) at n = 70 and 300, in binary, PHYLIP and
  TSV (tests/test_torch_cli.py covers its other routes); so do
  `--f32-registers` jobs.

Tolerance zero everywhere (f32 compared as u32 patterns).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.cmp import estimators as JE
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.ops import cmp_kernels as JCK
from dashing2_tpu.result import SketchingResult as JResult
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.cmp import estimators as PE
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.ops import cmp_kernels as PCK
from dashing2_tpu_torch.result import SketchingResult, from_reference

SIM = Measure.SIMILARITY
FULL = ["sketch", "-k", "31", "-S", "256"]
FORMATS = {"binary": ["--binary-output"], "phylip": ["--phylip"],
           "tsv": []}


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _jax_routes(m: int):
    """The JAX package's SIMILARITY of c = gt + lt for every c in [0, m]
    on each of its routes: (multi-device jitted, one-device jitted,
    numpy, counts-pull table)."""
    c = np.arange(m + 1, dtype=np.int32)
    cnt = np.zeros((m + 1, m + 1), np.int32)
    cnt[:, 0] = c                # pair (c, 0): gt = c, lt = cnt[0, c] = 0
    cards = np.ones(m + 1)
    gbt, gbinv = JC._gb_args(1.0 + 1e-9, m)
    mesh = JC._counts_epilogue_fn("full", m, SIM, 31, 8.0)(
        jnp.asarray(cnt), cards, np.float64(1.0), gbt, gbinv)[:, 0]
    one = jax.jit(lambda g, l: JC._tiled_epilogue(
        "full", m, SIM, 31, 8.0, g, l, jnp.ones(m + 1), jnp.ones(m + 1),
        1.0))(jnp.asarray(cnt), jnp.asarray(cnt.T))[:, 0]
    host = JE.full_setsketch_measures32(c, np.zeros_like(c), m, np.ones(1),
                                        np.ones(1), SIM, 31, xp=np)
    table = np.asarray(JC._sim_table("full", m, 31, 8.0))[m - c]
    return mesh, one, host, table


@pytest.mark.parametrize("m", [30, 64, 100, 128, 256, 300, 1000, 1024])
def test_full_table_bits_equal_jax_routes(m):
    fused = PC.sim_table("full", m, 8.0, "cpu", fused=True)
    plain = PC.sim_table("full", m, 8.0, "cpu", fused=False)
    assert fused.dtype == torch.float32 and fused.shape == (m + 1,)
    mesh, one, host, table = _jax_routes(m)
    for jax_route in (mesh, one):
        np.testing.assert_array_equal(_bits(fused), _bits(jax_route))
    np.testing.assert_array_equal(_bits(plain), _bits(host))
    if m & (m - 1) == 0:
        # c * f32(1/m) is exact: every route and the JAX table agree
        np.testing.assert_array_equal(_bits(fused), _bits(plain))
        np.testing.assert_array_equal(_bits(fused), _bits(table))
    else:
        assert (_bits(fused) != _bits(plain)).any()


def test_full_table_is_the_epilogue_on_count_matrices():
    m = 200
    rng = np.random.default_rng(0)
    gt = torch.from_numpy(rng.integers(0, m // 2 + 1, size=(17, 23)))
    lt = torch.from_numpy(rng.integers(0, m // 2 + 1, size=(17, 23)))
    for fused in (True, False):
        table = PC.sim_table("full", m, 8.0, "cpu", fused)
        direct = PE.full_setsketch_measures32(gt, lt, m, SIM, fused)
        np.testing.assert_array_equal(_bits(table[gt + lt]), _bits(direct))
    with pytest.raises(ValueError, match="invalid"):
        PE.full_setsketch_measures32(gt, lt, m, Measure.M_EDIT_DISTANCE)


@pytest.mark.parametrize("regt32", [False, True])
def test_ordered_bits_equal_jax(regt32):
    rng = np.random.default_rng(1)
    sigs = rng.exponential(size=(9, 64))
    sigs[0, :5] = [0.0, np.finfo(np.float64).max, 1e-300, 1.0, 1.0 + 1e-16]
    got = PC._ordered_bits(Dashing2DistOptions(regt32=regt32), sigs)
    want = JC._ordered_bits(JOptions(regt32=regt32), sigs)
    assert got.dtype == want.dtype == (np.uint32 if regt32 else np.uint64)
    np.testing.assert_array_equal(got, want)
    if not regt32:
        assert np.shares_memory(got, sigs)         # a view, not a copy
        np.testing.assert_array_equal(PCK.f64_to_ordered_u64(sigs),
                                      JCK.f64_to_ordered_u64(sigs))
    sigs[3, 3] = -1.0
    with pytest.raises(ValueError):
        PC._ordered_bits(Dashing2DistOptions(regt32=regt32), sigs)


def test_full_registers_are_not_compressed():
    opts = Dashing2DistOptions(k=31, sketchsize=64)
    sigs = np.random.default_rng(2).random((4, 64))
    assert opts.fd_level == 8.0
    assert PC.make_compressed(opts, sigs, None).data is None
    assert JC.make_compressed(JOptions(k=31, sketchsize=64), sigs,
                              None).data is None


def _sketches(n: int, m: int, seed: int) -> np.ndarray:
    """Mutants of a few ancestors: many distinct gt + lt counts, a few
    empty registers (densified), identical rows."""
    rng = np.random.default_rng(seed)
    anc = rng.exponential(size=(n // 10 + 1, m))
    sigs = anc[np.arange(n) % len(anc)].copy()
    mask = rng.random((n, m)) < rng.uniform(0.0, 0.6, size=(n, 1))
    sigs[mask] = rng.exponential(size=int(mask.sum()))
    sigs[5, ::7] = 0.0
    sigs[n - 1] = sigs[2]
    return sigs


# route -> (n, JAX environment, port SELF_MAX or None)
ROUTES = {
    "mesh": (70, {}, None),                                 # fused
    "single": (70, {"DASHING2_TPU_MULTICHIP": "0"}, None),   # fused
    "numpy": (40, {}, None),                                # n < 64
    "rowblock": (70, {"DASHING2_TPU_SELF_MAX": "0"}, 0),     # N > SELF_MAX
}


@pytest.mark.parametrize("upper_only", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pairwise_blocks_equal_jax_at_m200(route, upper_only, monkeypatch):
    n, env, self_max = ROUTES[route]
    m = 200
    sigs = _sketches(n, m, seed=n)
    names = [f"s{i}" for i in range(n)]
    cards = np.linspace(1e3, 1e5, n)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    if self_max is not None:
        monkeypatch.setattr(PC, "SELF_MAX", self_max)
    ref = JResult(names=list(names), cardinalities=cards.copy(),
                  signatures=sigs.copy())
    want = list(JC.pairwise_matrix(JOptions(k=31, sketchsize=m), ref,
                                   block=32))
    port = SketchingResult(names=list(names), cardinalities=cards.copy(),
                           signatures=sigs.copy())
    got = list(PC.pairwise_matrix(Dashing2DistOptions(k=31, sketchsize=m),
                                  port, block=32, upper_only=upper_only,
                                  device="cpu"))
    assert [s for s, _ in got] == [s for s, _ in want]
    for s, g in got:
        assert g.dtype == np.float32 and g.shape == (min(32, n - s), n)
    full = np.concatenate([w for _, w in want])
    mat = np.concatenate([g for _, g in got])
    iu = np.triu_indices(n, 1)
    np.testing.assert_array_equal(_bits(mat[iu]), _bits(full[iu]))
    if not upper_only:
        np.testing.assert_array_equal(_bits(mat), _bits(full))
    # the route's form shows in the bytes: the other form differs here
    c = np.rint((1.0 - full[iu].astype(np.float64)) * m).astype(np.int64)
    other = PC.sim_table("full", m, 8.0, "cpu",
                         fused=route in ("numpy", "rowblock")).numpy()
    assert (_bits(other[c]) != _bits(full[iu])).any()


def test_ordered_cache_carried_from_reference():
    n, m = 70, 64
    ref = JResult(names=[f"s{i}" for i in range(n)],
                  cardinalities=np.ones(n), signatures=_sketches(n, m, 3))
    list(JC.pairwise_matrix(JOptions(k=31, sketchsize=m), ref))
    key, bits = ref._ordered_cache
    port = from_reference(ref)
    assert port._ordered_cache[0] == key
    np.testing.assert_array_equal(port._ordered_cache[1], bits)
    assert not np.shares_memory(port._ordered_cache[1], bits)
    kind, data = PC._representation(
        Dashing2DistOptions(k=31, sketchsize=m), port,
        PC.CompressedReps(data=None))
    assert kind == "full" and data is port._ordered_cache[1]


def test_routes_outside_the_slice_raise(monkeypatch):
    n, m = 20, 64
    res = SketchingResult(names=[f"s{i}" for i in range(n)],
                          cardinalities=np.ones(n),
                          signatures=_sketches(n, m, 4))
    # m >= 65536 (u16 counts) raises; equality-compared saved k-mers
    # (--save-kmers) run, their ids (densified with the registers)
    # compared as the JAX package compares them; panels run, on every
    # route of n
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        next(PC.pairwise_matrix(Dashing2DistOptions(
            k=31, sketchsize=1 << 16), res, device="cpu"))
    eqfull = Dashing2DistOptions(k=31, sketchsize=m, truncation_method=1)
    ids = np.random.default_rng(5).integers(0, 3, (n, m)).astype(np.uint64)
    kmers = dataclasses.replace(res, signatures=res.signatures.copy(),
                                kmers=ids.copy())
    ref = JResult(names=list(res.names), cardinalities=np.ones(n),
                  signatures=res.signatures.copy(), kmers=ids.copy())
    got = list(PC.pairwise_matrix(eqfull, kmers, device="cpu"))
    want = list(JC.pairwise_matrix(JOptions(k=31, sketchsize=m,
                                            truncation_method=1), ref))
    assert len(got) == len(want)
    for (gs, g), (ws, w) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    monkeypatch.setattr(PC, "SELF_MAX", n - 1)
    nibble = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                                 truncation_method=1)
    panel = dataclasses.replace(res, nq=5)
    start, blk = next(PC.pairwise_matrix(nibble, panel, device="cpu"))
    assert start == 0 and blk.shape == (n - 5, 5)
    next(PC.pairwise_matrix(Dashing2DistOptions(k=31, sketchsize=m), res,
                            device="cpu"))


@pytest.fixture(scope="module", params=[70, 300])
def corpus(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"full_{n}")
    paths = write_corpus(str(d / "fa"), seed=n + 1, n_ancestors=n // 10,
                         n_mutants=10, length=2500)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), len(paths)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_row_block_route_bytes_equal_self_route_and_jax(corpus, fmt,
                                                        tmp_path,
                                                        monkeypatch):
    lst, n = corpus
    argv = FULL + FORMATS[fmt] + ["--batch-size", "64", "-F", lst]
    out = {k: str(tmp_path / k) for k in ("self", "rows", "jax1", "jax")}
    assert cli.main(argv + ["--cmpout", out["self"], "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", out["jax1"]]) == 0
    calls, counts = [], PC.int_counts

    def spy(a, b):
        calls.append((a.shape[0], b.shape[0]))
        return counts(a, b)
    monkeypatch.setattr(PC, "int_counts", spy)
    monkeypatch.setattr(PC, "SELF_MAX", 0)
    assert cli.main(argv + ["--cmpout", out["rows"], "--device", "cpu"]) == 0
    # one launch per 64-row block, each against the rows from its start on
    assert calls == [(min(64, n - s), n - s) for s in range(0, n, 64)]
    monkeypatch.setenv("DASHING2_TPU_SELF_MAX", "0")
    assert jax_cli.main(argv + ["--cmpout", out["jax"]]) == 0
    got = _read(out["rows"])
    assert got == _read(out["self"]) == _read(out["jax1"])
    assert got == _read(out["jax"])
    if fmt == "binary":
        vals = np.frombuffer(got, np.float32)
        assert vals.size == n * (n - 1) // 2 and np.isfinite(vals).all()
        assert vals.max() > 0.5


def test_f32_registers_bytes_equal_jax(corpus, tmp_path):
    lst, n = corpus
    argv = FULL + ["--f32-registers", "--binary-output", "-F", lst]
    p, j, f64 = (str(tmp_path / k) for k in ("port", "jax", "f64"))
    assert cli.main(argv + ["--cmpout", p, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--cmpout", j]) == 0
    assert _read(p) == _read(j)
    assert len(_read(p)) == 4 * n * (n - 1) // 2


def test_full_registers_from_reference_equal_jax(corpus, monkeypatch):
    """The JAX package's sketches through from_reference: the port's
    ordered registers and blocks equal the JAX package's."""
    lst, _ = corpus
    with open(lst) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    kw = dict(k=31, sketchsize=256)
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    ref = jax_sketch_fastx(JOptions(**kw), paths)
    port_res = from_reference(ref)
    got = list(PC.pairwise_matrix(Dashing2DistOptions(**kw), port_res,
                                  block=64, device="cpu"))
    want = list(JC.pairwise_matrix(JOptions(**kw), ref, block=64))
    np.testing.assert_array_equal(port_res._ordered_cache[1],
                                  ref._ordered_cache[1])
    for (s, g), (t, w) in zip(got, want):
        assert s == t
        np.testing.assert_array_equal(_bits(g), _bits(w))
