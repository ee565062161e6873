"""Port parity for FullSetSketch sketching, on the CPU.

* The hash chain (dashing2_tpu_torch/ops/hashes.py, torch int64) against
  dashing2_tpu/ops/hashes.py (jnp uint64) bit for bit, over seeded u64
  values with u64 values >= 2^63, 0, 2^64 - 1 and the u64 -> f64
  rounding ties. Tolerance zero.
* CSetSketch registers (ops/sketch_kernels.py::css_sketch_many) against
  the JAX `css_sketch`, mirroring tests/test_sketch_kernels.py:143-190:
  the brute-force minimum, duplicated input, an empty item, an input
  built to need several passes, m not a power of two, a 20k-item set at
  m = 1024. The passes equal the JAX loop's; the registers are within
  CSS_ULP ulp (XLA's CPU f64 log, the C library's, differs from the
  port's own, ops/fixedmath.py::log64, by an ulp in about 6% of
  values; the histogram is printed),
  the cardinalities within CARD_ULP ulp, and the order of registers
  across items (their gt/lt counts) equal exactly.
* The counting route's hashes and counts equal the JAX route's, with
  and without `-m 2`.
* CLI bytes against the JAX CLI at n = 20 (its numpy route) and n = 70
  (its jitted route): `--full-setsketch` with every measure (POISSON_LLR
  on the jitted route within 3 ulp, README "Documented deviations"),
  `--bbit-sigs`, `--fastcmp-bytes/-shorts/-words`, `--setsketch-ab
  0.02,1.06` with `--fastcmp 0.5` and `1`, and `--topk` over the
  quantised sketches; the quantised `-o` files byte for byte, the f64
  ones within CSS_ULP ulp (registers) and CARD_ULP ulp (cardinalities).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu import hashing as JH
from dashing2_tpu import native as JN
from dashing2_tpu.cmp import core as JC
from dashing2_tpu.cmp import estimators as JE
from dashing2_tpu.config import Dashing2DistOptions as JDist
from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.enums import Measure as JMeasure
from dashing2_tpu.io import fastx as jfastx
from dashing2_tpu.ops import hashes as JDH
from dashing2_tpu.ops import sketch_kernels as JSK
from dashing2_tpu.sketch import core as JCORE
from dashing2_tpu_torch import cli
from dashing2_tpu_torch import hashing as PH
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.cmp import estimators as PE
from dashing2_tpu_torch.config import Dashing2DistOptions, Dashing2Options
from dashing2_tpu_torch.enums import KmerSketchResultType, Measure
from dashing2_tpu_torch.io import formats
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.native import load_oph_lib
from dashing2_tpu_torch.ops import hashes as DH
from dashing2_tpu_torch.ops import sketch_kernels as SK
from dashing2_tpu_torch.ops.fixedmath import log64
from dashing2_tpu_torch.result import from_reference
from dashing2_tpu_torch.sketch import core as PCORE

# registers: x1 - log(u), x1 itself from a log; each of XLA's two logs may
# be an ulp from the port's
CSS_ULP = 4
# m / sum(registers)
CARD_ULP = 4
POISSON_ULP = 3


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a.view(np.int64) - b.view(np.int64))
    return np.where(a == b, 0, d)


def _u64_inputs() -> np.ndarray:
    x = np.random.default_rng(7).integers(0, 1 << 64, 4096, dtype=np.uint64)
    x[:10] = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
              (1 << 63) + (1 << 10),          # a tie: rounds down to 2^63
              (1 << 63) + (3 << 10),          # a tie: rounds up
              (1 << 63) + (1 << 10) + 1, (1 << 53) + 1, (1 << 62) + 1]
    return x


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64) if t.dtype == torch.int64 \
        else t.numpy()


HASHES = {
    "wanghash": (DH.wanghash, JDH.wanghash),
    "wanghash_": (lambda t: DH.wanghash_(t.clone()), JDH.wanghash),
    "cehasher": (DH.cehasher, JDH.cehasher),
    "css_item_hash": (DH.css_item_hash, JDH.css_item_hash),
    "mulhi_u64": (lambda t: DH.mulhi_u64(t, JH.WY_M2),
                  lambda x: JDH.mulhi_u64(
                      x, jnp.full(x.shape, JH.WY_M2, jnp.uint64))),
    "wyhash64_step": (lambda t: DH.wyhash64_step(t)[1],
                      lambda x: JDH.wyhash64_step(x)[1]),
    "wyhash64_seed": (lambda t: DH.wyhash64_step(t)[0],
                      lambda x: JDH.wyhash64_step(x)[0]),
    "u64_to_unit_float": (DH.u64_to_unit_float, JDH.u64_to_unit_float),
    "u64_mod_1000": (lambda t: DH.u64_mod(t, 1000),
                     lambda x: x % jnp.uint64(1000)),
    "u64_mod_1024": (lambda t: DH.u64_mod(t, 1024),
                     lambda x: x % jnp.uint64(1024)),
}


@pytest.mark.parametrize("name", sorted(HASHES))
def test_hash_chain_equals_jax(name):
    port, ref = HASHES[name]
    x = _u64_inputs()
    got = _np(port(_torch(x)))
    want = np.asarray(ref(jnp.asarray(x)))
    if want.dtype != np.float64:
        want = want.astype(np.uint64)
        got = got.astype(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_unit_float_rounds_ties_to_even():
    x = np.array([(1 << 63) + (1 << 10), (1 << 63) + (3 << 10)], np.uint64)
    got = DH.u64_to_unit_float(_torch(x)).numpy()
    assert got[0] == 0.5 and got[1] == (2.0 ** 63 + 2.0 ** 12) * 2.0 ** -64
    np.testing.assert_array_equal(got, x.astype(np.float64) * 2.0 ** -64)


def _passes_of_jax(monkeypatch, hashed, m):
    calls = []
    real = JSK._css_pass

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(JSK, "_css_pass", counted)
    regs = JSK.css_sketch(hashed, np.ones(len(hashed), bool), m)
    monkeypatch.setattr(JSK, "_css_pass", real)
    return np.asarray(regs), len(calls)


def _several_passes_input(n: int, m: int) -> np.ndarray:
    """Hashes whose CSetSketch RNG values put 3 items below the first
    threshold (log(m) + 8) / n and the rest just above it: the first
    pass keeps 3 rows, leaving most registers above its cutoff."""
    t = (np.log(m) + 8.0) / n
    rng = np.random.default_rng(n + m)
    x1 = np.concatenate([rng.uniform(0.001, 0.01, 3) * t,
                         rng.uniform(1.2, 3.0, n - 3) * t])
    rv = (np.exp(-x1 * m) * 2.0 ** 64).astype(np.uint64)
    return PH.cehasher_inverse(rv) ^ np.uint64(PH.CSS_XOR)


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, n,
                                                dtype=np.uint64)


CSS_CASES = {
    "brute-m64": (64, lambda: _rand(3000, 11)),
    "duplicates-m32": (32, lambda: np.concatenate(
        [_rand(500, 13), _rand(500, 13), _rand(500, 13)[:100]])),
    "several-passes-m64": (64, lambda: _several_passes_input(400, 64)),
    "m100": (100, lambda: _rand(700, 5)),
    "m1024-20k": (1024, lambda: _rand(20000, 3)),
    "one-item": (30, lambda: _rand(1, 9)),
}


@pytest.mark.parametrize("case", sorted(CSS_CASES))
def test_css_registers_equal_jax(case, monkeypatch):
    m, make = CSS_CASES[case]
    hashed = make()
    want, jax_passes = _passes_of_jax(monkeypatch, hashed, m)
    got, passes = SK.css_sketch_many([hashed], m, "cpu")
    got = got[0]
    assert passes[0] == jax_passes
    if case.startswith("several"):
        assert jax_passes >= 2
    ulp = _ulps(got, want)
    print(f"{case}: {jax_passes} passes; register ulp histogram "
          f"{np.bincount(ulp).tolist()}")
    assert ulp.max() <= CSS_ULP
    assert _ulps(SK.css_cardinality(got), JSK.css_cardinality(want)) \
        <= CARD_ULP
    if case == "brute-m64":
        # the brute-force minimum over every item's draws, the JAX
        # test's construction, with the port's f64 log
        def log(v):
            return log64(torch.from_numpy(v)).numpy()
        rv = PH.css_item_hash(hashed)
        u1 = rv.astype(np.float64) * 2.0 ** -64
        x1 = -log(u1) * (1.0 / m)
        _, draw = PH.wyhash64_step(rv)
        idx0 = (draw % np.uint64(m)).astype(np.int64)
        j = np.arange(m, dtype=np.uint64) * np.uint64(SK._GOLD)
        full = np.empty((len(hashed), m))
        for d in range(len(hashed)):
            u = PH.wanghash(rv[d] ^ j).astype(np.float64) * 2.0 ** -64
            full[d] = x1[d] - log(u)
            full[d, idx0[d]] = x1[d]
        np.testing.assert_array_equal(got, full.min(axis=0))
    if case.startswith("duplicates"):
        uniq = np.unique(hashed)
        np.testing.assert_array_equal(
            SK.css_sketch_many([uniq], m, "cpu")[0][0], got)


def test_css_batches_keep_each_items_own_passes(monkeypatch):
    """Items of one batch keep their own threshold, cap and passes: the
    several-passes item beside ordinary ones, an empty item, and a tiny
    budget (one item a pass) give the registers of one-item calls;
    thousands of tiny items share a batch."""
    m = 64
    items = [_rand(300, 1), _several_passes_input(400, m),
             np.zeros(0, np.uint64), _rand(5, 2), _rand(2000, 4)]
    regs, passes = SK.css_sketch_many(items, m, "cpu")
    small, small_p = SK.css_sketch_many(items, m, "cpu", budget=1)
    np.testing.assert_array_equal(regs, small)
    np.testing.assert_array_equal(passes, small_p)
    assert passes.tolist()[2] == 0 and np.isinf(regs[2]).all()
    assert passes[1] >= 2 and passes[0] == passes[3] == passes[4] == 1
    for i in (0, 1, 3, 4):
        one, p = SK.css_sketch_many([items[i]], m, "cpu")
        np.testing.assert_array_equal(one[0], regs[i])
        assert p[0] == passes[i]
        want, jp = _passes_of_jax(monkeypatch, items[i], m)
        assert jp == passes[i]
        assert _ulps(regs[i], want).max() <= CSS_ULP
    tiny = [_rand(3, s) for s in range(3000)]
    got, p = SK.css_sketch_many(tiny, m, "cpu")
    assert (p == 1).all()
    np.testing.assert_array_equal(got[17], SK.css_sketch_many(
        [tiny[17]], m, "cpu")[0][0])
    # equal registers across items are equal in both packages: the same
    # k-mer wins, by the same arithmetic
    a, b = _rand(3000, 8), _rand(3000, 8)[:2000]
    got = SK.css_sketch_many([a, b], m, "cpu")[0]
    want = [_passes_of_jax(monkeypatch, x, m)[0] for x in (a, b)]
    np.testing.assert_array_equal(got[0] == got[1], want[0] == want[1])
    np.testing.assert_array_equal(got[0] > got[1], want[0] > want[1])


@pytest.fixture(scope="module")
def joint_groups(tmp_path_factory):
    """Items of two or three files each, sharing files, so that k-mers
    occur more than once in an item (what -m 2 keeps)."""
    d = tmp_path_factory.mktemp("fss_joint")
    p = write_corpus(str(d / "fa"), seed=31, n_ancestors=2, n_mutants=5,
                     length=2500)
    return [f"{p[0]} {p[1]}", f"{p[0]} {p[2]} {p[3]}", f"{p[4]} {p[5]}",
            p[6], f"{p[7]} {p[8]} {p[9]}"]


@pytest.mark.parametrize("threshold", [0.0, 2.0])
def test_counting_route_equals_jax(joint_groups, threshold):
    kw = dict(k=21, sketchsize=64, count_threshold=threshold,
              kmer_result=KmerSketchResultType.FULL_SETSKETCH)
    opts = Dashing2Options(**kw)
    got = PCORE._count_stream(opts, joint_groups)
    jopts = JOptions(**kw)
    hkw = JCORE._hash_kwargs(jopts, 1 << 15)
    lib, plib = JN.load_oph_lib(), load_oph_lib()
    for g, (u, cnt) in zip(joint_groups, got):
        codes = [c for path in g.split()
                 for _, c in jfastx.read_encoded(path, jopts.alphabet)]
        hv = JCORE._native_hash_codes_list(lib, codes, hkw)
        np.testing.assert_array_equal(PCORE._native_hash_codes_list(
            plib, codes, PCORE._hash_kwargs(opts, 1 << 15)), hv)
        w, c = np.unique(hv, return_counts=True)
        if threshold > 1:
            w, c = w[c >= threshold], c[c >= threshold]
        np.testing.assert_array_equal(u, w)
        np.testing.assert_array_equal(cnt, c.astype(np.float64))
    if threshold > 1:
        assert 0 < sum(len(u) for u, _ in got) < sum(
            len(np.unique(x)) for x, _ in PCORE._count_stream(
                Dashing2Options(**dict(kw, count_threshold=0.0)),
                joint_groups))
    # the whole route: registers and cardinalities against the JAX route
    p = PCORE.sketch_fastx(opts, joint_groups, device="cpu")
    j = JCORE.sketch_fastx(jopts, joint_groups)
    assert _ulps(p.signatures, j.signatures).max() <= CSS_ULP
    assert _ulps(p.cardinalities, j.cardinalities).max() <= CARD_ULP
    assert (p.cardinalities == 0).sum() == (j.cardinalities == 0).sum()


@pytest.fixture(scope="module", params=[20, 70])
def corpus(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"fss_{n}")
    paths = write_corpus(str(d / "fa"), seed=n + 3, n_ancestors=n // 10,
                         n_mutants=10, length=2500)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path, monkeypatch, env=()):
    """The port's bytes (--device cpu) and the JAX CLI's, one device."""
    out_p, out_j = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + ["--cmpout", out_p, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    for key, val in env:
        monkeypatch.setenv(key, val)
    assert jax_cli.main(argv + ["--cmpout", out_j]) == 0
    return _read(out_p), _read(out_j)


MEASURE_FLAGS = {"similarity": [], "mash": ["--mash-distance"],
                 "containment": ["--containment"],
                 "symcontain": ["--symmetric-containment"],
                 "intersection": ["--intersection"],
                 "union": ["--union-size"]}


@pytest.mark.parametrize("measure", sorted(MEASURE_FLAGS))
def test_full_setsketch_cli_bytes_equal_jax(corpus, measure, tmp_path,
                                            monkeypatch):
    lst, paths = corpus
    n = len(paths)
    argv = ["sketch", "-k", "31", "-S", "256", "--full-setsketch",
            "--binary-output", "-F", lst] + MEASURE_FLAGS[measure]
    got, want = _both(argv, tmp_path, monkeypatch)
    assert len(got) == 4 * n * (n - 1) // 2
    if measure == "mash" and n >= 64:
        g, w = np.frombuffer(got, np.float32), np.frombuffer(want, np.float32)
        d = np.abs(g.view(np.int32).astype(np.int64)
                   - w.view(np.int32).astype(np.int64))
        assert d.max() <= POISSON_ULP
    else:
        assert got == want


FLAG_SETS = {
    "full-bbit": ["--full-setsketch", "--bbit-sigs"],
    "bytes": ["--full-setsketch", "--fastcmp-bytes"],
    "shorts": ["--full-setsketch", "--fastcmp-shorts", "--containment"],
    "words": ["--full-setsketch", "--fastcmp-words"],
    "ab-u8": ["--full-setsketch", "--setsketch-ab", "0.02,1.06",
              "--fastcmp", "1"],
    "ab-nibble": ["--full-setsketch", "--setsketch-ab", "0.02,1.06",
                  "--fastcmp", "0.5", "--union-size"],
    "ab-u8-bbit": ["--full-setsketch", "--setsketch-ab", "0.02,1.06",
                   "--fastcmp", "1", "--bbit-sigs"],
    "m2-phylip": ["-m", "2", "--phylip"],
}


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_compressed_cli_bytes_equal_jax(corpus, flags, tmp_path,
                                        monkeypatch):
    lst, paths = corpus
    argv = ["sketch", "-k", "31", "-S", "256", "-F", lst] + FLAG_SETS[flags]
    if "--phylip" not in argv:
        argv.append("--binary-output")
    got, want = _both(argv, tmp_path, monkeypatch)
    assert got == want and len(got) > 0


@pytest.mark.parametrize("flags", [["--fastcmp-bytes"],
                                   ["--setsketch-ab", "0.02,1.06",
                                    "--fastcmp", "2"]])
def test_topk_over_quantised_sketches_equal_jax(corpus, flags, tmp_path,
                                                monkeypatch):
    lst, paths = corpus
    argv = ["sketch", "-k", "31", "-S", "256", "--full-setsketch",
            "--topk", "5", "--binary-output", "-F", lst] + flags
    got, want = _both(argv, tmp_path, monkeypatch)
    indptr, _, _ = formats.read_knn_csr(str(tmp_path / "port.out"))
    assert len(indptr) == len(paths) + 1
    assert got == want


@pytest.mark.parametrize("flags", [[], ["--fastcmp-bytes"],
                                   ["--fastcmp-words"]])
def test_sketch_outfile_equals_jax(corpus, flags, tmp_path):
    """`-o`: the quantised registers and cardinalities byte for byte;
    the f64 registers within CSS_ULP ulp and their cardinalities within
    CARD_ULP (README "Documented deviations"), with the histograms."""
    lst, _ = corpus
    argv = ["sketch", "-k", "31", "-S", "256", "--full-setsketch", "-F",
            lst] + flags
    p, j = str(tmp_path / "port.sig"), str(tmp_path / "jax.sig")
    assert cli.main(argv + ["-o", p, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["-o", j]) == 0
    pc, ps = formats.read_stacked_signatures(p)
    jc, js = formats.read_stacked_signatures(j)
    if flags:
        assert _read(p) == _read(j)
        assert _read(p + ".names.txt") == _read(j + ".names.txt")
        return
    ulp, cu = _ulps(ps, js), _ulps(pc, jc)
    print(f"-o registers ulp histogram {np.bincount(ulp.ravel()).tolist()}; "
          f"cardinalities {np.bincount(cu).tolist()}")
    assert ulp.max() <= CSS_ULP and cu.max() <= CARD_ULP
    assert ((ps == 0) == (js == 0)).all()


U64_MEASURES = ["SIMILARITY", "INTERSECTION", "UNION_SIZE", "CONTAINMENT",
                "SYMMETRIC_CONTAINMENT", "POISSON_LLR"]


@pytest.mark.parametrize("m", [64, 100, 1000])
@pytest.mark.parametrize("msr", U64_MEASURES)
def test_u64_ab_estimator_equals_jax_routes(msr, m):
    """The a/b estimator of u64 registers (--setsketch-ab without
    --fastcmp: fd 8, no g_b) over every (gt, lt) with gt + lt <= m,
    against the JAX numpy route bit for bit and its jitted
    `_tiled_epilogue` bit for bit (POISSON_LLR within POISSON_ULP);
    m = 100 and 1000 are where the jitted SIMILARITY's contraction of
    1 - ab shows."""
    step = 1 if m <= 100 else 7
    c = np.arange(0, m + 1, step, dtype=np.int32)
    gt = np.repeat(c[:, None], len(c), 1)
    lt = np.minimum(np.repeat(c[None], len(c), 0), m - gt)
    rng = np.random.default_rng(m)
    lh = rng.uniform(1.0, 1e6, len(c))
    rh = rng.uniform(1.0, 1e6, len(c))
    rh[:5] = lh[:5]
    b = 1.06
    jm = JMeasure[msr]
    numpy_route = JE.compressed_ab_measures32(gt, lt, m, b, 8.0,
                                              lh[:, None], rh[None], jm, 31,
                                              gb_form="complement")
    gbt, gbinv = JC._gb_args(b, m)
    jitted = np.asarray(jax.jit(lambda x, y, p, q: JC._tiled_epilogue(
        "ab", m, jm, 31, 8.0, x, y, p, q, b, (gbt, gbinv)))(
            jnp.asarray(gt), jnp.asarray(lt), jnp.asarray(lh),
            jnp.asarray(rh)))
    table, ginv = PC._gb_args(b, m)
    x = torch.from_numpy(lh.astype(np.float32))[:, None]
    y = torch.from_numpy(rh.astype(np.float32))[None, :]
    for fused, want in ((False, numpy_route), (True, jitted)):
        got = PE.compressed_ab_measures32(
            torch.from_numpy(gt), torch.from_numpy(lt), m, b, 8.0,
            Measure[msr], table, ginv, fused, "complement", x, y).numpy()
        g, w = got.view(np.int32), np.asarray(want, np.float32).view(
            np.int32)
        if fused and msr == "POISSON_LLR":
            assert np.abs(g.astype(np.int64) - w).max() <= POISSON_ULP
        else:
            np.testing.assert_array_equal(g, w)


def test_u64_ab_cli_bytes_equal_jax(corpus, tmp_path, monkeypatch):
    """--setsketch-ab without --fastcmp quantises to u64 (compared on
    gtlt.cu), at m = 100: the JAX CLI's bytes, and the `-o` registers."""
    lst, _ = corpus
    argv = ["sketch", "-k", "31", "-S", "100", "--full-setsketch",
            "--setsketch-ab", "0.02,1.06", "--binary-output", "-F", lst]
    got, want = _both(argv, tmp_path, monkeypatch)
    assert got == want
    p, j = str(tmp_path / "port.sig"), str(tmp_path / "jax.sig")
    assert cli.main(argv + ["-o", p, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["-o", j]) == 0
    assert _read(p) == _read(j) and os.path.getsize(p) > 0


@pytest.mark.parametrize("fd", [8.0, 1.0, 2.0])
def test_pairwise_blocks_from_jax_sketches_equal_jax(corpus, fd,
                                                     monkeypatch):
    """The JAX package's FullSetSketch results (f64 registers, or u8/u16
    a/b registers) through `from_reference` into the port's
    `pairwise_matrix`: the JAX function's blocks, bit for bit."""
    _, paths = corpus
    ab = {1.0: (20.0, 1.2), 2.0: (0.06, 1.0005)}.get(fd, (-1.0, -1.0))
    kw = dict(k=31, sketchsize=128, fd_level=fd, compressed_a=ab[0],
              compressed_b=ab[1],
              kmer_result=KmerSketchResultType.FULL_SETSKETCH)
    ref = JCORE.sketch_fastx(JOptions(**kw), paths)
    port = from_reference(ref)
    assert port.signatures.dtype == ref.signatures.dtype
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    got = list(PC.pairwise_matrix(Dashing2DistOptions(**kw), port,
                                  block=64, device="cpu"))
    want = list(JC.pairwise_matrix(JDist(**kw), ref, block=64))
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_xla_f64_log_differs_by_an_ulp():
    """Why the registers carry an ulp bound: XLA's CPU f64 log (the C
    library's) and the port's own (ops/fixedmath.py::log64, which the
    CSetSketch draws take because torch's CPU log is not the same
    function in every process) differ by an ulp on a small share of
    values; never by more. Normal inputs: the draws clamp at 1e-300."""
    rng = np.random.default_rng(1)
    u = np.concatenate([rng.random(1 << 20) * 0.999 + 1e-12,
                        np.exp(rng.uniform(-690, 700, 1 << 18))])
    xla = np.asarray(jax.jit(jnp.log)(jnp.asarray(u)))
    port = log64(torch.from_numpy(u)).numpy()
    ulp = _ulps(port, xla)
    print(f"XLA f64 log vs the port's: {100 * (ulp > 0).mean():.2f}% of "
          f"{len(u)} values differ; ulp histogram {np.bincount(ulp).tolist()}")
    assert ulp.max() <= 1
