"""Port parity for the weighted sketches (-B/--multiset, -P/--prob), on the
CPU, against the JAX package run in the same process.

* The port's f32 log and exp (ops/fixedmath.py) against jnp.log and
  jnp.exp under jax.jit, bit for bit, over 10^7 values of the draws'
  operand ranges: unit32 values in (0, 1], log-uniform values in
  [1e-30, 1], the -(log u3 + log u4) range, and -lnw32 for weights 1 to
  2^40 and probabilities down to 1e-12.
* The draw math (`_icws_rt`, both kinds) against the JAX `_icws_rt`
  under jax.jit, keys and sample values bit for bit, weights 1 to 10^6
  and CountSketch bucket weights; and the contraction XLA makes in the
  ICWS key.
* Whole streams (`_sketch_many_streams`, streams longer than the 2048
  rows, with duplicated hashes across rows, and planted -0.0/+0.0 keys)
  against the JAX engine: registers, winners and cardinalities equal.
* The CLI's bytes against dashing2_tpu.cli: -B and -P with SIMILARITY
  and other measures, -c 4096, -Q, --topk, -o, --fastcmp.

The goldens multiset.bin and prob.bin are held in test_torch_golden.py;
the CUDA kernel against its plain version in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.sketch import weighted as JW
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import SketchSpace
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.ops import fixedmath as FM
from dashing2_tpu_torch.ops import weighted_draws as WD
from dashing2_tpu_torch.sketch import core as PCORE
from dashing2_tpu_torch.sketch import weighted as PW

_RANGE_N = 2_500_000


def _u64(rng, n):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


def _operands(name: str) -> np.ndarray:
    """2.5M f32 values of one operand range of the draws."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "unit32":
        # u64 -> f64 -> f32 as the draws round it, clamped at 1e-30
        u = (_u64(rng, _RANGE_N).astype(np.float64) * 2.0 ** -64)
        return np.maximum(u.astype(np.float32), np.float32(1e-30))
    if name == "log-uniform":
        return np.exp(rng.uniform(np.log(1e-30), 0.0, _RANGE_N)) \
            .astype(np.float32)
    if name == "gamma2":
        # -(log u3 + log u4), the operand of lnc's log
        u = rng.uniform(1e-30, 1.0, (2, _RANGE_N))
        return (-(np.log(u[0]) + np.log(u[1]))).astype(np.float32)
    # -lnw32 for weights 1 .. 2^40 (exp's operand is <= 0 for -B counts)
    # and probabilities down to 1e-12 (-P: exp(-log p) >= 1)
    w = np.exp(rng.uniform(0.0, 40 * np.log(2.0), _RANGE_N // 2))
    p = np.exp(rng.uniform(np.log(1e-12), 0.0, _RANGE_N // 2))
    return np.concatenate([-np.log(w), -np.log(p)]).astype(np.float32)


@pytest.mark.parametrize("name", ["unit32", "log-uniform", "gamma2",
                                  "neg-lnw"])
def test_f32_log_and_exp_equal_xla(name):
    x = _operands(name)
    t = torch.from_numpy(x)
    if name != "neg-lnw":
        want = np.asarray(jax.jit(jnp.log)(x))
        got = FM.log32(t).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = FM.exp32(t).numpy()
    if name == "neg-lnw":
        assert (want >= 1.0).sum() == len(x) // 2
    # XLA flushes subnormal results to zero; the draws never make one
    normal = np.abs(want) >= np.finfo(np.float32).tiny
    assert normal[-(len(x) // 2):].all()
    np.testing.assert_array_equal(got[normal].view(np.uint32),
                                  want[normal].view(np.uint32))


def test_f32_log_special_values():
    x = np.array([0.0, -0.0, -1.0, np.inf, np.nan, 1.0,
                  np.finfo(np.float32).tiny, np.finfo(np.float32).max],
                 np.float32)
    got = FM.log32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


def test_fma32_rounds_once_where_the_f64_sum_is_an_f32_tie():
    """fma32 where the f64 sum a*b + c lands exactly on an f32 midpoint
    (or below the f32 normals): the exact sum's f32, by rational
    arithmetic, not the f64 sum's tie-to-even."""
    from fractions import Fraction
    u = 2.0 ** -23
    a = np.array([-(2.0 ** -12) * (1 - u), 2.0 ** -12 * (1 - u), 2.0 ** -12,
                  3e-30, 1.5, -(2.0 ** -80)], np.float32)
    b = np.array([2.0 ** -12 * (1 + u), 2.0 ** -12 * (1 + u), 2.0 ** -13,
                  3e-10, 2.0 ** -140, 2.0 ** -70], np.float32)
    c = np.array([1 + u, 1.0, 1.0, 1e-38, 0.0, 2.0 ** -149], np.float32)
    got = FM.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        near = sorted((np.nextafter(lo, np.float32(-np.inf)), lo,
                       np.nextafter(lo, np.float32(np.inf))),
                      key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.uint32)) & 1))
        assert g == near[0], (x, y, z)
    # the first: 1 + 2^-24 + 2^-70 rounds up, its f64 sum (a tie) to even
    assert got[0] == np.float32(1 + u)


def _draw_operands(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    h = _u64(rng, n)
    reg = rng.integers(0, 1024, n).astype(np.uint64)
    j = reg * np.uint64(JW._GOLD)
    counts = np.concatenate([rng.integers(1, 10 ** 6 + 1, n // 2),
                             rng.integers(1, 40, n - n // 2)])
    c = counts.astype(np.float64)
    if kind == "pmh":
        c = c / c.sum()
    return h, np.log(c), j


@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_draws_equal_jax(kind):
    h, lnw, j = _draw_operands(kind, 200_000, 11)
    fn = jax.jit(lambda h, w, j: JW._icws_rt(kind, h, w, j, 1024))
    jk, jv = (np.asarray(a) for a in fn(jnp.asarray(h), jnp.asarray(lnw),
                                         jnp.asarray(j)))
    th = torch.from_numpy(h.view(np.int64))
    tj = torch.from_numpy(j.view(np.int64))
    tw = torch.from_numpy(lnw.astype(np.float32))
    key, t = WD._icws_rt(kind, th, tw, tj)
    val = WD._sval(kind, th, t)
    np.testing.assert_array_equal(key.numpy().view(np.uint32),
                                  jk.view(np.uint32))
    np.testing.assert_array_equal(val.numpy().view(np.uint32),
                                  jv.view(np.uint32))
    if kind == "icws":
        # XLA contracts r * (t - beta) into the subtraction from lnc: the
        # two rounded operations give other keys
        def unit(salt):
            return WD._unit32(WD.DH.wanghash(th ^ (tj + WD.DH.s64(salt)))
                              ).clamp_(min=WD._TINY)
        r = -(FM.log32(unit(WD._S1)) + FM.log32(unit(WD._S2)))
        lnc = FM.log32(-(FM.log32(unit(WD._S3)) + FM.log32(unit(WD._S4))))
        beta = WD._unit32(WD.DH.wanghash(th ^ (tj + WD.DH.s64(WD._S5))))
        rounded = (lnc - r * (t - beta)) - r
        assert (rounded != key).any()


def _streams(seed: int):
    """Items with streams of 0, 1, 2047, 2048, 2049 and 5000 positions;
    the last repeats a hash and its count 2048 positions later, so that
    two rows draw equal keys."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 2047, 2048, 2049, 5000]
    streams = [_u64(rng, n) for n in lens]
    counts = [rng.integers(1, 10 ** 6 + 1, n).astype(np.float64)
              for n in lens]
    streams[-1][2100] = streams[-1][10]
    counts[-1][2100] = counts[-1][10]
    return streams, counts


@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_streams_equal_jax(kind):
    streams, counts = _streams(5)
    m = 8
    lnws = JW._lnw_many(kind, streams, counts)
    np.testing.assert_array_equal(
        np.concatenate(PW._lnw_many(kind, streams, counts)),
        np.concatenate(lnws))
    want, want_ids = JW._sketch_many_streams(kind, streams, lnws, m)
    got, ids = PW._sketch_many_streams(kind, streams, lnws, m, "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ids, want_ids)
    assert (got[0] == 0).all() and (got[1:] > 0).all()
    many = JW.bagminhash_many if kind == "icws" else JW.probminhash_many
    pmany = PW.bagminhash_many if kind == "icws" else PW.probminhash_many
    sig, card = pmany(streams, counts, m, device="cpu")
    jsig, jcard = many(streams, counts, m)
    np.testing.assert_array_equal(sig, jsig)
    np.testing.assert_array_equal(card, jcard)
    # batching items into launches changes nothing
    small, small_ids = PW._sketch_many_streams(kind, streams, lnws, m, "cpu",
                                               budget=3000)
    np.testing.assert_array_equal(small, want)
    np.testing.assert_array_equal(small_ids, want_ids)


def test_signed_zero_keys_follow_the_row_rule(monkeypatch):
    """Planted keys: inside a row the order-preserving bits decide (-0.0
    before +0.0, then the first position); across rows f32 `<` decides,
    so an earlier row keeps a +0.0 against a later -0.0, and equal keys
    go to the earlier row. The same planted key function in both
    packages' draw math."""
    n, m = 6000, 5
    h = np.arange(n, dtype=np.uint64)
    # register -> [(position, key)]: 0: +0.0 at 100, -0.0 at 7 (one row);
    # 1: +0.0 at 7, -0.0 at 2100 (earlier row keeps +0.0); 2: 0.5 at 3,
    # 0.5 at 2200 (earlier row); 3: -0.0 at 4200, -0.0 at 4100 (first
    # position); 4: +0.0 at 50, -0.0 at 4199 and 4200
    table = np.ones((n, m), np.float32)
    table[100, 0], table[7, 0] = 0.0, -0.0
    table[7, 1], table[2100, 1] = 0.0, -0.0
    table[3, 2], table[2200, 2] = 0.5, 0.5
    table[4200, 3], table[4100, 3] = -0.0, -0.0
    table[50, 4], table[4199, 4], table[4200, 4] = 0.0, -0.0, -0.0
    jt = jnp.asarray(table)
    gold = int(JW._GOLD)

    def jax_rt(kind, hh, w, j, mm):
        reg = (j * jnp.uint64(pow(gold, -1, 1 << 64))).astype(jnp.int64)
        key = jt[hh.astype(jnp.int64), reg]
        return key, jnp.zeros_like(key)

    def port_rt(kind, hh, w, j):
        reg = j * WD.DH.s64(pow(gold, -1, 1 << 64))
        return torch.from_numpy(table)[hh, reg], None

    monkeypatch.setattr(JW, "_icws_rt", jax_rt)
    monkeypatch.setattr(WD, "_icws_rt", port_rt)
    lnw = [np.zeros(n)]
    _, want = JW._sketch_many_streams("pmh", [h], lnw, m)
    _, got = PW._sketch_many_streams("pmh", [h], lnw, m, "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [7, 7, 3, 4100, 50])


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("weighted")
    paths = write_corpus(str(d / "fa"), seed=41, n_ancestors=3,
                         n_mutants=7, length=2000)
    lst = d / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    refs = d / "refs.txt"
    refs.write_text("\n".join(paths[4:]) + "\n")
    queries = d / "queries.txt"
    queries.write_text("\n".join(paths[:4]) + "\n")
    return str(lst), str(refs), str(queries), paths


def _read(path):
    with open(path, "rb") as f:
        return f.read()


WEIGHTED_JOBS = {
    "B": ["-B"],
    "B-containment": ["-B", "--containment"],
    "B-c4096": ["-B", "-c", "4096", "--mash-distance"],
    "B-fastcmp1": ["-B", "--fastcmp", "1"],
    "B-bbit": ["-B", "--fastcmp", "2", "--bbit-sigs", "--union-size"],
    "P": ["-P"],
    "P-intersection": ["-P", "--intersection"],
    "P-c4096": ["-P", "-c", "4096"],
    "P-m2": ["-P", "-m", "2", "--symmetric-containment"],
    "P-square": ["-P", "--asymmetric-all-pairs"],
    "B-topk": ["-B", "--topk", "4"],
    "P-topk": ["-P", "--topk", "4"],
    "P-threshold": ["-P", "-T", "0.05"],
    "B-greedy": ["-B", "--greedy", "0.2"],
}


@pytest.mark.parametrize("job", sorted(WEIGHTED_JOBS))
def test_weighted_cli_bytes_equal_jax(corpus, job, tmp_path, monkeypatch):
    lst, _, _, paths = corpus
    argv = ["sketch", "-k", "21", "-S", "16", "--binary-output", "-F",
            lst] + WEIGHTED_JOBS[job]
    out_p, out_j = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + ["--cmpout", out_p, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", out_j]) == 0
    got = _read(out_p)
    assert len(got) > 0 and got == _read(out_j)


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("by_record", [False, True])
@pytest.mark.parametrize("flag", ["-B", "-P"])
def test_countsketch_cli_bytes_equal_jax(corpus, flag, by_record, threads,
                                         tmp_path, monkeypatch):
    """-B/-P with -c, over the genomes or (--parse-by-seq) over the
    records of one multi-FASTA of them, with -p 1 and 4, with the default
    batch of hashes and with batches of 5,000 (two items each: an item
    has about 1,980) and of 1,000 (every item longer: alone): the JAX
    CLI's bytes, and every batch one countsketch call."""
    from dashing2_tpu_torch.ops import countsketch as CS
    lst, _, _, paths = corpus
    if by_record:
        multi = tmp_path / "multi.fa"
        multi.write_bytes(b"".join(_read(p) for p in paths))
        inputs = ["--parse-by-seq", str(multi)]
    else:
        inputs = ["-F", lst]
    argv = ["sketch", "-k", "21", "-S", "16", "--binary-output", flag, "-c",
            "1000", "-p", threads] + inputs
    out_j = str(tmp_path / "jax.out")
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", out_j]) == 0
    want = _read(out_j)
    assert len(want) == 4 * len(paths) * (len(paths) - 1) // 2
    calls = []
    real = CS.countsketch_batch

    def counted(hv, offsets, cssize):
        calls.append(offsets.shape[0] - 1)
        return real(hv, offsets, cssize)
    monkeypatch.setattr(CS, "countsketch_batch", counted)
    for budget in (CS.BATCH_HASHES, 5000, 1000):
        monkeypatch.setattr(CS, "BATCH_HASHES", budget)
        calls.clear()
        out_p = str(tmp_path / f"port{budget}.out")
        assert cli.main(argv + ["--cmpout", out_p, "--device", "cpu"]) == 0
        assert _read(out_p) == want, budget
        assert sum(calls) == len(paths)
        assert len(calls) == {5000: (len(paths) + 1) // 2,
                              1000: len(paths)}.get(budget, 1)


@pytest.mark.parametrize("flag", ["-B", "-P"])
def test_weighted_panel_equals_jax(corpus, flag, tmp_path, monkeypatch):
    _, refs, queries, _ = corpus
    argv = ["sketch", "-k", "21", "-S", "16", "--binary-output", "-F",
            refs, "-Q", queries, flag]
    out_p, out_j = str(tmp_path / "port.out"), str(tmp_path / "jax.out")
    assert cli.main(argv + ["--cmpout", out_p, "--device", "cpu"]) == 0
    monkeypatch.setenv("DASHING2_TPU_MULTICHIP", "0")
    assert jax_cli.main(argv + ["--cmpout", out_j]) == 0
    assert _read(out_p) == _read(out_j)


@pytest.mark.parametrize("flag", ["-B", "-P"])
def test_weighted_outfile_and_presketched_equal_jax(corpus, flag, tmp_path):
    """`-o` stacked registers byte for byte, and `cmp --presketched` over
    them gives the sketch job's matrix."""
    lst, _, _, _ = corpus
    argv = ["sketch", "-k", "21", "-S", "16", "-F", lst, flag]
    p, j = str(tmp_path / "port.sig"), str(tmp_path / "jax.sig")
    out = str(tmp_path / "m.bin")
    assert cli.main(argv + ["-o", p, "--binary-output", "--cmpout", out,
                            "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["-o", j]) == 0
    assert _read(p) == _read(j)
    assert _read(p + ".names.txt") == _read(j + ".names.txt")
    again = str(tmp_path / "again.bin")
    assert cli.main(["cmp", "--presketched", flag, "--binary-output",
                     "--cmpout", again, p, "--device", "cpu"]) == 0
    assert _read(again) == _read(out)


def test_countsketch_counts_equal_jax_route(corpus):
    """-c: the CountSketch buckets and weights of the JAX CPU route's
    host engine, and empty CountSketches (all buckets cancelling) give
    empty items."""
    _, _, _, paths = corpus
    for sspace in (SketchSpace.SPACE_MULTISET, SketchSpace.SPACE_PSET):
        opts = Dashing2Options(k=21, sketchsize=64, sspace=sspace,
                               cssize=4096)
        got = PCORE._count_stream(opts, paths[:3])
        plain = PCORE._count_stream(
            Dashing2Options(k=21, sketchsize=64, sspace=sspace), paths[:3])
        for (u, c), (hv, hc) in zip(got, plain):
            stream = np.repeat(hv, hc.astype(np.int64))
            buckets = np.zeros(4096)
            np.add.at(buckets, (stream % np.uint64(4096)).astype(np.int64),
                      np.where(stream & np.uint64(1), 1.0, -1.0))
            nz = np.nonzero(buckets)[0]
            np.testing.assert_array_equal(u, nz.astype(np.uint64))
            np.testing.assert_array_equal(c, np.abs(buckets[nz]))
    hv = np.array([2, 4098, 3, 4099], np.uint64)
    (u, c), = PCORE._count_sketched(Dashing2Options(
        sspace=SketchSpace.SPACE_MULTISET, cssize=4096), [hv], "cpu")
    assert len(u) == 2 and (c == 2).all()
    # an odd bucket count: 2 (even, -1) and 4097 (odd, +1) share bucket 2
    (u, c), = PCORE._count_sketched(Dashing2Options(
        sspace=SketchSpace.SPACE_MULTISET, cssize=4095),
        [np.array([2, 4097], np.uint64)], "cpu")
    assert len(u) == 0 and len(c) == 0


def test_hash_salts_are_the_jax_packages():
    assert (PW._S1, PW._S2, PW._S3, PW._S4, PW._S5, PW._SVAL, PW._GOLD) == \
        (JW._S1, JW._S2, JW._S3, JW._S4, JW._S5, JW._SVAL, JW._GOLD)
