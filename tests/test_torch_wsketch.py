"""Port parity for the wsketch subcommand and the weighted engines it
shares with the interval inputs, on the CPU, against the JAX package run
in the same process.

* The draws' mask: a position whose log-weight is not finite (a weight
  of 0 or less) never wins. `weighted_draws_plain`'s keys and values
  against the JAX `_icws_rt` on masked operands, and whole streams with
  zero, negative and all-masked items (`_sketch_many_streams`) against
  the JAX engine: registers and winners bit for bit.
* CSetSketch winners (`css_sketch_many(return_ids=True)`) against the
  JAX `css_sketch(return_ids=True)`: the winning hash's index in the
  item's input order, for items that take one pass and several; the
  registers stay within CSS_ULP ulp and are unchanged by return_ids.
* The CLI's files against dashing2_tpu.cli wsketch, mirroring
  tests/test_subcommands.py's wsketch cases: the flat and CSR forms,
  empty rows, -B, -P (the default, and the flag) and -q, with --u32,
  --f32 and --indptr32, weights of 0 and below, and '-' for uniform
  weights. Byte for byte, except -q's registers (within CSS_ULP ulp)
  and their hashes (equal where the registers are).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.ops import sketch_kernels as JSK
from dashing2_tpu.sketch import weighted as JW
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.ops import sketch_kernels as SK
from dashing2_tpu_torch.ops import weighted_draws as WD
from dashing2_tpu_torch.sketch import weighted as PW

CSS_ULP = 4


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a.view(np.int64) - b.view(np.int64))
    return np.where(a == b, 0, d)


def _u64(rng, n):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_masked_draws_equal_jax(kind):
    """Non-finite log-weights (-inf, +inf, NaN) draw with w = 0 and key
    +inf in both engines; finite ones are untouched by the mask."""
    rng = np.random.default_rng(3)
    n = 4000
    h = _u64(rng, n)
    j = rng.integers(0, 1024, n).astype(np.uint64) * np.uint64(JW._GOLD)
    lnw = np.log(rng.uniform(0.01, 1e6, n))
    lnw[::3] = -np.inf
    lnw[1::17] = np.inf
    lnw[2::19] = np.nan
    fn = jax.jit(lambda h, w, j: JW._icws_rt(kind, h, w, j, 1024))
    jk, jv = (np.asarray(a) for a in fn(jnp.asarray(h), jnp.asarray(lnw),
                                         jnp.asarray(j)))
    th = torch.from_numpy(h.view(np.int64))
    key, t = WD._icws_rt(kind, th, torch.from_numpy(lnw.astype(np.float32)),
                         torch.from_numpy(j.view(np.int64)))
    np.testing.assert_array_equal(key.numpy().view(np.uint32),
                                  jk.view(np.uint32))
    live = np.isfinite(lnw)
    assert np.isinf(key.numpy()[~live]).all()
    val = WD._sval(kind, th, t).numpy()
    np.testing.assert_array_equal(val[live].view(np.uint32),
                                  jv[live].view(np.uint32))


def _masked_streams(seed: int):
    """Weights of items: positive counts with planted zeros and negative
    values (one in five), an item of zeros and negatives only (every
    position masked), an empty item, and a long item whose masked
    positions fill whole 2048-position rows."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 7, 2047, 2049, 5000]
    streams = [_u64(rng, n) for n in lens]
    weights = []
    for n in lens:
        w = rng.uniform(0.1, 1e4, n)
        w[rng.random(n) < 0.2] = 0.0
        w[rng.random(n) < 0.1] *= -1.0
        weights.append(w)
    weights[2] = -np.abs(weights[2])
    weights[2][::2] = 0.0
    weights[5][:4096] = 0.0
    return streams, weights


@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_masked_streams_equal_jax(kind):
    streams, weights = _masked_streams(9)
    m = 16
    lnws = JW._lnw_many(kind, streams, weights)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(
            np.concatenate(PW._lnw_many(kind, streams, weights)),
            np.concatenate(lnws))
    want, want_ids = JW._sketch_many_streams(kind, streams, lnws, m)
    got, ids = PW._sketch_many_streams(kind, streams, lnws, m, "cpu")
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    np.testing.assert_array_equal(ids, want_ids)
    # the empty and the all-masked items: registers 0, winners 0
    for i in (0, 2):
        assert (got[i] == 0).all() and (ids[i] == 0).all()
    assert (got[[1, 3, 4, 5]] > 0).all()
    # winners are live positions
    for i in (3, 4, 5):
        assert (weights[i][ids[i]] > 0).all()


@pytest.mark.parametrize("budget", [1 << 24, 5000])
@pytest.mark.parametrize("piece", [2048, 4096])
@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_streams_in_pieces_equal_jax(kind, piece, budget, monkeypatch):
    """Streams longer than PIECE are drawn as pieces (items of the
    launch) and merged in order: the JAX engine's registers and winners,
    with equal keys planted across pieces (the earlier keeps them),
    masked pieces, and a stream's pieces split over launches."""
    monkeypatch.setattr(PW, "PIECE", piece)
    streams, weights = _masked_streams(9)
    rng = np.random.default_rng(1)
    h, w = _u64(rng, 9000), rng.uniform(0.1, 1e3, 9000)
    for a, b in ((10, 4200), (10, 8300), (3000, 6200)):
        h[b], w[b] = h[a], w[a]
    w[2048:4096] = 0.0
    streams.append(h)
    weights.append(w)
    m = 16
    lnws = JW._lnw_many(kind, streams, weights)
    want, want_ids = JW._sketch_many_streams(kind, streams, lnws, m)
    got, ids = PW._sketch_many_streams(kind, streams, lnws, m, "cpu",
                                       budget=budget)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    np.testing.assert_array_equal(ids, want_ids)


@pytest.mark.parametrize("kind", ["icws", "pmh"])
def test_masked_kernel_plain_of_all_masked_item(kind):
    """weighted_draws_plain over an item whose every position is masked
    (across two rows) leaves key +inf, winner 0, value 0 per register."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(_u64(rng, 2100).view(np.int64))
    w = torch.full((2100,), float("-inf"), dtype=torch.float32)
    w[5] = float("nan")
    off = torch.tensor([0, 2100], dtype=torch.int64)
    key, win, val = WD.weighted_draws(kind, h, w, off, 8)
    assert torch.isinf(key).all() and (win == 0).all() and (val == 0).all()


def _css_items(seed: int):
    """Distinct hashes of items: one that one pass settles, one of 12
    hashes, an empty one, and a large one (one pass at m = 64); inputs
    in a shuffled order, so that the winner's index must go back
    through the sort."""
    rng = np.random.default_rng(seed)
    return [np.unique(_u64(rng, 3000)), np.unique(_u64(rng, 12)),
            np.zeros(0, np.uint64), rng.permutation(np.unique(
                _u64(rng, 30000)))]


@pytest.mark.parametrize("m", [64, 100])
def test_css_winners_equal_jax(m):
    items = _css_items(m)
    regs, passes, ids = SK.css_sketch_many(items, m, "cpu",
                                           return_ids=True)
    plain, plain_passes = SK.css_sketch_many(items, m, "cpu")
    np.testing.assert_array_equal(regs, plain)
    np.testing.assert_array_equal(passes, plain_passes)
    for i, it in enumerate(items):
        if not len(it):
            assert (ids[i] == 0).all() and np.isinf(regs[i]).all()
            continue
        want, win = JSK.css_sketch(it, np.ones(len(it), bool), m,
                                   return_ids=True)
        assert _ulps(regs[i], want).max() <= CSS_ULP
        np.testing.assert_array_equal(ids[i], np.asarray(win))


def test_css_winners_of_a_batch_split_by_budget():
    """Items split over several passes' groups by a small budget keep
    their winners."""
    items = _css_items(2)
    regs, _, ids = SK.css_sketch_many(items, 64, "cpu", return_ids=True)
    r2, _, i2 = SK.css_sketch_many(items, 64, "cpu", budget=1 << 12,
                                   return_ids=True)
    np.testing.assert_array_equal(regs, r2)
    np.testing.assert_array_equal(ids, i2)


@pytest.fixture(scope="module")
def vectors(tmp_path_factory):
    """A CSR matrix of 6 rows (the first and fourth empty) over u64 and
    u32 ids, f64 and f32 weights with zeros and negative values, u64 and
    u32 indptr."""
    d = tmp_path_factory.mktemp("ws")
    rng = np.random.default_rng(12)
    nnz = 700
    ids = rng.integers(0, 5000, nnz).astype(np.uint64)
    w = rng.uniform(0.25, 3.0, nnz)
    w[::9] = 0.0
    w[5::13] *= -1.0
    ip = np.array([0, 0, 150, 400, 400, 650, nnz])
    files = {"ids.u64": ids, "ids.u32": ids.astype(np.uint32),
             "w.f64": w, "w.f32": w.astype(np.float32),
             "ip.u64": ip.astype(np.uint64), "ip.u32": ip.astype(np.uint32)}
    out = {}
    for name, arr in files.items():
        p = d / name
        arr.tofile(str(p))
        out[name] = str(p)
    return out


FORMS = {"csr": (["ids.u64", "w.f64", "ip.u64"], []),
         "csr32": (["ids.u32", "w.f32", "ip.u32"],
                   ["--u32", "--f32", "--indptr32"]),
         "csr-uniform": (["ids.u64", "-", "ip.u64"], []),
         "flat": (["ids.u64", "w.f64"], []),
         "flat32": (["ids.u32", "w.f32"], ["--u32", "--f32"]),
         "flat-ids": (["ids.u64"], [])}
MODES = {"pmh": [], "pmh-flag": ["-P"], "bmh": ["-B"], "set": ["-q"]}


def _run(main, argv, pref) -> dict:
    import glob
    import os
    assert main(["wsketch", "-S", "64", "-o", pref] + argv) == 0
    return {os.path.basename(f)[len(os.path.basename(pref)):]:
            open(f, "rb").read() for f in glob.glob(pref + ".*")}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cli_wsketch_files_equal_jax(vectors, form, mode, tmp_path):
    names, flags = FORMS[form]
    paths = [vectors[n] if n != "-" else "-" for n in names]
    argv = MODES[mode] + flags + paths
    got = _run(cli.main, argv + ["--device", "cpu"], str(tmp_path / "p"))
    want = _run(jax_cli.main, argv, str(tmp_path / "j"))
    assert sorted(got) == sorted(want) and len(got) == 4
    csr = form.startswith("csr")
    regs = (".sampled.regs.stacked.6.64.f64" if csr
            else ".sampled.hashes.f64")
    hashes = (".sampled.hashes.stacked.6.64.i64" if csr
              else ".sampled.indices.u64")
    for suffix in got:
        if mode != "set" or suffix not in (regs, hashes):
            assert got[suffix] == want[suffix], suffix
    if mode != "set":
        return
    # -q: registers within CSS_ULP ulp (a header of n, m or the total
    # weight first), their hashes equal wherever the registers are
    head = 16 + 8 * 6 if csr else 8
    g = np.frombuffer(got[regs], np.uint8)
    w = np.frombuffer(want[regs], np.uint8)
    assert (g[:head] == w[:head]).all()
    gr, wr = g[head:].view(np.float64), w[head:].view(np.float64)
    assert _ulps(gr, wr).max() <= CSS_ULP
    same = gr == wr
    assert same.mean() > 0.5
    gh = np.frombuffer(got[hashes], np.uint64)
    wh = np.frombuffer(want[hashes], np.uint64)
    np.testing.assert_array_equal(gh[same], wh[same])


def test_cli_wsketch_empty_rows(vectors, tmp_path):
    """Empty CSR rows: all-zero registers, winners 0, total weight 0, in
    every mode (test_subcommands.py::test_wsketch_empty_row_and_modes)."""
    for flags in ([], ["-q"], ["-B"]):
        got = _run(cli.main, flags + [vectors["ids.u64"], vectors["w.f64"],
                                      vectors["ip.u64"], "--device", "cpu"],
                   str(tmp_path / "e"))
        regs = np.frombuffer(got[".sampled.regs.stacked.6.64.f64"],
                             np.uint8)
        cards = regs[16:64].view(np.float64)
        sigs = regs[64:].view(np.float64).reshape(6, 64)
        ids = np.frombuffer(got[".sampled.indices.stacked.6.64.i64"],
                            np.uint64).reshape(6, 64)
        for r in (0, 3):
            assert cards[r] == 0 and (sigs[r] == 0).all() \
                and (ids[r] == 0).all()
        assert (sigs[[1, 2, 4, 5]] != 0).any(axis=1).all()


def test_cli_wsketch_batches_change_nothing(vectors, tmp_path, monkeypatch):
    """Rows split over several many-stream calls give the same files."""
    from dashing2_tpu_torch.sketch import wsketch as PWS
    argv = ["-B", vectors["ids.u64"], vectors["w.f64"], vectors["ip.u64"],
            "--device", "cpu"]
    want = _run(cli.main, argv, str(tmp_path / "a"))
    monkeypatch.setattr(PWS, "BATCH_POSITIONS", 200)
    got = _run(cli.main, argv, str(tmp_path / "b"))
    assert got == want


def test_cli_wsketch_arity(tmp_path, capsys):
    assert cli.main(["wsketch", "--device", "cpu"]) == 1
    assert "1-3 positional" in capsys.readouterr().err
