"""The plan of csrc/oph_rows.cu's staged path (`hash_rows`, and
`oph_rows` with minimizers), on the CPU.

`ops/oph_rows.py::window_select_plain` models the kernel's window stage:
segments with their halos, van Herk / Gil-Werman prefix and suffix
minima over chunks of nwin slots with the leftmost argmin, liveness from
the chunks' all-valid prefixes and suffixes, candidates, and the tie
test on candidates only. It is held to the port's
`kmers.minimizer_mask` and to the JAX package's `minimizer_mask` (run on
the CPU as tests/test_torch_oph_roll.py runs it) on planted score rows:
all scores equal; tandem repeats of period 1 to h + 1 (h = nwin - 1);
runs of invalid positions of length 1 to nwin at every offset modulo
nwin; valid positions scored the u64 max; rows shorter than nwin;
ownership windows that cut windows; segment edges at every residue
modulo nwin; nwin in {2, 3, 17, 21}. `compact_plain` models the
kernel's compaction (segment counts, a slab reserved in any order, the
scan, the placement) and is held to `hash_rows_plain`'s mask
compaction. Integer work: tolerance zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.ops import kmers as JK
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.ops import kmers as K
from dashing2_tpu_torch.ops import oph_rows as OR
from dashing2_tpu_torch.sketch import core as PC

NWINS = (2, 3, 17, 21)
K_ = 15                       # k of the score rows' (k, w) pairs
U64MAX = -1


def _planted_scores(kind: str, nwin: int, seed: int):
    """(score int64 u64 bits, valid bool) rows of one planted kind."""
    rng = np.random.default_rng(seed)
    h = nwin - 1
    n = 12 * nwin + 40

    def rand(shape, top=1 << 62):
        return rng.integers(0, top, shape).astype(np.int64)
    if kind == "equal":
        score = np.full((3, n), 7, np.int64)
        valid = np.ones((3, n), bool)
        valid[1, n // 2] = False
        score[2] = U64MAX                     # valid, scored the u64 max
    elif kind == "tandem":
        rows = [np.resize(rand(p), n) for p in range(1, h + 2)]
        score, valid = np.stack(rows), np.ones((h + 1, n), bool)
    elif kind == "invalid-runs":
        rows, masks = [], []
        for run in range(1, nwin + 1):
            for off in range(nwin):
                row = rand(n, 8)              # many equal scores
                ok = np.ones(n, bool)
                for at in range(nwin + off, n - run, 3 * nwin + 1):
                    ok[at:at + run] = False
                rows.append(row)
                masks.append(ok)
        score, valid = np.stack(rows), np.stack(masks)
    elif kind == "u64max":
        score = rand((4, n))
        score[:, ::3] = U64MAX
        valid = rng.random((4, n)) > 0.1
    else:                                     # random
        score = rand((4, n), 64)
        valid = rng.random((4, n)) > 0.03
    return torch.from_numpy(score), torch.from_numpy(valid)


def _jax_mask(score, valid, nwin):
    fn = jax.jit(JK.minimizer_mask, static_argnums=(2, 3))
    return np.asarray(fn(jnp.asarray(score.numpy().view(np.uint64)),
                         jnp.asarray(valid.numpy()), K_, K_ + nwin - 1))


def _owned(mask, lo, hi):
    pos = torch.arange(mask.shape[-1])
    return mask & (pos >= lo) & (pos < hi)


@pytest.mark.parametrize("kind", ["equal", "tandem", "invalid-runs",
                                  "u64max", "random"])
@pytest.mark.parametrize("nwin", NWINS)
def test_window_model_equals_minimizer_masks(nwin, kind):
    """The kernel's window stage, at segment lengths of every residue
    modulo nwin and ownership windows that cut windows, selects the
    owned positions of the port's and the JAX package's minimizer
    masks."""
    score, valid = _planted_scores(kind, nwin, seed=nwin)
    want = K.minimizer_mask(score, valid, K_, K_ + nwin - 1)
    np.testing.assert_array_equal(want.numpy(),
                                  _jax_mask(score, valid, nwin))
    assert want.any()
    n = score.shape[1]
    h = nwin - 1
    segs = sorted({max(1, 2 * nwin + r) for r in range(nwin)}
                  | {1, 5 * nwin + 3, n})
    owns = [(0, n), (h // 2 + 1, n - h // 2 - 1), (nwin + 1, 4 * nwin - 1),
            (-5, n + 9)]
    for seg in segs:
        for lo, hi in owns:
            got = OR.window_select_plain(score, valid, nwin, seg, lo, hi)
            assert torch.equal(got, _owned(want, lo, hi)), (seg, lo, hi)


@pytest.mark.parametrize("nwin", NWINS)
def test_window_model_on_rows_shorter_than_nwin(nwin):
    """Rows of fewer than nwin positions hold no window: the model and
    the port's minimizer mask select nothing, as the JAX function does
    where it returns (it raises on the shortest rows, whose log-step
    shifts pass the row's end)."""
    rng = np.random.default_rng(nwin)
    for n in range(1, nwin):
        score = torch.from_numpy(rng.integers(0, 1 << 62, (2, n)))
        valid = torch.ones((2, n), dtype=torch.bool)
        want = K.minimizer_mask(score, valid, K_, K_ + nwin - 1)
        assert not want.any()
        try:
            assert not _jax_mask(score, valid, nwin).any()
        except (TypeError, ValueError):
            pass
        for seg in (1, nwin, 64):
            assert not OR.window_select_plain(score, valid, nwin, seg, 0,
                                              n).any()


def _corpus_codes(seed: int, R: int = 7, L: int = 900):
    """Rows of random DNA codes with N runs, a padded tail, a row of
    padding and one of a valid stretch shorter than the window."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    for r in range(0, R, 2):
        at = int(rng.integers(0, L - 40))
        codes[r, at:at + int(rng.integers(1, 40))] = K.INVALID
    codes[1, L // 3:] = K.INVALID
    codes[2] = K.INVALID
    codes[3] = K.INVALID
    codes[3, 100:130] = 1
    return torch.from_numpy(codes)


@pytest.mark.parametrize("kw", [dict(k=15, w=31), dict(k=21, w=31),
                                dict(k=12, w=14), dict(k=40, w=60,
                                                       use128=True)])
def test_plan_equals_hash_chunk_batch(kw):
    """The kernel's plan end to end: the rolled scores
    (`rolled_codes_plain`, at the geometry's run) through the window
    stage's model, at the geometry's segment and at short ones, with the
    chunk's ownership, == the surviving positions of the plain
    `hash_chunk_batch` (and `hash_chunk_batch128`)."""
    opts = Dashing2Options(**kw)
    L = 900
    hkw = PC._hash_kwargs(opts, L - 200)
    codes = _corpus_codes(kw["k"])
    mode = OR.encoding(hkw)[0]
    nwin = kw["w"] - kw["k"] + 1
    run, seg, _ = OR.geometry(kw["k"], nwin, 0, 2 if mode == OR.DNA128
                              else 1, stream=True)
    score, _, valid = OR.rolled_codes_plain(codes, hkw, run)
    lo, hi = K.owned_kmer_range(kw["k"], kw["w"], hkw["chunk_len"])
    if mode == OR.DNA128:
        _, _, want = OR.hash_chunk_batch128(codes, hkw, 5)
    else:
        _, want = OR.hash_chunk_batch(codes, hkw)
    assert want.any()
    for s in (seg, 3 * nwin + 1, 64):
        got = OR.window_select_plain(score, valid, nwin, s, lo, hi)
        assert torch.equal(got, want), s


@pytest.mark.parametrize("case", ["mixed", "no-token", "all-padding"])
@pytest.mark.parametrize("seg", [1, 37, 256, 5000])
def test_compaction_model_equals_mask_compaction(case, seg):
    """Segment counts, a slab reserved in any order, the exclusive scan
    and the placement give `hash_rows_plain`'s tokens and counts: rows
    with no kept token, all-padding rows, rows over several segments."""
    opts = Dashing2Options(k=15, w=31)
    codes = _corpus_codes(3)
    if case == "all-padding":
        codes[:] = K.INVALID
    hkw = PC._hash_kwargs(opts, codes.shape[1] - 200)
    if case == "no-token":                    # the filterset drops all
        lo, valid = OR.hash_chunk_batch(codes, hkw)
        fs = torch.from_numpy(np.unique(lo[valid].numpy().view(np.uint64))
                              .view(np.int64))
    else:
        fs = None
    tok, valid = OR.hash_chunk_batch(codes, hkw, fs)
    want_tok, _, want_cnt = OR.hash_rows_plain(codes, hkw, fs)
    assert (int(want_cnt.sum()) == 0) == (case != "mixed")
    lo, hi = K.owned_kmer_range(15, 31, hkw["chunk_len"])
    nseg = -(-(hi - lo) // seg)
    rng = np.random.default_rng(seg)
    for order in (None, rng.permutation(codes.shape[0] * nseg)):
        got_tok, got_cnt = OR.compact_plain(valid, tok, seg, lo, hi, order)
        assert torch.equal(got_tok, want_tok)
        assert torch.equal(got_cnt, want_cnt)


@pytest.mark.parametrize("span,nwin,words,stream", [
    (15, 17, 1, True), (40, 21, 2, True), (21, 11, 1, False),
    (31, 1, 1, True), (31, 1, 2, True), (63, 18, 2, True),
    (21, 2980, 1, False), (4, 9, 1, True), (11, 20, 1, True)])
def test_staged_geometry(span, nwin, words, stream):
    """A staged block: 128 runs, each 4 x odd, at most 4 span (at least
    12) and, unless the block is alone on its SM, at least (span - 1) / 2,
    covering the segment and its halos, with 16-bit slot indices; the
    longest such run for which the most blocks of SHARES share an SM,
    the shared bytes those of csrc/oph_rows.cu's layout."""
    m = 0 if stream else 1024
    run, seg, smem = OR.geometry(span, nwin, m, words, stream)
    h = nwin - 1 if nwin > 1 else 0
    longest = OR.run_length(max(4 * span, 12))
    shortest = min(OR.run_length(max(-(-(span - 1) // 2), 1)), longest)
    assert run % 4 == 0 and (run // 4) % 2 == 1 and run <= longest
    assert seg > 0 and OR.THREADS * run == seg + 2 * h < OR.MAX_SLOTS
    assert smem == OR.smem_bytes(seg, span, nwin, m, words, stream)
    assert smem <= OR.SMEM_LIMIT

    def fits(r, blocks):
        s = OR.THREADS * r - 2 * h
        return s > 0 and OR.smem_bytes(s, span, nwin, m, words, stream) \
            <= OR.SMEM_SM // blocks - 1024

    def runs(blocks):
        return range(4 if blocks == 1 else shortest, longest + 1, 8)
    share = next(n for n in OR.SHARES if run in runs(n) and fits(run, n))
    for more in OR.SHARES[:OR.SHARES.index(share)]:
        assert not any(fits(r, more) for r in runs(more))
    assert not any(fits(r, share) for r in runs(share) if r > run)


def test_token_capacity_and_segments():
    """The slab's first capacity: every owned position without
    minimizers, 2.5 / (nwin + 1) of them and 4096 more with them, at
    most every one; the segments a row."""
    hkw = PC._hash_kwargs(Dashing2Options(k=15, w=31), 9000)
    p = OR.kernel_params(hkw, 10, 9400, 0, 0)
    lo, hi = K.owned_kmer_range(15, 31, 9000)
    owned = 10 * (hi - lo)
    assert OR.token_capacity(p) == 5 * owned // 36 + 4096
    assert OR.segments(p) == -(-(hi - lo) // p.seg)
    p1 = OR.kernel_params(PC._hash_kwargs(Dashing2Options(k=15), 9000), 10,
                          9400, 0, 0)
    lo1, hi1 = K.owned_kmer_range(15, 0, 9000)
    assert OR.token_capacity(p1) == 10 * (hi1 - lo1)
    p.R = 1
    p.own_lo, p.own_hi = 0, 100
    assert OR.token_capacity(p) == 100 and OR.segments(p) == 1
    p.own_hi = 0
    assert OR.token_capacity(p) == 0 and OR.segments(p) == 0
