"""The rolling of csrc/oph_rows.cu, on the CPU.

`ops/oph_rows.py::rolled_codes_plain` computes each position's code as
a thread of the kernel does: positions cut into runs, a run's first
window pushed base by base, then one base a step, validity the count of
valid bases since the last INVALID one. It is held to ops/kmers.py's
codes and scores (each window built from its bases) and, through them,
to the JAX package's `hashed_kmers` and `dna_kmer_codes128`, in every
encoding the kernel selects (`oph_rows.encoding`): 2-bit DNA canonical
and not, the 128-bit code canonical and not, base-b (protein, DNA2),
spaced seeds, the rolling hash (DNA canonical and not, protein); at k in
{1, 31, 32, 33, 48, 64}; runs of several lengths starting at any
position; random INVALID runs, INVALID on run boundaries and on the
first base a run's main loop pushes. Integer work: tolerance zero.
Also the kernel's geometry (`geometry`, `run_length`) and the wrapper's
choice of bucket-min form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.enums import Alphabet as JAlphabet
from dashing2_tpu.ops import kmers as JK
from dashing2_tpu_torch import hashing as H
from dashing2_tpu_torch.enums import Alphabet
from dashing2_tpu_torch.ops import hashes as DH
from dashing2_tpu_torch.ops import kmers as K
from dashing2_tpu_torch.ops import oph_rows as OR

KS = (1, 31, 32, 33, 48, 64)
# name -> (alphabet, options of the job's hash kwargs)
ENCODINGS = {
    "dna": (Alphabet.DNA, dict()),
    "dna-noncanonical": (Alphabet.DNA, dict(canon=False)),
    "u128": (Alphabet.DNA, dict(use128=True)),
    "u128-noncanonical": (Alphabet.DNA, dict(use128=True, canon=False)),
    "roll": (Alphabet.DNA, dict(rolling=True)),
    "roll-noncanonical": (Alphabet.DNA, dict(rolling=True, canon=False)),
    "roll-protein": (Alphabet.PROTEIN, dict(rolling=True)),
    "protein": (Alphabet.PROTEIN, dict()),
    "dna2": (Alphabet.DNA2, dict()),
    "spaced": (Alphabet.DNA, dict(spaced=True)),
}
# (run, start): runs of 4 x odd positions as the kernel cuts them, and
# odd lengths and starts the kernel never uses
RUNS = ((4, 0), (12, 5), (36, 37), (44, 1), (7, 3), (132, 0))
L = 400


def _hkw(name, k, w=0):
    alphabet, kw = ENCODINGS[name]
    spacing = None
    if kw.get("spaced"):
        rng = np.random.default_rng(k)
        spacing = (0,) + tuple(sorted(int(x) for x in rng.choice(
            np.arange(1, k + 9), k - 1, replace=False)))
    return dict(k=k, w=w, canon=kw.get("canon", True), alphabet=alphabet,
                xormask=H.XORMASK, seed_is_zero=False,
                downsample_threshold=(1 << 64) - 1, chunk_len=L,
                span=(spacing[-1] + 1) if spacing else k,
                spacing_offsets=spacing, rolling=kw.get("rolling", False),
                use128=kw.get("use128", False))


def _codes(hkw, run, start, seed):
    """Rows of alphabet codes: random INVALID runs and a valid stretch
    shorter than k; INVALID on every run's first position; INVALID on
    the base each run's main loop pushes first, and before each run;
    no INVALID."""
    k, span = hkw["k"], hkw["span"]
    rng = np.random.default_rng(seed)
    nsym = K.alphabet_size(hkw["alphabet"])
    codes = rng.integers(0, nsym, (4, L)).astype(np.uint8)
    for _ in range(8):
        at = int(rng.integers(0, L - 12))
        codes[0, at:at + int(rng.integers(1, 12))] = K.INVALID
    codes[0, 300:300 + max(k - 1, 1)] = rng.integers(0, nsym, max(k - 1, 1))
    codes[0, 299] = codes[0, 300 + max(k - 1, 1)] = K.INVALID
    bounds = np.arange(start, L, run)
    codes[1, bounds] = K.INVALID
    firsts = bounds + span - 1
    codes[2, firsts[firsts < L]] = K.INVALID
    codes[2, bounds[bounds > 0] - 1] = K.INVALID
    return torch.from_numpy(codes)


def _built(codes, hkw):
    """(score, key, valid) of ops/kmers.py: each window built from its
    bases."""
    mode, base, bits, offsets, _, canon = OR.encoding(hkw)
    k = hkw["k"]
    if mode == OR.DNA128:
        hi, lo, valid = K.dna_kmer_codes128(codes, k, hkw["canon"])
        return DH.srl(hi, 1) ^ lo, lo, valid
    if mode == OR.DNA:
        code, valid = K.dna_kmer_codes(codes, k, canon)
    elif mode == OR.BASEB:
        code, valid = K.base_b_kmer_codes(codes, k, base)
    elif mode == OR.SPACED:
        code, valid = K.spaced_kmer_codes(codes, list(offsets), bits)
    else:
        code, valid = K.rolling_hash_codes(codes, k, canon,
                                           hkw["alphabet"])
    return code, code, valid


def _jax(codes, hkw):
    """(hashed key, score or None, valid) of the JAX package's
    functions: `dna_kmer_codes128` for the 128-bit code (its low word
    and (hi >> 1) ^ lo), `hashed_kmers` for the rest."""
    j = jnp.asarray(codes.numpy())
    k = hkw["k"]
    if OR.encoding(hkw)[0] == OR.DNA128:
        hi, lo, valid = JK.dna_kmer_codes128(j, k, hkw["canon"])
        hi, lo = np.asarray(hi), np.asarray(lo)
        return lo, (hi >> np.uint64(1)) ^ lo, np.asarray(valid)
    # minimizers compile faster than they run op by op
    fn = jax.jit(JK.hashed_kmers, static_argnums=(1,), static_argnames=(
        "w", "canonicalize", "alphabet", "xormask", "seed_is_zero",
        "spacing_offsets", "rolling")) if hkw["w"] else JK.hashed_kmers
    hashed, valid = fn(
        j, k, w=hkw["w"], canonicalize=hkw["canon"],
        alphabet=JAlphabet[hkw["alphabet"].name], xormask=hkw["xormask"],
        seed_is_zero=False, spacing_offsets=hkw["spacing_offsets"],
        rolling=hkw["rolling"])
    return np.asarray(hashed), None, np.asarray(valid)


def _u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_rolled_codes_equal_built_and_jax(name, k):
    """Every position's rolled code == its built code (and score) where
    valid, the same validity; 2^64 - 1 and 0 elsewhere; and == the JAX
    package's codes, through maskfn where `hashed_kmers` applies it."""
    hkw = _hkw(name, k)
    rows = [_codes(hkw, run, start, seed=k * 100 + i)
            for i, (run, start) in enumerate(RUNS)]
    codes = torch.cat(rows)       # the built and JAX codes in one call
    b_score, b_key, b_valid = _built(codes, hkw)
    j_key, j_score, j_valid = _jax(codes, hkw)
    score, key, valid = (torch.cat(x) for x in zip(*(
        OR.rolled_codes_plain(r, hkw, run, start)
        for r, (run, start) in zip(rows, RUNS))))
    assert torch.equal(valid, b_valid)
    assert all(v.any() for v in valid.view(len(RUNS), -1))
    assert torch.equal(key[valid], b_key[valid])
    assert torch.equal(score[valid], b_score[valid])
    assert (score[~valid] == -1).all() and (key[~valid] == 0).all()
    v = valid.numpy()
    np.testing.assert_array_equal(v, j_valid)
    if j_score is None:
        np.testing.assert_array_equal(
            _u64(DH.maskfn(key, hkw["xormask"]))[v], j_key[v])
    else:
        np.testing.assert_array_equal(_u64(key)[v], j_key[v])
        np.testing.assert_array_equal(_u64(score)[v], j_score[v])


@pytest.mark.parametrize("name,k,w", [("dna", 31, 41), ("roll", 48, 60),
                                      ("protein", 7, 12), ("u128", 40, 55),
                                      ("spaced", 11, 30)])
def test_rolled_scores_select_jax_minimizers(name, k, w):
    """The rolled scores and validity through `kmers.minimizer_mask`
    select the JAX package's minimizers (`hashed_kmers` with w > k; for
    the 128-bit code its scores through the JAX `minimizer_mask`)."""
    hkw = _hkw(name, k, w)
    codes = _codes(hkw, 36, 7, seed=w)
    score, key, valid = OR.rolled_codes_plain(codes, hkw, 36, 7)
    sel = K.minimizer_mask(score, valid, k, w).numpy()
    j_key, j_score, j_valid = _jax(codes, hkw)
    if j_score is not None:
        j_valid = np.asarray(jax.jit(JK.minimizer_mask,
                                     static_argnums=(2, 3))(
            jnp.asarray(j_score), jnp.asarray(j_valid), k, w))
    np.testing.assert_array_equal(sel, j_valid)
    assert sel.any()
    got = (_u64(DH.maskfn(key, hkw["xormask"])) if j_score is None
           else _u64(key))
    np.testing.assert_array_equal(got[sel], j_key[sel])


@pytest.mark.parametrize("n", [1, 4, 29, 32, 33, 36, 37, 253])
def test_run_length_is_four_times_odd(n):
    r = OR.run_length(n)
    assert r >= n and r % 4 == 0 and (r // 4) % 2 == 1 and r - n < 8


@pytest.mark.parametrize("span,nwin,m", [
    (1, 1, 64), (31, 1, 1024), (31, 1, 4096), (80, 1, 100), (300, 1, 2048),
    (31, 20, 1024), (21, 11, 4096), (21, 2980, 100), (63, 18, 100),
    (31, 1, 8192), (21, 11, 8192), (31, 20, 8192)])
def test_geometry_covers_rolled_positions(span, nwin, m):
    """Every rolled position (a segment, with minimizers h more on each
    side) lies in one of the block's 128 runs, each run 4 x odd, and the
    block's shared memory fits."""
    run, seg, smem = OR.geometry(span, nwin, m)
    h = nwin - 1 if nwin > 1 else 0
    assert run % 4 == 0 and (run // 4) % 2 == 1
    assert OR.THREADS * run >= seg + 2 * h
    assert smem == OR.smem_bytes(seg, span, nwin, m)
    assert smem <= OR.SMEM_LIMIT
    if nwin <= 1:
        assert run >= min(span + 4, 252)


def test_geometry_refuses_windows_that_do_not_fit():
    with pytest.raises(ValueError):
        OR.geometry(21, 40000, 64)


@pytest.mark.parametrize("m,want", [
    (1, True), (1000, True), (1024, True), (OR.SMEM_BUCKETS_MAX_M, True),
    (OR.SMEM_BUCKETS_MAX_M + 1, False), (2 * OR.SMEM_BUCKETS_MAX_M, False),
    (1 << 20, False)])
def test_bucket_form(m, want):
    """The bucket-min's form follows from m alone: shared memory up to
    SMEM_BUCKETS_MAX_M registers, the tested global atomicMin above."""
    assert OR.use_smem_buckets(m) is want
    p = OR.kernel_params(_hkw("dna", 31), 2, L, m, 0)
    assert p.smem_buckets == int(want)
    assert p.run == OR.geometry(31, 1, m)[0]


def test_kernel_params_base_power():
    """`bpow`, the base-b recurrence's b^(k-1) mod 2^64."""
    p = OR.kernel_params(_hkw("protein", 33), 2, L, 64, 0)
    assert p.bpow == pow(20, 32, 1 << 64)
    p = OR.kernel_params(_hkw("dna2", 64), 2, L, 64, 0)
    assert p.bpow == 1 << 63
