"""Port parity for the OrderMinHash registers of the edit-distance space
(`-E`), on the CPU, against the JAX package run in the same process.

* `omh_registers_plain` (ops/omh.py) on planted streams (tests/
  omh_planted.py: f64 key ties, keys that round to 2^64, phantom slots
  before and after a real winner, one or no valid window) and a random
  stream, in one ragged batch, against the JAX engine `_omh_registers`
  item by item (whole, and in chunks of 4 positions), for ell 1 to 3 and
  m in {4, 7, 130}, with pieces of 1, 3, 16 and the default PIECE
  positions (the kernel's merge of pieces in order);
* the port's `omh_sketch_many` against the JAX one over sequences of
  lengths k - 1, k, 255/256/257 positions, N runs, all-A runs, poly-A
  tracts and repeats, for m in {1, 7, 64, 1024}; 8191, 8192 and 9000
  positions (across the JAX engine's 8192-position chunks); a protein
  alphabet (codes above 3) and k = 40 (the shift-or wraps);
* `dna_kmer_codes` (torch) and `encode_ascii` against the JAX
  functions, and `occurrence_ranks` against the JAX `_occurrence_ranks`
  sequence by sequence;
* `sketch_fastx` in the edit-distance space, with and without
  --parse-by-seq: names, registers, cardinalities and raw sequences.

Every comparison is exact (u64 registers and integer ranks). The CUDA
kernel against its plain version: test_torch_cuda.py.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.enums import Alphabet as JAlphabet
from dashing2_tpu.ops import kmers as JK
from dashing2_tpu.sketch import omh as JO
from dashing2_tpu_torch.enums import Alphabet
from dashing2_tpu_torch.ops import kmers as K
from dashing2_tpu_torch.ops import omh as OP
from dashing2_tpu_torch.sketch import omh as PO

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from omh_planted import planted_items, ragged  # noqa: E402


def _jax_registers(items, m, ell, pchunk):
    out = []
    for km, occ, va in items:
        out.append(np.asarray(JO._omh_registers(
            jnp.asarray(km), jnp.asarray(occ), jnp.asarray(va), m=m,
            ell=ell, pchunk=pchunk)))
    return np.stack(out)


def _plain(items, m, ell, piece):
    km, occ, va, off = ragged(items)
    return OP.omh_registers_plain(
        torch.from_numpy(km.view(np.int64)), torch.from_numpy(occ),
        torch.from_numpy(va), torch.from_numpy(off), m, ell,
        piece=piece).numpy().view(np.uint64)


@pytest.mark.parametrize("m", [4, 7, 130])
@pytest.mark.parametrize("ell", [1, 2, 3])
def test_planted_registers_equal_jax(m, ell):
    items = planted_items()
    want = _jax_registers(items, m, ell, 8192)
    np.testing.assert_array_equal(_jax_registers(items, m, ell, 4), want)
    for piece in (OP.PIECE, 16, 3, 1):
        np.testing.assert_array_equal(_plain(items, m, ell, piece), want)


@pytest.mark.parametrize("ell", [1, 3])
def test_wrapper_is_built_for_ell_2_only(ell):
    """omh_registers serves ell = 2, the one depth of every path (the
    kernel is built for it alone); the plain version keeps the rule for
    any depth."""
    km, occ, va, off = ragged(planted_items())
    args = [torch.from_numpy(x) for x in (km.view(np.int64), occ, va, off)]
    with pytest.raises(ValueError, match="ell"):
        OP.omh_registers(*args, 4, ell)
    assert OP.omh_registers_plain(*args, 4, ell).shape == (len(off) - 1, 4)


def test_planted_registers_are_what_they_plant():
    """The plants bite: register 3 of the ties item folds positions 5 and
    10 (its least exact key, at 30, loses the f64 tie), and register 0 of
    the rounds-up and no-window items folds the sentinel twice."""
    items = planted_items()
    got = _plain(items, 4, 2, OP.PIECE)
    km, _, _ = items[0]
    sig = np.uint64(OP._SALT)
    from dashing2_tpu_torch import hashing as H
    for e, p in enumerate((5, 10)):
        sig = H.wanghash(sig ^ km[p] ^ np.uint64((e + 1) * OP._G1
                                                 & 0xFFFFFFFFFFFFFFFF))
    assert got[0, 3] == sig
    phantom = np.uint64(OP._SALT)
    for e in range(2):
        phantom = H.wanghash(phantom ^ np.uint64(OP._INVALID_CODE)
                             ^ np.uint64((e + 1) * OP._G1
                                         & 0xFFFFFFFFFFFFFFFF))
    assert got[1, 0] == phantom and (got[5] == phantom).all()
    assert got[2, 0] != got[3, 0] != phantom


def _codes(rng, lens, n_runs=True):
    out = []
    for i, L in enumerate(lens):
        c = rng.integers(0, 4, L).astype(np.uint8)
        if n_runs and L > 200:
            c[50:80] = K.INVALID            # an N run
            c[120:190] = 0                  # an all-A run after it
        if i % 3 == 2:
            c[: L // 2] = np.resize(c[:7], L // 2)   # repeats
        out.append(c)
    return out


K15 = 15
LENS = [K15 - 1, K15, 255 + K15 - 1, 256 + K15 - 1, 257 + K15 - 1, 400, 60]


@pytest.mark.parametrize("m", [1, 7, 64, 1024])
def test_sketch_many_equal_jax(m):
    rng = np.random.default_rng(m)
    codes = _codes(rng, LENS)
    codes.append(np.full(30, K.INVALID, np.uint8))   # no valid window
    c = np.zeros(100, np.uint8)
    c[40:45] = K.INVALID
    codes.append(c)                                  # all A around an N
    want = JO.omh_sketch_many(codes, K15, m)
    got = PO.omh_sketch_many(codes, K15, m, device="cpu")
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all() and (got[1] != 0).all()


@pytest.mark.parametrize("npos", [8191, 8192, 9000])
def test_long_streams_equal_jax(npos, monkeypatch):
    """Across the JAX engine's 8192-position chunks; the port's pieces of
    8192 positions, and of 1000 (a stream of several pieces)."""
    rng = np.random.default_rng(npos)
    codes = _codes(rng, [npos + K15 - 1, 300])
    want = JO.omh_sketch_many(codes, K15, 16)
    np.testing.assert_array_equal(
        PO.omh_sketch_many(codes, K15, 16, device="cpu"), want)
    monkeypatch.setattr(OP, "PIECE", 1000)
    np.testing.assert_array_equal(
        PO.omh_sketch_many(codes, K15, 16, device="cpu"), want)


def test_batches_split_and_keep_rows(monkeypatch):
    """Ragged batches capped by positions give the rows of one batch."""
    rng = np.random.default_rng(3)
    codes = _codes(rng, [40, 10, 300, 41, 500, 16])
    want = PO.omh_sketch_many(codes, K15, 8, device="cpu")
    monkeypatch.setattr(PO, "BATCH_POSITIONS", 100)
    assert len(list(PO._batches([len(c) for c in codes], K15, 8, 2))) >= 4
    np.testing.assert_array_equal(
        PO.omh_sketch_many(codes, K15, 8, device="cpu"), want)
    np.testing.assert_array_equal(want, JO.omh_sketch_many(codes, K15, 8))


@pytest.mark.parametrize("k, protein", [(15, True), (40, False), (32, False)])
def test_other_alphabets_and_long_k_equal_jax(k, protein):
    rng = np.random.default_rng(k)
    hi = 20 if protein else 4
    codes = [rng.integers(0, hi, L).astype(np.uint8) for L in (k + 30, 500)]
    codes[1][100:120] = K.INVALID
    np.testing.assert_array_equal(
        PO.omh_sketch_many(codes, k, 32, device="cpu"),
        JO.omh_sketch_many(codes, k, 32))


@pytest.mark.parametrize("k", [1, 15, 31, 32, 33, 40])
@pytest.mark.parametrize("canon", [False, True])
def test_dna_kmer_codes_equal_jax(k, canon):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (3, 200)).astype(np.uint8)
    codes[0, 17:19] = K.INVALID
    codes[2, :] = rng.integers(0, 20, 200)           # codes above 3
    want_k, want_v = JK.dna_kmer_codes(jnp.asarray(codes), k, canon)
    got_k, got_v = K.dna_kmer_codes(torch.from_numpy(codes), k, canon)
    np.testing.assert_array_equal(got_k.numpy().view(np.uint64),
                                  np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_encode_ascii_equal_jax():
    seq = b"ACGTNacgtnRYKM*-XACGT"
    for pa, ja in ((Alphabet.DNA, JAlphabet.DNA),
                   (Alphabet.PROTEIN20, JAlphabet.PROTEIN20)):
        np.testing.assert_array_equal(K.encode_ascii(seq, pa),
                                      JK.encode_ascii(seq, ja))
        arr = np.frombuffer(seq, np.uint8)
        np.testing.assert_array_equal(K.encode_ascii(arr, pa),
                                      JK.encode_ascii(arr, ja))


def test_occurrence_ranks_equal_jax():
    rng = np.random.default_rng(9)
    sizes = np.array([0, 1, 5, 300, 2, 1000])
    vals = rng.integers(0, 7, sizes.sum()).astype(np.uint64)
    vals[::11] = np.uint64(1 << 63) + vals[::11]    # top bit set
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    got = PO.occurrence_ranks(torch.from_numpy(vals.view(np.int64)),
                              torch.from_numpy(offsets),
                              torch.from_numpy(sizes)).numpy()
    want = np.concatenate([JO._occurrence_ranks(vals[a:b])
                           for a, b in zip(offsets[:-1], offsets[1:])])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parse_by_seq", [True, False])
def test_sketch_fastx_edit_distance_equals_jax(parse_by_seq, tmp_path):
    """sketch_fastx in the edit-distance space: names, OMH signatures,
    base-count cardinalities and the kept raw sequences equal the JAX
    package's, one item a record (--parse-by-seq) or a file."""
    from dashing2_tpu.config import Dashing2Options as JOptions
    from dashing2_tpu.enums import SketchSpace as JSpace
    from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.enums import SketchSpace
    from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
    from dashing2_tpu_torch.sketch.core import sketch_fastx
    recs = edited_sequences(2, 3, 3, length=(40, 300), n_every=4,
                            polya_every=5)
    recs.append(("tiny", b"ACG"))
    files = [write_fasta(str(tmp_path / f"{i}.fa"), recs[i::3])
             for i in range(3)]
    groups = files[:2] + [files[2] + " " + files[0]]
    kw = dict(k=K15, sketchsize=32, parse_by_seq=parse_by_seq)
    want = jax_sketch_fastx(JOptions(
        sspace=JSpace.SPACE_EDIT_DISTANCE, **kw), groups)
    got = sketch_fastx(Dashing2Options(
        sspace=SketchSpace.SPACE_EDIT_DISTANCE, **kw), groups,
        device="cpu")
    assert got.names == want.names
    np.testing.assert_array_equal(got.signatures.view(np.uint64),
                                  want.signatures.view(np.uint64))
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)
    assert list(got.sequences) == list(want.sequences)
