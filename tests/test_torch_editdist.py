"""Port parity for the edit distances and the sequence store of the
edit-distance space (`-E`), on the CPU.

* `myers_batch_native` (the port's copy of native/myers_ed.cpp) against
  the JAX package's `myers_batch_native` and the Python big-int oracle
  (both packages' `myers_edit_distance`): random sequences of unequal
  lengths over DNA and bytes, empty sequences, identical pairs, lengths
  at the 64-cell block edges and above the banded route's 128, related
  pairs (the band's early exit) and unrelated ones (its doubling);
* `edit_distances_pairs` over a SequenceStore, in RAM and spilled;
* `SequenceStore` (io/seqstore.py): the spill past the threshold to an
  unlinked temp file, reads by index and iteration, and `in_ram`.

Every comparison is exact (integer distances, equal bytes).
"""

import numpy as np
import pytest

from dashing2_tpu.cmp import editdist as JE
from dashing2_tpu.io import seqstore as JS
from dashing2_tpu_torch.cmp import editdist as PE
from dashing2_tpu_torch.io import seqstore as PS
from dashing2_tpu_torch.result import SketchingResult


def _mutate(rng, s: bytes, rate: float) -> bytes:
    out = bytearray()
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue                                   # deletion
        if r < 2 * rate / 3:
            out.append(int(rng.choice(list(b"ACGT"))))  # insertion
        out.append(int(rng.choice(list(b"ACGT"))) if r < rate else ch)
    return bytes(out)


def _seqs(seed: int):
    rng = np.random.default_rng(seed)
    seqs = [b"", b"A", b"ACGT", b"TTTT"]
    for L in (63, 64, 65, 127, 128, 129, 200, 700):
        seqs.append(bytes(rng.choice(list(b"ACGT"), L)))
    base = bytes(rng.choice(list(b"ACGT"), 900))
    seqs += [base, _mutate(rng, base, 0.02), _mutate(rng, base, 0.2)]
    seqs.append(bytes(rng.integers(0, 256, 300, dtype=np.uint8)))
    return seqs


def _pairs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ia, ib = np.triu_indices(n)
    extra = rng.integers(0, n, (2, 40))
    return (np.concatenate([ia, ib, extra[0]]),
            np.concatenate([ib, ia, extra[1]]))


@pytest.mark.parametrize("nthreads", [1, 3, 0])
def test_myers_batch_equals_jax_and_oracle(nthreads):
    seqs = _seqs(1)
    ia, ib = _pairs(len(seqs), 2)
    got = PE.myers_batch_native(seqs, ia, ib, nthreads=nthreads)
    want = JE.myers_batch_native(seqs, ia, ib, nthreads=nthreads)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    oracle = [PE.myers_edit_distance(seqs[a], seqs[b])
              for a, b in zip(ia, ib)]
    assert oracle == [JE.myers_edit_distance(seqs[a], seqs[b])
                      for a, b in zip(ia, ib)]
    np.testing.assert_array_equal(got, np.asarray(oracle, np.float64))


def test_myers_empty_pair_list():
    res = SketchingResult(names=["a", "b"], sequences=[b"AC", b"A"])
    none = np.zeros(0, np.int64)
    assert PE.edit_distances_pairs(res, none, none).shape == (0,)
    np.testing.assert_array_equal(
        PE.edit_distances_pairs(res, np.array([0, 1]), np.array([1, 1])),
        [1.0, 0.0])


@pytest.mark.parametrize("threshold", [None, 1, 1500])
def test_distances_over_a_store(threshold):
    """The store in RAM, spilled from the first sequence, and spilled part
    way: the same distances as a plain list."""
    seqs = _seqs(3)
    st = PS.SequenceStore(threshold=threshold)
    for s in seqs:
        st.append(s)
    assert (st._ram is None) == (threshold is not None)
    ia, ib = _pairs(len(seqs), 4)
    want = PE.edit_distances_pairs(SketchingResult(sequences=seqs), ia, ib)
    got = PE.edit_distances_pairs(SketchingResult(sequences=st), ia, ib)
    np.testing.assert_array_equal(got, want)


def test_sequence_store_spill_and_in_ram_like_jax(monkeypatch):
    seqs = [b"ACGT", b"", b"GGGGGGGG", b"T" * 100]
    for mod in (PS, JS):
        st = mod.SequenceStore(threshold=10)
        for s in seqs:
            st.append(s)
        assert st._ram is None and len(st) == 4
        assert [st[i] for i in range(4)] == seqs
        assert list(st) == seqs
        pinned = mod.SequenceStore(in_ram=True, threshold=1)
        for s in seqs:
            pinned.append(s)
        assert pinned._ram is not None and list(pinned) == seqs
    # the default threshold is read when a store is made
    monkeypatch.setattr(PS, "RAM_THRESHOLD", 5)
    st = PS.SequenceStore()
    st.append(b"ACGTAC")
    assert st._ram is None and st[0] == b"ACGTAC"
    assert PS.RAM_THRESHOLD != JS.RAM_THRESHOLD == 2 << 30
