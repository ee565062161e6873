"""Port parity for the chunked sketch route, on the CPU, against the JAX
package run in the same process.

`sketch/core.py::_sketch_chunked` (one-permutation registers of chunk
rows, `ops/oph_rows.py::oph_rows_plain` on CPU tensors) against the JAX
`_sketch_fastx_core` on its CPU backend (its segment engine over
`_hash_chunk_batch`), one item a record (--parse-by-seq), for every
configuration of tests/test_native_oph.py: canonical DNA k in {15, 21,
31, 32} (32 is the rolling hash: above the 2-bit capacity), window
minimizers over records with N runs (and a tiny k with dense ties),
base-b alphabets (protein, DNA2 past k = 32), the rolling hash (k = 40
and 80, canonical and not, with minimizers, protein), spaced seeds
(with minimizers), the 128-bit low word (k = 21, 33, 40, 63, with
minimizers), downsampling, and a filterset (FASTA, and a raw u64 list;
with minimizers and downsampling). The corpus holds a record of 40,000
bases (two chunks of the 32,768-base chunk length, N runs across the
edge), records shorter than k, and some with N runs; its encoding
tests share the one chunk length.

Registers (their k-mer ids, -s), counts (-N), signatures,
cardinalities and names must be equal: tolerance zero. Also:
`_native_oph_rows` (the native engine) against `oph_rows_plain` row by
row; the streamed read (items read as reached) against the JAX
package's; `kmers` functions against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.enums import Alphabet as JAlphabet
from dashing2_tpu.ops import kmers as JK
from dashing2_tpu.sketch import core as JC
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import Alphabet
from dashing2_tpu_torch.io.corpus import edited_sequences, write_fasta
from dashing2_tpu_torch.native import load_oph_lib
from dashing2_tpu_torch.ops import kmers as K
from dashing2_tpu_torch.ops import oph_rows as OR
from dashing2_tpu_torch.sketch import core as PC

M = 64


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunked")
    rng = np.random.default_rng(17)
    recs = edited_sequences(17, 3, 3, length=(150, 2500), n_every=3,
                            polya_every=4)
    long = bytearray(rng.choice(list(b"ACGT"), 40000).astype(np.uint8))
    long[32700:32760] = b"N" * 60        # an N run across the chunk edge
    long[12000:12100] = b"N" * 100
    recs += [("long", bytes(long)), ("short", b"ACGTACGTAC"),
             ("empty", b"")]
    prot = [(f"p{i}", bytes(rng.choice(list(b"ACDEFGHIKLMNPQRSTVWYX"),
                                       int(rng.integers(5, 1500)))
                            .astype(np.uint8))) for i in range(7)]
    fa = write_fasta(str(d / "dna.fa"), recs)
    return {"dna": fa, "protein": write_fasta(str(d / "protein.fa"), prot),
            # a filter FASTA cut from the corpus' records
            "filter": write_fasta(str(d / "filter.fa"), [
                ("f0", recs[0][1][:300]), ("f1", recs[4][1][100:700])]),
            "dir": d}


def _raw_filter(fastas):
    """A raw u64 list (`:b`): the hashes of the filter FASTA at k = 21."""
    hv = PC._filterset_array(Dashing2Options(k=21,
                                             filterset_path=fastas["filter"]))
    path = str(fastas["dir"] / "filter.u64")
    hv[::2].tofile(path)
    return path + ":b"


# name -> (options, FASTA); every case also runs -s and -N
CONFIGS = {
    "dna-k15": (dict(k=15), "dna"),
    "dna-k21": (dict(k=21), "dna"),
    "dna-k31": (dict(k=31), "dna"),
    "dna-k32-rolling": (dict(k=32), "dna"),
    "dna-k21-noncanonical": (dict(k=21, canonicalize=False), "dna"),
    "mini-21-31": (dict(k=21, w=31), "dna"),
    "mini-31-50": (dict(k=31, w=50), "dna"),
    "mini-4-12": (dict(k=4, w=12), "dna"),
    "mini-21-31-ds": (dict(k=21, w=31, kmer_downsample_frac=0.5), "dna"),
    "ds-31": (dict(k=31, kmer_downsample_frac=0.5), "dna"),
    "protein20-k10": (dict(k=10, alphabet=Alphabet.PROTEIN20), "protein"),
    "protein6-k20": (dict(k=20, alphabet=Alphabet.PROTEIN_6), "protein"),
    "protein3bit-k12-w20": (dict(k=12, w=20,
                                 alphabet=Alphabet.PROTEIN_3BIT), "protein"),
    "protein-k7": (dict(k=7, alphabet=Alphabet.PROTEIN), "protein"),
    "dna2-k40": (dict(k=40, alphabet=Alphabet.DNA2), "dna"),
    "roll-40": (dict(k=40), "dna"),
    "roll-80": (dict(k=80), "dna"),
    "roll-40-noncanonical": (dict(k=40, canonicalize=False), "dna"),
    "roll-40-w60": (dict(k=40, w=60), "dna"),
    "roll-protein20-k30": (dict(k=30, alphabet=Alphabet.PROTEIN20),
                           "protein"),
    "spaced-1x10": (dict(k=11, spacing="1x10"), "dna"),
    "spaced-mixed": (dict(k=11, spacing="0,2,0,1,0x5,3"), "dna"),
    "spaced-1x10-w30": (dict(k=11, w=30, spacing="1x10"), "dna"),
    "spaced-protein14": (dict(k=5, spacing="1,0,2,1",
                              alphabet=Alphabet.PROTEIN_14), "protein"),
    "u128-k40": (dict(k=40, use128=True), "dna"),
    "u128-k33": (dict(k=33, use128=True), "dna"),
    "u128-k63": (dict(k=63, use128=True), "dna"),
    "u128-k40-noncanonical": (dict(k=40, use128=True, canonicalize=False),
                              "dna"),
    "u128-k40-w55": (dict(k=40, w=55, use128=True), "dna"),
    "u128-k21": (dict(k=21, use128=True), "dna"),
    "filterset": (dict(k=21, filterset_path="FILTER"), "dna"),
    "filterset-raw": (dict(k=21, filterset_path="RAW"), "dna"),
    "filterset-mini-ds": (dict(k=21, w=31, kmer_downsample_frac=0.6,
                               filterset_path="FILTER"), "dna"),
}


def _options(fastas, kw, **extra):
    kw = dict(kw, sketchsize=M, parse_by_seq=True, save_kmers=True,
              save_kmercounts=True, **extra)
    if kw.get("filterset_path") == "FILTER":
        kw["filterset_path"] = fastas["filter"]
    elif kw.get("filterset_path") == "RAW":
        kw["filterset_path"] = _raw_filter(fastas)
    jkw = dict(kw)
    if "alphabet" in kw:
        jkw["alphabet"] = JAlphabet(int(kw["alphabet"]))
    return Dashing2Options(**kw), JOptions(**jkw)


def _assert_same(got, want):
    assert got.names == want.names
    for attr in ("kmers", "kmercounts", "signatures", "cardinalities"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert g.dtype == w.dtype, attr
        np.testing.assert_array_equal(g, w, err_msg=attr)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_chunked_route_equals_jax(fastas, cfg):
    kw, which = CONFIGS[cfg]
    opts, jopts = _options(fastas, kw)
    got = PC._sketch_chunked(opts, [fastas[which]], "cpu")
    want = JC._sketch_fastx_core(jopts, [fastas[which]])
    _assert_same(got, want)
    # the registers are not all empty, and neither are the counts
    assert (got.kmercounts > 0).sum() > M
    if which == "dna":
        # the 40,000-base record spans two chunks
        assert _auto_chunk(fastas, which) == 1 << 15


def _auto_chunk(fastas, which):
    opts = Dashing2Options(parse_by_seq=True)
    return PC._auto_chunk_len(list(PC._load_items(opts, [fastas[which]])))


def test_filterset_drops_kmers(fastas):
    """The filter changes registers (its k-mers occur in the corpus),
    and a raw list built from half its hashes drops fewer."""
    regs = {}
    for tag in ("none", "FILTER", "RAW"):
        kw = dict(k=21) if tag == "none" else dict(k=21, filterset_path=tag)
        opts, _ = _options(fastas, kw)
        regs[tag] = PC._sketch_chunked(opts, [fastas["dna"]], "cpu").kmers
    assert not np.array_equal(regs["none"], regs["FILTER"])
    assert not np.array_equal(regs["RAW"], regs["FILTER"])


def test_streamed_items_equal_jax(fastas, monkeypatch):
    """Items read as they are reached (above STREAM_BYTES; the record
    names from a first pass) at the streamed chunk length."""
    monkeypatch.setattr(PC, "STREAM_BYTES", 0)
    monkeypatch.setenv("DASHING2_TPU_STREAM", "1")
    opts, jopts = _options(fastas, dict(k=21, w=31))
    files = [fastas["dna"], fastas["dna"]]
    _assert_same(PC._sketch_chunked(opts, files, "cpu"),
                 JC._sketch_fastx_core(jopts, files))


@pytest.mark.parametrize("cfg", ["dna-k31", "mini-4-12", "roll-40-w60",
                                 "spaced-1x10-w30", "u128-k40-w55",
                                 "protein3bit-k12-w20", "filterset-mini-ds"])
def test_native_rows_equal_plain(fastas, cfg):
    """`_native_oph_rows` (the native engine) == `oph_rows_plain`, row by
    row and merged into items, over the corpus' chunk rows in batches of
    few rows."""
    kw, which = CONFIGS[cfg]
    opts, _ = _options(fastas, kw)
    items = list(PC._load_items(opts, [fastas[which]]))
    chunk_len = PC._auto_chunk_len(items)
    hkw = PC._hash_kwargs(opts, chunk_len)
    fs = PC._filterset_array(opts)
    fs_t = None if fs is None else torch.from_numpy(fs.view(np.int64))
    lib = load_oph_lib()
    rows, rid = zip(*PC._iter_chunk_batches(opts, items, chunk_len, 40000))
    rows, rid = np.concatenate(rows), np.concatenate(rid)
    r_nat, c_nat = PC._native_oph_rows(lib, rows, hkw, M, True, fs)
    r_pl, c_pl = OR.oph_rows_plain(
        torch.from_numpy(rows), torch.arange(len(rows), dtype=torch.int32),
        len(rows), M, hkw, fs_t, True)
    np.testing.assert_array_equal(r_pl.numpy().view(np.uint64), r_nat)
    np.testing.assert_array_equal(c_pl.numpy().view(np.uint32), c_nat)
    items_r, items_c = PC.merge_rows(r_nat, c_nat, rid, len(items))
    r_it, c_it = OR.oph_rows_plain(
        torch.from_numpy(rows), torch.from_numpy(rid), len(items), M, hkw,
        fs_t, True)
    np.testing.assert_array_equal(r_it.numpy().view(np.uint64), items_r)
    np.testing.assert_array_equal(c_it.numpy().view(np.uint32), items_c)


@pytest.mark.parametrize("k,w", [(5, 9), (21, 31), (4, 12)])
def test_minimizer_mask_equals_jax(k, w):
    """`kmers.minimizer_mask` on planted scores: ties, the u64 max as a
    valid score, dead windows at N runs and row edges."""
    rng = np.random.default_rng(k * 100 + w)
    scores = rng.integers(0, 6, size=(4, 300)).astype(np.uint64)
    scores[1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    scores[2, ::7] = np.uint64(1 << 63)
    valid = rng.random((4, 300)) > 0.05
    valid[3, 100:140] = False
    want = np.asarray(jax.jit(JK.minimizer_mask, static_argnums=(2, 3))(
        jnp.asarray(scores), jnp.asarray(valid), k, w))
    got = K.minimizer_mask(torch.from_numpy(scores.view(np.int64)),
                           torch.from_numpy(valid), k, w).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmer_codes_equal_jax():
    """base-b, spaced, 128-bit and rolling codes against the JAX
    functions on rows with INVALID bases."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(3, 200)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.03] = K.INVALID
    t, j = torch.from_numpy(codes), jnp.asarray(codes)

    def same(a, b):
        for x, y in zip(a, b):
            x = x.numpy()
            y = np.asarray(y)
            np.testing.assert_array_equal(
                x.view(np.uint64) if x.dtype == np.int64 else x, y)
    same(K.base_b_kmer_codes(t, 9, 4), JK.base_b_kmer_codes(j, 9, 4))
    same(K.spaced_kmer_codes(t, [0, 2, 3, 7], 2),
         JK.spaced_kmer_codes(j, [0, 2, 3, 7], 2))
    for canon in (True, False):
        same(K.dna_kmer_codes128(t, 35, canon),
             jax.jit(JK.dna_kmer_codes128, static_argnums=(1, 2))(
                 j, 35, canon))
        same(K.rolling_hash_codes(t, 66, canon, Alphabet.DNA),
             jax.jit(JK.rolling_hash_codes, static_argnums=(1, 2, 3))(
                 j, 66, canon, JAlphabet.DNA))
    np.testing.assert_array_equal(
        K.chunk_codes([codes[0], codes[1, :20]], 7, chunk_len=64, w=15),
        JK.chunk_codes([codes[0], codes[1, :20]], 7, chunk_len=64, w=15)[0])
