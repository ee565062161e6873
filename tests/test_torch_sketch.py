"""Port parity: the native file-driver sketch against the JAX package's
`sketch_fastx`, on seeded FASTA.

The JAX side runs once with DASHING2_TPU_NATIVE_FILES=force (the same
C++ file driver) and once without it (on the CPU backend: its chunked
device engines). Signatures, cardinalities and k-mer ids must be equal
exactly.
"""

import numpy as np
import pytest

from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.enums import KmerSketchResultType as JKres
from dashing2_tpu.enums import SketchSpace as JSpace
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import (Alphabet, KmerSketchResultType,
                                     SketchSpace)
from dashing2_tpu_torch.io.corpus import write_corpus
from dashing2_tpu_torch.sketch.core import sketch_fastx


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    d = tmp_path_factory.mktemp("sketch_corpus")
    paths = write_corpus(str(d / "fa"), seed=11, n_ancestors=3,
                         n_mutants=4, length=3000)
    # one item made of two files, sketched jointly
    return paths[:-2] + [paths[-2] + " " + paths[-1]]


CONFIGS = {
    "k31": dict(k=31, sketchsize=256),
    "minimizer-w40": dict(k=21, w=40, sketchsize=128),
    "spaced": dict(k=5, spacing="1,0,2,1", sketchsize=64),
    "protein8-seeded": dict(k=7, alphabet=Alphabet.PROTEIN_3BIT, seedseed=13,
                            sketchsize=128),
    "long-kmers": dict(k=40, use128=True, sketchsize=128, canonicalize=False),
}


@pytest.mark.parametrize("native_files", ["force", ""])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_sketch_matches_jax(groups, cfg, native_files, monkeypatch):
    if native_files:
        monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", native_files)
    else:
        monkeypatch.delenv("DASHING2_TPU_NATIVE_FILES", raising=False)
    want = jax_sketch_fastx(JOptions(**CONFIGS[cfg]), groups)
    got = sketch_fastx(Dashing2Options(**CONFIGS[cfg]), groups)
    assert got.names == want.names == groups
    np.testing.assert_array_equal(got.signatures, want.signatures)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)
    assert got.kmers is None and want.kmers is None


@pytest.mark.parametrize("opts", [
    dict(entmin=True), dict(parse_by_seq=True), dict(cache_sketches=True),
    dict(kmer_result=KmerSketchResultType.FULL_MMER_SEQUENCE),
    # the edit-distance space runs, --by-chrom ignored as in the JAX
    # package
    dict(sspace=SketchSpace.SPACE_EDIT_DISTANCE, by_chrom=True),
    dict(by_chrom=True), dict(filterset_path="some.fs"),
    dict(kmer_result=KmerSketchResultType.FULL_MMER_SET, use128=True),
])
def test_configs_outside_the_file_driver_raise(groups, opts):
    """--entmin raises, naming its ROADMAP item. The rest run and equal
    the JAX package's: --parse-by-seq (one item a record) and --by-chrom
    on the chunked route, -E (its own route), --seq (minimizer sequences
    on the chunked route's rows) and u128 exact sets (the counting
    route), --filterset (here the first genome as the filter FASTA) on
    the file driver, --cache (the port's cold run beside the inputs with
    -s, then the JAX package's warm one)."""
    runs = "entmin" not in opts
    if not runs:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sketch_fastx(Dashing2Options(k=21, sketchsize=64, **opts),
                         groups)
        return
    if "filterset_path" in opts:
        opts = dict(opts, filterset_path=groups[0])
    kw = dict(k=21, sketchsize=64, save_kmers=True, **opts)
    jkw = dict(kw)
    if "sspace" in kw:
        jkw["sspace"] = JSpace(int(kw["sspace"]))
    if "kmer_result" in kw:
        jkw["kmer_result"] = JKres(int(kw["kmer_result"]))
    got = sketch_fastx(Dashing2Options(**kw), groups, device="cpu")
    want = jax_sketch_fastx(JOptions(**jkw), groups)
    assert got.names == want.names
    for attr in ("signatures", "mmer_sequences", "kmer_sets"):
        g, w = getattr(got, attr), getattr(want, attr, None)
        assert (g is None) == (w is None), attr
        if g is not None:
            assert len(g) == len(w), attr
            for a, b in zip(g, w):
                assert np.asarray(a).dtype == np.asarray(b).dtype, attr
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)
    if got.kmers is not None:
        np.testing.assert_array_equal(got.kmers, want.kmers)


@pytest.mark.parametrize("flags", [dict(save_kmers=True),
                                   dict(save_kmercounts=True),
                                   dict(save_kmers=True, save_kmercounts=True,
                                        sketchsize=100, w=25)])
def test_saved_kmers_match_jax(groups, flags, monkeypatch):
    """-s/-N on the native file driver: each register's k-mer id (0 for
    an empty register) and multiplicity, as the JAX package's."""
    monkeypatch.setenv("DASHING2_TPU_NATIVE_FILES", "force")
    kw = dict(dict(k=21, sketchsize=64), **flags)
    got = sketch_fastx(Dashing2Options(**kw), groups)
    want = jax_sketch_fastx(JOptions(**kw), groups)
    np.testing.assert_array_equal(got.signatures, want.signatures)
    for attr in ("kmers", "kmercounts"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert (got.kmers is not None) == kw.get("save_kmers", False)


def test_xz_inputs_raise(groups, tmp_path):
    """A missing .xz input raises; one-permutation .xz/.bz2 inputs run
    on the chunked route since it was ported, with the plain inputs'
    registers and counts (and the JAX package's)."""
    import bz2
    import lzma
    with pytest.raises(OSError):
        sketch_fastx(Dashing2Options(k=21, sketchsize=64),
                     groups + [str(tmp_path / "x.fa.xz")], device="cpu")
    kw = dict(k=21, sketchsize=64, save_kmers=True, save_kmercounts=True)
    plain = [g.split()[0] for g in groups[:2]]
    packed = []
    for p, (suffix, opener) in zip(plain, ((".xz", lzma.open),
                                           (".bz2", bz2.open))):
        out = str(tmp_path / (p.rsplit("/", 1)[-1] + suffix))
        with open(p, "rb") as f, opener(out, "wb") as g:
            g.write(f.read())
        packed.append(out)
    want = sketch_fastx(Dashing2Options(**kw), plain, device="cpu")
    got = sketch_fastx(Dashing2Options(**kw), packed, device="cpu")
    jax = jax_sketch_fastx(JOptions(**kw), packed)
    for attr in ("signatures", "cardinalities", "kmers", "kmercounts"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr))
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(jax, attr))


def test_counting_route_reads_compressed_inputs(groups, tmp_path):
    """FullSetSketch jobs read .gz inputs with the native reader and
    .xz/.bz2 with the Python parser: the registers of plain inputs."""
    import bz2
    import gzip
    import lzma
    opts = Dashing2Options(k=21, sketchsize=64,
                           kmer_result=KmerSketchResultType.FULL_SETSKETCH)
    plain = [g.split()[0] for g in groups[:3]]
    packed = []
    for p, (suffix, opener) in zip(plain, ((".gz", gzip.open),
                                           (".xz", lzma.open),
                                           (".bz2", bz2.open))):
        out = str(tmp_path / (p.rsplit("/", 1)[-1] + suffix))
        with open(p, "rb") as f, opener(out, "wb") as g:
            g.write(f.read())
        packed.append(out)
    want = sketch_fastx(opts, plain, device="cpu")
    got = sketch_fastx(opts, packed, device="cpu")
    np.testing.assert_array_equal(got.signatures, want.signatures)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)
