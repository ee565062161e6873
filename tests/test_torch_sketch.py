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
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import Alphabet, KmerSketchResultType
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
    dict(kmer_result=KmerSketchResultType.FULL_MMER_SET),
    dict(count_threshold=2.0), dict(save_kmers=True),
    dict(filterset_path="some.fs"),
])
def test_configs_outside_the_file_driver_raise(groups, opts):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sketch_fastx(Dashing2Options(k=21, sketchsize=64, **opts), groups)


def test_xz_inputs_raise(groups):
    with pytest.raises(NotImplementedError, match="xz"):
        sketch_fastx(Dashing2Options(k=21, sketchsize=64),
                     groups + ["x.fa.xz"])
