"""Port parity for the edit-distance space (`-E`) through the CLI, on the
CPU: the port's `sketch`/`cmp` (`--device cpu`) against dashing2_tpu.cli
with the same argv, byte for byte.

* `-E --parse-by-seq` over a FASTA of edited families (io/corpus.py
  `edited_sequences`: substitutions, insertions and deletions, N runs
  and poly-A tracts), at n = 24 (the JAX numpy route) and n = 72 (its
  jitted route), with full registers (equality-compared OMH words) and
  `--fastcmp 0.5/1/2/4` (their low bits), in binary, PHYLIP, TSV and
  the asymmetric square, and a `-Q` panel;
* exact edit distances: `--compute-edit-distance` all pairs (upper
  triangle, square, panel) and `--exact-kmer-dist`;
* the neighbour jobs: `--topk 2` (registers, exact distances,
  `--refine-exact`), `-T`, `--greedy 0.3f` (FASTA out) and
  `--greedy 0.3`, and a non-`-E` `--greedy ...f` (empty sequence
  lines);
* whole-file `-E` (records concatenated, one item a file), `cmp -E`,
  `-o`, `--seqs-in-ram`, and a store spilled to disk;
* `from_reference` carrying the JAX result's `sequences`.

Tolerance zero: equal bytes.
"""

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.config import Dashing2DistOptions as JOptions
from dashing2_tpu.enums import Measure as JMeasure
from dashing2_tpu.enums import SketchSpace as JSpace
from dashing2_tpu.sketch.core import sketch_fastx as jax_sketch_fastx
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.cmp import core as PC
from dashing2_tpu_torch.config import Dashing2DistOptions
from dashing2_tpu_torch.enums import Measure, SketchSpace
from dashing2_tpu_torch.io import seqstore as PS
from dashing2_tpu_torch.io.corpus import (edited_sequences, write_corpus,
                                          write_fasta)
from dashing2_tpu_torch.result import from_reference

K = ["-k", "15", "-S", "64"]


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("edit")
    small = edited_sequences(7, 6, 4, length=(150, 400), n_every=7,
                             polya_every=5)
    small.append(("short", b"ACGTACG"))          # shorter than k
    big = edited_sequences(8, 9, 8, length=(100, 300), n_every=11,
                           polya_every=13)
    files = [write_fasta(str(d / f"f{i}.fa"), small[i * 5:(i + 1) * 5])
             for i in range(5)]
    return {"small": write_fasta(str(d / "small.fa"), small),
            "big": write_fasta(str(d / "big.fa"), big),
            "files": files}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both(argv, tmp_path):
    got, want = str(tmp_path / "p.out"), str(tmp_path / "j.out")
    assert cli.main(argv + ["--cmpout", got, "--device", "cpu"]) == 0
    assert jax_cli.main(argv + ["--cmpout", want]) == 0
    return _read(got), _read(want)


FORMATS = {"binary": ["--binary-output"], "tsv": [],
           "phylip": ["--phylip"],
           "asym": ["--asymmetric-all-pairs", "--binary-output"]}
REGS = {"full": [], "nibble": ["--fastcmp", "0.5"], "u8": ["--fastcmp", "1"],
        "u16": ["--fastcmp", "2"], "u32": ["--fastcmp", "4"]}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("regs", sorted(REGS))
def test_registers_all_pairs_equal_jax(fastas, regs, fmt, tmp_path):
    got, want = _both(["sketch", "-E", "--parse-by-seq"] + K + REGS[regs]
                      + FORMATS[fmt] + [fastas["small"]], tmp_path)
    assert got == want and len(got) > 0


@pytest.mark.parametrize("regs", sorted(REGS))
def test_registers_jitted_route_equal_jax(fastas, regs, tmp_path):
    """n = 72: the JAX package's jitted self-pairs route."""
    got, want = _both(["sketch", "-E", "--parse-by-seq", "--binary-output"]
                      + K + REGS[regs] + [fastas["big"]], tmp_path)
    assert got == want and len(got) == 4 * 72 * 71 // 2


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("flag", ["--compute-edit-distance",
                                  "--exact-kmer-dist"])
def test_exact_edit_distances_equal_jax(fastas, flag, fmt, tmp_path):
    got, want = _both(["sketch", "-E", "--parse-by-seq", flag] + K
                      + FORMATS[fmt] + [fastas["small"]], tmp_path)
    assert got == want
    if fmt == "binary" and flag == "--compute-edit-distance":
        vals = np.frombuffer(got, np.float32)
        assert (vals == np.round(vals)).all() and vals.max() > 100


@pytest.mark.parametrize("extra", [[], ["--compute-edit-distance"],
                                   ["--fastcmp", "1"]])
def test_panel_equal_jax(fastas, extra, tmp_path):
    refs, queries = tmp_path / "refs.txt", tmp_path / "q.txt"
    refs.write_text("\n".join(fastas["files"][:3]) + "\n")
    queries.write_text("\n".join(fastas["files"][3:]) + "\n")
    got, want = _both(["sketch", "-E", "--parse-by-seq", "--binary-output",
                       "-F", str(refs), "-Q", str(queries)] + K + extra,
                      tmp_path)
    # -Q counts query lines, here files, not their records (as in the
    # JAX package): 23 references by the last 2 items
    assert got == want and len(got) == 4 * 23 * 2


GRAPH = {"topk-regs": ["--topk", "2", "--binary-output"],
         "topk-ed": ["--topk", "2", "--compute-edit-distance",
                     "--binary-output"],
         "topk-refine": ["--topk", "3", "--refine-exact"],
         "topk-u8-refine": ["--topk", "2", "--fastcmp", "1",
                            "--refine-exact", "--binary-output"],
         "threshold": ["-T", "0.2"],
         "greedy-fasta": ["--greedy", "0.3f"],
         "greedy-ed-fasta": ["--greedy", "60f", "--compute-edit-distance"],
         "greedy": ["--greedy", "0.3", "--binary-output"],
         "greedy-exhaustive-fasta": ["--greedy", "0.3ef"]}


@pytest.mark.parametrize("job", sorted(GRAPH))
@pytest.mark.parametrize("fasta", ["small", "big"])
def test_neighbour_jobs_equal_jax(fastas, fasta, job, tmp_path):
    got, want = _both(["sketch", "-E", "--parse-by-seq"] + K + GRAPH[job]
                      + [fastas[fasta]], tmp_path)
    assert got == want and len(got) > 0
    if job == "greedy-fasta":
        # every representative's record is its input sequence
        from dashing2_tpu_torch.io.fastx import read_fastx
        seqs = dict(read_fastx(fastas[fasta]))
        lines = got.decode().split("\n")
        for hdr, seq in zip(lines[0::2], lines[1::2]):
            name = hdr.split()[0].split("_", 1)[1]
            assert seqs[name].decode() == seq


def test_fasta_dedup_without_sequences_equal_jax(tmp_path):
    """--greedy ...f outside -E writes an empty line for each sequence,
    as the JAX package does."""
    paths = write_corpus(str(tmp_path / "c"), 3, 3, 3, 2000)
    got, want = _both(["sketch", "-k", "21", "-S", "64", "--greedy",
                       "0.5f"] + paths, tmp_path)
    assert got == want and b"\n\n" in got


@pytest.mark.parametrize("extra", [[], ["--compute-edit-distance"],
                                   ["--fastcmp", "2", "--phylip"]])
def test_whole_file_edit_distance_equal_jax(fastas, extra, tmp_path):
    """Without --parse-by-seq each file is one item, its records
    concatenated."""
    got, want = _both(["sketch", "-E", "--binary-output"] + K + extra
                      + fastas["files"], tmp_path)
    assert got == want


def test_cmp_and_sketch_outputs_equal_jax(fastas, tmp_path, capsys):
    argv = ["cmp", "-E", "--parse-by-seq"] + K + [fastas["small"]]
    capsys.readouterr()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    assert got == capsys.readouterr().out and got
    sig_p, sig_j = str(tmp_path / "p.sig"), str(tmp_path / "j.sig")
    base = ["sketch", "-E", "--parse-by-seq"] + K + [fastas["small"]]
    assert cli.main(base + ["-o", sig_p, "--device", "cpu"]) == 0
    assert jax_cli.main(base + ["-o", sig_j]) == 0
    assert _read(sig_p) == _read(sig_j)
    assert _read(sig_p + ".names.txt") == _read(sig_j + ".names.txt")


@pytest.mark.parametrize("extra", [["--seqs-in-ram"], ["--spill"]])
def test_sequence_store_routes_equal_jax(fastas, extra, tmp_path,
                                         monkeypatch):
    """--seqs-in-ram, and a store spilled to an unlinked temp file (the
    threshold set to 1 byte in the port only): the JAX bytes."""
    if extra == ["--spill"]:
        monkeypatch.setattr(PS, "RAM_THRESHOLD", 1)
        extra = []
    argv = ["sketch", "-E", "--parse-by-seq", "--compute-edit-distance",
            "--binary-output"] + K + extra + [fastas["small"]]
    got, want = _both(argv, tmp_path)
    assert got == want
    got, want = _both(["sketch", "-E", "--parse-by-seq", "--greedy",
                       "0.2f"] + K + extra + [fastas["small"]], tmp_path)
    assert got == want


def test_from_reference_carries_sequences(fastas):
    kw = dict(k=15, sketchsize=64, sspace=JSpace.SPACE_EDIT_DISTANCE,
              parse_by_seq=True, measure=JMeasure.M_EDIT_DISTANCE)
    ref = jax_sketch_fastx(JOptions(**kw), [fastas["small"]])
    res = from_reference(ref)
    assert isinstance(res.sequences, list)
    assert res.sequences == list(ref.sequences)
    assert all(isinstance(s, bytes) for s in res.sequences)
    opts = Dashing2DistOptions(k=15, sketchsize=64,
                               sspace=SketchSpace.SPACE_EDIT_DISTANCE,
                               parse_by_seq=True,
                               measure=Measure.M_EDIT_DISTANCE)
    from dashing2_tpu.cmp import core as JC
    got = np.concatenate([b for _, b in PC.pairwise_matrix(
        opts, res, block=7, device="cpu")])
    want = np.concatenate([b for _, b in JC.pairwise_matrix(
        JOptions(**kw), ref, block=7)])
    n = res.n
    iu = np.triu_indices(n, 1)
    np.testing.assert_array_equal(got[iu], want[iu])
    ia, ib = np.array([0, 3, 5]), np.array([1, 2, 5])
    np.testing.assert_array_equal(
        PC.measure_pairs(opts, res, PC.CompressedReps(data=None), ia, ib,
                         device="cpu"),
        JC.measure_pairs(JOptions(**kw), ref, JC.CompressedReps(data=None),
                         ia, ib))
