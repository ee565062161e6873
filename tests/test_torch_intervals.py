"""Port parity for the interval inputs (--bed, --bigwig, --leafcutter), on
the CPU, against the JAX package run in the same process.

Mirrors tests/test_subcommands.py's BED, BigWig and LeafCutter cases at a
small size:

* the sketchers' registers and cardinalities (sketch_bed, sketch_bigwig
  with and without --by-chrom, sketch_leafcutter) against the JAX
  functions: one-permutation, FullSetSketch (registers within CSS_ULP
  ulp: the port's own f64 log against XLA's, as in test_torch_fss.py),
  -B and -P (bit for bit), with --normalize-intervals, and BigWig tracks
  holding zero and negative values, which the weighted draws mask;
* the CLI's comparison and `-o` bytes against dashing2_tpu.cli (the
  FullSetSketch `-o` registers within CSS_ULP ulp);
* batching items into draws and a pool of -p threads change nothing;
* the errors the JAX package raises: edit distance for BED, and
  --normalize-intervals in set space;
* the port's copy of the BigWig reader against the JAX reader.
"""

import numpy as np
import pytest

import dashing2_tpu.cli as jax_cli
from dashing2_tpu.config import Dashing2Options as JOptions
from dashing2_tpu.io import bigwig as JBW
from dashing2_tpu.sketch import intervals as JI
from dashing2_tpu_torch import cli
from dashing2_tpu_torch.config import Dashing2Options
from dashing2_tpu_torch.enums import DataType
from dashing2_tpu_torch.io import bigwig as PBW
from dashing2_tpu_torch.sketch import intervals as PI
from test_subcommands import _write_bigwig_multi

CSS_ULP = 4
M = 64

# sketch spaces: (sspace, kmer_result) for the options, and the CLI flags
SPACES = {"set": (0, 0, []), "fss": (0, 1, ["--full-setsketch"]),
          "bmh": (1, 1, ["-B"]), "pmh": (2, 1, ["-P"])}


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a.view(np.int64) - b.view(np.int64))
    return np.where(a == b, 0, d)


@pytest.fixture(scope="module")
def beds(tmp_path_factory):
    """Three BED files over three chromosomes: shared, overlapping and
    zero-length intervals, a comment and a blank line."""
    d = tmp_path_factory.mktemp("bed")
    rng = np.random.default_rng(5)
    shared = [f"chr1\t{s}\t{s + 80}" for s in range(0, 4000, 400)]
    paths = []
    for i in range(3):
        lines = ["# peaks", ""] + shared
        for c in ("chr2", "chrX", "3"):
            for s in np.sort(rng.integers(0, 20000, 12)):
                lines.append(f"{c}\t{s}\t{s + int(rng.integers(0, 150))}"
                             "\tpeak\t0")
        p = d / f"p{i}.bed"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


def _tracks(d, rng, n: int = 3):
    """BigWig tracks of two chromosomes whose values include 0 and
    negative numbers (one chromosome of the last track is all zeros)."""
    paths = []
    for i in range(n):
        ivs = {}
        for c in ("chr1", "chr2"):
            s = np.sort(rng.choice(3000, 50, replace=False)) * 7
            vals = rng.choice([0.0, -1.5, 2.0, 3.25, 0.5, 7.0], 50)
            if i == n - 1 and c == "chr2":
                vals = np.zeros(50)
            ivs[c] = [(int(a), int(a + rng.integers(1, 6)), float(v))
                      for a, v in zip(s, vals)]
        p = str(d / f"t{i}.bw")
        _write_bigwig_multi(p, ivs)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def bigwigs(tmp_path_factory):
    return _tracks(tmp_path_factory.mktemp("bw"), np.random.default_rng(6))


@pytest.fixture(scope="module")
def leafcutter(tmp_path_factory):
    """A perind counts file: num/denom tokens, zero counts, an empty
    denominator and a bare count; sites that differ only in their
    cluster id (the fourth field) are one splice site."""
    d = tmp_path_factory.mktemp("lf")
    rng = np.random.default_rng(7)
    lines = ["chrom s1 s2 s3 s4"]
    for j in range(40):
        toks = [f"{rng.integers(0, 5)}/{rng.integers(1, 9)}"
                for _ in range(4)]
        if j % 9 == 0:
            toks[1] = f"{rng.integers(1, 5)}/"
        if j % 11 == 0:
            toks[2] = str(rng.integers(0, 3))
        lines.append(f"chr1:{100 * (j % 30)}:{100 * (j % 30) + 50}:clu_{j} "
                     + " ".join(toks))
    p = d / "run_perind.counts"
    p.write_text("\n".join(lines) + "\n")
    return [str(p)]


def _opts(space: str, dtype, **kw):
    sspace, kres, _ = SPACES[space]
    return (Dashing2Options(sketchsize=M, sspace=sspace, kmer_result=kres,
                            dtype=dtype, **kw),
            JOptions(sketchsize=M, sspace=sspace, kmer_result=kres,
                     dtype=int(dtype), **kw))


def _hold(got, want, space: str):
    assert got.names == want.names
    assert got.signatures.dtype == want.signatures.dtype == np.float64
    assert got.signatures.shape == want.signatures.shape
    if space == "fss":
        assert _ulps(got.signatures, want.signatures).max() <= CSS_ULP
        assert _ulps(got.cardinalities, want.cardinalities).max() <= CSS_ULP
        assert np.array_equal(got.signatures == 0, want.signatures == 0)
        return
    np.testing.assert_array_equal(got.signatures.view(np.int64),
                                  want.signatures.view(np.int64))
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)


# set space refuses --normalize-intervals for BED (tested below)
@pytest.mark.parametrize("space,normalize", [
    (s, False) for s in sorted(SPACES)] + [("bmh", True), ("pmh", True)])
def test_sketch_bed_equals_jax(beds, space, normalize):
    po, jo = _opts(space, DataType.BED, bed_normalize=normalize)
    groups = beds + [" ".join(beds[:2])]
    got = PI.sketch_bed(po, groups, device="cpu")
    want = JI.sketch_bed(jo, groups)
    _hold(got, want, space)
    assert (got.cardinalities > 0).all()


@pytest.mark.parametrize("by_chrom", [False, True])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_sketch_bigwig_equals_jax(bigwigs, space, by_chrom):
    po, jo = _opts(space, DataType.BIGWIG, by_chrom=by_chrom)
    groups = bigwigs + [" ".join(bigwigs[1:])]
    got = PI.sketch_bigwig(po, groups, device="cpu")
    want = JI.sketch_bigwig(jo, groups)
    _hold(got, want, space)
    if by_chrom:
        assert got.names[0].endswith(":chr1") and len(got.names) == 8
    if space in ("bmh", "pmh"):
        # the all-zero chromosome drops out of the weighted spaces
        zero = [i for i, nm in enumerate(got.names)
                if nm == bigwigs[-1] + ":chr2"]
        assert all(got.cardinalities[i] == 0 for i in zero)
        assert all((got.signatures[i] == 0).all() for i in zero)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("space", sorted(SPACES))
def test_sketch_leafcutter_equals_jax(leafcutter, space, normalize):
    po, jo = _opts(space, DataType.LEAFCUTTER, bed_normalize=normalize)
    got = PI.sketch_leafcutter(po, leafcutter, device="cpu")
    want = JI.sketch_leafcutter(jo, leafcutter)
    _hold(got, want, space)
    assert got.names[0] == "s1:" + leafcutter[0][:-len("_perind.counts")]


def _files(tmp_path, tag: str):
    return {s: str(tmp_path / f"{tag}.{s}") for s in ("bin", "sig")}


def _both(argv, tmp_path):
    """The port's and the JAX CLI's comparison and -o bytes."""
    out = {}
    for tag, main, extra in (("p", cli.main, ["--device", "cpu"]),
                             ("j", jax_cli.main, [])):
        f = _files(tmp_path, tag)
        assert main(argv + ["--binary-output", "--cmpout", f["bin"], "-o",
                            f["sig"]] + extra) == 0
        out[tag] = {s: open(p, "rb").read() for s, p in f.items()}
        out[tag]["names"] = open(f["sig"] + ".names.txt").read()
    return out["p"], out["j"]


def _hold_cli(got, want, space: str):
    assert got["bin"] == want["bin"]
    if space != "fss":
        assert got["names"] == want["names"]
        assert got["sig"] == want["sig"]
        return
    # the names file's cardinalities are m / sum(registers)
    gl = [ln.split("\t") for ln in got["names"].splitlines()]
    wl = [ln.split("\t") for ln in want["names"].splitlines()]
    assert gl[0] == wl[0] and [a[0] for a in gl] == [b[0] for b in wl]
    assert _ulps([float(a[1]) for a in gl[1:]],
                 [float(b[1]) for b in wl[1:]]).max() <= CSS_ULP
    g = np.frombuffer(got["sig"], np.uint8)
    w = np.frombuffer(want["sig"], np.uint8)
    assert len(g) == len(w)
    assert (g[:16] == w[:16]).all()
    assert _ulps(g[16:].view(np.float64), w[16:].view(np.float64)).max() \
        <= CSS_ULP


CLI_BED = {"set": [], "fss": ["--full-setsketch"],
           "bmh-norm": ["-B", "--normalize-intervals"], "pmh": ["-P"],
           "pmh-norm-mash": ["-P", "--normalize-intervals",
                             "--mash-distance"],
           "bmh-containment": ["-B", "--containment"],
           # --by-chrom is ignored for BED, as in the JAX CLI
           "set-by-chrom": ["--by-chrom"],
           "bmh-by-chrom": ["-B", "--by-chrom"]}


@pytest.mark.parametrize("job", sorted(CLI_BED))
def test_cli_bed_bytes_equal_jax(beds, job, tmp_path):
    got, want = _both(["sketch", "--bed", "-S", str(M)] + CLI_BED[job]
                      + beds, tmp_path)
    _hold_cli(got, want, "fss" if job == "fss" else job)
    assert len(got["bin"]) == 4 * 3


CLI_BW = {"set": [], "fss": ["--full-setsketch"], "bmh": ["-B"],
          "pmh": ["-P"], "set-by-chrom": ["--by-chrom"],
          "bmh-by-chrom": ["-B", "--by-chrom"],
          "pmh-by-chrom": ["-P", "--by-chrom"]}


@pytest.mark.parametrize("job", sorted(CLI_BW))
def test_cli_bigwig_bytes_equal_jax(bigwigs, job, tmp_path):
    got, want = _both(["sketch", "--bigwig", "-S", str(M)] + CLI_BW[job]
                      + bigwigs, tmp_path)
    _hold_cli(got, want, job)


CLI_LF = {"set": [], "fss": ["--full-setsketch"], "bmh": ["-B"],
          "pmh": ["-P"], "pmh-norm": ["-P", "--normalize-intervals"],
          # --by-chrom is ignored for LeafCutter, as in the JAX CLI
          "pmh-by-chrom": ["-P", "--by-chrom"]}


@pytest.mark.parametrize("job", sorted(CLI_LF))
def test_cli_leafcutter_bytes_equal_jax(leafcutter, job, tmp_path):
    got, want = _both(["sketch", "--leafcutter", "-S", str(M)]
                      + CLI_LF[job] + leafcutter, tmp_path)
    _hold_cli(got, want, job)
    assert len(got["bin"]) == 4 * 4 * 3 // 2


@pytest.mark.parametrize("space", ["fss", "bmh", "pmh"])
def test_batches_and_threads_change_nothing(beds, bigwigs, space,
                                            monkeypatch):
    """Draws in batches of a few items, items prepared in a pool of
    threads: the registers of one batch, prepared in order."""
    po, _ = _opts(space, DataType.BIGWIG, by_chrom=True)
    want = PI.sketch_bigwig(po, bigwigs, device="cpu")
    monkeypatch.setattr(PI, "BATCH_POSITIONS", 150)
    po.nthreads = 3
    got = PI.sketch_bigwig(po, bigwigs, device="cpu")
    assert got.names == want.names
    np.testing.assert_array_equal(got.signatures, want.signatures)
    np.testing.assert_array_equal(got.cardinalities, want.cardinalities)


@pytest.mark.parametrize("flags,message", [
    (["-E"], "edit distance for BED"),
    (["--normalize-intervals"], "normalize BED rows in set space"),
    (["--full-setsketch", "--normalize-intervals"],
     "normalize BED rows in set space")])
def test_bed_errors_equal_jax(beds, flags, message, tmp_path, capsys):
    argv = ["sketch", "--bed", "-S", str(M), "--cmpout",
            str(tmp_path / "o.bin")] + flags + beds
    assert cli.main(argv + ["--device", "cpu"]) == 1
    port_err = capsys.readouterr().err
    assert jax_cli.main(argv) == 1
    jax_err = capsys.readouterr().err
    assert message in port_err and message in jax_err
    assert port_err.split("error: ")[1] == jax_err.split("error: ")[1]
    assert not (tmp_path / "o.bin").exists()


def test_fasta_by_chrom_stays_refused(tmp_path, capsys):
    """--by-chrom with FASTA inputs: the JAX CLI sketches the files as
    without it (on its chunked route), and so does the port since the
    chunked route: the JAX CLI's bytes."""
    fa = tmp_path / "a.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n"
                  ">b\nACGTTGCATGCAACGTAGCTAGCTAGGATCGATCGAT\n")
    fb = tmp_path / "b.fa"
    fb.write_text(">c\nACGTACGTACGTACGTACGTACGTACGTTTTTACGT\n")
    outs = []
    for tag, fn, extra in (("p", cli.main, ["--device", "cpu"]),
                           ("j", jax_cli.main, [])):
        out = tmp_path / f"{tag}.out"
        assert fn(["sketch", "--by-chrom", "-k", "15", "-S", "64",
                   "--binary-output", "--cmpout", str(out), str(fa), str(fb),
                   str(fa)] + extra) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) == 12
    assert "error" not in capsys.readouterr().err


def _write_bigwig_blocks(path, chrom_intervals, per_block: int):
    """Like test_subcommands._write_bigwig_multi, with `per_block` items
    a block, so that a chromosome spans several blocks and R-tree
    leaves, and a bedGraph, a variable-step and a fixed-step block."""
    import struct
    import zlib
    names = list(chrom_intervals)
    key_size = max(len(n.encode()) for n in names)
    chrom_tree = struct.pack("<IIIIQQ", 0x78CA8C91, len(names), key_size,
                             8, len(names), 0)
    chrom_tree += struct.pack("<BBH", 1, 0, len(names))
    for cid, n in enumerate(names):
        chrom_tree += n.encode().ljust(key_size, b"\0") + \
            struct.pack("<II", cid, 1000000)
    data_off = 64 + len(chrom_tree)
    blocks = []
    for cid, n in enumerate(names):
        ivs = chrom_intervals[n]
        for b in range(0, len(ivs), per_block):
            part = ivs[b:b + per_block]
            kind = (b // per_block) % 3
            if kind == 0:
                items = b"".join(struct.pack("<IIf", s, e, v)
                                 for (s, e, v) in part)
                hdr = (0, 0, 1)
            elif kind == 1:
                items = b"".join(struct.pack("<If", s, v)
                                 for (s, e, v) in part)
                hdr = (0, part[0][1] - part[0][0], 2)
            else:
                items = b"".join(struct.pack("<f", v) for (s, e, v) in part)
                hdr = (part[1][0] - part[0][0] if len(part) > 1 else 1,
                       part[0][1] - part[0][0], 3)
            block = struct.pack("<IIIIIBBH", cid, part[0][0], part[-1][1],
                                hdr[0], hdr[1], hdr[2], 0, len(part)) + items
            blocks.append((cid, part[0][0], part[-1][1],
                           zlib.compress(block)))
    data = struct.pack("<Q", len(blocks))
    leaf_meta = []
    for cid, s0, e0, comp in blocks:
        leaf_meta.append((cid, s0, e0, data_off + len(data), len(comp)))
        data += comp
    index_off = data_off + len(data)
    rtree = struct.pack("<IIQIIIIQIi", 0x2468ACE0, 256, len(blocks),
                        0, leaf_meta[0][1], len(names) - 1,
                        leaf_meta[-1][2], index_off, 512, 0)
    rtree += struct.pack("<BBH", 1, 0, len(blocks))
    for cid, s0, e0, off, size in leaf_meta:
        rtree += struct.pack("<IIIIQQ", cid, s0, cid, e0, off, size)
    hdr = struct.pack("<IHHQQQHHQQIQ", 0x888FFC26, 4, 0, 64, data_off,
                      index_off, 0, 0, 0, 0, 1 << 15, 0)
    with open(path, "wb") as f:
        f.write(hdr + chrom_tree + data + rtree)


def test_bigwig_reader_equals_jax(tmp_path):
    """The port's BigWigReader decodes every block kind, whole-file and
    per chromosome, as the JAX reader does."""
    rng = np.random.default_rng(8)
    ivs = {}
    for c in ("chr1", "chr2", "chrM"):
        # equal spans and steps, as variable- and fixed-step blocks hold
        s = np.arange(40) * 10 + int(rng.integers(0, 1000))
        ivs[c] = [(int(a), int(a + 4), float(v))
                  for a, v in zip(s, rng.normal(size=40).astype(np.float32))]
    p = str(tmp_path / "blocks.bw")
    _write_bigwig_blocks(p, ivs, per_block=7)
    with PBW.BigWigReader(p) as pr, JBW.BigWigReader(p) as jr:
        assert pr.chroms == jr.chroms and pr.chrom_sizes == jr.chrom_sizes
        assert pr.leaves == jr.leaves and len(pr.leaves) == 18
        for cid in (None, 0, 1, 2):
            got = list(pr.iter_blocks(chrom_id=cid))
            want = list(jr.iter_blocks(chrom_id=cid))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g[0] == w[0]
                for a, b in zip(g[1:], w[1:]):
                    np.testing.assert_array_equal(a, b)
    po, jo = _opts("pmh", DataType.BIGWIG)
    got = PI.sketch_bigwig(po, [p], device="cpu")
    want = JI.sketch_bigwig(jo, [p])
    _hold(got, want, "pmh")


def test_string_hash_equals_jax():
    for s in ("", "1", "chr1", "X", "chr1:100:200", "ü-site"):
        assert PI.string_hash64(s) == JI.string_hash64(s)


@pytest.mark.parametrize("space", ["fss", "bmh"])
def test_draws_on_cuda_without_a_card_raise(beds, space):
    """The FullSetSketch and weighted rows draw on the device they are
    given: a CUDA request without a card raises, nothing falls back."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    po, _ = _opts(space, DataType.BED)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PI.sketch_bed(po, beds, device="cuda")
