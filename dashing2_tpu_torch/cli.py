"""dashing2-compatible command-line interface of the PyTorch/CUDA port.

Port of dashing2_tpu/cli.py: `_add_shared` and `_build_opts` are copies,
so flags keep their reference names and build the same options. Five
subcommands exist, and they run only the slices the port covers:

* `sketch`: native sketching of FASTA/FASTQ inputs, one-permutation by
  default, FullSetSketch with `--full-setsketch` (also `-m` > 1, which
  counts k-mers and ends in FullSetSketch), its registers quantised with
  `--setsketch-ab a,b` or `--fastcmp-bytes/-shorts/-words`, the
  weighted sketches `-B` (`--multiset`) and `-P` (`--prob`), whose
  counts `-c` turns into a CountSketch's, or the exact k-mer sets
  (`--set`) and count dictionaries (`--countdict`; u128 keys with
  `--long-kmers`), or the minimizer sequences (`--seq`, with
  `--hp-compress`; u128 tokens with `--long-kmers`), or OrderMinHash
  registers in the edit-distance space (`-E`, one item a record with
  `--parse-by-seq`, the raw sequences kept, `--seqs-in-ram`); or of
  interval inputs, `--bed`, `--bigwig` (with `--by-chrom`, one item a
  chromosome) and `--leafcutter`, in set space, FullSetSketch or -B/-P
  (`--normalize-intervals`). `-o` writes the stacked signatures
  (the stacked minimizer sequences of `--seq`; nothing for exact
  sets), with `-s` the k-mer database
  `<-o>.kmer64` and with `-N` its counts `<-o>.kmercounts.f64` (FASTA
  one-permutation jobs). `--cache` (`-W`) loads each FASTA item's
  sketch artifact where it exists and writes it where it does not (in
  `--outprefix` when given; not with `--parse-by-seq` or `-E`, as in
  the JAX package). With --cmpout, the comparison:
* `cmp` (alias `dist`): sketch and compare, or with `--presketched`
  compare stacked signature files (`-o` output, with its .names.txt),
  single sketch caches (.opss, .ss, .bmh, .pmh), exact k-mer set
  caches (.kmerset64, .kmerset128) and minimizer sequences (.mmerseq64,
  .mmerseq128; with a <stem>kmercounts.f64 of as many counts, a count
  dictionary); the output goes to stdout without --cmpout.

The comparison is the all-pairs matrix of any measure (similarity,
`--mash-distance`, `--containment`, `--symmetric-containment`,
`--intersection`, `--union-size`) over the full registers (no
`--fastcmp`, or `--fastcmp 8`; `--f32-registers` compares them rounded
to f32, and `--bbit-sigs` compares their bits for equality), over
`--fastcmp 0.5`, `1`, `2` or `4` registers (nibbles, u8, u16, u32), b-bit
(`--bbit-sigs`) or SetSketch a/b quantised (without it), or over the
registers a sketch-compressed job quantised, over the weighted
registers (compared for equality, or quantised by `--fastcmp`), or over
exact sets (their intersections joined on the card), or over minimizer
sequences (their span edit distances, on the host); emitted as binary f32,
PHYLIP, the symmetric TSV or, with `--asymmetric-all-pairs`, the full
square; with `-Q`, the references-by-queries panel; and the LSH
neighbour jobs (`--topk`, `--similarity-threshold`, `--greedy`,
`--index-save`/`--index-load`, `--refine-exact`; over exact
sets a bottom-k index), emitted as CSR or text (cmp/graph.py);
`--greedy ...f` writes the clusters as FASTA. An `-E` job compares its
registers like full registers compared for equality (or their low bits
with `--fastcmp`), or with `--compute-edit-distance` or
`--exact-kmer-dist` computes exact edit distances (cmp/editdist.py);
these two flags run with `-E` and `--seq` only.
`--pairlist` sketches the unique paths it names and compares them
all-pairs, as the reference does.

* `wsketch`: pre-aggregated weighted sets (flat or CSR binary vectors),
  sketch/wsketch.py;
* `contain`: coverage of queries against a `.kmer64` database,
  cmp/contain.py;
* `printmin`: a `--seq -o` file as text (io/printmin.py).

Every other option is rejected with an error naming it. `--device`
(default cuda) picks where the CSetSketch and weighted draws, the
exact-set joins, the contain lookup and the comparison run; a CUDA
request without a card exits non-zero and never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import Dashing2DistOptions
from .enums import (Alphabet, DataType, KmerSketchResultType, Measure,
                    OutputFormat, OutputKind, SketchSpace)
from .result import SketchingResult


def _add_shared(p: argparse.ArgumentParser) -> None:
    p.add_argument("paths", nargs="*", help="input files")
    p.add_argument("-F", "--ffile", help="read input paths from file")
    p.add_argument("-Q", "--qfile", help="query paths (panel mode)")
    p.add_argument("-p", "--threads", type=int, default=0)
    p.add_argument("-S", "--sketchsize", type=int, default=1024)
    p.add_argument("-L", "--sketch-size-l2", type=int, dest="ssl2")
    p.add_argument("--cmpout", "--distout", "--cmp-outfile", dest="cmpout")
    p.add_argument("--outprefix", "--prefix", dest="outprefix", default="")
    p.add_argument("-K", "--topk", "--top-k", dest="topk", type=int)
    p.add_argument("-T", "--similarity-threshold", dest="simthresh",
                   type=float)
    p.add_argument("--greedy", type=str)
    p.add_argument("--fastcmp", "--regsize", "--regbytes", dest="fastcmp",
                   type=float)
    p.add_argument("--fastcmp-nibbles", action="store_true",
                   help="same as --fastcmp 0.5 (listed but disabled in "
                        "the reference's option table, options.h:126,214)")
    p.add_argument("--fastcmp-bytes", action="store_true")
    p.add_argument("--fastcmp-shorts", action="store_true")
    p.add_argument("--fastcmp-words", action="store_true")
    p.add_argument("--bbit-sigs", action="store_true")
    p.add_argument("-c", "--countsketch-size", "--countmin-size",
                   dest="cssize", type=int, default=0)
    p.add_argument("-k", "--kmer-length", dest="k", type=int, default=31)
    p.add_argument("-w", "--window-size", dest="w", type=int, default=-1)
    p.add_argument("-o", "--outfile")
    p.add_argument("-m", "--count-threshold", "--threshold",
                   dest="count_threshold", type=float, default=0)
    p.add_argument("--binary-output", "--emit-binary", "--binary",
                   dest="binary_output", action="store_true")
    p.add_argument("-P", "--prob", "--probs", "--pminhash", "--pmh",
                   "--probminhash", dest="prob", action="store_true")
    p.add_argument("-B", "--multiset", "--bagminhash", "--bmh",
                   dest="multiset", action="store_true")
    p.add_argument("--bed", action="store_true")
    p.add_argument("--bigwig", action="store_true")
    p.add_argument("--leafcutter", action="store_true")
    p.add_argument("-E", "--edit-distance", dest="edit_distance",
                   action="store_true")
    p.add_argument("--intersection", "--intersection-size", dest="isz",
                   action="store_true")
    p.add_argument("--union-size", dest="usz", action="store_true")
    p.add_argument("--mash-distance", "--distance", "--poisson-distance",
                   dest="mashdist", action="store_true")
    p.add_argument("--compute-edit-distance", dest="compute_edit",
                   action="store_true")
    p.add_argument("--symmetric-containment", dest="symcontain",
                   action="store_true")
    p.add_argument("--containment", action="store_true")
    p.add_argument("-H", "--set", dest="mmer_set", action="store_true")
    p.add_argument("-J", "--countdict", action="store_true")
    p.add_argument("-G", "--seq", dest="mmer_seq", action="store_true")
    p.add_argument("-2", "--128bit", "--long-kmers", dest="use128",
                   action="store_true")
    # registering "-2" flips argparse's negative-number heuristic so
    # EVERY "-<digit>" token parses as an option and flags reject
    # negative values ("-w -1", "--maxcand -1"). Reset the internal
    # marker: "-2" still resolves (exact option-string match precedes
    # the heuristic), while other negative numbers parse as values.
    p._has_negative_number_optionals[:] = []
    p.add_argument("--phylip", action="store_true")
    p.add_argument("--asymmetric-all-pairs", "--asymmetric", "--square",
                   dest="asym", action="store_true")
    p.add_argument("-s", "--save-kmers", dest="save_kmers",
                   action="store_true")
    p.add_argument("-N", "--save-kmercounts", dest="save_kmercounts",
                   action="store_true")
    p.add_argument("--hp-compress", dest="hpcompress", action="store_true")
    p.add_argument("--refine-exact", dest="refine_exact",
                   action="store_true")
    p.add_argument("-Z", "--oneperm-setsketch", "--oneperm", "--one-perm",
                   "--oph", "--doph", dest="oneperm", action="store_true")
    p.add_argument("--full", "--full-setsketch", dest="full",
                   action="store_true")
    p.add_argument("--normalize-intervals", dest="normalize_intervals",
                   action="store_true")
    p.add_argument("--protein", "--protein20", "--enable-protein",
                   dest="protein", action="store_true")
    p.add_argument("--protein6", action="store_true")
    p.add_argument("--protein8", action="store_true")
    p.add_argument("--protein14", action="store_true")
    p.add_argument("--downsample", type=float, default=1.0)
    p.add_argument("-W", "--cache", "--cache-sketches", dest="cache",
                   action="store_true")
    p.add_argument("-C", "--no-canon", dest="nocanon", action="store_true")
    p.add_argument("--exact-kmer-dist", dest="exact_kmer_dist",
                   action="store_true")
    p.add_argument("--spacing", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--filterset", default="")
    p.add_argument("--parse-by-seq", dest="parse_by_seq",
                   action="store_true")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=0)
    p.add_argument("--nlsh", "--nLSH", dest="nlsh", type=int, default=2)
    p.add_argument("--entmin", action="store_true")
    p.add_argument("--by-chrom", dest="by_chrom", action="store_true")
    p.add_argument("--sig-ram-limit", dest="sig_ram_limit", type=int)
    p.add_argument("--maxcand", type=int, default=-1)
    p.add_argument("--index-save", default="", metavar="PATH",
                   help="write the KNN/dedup LSH index after building "
                        "it; a .ssi suffix selects the reference's gz "
                        "layout (sketch::lsh::SetSketchIndex::write, "
                        "ssi.h:454-484), anything else the native "
                        "format")
    p.add_argument("--index-load", default="", metavar="PATH",
                   help="load a previously saved LSH index instead of "
                        "building one (.ssi = reference layout)")
    p.add_argument("--setsketch-ab", dest="setsketch_ab")
    p.add_argument("--pairlist")
    p.add_argument("--seqs-in-ram", dest="seqs_in_ram", action="store_true")
    p.add_argument("--f32-registers", dest="regt32", action="store_true",
                   help="compare full registers in f32 (the reference's "
                        "-DSKETCH_FLOAT_TYPE=float build, as a runtime "
                        "switch; ~1.4x faster full-register comparisons)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("--warm-only", type=int, default=0, metavar="N",
                   help="compile the compare programs for an announced "
                        "item count N under these flags, then exit (no "
                        "inputs needed). Through a resident worker "
                        "(DASHING2_TPU_DAEMON / `serve --warm`) this "
                        "pre-pays the XLA compile wall so the real job "
                        "runs at the warm rate")


def _build_opts(a: argparse.Namespace) -> Dashing2DistOptions:
    sketchsize = ((1 << a.ssl2) if a.ssl2 is not None
                  else a.sketchsize)
    sspace = SketchSpace.SPACE_SET
    kres = KmerSketchResultType.ONE_PERM
    if a.multiset:
        sspace = SketchSpace.SPACE_MULTISET
        kres = KmerSketchResultType.FULL_SETSKETCH
    if a.prob:
        sspace = SketchSpace.SPACE_PSET
        kres = KmerSketchResultType.FULL_SETSKETCH
    if a.edit_distance:
        sspace = SketchSpace.SPACE_EDIT_DISTANCE
    if a.full:
        kres = KmerSketchResultType.FULL_SETSKETCH
        if not (a.multiset or a.prob):
            sspace = SketchSpace.SPACE_SET
    if a.oneperm:
        kres = KmerSketchResultType.ONE_PERM
    if a.mmer_set:
        kres = KmerSketchResultType.FULL_MMER_SET
    if a.countdict:
        kres = KmerSketchResultType.FULL_MMER_COUNTDICT
    if a.mmer_seq:
        kres = KmerSketchResultType.FULL_MMER_SEQUENCE

    dtype = DataType.FASTX
    if a.bed:
        dtype = DataType.BED
    elif a.bigwig:
        dtype = DataType.BIGWIG
    elif a.leafcutter:
        dtype = DataType.LEAFCUTTER

    alphabet = Alphabet.DNA
    if a.protein:
        alphabet = Alphabet.PROTEIN20
    elif a.protein6:
        alphabet = Alphabet.PROTEIN_6
    elif a.protein8:
        alphabet = Alphabet.PROTEIN_3BIT
    elif a.protein14:
        alphabet = Alphabet.PROTEIN_14

    measure = Measure.SIMILARITY
    if a.isz:
        measure = Measure.INTERSECTION
    if a.usz:
        measure = Measure.UNION_SIZE
    if a.mashdist:
        measure = Measure.POISSON_LLR
    if a.symcontain:
        measure = Measure.SYMMETRIC_CONTAINMENT
    if a.containment:
        measure = Measure.CONTAINMENT
    if a.compute_edit:
        measure = Measure.M_EDIT_DISTANCE

    kind = OutputKind.SYMMETRIC_ALL_PAIRS
    if a.phylip:
        kind = OutputKind.PHYLIP
    if a.asym:
        kind = OutputKind.ASYMMETRIC_ALL_PAIRS
    if a.qfile:
        kind = OutputKind.PANEL
    num_neighbors = -1
    min_sim = -1.0
    exhaustive_dedup = fasta_dedup = False
    if a.topk is not None:
        kind = OutputKind.KNN_GRAPH
        num_neighbors = a.topk
    if a.simthresh is not None:
        kind = OutputKind.NN_GRAPH_THRESHOLD
        min_sim = a.simthresh
    if a.greedy is not None:
        kind = OutputKind.DEDUP
        g = a.greedy
        gv = ""
        for ch in g:
            if ch.lower() == "e":
                exhaustive_dedup = True
            elif ch.lower() == "f":
                fasta_dedup = True
            else:
                gv += ch
        min_sim = float(gv)

    fd = a.fastcmp if a.fastcmp is not None else 8.0
    ca = cb = -1.0
    if a.fastcmp_nibbles:
        fd = 0.5
    if a.fastcmp_bytes:
        ca, cb, fd = 20.0, 1.2, 1.0
    if a.fastcmp_shorts:
        ca, cb, fd = 0.06, 1.0005, 2.0
    if a.fastcmp_words:
        ca, cb, fd = 19.77, 1.0000000109723500835, 4.0
    if a.setsketch_ab:
        pa, pb = a.setsketch_ab.split(",")
        ca, cb = float(pa), float(pb)

    opts = Dashing2DistOptions(
        k=a.k, w=a.w, alphabet=alphabet, sspace=sspace, dtype=dtype,
        use128=a.use128, spacing=a.spacing, canonicalize=not a.nocanon,
        kmer_result=kres, parse_by_seq=a.parse_by_seq,
        sketchsize=sketchsize, count_threshold=a.count_threshold,
        cssize=a.cssize, save_kmers=a.save_kmers,
        save_kmercounts=a.save_kmercounts,
        homopolymer_compress_minimizers=a.hpcompress,
        cache_sketches=a.cache, outprefix=a.outprefix,
        kmer_downsample_frac=a.downsample, seedseed=a.seed,
        fd_level=fd, truncation_method=1 if a.bbit_sigs else 0,
        nthreads=a.threads, compressed_a=ca, compressed_b=cb,
        entmin=a.entmin, filterset_path=a.filterset,
        verbosity=a.verbose, bed_normalize=a.normalize_intervals,
        by_chrom=a.by_chrom, fasta_dedup=fasta_dedup,
        exhaustive_dedup=exhaustive_dedup,
        output_kind=kind,
        output_format=(OutputFormat.MACHINE_READABLE if a.binary_output
                       else OutputFormat.HUMAN_READABLE),
        num_neighbors=num_neighbors, min_similarity=min_sim,
        measure=measure, outfile_path=a.cmpout or "",
        exact_kmer_dist=a.exact_kmer_dist, refine_exact=a.refine_exact,
        cmp_batch_size=a.batch_size, nLSH=a.nlsh, maxcand=a.maxcand,
        index_save=a.index_save, index_load=a.index_load,
        sig_ram_limit=(a.sig_ram_limit if a.sig_ram_limit is not None
                       else 20 << 30),
        regt32=a.regt32, seqs_in_ram=a.seqs_in_ram,
    )
    return opts


# options outside the slice: dest -> the flag a user typed
_OUTSIDE_SLICE = {"entmin": "--entmin", "warm_only": "--warm-only"}
# options the port runs only in the edit-distance space (-E) and over
# minimizer sequences (--seq)
_EDIT_ONLY = {
    "compute_edit": "--compute-edit-distance",
    "exact_kmer_dist": "--exact-kmer-dist",
}


def _slice_errors(p: argparse.ArgumentParser, a: argparse.Namespace,
                  compares: bool) -> List[str]:
    """Options this port does not run yet (empty if the job is in the
    slice). The flags are checked before any options are built, so that
    a flag outside the slice is reported as such even where building
    the options would fail. --compute-edit-distance and
    --exact-kmer-dist run only with -E (--edit-distance; the BED
    sketcher refuses -E, as the JAX package's does) or --seq."""
    outside = dict(_OUTSIDE_SLICE)
    if not (a.edit_distance or a.mmer_seq):
        outside.update(_EDIT_ONLY)
    errs = [flag for dest, flag in outside.items()
            if getattr(a, dest) != p.get_default(dest)]
    if errs or not compares:
        return errs
    opts = _build_opts(a)
    if opts.fd_level not in (0.5, 1.0, 2.0, 4.0, 8.0):
        errs.append("comparisons other than --fastcmp 0.5, 1, 2, 4 and "
                    "full registers")
    return errs


def _collect_inputs(a: argparse.Namespace) -> Tuple[List[str], int]:
    """(input paths, query count): the paths, --pairlist's unique paths,
    -F's list, then -Q's queries at the tail (dashing2_tpu/cli.py)."""
    groups: List[str] = list(a.paths)
    if a.pairlist:
        # The reference collects the unique paths named in the pairlist and
        # proceeds with the normal comparison flow (options.h:428-449;
        # sparse pair-restricted output is a TODO there too).
        if groups:
            raise ValueError("Provide either a pairlist or paths, not both")
        seen = {}
        with open(a.pairlist) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    raise ValueError(
                        "pairlist lines need two space-separated paths")
                for p in parts[:2]:
                    seen.setdefault(p, None)
        groups.extend(seen.keys())
    if a.ffile:
        with open(a.ffile) as f:
            # .strip(), not rstrip("\n"): CRLF list files would leave a
            # trailing "\r" in every path
            groups.extend(line.strip() for line in f if line.strip())
    nq = 0
    if a.qfile:
        with open(a.qfile) as f:
            qgroups = [line.strip() for line in f if line.strip()]
        groups.extend(qgroups)
        nq = len(qgroups)
    return groups, nq


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry: dispatch + clean error reporting (the reference's
    THROW_EXCEPTION prints the message and aborts, enums.h:59-63). Pass
    -v for full tracebacks."""
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        return _main(argv)
    except (OSError, ValueError, NotImplementedError) as e:
        if "-v" in argv:
            raise
        print(f"dashing2-tpu-torch: error: {e}", file=sys.stderr)
        return 1


def _main(argv: List[str]) -> int:
    top = argparse.ArgumentParser(prog="dashing2-tpu-torch")
    sub = top.add_subparsers(dest="command", required=True)
    ps = sub.add_parser("sketch", help="sketch inputs (and optionally "
                                       "compare them all-pairs)")
    pc = sub.add_parser("cmp", aliases=["dist"], help="compare inputs")
    for p in (ps, pc):
        _add_shared(p)
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the sketch draws and the comparison "
                            "run (default cuda); cpu runs the kernels' "
                            "plain PyTorch versions")
    pc.add_argument("--presketched", action="store_true")
    pw = sub.add_parser("wsketch", help="sketch pre-aggregated weighted "
                                        "sets")
    pw.add_argument("wargs", nargs="*")
    pw.add_argument("-S", "--sketchsize", type=int, default=1024)
    pw.add_argument("-o", "--outfile", default="")
    pw.add_argument("-P", "--prob", action="store_true",
                    help="ProbMinHash (the default; kept for "
                         "compatibility with earlier versions)")
    pw.add_argument("-B", "--bagminhash", action="store_true",
                    help="BagMinHash instead of the default ProbMinHash "
                         "(reference -B)")
    pw.add_argument("-q", "--set", dest="setsketch", action="store_true",
                    help="set semantics: FullSetSketch over the ids, "
                         "weights ignored (reference -q)")
    pw.add_argument("--u32", action="store_true",
                    help="ids are 32-bit (reference -u)")
    pw.add_argument("--f32", action="store_true",
                    help="weights are 32-bit floats (reference -f)")
    pw.add_argument("--indptr32", action="store_true",
                    help="indptr is u32 (the reference's -P)")
    pcon = sub.add_parser("contain", help="screen queries against a "
                                          "k-mer db")
    _add_shared(pcon)
    for p in (pw, pcon):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the draws (wsketch) or the lookup "
                            "(contain) run (default cuda); cpu runs the "
                            "plain PyTorch versions")
    ppm = sub.add_parser("printmin", help="print minimizer sequences")
    ppm.add_argument("minfile")
    a = top.parse_args(argv)
    if a.command == "printmin":
        # host only: decodes a file
        from .io.printmin import printmin_main
        return printmin_main(a.minfile)

    from .device import resolve
    try:
        device = resolve(a.device)
    except RuntimeError as e:
        print(f"dashing2-tpu-torch: error: {e}", file=sys.stderr)
        return 2
    if a.command == "wsketch":
        from .sketch.wsketch import wsketch_main
        return wsketch_main(a)
    if a.command == "contain":
        from .cmp.contain import contain_main
        return contain_main(a)
    parser = ps if a.command == "sketch" else pc
    groups, nq = _collect_inputs(a)
    compares = a.command != "sketch" or bool(a.cmpout)
    errs = _slice_errors(parser, a, compares)
    if errs:
        parser.error("not ported yet (see ROADMAP.md): " + ", ".join(errs))
    opts = _build_opts(a)
    if opts.verbosity >= 1:
        from . import __version__
        print(f"#dashing2-tpu-torch v{__version__}; invocation: "
              "dashing2-tpu-torch " + " ".join(argv), file=sys.stderr)
    if a.command != "sketch" and not opts.outfile_path:
        opts.outfile_path = "/dev/stdout"

    if not groups:
        parser.error("no input files")
    from .timing import phase
    if getattr(a, "presketched", False):
        with phase("load-presketched", opts.verbosity):
            result = _load_presketched(opts, groups, nq_files=nq)
    else:
        with phase("sketch", opts.verbosity):
            result = _do_sketch(opts, groups, device)
        result.nq = nq
        if a.outfile and (result.signatures is not None
                          or result.mmer_sequences is not None):
            with phase("write-sketches", opts.verbosity):
                _write_outputs(opts, a.outfile, result)
    if compares:
        with phase("compare+emit", opts.verbosity):
            _do_cmp(opts, result, device)
    return 0


def _do_sketch(opts: Dashing2DistOptions, groups: List[str], device
               ) -> SketchingResult:
    """FASTA/FASTQ inputs (sketch/core.py), or BED, BigWig and LeafCutter
    inputs (sketch/intervals.py)."""
    if opts.dtype == DataType.FASTX:
        from .sketch.core import sketch_fastx
        return sketch_fastx(opts, groups, device=device)
    from .sketch import intervals
    fn = {DataType.BED: intervals.sketch_bed,
          DataType.BIGWIG: intervals.sketch_bigwig,
          DataType.LEAFCUTTER: intervals.sketch_leafcutter}[opts.dtype]
    return fn(opts, groups, device=device)


def _write_outputs(opts: Dashing2DistOptions, outfile: str,
                   result: SketchingResult) -> None:
    """-o: the stacked signatures (and names), with -s the k-mer
    database <-o>.kmer64 and with -N the registers' counts
    <-o>.kmercounts.f64, which only one-permutation FASTA jobs have; or
    the stacked minimizer sequences of --seq and their names."""
    from .io import formats
    if result.mmer_sequences is not None:
        formats.write_mmer_sequences(
            outfile, result.mmer_sequences, opts.k, opts.w, opts.alphabet,
            opts.canonicalize)
        formats.write_names_file(outfile + ".names.txt", result.names,
                                 result.cardinalities)
        return
    formats.write_stacked_signatures(outfile, result.cardinalities,
                                     result.signatures, result.names)
    if result.kmers is not None:
        formats.write_kmer_db(outfile + ".kmer64", result.kmers, opts.k,
                              opts.w, opts.alphabet, opts.canonicalize,
                              opts.seedseed)
    if result.kmercounts is not None:
        result.kmercounts.astype(np.float64).tofile(
            outfile + ".kmercounts.f64")


def _load_presketched(opts: Dashing2DistOptions, groups: List[str],
                      nq_files: int = 0) -> SketchingResult:
    """Load pre-computed sketches: stacked signature files (with their
    .names.txt) or single sketch caches, whose suffix also fixes the
    sketch space and result type (cmp_main.cpp:24-198,305-352): .opss is
    a one-permutation cache, .ss a FullSetSketch one, .bmh and .pmh
    BagMinHash and ProbMinHash ones. `nq_files` trailing paths are query
    files (PANEL): nq becomes the number of ITEMS they contain (a
    stacked file holds many). A .kmerset64 file is an exact k-mer set: an
    f64 cardinality (0 or less: the key count) then u64 keys, sorted on
    load (.kmerset128: u128 keys, little-endian (lo, hi)); a .mmerseq64
    (.mmerseq128) file is a minimizer sequence, or with a sibling
    <stem>kmercounts.f64 of as many f64 counts a count dictionary, its
    repeated keys summed (cmp_main.cpp:107,335-351). Sequences compare
    by their exact span edit distances (`exact_kmer_dist` re-applied, as
    the JAX loader does). .kmerset64 sets larger than --sig-ram-limit,
    which the JAX package streams from the file, are not ported."""
    import os
    from . import u128 as U
    from .io import formats
    result = SketchingResult()
    cards_all, sig_rows = [], []
    kmer_sets, kmer_counts = [], []
    mmer_seqs = []
    items_per_path = []
    for path in groups:
        if path.endswith((".opss", ".ss", ".bmh", ".pmh")):
            if path.endswith(".bmh"):
                opts.sspace = SketchSpace.SPACE_MULTISET
            elif path.endswith(".pmh"):
                opts.sspace = SketchSpace.SPACE_PSET
            opts.kmer_result = (KmerSketchResultType.ONE_PERM
                                if path.endswith(".opss")
                                else KmerSketchResultType.FULL_SETSKETCH)
            card, regs = formats.read_sketch_cache(path)
            result.names.append(path)
            cards_all.append(np.array([card]))
            sig_rows.append(regs[None, :])
            items_per_path.append(1)
        elif path.endswith((".kmerset64", ".kmerset128")):
            if path.endswith(".kmerset64") \
                    and os.path.getsize(path) > opts.sig_ram_limit:
                raise NotImplementedError(
                    f"{path}: exact sets larger than --sig-ram-limit are "
                    "streamed from their files in the JAX package, which "
                    "is not ported (ROADMAP Queue 1 item 8)")
            opts.kmer_result = KmerSketchResultType.FULL_MMER_SET
            card = float(np.fromfile(path, np.float64, count=1)[0])
            kmers = np.fromfile(path, dtype=np.uint64, offset=8)
            if path.endswith(".kmerset128"):
                pairs = kmers.reshape(-1, 2)    # (lo, hi) little-endian
                kmers = U.from_words(pairs[:, 1], pairs[:, 0])
                opts.use128 = True
            result.names.append(path)
            kmer_sets.append(U.sort(kmers) if U.is_u128(kmers)
                             else np.sort(kmers))
            cards_all.append(np.array([card if card > 0
                                       else float(len(kmers))]))
            items_per_path.append(1)
        elif path.endswith((".mmerseq64", ".mmerseq128")):
            if path.endswith(".mmerseq128"):
                tokens = U.read_file(path)
                opts.use128 = True
            else:
                tokens = np.fromfile(path, dtype=np.uint64)
            countg = path[:path.rfind(".")] + "kmercounts.f64"
            counts = (np.fromfile(countg, dtype=np.float64)
                      if os.path.isfile(countg) else None)
            result.names.append(path)
            items_per_path.append(1)
            if counts is None or len(counts) != len(tokens):
                opts.kmer_result = KmerSketchResultType.FULL_MMER_SEQUENCE
                mmer_seqs.append(tokens)
                cards_all.append(np.array([float(len(tokens))]))
                continue
            # dict keys must be unique and sorted for the joins; a
            # positional stream may repeat a token
            u, inv = np.unique(tokens, return_inverse=True)
            csum = np.zeros(len(u), np.float64)
            np.add.at(csum, inv, counts)
            opts.kmer_result = KmerSketchResultType.FULL_MMER_COUNTDICT
            kmer_sets.append(u)
            kmer_counts.append(csum)
            cards_all.append(np.array([float(csum.sum())]))
        else:
            cards, sigs = formats.read_stacked_signatures(path)
            try:
                names, _ = formats.read_names_file(path + ".names.txt")
            except OSError:
                names = [f"{path}:{i}" for i in range(len(cards))]
            result.names.extend(names)
            cards_all.append(cards)
            sig_rows.append(sigs)
            items_per_path.append(len(cards))
    result.cardinalities = np.concatenate(cards_all)
    if sig_rows:
        result.signatures = np.vstack(sig_rows)
        if result.signatures.shape[1] != opts.sketchsize:
            opts.sketchsize = result.signatures.shape[1]
    if kmer_sets:
        result.kmer_sets = kmer_sets
        if kmer_counts and len(kmer_counts) == len(kmer_sets):
            result.kmer_set_counts = kmer_counts
        opts.exact_kmer_dist = True
    if mmer_seqs:
        result.mmer_sequences = mmer_seqs
        # the options' coupling (kmer_result >= FULL_MMER_SET: exact
        # span distances) ran before the suffix set kmer_result
        opts.exact_kmer_dist = True
    if nq_files:
        result.nq = int(sum(items_per_path[-nq_files:]))
    return result


def _do_cmp(opts: Dashing2DistOptions, result, device) -> None:
    """The comparison and its output: neighbour graphs and dedup
    clusters (cmp/graph.py), else the all-pairs matrix or the panel."""
    if opts.output_kind in (OutputKind.KNN_GRAPH,
                            OutputKind.NN_GRAPH_THRESHOLD,
                            OutputKind.DEDUP):
        from .cmp.graph import neighbor_graph_main
        neighbor_graph_main(opts, result, device=device)
        return
    from .cmp.core import pairwise_matrix
    from .io.emitters import emit_rectangular
    # symmetric/PHYLIP emitters never read the lower triangle
    upper = (opts.output_kind in (OutputKind.SYMMETRIC_ALL_PAIRS,
                                  OutputKind.PHYLIP)
             and result.nqueries() == 0)
    emit_rectangular(opts, result, pairwise_matrix(
        opts, result, upper_only=upper, device=device))


if __name__ == "__main__":
    sys.exit(main())
