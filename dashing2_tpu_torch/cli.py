"""dashing2-compatible command-line interface of the PyTorch/CUDA port.

Port of dashing2_tpu/cli.py: `_add_shared` and `_build_opts` are copies,
so flags keep their reference names and build the same options. Only the
`sketch` subcommand exists, and it runs only the slices the port covers:
native sketching of FASTA/FASTQ inputs, then (with --cmpout) the
all-pairs matrix of any measure (similarity, `--mash-distance`,
`--containment`, `--symmetric-containment`, `--intersection`,
`--union-size`) over the full registers (no `--fastcmp`, or
`--fastcmp 8`; `--f32-registers` compares them rounded to f32, and
`--bbit-sigs` compares their bits for equality) or over `--fastcmp 0.5`,
`1`, `2` or `4` registers (nibbles, u8, u16, u32), b-bit (`--bbit-sigs`)
or SetSketch a/b quantised (without it), emitted as binary f32, PHYLIP,
the symmetric TSV or, with `--asymmetric-all-pairs`, the full square.
Every other option is rejected with an error naming it. `--device`
(default cuda) picks where the comparison runs; a CUDA request without a
card exits non-zero and never carries on on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

from .config import Dashing2DistOptions
from .enums import (Alphabet, DataType, KmerSketchResultType, Measure,
                    OutputFormat, OutputKind, SketchSpace)


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
_OUTSIDE_SLICE = {
    "qfile": "-Q/--qfile", "outprefix": "--outprefix",
    "topk": "--topk", "simthresh": "--similarity-threshold",
    "greedy": "--greedy", "fastcmp_bytes": "--fastcmp-bytes",
    "fastcmp_shorts": "--fastcmp-shorts", "fastcmp_words": "--fastcmp-words",
    "cssize": "--countsketch-size", "prob": "--prob",
    "multiset": "--multiset", "bed": "--bed", "bigwig": "--bigwig",
    "leafcutter": "--leafcutter", "edit_distance": "--edit-distance",
    "compute_edit": "--compute-edit-distance",
    "mmer_set": "--set", "countdict": "--countdict", "mmer_seq": "--seq",
    "save_kmers": "--save-kmers",
    "save_kmercounts": "--save-kmercounts", "hpcompress": "--hp-compress",
    "refine_exact": "--refine-exact", "full": "--full-setsketch",
    "normalize_intervals": "--normalize-intervals", "cache": "--cache",
    "exact_kmer_dist": "--exact-kmer-dist", "filterset": "--filterset",
    "parse_by_seq": "--parse-by-seq", "nlsh": "--nlsh", "entmin": "--entmin",
    "by_chrom": "--by-chrom", "maxcand": "--maxcand",
    "index_save": "--index-save", "index_load": "--index-load",
    "setsketch_ab": "--setsketch-ab", "pairlist": "--pairlist",
    "seqs_in_ram": "--seqs-in-ram", "warm_only": "--warm-only",
}


def _slice_errors(p: argparse.ArgumentParser,
                  a: argparse.Namespace) -> List[str]:
    """Options this port does not run yet (empty if the job is in the
    slice). The flags are checked before any options are built, so that
    a flag outside the slice is reported as such even where building
    the options would fail (--fastcmp-bytes and --setsketch-ab need
    FullSetSketch sketching)."""
    errs = [flag for dest, flag in _OUTSIDE_SLICE.items()
            if getattr(a, dest) != p.get_default(dest)]
    if errs or not a.cmpout:
        return errs
    opts = _build_opts(a)
    if opts.fd_level not in (0.5, 1.0, 2.0, 4.0, 8.0):
        errs.append("comparisons other than --fastcmp 0.5, 1, 2, 4 and "
                    "full registers")
    return errs


def _collect_inputs(a: argparse.Namespace) -> List[str]:
    groups: List[str] = list(a.paths)
    if a.ffile:
        with open(a.ffile) as f:
            # .strip(), not rstrip("\n"): CRLF list files would leave a
            # trailing "\r" in every path
            groups.extend(line.strip() for line in f if line.strip())
    return groups


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
    _add_shared(ps)
    ps.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the comparison runs (default cuda); cpu "
                         "runs the kernels' plain PyTorch versions")
    a = top.parse_args(argv)

    from .device import resolve
    try:
        device = resolve(a.device)
    except RuntimeError as e:
        print(f"dashing2-tpu-torch: error: {e}", file=sys.stderr)
        return 2
    groups = _collect_inputs(a)
    errs = _slice_errors(ps, a)
    if errs:
        ps.error("not ported yet (see ROADMAP.md): " + ", ".join(errs))
    opts = _build_opts(a)
    if not groups:
        ps.error("no input files")
    if opts.verbosity >= 1:
        from . import __version__
        print(f"#dashing2-tpu-torch v{__version__}; invocation: "
              "dashing2-tpu-torch " + " ".join(argv), file=sys.stderr)

    from .sketch.core import sketch_fastx
    from .timing import phase
    with phase("sketch", opts.verbosity):
        result = sketch_fastx(opts, groups)
    if a.outfile:
        from .io import formats
        with phase("write-sketches", opts.verbosity):
            formats.write_stacked_signatures(
                a.outfile, result.cardinalities, result.signatures,
                result.names)
    if opts.outfile_path:
        from .cmp.core import pairwise_matrix
        from .io.emitters import emit_rectangular
        # symmetric/PHYLIP emitters never read the lower triangle
        upper = opts.output_kind in (OutputKind.SYMMETRIC_ALL_PAIRS,
                                     OutputKind.PHYLIP)
        with phase("compare+emit", opts.verbosity):
            emit_rectangular(opts, result,
                             pairwise_matrix(opts, result, upper_only=upper,
                                             device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
