"""Sketch caching: parameter-keyed per-input sketch artifacts.

Copy of dashing2_tpu/io/cache.py (the port never imports the JAX
package). This is the framework's checkpoint/restart mechanism: --cache
writes one self-describing sketch file per input, named by every
parameter that affects its content, and reloads it instead of
resketching; --outprefix puts the files in another directory.

Naming mirrors makedest (the reference's fastxmerge.cpp:70-120):
<base>[.seed<S>][.rc_canon][.spacing][.sketchsize<m>].k<k>[.w<w>]
[.ct_threshold<t>][.<CountingType><cssize>].<Space|ResultType>.<Alphabet>
<suffix>.
"""

from __future__ import annotations

import os

from ..config import Dashing2Options
from ..enums import (Alphabet, CountingType, KmerSketchResultType,
                     SketchSpace)

_SPACE_STR = {SketchSpace.SPACE_SET: "SetSpace",
              SketchSpace.SPACE_MULTISET: "MultisetSpace",
              SketchSpace.SPACE_PSET: "ProbsetSpace",
              SketchSpace.SPACE_EDIT_DISTANCE: "EditDistanceSpace"}
_KRES_STR = {KmerSketchResultType.ONE_PERM: "OnePermutationSetSketch",
             KmerSketchResultType.FULL_SETSKETCH: "FullSetSketch",
             KmerSketchResultType.FULL_MMER_SET: "FullMmerSet",
             KmerSketchResultType.FULL_MMER_COUNTDICT: "FullMmerCountdict",
             KmerSketchResultType.FULL_MMER_SEQUENCE: "FullMmerSequence"}
_CT_STR = {CountingType.EXACT_COUNTING: "ExactCounting",
           CountingType.COUNTMIN_COUNTING: "CountMinCounting",
           CountingType.COUNTSKETCH_COUNTING: "CountSketchCounting"}


def makedest(opts: Dashing2Options, path: str, iskmer: bool = False) -> str:
    """The cache file of the item `path` (its first path when it names
    several); with `iskmer`, a count dictionary's keys file."""
    ret = path.split(" ")[0]
    if opts.outprefix:
        ret = os.path.join(opts.outprefix, os.path.basename(ret))
    if opts.seedseed != 0:
        ret += f".seed{opts.seedseed}"
    if opts.canonicalize:
        ret += ".rc_canon"
    if opts.spacing:
        ret += "." + opts.spacing
    if opts.kmer_result <= KmerSketchResultType.FULL_SETSKETCH:
        ret += f".sketchsize{opts.sketchsize}"
    ret += f".k{opts.k}"
    if opts.w > opts.k:
        ret += f".w{opts.w}"
    if opts.count_threshold > 0:
        ret += ".ct_threshold"
        ct = opts.count_threshold
        ret += str(ct) if ct % 1 else str(int(ct))
    if opts.sspace not in (SketchSpace.SPACE_SET,
                           SketchSpace.SPACE_EDIT_DISTANCE):
        ret += "." + _CT_STR[opts.counting_type]
        if opts.counting_type != CountingType.EXACT_COUNTING:
            ret += str(opts.cssize)
    if opts.sspace == SketchSpace.SPACE_SET and opts.sketch_compressed():
        ret += (f".a={opts.compressed_a:0.16g}.b={opts.compressed_b:0.16g}"
                f".fd={opts.fd_level:0.16g}")
    ret += "."
    if opts.kmer_result <= KmerSketchResultType.FULL_SETSKETCH:
        ret += _SPACE_STR[opts.sspace]
    else:
        ks = opts.kmer_result
        if iskmer and ks == KmerSketchResultType.FULL_MMER_COUNTDICT:
            ks = KmerSketchResultType.FULL_MMER_SET
        ret += _KRES_STR[ks]
    ret += "." + Alphabet(opts.alphabet).name + opts.suffix()
    return ret
