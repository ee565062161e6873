"""printmin subcommand: decode a minimizer-sequence file to text.

Copy of dashing2_tpu/io/printmin.py. Reference:
src/printminmain.cpp:7-94: reads the --seq output (stacked minimizer
sequences), inverts the maskfn scrambler, and prints per item one line
of tab-separated decoded k-mer strings (DNA) or hex values.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import hashing as H
from ..enums import Alphabet
from . import formats


def decode_kmer_dna(code: int, k: int) -> str:
    return "".join("ACGT"[(code >> (2 * (k - 1 - i))) & 3]
                   for i in range(k))


def printmin_main(path: str, out=None) -> int:
    out = out or sys.stdout
    data = formats.read_mmer_sequences(path)
    k = data["k"]
    if data.get("use128"):
        # u128 tokens: per-word inverse maskfn (invmaskfn(u128),
        # enums.h:149-153), exact DNA decode up to k=62
        exact_dna = data["alphabet"] in (Alphabet.DNA, Alphabet.DNAC) \
            and k <= 62
        for seq in data["seqs"]:
            hi = H.invmaskfn(np.asarray(seq["hi"], np.uint64),
                             H.XORMASK2_HI)
            lo = H.invmaskfn(np.asarray(seq["lo"], np.uint64))
            if exact_dna:
                out.write("\t".join(
                    decode_kmer_dna((int(h) << 64) | int(x), k)
                    for h, x in zip(hi, lo)))
            else:
                out.write("\t".join("%016x%016x" % (int(h), int(x))
                                    for h, x in zip(hi, lo)))
            out.write("\n")
        return 0
    exact_dna = data["alphabet"] in (Alphabet.DNA, Alphabet.DNAC) and k <= 31
    for seq in data["seqs"]:
        vals = H.invmaskfn(np.asarray(seq, dtype=np.uint64))
        if exact_dna:
            out.write("\t".join(decode_kmer_dna(int(v), k) for v in vals))
        else:
            out.write("\t".join("%016x" % int(v) for v in vals))
        out.write("\n")
    return 0
