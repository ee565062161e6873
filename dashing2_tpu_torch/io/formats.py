"""Binary on-disk formats — the compatibility surface (SURVEY §1.1).

Copy of dashing2_tpu/io/formats.py, cut to the writers the slice's
`sketch -o` calls:

* Stacked signatures  (-o): u64 nseqs, u64 sketchsize, f64 cards[nseqs],
  RegT sigs[nseqs*sketchsize]  (src/sketch_core.cpp:130-139,
  src/fastxsketch.cpp:236-244; reader python/parse.py).
  Companion <out>.names.txt: "#Name\tCardinality" + per-item lines
  (src/sketch_core.cpp:146-161).

Binary distance matrices (raw row-major f32, condensed upper triangle
for symmetric all-pairs) are written by io/emitters.py.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def write_stacked_signatures(path: str, cardinalities: np.ndarray,
                             signatures: np.ndarray,
                             names: Sequence[str] | None = None) -> None:
    sigs = np.ascontiguousarray(signatures)
    cards = np.ascontiguousarray(cardinalities, dtype=np.float64)
    nseqs = sigs.shape[0]
    # sketchsize counts RegT(=f64)-sized registers regardless of the
    # stored register width (parse.py:71-73 uses the ratio to infer dtype)
    sketchsize = sigs.shape[1] * sigs.dtype.itemsize // 8 if sigs.dtype != np.float64 \
        else sigs.shape[1]
    with open(path, "wb") as f:
        np.array([nseqs, sketchsize], dtype=np.uint64).tofile(f)
        cards.tofile(f)
        sigs.tofile(f)
    if names is not None:
        write_names_file(path + ".names.txt", names, cards)


def write_names_file(path: str, names: Sequence[str],
                     cardinalities: np.ndarray | None) -> None:
    with open(path, "w") as f:
        f.write("#Name\tCardinality\n")
        for i, n in enumerate(names):
            f.write(n)
            if cardinalities is not None:
                f.write("\t%0.24g" % float(cardinalities[i]))
            f.write("\n")
