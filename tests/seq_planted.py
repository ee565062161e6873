"""Planted rows for the window stage of csrc/oph_rows.cu (no jax here).

`planted_rows(L, nsym, nwin, seed)` gives rows of L alphabet codes
(uint8, INVALID = 0xFF) whose minimizer windows take the stage's edge
cases: equal scores and runs of invalid positions.

* a homopolymer (every code 0): every k-mer equal, so every score equal;
* a tandem repeat of period 5 and one of period nwin: the scores repeat
  with that period, so windows hold equal minima at several places;
* one row for each length 1 to nwin of a run of INVALID codes, the runs
  a few windows apart at offsets that walk through the residues modulo
  nwin (the step 2 nwin + 7), between random codes.

With nwin = 1 (no minimizers) the rows are made for nwin = 17.
"""

import numpy as np

INVALID = 0xFF


def planted_rows(L: int, nsym: int, nwin: int, seed: int = 0) -> np.ndarray:
    nwin = nwin if nwin > 1 else 17
    rng = np.random.default_rng(seed)
    rows = [np.zeros(L, np.uint8)]
    for period in (5, nwin):
        motif = rng.integers(0, nsym, period).astype(np.uint8)
        rows.append(np.resize(motif, L))
    for run in range(1, nwin + 1):
        row = rng.integers(0, nsym, L).astype(np.uint8)
        for at in range(40, L - run, 2 * nwin + 7):
            row[at:at + run] = INVALID
        rows.append(row)
    return np.stack(rows)
