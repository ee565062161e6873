"""wsketch subcommand: sketch pre-aggregated weighted sets (CSR or flat).

Port of dashing2_tpu/sketch/wsketch.py. Reference: src/wsketch.cpp.
Inputs are raw binary vectors: ids/weights (+ optional indptr for CSR
matrices); '-' as the weights file means uniform weights. Items fed to
the sketcher are row ordinals, remapped to the original ids through
each register's winner at the end (wsketch.cpp:17-49).

Outputs (CSR case, wsketch.cpp:300-360):
  <pref>.sampled.indices.stacked.<n>.<m>.i64  — winning original ids
  <pref>.sampled.regs.stacked.<n>.<m>.f64     — stacked sigs w/ header
                                                (u64 n, u64 m, f64 cards)
  <pref>.sampled.hashes.stacked.<n>.<m>.i64   — u64 signature hashes
  <pref>.sampled.info.txt                     — total weights
Flat case (wsketch.cpp:362-377): .sampled.indices.u64 / .sampled.hashes.f64
(f64 total weight + registers) / .sampled.ids.u64 / .sampled.tw.txt.

Where the JAX package sketches row by row, the port hands every row of a
CSR matrix to one many-stream call: -B (BagMinHash) and -P (ProbMinHash,
the default) draw on sketch/weighted.py (csrc/weighted_draws.cu on the
card), -q (set semantics) on ops/sketch_kernels.py::css_sketch_many,
both on `--device` (default cuda), in batches of up to BATCH_POSITIONS
non-zeros.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import hashing as H
from ..device import resolve
from ..ops import sketch_kernels as SK
from ..timing import span
from . import weighted as W

# non-zeros of the rows one call of the draws takes together
BATCH_POSITIONS = 1 << 26


def _read_vec(path: str, dtype) -> Optional[np.ndarray]:
    if path == "-":
        return None
    return np.fromfile(path, dtype=dtype)


def _sketch_rows(ids: Sequence[np.ndarray],
                 weights: Sequence[Optional[np.ndarray]], m: int,
                 sketchtype: int, device
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The JAX `_sketch_row` of every row at once. Returns (sigs f64
    (n, m), sig_hashes u64 (n, m), sampled_ids u64 (n, m), total weights
    f64 (n,)). sketchtype: 1 = BagMinHash, 0 = ProbMinHash, -1 =
    FullSetSketch (set semantics). An empty row has the empty-sketch
    conventions: all-zero registers, winners 0 and total weight 0 (the
    reference's rowwise sketcher emits a row for empty ranges)."""
    n = len(ids)
    sigs = np.zeros((n, m), np.float64)
    sampled = np.zeros((n, m), np.uint64)
    tw = np.zeros(n, np.float64)
    live = [i for i in range(n) if len(ids[i])]
    ords = [np.arange(len(ids[i]), dtype=np.uint64) for i in live]
    ws = [np.asarray(weights[i] if weights[i] is not None
                     else np.ones(len(ids[i])), np.float64) for i in live]
    dev = resolve(device)
    s = 0
    while s < len(live):
        # consecutive live rows up to the batch's non-zeros (one at least)
        e, tot = s + 1, len(ords[s])
        while e < len(live) and tot + len(ords[e]) <= BATCH_POSITIONS:
            tot += len(ords[e])
            e += 1
        rows = live[s:e]
        if sketchtype == -1:
            with span("sketch/css"):
                regs, _, win = SK.css_sketch_many(ords[s:e], m, dev,
                                                  return_ids=True)
            sigs[rows] = np.where(np.isfinite(regs), regs, 0.0)
            tw[rows] = [float(len(o)) for o in ords[s:e]]
        else:
            kind = "icws" if sketchtype == 1 else "pmh"
            with span("sketch/weighted"):
                sg, win = W._sketch_many_streams(
                    kind, ords[s:e], W._lnw_many(kind, ords[s:e], ws[s:e]),
                    m, dev)
            sigs[rows] = sg
            tw[rows] = [float(w.sum()) for w in ws[s:e]]
        for r, i in enumerate(rows):
            sampled[i] = ids[i][np.clip(win[r], 0, len(ids[i]) - 1)] \
                .astype(np.uint64)
        s = e
    # u64 "hash" signatures: wyhash64_stateless of the register bit
    # patterns (CSetSketch::to_sigs<integral>, setsketch.h:573-589:
    # stateless(x) = mix(x + WY_INC), one wyhash64_step on the bits)
    _, hashes = H.wyhash64_step(sigs.view(np.uint64))
    return sigs, hashes, sampled, tw


def wsketch_main(a) -> int:
    args: List[str] = a.wargs
    if not 1 <= len(args) <= 3:
        print("wsketch requires 1-3 positional args "
              "(ids [weights [indptr]])", file=sys.stderr)
        return 1
    m = a.sketchsize
    # default ProbMinHash (the reference's usage contract and its CSR
    # path; its flat path's 1->BagMinHash mapping is an internal
    # inconsistency there); -B picks BagMinHash, -q set semantics
    sketchtype = (-1 if getattr(a, "setsketch", False)
                  else 1 if getattr(a, "bagminhash", False) else 0)
    id_dtype = np.uint32 if a.u32 else np.uint64
    w_dtype = np.float32 if a.f32 else np.float64
    ip_dtype = np.uint32 if getattr(a, "indptr32", False) else np.uint64
    outpref = a.outfile or args[0]
    device = getattr(a, "device", "cuda")
    if len(args) == 3:
        ids = _read_vec(args[0], id_dtype)
        weights = _read_vec(args[1], w_dtype)
        indptr = _read_vec(args[2], ip_dtype)
        nr = len(indptr) - 1
        bounds = [(int(indptr[i]), int(indptr[i + 1])) for i in range(nr)]
        sig_rows, hash_rows, id_rows, cards = _sketch_rows(
            [ids[b:e] for b, e in bounds],
            [weights[b:e] if weights is not None else None
             for b, e in bounds], m, sketchtype, device)
        tag = f"{nr}.{m}"
        with span("wsketch/write"):
            _write_csr(outpref, tag, sig_rows, hash_rows, id_rows, cards)
        return 0
    # flat (single weighted set): ids [weights]
    ids = _read_vec(args[0], id_dtype)
    weights = _read_vec(args[1], w_dtype) if len(args) == 2 else None
    sigs, hashes, sampled, tw = (x[0] for x in _sketch_rows(
        [ids], [weights], m, sketchtype, device))
    hashes.tofile(outpref + ".sampled.indices.u64")
    with open(outpref + ".sampled.hashes.f64", "wb") as f:
        np.array([tw], np.float64).tofile(f)
        sigs.tofile(f)
    sampled.tofile(outpref + ".sampled.ids.u64")
    with open(outpref + ".sampled.tw.txt", "w") as f:
        f.write(f"Total weight: {float(tw)};{args[0]}\n")
    return 0


def _write_csr(outpref: str, tag: str, sig_rows, hash_rows, id_rows,
               cards) -> None:
    id_rows.tofile(f"{outpref}.sampled.indices.stacked.{tag}.i64")
    with open(f"{outpref}.sampled.regs.stacked.{tag}.f64", "wb") as f:
        np.array([len(cards), sig_rows.shape[1]], np.uint64).tofile(f)
        cards.tofile(f)
        sig_rows.tofile(f)
    hash_rows.tofile(f"{outpref}.sampled.hashes.stacked.{tag}.i64")
    with open(f"{outpref}.sampled.info.txt", "w") as f:
        for c in cards:
            f.write("%0.17g\n" % c)
