"""Weighted sketches: BagMinHash-equivalent (`-B`, weighted Jaccard) and
ProbMinHash-equivalent (`-P`, probability Jaccard) registers.

Port of dashing2_tpu/sketch/weighted.py's batched engine
(`bagminhash_many`, `probminhash_many`, `_lnw_many`,
`_sketch_many_streams`). The log-weights are computed on the host in
numpy f64 as there (`-P`: log(c / sum c)) and cast to f32 for the draws.
The draws and the per-register minimum run in ops/weighted_draws.py:
csrc/weighted_draws.cu on the card, its plain PyTorch version on the
CPU, with the same salts and draw math (`_icws_rt`, re-exported here)
and the JAX engine's 2048-position row rule. Registers are the winner's
f32 sample value as f64 (0.0 for an empty item); cardinalities are the
total weight.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.weighted_draws import (_GOLD, _S1, _S2, _S3, _S4, _S5,  # noqa: F401
                                  _SVAL, ROW_L, _icws_rt, weighted_draws)
from ..timing import span

# stream positions one launch draws for (a few bytes each on the card)
BATCH_POSITIONS = 1 << 24
# positions of a piece of a long stream: 16 rows of ROW_L
PIECE = 16 * ROW_L


def _lnw_many(kind: str, uniq: Sequence[np.ndarray],
              counts: Sequence[np.ndarray]) -> List[np.ndarray]:
    out = []
    # a weight of 0 or less (interval values, wsketch weights) is masked
    with np.errstate(divide="ignore", invalid="ignore"):
        for c in counts:
            c = c.astype(np.float64)
            if kind == "pmh":
                c = c / max(float(c.sum()), 1e-300)
            out.append(np.where(c > 0, np.log(c), -np.inf))
    return out


def _batches(sizes: np.ndarray, budget: int):
    """Consecutive item ranges whose streams hold at most `budget`
    positions together (one item at least), and at most 65535 items."""
    s, n = 0, len(sizes)
    while s < n:
        e, tot = s + 1, int(sizes[s])
        while e < n and e - s < 65535 and tot + int(sizes[e]) <= budget:
            tot += int(sizes[e])
            e += 1
        yield s, e
        s = e


def _pieces(sizes: np.ndarray):
    """(stream, start, length) arrays of the pieces of PIECE positions
    the streams are cut into, streams in order (an empty stream is one
    empty piece)."""
    count = np.maximum(1, -(-sizes // PIECE))
    item = np.repeat(np.arange(len(sizes)), count)
    first = np.cumsum(count) - count
    start = (np.arange(len(item)) - first[item]) * PIECE
    return item, start, np.minimum(PIECE, sizes[item] - start)


def _sketch_many_streams(kind: str, streams: Sequence[np.ndarray],
                         lnws: Sequence[np.ndarray], m: int, device,
                         budget: int = BATCH_POSITIONS
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Each item's registers (f64 (n, m)) and winners (int64 (n, m),
    positions in the item's stream) from its (hash, log-weight) stream,
    items batched into launches on `device`. A position whose log-weight
    is not finite (a weight of 0 or less) never wins; a register no
    position wins is 0 with winner 0, as in the JAX engine.

    A stream longer than PIECE positions is drawn as pieces of PIECE
    positions (whole 2048-position rows), each an item of the launch, so
    that a launch of a few long streams (interval files) still fills the
    card; the pieces then merge in order by f32 `<`, an earlier piece
    keeping an equal key: the JAX engine's row rule, so the registers
    are those of the whole stream."""
    n = len(streams)
    sigs = np.zeros((n, m), np.float64)
    ids = np.zeros((n, m), np.int64)
    dev = torch.device(device)
    sizes = np.array([len(h) for h in streams], np.int64)
    item, start, plen = _pieces(sizes)
    split = np.flatnonzero(sizes > PIECE)
    row = np.full(n, -1, np.int64)
    row[split] = np.arange(len(split))
    key_s = np.full((len(split), m), np.inf, np.float32)
    val_s = np.zeros((len(split), m), np.float32)
    win_s = np.zeros((len(split), m), np.int64)
    for s, e in _batches(plen, budget):
        off = np.zeros(e - s + 1, np.int64)
        np.cumsum(plen[s:e], out=off[1:])
        cut = [slice(a, a + b) for a, b in zip(start[s:e], plen[s:e])]
        h = np.concatenate([streams[i][c] for i, c in zip(item[s:e], cut)]
                           ).astype(np.uint64, copy=False)
        w = np.concatenate([lnws[i][c] for i, c in zip(item[s:e], cut)]
                           ).astype(np.float32)
        with span("sketch/h2d"):
            th = torch.from_numpy(h.view(np.int64)).to(dev)
            tw = torch.from_numpy(w).to(dev)
            to = torch.from_numpy(off).to(dev)
        with span("sketch/draws"):
            key, win, val = weighted_draws(kind, th, tw, to, m)
            key, win, val = key.cpu().numpy(), win.cpu().numpy(), \
                val.cpu().numpy()
        whole = row[item[s:e]] < 0
        sigs[item[s:e][whole]] = val[whole].astype(np.float64)
        ids[item[s:e][whole]] = win[whole]
        for p in np.flatnonzero(~whole):
            r = row[item[s + p]]
            better = key[p] < key_s[r]
            key_s[r] = np.where(better, key[p], key_s[r])
            val_s[r] = np.where(better, val[p], val_s[r])
            win_s[r] = np.where(better, win[p] + start[s + p], win_s[r])
    sigs[split] = val_s.astype(np.float64)
    ids[split] = win_s
    return sigs, ids


def bagminhash_many(uniq: Sequence[np.ndarray], counts: Sequence[np.ndarray],
                    m: int, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """ICWS registers of each item's distinct hashes weighted by their
    counts, and each item's total weight as its cardinality."""
    sigs, _ = _sketch_many_streams("icws", uniq,
                                   _lnw_many("icws", uniq, counts), m,
                                   device)
    cards = np.array([c.sum() for c in counts], np.float64)
    return sigs, cards


def probminhash_many(uniq: Sequence[np.ndarray], counts: Sequence[np.ndarray],
                     m: int, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """ProbMinHash registers of each item's distinct hashes with
    probabilities count / total, and each item's total weight."""
    sigs, _ = _sketch_many_streams("pmh", uniq,
                                   _lnw_many("pmh", uniq, counts), m,
                                   device)
    cards = np.array([c.sum() for c in counts], np.float64)
    return sigs, cards
