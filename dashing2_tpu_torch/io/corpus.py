"""Seeded synthetic genome corpora for tests and on-card runs.

Families of FASTA genomes: each ancestor is a uniform random sequence,
and each of its mutants replaces every base independently with
probability `rate` (rates spaced evenly over `divergence`), so pairwise
similarities spread from near 1 inside a family to the b-bit collision
floor across families.

Every draw is an explicit splitmix64 of a per-(seed, stream, genome)
counter base plus the base position, so the bytes depend on nothing but
the arguments: no numpy Generator algorithm or version can change them.
A committed digest of a job's output (tests/goldens/
torch_port_bbit_nibble.json) rests on that.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_M64 = (1 << 64) - 1
_STREAM_ANCESTOR, _STREAM_MUTATE, _STREAM_BASE = 1, 2, 3


def _splitmix64_int(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Elementwise splitmix64 finalizer of u64 counters (wrapping)."""
    z = np.asarray(x, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _draws(seed: int, stream: int, genome: int, length: int) -> np.ndarray:
    base = _splitmix64_int(_splitmix64_int(_splitmix64_int(seed) ^ stream)
                           ^ genome)
    return splitmix64(np.uint64(base) + np.arange(length, dtype=np.uint64))


def genome_bases(seed: int, n_ancestors: int, n_mutants: int, length: int,
                 divergence: Tuple[float, float]) -> np.ndarray:
    """(n_ancestors * n_mutants, length) ASCII bases; row a * n_mutants + j
    is mutant j of ancestor a."""
    lo, hi = divergence
    out = np.empty((n_ancestors * n_mutants, length), np.uint8)
    for a in range(n_ancestors):
        anc = _BASES[(_draws(seed, _STREAM_ANCESTOR, a, length)
                      >> np.uint64(62)).astype(np.intp)]
        for j in range(n_mutants):
            g = a * n_mutants + j
            rate = lo + (hi - lo) * j / max(n_mutants - 1, 1)
            thr = np.uint64(min(int(rate * 2.0 ** 64), _M64))
            hit = _draws(seed, _STREAM_MUTATE, g, length) < thr
            new = _BASES[(_draws(seed, _STREAM_BASE, g, length)
                          >> np.uint64(62)).astype(np.intp)]
            out[g] = np.where(hit, new, anc)
    return out


def _fasta_bytes(name: str, seq: np.ndarray, width: int = 80) -> bytes:
    full = len(seq) // width * width
    body = np.concatenate(
        [seq[:full].reshape(-1, width),
         np.full((full // width, 1), ord("\n"), np.uint8)], axis=1)
    tail = seq[full:].tobytes() + b"\n" if full < len(seq) else b""
    return f">{name}\n".encode() + body.tobytes() + tail


def write_corpus(outdir: str, seed: int, n_ancestors: int, n_mutants: int,
                 length: int, divergence: Tuple[float, float] = (0.005, 0.05)
                 ) -> List[str]:
    """Write one FASTA file per genome under `outdir`; returns the paths
    in item order."""
    os.makedirs(outdir, exist_ok=True)
    seqs = genome_bases(seed, n_ancestors, n_mutants, length, divergence)
    paths = []
    for g in range(seqs.shape[0]):
        p = os.path.join(outdir, f"g{g:05d}.fa")
        with open(p, "wb") as f:
            f.write(_fasta_bytes(f"genome{g}", seqs[g]))
        paths.append(p)
    return paths


def edited_sequences(seed: int, n_families: int, n_members: int,
                     length: Tuple[int, int] = (1000, 4000),
                     edits: Tuple[float, float] = (0.01, 0.03),
                     n_every: int = 97, polya_every: int = 89
                     ) -> List[Tuple[str, bytes]]:
    """(name, sequence) records of families for the edit-distance space
    (numpy's PCG64 from `seed`): each family an ancestor of uniform
    random length in `length` (bases uniform over ACGT) and `n_members`
    members, each edited from it at a rate uniform in `edits`, the edits
    substitutions, insertions and deletions in equal parts at distinct
    positions. Every `n_every`-th record gets a run of 20-200 N bases
    and every `polya_every`-th a poly-A tract of 50-300 bases, at random
    places. Records `fam<f>_<j>`, families in consecutive rows."""
    rng = np.random.default_rng(seed)
    out: List[Tuple[str, bytes]] = []
    for f in range(n_families):
        anc = _BASES[rng.integers(0, 4, int(rng.integers(*length,
                                                         endpoint=True)))]
        for j in range(n_members):
            L = len(anc)
            rate = rng.uniform(*edits)
            pos = np.sort(rng.choice(L, size=int(round(rate * L)),
                                     replace=False))
            kind = rng.integers(0, 3, len(pos))
            seq = anc.copy()
            sub = pos[kind == 0]
            shift = rng.integers(1, 4, len(sub))
            # _BASES is sorted: searchsorted gives a base's code
            seq[sub] = _BASES[(np.searchsorted(_BASES, seq[sub]) + shift) % 4]
            ins = pos[kind == 1]
            dele = pos[kind == 2]
            seq = np.insert(seq, ins, _BASES[rng.integers(0, 4, len(ins))])
            seq = np.delete(seq, dele + np.searchsorted(ins, dele,
                                                        side="right"))
            i = len(out)
            if i % n_every == n_every - 1:
                at, w = int(rng.integers(0, len(seq))), int(
                    rng.integers(20, 201))
                seq[at:at + w] = ord("N")
            if i % polya_every == polya_every - 1:
                at, w = int(rng.integers(0, len(seq))), int(
                    rng.integers(50, 301))
                seq[at:at + w] = ord("A")
            out.append((f"fam{f}_{j}", seq.tobytes()))
    return out


def write_fasta(path: str, records) -> str:
    """Write (name, sequence bytes) records as one FASTA file of 80-column
    lines; returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(_fasta_bytes(name, np.frombuffer(seq, np.uint8)))
    return path
