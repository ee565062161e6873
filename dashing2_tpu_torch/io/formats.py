"""Binary on-disk formats — the compatibility surface (SURVEY §1.1).

Copy of dashing2_tpu/io/formats.py, cut to the formats of `sketch -o`
(with -s/-N, and of `--seq`), `cmp --presketched`, `contain`,
`printmin` and the neighbour graphs' CSR:

* Stacked signatures  (-o): u64 nseqs, u64 sketchsize, f64 cards[nseqs],
  RegT sigs[nseqs*sketchsize]  (src/sketch_core.cpp:130-139,
  src/fastxsketch.cpp:236-244; reader python/parse.py).
  Companion <out>.names.txt: "#Name\tCardinality" + per-item lines
  (src/sketch_core.cpp:146-161).
* Single sketch cache (.opss, .ss, .bmh, .pmh; `--cache`): f64
  cardinality, then registers (f64, or the quantised width)
  (src/fastxsketch.cpp:461-489).
* K-mer database (--save-kmers, .kmer64): u32 dtype|canon<<8, u32
  sketchsize, u32 k, u32 w, u64 seed, then u64 kmers
  (src/fastxsketch.cpp:245-264).
* Minimizer sequences (`--seq -o`): u64 nseqs, u32 k, u32 w, u32
  alphabet|canon<<8|use128<<9, f64 lengths[nseqs], then every
  sequence's u64 tokens (u128 tokens as little-endian (lo, hi) pairs)
  (src/fastxsketch.cpp:526-553, src/printminmain.cpp).
* Contain output: u64 nref, u64 nq, f32 coverage[nq*nref],
  f32 meandepth[nq*nref] (src/contain_main.cpp:246-250).

* KNN / threshold graphs (--topk, -T, --binary-output): u64 nids, u64
  nnz, u64 indptr[nids + 1], u32 indices[nnz], f32 data[nnz]
  (src/emitnn.cpp).

Binary distance matrices (raw row-major f32, condensed upper triangle
for symmetric all-pairs) are written by io/emitters.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ..enums import Alphabet


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


def read_stacked_signatures(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (cardinalities (n,), signatures (n, m)). The register
    dtype is inferred from the stored-width/sketchsize ratio like the
    reference's parse.py:71-73 — full-width (ratio 1) registers are
    returned as f64 (RegT), narrower widths as the matching uint."""
    dat = np.memmap(path, np.uint8, mode="r")
    nseqs, sketchsize = (int(x) for x in dat[:16].view(np.uint64))
    cards = np.array(dat[16:16 + 8 * nseqs].view(np.float64))
    sigs = np.array(dat[16 + 8 * nseqs:].view(np.float64)).reshape(nseqs, -1)
    sigmul = sketchsize // sigs.shape[1]
    if sigmul != 1:
        sigs = sigs.view({2: np.uint32, 4: np.uint16,
                          8: np.uint8}[sigmul])
    return cards, sigs


def write_names_file(path: str, names: Sequence[str],
                     cardinalities: np.ndarray | None) -> None:
    with open(path, "w") as f:
        f.write("#Name\tCardinality\n")
        for i, n in enumerate(names):
            f.write(n)
            if cardinalities is not None:
                f.write("\t%0.24g" % float(cardinalities[i]))
            f.write("\n")


def read_names_file(path: str) -> Tuple[List[str], np.ndarray]:
    names: List[str] = []
    cards: List[float] = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            names.append(parts[0])
            cards.append(float(parts[1]) if len(parts) > 1 else -1.0)
    return names, np.asarray(cards)


def write_sketch_cache(path: str, cardinality: float, registers: np.ndarray
                       ) -> None:
    """A single sketch cache: the f64 cardinality, then the registers as
    they are stored (f64, or the u8/u16/u32/u64 of a quantised sketch)."""
    with open(path, "wb") as f:
        np.array([cardinality], dtype=np.float64).tofile(f)
        np.ascontiguousarray(registers).tofile(f)


def read_sketch_cache(path: str, dtype=np.float64
                      ) -> Tuple[float, np.ndarray]:
    """(cardinality, registers of `dtype`) of a single sketch cache."""
    dat = np.fromfile(path, dtype=np.uint8)
    card = float(dat[:8].view(np.float64)[0])
    return card, dat[8:].view(dtype)


def write_knn_csr_fileobj(f, indptr: np.ndarray, indices: np.ndarray,
                          data: np.ndarray) -> None:
    """CSR layout to an open binary file object (shared by the file and
    stdout emit paths so the two can never diverge)."""
    nids = len(indptr) - 1
    nnz = len(indices)
    f.write(np.array([nids, nnz], dtype=np.uint64).tobytes())
    f.write(np.ascontiguousarray(indptr, dtype=np.uint64).tobytes())
    f.write(np.ascontiguousarray(indices, dtype=np.uint32).tobytes())
    f.write(np.ascontiguousarray(data, dtype=np.float32).tobytes())


def write_knn_csr(path: str, indptr: np.ndarray, indices: np.ndarray,
                  data: np.ndarray) -> None:
    with open(path, "wb") as f:
        write_knn_csr_fileobj(f, indptr, indices, data)


def read_knn_csr(path: str):
    with open(path, "rb") as f:
        nids, nnz = np.fromfile(f, np.uint64, 2)
        nids, nnz = int(nids), int(nnz)
        indptr = np.fromfile(f, np.uint64, nids + 1)
        indices = np.fromfile(f, np.uint32, nnz)
        data = np.fromfile(f, np.float32, nnz)
    return indptr, indices, data


# ----------------------------------------------------------------------
# K-mer database
# ----------------------------------------------------------------------

def write_kmer_db(path: str, kmers: np.ndarray, k: int, w: int,
                  alphabet: Alphabet, canon: bool, seed: int) -> None:
    """kmers: (nseqs, sketchsize) u64."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    with open(path, "wb") as f:
        hdr = np.array([int(alphabet) | (int(canon) << 8),
                        kmers.shape[1], k, w], dtype=np.uint32)
        hdr.tofile(f)
        np.array([seed], dtype=np.uint64).tofile(f)
        kmers.tofile(f)


@dataclass
class KmerDB:
    k: int
    w: int
    canon: bool
    alphabet: Alphabet
    sketchsize: int
    seed: int
    kmers: np.ndarray  # (nseqs, sketchsize)


def read_kmer_db(path: str) -> KmerDB:
    dat = np.memmap(path, np.uint8, mode="r")
    d, s, k, w = (int(x) for x in dat[:16].view(np.uint32))
    seed = int(dat[16:24].view(np.uint64)[0])
    kmers = np.array(dat[24:].view(np.uint64)).reshape(-1, s)
    return KmerDB(k=k, w=w, canon=bool((d >> 8) & 1),
                  alphabet=Alphabet(d & 0xFF), sketchsize=s, seed=seed,
                  kmers=kmers)


# ----------------------------------------------------------------------
# Minimizer sequences
# ----------------------------------------------------------------------

def write_mmer_sequences(path: str, seqs: Sequence[np.ndarray], k: int,
                         w: int, alphabet: Alphabet, canon: bool) -> None:
    """Stacked minimizer sequences. u128 token streams (--long-kmers
    structured arrays) set header bit 9 and store little-endian u128
    tokens (lo, hi words), the layout of .kmerset128."""
    from .. import u128 as U
    use128 = any(U.is_u128(s) for s in seqs)
    with open(path, "wb") as f:
        np.array([len(seqs)], dtype=np.uint64).tofile(f)
        np.array([k, w,
                  int(alphabet) | (int(canon) << 8)
                  | (int(use128) << 9)],
                 dtype=np.uint32).tofile(f)
        np.array([len(s) for s in seqs], dtype=np.float64).tofile(f)
        for s in seqs:
            if use128:
                U.tofile_bytes(np.asarray(s, U.U128)).tofile(f)
            else:
                np.ascontiguousarray(s, dtype=np.uint64).tofile(f)


def read_mmer_sequences(path: str):
    """{k, w, canon, alphabet, nseqs, use128, seqs} of a file written by
    `write_mmer_sequences` (u128 tokens as structured arrays)."""
    from .. import u128 as U
    dat = np.memmap(path, np.uint8, mode="r")
    nseqs = int(dat[:8].view(np.uint64)[0])
    k, w, dt = (int(x) for x in dat[8:20].view(np.uint32))
    use128 = bool(dt & 512)
    cards = dat[20:20 + 8 * nseqs].view(np.float64)
    flat64 = np.array(dat[20 + 8 * nseqs:].view(np.uint64))
    if use128:
        pairs = flat64.reshape(-1, 2)       # (lo, hi) little-endian
        flat = U.from_words(pairs[:, 1], pairs[:, 0])
    else:
        flat = flat64
    indptr = np.concatenate([[0], np.cumsum(cards.astype(np.uint64))])
    seqs = [flat[int(indptr[i]):int(indptr[i + 1])] for i in range(nseqs)]
    return {"k": k, "w": w, "canon": bool(dt & 256),
            "alphabet": Alphabet(dt & 0xFF), "nseqs": nseqs,
            "use128": use128, "seqs": seqs}


# ----------------------------------------------------------------------
# Contain output
# ----------------------------------------------------------------------

def write_contain(path: str, coverage: np.ndarray, meandepth: np.ndarray
                  ) -> None:
    """coverage/meandepth: (nqueries, nref) f32."""
    nq, nref = coverage.shape
    with open(path, "wb") as f:
        np.array([nref, nq], dtype=np.uint64).tofile(f)
        np.ascontiguousarray(coverage, dtype=np.float32).tofile(f)
        np.ascontiguousarray(meandepth, dtype=np.float32).tofile(f)


def read_contain(path: str):
    with open(path, "rb") as f:
        nref, nq = (int(x) for x in np.fromfile(f, np.uint64, 2))
        cov = np.fromfile(f, np.float32, nref * nq).reshape(nq, nref)
        dep = np.fromfile(f, np.float32, nref * nq).reshape(nq, nref)
    return {"nref": nref, "nqueries": nq, "coverage_matrix": cov,
            "depth_matrix": dep}
