"""FASTA/FASTQ reading (kseq-equivalent host ingest).

Copy of dashing2_tpu/io/fastx.py's `xopen`, `read_fastx` and
`read_encoded`: the native reader (the port's copy of fastx_reader.cpp)
for plain and gzip inputs, the Python parser for .xz and .bz2 only. A
failed native build raises; nothing falls back to the Python parser.
"""

from __future__ import annotations

import bz2
import ctypes
import gzip
import lzma
from typing import Iterator, List, Tuple

import numpy as np


def xopen(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".xz"):
        return lzma.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    return open(path, "rb")


def read_fastx(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence) from FASTA or FASTQ (auto-detected)."""
    with xopen(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == b">":
            name = None
            chunks: List[bytes] = []
            for raw in _lines(f, b">"):
                if raw.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(chunks)
                    name = raw[1:].split()[0].decode() if len(raw) > 1 else ""
                    chunks = []
                else:
                    chunks.append(raw.strip())
            if name is not None:
                yield name, b"".join(chunks)
        elif first == b"@":
            # FASTQ: 4-line records
            name_line = b"@" + f.readline()
            while name_line and name_line.strip():
                name = name_line[1:].split()[0].decode()
                seq = f.readline().strip()
                f.readline()  # +
                f.readline()  # qual
                yield name, seq
                name_line = f.readline()
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _lines(f, first_prefix: bytes) -> Iterator[bytes]:
    yield first_prefix + f.readline()
    for line in f:
        yield line


def read_encoded(path: str, alphabet) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, alphabet-encoded uint8 codes) per record: the native
    reader, or the Python parser for .xz/.bz2 inputs."""
    from ..native import load_fastx_lib
    from ..ops.kmers import alphabet_lut

    if path.endswith((".xz", ".bz2")):
        lut = alphabet_lut(alphabet)
        for name, seq in read_fastx(path):
            yield name, lut[np.frombuffer(seq, dtype=np.uint8)]
        return
    lib = load_fastx_lib()
    h = lib.fxr_open(path.encode(), alphabet_lut(alphabet).tobytes())
    if not h:
        raise OSError(f"failed to open {path}")
    try:
        name_p = ctypes.c_char_p()
        seq_p = ctypes.POINTER(ctypes.c_ubyte)()
        while True:
            n = lib.fxr_next(h, ctypes.byref(name_p), ctypes.byref(seq_p))
            if n < 0:
                if n == -2:
                    raise ValueError(f"{path}: malformed FASTA/FASTQ")
                break
            codes = np.ctypeslib.as_array(seq_p, shape=(n,)).copy()
            yield (name_p.value or b"").decode(), codes
    finally:
        lib.fxr_close(h)
