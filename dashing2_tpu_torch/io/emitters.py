"""Distance-matrix emitters: PHYLIP / TSV human text and binary f32.

Copy of dashing2_tpu/io/emitters.py::emit_rectangular, cut to the
all-pairs kinds the port emits (SYMMETRIC_ALL_PAIRS, PHYLIP and
ASYMMETRIC_ALL_PAIRS). The bytes written are the JAX package's, byte for
byte. Text values are formatted by the native std::to_chars formatter
(emit_fmt.cpp), which the port requires: a failed build raises instead
of falling back.

Reference layouts (src/emitrect.cpp):
* human PHYLIP (:151): first line = N; rows: name (space-padded to >= 9
  chars) then upper-triangle values "\t{v}".
* human symmetric (:136-148,353): "#Dashing2 <label> Output",
  "#Dashing2Options: ...", "#Sources\t..." header; rows: padded name,
  (i+1) "\t-" placeholders, then upper-triangle values.
* human asymmetric: the same header, full rows.
* binary (:370-399): raw little-endian f32 — condensed upper triangle for
  symmetric/PHYLIP, full row-major N x N for asymmetric.
"""

from __future__ import annotations

import ctypes
import sys
from typing import IO, Iterator, Tuple

import numpy as np

from ..config import Dashing2DistOptions
from ..enums import OutputFormat, OutputKind
from ..result import SketchingResult
from ..timing import span
from .prefetch import prefetch


def _fmt_row(lib, vals: np.ndarray) -> str:
    """"\\t<v>" per value via the native std::to_chars formatter."""
    v = np.ascontiguousarray(vals, dtype=np.float32)
    cap = max(24 * (len(v) + 1), 64)
    buf = ctypes.create_string_buffer(cap)
    fp = v.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    n = lib.fmt_f32_rows(fp, len(v), b"\t", buf, cap)
    if n > cap:  # shouldn't happen with 24B/value headroom
        buf = ctypes.create_string_buffer(n)
        n = lib.fmt_f32_rows(fp, len(v), b"\t", buf, n)
    return buf.raw[:n].decode()


def _open_out(path: str) -> IO:
    if not path or path in ("-", "/dev/stdout"):
        return sys.stdout.buffer
    return open(path, "wb")


def emit_rectangular(opts: Dashing2DistOptions, result: SketchingResult,
                     blocks: Iterator[Tuple[int, np.ndarray]]) -> None:
    """Stream all-pairs measure-matrix blocks to the configured output:
    upper triangles for the symmetric kinds, full rows for
    ASYMMETRIC_ALL_PAIRS."""
    kind = opts.output_kind
    if kind not in (OutputKind.SYMMETRIC_ALL_PAIRS, OutputKind.PHYLIP,
                    OutputKind.ASYMMETRIC_ALL_PAIRS):
        raise NotImplementedError(
            f"{kind.name} output is not ported (ROADMAP Queue 1 item 5)")
    full_rows = kind == OutputKind.ASYMMETRIC_ALL_PAIRS
    names = result.names
    n = result.n if names else len(result.cardinalities)
    lib = None
    if opts.output_format == OutputFormat.HUMAN_READABLE:
        from ..native import load_emit_lib
        lib = load_emit_lib()
    f = _open_out(opts.outfile_path)
    close = f is not sys.stdout.buffer
    # overlap block computation with formatting/writes (the reference's
    # async emit thread, emitrect.cpp:159-197 / SURVEY P8)
    blocks = prefetch(blocks, depth=2)
    try:
        if lib is not None:
            if kind == OutputKind.PHYLIP:
                f.write(f"{n}\n".encode())
            else:
                label = "Asymmetric" if full_rows else "Symmetric"
                f.write(f"#Dashing2 {label} pairwise Output\n".encode())
                f.write(f"#Dashing2Options: {_opts_str(opts)}\n".encode())
                f.write(b"#Sources")
                for i in range(len(names)):
                    nm = names[i] if names[i] else f"E{i}"
                    f.write(("\t" + nm).encode())
                f.write(b"\n")
            for start, mat in blocks:
                with span("emit/format"):
                    out = []
                    for bi in range(mat.shape[0]):
                        i = start + bi
                        nm = (names[i] if i < len(names) and names[i]
                              else f"E{i}")
                        if len(nm) < 9:
                            nm = nm + " " * (9 - len(nm))
                        row = [nm]
                        if kind == OutputKind.SYMMETRIC_ALL_PAIRS:
                            row.append("\t-" * (i + 1))
                        row.append(_fmt_row(
                            lib, mat[bi] if full_rows else mat[bi, i + 1:]))
                        row.append("\n")
                        out.append("".join(row))
                with span("emit/write"):
                    f.write("".join(out).encode())
        else:
            for start, mat in blocks:
                with span("emit/write"):
                    if full_rows:
                        f.write(np.ascontiguousarray(
                            mat, dtype=np.float32).tobytes())
                        continue
                    for bi in range(mat.shape[0]):
                        i = start + bi
                        f.write(np.ascontiguousarray(
                            mat[bi, i + 1:], dtype=np.float32).tobytes())
    finally:
        f.flush()
        if close:
            f.close()


def _opts_str(opts: Dashing2DistOptions) -> str:
    return (f"k={opts.k};w={opts.w};space={opts.sspace.name};"
            f"result={opts.kmer_result.name};sketchsize={opts.sketchsize};"
            f"measure={opts.measure.name}")
