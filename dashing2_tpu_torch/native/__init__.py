"""Native (C++ and CUDA) components, built on demand into the port's own
build directory.

Port of dashing2_tpu/native/__init__.py (`_load_lib`, `load_oph_lib`,
`load_fastx_lib`, `load_emit_lib`, `load_myers_lib`). The C++ sources in
this directory, oph_sketch.cpp, fastx_reader.h, fastx_reader.cpp,
emit_fmt.cpp and myers_ed.cpp, are copies of the JAX package's files of
the same names in its native/ directory, line for line (one comment each
of fastx_reader.h, fastx_reader.cpp and myers_ed.cpp cites the upstream
source by name instead of by a local path); the port builds only these
copies and reads no file of the JAX package. span_ed.cpp, the
minimizer sequences' edit distance, is the port's own (the JAX package
runs that DP in numpy, cmp/editdist.py `span_edit_distance`). Unlike the
JAX loader, a
failed build raises: the port has no Python fallback for anything on its
main path (the Python FASTA parser serves only .xz and .bz2 inputs, and
the edit-distance space's raw sequences, as in the JAX package; the
Python Myers recurrence of cmp/editdist.py is a test oracle only).

`build_shared` is the one build routine. It keys each shared library on
a hash of its sources, the local headers they include, and the command
line, builds into a temporary name and renames it into place, so
concurrent processes (test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

_lock = threading.Lock()
# one lock per library, so that different libraries build in parallel
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# the last build's compiler output per library name (nvcc -Xptxas -v
# reports registers and spills there); read by chip_smoke.py
build_logs: Dict[str, str] = {}

_HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE_DIR = os.path.dirname(_HERE)


def build_dir() -> str:
    """Git-ignored build directory inside the port's package."""
    d = os.path.join(PACKAGE_DIR, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _cpu_fingerprint() -> str:
    """Short hash of the host CPU feature flags (empty if unreadable)."""
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("flags"):
                    return hashlib.sha1(ln.encode()).hexdigest()[:8]
    except OSError:
        pass
    return "noflags"


def _source_digest(sources: Sequence[str]) -> bytes:
    body = b""
    for src in sources:
        with open(src, "rb") as f:
            text = f.read()
        body += text
        # local includes participate in the content hash (editing a
        # shared header must rebuild dependents)
        for inc in re.findall(rb'#include\s+"([^"]+)"', text):
            with open(os.path.join(os.path.dirname(src), inc.decode()),
                      "rb") as hf:
                body += hf.read()
    return body


def build_shared(name: str, sources: Sequence[str],
                 command: Callable[[str], List[str]],
                 tag_extra: str = "") -> ctypes.CDLL:
    """Compile `sources` (once per content hash) with `command(out_path)`
    and load the result. Raises OSError or CalledProcessError (with the
    compiler's output) when the build fails. Different libraries may be
    built from different threads at once."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        probe = command("OUT")
        tag = hashlib.sha256(_source_digest(sources)
                             + " ".join(probe).encode()).hexdigest()[:16]
        if tag_extra:
            tag += "-" + tag_extra
        so = os.path.join(build_dir(), f"lib{name}-{tag}.so")
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            r = subprocess.run(command(tmp), capture_output=True, text=True)
            build_logs[name] = r.stdout + r.stderr
            if r.returncode != 0:
                raise subprocess.CalledProcessError(
                    r.returncode, r.args, r.stdout, r.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _libs[name] = lib
        return lib


def _gxx(src: str, link: Sequence[str], cflags: Sequence[str]):
    def cmd(out: str) -> List[str]:
        return (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
                 "-o", out] + list(cflags) + list(link))
    return cmd


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) \
        + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def nvcc_command(src: str) -> Callable[[str], List[str]]:
    """build_shared command for one CUDA source with a plain C interface:
    sm_90a, and ptxas' register/spill report kept in build_logs."""
    def cmd(out: str) -> List[str]:
        return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", out, src]
    return cmd


def load_oph_lib() -> ctypes.CDLL:
    """The native threaded OPH sketcher (the port's copy of oph_sketch.cpp),
    with the file-driver entry `oph_sketch_files`, the k-mer hash entry
    `hash_rows_native` of the counting route (`hash_rows_native128`, its
    full 128-bit keys for `--long-kmers` exact sets), `oph_update_hashed`, the
    one-permutation update over pre-hashed items (set-space intervals),
    and `oph_rows_native`, the registers of chunk rows (a second
    reference for csrc/oph_rows.cu in the tests and chip_smoke.py).
    Built with -march=native, so the build is scoped by the host's CPU
    feature flags (a library tuned for another microarchitecture loads
    fine and then dies of SIGILL)."""
    src = os.path.join(_HERE, "oph_sketch.cpp")
    lib = build_shared("ophsketch", [src],
                       _gxx(src, ["-lpthread", "-lz"],
                            ["-march=native", "-funroll-loops"]),
                       tag_extra=_cpu_fingerprint())
    if not getattr(lib, "_sigs_set", False):
        c = ctypes
        lib.oph_update_hashed.restype = None
        lib.oph_update_hashed.argtypes = [
            c.POINTER(c.c_uint64), c.c_int64, c.c_uint64, c.c_int64,
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint32)]
        lib.oph_sketch_files.restype = c.c_int64
        lib.oph_sketch_files.argtypes = [
            c.POINTER(c.c_char_p), c.POINTER(c.c_int32),
            c.c_int64, c.c_int64, c.c_char_p,
            c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.c_uint64, c.c_uint64,
            c.c_int32, c.c_uint64, c.c_uint64,
            c.c_int64, c.c_int32,
            c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_int32), c.c_int32,
            c.POINTER(c.c_uint64),
            c.POINTER(c.c_uint64), c.c_int64, c.c_int64,
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint32)]
        lib.oph_rows_native.restype = None
        lib.oph_rows_native.argtypes = [
            c.POINTER(c.c_ubyte), c.c_int64, c.c_int64,
            c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.c_uint64, c.c_uint64,
            c.c_int32, c.c_uint64, c.c_uint64, c.c_int64, c.c_int64,
            c.c_int64, c.c_int32,
            c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_int32), c.c_int32,
            c.POINTER(c.c_uint64),
            c.POINTER(c.c_uint64), c.c_int64, c.c_int64,
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint32)]
        lib.hash_rows_native.restype = c.c_int64
        lib.hash_rows_native.argtypes = [
            c.POINTER(c.c_ubyte), c.c_int64, c.c_int64,
            c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.c_uint64, c.c_int32, c.c_uint64, c.c_uint64,
            c.c_int32, c.c_int32, c.c_int32,
            c.POINTER(c.c_int32), c.c_int32,
            c.POINTER(c.c_uint64),
            c.POINTER(c.c_uint64), c.c_int64, c.c_int64,
            c.POINTER(c.c_uint64)]
        lib.hash_rows_native128.restype = c.c_int64
        lib.hash_rows_native128.argtypes = [
            c.POINTER(c.c_ubyte), c.c_int64, c.c_int64,
            c.c_int32, c.c_int32, c.c_int32, c.c_int32,
            c.c_uint64, c.c_uint64,
            c.c_int32, c.c_uint64, c.c_uint64,
            c.POINTER(c.c_uint64), c.c_int64,
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint64)]
        lib._sigs_set = True
    return lib


def load_fastx_lib() -> ctypes.CDLL:
    """The native FASTA/FASTQ reader (the port's copy of
    fastx_reader.cpp: zlib-aware, LUT encoding)."""
    src = os.path.join(_HERE, "fastx_reader.cpp")
    lib = build_shared("fastx", [src], _gxx(src, ["-lz"], []))
    if not getattr(lib, "_sigs_set", False):
        lib.fxr_open.restype = ctypes.c_void_p
        lib.fxr_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.fxr_next.restype = ctypes.c_long
        lib.fxr_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
        lib.fxr_close.restype = None
        lib.fxr_close.argtypes = [ctypes.c_void_p]
        lib._sigs_set = True
    return lib


def load_emit_lib() -> ctypes.CDLL:
    """The native float-row formatter (the port's copy of emit_fmt.cpp:
    std::to_chars shortest round-trip)."""
    src = os.path.join(_HERE, "emit_fmt.cpp")
    lib = build_shared("emitfmt", [src], _gxx(src, [], []))
    if not getattr(lib, "_sigs_set", False):
        lib.fmt_f32_rows.restype = ctypes.c_size_t
        lib.fmt_f32_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
            ctypes.c_char, ctypes.c_char_p, ctypes.c_size_t]
        lib._sigs_set = True
    return lib


def load_myers_lib() -> ctypes.CDLL:
    """Blocked Myers bit-parallel edit distance, batch and threads (the
    port's copy of myers_ed.cpp)."""
    src = os.path.join(_HERE, "myers_ed.cpp")
    lib = build_shared("myersed", [src], _gxx(src, ["-lpthread"], []))
    if not getattr(lib, "_sigs_set", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        lib.myers_batch.restype = None
        lib.myers_batch.argtypes = [u8p, i64p, i64p, i64p,
                                    ctypes.c_int64, ctypes.c_int, i64p]
        lib.myers_one.restype = ctypes.c_int64
        lib.myers_one.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib._sigs_set = True
    return lib


def load_span_lib() -> ctypes.CDLL:
    """The O(nm) edit distance over token sequences (span_ed.cpp), batch
    and threads: the minimizer-sequence distances of `--seq`."""
    src = os.path.join(_HERE, "span_ed.cpp")
    lib = build_shared("spaned", [src], _gxx(src, ["-lpthread"], []))
    if not getattr(lib, "_sigs_set", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.span_ed_batch.restype = None
        lib.span_ed_batch.argtypes = [u64p, u64p, i64p, i64p, i64p,
                                      ctypes.c_int64, ctypes.c_int, i64p]
        lib._sigs_set = True
    return lib
