"""Native (C++ and CUDA) components, built on demand into the port's own
build directory.

Port of dashing2_tpu/native/__init__.py (`_load_lib`, `load_oph_lib`,
`load_emit_lib`). The C++ sources are the JAX package's own
(dashing2_tpu/native/oph_sketch.cpp and emit_fmt.cpp), compiled by file
path: reading a source file is not importing the package. Unlike the
JAX loader, a failed build raises: the port has no Python fallback for
anything on its main path.

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
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# the last build's compiler output per library name (nvcc -Xptxas -v
# reports registers and spills there); read by chip_smoke.py
build_logs: Dict[str, str] = {}

_HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE_DIR = os.path.dirname(_HERE)
# the JAX package's C++ sources, read by path (never imported)
JAX_NATIVE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "dashing2_tpu",
                              "native")


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
    compiler's output) when the build fails."""
    with _lock:
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


def load_oph_lib() -> ctypes.CDLL:
    """The JAX package's native threaded OPH sketcher (oph_sketch.cpp),
    with the file-driver entry `oph_sketch_files` the slice calls.
    Built with -march=native, so the build is scoped by the host's CPU
    feature flags (a library tuned for another microarchitecture loads
    fine and then dies of SIGILL)."""
    src = os.path.join(JAX_NATIVE_DIR, "oph_sketch.cpp")
    lib = build_shared("ophsketch", [src],
                       _gxx(src, ["-lpthread", "-lz"],
                            ["-march=native", "-funroll-loops"]),
                       tag_extra=_cpu_fingerprint())
    if not getattr(lib, "_sigs_set", False):
        c = ctypes
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
        lib._sigs_set = True
    return lib


def load_emit_lib() -> ctypes.CDLL:
    """The JAX package's native float-row formatter (emit_fmt.cpp:
    std::to_chars shortest round-trip)."""
    src = os.path.join(JAX_NATIVE_DIR, "emit_fmt.cpp")
    lib = build_shared("emitfmt", [src], _gxx(src, [], []))
    if not getattr(lib, "_sigs_set", False):
        lib.fmt_f32_rows.restype = ctypes.c_size_t
        lib.fmt_f32_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
            ctypes.c_char, ctypes.c_char_p, ctypes.c_size_t]
        lib._sigs_set = True
    return lib
