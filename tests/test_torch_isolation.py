"""The port stands alone: importing it loads neither jax nor the JAX
package, its sources name no path under the JAX package (it builds its
own copies of the C++ sources), and a CUDA request on a machine without
a card fails instead of running on the CPU."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import dashing2_tpu_torch, dashing2_tpu_torch.cli
import dashing2_tpu_torch.cmp.core, dashing2_tpu_torch.sketch.core
import dashing2_tpu_torch.io.emitters, dashing2_tpu_torch.ops.nibble_tri
import dashing2_tpu_torch.ops.nibble_comb, dashing2_tpu_torch.cmp.estimators
import dashing2_tpu_torch.ops.gtlt, dashing2_tpu_torch.ops.cmp_kernels
import dashing2_tpu_torch.ops.int_counts, dashing2_tpu_torch.ops.pair_counts
import dashing2_tpu_torch.cmp.graph, dashing2_tpu_torch.cmp.lsh
import dashing2_tpu_torch.io.formats, dashing2_tpu_torch.io.fastx
import dashing2_tpu_torch.ops.hashes, dashing2_tpu_torch.ops.sketch_kernels
import dashing2_tpu_torch.sketch.intervals, dashing2_tpu_torch.sketch.wsketch
import dashing2_tpu_torch.cmp.contain, dashing2_tpu_torch.io.bigwig
import dashing2_tpu_torch.sketch.weighted
import dashing2_tpu_torch.ops.weighted_draws
import dashing2_tpu_torch.ops.omh, dashing2_tpu_torch.sketch.omh
import dashing2_tpu_torch.cmp.editdist, dashing2_tpu_torch.io.seqstore
import dashing2_tpu_torch.ops.oph_rows, dashing2_tpu_torch.ops.kmers
import dashing2_tpu_torch.ops.css, dashing2_tpu_torch.ops.countsketch
import dashing2_tpu_torch.io.cache
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "dashing2_tpu."))
             or m == "dashing2_tpu")
print(bad)
assert not bad, bad
assert "triton" not in sys.modules
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _cuda_job_without_card(tmp_path, flags):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fa = tmp_path / "a.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n")
    out = tmp_path / "out.bin"
    r = subprocess.run(
        [sys.executable, "-m", "dashing2_tpu_torch", "sketch", "-k", "31",
         "-S", "64"] + flags + ["--binary-output", "--cmpout", str(out),
                                str(fa), str(fa)],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=120)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
    assert not out.exists()


def test_cli_default_cuda_device_fails_without_a_card(tmp_path):
    _cuda_job_without_card(tmp_path, ["--fastcmp", "0.5", "--bbit-sigs"])


def test_full_register_job_on_cuda_fails_without_a_card(tmp_path):
    """The default job (no --fastcmp) with the default --device cuda."""
    _cuda_job_without_card(tmp_path, [])


@pytest.mark.parametrize("job", ["bed", "wsketch", "contain", "edit",
                                 "byseq", "xz", "cache", "countsketch"])
def test_new_subcommands_on_cuda_fail_without_a_card(tmp_path, job):
    """`sketch --bed -B`, `wsketch`, `contain`, `sketch -E`, the chunked
    route (`--parse-by-seq`, an .xz input), `--full-setsketch --cache`
    and `-P -c` with the default --device cuda exit non-zero without a
    card and write nothing (no cache file either)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    (tmp_path / "a.bed").write_text("chr1\t0\t100\n")
    (tmp_path / "ids.u64").write_bytes(bytes(8 * 4))
    (tmp_path / "a.fa").write_text(">a\nACGTACGTACGTACGTACGTACGTACGT\n")
    import lzma
    with lzma.open(tmp_path / "a.fa.xz", "wb") as f:
        f.write(b">a\nACGTACGTACGTACGTACGTACGTACGT\n")
    argv = {"bed": ["sketch", "--bed", "-B", "--binary-output", "--cmpout",
                    "out", "a.bed", "a.bed"],
            "wsketch": ["wsketch", "-o", "out", "ids.u64"],
            "contain": ["contain", "--cmpout", "out", "db.kmer64",
                        "a.fa"],
            "edit": ["sketch", "-E", "--parse-by-seq", "-k", "9",
                     "--cmpout", "out", "a.fa"],
            "byseq": ["sketch", "--parse-by-seq", "-k", "9", "--cmpout",
                      "out", "a.fa"],
            "xz": ["sketch", "-k", "9", "-o", "out", "a.fa.xz",
                   "a.fa"],
            "cache": ["sketch", "-k", "9", "--full-setsketch", "--cache",
                      "--outprefix", ".", "-o", "out", "a.fa", "a.fa"],
            "countsketch": ["sketch", "-k", "9", "-P", "-c", "64", "-o",
                            "out", "a.fa", "a.fa"]}[job]
    r = subprocess.run([sys.executable, "-m", "dashing2_tpu_torch"] + argv,
                       cwd=str(tmp_path), env=_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("out") or ".k9." in f]


def _names_jax_path(value: str) -> bool:
    """A string that names the JAX package's directory, or a path in it,
    as a path component (not `dashing2_tpu_torch`)."""
    return re.search(r"(^|[/\\])dashing2_tpu([/\\]|$)", value) is not None


def _python_offenders(path: str):
    """String constants in a Python source that name a path under the JAX
    package: one that is that directory's name (a component handed to
    os.path.join or Path), or a path under it passed straight to a call
    (open, os.path.join, a build). Docstrings and comments only cite the
    reference and are not read."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docstrings.add(id(first.value))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings \
                and node.value.strip("/\\") == "dashing2_tpu":
            bad.append((node.lineno, node.value))
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [k.value for k in node.keywords]:
                parts = (arg.values if isinstance(arg, ast.JoinedStr)
                         else [arg])
                for p in parts:
                    if isinstance(p, ast.Constant) and isinstance(p.value, str) \
                            and _names_jax_path(p.value):
                        bad.append((p.lineno, p.value))
    return sorted(set(bad))


def _port_sources():
    pkg = os.path.join(ROOT, "dashing2_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(pkg):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        out += [os.path.join(d, f) for f in sorted(files)
                if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h"))]
    return out


def test_port_sources_name_no_path_under_the_jax_package():
    """The port builds and reads only its own files: no Python source of
    the port, nor chip_smoke.py, builds a path into dashing2_tpu/, and no
    C++ or CUDA source includes a file from there."""
    bad = {}
    for path in _port_sources():
        if path.endswith(".py"):
            hits = _python_offenders(path)
        else:
            with open(path) as f:
                hits = [(i + 1, ln.strip()) for i, ln in enumerate(f)
                        if ln.lstrip().startswith("#include")
                        and _names_jax_path(ln.split("include", 1)[1]
                                            .strip().strip('"<>'))]
        if hits:
            bad[os.path.relpath(path, ROOT)] = hits
    assert not bad, bad


def test_path_check_sees_a_path_into_the_jax_package(tmp_path):
    """The check above flags the two ways a source can name such a path."""
    src = tmp_path / "probe.py"
    src.write_text('"""cites dashing2_tpu/native/oph_sketch.cpp"""\n'
                   "import os\n"
                   'a = os.path.join(ROOT, "dashing2_tpu", "native")\n'
                   'b = open(f"{ROOT}/dashing2_tpu/native/emit_fmt.cpp")\n'
                   'c = "dashing2_tpu_torch"\n')
    assert [ln for ln, _ in _python_offenders(str(src))] == [3, 4]


@pytest.mark.parametrize("name", ["oph_sketch.cpp", "fastx_reader.h",
                                  "emit_fmt.cpp", "fastx_reader.cpp",
                                  "myers_ed.cpp"])
def test_native_sources_are_copies_of_the_jax_package(name):
    """Line for line the JAX package's file; only a `//` comment line may
    be worded otherwise (fastx_reader.h, fastx_reader.cpp and
    myers_ed.cpp cite the upstream source by name where the JAX files
    give a local path)."""
    with open(os.path.join(ROOT, "dashing2_tpu_torch", "native", name)) as f:
        port = f.read().splitlines()
    with open(os.path.join(ROOT, "dashing2_tpu", "native", name)) as f:
        jax = f.read().splitlines()
    assert len(port) == len(jax)
    differ = [(a, b) for a, b in zip(port, jax) if a != b]
    assert all(a.lstrip().startswith("//") and b.lstrip().startswith("//")
               for a, b in differ), differ
    assert len(differ) <= 1
