"""tri_eq on the card: csrc/tri_eq.cu timed in turns against another
source of the same C entry, and against its own products alone.

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and nvcc:

    python3 experiments/torch_tri_eq_turns.py OTHER/tri_eq.cu

OTHER/tri_eq.cu is any source with the C entry `tri_eq_counts_u16` (for
example an earlier commit's tri_eq.cu, from `git show`). At N = 10240,
m = 1024, on seeded random registers, the script

1. builds csrc/tri_eq.cu and OTHER (sm_90a), prints ptxas' register,
   shared memory and spill report, and holds both to
   `tri_eq_counts_plain` exactly (u16);
2. times them by CUDA events (mean of 20 launches after a warm-up) in
   turns: other, new, new, other;
3. builds a probe, a copy of csrc/tri_eq.cu in the build directory whose
   fragment words are the staged bytes themselves (no one-hot build, so
   wrong counts), and times it in turns with the kernel (probe, new,
   probe): the products, loads and staging alone;
4. prints the kernel's SASS opcode counts (cuobjdump) and writes its SASS
   to chiprun_out/tri_eq.sass.

Exactness at every other shape, the bound's rates and the library call
are chip_smoke.py's; this script takes its helpers from there. Prints
the card's name and power limit, and as its last line one JSON object,
also written to chiprun_out/tri_eq_turns.json.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from dashing2_tpu_torch import native  # noqa: E402
from dashing2_tpu_torch.ops import nibble_tri as NT  # noqa: E402

N, M = 10240, 1024
# a fragment word of the kernel: shl(1u, nib8<B, H>(w) ^ c)
_WORD = re.compile(r"shl\(1u, nib8<B, (\d)>\(([^()]*)\) \^ c[ab]\)")


def _sass_counts(so_path: str) -> None:
    """Opcode counts of the SASS in a built library (cuobjdump)."""
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(ROOT, "chiprun_out", "tri_eq.sass"), "w") as f:
        f.write(text)
    counts = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln.startswith("/*") or "*/" not in ln:
            continue
        body = ln.split("*/", 1)[1].strip().rstrip(" ;")
        if not body or body.startswith("/*"):
            continue
        words = body.split()
        op = (words[1] if words[0].startswith("@") else words[0]).split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    CS._say("[sass] " + ", ".join(f"{k} {v}" for k, v in top))


def _probe_source() -> str:
    """csrc/tri_eq.cu with every fragment word replaced by the staged
    word shifted to its byte, written into the build directory."""
    with open(NT.SOURCE) as f:
        src, n = _WORD.subn(r"((\2) >> (8 * B + 4 * \1))", f.read())
    assert n == 6, f"expected 6 fragment words in tri_eq.cu, found {n}"
    path = os.path.join(native.build_dir(), "tri_eq_probe.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def _bind(lib):
    lib.tri_eq_counts_u16.restype = ctypes.c_int
    lib.tri_eq_counts_u16.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _ptxas(name: str) -> None:
    for ln in native.build_logs.get(name, "").splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            CS._say(f"[build] ptxas {name}: {ln.strip()}")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    smi = CS.phase_device()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    lib_new = NT.load_kernel()
    _ptxas("tri_eq")
    lib_other = _bind(native.build_shared(
        "tri_eq_other", [other], native.nvcc_command(other)))
    _ptxas("tri_eq_other")
    probe = _probe_source()
    lib_probe = _bind(native.build_shared(
        "tri_eq_probe", [probe], native.nvcc_command(probe)))
    _ptxas("tri_eq_probe")
    _sass_counts(lib_new._name)

    rng = np.random.default_rng(2026)
    packed = torch.from_numpy(rng.integers(0, 256, size=(N, M // 2),
                                           dtype=np.uint8)).cuda()
    words = NT.packed_words(packed, 16)
    out = torch.empty((N, N), dtype=torch.uint16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib):
        def run():
            err = lib.tri_eq_counts_u16(words.data_ptr(), N,
                                        words.shape[1] // 4, M,
                                        out.data_ptr(), stream)
            assert err == 0, err
        return run
    run_new, run_other, run_probe = map(launcher,
                                        (lib_new, lib_other, lib_probe))
    want = NT.tri_eq_counts_plain(packed, M)
    for name, run in (("new", run_new), ("other", run_other)):
        run()
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"{name} != plain at N = {N}"
    del want
    CS._say(f"[exact] new and other == plain (u16) at N = {N}, m = {M}")

    rec = {"card": smi, "n": N, "m": M, "other": sys.argv[1]}
    rec["bound_ms"], rec["bound_by"] = CS._bound(
        N * (N + 1) // 2 * 16 * M * 2, "int8", N * M // 2 + 2 * N * N)
    for key, turns in (("turns", (("other", run_other), ("new", run_new),
                                  ("new", run_new), ("other", run_other))),
                       ("probe", (("probe", run_probe), ("new", run_new),
                                  ("probe", run_probe)))):
        rec[key] = []
        for name, run in turns:
            ms = CS._library_ms(run, 20)
            rec[key].append([name, ms])
            CS._say(f"[{key}] {name} {ms:.6f} ms")
    best = min(ms for name, ms in rec["turns"] if name == "new")
    CS._say(f"[bound] {rec['bound_ms']:.6f} ms ({rec['bound_by']}); new "
            f"kernel at {100 * rec['bound_ms'] / best:.1f}% of it")
    with open(os.path.join(ROOT, "chiprun_out", "tri_eq_turns.json"),
              "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
