"""A nibble kernel on the card, timed in turns against another source of
the same C entry, and against copies of itself with parts taken out.

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and nvcc:

    python3 experiments/torch_kernel_turns.py KERNEL OTHER.cu

KERNEL is `tri_eq` (csrc/tri_eq.cu, C entry `tri_eq_counts_u16`) or
`tri_comb` (csrc/tri_comb.cu, `tri_comb_counts_u16`). OTHER.cu is any
source with the same C entry, for example an earlier commit's
(`git show REV:dashing2_tpu_torch/csrc/tri_comb.cu > OTHER.cu`). At
N = 10240, m = 1024, on seeded random registers, the script

1. builds the kernel and OTHER (sm_90a), prints ptxas' register, shared
   memory and spill report, and holds both to the plain version exactly
   (u16; eq, and gt for tri_comb);
2. times them by CUDA events (mean of 20 launches after a warm-up) in
   turns: other, new, new, other;
3. builds probes, copies of the kernel's source in the build directory
   with parts taken out (wrong counts), and times each in turns with the
   kernel (probe, new, probe):
   - `products`: every fragment word is the staged word shifted to its
     byte (no one-hot or combined build) and, for tri_comb, one decode
     after the last chunk only: the products, loads, staging and
     epilogue alone;
   - `decode` (tri_comb): the same with the decode kept;
4. prints the SASS opcode counts (cuobjdump) of the kernel and of OTHER
   and writes the kernel's SASS to chiprun_out/KERNEL.sass.

Exactness at every other shape, the bound's rates and the library call
are chip_smoke.py's; this script takes its helpers from there. Prints
the card's name and power limit, and as its last line one JSON object,
also written to chiprun_out/KERNEL_turns.json.
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
from dashing2_tpu_torch.ops import nibble_comb as NC  # noqa: E402
from dashing2_tpu_torch.ops import nibble_tri as NT  # noqa: E402

N, M = 10240, 1024
# the kernels' fragment words: shl(1u, nib8<B, H>(w) ^ ca) (A and, in
# tri_eq, B) and bwords<B>(tb, w) (tri_comb's B pair, from its table)
_ONEHOT = (re.compile(r"shl\(1u, nib8<B, (\d)>\(([^()]*)\) \^ c[ab]\)"),
           r"((\2) >> (8 * B + 4 * \1))")
_COMBINED = (re.compile(r"bwords<B>\(tb, ([^()]*)\)"),
             r"make_uint2((\1) >> (8 * B), (\1) >> (8 * B + 4))")
# tri_comb's decode, kept only after the last chunk (the partials must
# reach the output, or the products are dead code)
_DECODE = (re.compile(r"decode\(acc, tot\);"),
           "if (s + 1 == nstages) decode(acc, tot);")
# per kernel: module, C entry, outputs, and each probe's substitutions
# with the count each must make
KERNELS = {
    "tri_eq": (NT, "tri_eq_counts_u16", 1, {
        "products": ((_ONEHOT, 6),)}),
    "tri_comb": (NC, "tri_comb_counts_u16", 2, {
        "products": ((_ONEHOT, 4), (_COMBINED, 1), (_DECODE, 1)),
        "decode": ((_ONEHOT, 4), (_COMBINED, 1))}),
}


def _sass_counts(tag: str, so_path: str, keep: str = "") -> None:
    """Opcode counts of the SASS in a built library (cuobjdump)."""
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    if keep:
        with open(os.path.join(ROOT, "chiprun_out", keep), "w") as f:
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
    CS._say(f"[sass] {tag}: " + ", ".join(f"{k} {v}" for k, v in top))


def probe_source(kernel: str, source: str, probe: str, subs) -> str:
    """`source` with the probe's substitutions, written into the build
    directory."""
    with open(source) as f:
        src = f.read()
    for (pattern, repl), want in subs:
        src, n = pattern.subn(repl, src)
        assert n == want, f"{probe}: expected {want} of {pattern.pattern}, found {n}"
    path = os.path.join(native.build_dir(), f"{kernel}_{probe}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def ptxas(name: str) -> None:
    for ln in native.build_logs.get(name, "").splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            CS._say(f"[build] ptxas {name}: {ln.strip()}")


def in_turns(rounds, timer):
    """{round: [[name, ms], ...]}: each round's (name, run) pairs timed
    by `timer(run)` in the order given, each time printed."""
    out = {}
    for key, turns in rounds:
        out[key] = []
        for name, run in turns:
            ms = timer(run)
            out[key].append([name, ms])
            CS._say(f"[{key}] {name} {ms:.6f} ms")
    return out


def main() -> int:
    if len(sys.argv) != 3 or sys.argv[1] not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    kernel, other = sys.argv[1], os.path.abspath(sys.argv[2])
    mod, entry, nout, probes = KERNELS[kernel]
    smi = CS.phase_device()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)

    def build(name, source):
        lib = native.build_shared(name, [source], native.nvcc_command(source))
        ptxas(name)
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * (nout + 1)
        return lib, fn
    lib_new, fn_new = build(kernel, mod.SOURCE)
    lib_other, fn_other = build(f"{kernel}_other", other)
    fn_probes = {p: build(f"{kernel}_{p}", probe_source(
        kernel, mod.SOURCE, p, subs))[1] for p, subs in probes.items()}
    _sass_counts("new", lib_new._name, f"{kernel}.sass")
    _sass_counts("other", lib_other._name)

    rng = np.random.default_rng(2026)
    packed = torch.from_numpy(rng.integers(0, 256, size=(N, M // 2),
                                           dtype=np.uint8)).cuda()
    words = NT.packed_words(packed, 16)
    outs = [torch.empty((N, N), dtype=torch.uint16, device="cuda")
            for _ in range(nout)]
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(fn):
        def run():
            err = fn(words.data_ptr(), N, words.shape[1] // 4, M,
                     *[o.data_ptr() for o in outs], stream)
            assert err == 0, err
        return run
    run_new, run_other = launcher(fn_new), launcher(fn_other)
    want = (NT.tri_eq_counts_plain(packed, M),) if nout == 1 else \
        NC.tri_comb_counts_plain(packed, M)
    for name, run in (("new", run_new), ("other", run_other)):
        run()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o, w), f"{name} != plain at N = {N}"
    del want
    CS._say(f"[exact] new and other == plain (u16) at N = {N}, m = {M}")

    rec = {"card": smi, "kernel": kernel, "n": N, "m": M,
           "other": sys.argv[2]}
    rec["bound_ms"], rec["bound_by"] = CS._bound(
        N * (N + 1) // 2 * 16 * M * 2, "int8",
        N * M // 2 + 2 * nout * N * N)
    rounds = [("turns", (("other", run_other), ("new", run_new),
                         ("new", run_new), ("other", run_other)))]
    for p, fn in fn_probes.items():
        run_p = launcher(fn)
        rounds.append((p, ((p, run_p), ("new", run_new), (p, run_p))))
    rec.update(in_turns(rounds, lambda run: CS._library_ms(run, 20)))
    best = min(ms for name, ms in rec["turns"] if name == "new")
    CS._say(f"[bound] {rec['bound_ms']:.6f} ms ({rec['bound_by']}); new "
            f"kernel at {100 * rec['bound_ms'] / best:.1f}% of it")
    with open(os.path.join(ROOT, "chiprun_out", f"{kernel}_turns.json"),
              "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
