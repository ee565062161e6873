"""csrc/oph_rows.cu over chip_smoke.py's phase-37 corpus (32,768 records
of 1-6 kb), in turns with the kernel of commit 833c1c6 (a thread a
position, each code built from its k bases), whose Params this script
carries, and with itself under other settings of its Params.

    python3 experiments/oph_rows_turns.py [--old OLD.cu] [--probes]

OLD.cu: e.g. `git show 833c1c6:dashing2_tpu_torch/csrc/oph_rows.cu`, put
in a git-ignored directory of the checkout (chip_check/, not build/).
Run on a machine with one NVIDIA Hopper card and nvcc. Each case builds
the chunked route's batches of the corpus for its options (m = 1024
unless said) and times one pass over them per version:

- `k31` (k = 31, the yardstick of phase 37): the kernel, OLD, the
  kernel with the tested global atomicMin in place of its shared
  bucket-min (Params.smem_buckets = 0), at runs of 28 and 68 positions
  (`geometry` takes 36), and with --probes copies of the
  source with one stage taken out (PROBES; their registers are wrong,
  their times say what the stage costs);
- `m2048` to `m16384`: the kernel with the shared and with the global
  bucket-min (whichever ops/oph_rows.py's SMEM_BUCKETS_MAX_M picks, and
  the other);
- `mini` (k = 21, w = 31 minimizers), `roll` (k = 48, the rolling hash)
  and `u128` (k = 40, the 128-bit code's low word): the kernel against
  OLD; `mini` also at segments of 256, 1,024, 2,048 and 4,096 owned
  positions, each with the runs that cover it (ops/oph_rows.py
  `geometry` takes 128 runs of 28 positions, segments of 3,564; at
  commit 2d1f800 it took 512, runs of 12).

Every version of a case but the probes gives the same registers over
the corpus bit for bit (held here), and on the first 256 records of
`k31` the wrapper equals `oph_rows_plain` with counts. A version's time
is one pass over the prebuilt batches (registers reset by a copy
outside the events window; CUDA events, mean of REPS), the versions
timed in turns: each once, then each again in reverse order (a probe:
probe, kernel, probe). Prints the card's name and power limit, ptxas'
registers, each time, the bound of phase 37 (OPH_OPS reckoned int32
lane instructions a valid 31-mer), and as its last line one JSON
object, also written to chiprun_out/oph_rows_turns.json.
"""

import argparse
import ctypes
import json
import os
import re
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import chip_smoke as CS  # noqa: E402
from torch_kernel_turns import in_turns, probe_source, ptxas  # noqa: E402
from dashing2_tpu_torch import native  # noqa: E402
from dashing2_tpu_torch.config import Dashing2Options  # noqa: E402
from dashing2_tpu_torch.ops import oph_rows as OR  # noqa: E402
from dashing2_tpu_torch.sketch import core as PC  # noqa: E402

REPS = 5
# name -> (text of csrc/oph_rows.cu, its replacement): each takes one
# stage out of the kernel
PROBES = {
    # no key is hashed or bucketed: staging, rolling, the rings, flush
    "no-hash": ("    const Params& p = *cx.p;\n    const uint64_t h =",
                "    const Params& p = *cx.p;\n"
                "    if (key != p.xormask) return;\n    const uint64_t h ="),
    # the shared bucket-min without its compare-and-swap loop (racy)
    "no-shared-cas": ("atomicMin(cx.sbk + b, (unsigned long long)id);",
                      "if (id < cx.sbk[b]) cx.sbk[b] = id;"),
    # no flush of the shared buckets to the registers
    "no-flush": ("if (v != U64MAX && v < __ldcg(regs + cx.reg0 + b))",
                 "if (v == 0 && v < __ldcg(regs + cx.reg0 + b))"),
}
# case -> (options, m, {version: Params overrides}); "old" is OLD.cu
CASES = {
    "k31": (dict(k=31), 1024, {"new": {}, "old": None,
                               "global": dict(smem_buckets=0),
                               "run28": dict(seg=OR.THREADS * 28),
                               "run68": dict(seg=OR.THREADS * 68)}),
    **{f"m{m}": (dict(k=31), m, {"shared": dict(smem_buckets=1),
                                 "global": dict(smem_buckets=0)})
       for m in (2048, 4096, 8192, 16384)},
    "mini": (dict(k=21, w=31), 1024, {"new": {}, "old": None,
                                      "seg256": dict(seg=256),
                                      "seg1024": dict(seg=1024),
                                      "seg2048": dict(seg=2048),
                                      "seg4096": dict(seg=4096)}),
    "roll": (dict(k=48), 1024, {"new": {}, "old": None}),
    "u128": (dict(k=40, use128=True), 1024, {"new": {}, "old": None}),
}


class OldParams(ctypes.Structure):
    """csrc/oph_rows.cu's `Params` at commit 833c1c6."""
    _fields_ = [(f, ctypes.c_int64) for f in (
                    "R", "W", "npos", "own_lo", "own_hi", "m", "fs_len",
                    "ntiles")] \
        + [(f, ctypes.c_uint64) for f in (
            "xormask", "oph_xor", "ds_threshold", "ds_salt")] \
        + [("roll", ctypes.c_uint64 * OR.MAX_SYMBOLS)] \
        + [(f, ctypes.c_int32) for f in (
            "mode", "k", "span", "nwin", "canon", "seed_is_zero",
            "downsample", "base", "bits", "noff")] \
        + [("offsets", ctypes.c_int32 * OR.MAX_OFFSETS)]


def params(hkw, rows, m, over):
    """Params of a batch: the kernel's with `over` set (a segment length
    also sets the run that covers it), or OLD's where `over` is None."""
    p = OR.kernel_params(hkw, rows.shape[0], rows.shape[1], m, 0)
    if over is None:
        q = OldParams()
        for name, _ in OldParams._fields_:
            if name != "ntiles":
                setattr(q, name, getattr(p, name))
        return q
    for key, val in over.items():
        setattr(p, key, val)
    if "seg" in over:
        p.run = OR.run_length(-(-(p.seg + 2 * (p.nwin - 1)) // OR.THREADS))
    return p


def load(name, src, ptype):
    lib = native.build_shared(name, [src], native.nvcc_command(src))
    ptxas(name)
    lib.oph_rows.restype = ctypes.c_int
    lib.oph_rows.argtypes = [ctypes.POINTER(ptype)] + [ctypes.c_void_p] * 6
    return lib


def run_case(case, libs, fa, probes, rec):
    kw, m, versions = CASES[case]
    t0 = time.perf_counter()
    opts = Dashing2Options(sketchsize=m, parse_by_seq=True, **kw)
    items, _, hkw, batches = CS._rows_of(opts, [fa], PC.BATCH_CODES["cuda"])
    args = [(torch.from_numpy(r).cuda(), torch.from_numpy(i - i[0]).cuda(),
             int(i[-1]) - int(i[0]) + 1) for r, i in batches]
    CS._say(f"[{case}] {kw}, m = {m}: {len(items)} records, {len(args)} "
            f"batches, {time.perf_counter() - t0:.3f} s")
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib, over):
        plist = [params(hkw, r, m, over) for r, _, _ in args]
        regs = [torch.full((n, m), -1, dtype=torch.int64, device="cuda")
                for _, _, n in args]
        fresh = [g.clone() for g in regs]

        def once():
            for (r, i, _), p, g in zip(args, plist, regs):
                err = lib.oph_rows(ctypes.byref(p), r.data_ptr(),
                                   i.data_ptr(), None, g.data_ptr(), None,
                                   stream)
                assert err == 0, (case, err)

        def timed():
            total = 0.0
            for _ in range(REPS):
                for g, f in zip(regs, fresh):
                    g.copy_(f)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                once()
                e1.record()
                torch.cuda.synchronize()
                total += e0.elapsed_time(e1)
            return total / REPS
        once()
        torch.cuda.synchronize()
        return timed, [g.clone() for g in regs]
    runs = {}
    ref = None
    for name, over in versions.items():
        if over is None and "old" not in libs:
            continue
        runs[name], got = runner(libs["old" if over is None else "new"],
                                 over)
        ref = got if ref is None else ref
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            (case, name, "registers differ")
    CS._say(f"[{case}] registers of {', '.join(runs)} equal over the "
            f"corpus")
    rounds = [("turns", [(n, runs[n]) for n in list(runs) + list(runs)[::-1]])]
    if case == "k31":
        r0, i0, _ = args[0]
        cut = int(np.searchsorted(batches[0][1], CS.BYSEQ_SLICE))
        part = (r0[:cut].contiguous(), i0[:cut].contiguous())
        want = OR.oph_rows_plain(*part, CS.BYSEQ_SLICE, m, hkw, None, True)
        got = OR.oph_rows(*part, CS.BYSEQ_SLICE, m, hkw, None, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        CS._say(f"[{case}] first {CS.BYSEQ_SLICE} records == oph_rows_plain, "
                "counts too")
        for name, lib in probes.items():
            run_p, _ = runner(lib, {})
            rounds.append((name, [(name, run_p), ("new", runs["new"]),
                                  (name, run_p)]))
        nvalid = CS._valid_windows(items, CS.BYSEQ_K)
        nbases = sum(len(c) for it in items for c in it.codes)
        rec["bound_ms"], rec["bound_by"] = CS._bound(
            nvalid * CS.OPH_OPS, "int32", nbases + 8 * len(items) * m)
        CS._say(f"[bound] {rec['bound_ms']:.3f} ms ({rec['bound_by']}: "
                f"{CS.OPH_OPS} int32 lane instructions x {nvalid} valid "
                f"{CS.BYSEQ_K}-mers)")
    rec[case] = in_turns(rounds, lambda run: run())
    for name in runs:
        best = min(ms for nm, ms in rec[case]["turns"] if nm == name)
        CS._say(f"[{case}] {name}: {best:.3f} ms at best"
                + (f", {100 * rec['bound_ms'] / best:.1f}% of the bound"
                   if case == "k31" else ""))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="another source of the C entry, with "
                    "the Params of commit 833c1c6")
    ap.add_argument("--probes", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    smi = CS.phase_device()
    libs = {"new": OR.load_kernel()}
    ptxas("oph_rows")
    if a.old:
        libs["old"] = load("oph_rows_old", os.path.abspath(a.old), OldParams)
    probes = {}
    if a.probes:
        for name, (text, repl) in PROBES.items():
            src = probe_source("oph_rows", OR.SOURCE, name, (
                ((re.compile(re.escape(text)), repl.replace("\\", r"\\")),
                 1),))
            probes[name] = load(f"oph_rows_{name}", src, OR.Params)
    t0 = time.perf_counter()
    fa, _ = CS._byseq_corpus()
    CS._say(f"[corpus] {CS.BYSEQ_N} records in "
            f"{time.perf_counter() - t0:.3f} s")
    rec = {"card": smi, "smem_buckets_max_m": OR.SMEM_BUCKETS_MAX_M}
    for case in CASES:
        run_case(case, libs, fa, probes, rec)
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "oph_rows_turns.json"),
              "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
