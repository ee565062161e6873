"""A kernel on the card, timed in turns against another source of the
same C entry, and against copies of itself with parts taken out.

Run from the root of a checkout on a machine with one NVIDIA Hopper card
and nvcc:

    python3 experiments/torch_kernel_turns.py KERNEL OTHER.cu
    python3 experiments/torch_kernel_turns.py css OTHER.cu [--check]
    python3 experiments/torch_kernel_turns.py countsketch OTHER.cu

    python3 experiments/torch_kernel_turns.py hash_rows OTHER.cu

`css` (csrc/css.cu, C entry `css_pass`) is described under CSS below,
`countsketch` under COUNTSKETCH, `hash_rows` under HASH_ROWS; the rest
of this text is the nibble kernels'.

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

CSS. The operands of the FullSetSketch job's first pass, built as
ops/sketch_kernels.py `_css_batch` builds them: 5,120 items of 19,970
seeded random u64 hashes, m = 1024, x1 and rv sorted by x1, the first
6,144 rows (the cap max(4096, 6m)) kept, threshold (ln m + 8)/n. The
script

1. builds csrc/css.cu, OTHER.cu (e.g. `git show
   833c1c6:dashing2_tpu_torch/csrc/css.cu`, the PR 18 kernel: a thread a
   register) and the copies below, and prints ptxas' report;
2. holds the kernel to `css_pass_plain` bit for bit on the first 8
   items (registers, cutoffs, winners), and OTHER and every variant to
   the kernel over all items;
3. prints the lane slots a draw of both schedules, from the walks'
   lengths (`walk_draws` of OTHER's output: `lane_slot_ratio` over a
   warp and a block of 128 registers, `step_slot_ratio`), and the bound
   (chip_smoke.py's CSS_INT_OPS integer-lane instructions a draw the
   early exit evaluates);
4. unless --check: times them by CUDA events (mean of CSS_REPS launches
   after a warm-up) in turns: other, new, new, other; each variant
   (`tileN`: N registers a block, `warpsN`: N warps a block; exact) and
   probe (`nolog`: no f64 log, a draw x1 + u, so wrong registers;
   `old-nolog` the same in OTHER) as variant, new (or other), variant;
5. prints the SASS opcode counts of both kernels, writes the kernel's
   SASS to chiprun_out/css.sass, and counts the instructions of one trip
   of each walk loop (chip_smoke.py `_loop_ops`).

Its JSON goes to chiprun_out/css_turns.json.

COUNTSKETCH. csrc/countsketch.cu's batched route (C entry
`countsketch_batch`, through ops/countsketch.py) against OTHER.cu, a
source with the C entry `countsketch` of the dense-bucket kernel (e.g.
experiments/countsketch_dense.cu, or `git show
833c1c6:dashing2_tpu_torch/csrc/countsketch.cu`), run as that kernel's
whole function (chip_smoke.py `cs_dense_function`: a zeroed
cssize-sized array a stream, the kernel, nonzero, gather, cast). The
sets are chip_smoke.py's: (a) the streams of `-P -c 1048576` over the
first 8 genomes of its N = 10240 corpus, (b) 8 bacterial-genome streams
(`_cs_bacterial`), (c) the streams of `-P -c 1048576 --parse-by-seq`
over the first 8,192 records of its by-record corpus, each captured
from the port's CLI. The script

1. builds both and prints ptxas' report;
2. holds the new route, the plain version and OTHER's function equal on
   every set;
3. times the new route and OTHER's function by CUDA events (mean of a
   few calls after a warm-up) in turns: other, new, new, other;
4. builds copies of the kernel with one constant changed (CS_VARIANTS:
   `items8` 8 hashes a thread in a tile, `t2048` 2,048 entries a sparse
   bin, `bitonic` every sparse bin sorted by the bitonic sort), holds
   each to the kernel on every set and times each in turns with the
   kernel's own C entry (variant, new, variant; no wrapper in either);
5. prints each launch's device time on every set (torch.profiler);
6. times the two routes over set (c) as the sketch route runs them, by
   the host clock (`sketch/count`'s work): the streams from host memory,
   a stream at a time through OTHER's function with its ids and sums
   copied back (the dense route), and all at once through
   `countsketch_many` (one upload, one call, the copies back), in turns.

It prints its JSON as its last line.

HASH_ROWS. csrc/oph_rows.cu's `hash_rows` path against OTHER.cu, a
source of the kernel before the window stage and the compaction were
redesigned (`git show e42f2d9:dashing2_tpu_torch/csrc/oph_rows.cu`: its
`hash_rows` writes each kept token at its place with a keep flag;
segments of 512 owned positions with minimizers), over chip_smoke.py's
by-record corpus (32,768 records) in the `--seq` route's batches. The
script

1. builds both and the probes below, and prints ptxas' report and the
   kernels that spill;
2. holds the new wrapper, OTHER's whole function (as the wrapper of
   commit e42f2d9 ran it: the (R, npos) token arrays, a zeroed keep
   array, the launch, `nonzero`, the gathers, the rows' sums) and the
   plain version equal over the corpus at `-k 15 -w 31` (`seq`) and `--long-kmers -k
   40 -w 60` (`seq128`, full keys), and every run-length variant to the
   new wrapper;
3. times, by CUDA events (mean of a few calls after a warm-up), in
   turns (other, new, new, other): the whole functions, and the bare
   launches (OTHER's launch on zeroed keep flags; the new two C entries
   on the offsets of a first call); each run-length variant
   (`runN`: 128 runs of N positions a block, seg = 128 N - 2 h; the
   geometry's choice is ops/oph_rows.py `geometry`'s), the `few-warps` copy (a segment's rolled range cut
   into runs of about the geometry's over as few warps as hold them, as
   the codes that go straight to the rings are; exact) and each probe
   (`seq` only, bare, in turns with the new bare launches: `stage-only`
   leaves after staging the codes, `no-window` skips the window stage
   (no candidate), `no-tie` the tie test, `no-write` the tokens'
   writes), with the bound of chip_smoke.py's `_hash_bound`;
4. times `oph_rows` (registers only, m = 1024) at `-k 21 -w 31` (the
   window stage it shares) and at k = 31 (no minimizers), OTHER's C
   entry against the new one, both exact against each other, in turns.

Its JSON goes to chiprun_out/hash_rows_turns.json.
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


def _sass_text(so_path: str) -> str:
    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout


def _sass_counts(tag: str, so_path: str, keep: str = "") -> None:
    """Opcode counts of the SASS in a built library (cuobjdump)."""
    text = _sass_text(so_path)
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


# css: the FullSetSketch job's first pass
CSS_ITEMS, CSS_HASHES, CSS_M = 5120, 19970, 1024
CSS_REPS = 5
_CSS_TILE = re.compile(r"constexpr int TILE = \d+;")
_CSS_WARPS = re.compile(r"constexpr int WARPS = \d+;")
_CSS_LOG = (re.compile(re.escape("return __dadd_rn(-log64(u), x1);")),
            "return __dadd_rn(u, x1);")
# copies of csrc/css.cu: exact variants, and probes (wrong registers)
CSS_VARIANTS = {
    "tile128": (((_CSS_TILE, "constexpr int TILE = 128;"), 1),),
    "tile256": (((_CSS_TILE, "constexpr int TILE = 256;"), 1),),
    "warps4": (((_CSS_WARPS, "constexpr int WARPS = 4;"), 1),),
    "warps16": (((_CSS_WARPS, "constexpr int WARPS = 16;"), 1),),
}
CSS_PROBES = {"nolog": ((_CSS_LOG, 1),)}


def css_operands():
    """(sx1, srv, k, threshold) on the card, as `_css_batch` builds the
    first pass of CSS_ITEMS items of CSS_HASHES seeded random hashes."""
    from dashing2_tpu_torch.ops import sketch_kernels as SK
    rng = np.random.default_rng(2026)
    h = rng.integers(0, 1 << 64, (CSS_ITEMS, CSS_HASHES), dtype=np.uint64)
    hashed = torch.from_numpy(h.view(np.int64)).cuda()
    del h
    x1, rv = SK._css_x1(hashed, CSS_M)
    sx1, perm = torch.sort(x1, dim=1, stable=True)
    srv = torch.gather(rv, 1, perm)
    del hashed, x1, rv, perm
    cap = max(4096, 6 * CSS_M)
    k = torch.full((CSS_ITEMS,), cap, dtype=torch.int64, device="cuda")
    t = torch.full((CSS_ITEMS,), (np.log(CSS_M) + 8.0) / CSS_HASHES,
                   dtype=torch.float64, device="cuda")
    return sx1[:, :cap].contiguous(), srv[:, :cap].contiguous(), k, t


def css_main(other: str, check: bool) -> int:
    from concurrent.futures import ThreadPoolExecutor
    from dashing2_tpu_torch.ops import css as CSSOP
    smi = CS.phase_device()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    sources = {"new": CSSOP.SOURCE, "other": other}
    copies = dict(CSS_VARIANTS, **CSS_PROBES)
    for name, subs in copies.items():
        sources[name] = probe_source("css", CSSOP.SOURCE, name, subs)
    sources["old-nolog"] = probe_source("css", other, "old-nolog",
                                        CSS_PROBES["nolog"])

    def build(name):
        lib = native.build_shared(f"css_{name}", [sources[name]],
                                  native.nvcc_command(sources[name]))
        fn = lib.css_pass
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.restype = ctypes.c_int
        fn.argtypes = [p, p, p, p, ll, ll, ctypes.c_int, p, p, p, p]
        return lib
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources)))
    for name in sources:
        ptxas(f"css_{name}")

    sx1, srv, k, t = css_operands()
    B, K = sx1.shape
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def launcher(name):
        regs = torch.empty((B, CSS_M), dtype=torch.float64, device="cuda")
        tcut = torch.empty(B, dtype=torch.float64, device="cuda")
        ids = torch.empty((B, CSS_M), dtype=torch.int64, device="cuda")
        outs[name] = (regs, tcut, ids)
        fn = libs[name].css_pass

        def run():
            err = fn(sx1.data_ptr(), srv.data_ptr(), k.data_ptr(),
                     t.data_ptr(), B, K, CSS_M, regs.data_ptr(),
                     tcut.data_ptr(), ids.data_ptr(), stream)
            assert err == 0, f"{name}: CUDA error {err}"
        return run
    runs = {name: launcher(name) for name in sources}
    for run in runs.values():
        run()
    torch.cuda.synchronize()

    def bits(x):
        return x.view(torch.int64) if x.is_floating_point() else x
    cut = [x[:8].contiguous() for x in (sx1, srv, k, t)]
    want = CSSOP.css_pass_plain(*cut, CSS_M, return_ids=True)
    assert all(torch.equal(bits(g[:8]), bits(w))
               for g, w in zip(outs["new"], want)), "new != plain"
    for name in ["other"] + list(CSS_VARIANTS):
        assert all(torch.equal(bits(a), bits(b)) for a, b in
                   zip(outs[name], outs["new"])), f"{name} != new"
    CS._say(f"[exact] new == plain on 8 items; other and "
            f"{', '.join(CSS_VARIANTS)} == new on {B} items x {K} rows, "
            f"m = {CSS_M} (registers, cutoffs, winners)")

    walks = CSSOP.walk_draws(sx1, k, t, outs["other"][0], outs["other"][2])
    drawn = int(walks.sum())
    slots = {"warp": CSSOP.lane_slot_ratio(walks, 32),
             "block": CSSOP.lane_slot_ratio(walks, 128),
             "steps": CSSOP.step_slot_ratio(walks, 32)}
    probe_draws = {p: int(CSSOP.walk_draws(sx1, k, t, outs[p][0],
                                           outs[p][2]).sum())
                   for p in ("nolog", "old-nolog")}
    bound_ms = drawn * CS.CSS_INT_OPS / CS.RATES["int32"] * 1e3
    CS._say(f"[walk] {drawn} draws evaluated of {B * K * CSS_M} kept "
            f"({100 * drawn / (B * K * CSS_M):.2f}%), mean walk "
            f"{drawn / (B * CSS_M):.1f} rows; lane slots a draw: a thread "
            f"a register {slots['warp']:.4f} (warp), {slots['block']:.4f} "
            f"(block of 128); a warp a register {slots['steps']:.4f}; the "
            f"probes' own walks: {probe_draws}")
    CS._say(f"[bound] {bound_ms:.3f} ms ({CS.CSS_INT_OPS} int32 lane "
            "instructions a draw evaluated)")
    rec = {"card": smi, "kernel": "css", "items": B, "rows": K, "m": CSS_M,
           "other": other, "draws": drawn, "lane_slots": slots,
           "probe_draws": probe_draws, "bound_ms": bound_ms}
    if not check:
        rounds = [("turns", (("other", runs["other"]), ("new", runs["new"]),
                             ("new", runs["new"]),
                             ("other", runs["other"])))]
        for name in list(copies) + ["old-nolog"]:
            base = "other" if name == "old-nolog" else "new"
            rounds.append((name, ((name, runs[name]), (base, runs[base]),
                                  (name, runs[name]))))
        rec.update(in_turns(rounds, lambda run: CS._library_ms(run,
                                                                CSS_REPS)))
        best = min(ms for name, ms in rec["turns"] if name == "new")
        CS._say(f"[bound] new kernel at {100 * bound_ms / best:.1f}% of it")
    for name, keep in (("new", "css.sass"), ("other", "")):
        path = libs[name]._name
        _sass_counts(name, path, keep)
        try:
            f64, alu, trips, _ = CS._loop_ops(_sass_text(path), "css_kernel",
                                              "MUFU.RCP64")
            CS._say(f"[sass] {name}: walk loop {alu:.2f} integer-lane and "
                    f"{f64:.2f} f64 instructions a draw ({trips} a trip)")
            rec[f"loop_ops_{name}"] = [alu, f64]
        except ValueError as e:
            CS._say(f"[sass] {name}: no walk loop found ({e})")
    with open(os.path.join(ROOT, "chiprun_out", "css_turns.json"), "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return 0


# copies of csrc/countsketch.cu with one constant changed (all exact)
CS_VARIANTS = {
    "items8": (((re.compile(r"constexpr int ITEMS = 16;"),
                 "constexpr int ITEMS = 8;"), 1),),
    "t2048": (((re.compile(r"constexpr int BIN_TARGET = 1024;"),
                "constexpr int BIN_TARGET = 2048;"), 1),),
    "bitonic": (((re.compile(r"constexpr int SUB_MAX = 32;"),
                  "constexpr int SUB_MAX = 0;"), 1),),
}


def cs_variant(lib):
    """A launcher of a built copy's C entry over a set, as
    ops/countsketch.py launches it: (run, out, counts)."""
    p, ll, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
    lib.countsketch_scratch_ints.restype = ll
    lib.countsketch_scratch_ints.argtypes = [ll, ctypes.c_int]
    lib.countsketch_batch.restype = ctypes.c_int
    lib.countsketch_batch.argtypes = [p, ll, p, ctypes.c_int, ull, ull, p, p,
                                      p, p]

    def launcher(hv, offsets, cssize):
        n, S = hv.shape[0], offsets.shape[0] - 1
        out = torch.empty((n, 2), dtype=torch.int32, device="cuda")
        counts = torch.empty(S, dtype=torch.int64, device="cuda")
        off = offsets.cuda()
        scratch = torch.empty(lib.countsketch_scratch_ints(n, S),
                              dtype=torch.int32, device="cuda")

        def run():
            err = lib.countsketch_batch(
                hv.data_ptr(), n, off.data_ptr(), S, cssize,
                ((1 << 64) - 1) // cssize, scratch.data_ptr(),
                out.data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        return run, out, counts
    return launcher


def cs_sets():
    """chip_smoke.py's CountSketch sets (a), (b) and (c), (a) and (c)
    captured from the port's CLI over its corpora."""
    from dashing2_tpu_torch import cli
    lst = CS._corpus("northstar", CS.NS_SEED, CS.NS_ANCESTORS,
                     CS.NS_MUTANTS, CS.NS_LENGTH)
    with open(lst) as f:
        first8 = [ln.strip() for ln in f if ln.strip()][:8]
    CS._byseq_corpus()
    d = os.path.join(CS.WORK, "byseq")
    sets = {}
    for tag, args in (("a", first8), ("c", ["--parse-by-seq", os.path.join(
            d, "pairs.fa")])):
        rec, undo = CS._capture_countsketch()
        try:
            assert cli.main(["sketch", "-k", "31", "-S", "256", "-P", "-c",
                             "1048576", "--binary-output", "--cmpout",
                             os.path.join(CS.WORK, f"{tag}.bin")]
                            + args) == 0
        finally:
            undo()
        sets[tag] = CS._cs_set(rec)
    sets["b"] = CS._cs_bacterial(CS.CS_BACTERIA, 1 << 20)
    return sets


def countsketch_main(other: str) -> int:
    import shutil
    import time
    from concurrent.futures import ThreadPoolExecutor
    from dashing2_tpu_torch.ops import countsketch as CSOP
    smi = CS.phase_device()
    CS.CS_DENSE_SOURCE = other
    builds = {"new": CSOP.load_kernel, "dense": CS._cs_dense_lib}
    for name, subs in CS_VARIANTS.items():
        src = probe_source("countsketch", CSOP.SOURCE, name, subs)
        builds[name] = (lambda nm, sr: lambda: native.build_shared(
            f"countsketch_{nm}", [sr], native.nvcc_command(sr)))(name, src)
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(builds, pool.map(lambda f: f(), builds.values())))
    dense = libs["dense"]
    variants = {name: cs_variant(libs[name]) for name in CS_VARIANTS}
    for name in ["countsketch", "countsketch_dense"] + [
            f"countsketch_{v}" for v in CS_VARIANTS]:
        ptxas(name)
    try:
        sets = cs_sets()
    finally:
        shutil.rmtree(CS.WORK, ignore_errors=True)
    rec = {"card": smi, "kernel": "countsketch", "other": other}
    for tag, (hv, offsets, cssize) in sets.items():
        out, counts = CSOP.countsketch_batch(hv, offsets, cssize)
        pout, pcounts = CSOP.countsketch_batch_plain(hv, offsets, cssize)
        k = int(counts.sum())
        assert torch.equal(counts, pcounts) and torch.equal(out[:k],
                                                            pout[:k]), tag
        new_run, _, _ = cs_variant(libs["new"])(hv, offsets, cssize)
        CS._cs_hold(tag, out[:k], CS.cs_dense_function(dense, hv, offsets,
                                                      cssize))
        del out, pout
        CS._say(f"[exact] set {tag}: new == plain == other's function "
                f"({offsets.shape[0] - 1} streams, {hv.shape[0]} hashes, "
                f"{k} non-zero buckets)")

        def run_new():
            CSOP.countsketch_batch(hv, offsets, cssize)
        rec[f"{tag}_bare_ms"] = CS._library_ms(new_run, 5)

        def run_old():
            CS.cs_dense_function(dense, hv, offsets, cssize)
        reps = 3 if tag == "c" else 10
        rec[tag] = in_turns([("turns", (("other", run_old), ("new", run_new),
                                        ("new", run_new),
                                        ("other", run_old)))],
                            lambda run: CS._library_ms(run, reps))["turns"]
        for name, launcher in variants.items():
            run_v, vout, vcounts = launcher(hv, offsets, cssize)
            run_v()
            torch.cuda.synchronize()
            assert torch.equal(vcounts, counts) and torch.equal(
                vout[:k], CSOP.countsketch_batch(hv, offsets, cssize)[0][:k]
            ), f"{name} != new on set {tag}"
            rec[f"{tag}_{name}"] = in_turns(
                [(f"{tag} {name}", ((name, run_v), ("new", new_run),
                                    (name, run_v)))],
                lambda run: CS._library_ms(run, reps))[f"{tag} {name}"]
            del vout, run_v
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run_new()
            torch.cuda.synchronize()
        launches = {}
        for ev in prof.key_averages():
            if ev.device_time_total:
                name = re.search(r"cs_\w+(<\w+>)?", ev.key)
                launches[name.group(0) if name else ev.key.split("(")[0]
                         .strip()] = ev.device_time_total / 3e3
        rec[f"{tag}_launch_ms"] = launches
        CS._say(f"[profile] set {tag}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in sorted(launches.items(),
                                                  key=lambda kv: -kv[1])))
        nbytes = 8 * hv.shape[0] + 8 * k + 8 * offsets.shape[0]
        bound_ms, bound_by = CS._bound(hv.shape[0] * CS.CS_OPS, "int32",
                                       nbytes)
        best = {name: min(ms for nm, ms in rec[tag] if nm == name)
                for name in ("new", "other")}
        rec[f"{tag}_bound_ms"] = bound_ms
        CS._say(f"[bound] set {tag}: {bound_ms:.5f} ms ({bound_by}); new at "
                f"{100 * bound_ms / best['new']:.2f}%, other at "
                f"{100 * bound_ms / best['other']:.2f}%")
    # the two routes over set (c) as sketch/count runs them, host clock
    hv, offsets, cssize = sets["c"]
    host = hv.cpu().numpy().view(np.uint64)
    streams = [host[int(offsets[s]):int(offsets[s + 1])]
               for s in range(offsets.shape[0] - 1)]

    def route_old():
        for x in streams:
            h = torch.from_numpy(x.view(np.int64)).cuda()
            (ids, sums), = CS.cs_dense_function(
                dense, h, torch.tensor([0, len(x)]), cssize)
            ids.cpu().numpy()
            sums.cpu().numpy()

    def route_new():
        CSOP.countsketch_many(streams, cssize, "cuda")

    def wall(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    route_new()
    rec["route_c_ms"] = in_turns([("route", (
        ("other", route_old), ("new", route_new), ("new", route_new),
        ("other", route_old)))], wall)["route"]
    print(json.dumps(rec))
    return 0


# hash_rows: the --seq jobs, and the run lengths tried beside the
# geometry's
HASH_JOBS = {"seq": (dict(k=15, w=31), False),
             "seq128": (dict(k=40, w=60, use128=True), True)}
HASH_RUNS = {"seq": (20, 28, 36, 60), "seq128": (12, 28, 36, 44)}
HASH_REPS = 3
# copies of csrc/oph_rows.cu with one stage taken out (wrong tokens), or
# one choice changed (HASH_EXACT: the kernel's own tokens)
HASH_PROBES = {
    name: (((re.compile(re.escape(text)), repl), count),)
    for name, text, repl, count in (
        ("stage-only",
         "if (uhi <= ulo) {                           // no window",
         "if (true) {                                 // no window", 1),
        ("no-window", "for (int c = tid; c < nch; c += THREADS) {",
         "for (int c = tid; c < 0 * nch; c += THREADS) {", 1),
        ("no-tie", "for (int d = 1; d <= h; ++d) dup |= sc[q - d] == v;",
         "dup = v == 0;", 1),
        ("no-write", "if (c == 0 || s0 + nk > o.cap) return;",
         "if (c >= 0) return;", 1),
        ("few-warps", "const int nwu = st ? WARPS : ",
         "const int nwu = ", 1),
        ("no-unroll", "#pragma unroll 4\n", "", 3))}
HASH_EXACT = ("few-warps", "no-unroll")


def _spills(name: str) -> None:
    """The kernels of a built library that ptxas reports spilling, by
    name (demangled where c++filt is found)."""
    func, out = None, []
    for ln in native.build_logs.get(name, "").splitlines():
        if "Function properties for" in ln:
            func = ln.split("Function properties for", 1)[1].strip()
        elif "spill stores" in ln and not ln.strip().startswith(
                "0 bytes stack frame, 0 bytes spill stores"):
            out.append((func, ln.strip()))
    for func, ln in out:
        try:
            func = subprocess.run(["c++filt", func], capture_output=True,
                                  text=True, check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            pass
        CS._say(f"[spill] {name}: {func}: {ln}")
    if not out:
        CS._say(f"[spill] {name}: no kernel spills")


def _old_geometry(p):
    """OTHER's (commit e42f2d9) minimizer geometry on the new Params:
    segments of 512 owned positions, runs that cover them with their
    halos."""
    from dashing2_tpu_torch.ops import oph_rows as OR
    h = p.nwin - 1
    p.seg = 512
    p.run = OR.run_length(-(-(p.seg + 2 * h) // OR.THREADS))
    return p


def _hash_sigs(lib, old: bool):
    from dashing2_tpu_torch.ops import oph_rows as OR
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.oph_rows.restype = ctypes.c_int
    lib.oph_rows.argtypes = [ctypes.POINTER(OR.Params)] + [p] * 6
    lib.hash_rows.restype = ctypes.c_int
    lib.hash_rows.argtypes = ([ctypes.POINTER(OR.Params)] + [p] * 6 + [p]
                              if old else
                              [ctypes.POINTER(OR.Params)] + [p] * 5
                              + [ll] + [p] * 4)
    if not old:
        lib.hash_place.restype = ctypes.c_int
        lib.hash_place.argtypes = [ll, p, p, p, p, p, ll, p, p, p]
    return lib


def hash_rows_main(other: str) -> int:
    import shutil
    import time
    from concurrent.futures import ThreadPoolExecutor
    from dashing2_tpu_torch.config import Dashing2Options
    from dashing2_tpu_torch.enums import KmerSketchResultType
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.sketch import core as PC
    smi = CS.phase_device()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    sources = {"new": OR.SOURCE, "other": other}
    for name, subs in HASH_PROBES.items():
        sources[name] = probe_source("oph_rows", OR.SOURCE, name, subs)

    def build(name):
        src = sources[name]
        lib = OR.load_kernel() if name == "new" else native.build_shared(
            f"oph_rows_{name}", [src], native.nvcc_command(src))
        return _hash_sigs(lib, name == "other")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources)))
    CS._say(f"[build] {len(libs)} libraries in "
            f"{time.perf_counter() - t0:.3f} s")
    for name in ["oph_rows"] + [f"oph_rows_{n}" for n in sources
                                if n != "new"]:
        ptxas(name)
    _spills("oph_rows")
    _spills("oph_rows_other")
    fa, _ = CS._byseq_corpus()
    stream = torch.cuda.current_stream().cuda_stream
    seq = KmerSketchResultType.FULL_MMER_SEQUENCE
    rec = {"card": smi, "kernel": "hash_rows", "other": other}

    def new_bare(lib, batch, full, over=None):
        """The new two C entries over a batch, on the offsets of a first
        call: (run, outputs)."""
        r, hkw, x2 = batch
        R, L = r.shape
        prm = OR.kernel_params(hkw, R, L, 0, 0, xormask2_hi=x2)
        if over:
            prm.run = over
            prm.seg = OR.THREADS * over - 2 * (prm.nwin - 1)
        nblk = R * OR.segments(prm)
        cap = OR.token_capacity(prm)
        w = 2 if full else 1
        counts = torch.empty(nblk, dtype=torch.int64, device="cuda")
        starts = torch.empty_like(counts)
        cursor = torch.empty(1, dtype=torch.int64, device="cuda")
        slab = torch.empty((w, cap), dtype=torch.int64, device="cuda")
        out = torch.empty_like(slab)

        def ptr(t, i):
            return t[i].data_ptr() if i < t.shape[0] else None

        def main_launch():
            assert lib.hash_rows(ctypes.byref(prm), r.data_ptr(), None, None,
                                 ptr(slab, 0), ptr(slab, 1), cap,
                                 counts.data_ptr(), starts.data_ptr(),
                                 cursor.data_ptr(), stream) == 0
        main_launch()
        offsets = torch.cumsum(counts, 0) - counts
        assert int(cursor) <= cap

        def run():
            main_launch()
            assert lib.hash_place(nblk, counts.data_ptr(), starts.data_ptr(),
                                  offsets.data_ptr(), ptr(slab, 0),
                                  ptr(slab, 1), cap, ptr(out, 0),
                                  ptr(out, 1), stream) == 0
        run()
        torch.cuda.synchronize()
        total = int(cursor)
        return run, (out[0, :total], out[1, :total] if full else None,
                     counts.view(R, -1).sum(1))

    def old_parts(batch, full):
        r, hkw, x2 = batch
        R, L = r.shape
        prm = _old_geometry(OR.kernel_params(hkw, R, L, 0, 0,
                                             xormask2_hi=x2))
        npos = prm.npos
        tok = torch.empty((R, npos), dtype=torch.int64, device="cuda")
        hi = torch.empty_like(tok) if full else None
        return prm, tok, hi, npos

    def old_function(batch, full):
        prm, tok, hi, npos = old_parts(batch, full)
        r = batch[0]
        keep = torch.zeros((r.shape[0], npos), dtype=torch.uint8,
                           device="cuda")
        assert libs["other"].hash_rows(
            ctypes.byref(prm), r.data_ptr(), None, None, tok.data_ptr(),
            hi.data_ptr() if full else None, keep.data_ptr(), stream) == 0
        at = keep.view(-1).nonzero().squeeze(1)
        return (tok.view(-1)[at], hi.view(-1)[at] if full else None,
                keep.sum(1, dtype=torch.int64))

    def old_bare(batch, full):
        prm, tok, hi, npos = old_parts(batch, full)
        r = batch[0]
        keeps = [torch.zeros((r.shape[0], npos), dtype=torch.uint8,
                             device="cuda") for _ in range(HASH_REPS + 1)]
        state = {"i": 0}

        def run():
            keep = keeps[state["i"] % len(keeps)]
            state["i"] += 1
            assert libs["other"].hash_rows(
                ctypes.byref(prm), r.data_ptr(), None, None, tok.data_ptr(),
                hi.data_ptr() if full else None, keep.data_ptr(),
                stream) == 0
        return run

    def same(a, b):
        return all((x is None) == (y is None) and (
            x is None or torch.equal(x, y)) for x, y in zip(a, b))

    def wrapper(batch):
        r, hkw, x2 = batch
        return OR.hash_rows(r, hkw, None, x2)

    for job, (kw, full) in HASH_JOBS.items():
        opts = Dashing2Options(parse_by_seq=True, kmer_result=seq, **kw)
        items, _, hkw, batches = CS._rows_of(opts, [fa],
                                             PC.BATCH_CODES["cuda"])
        x2 = opts.xormask2_hi if full else None
        on_card = [(torch.from_numpy(r).cuda(), hkw, x2) for r, _ in batches]
        kept = 0
        for b in on_card:
            got = wrapper(b)
            assert same(got, old_function(b, full)), job
            assert same(got, OR.hash_rows_plain(b[0], b[1], None, b[2])), job
            kept += int(got[2].sum())
        bound_ms, bound_by, nvalid = CS._hash_bound(items, kw["k"], kw["w"],
                                                    full, kept)
        rec[f"{job}_bound_ms"] = bound_ms
        CS._say(f"[exact] {job}: new == other's function == plain over "
                f"{len(items)} records, {len(on_card)} batches, {kept} "
                f"tokens; bound {bound_ms:.4f} ms ({bound_by}, {nvalid} "
                "valid positions)")

        def new_fn():
            for b in on_card:
                wrapper(b)

        def old_fn():
            for b in on_card:
                old_function(b, full)
        bare_new = [new_bare(libs["new"], b, full)[0] for b in on_card]
        bare_old = [old_bare(b, full) for b in on_card]

        def runner(runs):
            def run():
                for f in runs:
                    f()
            return run
        rounds = [("function", (("other", old_fn), ("new", new_fn),
                                ("new", new_fn), ("other", old_fn))),
                  ("bare", (("other", runner(bare_old)),
                            ("new", runner(bare_new)),
                            ("new", runner(bare_new)),
                            ("other", runner(bare_old))))]
        for run_len in HASH_RUNS[job]:
            runs = []
            for b in on_card:
                run, got = new_bare(libs["new"], b, full, run_len)
                assert same(got, wrapper(b)), (job, run_len)
                runs.append(run)
            rounds.append((f"run{run_len}", ((f"run{run_len}", runner(runs)),
                                             ("new", runner(bare_new)),
                                             (f"run{run_len}",
                                              runner(runs)))))
        for name in HASH_PROBES:
            if job != "seq" and name not in HASH_EXACT:
                continue
            runs = []
            for b in on_card:
                run, got = new_bare(libs[name], b, full)
                assert name not in HASH_EXACT or same(got, wrapper(b))
                runs.append(run)
            rounds.append((name, ((name, runner(runs)),
                                  ("new", runner(bare_new)),
                                  (name, runner(runs)))))
        out = in_turns(rounds, lambda run: CS._library_ms(run, HASH_REPS))
        rec[job] = out
        for key in ("function", "bare"):
            best = {n: min(ms for nm, ms in out[key] if nm == n)
                    for n in ("new", "other")}
            CS._say(f"[bound] {job} {key}: new {best['new']:.4f} ms "
                    f"({100 * bound_ms / best['new']:.1f}%), other "
                    f"{best['other']:.4f} ms "
                    f"({100 * bound_ms / best['other']:.1f}%)")
        del on_card, bare_new, bare_old
        torch.cuda.empty_cache()
    # oph_rows: the window stage at k = 21, w = 31, and k = 31
    for job, kw in (("oph-k21-w31", dict(k=21, w=31)), ("oph-k31", dict(
            k=31))):
        m = 1024
        opts = Dashing2Options(sketchsize=m, parse_by_seq=True, **kw)
        items, _, hkw, batches = CS._rows_of(opts, [fa],
                                             PC.BATCH_CODES["cuda"])
        args = [(torch.from_numpy(r).cuda(),
                 torch.from_numpy(i - i[0]).cuda(),
                 int(i[-1]) - int(i[0]) + 1) for r, i in batches]

        def oph(name):
            lib = libs[name]
            plist = []
            for r, _, _ in args:
                prm = OR.kernel_params(hkw, r.shape[0], r.shape[1], m, 0)
                plist.append(_old_geometry(prm) if name == "other"
                             and "w" in kw else prm)
            regs = [torch.empty((n, m), dtype=torch.int64, device="cuda")
                    for _, _, n in args]

            def run():
                for (r, i, _), prm, g in zip(args, plist, regs):
                    g.fill_(-1)
                    assert lib.oph_rows(ctypes.byref(prm), r.data_ptr(),
                                        i.data_ptr(), None, g.data_ptr(),
                                        None, stream) == 0
            run()
            torch.cuda.synchronize()
            return run, [g.clone() for g in regs]
        run_new, got_new = oph("new")
        run_old, got_old = oph("other")
        assert all(torch.equal(a, b) for a, b in zip(got_new, got_old)), job
        rec[job] = in_turns([(job, (("other", run_old), ("new", run_new),
                                    ("new", run_new), ("other", run_old)))],
                            lambda run: CS._library_ms(run, HASH_REPS))[job]
        CS._say(f"[exact] {job}: new registers == other's over "
                f"{len(items)} records")
        del args
        torch.cuda.empty_cache()
    shutil.rmtree(CS.WORK, ignore_errors=True)
    with open(os.path.join(ROOT, "chiprun_out", "hash_rows_turns.json"),
              "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec))
    return 0


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "hash_rows":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        return hash_rows_main(os.path.abspath(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "countsketch":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        return countsketch_main(os.path.abspath(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "css":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        return css_main(os.path.abspath(sys.argv[2]),
                        "--check" in sys.argv[3:])
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
