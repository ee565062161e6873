"""On-card smoke run of the PyTorch/CUDA port (dashing2_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA Hopper
card (H100), CUDA's nvcc, g++ and zlib:

    python3 chip_smoke.py

It builds every kernel of the port's main paths from the checkout's
sources and drives both `--fastcmp 0.5` jobs, the `--fastcmp 1|2|4`
jobs, the default full-register job (no `--fastcmp`), a job of every
other measure and the asymmetric output through the port's own CLI.
It exits non-zero when a phase fails (nothing is caught), when torch sees
no card, or when the port is not importable:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: nvcc for csrc/tri_eq.cu, csrc/tri_comb.cu, csrc/gtlt.cu and
   csrc/int_counts.cu (sm_90a) and g++ for the native sketcher and
   formatter, all started together; build seconds and ptxas'
   register/spill report;
3. kernels against plain, on the card: exact u16 equality of
   `tri_eq_counts` and `tri_eq_counts_plain` for n in {1, 2, 63, 129,
   1000, 1025, 4097} and m in {30, 62, 64, 96, 98, 100, 126, 128, 130,
   256, 1024} (m not a multiple of the kernels' 32-register k step is
   where their pad rule bites; 96 and 98 sit at the edge of tri_comb's
   96-register decode chunks, 126-130 at the decode's 127-register
   limit), the diagonal m, and of `tri_comb_counts` and
   `tri_comb_counts_plain` (eq and gt) for the same n and m, with
   planted identical, all-0x00 and all-0xFF rows, and a matrix of equal
   rows (every register equal: a full chunk's eq in every chunk); of
   `gtlt_self_counts` and `gtlt_self_counts_plain`, and of
   `gtlt_counts` and `gtlt_counts_plain` (gt and lt, against a second
   matrix and on the row-block route's row slices), for the same n and
   m, with u64 registers of which about half have the top bit set and
   planted identical rows, equal registers, all-zero and all-ones rows;
   the similarity tables (b-bit, and full in both forms) built on the
   card must equal the CPU-built tables bit for bit; and of
   `int_counts_self` (eq and gtlt modes) and `int_counts` (eq, gt, lt,
   against a second matrix and on row slices) with their plain versions,
   u8 and u16 registers, for the same n and m, with planted identical,
   all-zero and all-max rows, equal registers and top-bit values; the
   b-bit tables of every width (fused and numpy forms) and the a/b
   complement epilogue over every (gt, lt) built on the card must equal
   the CPU's bit for bit;
4. golden digests: the port's CLI on the card over the seeded n=777
   corpus must reproduce the SHA-256s in
   tests/goldens/torch_port_{bbit,ab}_nibble.json, torch_port_full.json,
   torch_port_u8_bbit.json and torch_port_u16_ab.json, which CPU tests
   tie to the JAX package's output;
5. b-bit main path at full size: N = 10240 genomes, 512 ancestors x 20
   mutants at 0.5-5% divergence, through
   `sketch -k 31 -S 1024 --fastcmp 0.5 --bbit-sigs --binary-output
   --cmpout out.bin -F list.txt` on the card. Checks the output size,
   that the tri_eq launch counter moved during the run, that the
   kernel's full (N, N) count matrix equals the plain version's, and
   that every emitted value is the similarity table at the plain
   counts. Prints the phase walls and unique pairs/s;
6. a/b main path at full size: the same corpus through
   `sketch -k 31 -S 1024 --fastcmp 0.5 --binary-output --cmpout out.bin
   -F list.txt`. Checks the output size, that the tri_comb launch
   counter moved during the run, that the kernel's full (N, N) eq and gt
   equal the plain version's, that the card's a/b epilogue equals the
   CPU's bit for bit on every (gt, lt) in [0, m]^2 at the job's b, and
   that every emitted value is the CPU epilogue at the plain counts.
   Prints the wall, unique pairs/s and the spans;
7. default full-register job at full size: the same corpus through
   `sketch -k 31 -S 1024 --binary-output --cmpout out.bin -F list.txt`
   (self-pairs route, `gtlt_self_counts`). Checks the output size, that
   the gtlt_self launch counter moved during the run, that the kernel's
   full (N, N) counts equal the plain version's, and that every emitted
   value is the table at the plain counts. Prints the wall, unique
   pairs/s, the spans and the kernel's and plain version's times;
8. the `--fastcmp 1 --bbit-sigs`, `--fastcmp 1`, `--fastcmp 2
   --bbit-sigs` and `--fastcmp 2` jobs on the same corpus (self-pairs
   route, `int_counts_self` in eq or gtlt mode), and `--fastcmp 4` (u32
   a/b registers, `gtlt_self_counts`). Each checks the output size, that
   its kernel's launch counter moved during the run, that the kernel's
   full (N, N) counts equal the plain version's (u8 and u16), that the
   card's epilogue equals the CPU's over every count (the b-bit table,
   or the a/b value at every (gt, lt) in [0, m]^2 at the job's b), and
   that every emitted value is the CPU epilogue at the plain counts.
   Prints the wall, unique pairs/s, the spans and the kernel's and plain
   version's times;
9. row-block jobs above SELF_MAX: N = 20480 genomes, 1024 ancestors x 20
   mutants, through the default job's argv (row-block route, one
   `gtlt_counts` launch per 4096-row block), then through `--fastcmp 1`
   (one `int_counts` launch per block). Each checks the output size,
   that its rectangular launch counter moved once per row block and the
   self-pairs counters not at all, and that every emitted value is the
   CPU epilogue at the plain version's counts, 1024 rows at a time.
   Times `gtlt_counts` and `int_counts` on one full-width block
   (4096 x 20480) against their plain versions;
10. every measure on the N = 10240 corpus (its sketches reused):
   `--fastcmp 0.5 --bbit-sigs --mash-distance` (tri_eq), `--fastcmp 0.5
   --union-size` (tri_comb), the default job with `--containment
   --asymmetric-all-pairs` (gtlt_self, the full square), `--fastcmp 1
   --intersection` (int_counts_self, gtlt mode), `--fastcmp 2 --bbit-sigs
   --symmetric-containment` (int_counts_self, eq mode) and `--bbit-sigs`
   without `--fastcmp` (equality-compared full registers: gtlt_self on the
   raw bits). Each checks the output size, that its kernel's launch
   counter moved, and that every emitted value equals the CPU epilogue
   at the plain version's counts and the job's cardinalities, bit for
   bit (POISSON_LLR's table is built on the host, so it holds too);
11. the nibble row-block route on the N = 20480 corpus: `--fastcmp 0.5
   --bbit-sigs` and `--fastcmp 0.5`, nibbles unpacked on the card once
   and one `int_counts` launch per row block, tri_eq and tri_comb never.
   Each checks the output and every emitted value as phase 9 does; the
   b-bit job times `int_counts` on one unpacked 4096 x 20480 block
   against its plain version, with its bound.

Each main path runs with every launch counter set to 0 just before its
CLI call and read just after it. Each phase prints its wall.

Beside each kernel's time the script reckons its bound (the least time
the card could take for the same work, from this run's shapes: the
larger of its operations over the peak rate of their type and its bytes
over the memory rate, `_bound`) and times one PyTorch call that computes
the same function where there is one (`library_ms`, a yardstick the port
never calls): `torch._int_mm` over the int8 one-hot operands of the JAX
package's enc_onehot_T / enc_combined_T for tri_eq and tri_comb (all N^2
pairs; the expansion is done before the timed window), `torch.cdist(x,
x, p=0)` over the f32 registers for int_counts_self in eq mode (the
unequal-register count, eq = m - d). No single call computes (gt, lt)
counts, so gtlt_self_counts, gtlt_counts and int_counts have none. The
kernels line gives int_counts_self twice: `int_counts_self` with the
u8 a/b job's gtlt-mode times (no library call) and `int_counts_self_eq`
with the u8 b-bit job's eq-mode times and its library call.

Reductions: the north-star job uses 50 kb genomes; phases 5-8 use 20 kb
and phase 9 10 kb. The comparison's work depends only on N and m; 20 kb
genomes still carry about 20k distinct 31-mers and 10 kb genomes about
10k (both more than m = 1024, so every register fills and the jobs stay
out of the OPH small-input regime). The cuts only shorten sketching and
the generated FASTA: about 205 MB for phases 5-8 (written once, read by
all of them) and 205 MB for phase 9, against 520 MB and 1 GB at 50 kb.

The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
NORTH_STAR_N, NS_ANCESTORS, NS_MUTANTS, NS_LENGTH = 10240, 512, 20, 20000
NS_SEED = 11
ROWS_N, ROWS_ANCESTORS, ROWS_MUTANTS, ROWS_LENGTH = 20480, 1024, 20, 10000
ROWS_SEED = 12
# item counts of the kernel-vs-plain phase: tile edges and ragged tails
KERNEL_SIZES = (1, 2, 63, 129, 1000, 1025, 4097)
# register counts of tri_eq's and tri_comb's kernel-vs-plain phase
NIBBLE_MS = (30, 62, 64, 96, 98, 100, 126, 128, 130, 256, 1024)
# peak rates of one H100 SXM at 700 W: int8 tensor operations (dense,
# from NVIDIA's H100 datasheet) and, for the integer kernels, the
# SM's 64 INT32 lanes and 16 popcount lanes a clock x 132 SMs x 1.98 GHz
# boost (Hopper's SM layout); device memory 3.35 TB/s
RATES = {"int8": 1.979e15, "int32": 132 * 64 * 1.98e9,
         "popc": 132 * 16 * 1.98e9}
HBM = 3.35e12


def _say(msg: str) -> None:
    print(msg, flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` launches, by CUDA events."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _bound(ops: float, kind: str, nbytes: float):
    """(bound ms, what sets it): the larger of `ops` operations at the
    peak rate of `kind` and `nbytes` (each input read once, each output
    written once) at the memory rate."""
    t_ops = ops / RATES[kind] * 1e3
    t_bytes = nbytes / HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _library_ms(fn, reps: int) -> float:
    """Mean device time of one PyTorch call, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    return _cuda_ms(fn, reps)


def _nibble_operands(packed, combined: bool):
    """The (N, 16m) int8 operands of the JAX package's nibble products,
    transposed: enc_onehot_T's [a == v] and, with `combined`,
    enc_combined_T's [a == v] - 128 [a < v], register-major
    k = 16 r + v in its register order (low nibbles, then high)."""
    import torch
    regs = torch.cat([packed & 0xF, packed >> 4], dim=1)
    lv = torch.arange(16, dtype=torch.uint8, device=packed.device)
    n, m = regs.shape
    eq = (regs.unsqueeze(2) == lv).to(torch.int8).reshape(n, 16 * m)
    if not combined:
        return eq, eq
    lt = (regs.unsqueeze(2) < lv).to(torch.int8).reshape(n, 16 * m)
    return eq, eq + lt * -128


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    _say(f"[device] nvidia-smi: {smi}")
    _say(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from dashing2_tpu_torch import native
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    builds = {"tri_eq": NT.load_kernel, "tri_comb": NC.load_kernel,
              "gtlt": G.load_kernel, "int_counts": IC.load_kernel,
              "ophsketch": native.load_oph_lib,
              "emitfmt": native.load_emit_lib}

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {name: pool.submit(timed, fn) for name, fn in builds.items()}
        secs = {name: f.result() for name, f in futs.items()}
    _say(f"[build] all {len(builds)} in {time.perf_counter() - t0:.3f} s, in "
         "parallel: " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()))
    for name in ("tri_eq", "tri_comb", "gtlt", "int_counts"):
        for ln in native.build_logs.get(name, "").splitlines():
            if "registers" in ln or "spill" in ln:
                _say(f"[build] ptxas {name}: {ln.strip()}")


def _planted(rng, n: int, m: int):
    import numpy as np
    a = rng.integers(0, 256, size=(n, m // 2), dtype=np.uint8)
    if n >= 2:
        a[n - 1] = a[0]
    if n >= 4:
        a[1] = 0x00
        a[2] = 0xFF
    if n >= 64:
        a[60:63] = a[5]
    return a


def phase_kernel_vs_plain():
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp.core import sim_table
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    rng = np.random.default_rng(2026)
    worst_eq = 0
    for m in NIBBLE_MS:
        for n in KERNEL_SIZES:
            a = torch.from_numpy(_planted(rng, n, m)).cuda()
            got = NT.tri_eq_counts(a, m).to(torch.int32)
            want = NT.tri_eq_counts_plain(a, m).to(torch.int32)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            worst_eq = max(worst_eq, err)
            assert err == 0, f"kernel != plain at n={n} m={m}: {err}"
            diag = got.diagonal()
            assert int(diag.min()) == int(diag.max()) == m
        tc = sim_table("nibble-bbit", m, 0.5, "cuda").cpu().numpy()
        th = sim_table("nibble-bbit", m, 0.5, "cpu").numpy()
        assert np.array_equal(tc.view(np.uint32), th.view(np.uint32)), m
    _say("[kernel] tri_eq_counts == plain (exact u16, diagonal m) at n in "
         "{1, 2, 63, 129, 1000, 1025, 4097} x m in {"
         + ", ".join(map(str, NIBBLE_MS)) + "}; "
         "card-built sim table == CPU table bit for bit")
    rng = np.random.default_rng(2027)
    worst_comb = 0
    for m in NIBBLE_MS:
        equal = np.broadcast_to(_planted(rng, 1, m), (300, m // 2)).copy()
        for a in [_planted(rng, n, m) for n in KERNEL_SIZES] + [equal]:
            a = torch.from_numpy(a).cuda()
            n = a.shape[0]
            got = NC.tri_comb_counts(a, m)
            want = NC.tri_comb_counts_plain(a, m)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("eq", "gt")):
                err = int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
                worst_comb = max(worst_comb, err)
                assert err == 0, f"tri_comb {what} != plain at n={n} m={m}"
            assert int(got[0].diagonal().to(torch.int32).min()) == m
            assert int(got[1].diagonal().to(torch.int32).max()) == 0
        assert int(got[0].to(torch.int32).min()) == m      # equal rows
    _say("[kernel] tri_comb_counts == plain (exact u16 eq and gt) at n in "
         "{1, 2, 63, 129, 1000, 1025, 4097} x m in {"
         + ", ".join(map(str, NIBBLE_MS)) + "}, and on 300 equal rows")
    return worst_eq, worst_comb


def _planted_u64(rng, n: int, m: int):
    """(n, m) u64 registers as int64, about half with the top bit set,
    with identical rows, equal registers, all-zero and all-ones rows."""
    import numpy as np
    a = rng.integers(0, 1 << 64, size=(n, m), dtype=np.uint64)
    if n >= 2:
        a[n - 1] = a[0]
        a[1, ::3] = a[0, ::3]
    if n >= 4:
        a[2] = 0
        a[3] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if n >= 64:
        a[60:63] = a[5]
    return a.view(np.int64)


def _max_err(got, want) -> int:
    import torch
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def phase_gtlt_vs_plain():
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp.core import sim_table
    from dashing2_tpu_torch.ops import gtlt as G
    rng = np.random.default_rng(2028)
    worst_self = worst_rect = 0
    for m in (30, 64, 256, 1024):
        for n in KERNEL_SIZES:
            a = torch.from_numpy(_planted_u64(rng, n, m)).cuda()
            b = torch.from_numpy(_planted_u64(rng, n // 2 + 1, m)).cuda()
            got = G.gtlt_self_counts(a)
            err = _max_err(got, G.gtlt_self_counts_plain(a))
            assert err == 0, f"gtlt_self != plain at n={n} m={m}: {err}"
            assert int(got.diagonal().to(torch.int32).max()) == 0
            worst_self = max(worst_self, err)
            # against a second matrix, and the row-block route's slices
            s = n // 3
            for x, y in ((a, b), (a[s:s + 64], a[s:])):
                for g, w in zip(G.gtlt_counts(x, y),
                                G.gtlt_counts_plain(x, y)):
                    err = _max_err(g, w)
                    assert err == 0, f"gtlt != plain at n={n} m={m}: {err}"
                    worst_rect = max(worst_rect, err)
            torch.cuda.synchronize()
    _say("[kernel] gtlt_self_counts == plain and gtlt_counts == plain (gt "
         "and lt; against a second matrix and on row slices) exactly at n "
         "in {1, 2, 63, 129, 1000, 1025, 4097} x m in {30, 64, 256, 1024}")
    for m in (30, 200, 1024):
        for fused in (True, False):
            tc = sim_table("full", m, 8.0, "cuda", fused).cpu().numpy()
            th = sim_table("full", m, 8.0, "cpu", fused).numpy()
            assert np.array_equal(tc.view(np.uint32), th.view(np.uint32)), m
    _say("[kernel] card-built full sim tables (fused and numpy forms) == "
         "CPU tables bit for bit at m in {30, 200, 1024}")
    return worst_self, worst_rect


def _planted_int(rng, n: int, m: int, dt):
    """(n, m) u8 or u16 registers as the kernels take them (u16 as int16
    bit patterns), with identical rows, equal registers, all-zero and
    all-max rows, and values on both sides of the top bit."""
    import numpy as np
    top = int(np.iinfo(dt).max)
    a = rng.integers(0, top + 1, size=(n, m), dtype=np.uint64).astype(dt)
    if n >= 2:
        a[n - 1] = a[0]
        a[1, ::3] = a[0, ::3]
    if n >= 5:
        a[2] = 0
        a[3] = top
        a[4, 0::2] = (top + 1) // 2
        a[4, 1::2] = (top + 1) // 2 - 1
    if n >= 64:
        a[60:63] = a[5]
    return a.view(np.int16) if dt == np.uint16 else a


def phase_int_vs_plain():
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.cmp.core import sim_table
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import int_counts as IC
    rng = np.random.default_rng(2029)
    worst_self = worst_rect = 0
    for dt in (np.uint8, np.uint16):
        for m in (30, 64, 256, 1024):
            for n in KERNEL_SIZES:
                a = torch.from_numpy(_planted_int(rng, n, m, dt)).cuda()
                b = torch.from_numpy(
                    _planted_int(rng, n // 2 + 1, m, dt)).cuda()
                for mode in ("eq", "gtlt"):
                    got = IC.int_counts_self(a, mode)
                    err = _max_err(got, IC.int_counts_self_plain(a, mode))
                    assert err == 0, \
                        f"int_counts_self {mode} != plain at n={n} m={m}"
                    worst_self = max(worst_self, err)
                    diag = got.diagonal().to(torch.int32)
                    assert int(diag.min()) == int(diag.max()) == \
                        (m if mode == "eq" else 0)
                s = n // 3
                for x, y in ((a, b), (a[s:s + 64], a[s:])):
                    for g, w in zip(IC.int_counts(x, y),
                                    IC.int_counts_plain(x, y)):
                        err = _max_err(g, w)
                        assert err == 0, f"int_counts != plain at n={n} m={m}"
                        worst_rect = max(worst_rect, err)
                torch.cuda.synchronize()
    _say("[kernel] int_counts_self == plain (eq and gtlt modes) and "
         "int_counts == plain (eq, gt, lt; against a second matrix and on "
         "row slices) exactly, u8 and u16, at n in {1, 2, 63, 129, 1000, "
         "1025, 4097} x m in {30, 64, 256, 1024}")
    for fd in (0.5, 1.0, 2.0, 4.0):
        kind = "nibble-bbit" if fd == 0.5 else "bbit"
        for m in (30, 256, 1024):
            for fused in (True, False):
                tc = sim_table(kind, m, fd, "cuda", fused).cpu().numpy()
                th = sim_table(kind, m, fd, "cpu", fused).numpy()
                assert np.array_equal(tc.view(np.uint32),
                                      th.view(np.uint32)), (fd, m, fused)
    for fd, b in ((1.0, 1.0545), (2.0, 1.000206), (4.0, 1.0000000031)):
        for m in (30, 1024):
            c = torch.arange(m + 1, dtype=torch.int32)
            cg, cl = torch.meshgrid(c, c, indexing="ij")
            for fused in (True, False):
                on_cpu = E.compressed_ab_measures32(
                    cg, cl, m, b, fd, Measure.SIMILARITY, fused=fused,
                    gb_form="complement")
                on_card = E.compressed_ab_measures32(
                    cg.cuda(), cl.cuda(), m, b, fd, Measure.SIMILARITY,
                    fused=fused, gb_form="complement").cpu()
                assert torch.equal(on_cpu.view(torch.int32),
                                   on_card.view(torch.int32)), (fd, m, fused)
    _say("[kernel] card-built b-bit tables (fd 0.5, 1, 2, 4; fused and numpy "
         "forms) and a/b complement epilogues over every (gt, lt) (fd 1, 2, "
         "4) == CPU bit for bit at m in {30, 256, 1024} (tables) and "
         "{30, 1024} (epilogues)")
    return worst_self, worst_rect


def _corpus(name: str, seed: int, n_anc: int, n_mut: int, length: int,
            divergence=(0.005, 0.05)) -> str:
    from dashing2_tpu_torch.io.corpus import write_corpus
    d = os.path.join(WORK, name)
    paths = write_corpus(os.path.join(d, "fa"), seed, n_anc, n_mut, length,
                         divergence)
    lst = os.path.join(d, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    return lst


def phase_golden(name: str):
    from dashing2_tpu_torch import cli
    with open(os.path.join(ROOT, "tests", "goldens", name)) as f:
        gold = json.load(f)
    c = gold["corpus"]
    lst = _corpus("golden", c["seed"], c["n_ancestors"], c["n_mutants"],
                  c["length"], tuple(c["divergence"]))
    out = os.path.join(WORK, "golden", "out.bin")
    argv = [{"list.txt": lst, "out.bin": out}.get(x, x)
            for x in gold["argv"]] + ["--device", "cuda"]
    assert cli.main(argv) == 0
    with open(out, "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    assert (len(data), digest) == (gold["bytes"], gold["sha256"]), digest
    _say(f"[golden] {name} n={gold['n']} m={gold['m']}: sha256 {digest} "
         "matches the committed JAX digest")


def _run_cli(tag: str, argv, n: int, counters):
    """One CLI call with every launch counter set to 0 just before it;
    returns (wall seconds, spans, launches per counter name)."""
    from dashing2_tpu_torch import cli, timing
    timing.reset_spans()
    for mod in counters.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    spans = timing.spans()
    assert rc == 0, rc
    pairs = n * (n - 1) // 2
    _say(f"[{tag}] CLI wall {wall:.3f} s for {pairs} unique pairs: "
         f"{pairs / wall:.6e} unique pairs/s; launches {launches}")
    return wall, spans, launches


def _say_spans(tag: str, spans, keys) -> None:
    for key in keys:
        _say(f"[{tag}] span {key}: {spans.get(key, 0.0):.6f} s")


def _sketch(lst: str):
    """The corpus' sketches, once for both main paths' kernel checks
    (_prep densifies them in place on first use; a second _prep finds
    nothing left to densify)."""
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.sketch.core import sketch_fastx
    with open(lst) as f:
        groups = [ln.strip() for ln in f if ln.strip()]
    return sketch_fastx(Dashing2DistOptions(k=31, sketchsize=1024), groups)


def _rows_equal(vals, n: int, row_fn) -> None:
    """Every row i of the condensed output equals row_fn(i0, i1)[i - i0]
    over [i + 1, n), for row blocks [i0, i1)."""
    import numpy as np
    off = 0
    for i0 in range(0, n - 1, 1024):
        i1 = min(i0 + 1024, n - 1)
        want = row_fn(i0, i1)
        for i in range(i0, i1):
            row = vals[off:off + n - 1 - i]
            assert np.array_equal(row.view(np.uint32),
                                  want[i - i0, i + 1:].view(np.uint32)), i
            off += n - 1 - i


def _histogram(vals) -> list:
    import numpy as np
    return np.histogram(vals, bins=[0, 1e-9, 0.1, 0.5, 0.9, 1.0001]
                        )[0].tolist()


def phase_main_bbit(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.ops import nibble_tri as NT

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", "out.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5",
            "--bbit-sigs", "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("main", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["tri_eq"] >= 1, "the main path never launched tri_eq"
    _say_spans("main", spans, (
        "sketch", "sketch/native-files", "sketch/finalize", "compare+emit",
        "cmp/prep", "cmp/table", "cmp/h2d", "cmp/kernel", "cmp/epilogue",
        "cmp/d2h", "emit/write"))

    # the same job's registers, once more, for the kernel-vs-plain check
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=1)
    creps, _ = C._prep(opts, sketches)
    packed = torch.from_numpy(creps.data).cuda()
    NT.tri_eq_counts(packed, m)                       # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: NT.tri_eq_counts(packed, m), 20)
    NT.tri_eq_counts_plain(packed, m)                 # warm-up
    plain_ms = _cuda_ms(lambda: NT.tri_eq_counts_plain(packed, m), 3)
    got = NT.tri_eq_counts(packed, m)
    want = NT.tri_eq_counts_plain(packed, m)
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    assert err == 0, f"kernel != plain on the main path's registers: {err}"
    t0 = time.perf_counter()
    counts = want.cpu().numpy()
    d2h = time.perf_counter() - t0
    del got, want
    _say(f"[main] tri_eq kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} counts equal; u16 d2h copy {d2h:.6f} s")
    onehot, _ = _nibble_operands(packed, combined=False)
    library_ms = _library_ms(lambda: torch._int_mm(onehot, onehot.t()), 5)
    del onehot
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * 16 * m * 2, "int8",
                                n * m // 2 + 2 * n * n)
    _say(f"[main] tri_eq bound {bound_ms:.6f} ms ({bound_by}: N(N+1)/2 "
         f"pairs x 16m int8 MACs x 2 at 1,979 TOP/s); kernel at "
         f"{100 * bound_ms / kernel_ms:.1f}% of it; library torch._int_mm "
         f"over the (N, 16m) int8 one-hot {library_ms:.6f} ms (mean of 5; "
         "all N^2 pairs, the expansion before the timed window)")

    # every emitted value is the table at the plain version's counts
    table = C.sim_table("nibble-bbit", m, 0.5, "cuda").cpu().numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: table[counts[i0:i1]])
    _say(f"[main] output == table[plain counts] for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["tri_eq"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_main_ab(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import nibble_comb as NC

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", "out_ab.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5",
            "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("ab", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["tri_comb"] >= 1, "the a/b path never launched tri_comb"
    _say_spans("ab", spans, (
        "sketch", "sketch/native-files", "sketch/finalize", "compare+emit",
        "cmp/prep", "cmp/h2d", "cmp/kernel", "cmp/epilogue", "cmp/d2h",
        "emit/write"))

    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5)
    creps, _ = C._prep(opts, sketches)
    packed = torch.from_numpy(creps.data).cuda()
    NC.tri_comb_counts(packed, m)                     # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: NC.tri_comb_counts(packed, m), 20)
    NC.tri_comb_counts_plain(packed, m)               # warm-up
    plain_ms = _cuda_ms(lambda: NC.tri_comb_counts_plain(packed, m), 3)
    got = NC.tri_comb_counts(packed, m)
    want = NC.tri_comb_counts_plain(packed, m)
    err = 0
    for g, w, what in zip(got, want, ("eq", "gt")):
        e = int((g.to(torch.int32) - w.to(torch.int32)).abs().max())
        assert e == 0, f"tri_comb {what} != plain on the job's registers"
        err = max(err, e)
    eq = want[0].cpu().to(torch.int32)
    gt = want[1].cpu().to(torch.int32)
    del got, want
    _say(f"[ab] tri_comb kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} eq and gt equal")
    onehot, comb = _nibble_operands(packed, combined=True)
    library_ms = _library_ms(lambda: torch._int_mm(onehot, comb.t()), 5)
    del onehot, comb
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * 16 * m * 2, "int8",
                                n * m // 2 + 4 * n * n)
    _say(f"[ab] tri_comb bound {bound_ms:.6f} ms ({bound_by}: one int8 "
         f"product, as enc_combined_T's); kernel at "
         f"{100 * bound_ms / kernel_ms:.1f}% of it; library torch._int_mm "
         f"one-hot x combined {library_ms:.6f} ms (mean of 5; all N^2 "
         "pairs, the encoding before the timed window, no decode)")

    # the card's epilogue == the CPU's on every (gt, lt) at the job's b
    bf = max(creps.b, 1.0 + 1e-9)
    table, gbinv = C._gb_args(bf, m)
    c = torch.arange(m + 1, dtype=torch.int32)
    cg, cl = torch.meshgrid(c, c, indexing="ij")
    for fused in (True, False):
        on_cpu = E.compressed_ab_measures32(
            cg, cl, m, bf, 0.5, Measure.SIMILARITY, table, gbinv, fused)
        on_card = E.compressed_ab_measures32(
            cg.cuda(), cl.cuda(), m, bf, 0.5, Measure.SIMILARITY, table,
            gbinv, fused).cpu()
        assert torch.equal(on_cpu.view(torch.int32),
                           on_card.view(torch.int32)), fused
    _say(f"[ab] card epilogue == CPU epilogue bit for bit on all "
         f"{(m + 1) ** 2} (gt, lt) at b = {bf!r} (fused and numpy forms)")

    # every emitted value is the CPU epilogue at the plain counts
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: E.compressed_ab_measures32(
        gt[i0:i1], m - eq[i0:i1] - gt[i0:i1], m, bf, 0.5,
        Measure.SIMILARITY, table, gbinv).numpy())
    _say(f"[ab] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["tri_comb"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


FULL_SPANS = ("sketch", "sketch/native-files", "sketch/finalize",
              "compare+emit", "cmp/prep", "cmp/table", "cmp/h2d",
              "cmp/kernel", "cmp/epilogue", "cmp/d2h", "emit/write")


def _full_regs(sketches, m: int):
    """The job's ordered u64 registers on the card (int64 bit patterns),
    from the sketches the CLI run made again."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    opts = Dashing2DistOptions(k=31, sketchsize=m)
    C._prep(opts, sketches)
    bits = C._ordered_cached(opts, sketches)
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int64)).cuda()


def phase_main_full(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.ops import gtlt as G

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", "out_full.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--binary-output",
            "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("full", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["gtlt_self"] >= 1, "the full path never launched gtlt_self"
    _say_spans("full", spans, FULL_SPANS)

    regs = _full_regs(sketches, m)
    G.gtlt_self_counts(regs)                          # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: G.gtlt_self_counts(regs), 20)
    G.gtlt_self_counts_plain(regs)                    # warm-up
    plain_ms = _cuda_ms(lambda: G.gtlt_self_counts_plain(regs), 3)
    got = G.gtlt_self_counts(regs)
    want = G.gtlt_self_counts_plain(regs)
    err = _max_err(got, want)
    assert err == 0, f"gtlt_self != plain on the job's registers: {err}"
    counts = want.cpu().numpy().astype(np.int32)
    del got, want, regs
    _say(f"[full] gtlt_self kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} counts equal")
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * 2 * 2 * m, "int32",
                                8 * n * m + 2 * n * n)
    _say(f"[full] gtlt_self bound {bound_ms:.6f} ms ({bound_by}: one 32-bit "
         "integer operation per word of each register pair per count, gt "
         f"and lt); kernel at {100 * bound_ms / kernel_ms:.1f}% of it; "
         "library: none (no single PyTorch call computes gt/lt counts)")

    # every emitted value is the table at the plain counts (gt + gt^T)
    table = C.sim_table("full", m, 8.0, "cpu", fused=True).numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: table[counts[i0:i1]
                                              + counts[:, i0:i1].T])
    _say(f"[full] output == table[plain gt + lt] for all {n * (n - 1) // 2} "
         f"pairs; similarity counts in [0,1e-9) [1e-9,.1) [.1,.5) [.5,.9) "
         f"[.9,1]: {_histogram(vals)}")
    return dict(launches=launches["gtlt_self"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def _int_job(sketches, m: int, fd: float, bbit: bool, n: int):
    """The options, compressed registers (on the card, as pairwise_matrix
    passes them to the kernels) and kind of a `--fastcmp fd` job, from
    the sketches the CLI run made again."""
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=fd,
                               truncation_method=int(bbit))
    creps, _ = C._prep(opts, sketches)
    kind, data = C._representation(opts, sketches, creps)
    return opts, creps, kind, C._device_regs(data, torch.device("cuda"))


def _job_epilogue(tag: str, kind: str, opts, creps, n: int):
    """The job's epilogue on the CPU as a function of its counts, after
    holding the card's to it bit for bit over every count: the (m+1)
    table for b-bit kinds, the (m+1)^2 table over every (gt, lt) for
    a/b kinds. Returns fn(eq, gt, lt) of int64 host arrays."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    m = opts.sketchsize
    on_cpu = C._epilogue(kind, opts, creps, n, torch.device("cpu"))
    on_card = C._epilogue(kind, opts, creps, n, torch.device("cuda"))
    c = torch.arange(m + 1, dtype=torch.int32)
    if kind.endswith("bbit"):
        host = on_cpu(c, None, None, None, None)
        card = on_card(c.cuda(), None, None, None, None).cpu()
    else:
        cg, cl = torch.meshgrid(c, c, indexing="ij")
        host = on_cpu(None, cg, cl, None, None)
        card = on_card(None, cg.cuda(), cl.cuda(), None, None).cpu()
    assert torch.equal(host.view(torch.int32), card.view(torch.int32)), tag
    table = host.numpy()
    _say(f"[{tag}] card epilogue == CPU epilogue bit for bit on all "
         f"{table.size} counts" + ("" if kind.endswith("bbit") else
                                   f" (gt, lt) at b = {creps.b!r}"))
    if kind.endswith("bbit"):
        return lambda eq, gt, lt: table[eq]
    return lambda eq, gt, lt: table[gt, lt]


INT_JOBS = (("u8-bbit", 1.0, True), ("u8-ab", 1.0, False),
            ("u16-bbit", 2.0, True), ("u16-ab", 2.0, False))


def phase_main_int(tag: str, fd: float, bbit: bool, lst: str, sketches,
                   counters):
    """One `--fastcmp 1|2` job at full size (self-pairs route,
    int_counts_self), checked as the nibble jobs are."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m = NORTH_STAR_N, 1024
    out = os.path.join(WORK, "northstar", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", f"{fd:g}"] \
        + (["--bbit-sigs"] if bbit else []) \
        + ["--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["int_counts_self"] >= 1, \
        f"the {tag} job never launched int_counts_self"
    _say_spans(tag, spans, FULL_SPANS)

    opts, creps, kind, regs = _int_job(sketches, m, fd, bbit, n)
    mode = "eq" if bbit else "gtlt"
    IC.int_counts_self(regs, mode)                    # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: IC.int_counts_self(regs, mode), 20)
    IC.int_counts_self_plain(regs, mode)              # warm-up
    plain_ms = _cuda_ms(lambda: IC.int_counts_self_plain(regs, mode), 3)
    got = IC.int_counts_self(regs, mode)
    want = IC.int_counts_self_plain(regs, mode)
    err = _max_err(got, want)
    assert err == 0, f"int_counts_self != plain on the {tag} registers"
    counts = want.cpu().numpy().astype(np.int64)
    del got, want
    _say(f"[{tag}] int_counts_self ({mode}) kernel {kernel_ms:.6f} ms (CUDA "
         f"events, mean of 20 after a warm-up); plain {plain_ms:.6f} ms "
         f"(mean of 3); full {n}x{n} counts equal")
    width = regs.element_size()
    ncounts = 1 if bbit else 2          # eq; or neq and gt (lt = m - eq - gt)
    bound_ms, bound_by = _bound(n * (n + 1) // 2 * ncounts * m * width / 4,
                                "popc", width * n * m + 2 * n * n)
    library_ms = None
    if bbit:
        x = (regs.to(torch.int32) & 0xFFFF).to(torch.float32)   # u8, u16
        library_ms = _library_ms(lambda: torch.cdist(x, x, p=0), 3)
        del x
    del regs
    _say(f"[{tag}] int_counts_self bound {bound_ms:.6f} ms ({bound_by}: one "
         "popcount per 32-bit word of each register pair per count); kernel "
         f"at {100 * bound_ms / kernel_ms:.1f}% of it; library " + (
             f"torch.cdist(x, x, p=0) over the f32 registers {library_ms:.6f}"
             " ms (mean of 3; the unequal-register count, eq = m - d)"
             if bbit else "none (no single PyTorch call computes gt/lt "
             "counts)"))

    # every emitted value is the CPU epilogue at the plain counts
    epi = _job_epilogue(tag, kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: epi(
        counts[i0:i1], counts[i0:i1], counts[:, i0:i1].T))
    _say(f"[{tag}] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["int_counts_self"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_main_u32(lst: str, sketches, counters):
    """`--fastcmp 4` (u32 a/b registers) at full size: widened to int64,
    counted by gtlt_self_counts."""
    import numpy as np
    from dashing2_tpu_torch.ops import gtlt as G

    n, m, tag = NORTH_STAR_N, 1024, "u32-ab"
    out = os.path.join(WORK, "northstar", "out_u32.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "4",
            "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches["gtlt_self"] >= 1 and launches["int_counts_self"] == 0, \
        launches
    _say_spans(tag, spans, FULL_SPANS)
    opts, creps, kind, regs = _int_job(sketches, m, 4.0, False, n)
    assert kind == "ab" and creps.data.dtype == np.uint32
    counts = G.gtlt_self_counts_plain(regs).cpu().numpy().astype(np.int64)
    del regs
    epi = _job_epilogue(tag, kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    _rows_equal(vals, n, lambda i0, i1: epi(
        None, counts[i0:i1], counts[:, i0:i1].T))
    _say(f"[{tag}] output == CPU epilogue at the plain gt/lt counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")


def phase_rowblock(lst: str, sketches, counters):
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.cmp import estimators as E
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure
    from dashing2_tpu_torch.ops import gtlt as G

    n, m = ROWS_N, 1024
    assert n > C.SELF_MAX
    out = os.path.join(WORK, "rowblock", "out.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--binary-output",
            "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli("rows", argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    block = C._block_size(Dashing2DistOptions(k=31, sketchsize=m))
    blocks = -(-n // block)
    assert launches["gtlt"] == blocks and launches["gtlt_self"] == 0, \
        (launches, blocks)
    _say(f"[rows] {blocks} row blocks of {block}: gtlt launched once each")
    _say_spans("rows", spans, FULL_SPANS)

    regs = _full_regs(sketches, m)
    rows, cols = regs[:block], regs
    G.gtlt_counts(rows, cols)                         # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: G.gtlt_counts(rows, cols), 20)
    G.gtlt_counts_plain(rows, cols)                   # warm-up
    plain_ms = _cuda_ms(lambda: G.gtlt_counts_plain(rows, cols), 3)
    err = 0
    for g, w in zip(G.gtlt_counts(rows, cols),
                    G.gtlt_counts_plain(rows, cols)):
        err = max(err, _max_err(g, w))
    assert err == 0, f"gtlt != plain on the job's first block: {err}"
    _say(f"[rows] gtlt kernel {kernel_ms:.6f} ms on one {block}x{n} block "
         f"(CUDA events, mean of 20 after a warm-up); plain {plain_ms:.6f} "
         "ms (mean of 3); gt and lt equal")
    bound_ms, bound_by = _bound(block * n * 2 * 2 * m, "int32",
                                8 * (block + n) * m + 4 * block * n)
    _say(f"[rows] gtlt bound {bound_ms:.6f} ms ({bound_by}: one 32-bit "
         "integer operation per word of each register pair per count, gt "
         f"and lt); kernel at {100 * bound_ms / kernel_ms:.1f}% of it; "
         "library: none (no single PyTorch call computes gt/lt counts)")

    # every emitted value is the CPU epilogue at the plain counts
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()

    def want(i0, i1):
        gt, lt = G.gtlt_counts_plain(regs[i0:i1], regs[i0:])
        sim = E.full_setsketch_measures32(gt.cpu(), lt.cpu(), m,
                                          Measure.SIMILARITY, fused=False)
        return C._expand_upper(sim.numpy(), i0, n)
    _rows_equal(vals, n, want)
    _say(f"[rows] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["gtlt"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def phase_rowblock_int(lst: str, sketches, counters):
    """`--fastcmp 1` (u8 a/b) above SELF_MAX: one int_counts launch per
    row block, the numpy-route epilogue."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m, tag = ROWS_N, 1024, "rows-u8"
    out = os.path.join(WORK, "rowblock", "out_u8.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "1",
            "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    opts, creps, kind, regs = _int_job(sketches, m, 1.0, False, n)
    block = C._block_size(opts)
    blocks = -(-n // block)
    assert launches["int_counts"] == blocks \
        and launches["int_counts_self"] == 0 \
        and launches["gtlt"] == launches["gtlt_self"] == 0, (launches, blocks)
    _say(f"[{tag}] {blocks} row blocks of {block}: int_counts launched once "
         "each")
    _say_spans(tag, spans, FULL_SPANS)

    rows = regs[:block]
    IC.int_counts(rows, regs)                         # warm-up
    torch.cuda.synchronize()
    kernel_ms = _cuda_ms(lambda: IC.int_counts(rows, regs), 20)
    IC.int_counts_plain(rows, regs)                   # warm-up
    plain_ms = _cuda_ms(lambda: IC.int_counts_plain(rows, regs), 3)
    err = 0
    for g, w in zip(IC.int_counts(rows, regs), IC.int_counts_plain(rows, regs)):
        err = max(err, _max_err(g, w))
    assert err == 0, f"int_counts != plain on the job's first block: {err}"
    _say(f"[{tag}] int_counts kernel {kernel_ms:.6f} ms on one {block}x{n} "
         f"u8 block (CUDA events, mean of 20 after a warm-up); plain "
         f"{plain_ms:.6f} ms (mean of 3); eq, gt and lt equal")
    bound_ms, bound_by = _bound(block * n * 2 * m / 4, "popc",
                                (block + n) * m + 6 * block * n)
    _say(f"[{tag}] int_counts bound {bound_ms:.6f} ms ({bound_by}: one "
         "popcount per 32-bit word of each register pair for eq and for gt; "
         f"lt = m - eq - gt); kernel at {100 * bound_ms / kernel_ms:.1f}% of "
         "it; library: none (no single PyTorch call computes gt/lt counts)")

    # every emitted value is the CPU epilogue at the plain counts
    epi = _job_epilogue(tag, kind, opts, creps, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()

    def want(i0, i1):
        _, gt, lt = IC.int_counts_plain(regs[i0:i1], regs[i0:])
        sim = epi(None, gt.cpu().numpy().astype(np.int64),
                  lt.cpu().numpy().astype(np.int64))
        return C._expand_upper(sim, i0, n)
    _rows_equal(vals, n, want)
    _say(f"[{tag}] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return dict(launches=launches["int_counts"], err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


# tag, the job's flags, the self-pairs kernel it launches, and the
# options its flags build (measure by name)
MEASURE_JOBS = (
    ("mash-nibble-bbit", ["--fastcmp", "0.5", "--bbit-sigs",
                          "--mash-distance"], "tri_eq",
     dict(fd_level=0.5, truncation_method=1, measure="POISSON_LLR")),
    ("union-nibble-ab", ["--fastcmp", "0.5", "--union-size"], "tri_comb",
     dict(fd_level=0.5, measure="UNION_SIZE")),
    ("containment-full-asym", ["--containment", "--asymmetric-all-pairs"],
     "gtlt_self", dict(measure="CONTAINMENT")),
    ("intersection-u8-ab", ["--fastcmp", "1", "--intersection"],
     "int_counts_self", dict(fd_level=1.0, measure="INTERSECTION")),
    ("symcontain-u16-bbit", ["--fastcmp", "2", "--bbit-sigs",
                             "--symmetric-containment"], "int_counts_self",
     dict(fd_level=2.0, truncation_method=1,
          measure="SYMMETRIC_CONTAINMENT")),
    ("eqfull", ["--bbit-sigs"], "gtlt_self", dict(truncation_method=1)),
)


def _plain_self_counts(kind: str, regs, m: int):
    """The (n, n) u16 matrix of the kind's self-pairs kernel, from its
    plain version on the card."""
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    if kind == "nibble-bbit":
        return NT.tri_eq_counts_plain(regs, m)
    if kind == "nibble-ab":
        return NC.tri_comb_counts_plain(regs, m)[1]
    return IC.int_counts_self_plain(regs, "eq" if kind in C._EQ_KINDS
                                    else "gtlt")


def phase_measure(tag: str, flags, counter: str, kw, lst: str, sketches,
                  counters):
    """One job of a measure other than SIMILARITY (or of the
    equality-compared full registers) at full size, self-pairs route."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.enums import Measure

    n, m = NORTH_STAR_N, 1024
    asym = "--asymmetric-all-pairs" in flags
    out = os.path.join(WORK, "northstar", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m)] + flags + [
        "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * (n * n if asym
                                        else n * (n - 1) // 2)
    assert launches[counter] >= 1, f"the {tag} job never launched {counter}"
    _say_spans(tag, spans, FULL_SPANS)

    kw = dict(kw, measure=Measure[kw.get("measure", "SIMILARITY")])
    opts = Dashing2DistOptions(k=31, sketchsize=m, **kw)
    creps, _ = C._prep(opts, sketches)
    kind, data = C._representation(opts, sketches, creps)
    regs = C._device_regs(data, torch.device("cuda"))
    mat = _plain_self_counts(kind, regs, m).cpu().to(torch.int32)
    del regs
    cards = torch.from_numpy(np.asarray(sketches.cardinalities,
                                        np.float64).astype(np.float32))
    epi = C._epilogue(kind, opts, creps, n, torch.device("cpu"))

    def want(i0, i1):
        c0 = 0 if asym else i0
        v = epi(mat[i0:i1, c0:], mat[i0:i1, c0:], mat[c0:, i0:i1].T,
                cards[i0:i1, None], cards[None, c0:]).numpy()
        return v if asym else C._expand_upper(v, i0, n)
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    if asym:
        sq = vals.reshape(n, n)
        for i0 in range(0, n, 1024):
            assert np.array_equal(sq[i0:i0 + 1024].view(np.uint32),
                                  want(i0, min(i0 + 1024, n))
                                  .view(np.uint32)), i0
    else:
        _rows_equal(vals, n, want)
    _say(f"[{tag}] {kind} {opts.measure.name}: output == CPU epilogue at the "
         f"plain counts and the job's cardinalities for all "
         f"{n * n if asym else n * (n - 1) // 2} values; min "
         f"{float(vals.min())!r} max {float(vals.max())!r}")
    return launches


def phase_rowblock_nibble(tag: str, bbit: bool, lst: str, sketches,
                          counters):
    """`--fastcmp 0.5 [--bbit-sigs]` above SELF_MAX: nibbles unpacked on
    the card, one int_counts launch per row block, the numpy-route
    epilogue; the b-bit job times one unpacked block."""
    import numpy as np
    import torch
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.ops import int_counts as IC

    n, m = ROWS_N, 1024
    out = os.path.join(WORK, "rowblock", f"out_{tag}.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5"] + (
        ["--bbit-sigs"] if bbit else []) + [
        "--binary-output", "--cmpout", out, "-F", lst]
    _, spans, launches = _run_cli(tag, argv, n, counters)
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=int(bbit))
    creps, _ = C._prep(opts, sketches)
    kind, data = C._representation(opts, sketches, creps)
    block = C._block_size(opts)
    blocks = -(-n // block)
    assert launches["int_counts"] == blocks \
        and launches["tri_eq"] == launches["tri_comb"] == 0 \
        and launches["int_counts_self"] == 0, (launches, blocks)
    _say(f"[{tag}] {blocks} row blocks of {block}: int_counts launched once "
         "each on the unpacked nibbles, tri_eq and tri_comb never")
    _say_spans(tag, spans, FULL_SPANS + ("cmp/unpack",))

    regs = C._unpack_nibbles(C._device_regs(data, torch.device("cuda")))
    if bbit:
        rows = regs[:block]
        IC.int_counts(rows, regs)                     # warm-up
        torch.cuda.synchronize()
        kernel_ms = _cuda_ms(lambda: IC.int_counts(rows, regs), 20)
        IC.int_counts_plain(rows, regs)               # warm-up
        plain_ms = _cuda_ms(lambda: IC.int_counts_plain(rows, regs), 3)
        for g, w in zip(IC.int_counts(rows, regs),
                        IC.int_counts_plain(rows, regs)):
            assert _max_err(g, w) == 0, "int_counts != plain on nibbles"
        nr = rows.shape[0]
        bound_ms, bound_by = _bound(nr * n * 2 * m / 4, "popc",
                                    (nr + n) * m + 6 * nr * n)
        _say(f"[{tag}] int_counts kernel {kernel_ms:.6f} ms on one "
             f"{nr}x{n} unpacked-nibble block (CUDA events, mean of 20 "
             f"after a warm-up); plain {plain_ms:.6f} ms (mean of 3); eq, gt "
             f"and lt equal; bound {bound_ms:.6f} ms ({bound_by}); kernel at "
             f"{100 * bound_ms / kernel_ms:.1f}% of it")

    epi = C._epilogue(kind, opts, creps, n, torch.device("cpu"))
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()

    def want(i0, i1):
        eq, gt, lt = (x.cpu() for x in IC.int_counts_plain(regs[i0:i1],
                                                           regs[i0:]))
        return C._expand_upper(epi(eq, gt, lt, None, None).numpy(), i0, n)
    _rows_equal(vals, n, want)
    _say(f"[{tag}] output == CPU epilogue at the plain counts for all "
         f"{n * (n - 1) // 2} pairs; similarity counts in [0,1e-9) "
         f"[1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {_histogram(vals)}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    import dashing2_tpu_torch  # noqa: F401  (fails outside a checkout)
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    counters = {"tri_eq": NT, "tri_comb": NC, "gtlt_self": G.self_launches,
                "gtlt": G.rect_launches, "int_counts_self": IC.self_launches,
                "int_counts": IC.rect_launches}
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _say(f"[wall] phase {name}: {time.perf_counter() - t0:.3f} s")
        return out
    smi = timed("device", phase_device)
    timed("build", phase_build)
    worst_eq, worst_comb = timed("kernels", phase_kernel_vs_plain)
    worst_self, worst_rect = timed("gtlt kernels", phase_gtlt_vs_plain)
    worst_int_self, worst_int_rect = timed("int_counts kernels",
                                           phase_int_vs_plain)
    try:
        for gold in ("torch_port_bbit_nibble.json",
                     "torch_port_ab_nibble.json", "torch_port_full.json",
                     "torch_port_u8_bbit.json", "torch_port_u16_ab.json"):
            timed(f"golden {gold}", phase_golden, gold)
        t0 = time.perf_counter()
        lst = _corpus("northstar", NS_SEED, NS_ANCESTORS, NS_MUTANTS,
                      NS_LENGTH)
        _say(f"[main] corpus: {NORTH_STAR_N} genomes x {NS_LENGTH} bp "
             f"written in {time.perf_counter() - t0:.3f} s")
        sketches = timed("sketch for the checks", _sketch, lst)
        eq_run = timed("b-bit job", phase_main_bbit, lst, sketches, counters)
        comb_run = timed("a/b job", phase_main_ab, lst, sketches, counters)
        self_run = timed("full job", phase_main_full, lst, sketches,
                         counters)
        int_runs = {tag: timed(f"{tag} job", phase_main_int, tag, fd, bbit,
                               lst, sketches, counters)
                    for tag, fd, bbit in INT_JOBS}
        timed("u32-ab job", phase_main_u32, lst, sketches, counters)
        measure_runs = {tag: timed(f"{tag} job", phase_measure, tag, flags,
                                   counter, kw, lst, sketches, counters)
                        for tag, flags, counter, kw in MEASURE_JOBS}
        del sketches
        shutil.rmtree(os.path.join(WORK, "northstar"), ignore_errors=True)
        t0 = time.perf_counter()
        lst = _corpus("rowblock", ROWS_SEED, ROWS_ANCESTORS, ROWS_MUTANTS,
                      ROWS_LENGTH)
        _say(f"[rows] corpus: {ROWS_N} genomes x {ROWS_LENGTH} bp written "
             f"in {time.perf_counter() - t0:.3f} s")
        sketches = timed("sketch for the row-block checks", _sketch, lst)
        rect_run = timed("row-block job", phase_rowblock, lst, sketches,
                         counters)
        int_rect_run = timed("u8 row-block job", phase_rowblock_int, lst,
                             sketches, counters)
        nibble_rows = {tag: timed(f"{tag} row-block job",
                                  phase_rowblock_nibble, tag, bbit, lst,
                                  sketches, counters)
                       for tag, bbit in (("rows-nibble-bbit", True),
                                         ("rows-nibble-ab", False))}
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    _say(f"[wall] all phases: {time.perf_counter() - t_start:.3f} s")
    # int_counts_self: launches summed over the four --fastcmp 1|2 jobs,
    # times and bound of the u8 a/b job's gtlt mode; int_counts_self_eq:
    # the same kernel in eq mode, launches of the two b-bit jobs, times,
    # bound and library call of the u8 b-bit job (each job's are printed
    # above)
    int_self_run = dict(int_runs["u8-ab"],
                        launches=sum(r["launches"] for r in int_runs.values()),
                        err=max(r["err"] for r in int_runs.values()))
    int_self_eq_run = dict(int_runs["u8-bbit"], launches=sum(
        int_runs[t]["launches"] for t in ("u8-bbit", "u16-bbit")))
    # the measure jobs' and nibble row-block jobs' launches join their
    # kernels' counts (times and bounds stay those printed above)
    for run, key, tags in (
            (eq_run, "tri_eq", ("mash-nibble-bbit",)),
            (comb_run, "tri_comb", ("union-nibble-ab",)),
            (self_run, "gtlt_self", ("containment-full-asym", "eqfull")),
            (int_self_run, "int_counts_self", ("intersection-u8-ab",
                                               "symcontain-u16-bbit")),
            (int_self_eq_run, "int_counts_self", ("symcontain-u16-bbit",))):
        run["launches"] += sum(measure_runs[t][key] for t in tags)
    int_rect_run["launches"] += sum(r["int_counts"]
                                    for r in nibble_rows.values())
    kernels = []
    for name, src, line, worst, run in (
            ("tri_eq_counts", "tri_eq.cu", 447, worst_eq, eq_run),
            ("tri_comb_counts", "tri_comb.cu", 367, worst_comb, comb_run),
            ("gtlt_self_counts", "gtlt.cu", 162, worst_self, self_run),
            ("gtlt_counts", "gtlt.cu", 45, worst_rect, rect_run),
            ("int_counts_self", "int_counts.cu", 239, worst_int_self,
             int_self_run),
            ("int_counts_self_eq", "int_counts.cu", 239, worst_int_self,
             int_self_eq_run),
            ("int_counts", "int_counts.cu", 239, worst_int_rect,
             int_rect_run)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"dashing2_tpu_torch/csrc/{src}",
            "replaces": f"dashing2_tpu/ops/pallas_cmp.py:{line}",
            "launches": run["launches"],
            "max_abs_err": max(worst, run["err"]),
            "ms": run["ms"],
            "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"],
            "bound_by": run["bound_by"],
            "library_ms": run["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
