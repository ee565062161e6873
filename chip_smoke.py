"""On-card smoke run of the PyTorch/CUDA port (dashing2_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA Hopper
card (H100), CUDA's nvcc, g++ and zlib:

    python3 chip_smoke.py

It builds every kernel of the port's main path from the checkout's
sources and drives the north-star job through the port's own CLI. It
exits non-zero when a phase fails (nothing is caught), when torch sees no
card, or when the port is not importable:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: nvcc for csrc/tri_eq.cu (sm_90a), g++ for the native sketcher
   and formatter; build seconds and ptxas' register/spill report;
3. kernel against plain, on the card: exact u16 equality of
   `tri_eq_counts` and `tri_eq_counts_plain` for n in {1, 2, 63, 129,
   1000, 1025, 4097} and m in {64, 256, 1024} with planted identical,
   all-0x00 and all-0xFF rows; the similarity table built on the card
   must equal the CPU-built table bit for bit;
4. golden digest: the port's CLI on the card over the seeded n=777
   corpus must reproduce the SHA-256 in
   tests/goldens/torch_port_bbit_nibble.json, which a CPU test ties to
   the JAX package's output;
5. main path at full size: N = 10240 genomes, 512 ancestors x 20
   mutants at 0.5-5% divergence, through
   `sketch -k 31 -S 1024 --fastcmp 0.5 --bbit-sigs --binary-output
   --cmpout out.bin -F list.txt` on the card. Checks the output size,
   that the kernel's launch counter moved during the run, that the
   kernel's full (N, N) count matrix equals the plain version's, and
   that every emitted value is the similarity table at the plain
   counts. Prints the phase walls and unique pairs/s.

Reduction: the north-star job uses 50 kb genomes; this one uses 20 kb.
The comparison's work depends only on N and m, 20 kb genomes still carry
about 20k distinct 31-mers (more than 5 m, so every register fills and
the job stays out of the OPH small-input regime), and it cuts the
generated FASTA from about 520 MB to about 205 MB.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
NORTH_STAR_N, NS_ANCESTORS, NS_MUTANTS, NS_LENGTH = 10240, 512, 20, 20000
NS_SEED = 11


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
    from dashing2_tpu_torch.ops import nibble_tri as NT
    t0 = time.perf_counter()
    NT.load_kernel()
    t1 = time.perf_counter()
    native.load_oph_lib()
    native.load_emit_lib()
    t2 = time.perf_counter()
    _say(f"[build] nvcc tri_eq.cu {t1 - t0:.3f} s; g++ native libs "
         f"{t2 - t1:.3f} s")
    for ln in native.build_logs.get("tri_eq", "").splitlines():
        if "registers" in ln or "spill" in ln:
            _say(f"[build] ptxas: {ln.strip()}")


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
    from dashing2_tpu_torch.ops import nibble_tri as NT
    rng = np.random.default_rng(2026)
    worst = 0
    for m in (64, 256, 1024):
        for n in (1, 2, 63, 129, 1000, 1025, 4097):
            a = torch.from_numpy(_planted(rng, n, m)).cuda()
            got = NT.tri_eq_counts(a, m).to(torch.int32)
            want = NT.tri_eq_counts_plain(a, m).to(torch.int32)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            worst = max(worst, err)
            assert err == 0, f"kernel != plain at n={n} m={m}: {err}"
            assert int(got.diagonal().min()) == m
        tc = sim_table("nibble-bbit", m, 0.5, "cuda").cpu().numpy()
        th = sim_table("nibble-bbit", m, 0.5, "cpu").numpy()
        assert np.array_equal(tc.view(np.uint32), th.view(np.uint32)), m
    _say("[kernel] tri_eq_counts == plain (exact u16) at n in {1, 2, 63, "
         "129, 1000, 1025, 4097} x m in {64, 256, 1024}; card-built sim "
         "table == CPU table bit for bit")
    return worst


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


def phase_golden():
    from dashing2_tpu_torch import cli
    with open(os.path.join(ROOT, "tests", "goldens",
                           "torch_port_bbit_nibble.json")) as f:
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
    _say(f"[golden] n={gold['n']} m={gold['m']}: sha256 {digest} matches "
         "the committed JAX digest")


def phase_main_path():
    import numpy as np
    import torch
    from dashing2_tpu_torch import cli, timing
    from dashing2_tpu_torch.cmp import core as C
    from dashing2_tpu_torch.config import Dashing2DistOptions
    from dashing2_tpu_torch.ops import nibble_tri as NT
    from dashing2_tpu_torch.sketch.core import sketch_fastx

    n, m = NORTH_STAR_N, 1024
    t0 = time.perf_counter()
    lst = _corpus("northstar", NS_SEED, NS_ANCESTORS, NS_MUTANTS, NS_LENGTH)
    _say(f"[main] corpus: {n} genomes x {NS_LENGTH} bp written in "
         f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(WORK, "northstar", "out.bin")
    argv = ["sketch", "-k", "31", "-S", str(m), "--fastcmp", "0.5",
            "--bbit-sigs", "--binary-output", "--cmpout", out, "-F", lst]

    timing.reset_spans()
    NT.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = NT.launches
    spans = timing.spans()
    assert rc == 0, rc
    assert os.path.getsize(out) == 4 * n * (n - 1) // 2
    assert launches >= 1, "the main path never launched tri_eq"
    pairs = n * (n - 1) // 2
    _say(f"[main] CLI wall {wall:.3f} s for {pairs} unique pairs: "
         f"{pairs / wall:.6e} unique pairs/s; tri_eq launches {launches}")
    for key in ("sketch", "sketch/native-files", "sketch/finalize",
                "compare+emit", "cmp/prep", "cmp/table", "cmp/h2d",
                "cmp/kernel", "cmp/d2h", "cmp/table-gather", "emit/write"):
        _say(f"[main] span {key}: {spans.get(key, 0.0):.6f} s")

    # the same job's registers, once more, for the kernel-vs-plain check
    opts = Dashing2DistOptions(k=31, sketchsize=m, fd_level=0.5,
                               truncation_method=1)
    with open(lst) as f:
        groups = [ln.strip() for ln in f if ln.strip()]
    creps, _ = C._prep(opts, sketch_fastx(opts, groups))
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
    _say(f"[main] tri_eq kernel {kernel_ms:.6f} ms (CUDA events, mean of "
         f"20 after a warm-up); plain {plain_ms:.6f} ms (mean of 3); full "
         f"{n}x{n} counts equal; u16 d2h copy {d2h:.6f} s")

    # every emitted value is the table at the plain version's counts
    table = C.sim_table("nibble-bbit", m, 0.5, "cuda").cpu().numpy()
    vals = np.fromfile(out, dtype=np.float32)
    assert np.isfinite(vals).all()
    off = 0
    for i in range(n - 1):
        row = vals[off:off + n - 1 - i]
        assert np.array_equal(row.view(np.uint32),
                              table[counts[i, i + 1:]].view(np.uint32)), i
        off += n - 1 - i
    hist = np.histogram(vals, bins=[0, 1e-9, 0.1, 0.5, 0.9, 1.0001])[0]
    _say(f"[main] output == table[plain counts] for all {pairs} pairs; "
         f"similarity counts in [0,1e-9) [1e-9,.1) [.1,.5) [.5,.9) [.9,1]: {hist.tolist()}")
    return launches, err, kernel_ms, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    import dashing2_tpu_torch  # noqa: F401  (fails outside a checkout)
    smi = phase_device()
    phase_build()
    worst = phase_kernel_vs_plain()
    try:
        phase_golden()
        launches, err, kernel_ms, plain_ms = phase_main_path()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    record = {"kernels": [{
        "name": "tri_eq_counts",
        "route": "cuda",
        "source": "dashing2_tpu_torch/csrc/tri_eq.cu",
        "replaces": "dashing2_tpu/ops/pallas_cmp.py:447",
        "launches": launches,
        "max_abs_err": max(worst, err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
