"""Which kind of f64 `log` keeps the port's FullSetSketch output equal to the
JAX golden tests/goldens/full_sim.bin.

    python3 experiments/fss_log_order.py [--trials 4]

Runs the golden's configuration (tests/golden_configs.py: `sketch -k 17
-S 128 --full`, six genomes of tests/make_fixtures.py) through the port's
CLI on the CPU, with the CSetSketch draws' log (ops/sketch_kernels.py's
`log64`) replaced in turn by:

* `log64` itself, the port's fixed sequence;
* `per-value`: torch's log moved by one ulp, up or down, on about 22% of
  values chosen by a hash of the input's bits (a different but
  deterministic log: one input, one output);
* `per-place`: torch's log moved by one ulp on about 22% of elements
  chosen at random (a log whose result depends on where a value sits,
  as a kernel that takes two code paths by position would give).

Prints one JSON line per variant and trial: whether the bytes equal the
committed golden. The fixtures are written under build/fss_log_order/.
"""

import argparse
import hashlib
import json
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from dashing2_tpu_torch import cli  # noqa: E402
from dashing2_tpu_torch.ops import sketch_kernels as SK  # noqa: E402
from golden_configs import CONFIGS, LENGTH, N_GENOMES  # noqa: E402
from make_fixtures import make  # noqa: E402


def _shifted(y: torch.Tensor, flip: torch.Tensor, up: torch.Tensor):
    step = torch.where(up, 1, -1)
    return torch.where(flip, (y.view(torch.int64) + step).view(
        torch.float64), y)


def variant(name: str, seed: int):
    if name == "log64":
        return SK.log64
    if name == "per-value":
        def log(x):
            b = x.view(torch.int64)
            mix = ((b ^ seed) * -7046029254386353131 >> 40) & 1023
            return _shifted(torch.log(x), mix < 225, ((b >> 7) & 1) == 1)
        return log
    rng = np.random.default_rng(seed)

    def log(x):
        flip = torch.from_numpy(rng.random(tuple(x.shape)) < 0.22)
        up = torch.from_numpy(rng.random(tuple(x.shape)) < 0.5)
        return _shifted(torch.log(x), flip, up)
    return log


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=4)
    a = ap.parse_args()
    with open(os.path.join(ROOT, "tests", "goldens", "full_sim.bin"),
              "rb") as f:
        want = f.read()
    work = os.path.join(ROOT, "build", "fss_log_order")
    make(work, n_genomes=N_GENOMES, length=LENGTH, seed=42)
    args, _ = CONFIGS["full_sim.bin"]
    real = SK.log64
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name in ("log64", "per-value", "per-place"):
            for trial in range(1 if name == "log64" else a.trials):
                SK.log64 = variant(name, trial + 1)
                try:
                    assert cli.main(list(args) + ["--device", "cpu"]) == 0
                finally:
                    SK.log64 = real
                with open("full_sim.bin", "rb") as f:
                    got = f.read()
                print(json.dumps({
                    "log": name, "trial": trial, "equal": got == want,
                    "sha256": hashlib.sha256(got).hexdigest()[:12]}))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
