"""How many weighted-sketch registers would change if the draws used the
device library's f32 log and exp instead of the port's fixed sequences
(ops/fixedmath.py, which equal XLA's CPU jnp.log/jnp.exp, so the JAX
package's registers).

    python3 experiments/weighted_log_flips.py [--genomes 200] [-m 1024]
        [--device cuda]

Writes the first `--genomes` genomes of chip_smoke.py's N = 10240 corpus
(seed 11, 20 kb, families of 20) under build/weighted_log_flips/, counts
their 31-mers (`-B`/`-P` counts), and draws every item's registers twice
on the card for each kind: with csrc/weighted_draws.cu, and with the
plain version whose log and exp are torch's (`torch.log`, `torch.exp`,
CUDA's f32 functions). Prints one JSON line per kind: the registers whose
winner differs and those whose value differs (ICWS keys its value by the
winner's t as well), their shares, and the device's name. `--device cpu`
runs both on the CPU (the plain version twice, torch's CPU functions).
"""

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dashing2_tpu_torch.config import Dashing2Options  # noqa: E402
from dashing2_tpu_torch.enums import SketchSpace  # noqa: E402
from dashing2_tpu_torch.io.corpus import write_corpus  # noqa: E402
from dashing2_tpu_torch.ops import weighted_draws as WD  # noqa: E402
from dashing2_tpu_torch.sketch import core as SC  # noqa: E402
from dashing2_tpu_torch.sketch import weighted as PW  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--genomes", type=int, default=200)
    ap.add_argument("-m", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        print("weighted_log_flips: no CUDA card", file=sys.stderr)
        return 2
    work = os.path.join(ROOT, "build", "weighted_log_flips")
    try:
        paths = write_corpus(os.path.join(work, "fa"), 11, a.genomes // 20,
                             20, 20000)[:a.genomes]
        counted = SC._count_stream(Dashing2Options(
            k=31, sketchsize=a.m, sspace=SketchSpace.SPACE_MULTISET), paths)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    uniq = [u for u, _ in counted]
    counts = [c for _, c in counted]
    off = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum([len(u) for u in uniq], out=off[1:])
    dev = torch.device(a.device)
    h = torch.from_numpy(np.concatenate(uniq).view(np.int64)).to(dev)
    o = torch.from_numpy(off).to(dev)
    for kind in WD.KINDS:
        w = torch.from_numpy(np.concatenate(PW._lnw_many(
            kind, uniq, counts)).astype(np.float32)).to(dev)
        _, win, val = WD.weighted_draws(kind, h, w, o, a.m)
        fixed = (WD.log32, WD.exp32)
        WD.log32, WD.exp32 = torch.log, torch.exp
        try:
            _, lwin, lval = WD.weighted_draws_plain(kind, h, w, o, a.m)
        finally:
            WD.log32, WD.exp32 = fixed
        regs = len(uniq) * a.m
        winners = int((win != lwin).sum())
        values = int((val.view(torch.int32) != lval.view(torch.int32)).sum())
        print(json.dumps({
            "kind": kind, "genomes": len(uniq), "m": a.m,
            "positions": int(off[-1]), "registers": regs,
            "winner_changed": winners, "value_changed": values,
            "winner_share": winners / regs, "value_share": values / regs,
            "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
