"""What the exact-set joins of the PyTorch port (cmp/wcompare.py) cost on
CPU tensors, over 512 genomes of chip_smoke.py's N = 10240 corpus.

    python3 experiments/torch_exact_cpu_costs.py [--threads 4] [--pairs 20000]

Writes the corpus' first 512 genomes (seed 11, 20 kb, families of 20)
under build/exact_cpu_costs/, counts them as `--countdict` sets, and
prints one JSON line:

* the key count, the largest set and the expansion entries of the full
  512 x 512 square (each key's holders, summed), so the mean number of
  items a key is shared by;
* the seconds of one ExactJoin block over the full square (the count
  sums of a count dictionary), and per expanded entry;
* the seconds per pair of `exact_intersections_pairs` over the first
  `--pairs` pairs of the upper triangle: the padded lookup the port
  uses, and a sort of each pair's two concatenated rows along the row
  (the JAX package's `_exact_pairs_device` merge) on the same table.

The counts are exact and hold on any machine; the times are host times
of whatever CPU runs it.
"""

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dashing2_tpu_torch.cmp import wcompare as W  # noqa: E402
from dashing2_tpu_torch.config import Dashing2Options  # noqa: E402
from dashing2_tpu_torch.enums import KmerSketchResultType  # noqa: E402
from dashing2_tpu_torch.io.corpus import write_corpus  # noqa: E402
from dashing2_tpu_torch.sketch.core import sketch_fastx  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=20000)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    work = os.path.join(ROOT, "build", "exact_cpu_costs")
    try:
        paths = write_corpus(os.path.join(work, "fa"), 11, 26, 20,
                             20000)[:512]
        res = sketch_fastx(Dashing2Options(
            k=31, kmer_result=KmerSketchResultType.FULL_MMER_COUNTDICT),
            paths)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cpu = torch.device("cpu")
    sizes = np.array([len(s) for s in res.kmer_sets])
    join = W.ExactJoin(W.device_sets(res, cpu), np.arange(len(paths)))
    t0 = time.perf_counter()
    join.block(np.arange(len(paths)))
    join_s = time.perf_counter() - t0

    ia, ib = np.triu_indices(len(paths), k=1)
    ia, ib = ia[:a.pairs], ib[:a.pairs]
    W.exact_intersections_pairs(res, ia[:10], ib[:10], device="cpu")
    t0 = time.perf_counter()
    W.exact_intersections_pairs(res, ia, ib, device="cpu")
    lookup_s = time.perf_counter() - t0
    padded = W.padded_sets(res, cpu)
    L = padded.keys.shape[1]
    step = max(1, W.PAIR_BUDGET // (2 * L))
    ia_t, ib_t = torch.from_numpy(ia), torch.from_numpy(ib)
    t0 = time.perf_counter()
    for s in range(0, len(ia), step):
        a_, b_ = ia_t[s:s + step], ib_t[s:s + step]
        torch.sort(torch.cat([padded.keys[a_], padded.keys[b_]], 1), dim=1)
    sort_s = time.perf_counter() - t0
    print(json.dumps({
        "items": len(paths), "threads": a.threads,
        "keys": int(sizes.sum()), "largest_set": int(sizes.max()),
        "square_entries": join.entries,
        "items_a_key": join.entries / int(sizes.sum()),
        "join_s": join_s, "join_ns_an_entry": 1e9 * join_s / join.entries,
        "pairs": len(ia), "lookup_ms_a_pair": 1e3 * lookup_s / len(ia),
        "row_sort_ms_a_pair": 1e3 * sort_s / len(ia)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
