"""chip_smoke.py's minimizer-sequence and u128 phases (37, 39, 47-50) at a
reduced size, for a first check of their code on the card.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 experiments/chip_smoke_seq_phases.py

The by-record corpus is cut to 256 families (4,096 records, one batch),
phase 39 to 2,048 records, phase 49's --topk job to 512 and phase 50's
genomes to 128 of a 160-genome corpus; everything else is chip_smoke.py's
own code. The corpora are written under build/ and deleted.
"""

import os
import shutil
import sys
import time

sys.path.insert(0, os.getcwd())
import chip_smoke as CS  # noqa: E402

CS.WORK = os.path.join(CS.ROOT, "build", "chip_smoke_seq")
CS.BYSEQ_FAMILIES = 256
CS.BYSEQ_N = CS.BYSEQ_FAMILIES * CS.BYSEQ_MEMBERS
CS.BYSEQ_KNN_N = 2048
CS.SEQ_KNN_N = 512
CS.EXACT_SUBSET = 128


def main() -> None:
    from dashing2_tpu_torch.ops import countsketch as CSK
    from dashing2_tpu_torch.ops import css as CSS
    from dashing2_tpu_torch.ops import gtlt as G
    from dashing2_tpu_torch.ops import int_counts as IC
    from dashing2_tpu_torch.ops import nibble_comb as NC
    from dashing2_tpu_torch.ops import nibble_tri as NT
    from dashing2_tpu_torch.ops import omh as OP
    from dashing2_tpu_torch.ops import oph_rows as OR
    from dashing2_tpu_torch.ops import weighted_draws as WD
    counters = {"tri_eq": NT, "tri_comb": NC, "gtlt_self": G.self_launches,
                "gtlt": G.rect_launches, "int_counts_self": IC.self_launches,
                "int_counts": IC.rect_launches,
                "weighted_draws": WD.launches, "omh": OP.launches,
                "oph_rows": OR.launches, "css": CSS.launches,
                "countsketch": CSK.launches, "hash_rows": OR.hash_launches}
    t0 = time.perf_counter()
    CS.phase_build()
    try:
        fa, recs = CS._byseq_corpus()
        _, host_regs = CS.phase_oph_vs_plain(fa, recs)
        CS.phase_byseq_knn(fa, recs, host_regs, counters)
        print(CS.phase_hash_rows_vs_plain(fa))
        for tag, args in (("seq-sketch", CS.SEQ_ARGS),
                          ("seq128-sketch", CS.SEQ128_ARGS)):
            CS.phase_seq_sketch(tag, args, fa, recs, counters)
        CS.phase_seq_compare(recs, counters)
        lst = CS._corpus("northstar", CS.NS_SEED, 16, 10, 20000)
        CS.phase_u128_sets(CS._subset_lists(lst), counters)
    finally:
        shutil.rmtree(CS.WORK, ignore_errors=True)
    print(f"done in {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
