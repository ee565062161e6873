"""KNN / thresholded neighbor graphs and greedy dedup clustering.

Copy of dashing2_tpu/cmp/graph.py for one process: the same LSH
candidates (cmp/lsh.py), the same per-item selection and greedy walk,
and the same bytes out. The pair measures run on the caller's device
through cmp/core.py::measure_pairs (counts on the card for a CUDA job).
Exact k-mer sets and count dictionaries (`--set`, `--countdict`, u64 or
u128 keys) index their bottom-k hashes and refine on exact
intersections (cmp/wcompare.py, on the caller's device); minimizer
sequences (`--seq`) index the bottom-k of their distinct tokens and
refine on span edit distances (host). Left out: the JAX package's
multi-host branches (ROADMAP Queue 1 item 9) and its EXACT_KNN
environment switch (`build_exact_lists` is a plain function here).
Edit-distance (`-E`) jobs index their
OrderMinHash registers (the signatures), refine on them or on exact edit
distances (cmp/editdist.py), and `--greedy ...f` writes each cluster's
representative sequence.

Reference: src/index_build.cpp (build_index / build_exact_graph),
src/refine.cpp (refine_results), src/dedup_core.cpp (greedy CD-HIT-style
clustering), src/emitnn.cpp (CSR emit).

Flow (KNN/threshold): LSH candidate pairs (vectorized self-join) ->
batched true-measure refinement (measure_pairs) -> per-item top-k trim
with k-th-value ties kept / threshold filter (refine.cpp:27-72
semantics) -> CSR or human emit.

Dedup: LSH mode orders items by decreasing cardinality and resolves
each against precomputed shared-bucket candidates in batched rounds,
joining the best rep above the similarity threshold or founding a new
cluster (dedup_core.cpp:238-322). --exhaustive-dedup ("E" suffix)
compares every item against all reps in ORIGINAL input order, like the
reference's exhaustive branch.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Tuple

import numpy as np

from ..config import Dashing2DistOptions
from ..enums import (KmerSketchResultType, OutputFormat, OutputKind,
                     measure_is_distance)
from ..io import formats
from ..result import SketchingResult
from ..timing import phase
from . import core as C
from .lsh import LSHIndex, default_candidates

INFLATE_FACTOR = 3.5  # index_build.cpp:57
# items per dedup round (the JAX package's DASHING2_TPU_DEDUP_CHUNK
# default)
DEDUP_CHUNK = 256


def _index_source(opts: Dashing2DistOptions, result: SketchingResult,
                  creps: C.CompressedReps) -> LSHIndex:
    """What the LSH index is built over (index_build.cpp:70-99): the
    quantised registers of a sketch-compressed set (--setsketch-ab,
    --fastcmp-bytes/-shorts/-words), else the full signatures; exact
    sets index their bottom-k hashes (-S of them): a set's first -S, and
    a count dictionary's -S with the smallest hash // count
    (fastxsketch.cpp:24-47,451-459), in u64 integer division on the host
    and a stable sort (u128 keys: by the f64 ratio, as in the JAX
    package, a retrieval heuristic whose candidates are refined
    exactly); minimizer sequences the -S smallest of their distinct
    tokens."""
    from .. import u128 as U
    if opts.kmer_result == KmerSketchResultType.FULL_MMER_SEQUENCE:
        k = max(opts.sketchsize, 1)
        bk = [(U.unique_counts(s)[0] if U.is_u128(s) else np.unique(s))[:k]
              for s in result.mmer_sequences]
        return LSHIndex.build(np.zeros((0, 0)), opts.nLSH, bottomk=bk)
    if opts.kmer_result >= KmerSketchResultType.FULL_MMER_SET:
        k = max(opts.sketchsize, 1)
        counts = result.kmer_set_counts
        if (opts.kmer_result == KmerSketchResultType.FULL_MMER_COUNTDICT
                and counts is not None):
            bk = []
            for s, c in zip(result.kmer_sets, counts):
                c = np.maximum(np.asarray(c, np.float64), 1.0)
                if U.is_u128(s):
                    ratio = (s["hi"].astype(np.float64) * 2.0 ** 64
                             + s["lo"].astype(np.float64)) / c
                else:
                    ratio = s // c.astype(np.uint64)
                bk.append(s[np.argsort(ratio, kind="stable")[:k]])
        else:
            bk = [s[:k] for s in result.kmer_sets]
        return LSHIndex.build(np.zeros((0, 0)), opts.nLSH, bottomk=bk)
    if (creps.data is not None and not creps.nibble_packed
            and opts.sketch_compressed_set):
        return LSHIndex.build(creps.data, opts.nLSH)
    return LSHIndex.build(result.signatures, opts.nLSH)


def _refine_lists(opts: Dashing2DistOptions, result: SketchingResult,
                  creps: C.CompressedReps, ia: np.ndarray, ib: np.ndarray,
                  device="cuda") -> List[List[Tuple[float, int]]]:
    """Batched refinement + per-item selection (refine.cpp semantics).
    Returns per-item [(emitted_value, neighbor_id)] sorted best-first."""
    ropts = opts
    if opts.refine_exact and not opts.exact_kmer_dist:
        if opts.kmer_result <= KmerSketchResultType.FULL_SETSKETCH and \
                creps.data is not None:
            creps = C.CompressedReps(data=None)  # drop compression
        else:
            # exact edit distances for -E (no other register kind reads
            # exact_kmer_dist)
            ropts = dataclasses.replace(opts)
            ropts.exact_kmer_dist = True
    n = result.n
    vals = (C.measure_pairs(ropts, result, creps, ia, ib, device=device)
            if len(ia) else np.zeros(0, np.float32))
    isdist = measure_is_distance(opts.measure)
    if len(ia) == 0:
        return [[] for _ in range(n)]
    # vectorized grouped selection: mirror each pair to both endpoints,
    # lexsort by (item, key, neighbor) — the order of the per-list sort
    # key (v if isdist else -v, id) — then apply the reference's trim
    # semantics per group slice.
    items = np.concatenate([ia, ib]).astype(np.int64)
    nbrs = np.concatenate([ib, ia]).astype(np.int64)
    vv = np.concatenate([vals, vals]).astype(np.float32)
    if np.isnan(vv).any():
        # NaN keys would make lexsort and Python sort diverge; keep the
        # straightforward walk for that degenerate case
        lists: List[List[Tuple[float, int]]] = [[] for _ in range(n)]
        for a, b, v in zip(ia, ib, vals):
            lists[a].append((float(v), int(b)))
            lists[b].append((float(v), int(a)))
        for i, lst in enumerate(lists):
            lst.sort(key=lambda x: (x[0] if isdist else -x[0], x[1]))
            lists[i] = _trim_list(opts, isdist, lst)
        return lists
    key = vv if isdist else -vv.astype(np.float64)
    order = np.lexsort((nbrs, key, items))
    it_s, nb_s, v_s = items[order], nbrs[order], vv[order]
    k = opts.num_neighbors
    if k > 0 and not isdist:
        keep = v_s != np.float32(0.0)     # sim mode drops zeros pre-k
        it_s, nb_s, v_s = it_s[keep], nb_s[keep], v_s[keep]
    starts = np.searchsorted(it_s, np.arange(n), side="left")
    ends = np.searchsorted(it_s, np.arange(n), side="right")
    if k > 0:
        sizes = ends - starts
        big = sizes > k
        pos = np.arange(len(it_s)) - starts[it_s]
        kth = np.zeros(n, np.float32)
        kth[big] = v_s[starts[big] + k - 1]
        keep = (pos < k) | (big[it_s] & (v_s == kth[it_s]))
        it_s, nb_s, v_s = it_s[keep], nb_s[keep], v_s[keep]
        starts = np.searchsorted(it_s, np.arange(n), side="left")
        ends = np.searchsorted(it_s, np.arange(n), side="right")
    elif opts.min_similarity > 0:
        keep = (v_s < opts.min_similarity if isdist
                else v_s >= opts.min_similarity)
        it_s, nb_s, v_s = it_s[keep], nb_s[keep], v_s[keep]
        starts = np.searchsorted(it_s, np.arange(n), side="left")
        ends = np.searchsorted(it_s, np.arange(n), side="right")
    vf = v_s.astype(np.float64)
    nbl = nb_s.tolist()
    vfl = vf.tolist()
    return [list(zip(vfl[s:e], nbl[s:e]))
            for s, e in zip(starts.tolist(), ends.tolist())]


def _trim_list(opts: Dashing2DistOptions, isdist: bool,
               lst: List[Tuple[float, int]]) -> List[Tuple[float, int]]:
    """The reference's per-item trim (refine.cpp:27-72): top-k with
    k-th-value ties kept (similarity mode drops exact zeros first), or
    the threshold filter."""
    if opts.num_neighbors > 0:
        if not isdist:
            lst = [x for x in lst if x[0] != 0.0]
        if len(lst) > opts.num_neighbors:
            kth = lst[opts.num_neighbors - 1][0]
            lst = [x for j, x in enumerate(lst)
                   if j < opts.num_neighbors or x[0] == kth]
    elif opts.min_similarity > 0:
        if isdist:
            lst = [x for x in lst if x[0] < opts.min_similarity]
        else:
            lst = [x for x in lst if x[0] >= opts.min_similarity]
    return lst


def build_exact_lists(opts: Dashing2DistOptions, result: SketchingResult,
                      creps: C.CompressedReps, device="cuda"
                      ) -> List[List[Tuple[float, int]]]:
    """Brute-force oracle (build_exact_graph, index_build.cpp:166): every
    pair refined."""
    ia, ib = np.triu_indices(result.n, k=1)
    return _refine_lists(opts, result, creps, ia, ib, device)


def _load_or_build_index(opts: Dashing2DistOptions,
                         result: SketchingResult,
                         creps: C.CompressedReps) -> LSHIndex:
    """--index-load/--index-save plumbing around _index_source: a .ssi
    suffix selects the reference's gz layout (ssi.h:454-532), anything
    else the native format. Loaded .ssi indexes carry bucket maps only
    and serve candidates straight from them."""
    if opts.index_load:
        p = opts.index_load
        return (LSHIndex.load_ssi(p) if p.endswith(".ssi")
                else LSHIndex.load(p))
    idx = _index_source(opts, result, creps)
    if opts.index_save:
        p = opts.index_save
        if p.endswith(".ssi"):
            idx.save_ssi(p)
        else:
            idx.save(p)
    return idx


def neighbor_graph_main(opts: Dashing2DistOptions, result: SketchingResult,
                        device="cuda") -> None:
    """A KNN, threshold or dedup job from sketches to its output, with
    the pair measures on `device`; each phase is a span of the JAX
    package's name."""
    creps, result = C._prep(opts, result)
    n = result.n
    if opts.output_kind == OutputKind.DEDUP:
        with phase("dedup-cluster", opts.verbosity):
            ids, constituents = dedup_core(opts, result, creps,
                                           device=device)
        with phase("dedup-emit", opts.verbosity):
            dedup_emit(ids, constituents, opts, result)
        return
    ntoquery = (min(n - 1, int(opts.num_neighbors * INFLATE_FACTOR))
                if opts.num_neighbors > 0
                else (opts.maxcand if opts.maxcand > 0 else n - 1))
    with phase("lsh-index-build", opts.verbosity):
        idx = _load_or_build_index(opts, result, creps)
    with phase("lsh-candidates", opts.verbosity):
        ia, ib, _counts = idx.candidate_pairs(max_per_item=ntoquery)
    with phase("refine", opts.verbosity):
        lists = _refine_lists(opts, result, creps, ia, ib, device)
    with phase("emit-neighbors", opts.verbosity):
        emit_neighbors(lists, opts, result)


def emit_neighbors(lists, opts: Dashing2DistOptions,
                   result: SketchingResult) -> None:
    """emitnn.cpp:12-52."""
    path = opts.outfile_path
    if opts.output_format == OutputFormat.HUMAN_READABLE:
        f = (sys.stdout.buffer if not path or path in ("-", "/dev/stdout")
             else open(path, "wb"))
        from ..io.emitters import emit_neighbors_human
        emit_neighbors_human(f, lists, result.names)
        if f is not sys.stdout.buffer:
            f.close()
        return
    indptr = np.zeros(len(lists) + 1, dtype=np.uint64)
    for i, lst in enumerate(lists):
        indptr[i + 1] = indptr[i] + len(lst)
    indices = np.array([x[1] for lst in lists for x in lst], dtype=np.uint32)
    data = np.array([x[0] for lst in lists for x in lst], dtype=np.float32)
    out = path if path and path not in ("-", "/dev/stdout") else None
    if out is None:
        formats.write_knn_csr_fileobj(sys.stdout.buffer, indptr, indices,
                                      data)
    else:
        formats.write_knn_csr(out, indptr, indices, data)


# ----------------------------------------------------------------------
# greedy dedup
# ----------------------------------------------------------------------

def dedup_core(opts: Dashing2DistOptions, result: SketchingResult,
               creps: C.CompressedReps, chunk: int = DEDUP_CHUNK,
               device="cuda") -> Tuple[List[int], List[List[int]]]:
    """Greedy clustering in batched rounds: items are processed in
    cardinality order, and each round of `chunk` items issues ONE
    measure_pairs batch covering (a) every item's LSH candidates among
    existing representatives and (b) intra-round candidate pairs (items
    that share a bucket with an earlier round member that may become a
    rep). The greedy decisions then replay serially on the host over the
    precomputed similarities — the round result equals the serial walk
    whenever the per-item candidate cap is not the binding constraint
    (the reference's own parallel mode, par_reduce merging of per-thread
    clusterings at dedup_core.cpp:86-171, relaxes order far more).

    Chunk-size caveat: in the capped regime the result can depend on
    `chunk` — prior-round rep candidates are capped at maxcands while
    same-round founders arrive via intra_of uncapped, so moving an item
    across a chunk boundary can change which candidates it sees when the
    cap binds. Runs with a fixed chunk (default 256, the JAX package's)
    are deterministic."""
    n = result.n
    cards = result.cardinalities
    # LSH mode processes in descending-cardinality order (the reference's
    # `order` array); the EXHAUSTIVE branch iterates ORIGINAL input order
    # with no rep swap, exactly like dedup_core.cpp:262-283 (its sorted
    # order array is unused there)
    order = (np.arange(n, dtype=np.int64) if opts.exhaustive_dedup
             else np.argsort(-cards, kind="stable"))
    simt = opts.min_similarity if opts.min_similarity > 0 else 0.9
    isdist = measure_is_distance(opts.measure)
    maxcands = default_candidates(n, opts.maxcand)
    chunk = max(1, int(chunk))
    ids: List[int] = []
    constituents: List[List[int]] = []
    nbr_ids: List[np.ndarray] = []
    rep_store = np.full(n, -1, np.int64)   # item -> store id if rep
    pos_in_batch = np.full(n, -1, np.int64)
    if not opts.exhaustive_dedup:
        # ONE vectorized self-join replaces the per-item incremental
        # dict walk (ssi.h:394-448): every item's shared-bucket
        # neighbors are precomputed count-ranked, and rep candidates
        # during the greedy walk are a numpy filter against the current
        # representative set. Extra headroom (4x the per-item cap)
        # compensates for neighbors that never become reps.
        idx = _index_source(opts, result, creps)
        jia, jib, jcnt = idx.candidate_pairs(
            max_per_item=max(maxcands * 4, 64))
        items = np.concatenate([jia, jib])
        nbrs = np.concatenate([jib, jia])
        cnts = np.concatenate([jcnt, jcnt])
        o = np.lexsort((-cnts, items))
        items, nbrs = items[o], nbrs[o]
        nbr_ids = [np.zeros(0, np.int64)] * n
        if len(items):
            starts = np.nonzero(np.concatenate(
                [[True], items[1:] != items[:-1]]))[0]
            ends = np.concatenate([starts[1:], [len(items)]])
            for s, e in zip(starts, ends):
                nbr_ids[int(items[s])] = nbrs[s:e]

    def _passes(v: float) -> bool:
        # DOCUMENTED DEVIATION (README "dedup under distance measures"):
        # join when the best distance is BELOW the threshold. The
        # reference's `mult * best < simt` founds a new cluster when the
        # distance is small and joins when it is large
        # (dedup_core.cpp:136,276 — the mult sign makes distance joins
        # inverted), which clusters maximally-dissimilar items together.
        return (v < simt) if isdist else (v >= simt)

    for cs in range(0, n, chunk):
        batch = [int(x) for x in order[cs:cs + chunk]]
        Cn = len(batch)
        # 1. candidates vs existing reps (store ids), per item
        rep_cands: List[np.ndarray] = []
        for oid in batch:
            if opts.exhaustive_dedup:
                rep_cands.append(np.arange(len(ids), dtype=np.int64))
            else:
                nb = nbr_ids[oid]
                cand = rep_store[nb]
                cand = cand[cand >= 0][:maxcands]
                rep_cands.append(cand)
        # 2. intra-round candidate pairs (positions lo < hi)
        if opts.exhaustive_dedup:
            hi0, lo0 = np.tril_indices(Cn, k=-1)
        else:
            barr = np.asarray(batch)
            pos_in_batch[barr] = np.arange(Cn)
            pij = []
            for p, oid in enumerate(batch):
                nb = nbr_ids[oid]
                q = pos_in_batch[nb]
                q = q[(q >= 0) & (q != p)]
                if len(q):
                    pij.append(np.stack(
                        [np.minimum(q, p), np.maximum(q, p)], 1))
            if pij:
                allp = np.unique(np.concatenate(pij), axis=0)
                lo0, hi0 = allp[:, 0], allp[:, 1]
            else:
                lo0 = hi0 = np.zeros(0, np.int64)
            pos_in_batch[barr] = -1
        # 3. one batched measure for everything this round needs
        ia = [np.full(len(c), batch[p], np.int64)
              for p, c in enumerate(rep_cands)]
        ib = [np.array([ids[int(c)] for c in cand], np.int64)
              for cand in rep_cands]
        ia.append(np.array([batch[p] for p in hi0], np.int64))
        ib.append(np.array([batch[q] for q in lo0], np.int64))
        ia_all = np.concatenate(ia) if ia else np.zeros(0, np.int64)
        ib_all = np.concatenate(ib) if ib else np.zeros(0, np.int64)
        vals = (C.measure_pairs(opts, result, creps, ia_all, ib_all,
                                device=device)
                if len(ia_all) else np.zeros(0, np.float32))
        # split back
        off = 0
        rep_vals: List[np.ndarray] = []
        for cand in rep_cands:
            rep_vals.append(vals[off:off + len(cand)])
            off += len(cand)
        intra_vals = vals[off:]
        intra_of: List[List[Tuple[int, float]]] = [[] for _ in range(Cn)]
        for (q, p, v) in zip(lo0, hi0, intra_vals):
            intra_of[int(p)].append((int(q), float(v)))
        # 4. serial greedy replay on host
        newrep = [-1] * Cn          # position -> store id if it founded
        for p, oid in enumerate(batch):
            best_cid, best_v = -1, None
            for c, v in zip(rep_cands[p], rep_vals[p]):
                v = float(v)
                if best_v is None or (v < best_v if isdist else v > best_v):
                    best_v, best_cid = v, int(c)
            for q, v in intra_of[p]:
                if newrep[q] < 0:
                    continue
                if best_v is None or (v < best_v if isdist else v > best_v):
                    best_v, best_cid = v, newrep[q]
            if best_v is not None and _passes(best_v):
                constituents[best_cid].append(oid)
                # highest-cardinality rep defense (dedup_core.cpp:166-169;
                # unreachable under the sorted LSH order, kept to mirror
                # the reference's unsorted-parallel-arrival guard). The
                # reference's exhaustive branch never swaps.
                if not opts.exhaustive_dedup \
                        and cards[oid] > cards[ids[best_cid]]:
                    constituents[best_cid][-1] = ids[best_cid]
                    ids[best_cid] = oid
            else:
                rep_store[oid] = len(ids)
                newrep[p] = len(ids)
                ids.append(oid)
                constituents.append([])
    return ids, constituents


def dedup_emit(ids: List[int], constituents: List[List[int]],
               opts: Dashing2DistOptions, result: SketchingResult) -> None:
    """dedup_core.cpp:400-452: with --greedy ...f a FASTA record per
    cluster (`>Cluster-<id>_<representative>` then `<name>:<index>,` of
    each member, and the representative's sequence, or an empty line
    where the job kept no sequences, as in the JAX package), else the
    human cluster list, or the binary CSR with each cluster's
    representative first."""
    path = opts.outfile_path
    f = (sys.stdout.buffer if not path or path in ("-", "/dev/stdout")
         else open(path, "wb"))
    try:
        if opts.fasta_dedup:
            for cid, rep in enumerate(ids):
                hdr = f">Cluster-{cid}_{result.names[rep]}"
                if constituents[cid]:
                    hdr += " " + "".join(
                        f"{result.names[c]}:{c}," for c in constituents[cid])
                seq = (result.sequences[rep].decode()
                       if result.sequences else "")
                f.write((hdr + "\n" + seq + "\n").encode())
        elif opts.output_format == OutputFormat.HUMAN_READABLE:
            nitems = result.n
            avg = nitems / max(len(ids), 1)
            f.write((f"#Clustering {nitems} items yielded {len(ids)} "
                     f"clusters of average size {avg}, separated by "
                     f"minimum similarity {opts.min_similarity}\n").encode())
            for cid, rep in enumerate(ids):
                line = f"Cluster-{cid}\t{result.names[rep]}:{rep}"
                for c in constituents[cid]:
                    line += f"\t{result.names[c]}:{c}"
                f.write((line + "\n").encode())
        else:
            # CSR: representative first in each cluster's index list
            indptr = np.zeros(len(ids) + 1, dtype=np.uint64)
            rows = []
            for i, rep in enumerate(ids):
                rows.append(np.array([rep] + constituents[i],
                                     dtype=np.uint32))
                indptr[i + 1] = indptr[i] + len(rows[-1])
            f.write(np.array([len(ids), int(indptr[-1])],
                             np.uint64).tobytes())
            f.write(indptr.tobytes())
            for r in rows:
                f.write(r.tobytes())
    finally:
        if f is not sys.stdout.buffer:
            f.close()
