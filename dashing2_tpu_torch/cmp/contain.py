"""contain subcommand: mash-screen-like coverage of a k-mer database.

Port of dashing2_tpu/cmp/contain.py. Reference:
src/contain_main.cpp:133-301. Loads a stacked .kmer64 database
(--save-kmers output), hashes each query file's k-mers through the same
maskfn pipeline, and reports per (query, reference): coverage fraction
(#distinct db k-mers of the reference matched / sketchsize) and mean
depth (total matched occurrences / #matched).

The queries are read and hashed on the host (the port's copy of the
native reader and `hash_rows_native`, a prefetch thread reading ahead).
The lookup runs in torch on `--device` (default cuda): the database keys
sorted once on the device (each u64 with its top bit flipped, so that
int64 order is u64 order), then per query its distinct hashes and their
multiplicities (`torch.unique`), a `searchsorted`, the ragged expansion
of each hit key to the references that hold it (in sub-blocks of at
most EXPAND_BLOCK entries), and the per-reference match counts and
depth sums, both in int64 (exact), as the JAX package's numpy lookup
gives them. Coverage and depth are divided in f64 on the host and cast
to f32, as there.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch

from .. import hashing as H
from ..config import Dashing2Options
from ..device import resolve
from ..io import fastx, formats
from ..io.prefetch import prefetch
from ..timing import span

# hit (key, reference) entries one sub-block of the lookup expands
EXPAND_BLOCK = 1 << 26
_TOP = -(1 << 63)


def _flipped(keys: np.ndarray, dev) -> torch.Tensor:
    """u64 keys -> int64 with the top bit flipped, on `dev`."""
    t = torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                         .view(np.int64)).to(dev)
    return t ^ _TOP


class KmerLookup:
    """The database's keys, sorted on a device, with the reference that
    holds each (a key may be held by several, or several times by one:
    every empty register's key is 0)."""

    def __init__(self, kmers: np.ndarray, dev):
        nitems, self.sketchsize = kmers.shape
        self.nitems = nitems
        self.dev = dev
        keys, order = torch.sort(_flipped(kmers.reshape(-1), dev),
                                 stable=True)
        self.keys = keys
        self.owners = order // self.sketchsize

    def match(self, hv: np.ndarray):
        """One query's hashes -> (matches int64 (nitems,), depth sums
        int64 (nitems,)): per reference, its database keys the query
        holds, and the query's occurrences of them summed."""
        dev, keys = self.dev, self.keys
        matches = torch.zeros(self.nitems, dtype=torch.int64, device=dev)
        sums = torch.zeros(self.nitems, dtype=torch.int64, device=dev)
        if len(hv) and len(keys):
            uniq, counts = torch.unique(_flipped(hv, dev), sorted=True,
                                        return_counts=True)
            pos = torch.searchsorted(keys, uniq)
            hit = keys[pos.clamp_(max=len(keys) - 1)] == uniq
            uniq, counts, pos = uniq[hit], counts[hit], pos[hit]
            lens = torch.searchsorted(keys, uniq, right=True) - pos
            ends = torch.cumsum(lens, 0)
            ends_h = ends.cpu().numpy()
            s = 0
            while s < len(ends_h):
                # hit keys whose entries fit the sub-block (one at least)
                base = int(ends_h[s - 1]) if s else 0
                e = max(s + 1, int(np.searchsorted(
                    ends_h, base + EXPAND_BLOCK, side="right")))
                ln = lens[s:e]
                total = int(ends_h[e - 1]) - base
                starts = torch.repeat_interleave(pos[s:e], ln)
                within = torch.arange(total, device=dev) \
                    - torch.repeat_interleave(ends[s:e] - ln - base, ln)
                own = self.owners[starts + within]
                matches.index_add_(0, own, torch.ones_like(own))
                sums.index_add_(0, own, torch.repeat_interleave(
                    counts[s:e], ln))
                s = e
        return matches.cpu().numpy(), sums.cpu().numpy()


def contain_main(a) -> int:
    if not a.paths:
        print("contain requires a .kmer64 database and >= 1 query file",
              file=sys.stderr)
        return 1
    dbpath, queries = a.paths[0], list(a.paths[1:])
    if a.ffile:
        with open(a.ffile) as f:
            queries += [x.strip() for x in f if x.strip()]
    if not queries:
        print("contain requires >= 1 query file (positional or -F)",
              file=sys.stderr)
        return 1
    dev = resolve(getattr(a, "device", "cuda"))
    db = formats.read_kmer_db(dbpath)
    xormask = H.seed_mask(db.seed)[0] if db.seed else H.XORMASK
    names: List[str] = [str(i) for i in range(db.kmers.shape[0])]
    try:
        names, _ = formats.read_names_file(dbpath + ".names.txt")
    except OSError:
        base = dbpath[:-len(".kmer64")] if dbpath.endswith(".kmer64") \
            else dbpath
        try:
            names, _ = formats.read_names_file(base + ".names.txt")
        except OSError:
            pass
    nitems, sketchsize = db.kmers.shape
    with span("contain/db"):
        lookup = KmerLookup(db.kmers, dev)

    from ..sketch.core import _hash_kwargs, _native_hash_codes_list
    opts = Dashing2Options(k=db.k, w=db.w, alphabet=db.alphabet,
                           canonicalize=db.canon, seedseed=db.seed)
    opts.xormask = xormask
    hkw = _hash_kwargs(opts, 1 << 15)
    from ..native import load_oph_lib
    natlib = load_oph_lib()
    nq = len(queries)
    coverage = np.zeros((nq, nitems), np.float32)
    depth = np.zeros((nq, nitems), np.float32)

    def _code_batches():
        # the queries' records, alphabet-encoded, in batches of about
        # 32 MB of codes (the reference's threaded FastxParser pipeline,
        # contain_main.cpp:76-114)
        for qi, q in enumerate(queries):
            codes: List[np.ndarray] = []
            pending = 0
            for path in q.split():
                for _name, c in fastx.read_encoded(path, db.alphabet):
                    codes.append(c)
                    pending += len(c)
                    if pending >= (32 << 20):
                        yield qi, codes
                        codes, pending = [], 0
            yield qi, codes     # possibly empty: marks the query seen

    def _finalize(qi: int, hv_parts: List[np.ndarray]):
        if not hv_parts:
            return
        with span("contain/lookup"):
            matches, sums = lookup.match(np.concatenate(hv_parts))
        nz = matches > 0
        coverage[qi, nz] = matches[nz] / sketchsize
        depth[qi, nz] = sums[nz].astype(np.float64) / matches[nz]

    cur = -1
    hv_parts: List[np.ndarray] = []
    for qi, codes in prefetch(_code_batches(), depth=2):
        if qi != cur:
            if cur >= 0:
                _finalize(cur, hv_parts)
            cur, hv_parts = qi, []
        if not codes:
            continue
        with span("contain/hash"):
            hv_parts.append(_native_hash_codes_list(natlib, codes, hkw))
    if cur >= 0:
        _finalize(cur, hv_parts)
    # the reference's contain writes its matrix to -o (contain_main.cpp
    # "-o" handling); accept --cmpout as an alias
    outpath = a.cmpout or getattr(a, "outfile", None) or ""
    with span("contain/emit"):
        _emit(a.binary_output, outpath, names, queries, coverage, depth)
    return 0


def _emit(binary: bool, outpath: str, names: List[str], queries: List[str],
          coverage: np.ndarray, depth: np.ndarray) -> None:
    nq, nitems = coverage.shape
    if binary:
        if outpath and outpath not in ("-", "/dev/stdout"):
            formats.write_contain(outpath, coverage, depth)
        else:
            buf = sys.stdout.buffer
            buf.write(np.array([nitems, nq], np.uint64).tobytes())
            buf.write(coverage.astype(np.float32).tobytes())
            buf.write(depth.astype(np.float32).tobytes())
        return
    f = (sys.stdout if not outpath or outpath in ("-", "/dev/stdout")
         else open(outpath, "w"))
    f.write("#Dashing2 contain - a list of coverage %s for the set of "
            "references, + mean coverage levels.\n"
            "#Each matrix entry consists of <coverage%:mean depth of "
            "coverage>\n##References:")
    for nm in names[:nitems]:
        f.write("\t" + nm)
    f.write("\n")
    for qi, q in enumerate(queries):
        f.write(q)
        for j in range(nitems):
            f.write("\t%0.6g%%:%g" % (100.0 * coverage[qi, j],
                                      depth[qi, j]))
        f.write("\n")
    if f is not sys.stdout:
        f.close()
