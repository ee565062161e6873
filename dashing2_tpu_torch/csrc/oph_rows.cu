// One-permutation registers of chunk rows, and their k-mer hash streams,
// for sm_90a (H100).
//
// Replaces the JAX package's device OPH engine, the XLA function
// `_fused_oph_fn` (dashing2_tpu/sketch/core.py:146): `_hash_chunk_batch`
// (:59; ops/kmers.py `hashed_kmers`, `dna_kmer_codes128`,
// `minimizer_mask`) fused with the OPH row engine `oph_sketch_segments`
// (dashing2_tpu/ops/sketch_kernels.py:57, and its dense/sort/rot twins,
// which give the same bytes). Its plain version is
// dashing2_tpu_torch/ops/oph_rows.py `oph_rows_plain`; the two agree bit
// for bit (tests/test_torch_cuda.py, chip_smoke.py).
//
// A second C entry, `hash_rows`, is the port of the XLA engines
// `_hash_chunk_batch` (dashing2_tpu/sketch/core.py:59) and
// `_hash_chunk_batch128` (:103) as the `--seq` route calls them: the
// same stages up to the masks, then, instead of the bucket-min, each
// block writes its segment's surviving tokens, in position order, to a
// range of a token slab that it reserves with one atomicAdd, with the
// segment's count and the range's start; a third entry, `hash_place`,
// moves each segment's tokens to its offset in the output (an
// exclusive scan of the counts, which the caller takes). With
// `full_key` (DNA128 only) the masked high word maskfn(hi, xormask2_hi)
// too (the raw hi with a zero seed); the downsample test and the
// filterset probe read the masked low word, as in the JAX function. Its
// plain versions are ops/oph_rows.py `hash_chunk_batch` and
// `hash_chunk_batch128`.
//
// Input: R rows of W alphabet codes (INVALID = 0xFF), each a chunk of
// one item (row_item[r], or -1 to skip the row); the job's encoding and
// masks in Params; a sorted u64 filterset. Output: per item m registers,
// register id % m = the least id over the item's surviving positions
// (initialised by the caller to 2^64 - 1), and on request its count.
//
// Per position q of a row (npos = W - span + 1 of them), as the JAX
// functions compute it:
//   * the k-mer code of the encoding (2-bit DNA, canonical = the
//     unsigned min with the reverse complement; base-b; spaced seeds,
//     `bits` a kept base; the cyclic rolling hash, canonical for DNA
//     only; the 128-bit code's low word, scored (hi >> 1) ^ lo for
//     minimizers), valid where no INVALID lies in its span;
//   * with nwin = w - k + 1 > 1, the minimizer rule of `minimizer_mask`:
//     q is kept iff it is valid, some live window (all nwin positions
//     valid, inside [0, npos)) containing q has q's score as its
//     minimum, and no position in the h = nwin - 1 before q (the u64
//     max before the row) has an equal score; invalid positions score
//     the u64 max. Restated as the kernel computes it: q is kept iff it
//     is the leftmost argmin of some live window and no position in
//     [q - h, q - 1] has an equal score (a window containing q whose
//     minimum equals q's score, with no equal score before q in it, has
//     q as its leftmost argmin; and conversely);
//   * owned positions only ([own_lo, own_hi): chunk halos), maskfn, the
//     downsample test, the filterset probe, id = wanghash(h ^ oph_xor).
//
// Schedule. What bounds the work is integer lane instructions (the
// codes are 1 byte a position, the registers 8 bytes each), so the
// design spends as few of them as it can on each position:
//   * A block of 128 threads takes one segment of a row: `seg` owned
//     positions (with minimizers also the h scored on each side). It
//     stages the segment's codes in shared memory with aligned 16-byte
//     loads, so no device byte is read twice, and finds the first and
//     last code that is not INVALID (a warp reduction and one barrier);
//     a block with none leaves there.
//   * Only the positions whose windows lie between those two codes are
//     rolled: chunk padding past a record's end costs nothing more. They
//     are cut into runs (4 times an odd number of positions, so the 32
//     lanes of a warp, a run apart, read 32 distinct banks), one a
//     thread. Where the keys go straight to the rings (below), runs of at
//     most about `run` over as few warps as hold them, each of those
//     warps full; the other warps skip the rolling. Where the scores are
//     staged, over all 128 threads: a segment is 128 runs of `run` less
//     the halos, `run` the longest (up to 4 span) for which four blocks
//     share an SM (else two, else one: ops/oph_rows.py `geometry`), so
//     that the SM keeps enough warps to hide the rolling's shared loads
//     while the span - 1 bases a run pushes before its first code stay
//     a fair share of its pushes; a segment cut short by a record's end
//     keeps every warp rolling on shorter runs. The loops of the roll
//     and of the window stage are unrolled by 4, so that a thread's
//     shared loads of several steps are in flight at once.
//   * A thread builds its run's first window from its bases, then rolls
//     one base a step: 2-bit DNA v = ((v << 2) | c) & mask and the
//     reverse complement rc = (rc >> 2) | ((3 - c) << 2(k - 1)) (on
//     (hi, lo) pairs for the 128-bit code; past 32 (64) bases the
//     complement's newest base is the window's 32nd (64th)); base-b
//     v = (v - c_old b^(k-1)) b + c_new; the rolling hash
//     v = rotl(v, 1) ^ rotl(T[c_old], k) ^ T[c_new] and
//     rc = rotr(rc ^ T[3 - c_old], 1) ^ rotl(T[3 - c_new], k - 1), all
//     exact in u64 wrap-around arithmetic. Validity is the count of
//     valid bases since the last INVALID one: a window is valid when it
//     reaches the span. A step has no branch: an INVALID code costs its
//     shared load and a compare, resets the count and the base-b and
//     rolling codes, and shifts into the 2-bit codes like a base (its
//     bits leave the window before the count reaches k again). Spaced
//     seeds build each valid code from their offsets in shared memory;
//     only their validity is rolled.
//   * oph_rows without minimizers: the valid positions' keys go into a
//     ring of 64 in shared memory a warp (ballot + popc); whenever 32
//     are waiting, the 32 lanes hash one each, so the hash chains run
//     on full warps however ragged the valid positions are.
//   * Otherwise (minimizers, and every hash_rows job) the runs stage
//     each position's score (the u64 max where invalid), its validity
//     and, for the 128-bit code, its key's low word in shared memory
//     (a full key's high word is ((score ^ lo) << 1) | its low bit,
//     which the validity byte keeps). With minimizers, the window
//     stage (van Herk / Gil-Werman): the windows' slots are cut into
//     chunks of nwin, and a thread a chunk walks it backwards for the
//     suffix minima (the leftmost argmin, and whether the suffix is all
//     valid, kept as a 16-bit slot index), then the next chunk forwards
//     for the prefix minimum; window j = [j, j + h] is the suffix of
//     j's chunk and a prefix of the next, so its leftmost argmin and
//     its liveness follow from one compare, about three u64 steps a
//     position. The argmin of each live window is flagged where it is
//     owned (neighbouring windows flag the same position; equal writes).
//   * The flagged candidates (with minimizers, about 2 / (nwin + 1) of
//     the positions; without, the valid ones) are listed in position
//     order by a block scan, and the list is taken 128 at a time, one a
//     thread, so the h-wide tie test and the masks run on full warps:
//     oph_rows pushes the survivors into the rings; hash_rows flags
//     them, counts them by a second block scan over the list, reserves
//     their range of the slab and writes them in order. A segment's
//     range that would pass the slab's capacity is not written (its
//     count is): the caller sees the cursor past the capacity and runs
//     the batch again with room for it.
//   * The bucket-min, for m up to ops/oph_rows.py's SMEM_BUCKETS_MAX_M
//     (`smem_buckets`): a block-level bucket-min in shared memory (a u64
//     atomicMin there is a compare-and-swap loop on sm_90), flushed by
//     reading each touched register and issuing the global atomicMin
//     only where the block's id is below it. Otherwise the same tested
//     atomicMin a position: a plain (L2) read of the register first,
//     and the atomic only where the id is below it (registers only
//     fall, so a stale read never skips a needed update). Counts are a
//     second launch on the same schedule that adds 1 where a position's
//     id equals its register.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RING = 64;               // keys a warp's ring holds
constexpr uint8_t INVALID = 0xFF;
constexpr uint64_t U64MAX = ~0ULL;
constexpr int MAX_SYMBOLS = 32;
constexpr int MAX_OFFSETS = 256;
constexpr int MAX_SLOTS = 1 << 15;     // staged slots a 16-bit index holds
constexpr uint16_t MARK = 0x8000;      // a 16-bit slot index's flag bit
enum Mode { MODE_DNA = 0, MODE_BASEB = 1, MODE_SPACED = 2, MODE_ROLL = 3,
            MODE_DNA128 = 4 };
// what a block does with its surviving positions: bucket-min them into
// registers (oph_rows), or write their tokens (hash_rows; with the
// masked high word too)
enum Out { OUT_BUCKETS = 0, OUT_STREAM = 1, OUT_STREAM128 = 2 };

}  // namespace

// ops/oph_rows.py `Params`, field for field
struct Params {
    int64_t R, W, npos, own_lo, own_hi, m, fs_len, seg, nseg;
    uint64_t xormask, oph_xor, ds_threshold, ds_salt, bpow;
    uint64_t roll[MAX_SYMBOLS];
    int32_t mode, k, span, nwin, canon, seed_is_zero, downsample, base,
        bits, noff, run, smem_buckets;
    int32_t offsets[MAX_OFFSETS];
    uint64_t xormask2_hi;               // hash_rows with full_key only
    int32_t full_key;
};

namespace {

// Whether a block stages its positions' scores (minimizers, and every
// hash_rows job: m = 0) or pushes its keys straight into the rings.
__host__ __device__ inline bool staged(const Params& p) {
    return p.nwin > 1 || p.m == 0;
}

// Shared-memory layout of a block, in bytes (ops/oph_rows.py
// `smem_bytes` computes the same total).
struct Layout {
    int64_t ring, table, ext, scan, buckets, sc, ky, ix, stage, va, cf,
        total;
    int64_t E, nstage;
};

__host__ __device__ inline int64_t align16(int64_t x) {
    return (x + 15) & ~int64_t(15);
}

__host__ __device__ inline Layout layout(const Params& p) {
    Layout L;
    const bool st = staged(p);
    const int64_t h = p.nwin > 1 ? p.nwin - 1 : 0;
    L.E = st ? p.seg + 2 * h : 0;               // staged slots
    L.nstage = align16((st ? L.E : p.seg) + p.span - 1 + 32);
    int64_t at = 0;
    L.ring = at;    at += 8 * (int64_t)WARPS * RING;
    L.table = at;   at += 8 * MAX_SYMBOLS;
    L.ext = at;     at += 8 * WARPS;
    L.scan = at;    at += 16;
    L.buckets = at; at += p.smem_buckets ? 8 * p.m : 0;
    L.sc = at;      at += 8 * L.E;
    L.ky = at;      at += p.mode == MODE_DNA128 ? 8 * L.E : 0;
    L.ix = at;      at += 2 * L.E;
    at = align16(at);
    L.stage = at;   at += L.nstage;
    L.va = at;      at += L.E;
    L.cf = at;      at += p.nwin > 1 ? L.E : 0;
    L.total = align16(at);
    return L;
}

__device__ __forceinline__ uint64_t wanghash(uint64_t x) {
    x = (~x) + (x << 21);
    x ^= x >> 24;
    x *= 265;
    x ^= x >> 14;
    x *= 21;
    x ^= x >> 28;
    x += x << 31;
    return x;
}

// rotl by s in [0, 64), as two funnel shifts of the 32-bit halves
__device__ __forceinline__ uint64_t rotl(uint64_t x, int s) {
    uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
    if (s & 32) {
        const uint32_t t = lo;
        lo = hi;
        hi = t;
    }
    return ((uint64_t)__funnelshift_l(lo, hi, s) << 32)
        | __funnelshift_l(hi, lo, s);
}

// The outputs of a launch: registers (and counts) for oph_rows; for
// hash_rows the token slab (and high words) of `cap` tokens, the
// cursor its ranges are reserved from, and each block's count and
// range start.
struct Outs {
    unsigned long long* regs;
    unsigned int* counts;
    uint64_t* tok;
    uint64_t* tok_hi;
    long long* seg_count;
    long long* seg_start;
    unsigned long long* cursor;
    long long cap;
};

// What one block shares between its stages.
struct Ctx {
    const Params* p;
    const uint64_t* __restrict__ fs;
    unsigned long long* __restrict__ regs;
    unsigned int* __restrict__ counts;
    unsigned long long* sbk;            // shared buckets, or null
    uint64_t* ring;                     // this warp's ring
    int64_t reg0;                       // item * m
    bool count_pass;
};

// The masked token of a key, or false where the downsample test or the
// filterset drops it.
__device__ __forceinline__ bool masked(const Ctx& cx, uint64_t key,
                                       uint64_t* h_out) {
    const Params& p = *cx.p;
    const uint64_t h = p.seed_is_zero ? key : wanghash(key ^ p.xormask);
    *h_out = h;
    if (p.downsample && !(wanghash(h ^ p.ds_salt) < p.ds_threshold))
        return false;
    if (p.fs_len) {
        int64_t lo = 0, hi = p.fs_len;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (cx.fs[mid] < h) lo = mid + 1; else hi = mid;
        }
        if (lo < p.fs_len && cx.fs[lo] == h) return false;
    }
    return true;
}

// One position's key through the masks to its bucket.
__device__ __forceinline__ void consume(const Ctx& cx, uint64_t key) {
    const Params& p = *cx.p;
    uint64_t h;
    if (!masked(cx, key, &h)) return;
    const uint64_t id = wanghash(h ^ p.oph_xor);
    const uint64_t b = (p.m & (p.m - 1)) == 0 ? id & (uint64_t)(p.m - 1)
                                              : id % (uint64_t)p.m;
    unsigned long long* reg = cx.regs + cx.reg0 + (int64_t)b;
    if (cx.count_pass) {
        if (__ldcg(reg) == id) atomicAdd(cx.counts + cx.reg0 + b, 1u);
    } else if (cx.sbk) {
        atomicMin(cx.sbk + b, (unsigned long long)id);
    } else if (id < __ldcg(reg)) {
        atomicMin(reg, (unsigned long long)id);
    }
}

// A warp's ring: the lanes' valid keys of one step go in; 32 come out
// and are consumed, one a lane, whenever 32 wait. head and tail are the
// same in every lane.
struct Ring {
    unsigned head = 0, tail = 0;

    __device__ __forceinline__ void push(const Ctx& cx, bool valid,
                                         uint64_t key) {
        const unsigned lane = threadIdx.x & 31;
        const unsigned bal = __ballot_sync(0xFFFFFFFFu, valid);
        if (valid)
            cx.ring[(tail + __popc(bal & ((1u << lane) - 1))) & (RING - 1)]
                = key;
        tail += __popc(bal);
        if (tail - head >= 32) {
            __syncwarp();
            const uint64_t k = cx.ring[(head + lane) & (RING - 1)];
            __syncwarp();
            head += 32;
            consume(cx, k);
        }
    }

    __device__ __forceinline__ void drain(const Ctx& cx) {
        const unsigned lane = threadIdx.x & 31;
        __syncwarp();
        if (lane < tail - head)
            consume(cx, cx.ring[(head + lane) & (RING - 1)]);
        __syncwarp();
        head = tail;
    }
};

// The exclusive prefix of c over the block's threads in order, and in
// *total their sum; every thread calls it (two barriers; `wsum` holds
// WARPS ints).
__device__ __forceinline__ int block_scan(int c, int* wsum, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int s = wsum[w];
        before += w < warp ? s : 0;
        all += s;
    }
    __syncthreads();
    *total = all;
    return before + x - c;
}

// A thread's share [*i0, *i1) of n items cut into THREADS contiguous
// pieces, each 4 x odd long (lanes a piece apart read distinct banks of
// a byte array).
__device__ __forceinline__ void piece(int n, int* i0, int* i1) {
    int per = (n + THREADS - 1) / THREADS;
    per = (per + 3) & ~3;
    if (((per >> 2) & 1) == 0) per += 4;
    *i0 = min((int)threadIdx.x * per, n);
    *i1 = min(*i0 + per, n);
}

// The rolling state of one run: the codes of the window that ends at
// the last pushed base, and `len`, the valid bases since the last
// INVALID one (or since the run's first base). A push has no branch:
// an INVALID base is shifted into the 2-bit codes like any other (its
// bits leave the window before the count reaches k again; its
// complement is pushed as 0) and resets the base-b and rolling codes.
template <int MODE, bool CANON>
struct Roller {
    uint64_t v = 0, rc = 0, vhi = 0, rchi = 0;
    int len = 0;
    // the job's constants
    uint64_t lmask, hmask, bpow, base;
    int k, sh, dk, rk, rk1;

    __device__ __forceinline__ explicit Roller(const Params& p) {
        k = p.k;
        const int kr = MODE == MODE_DNA ? 32 : 64;   // bases rc holds
        lmask = k >= 32 ? U64MAX : (1ULL << (2 * k)) - 1;
        hmask = k >= 64 ? U64MAX : k > 32 ? (1ULL << (2 * k - 64)) - 1 : 0;
        sh = 2 * ((k < kr ? k : kr) - 1);
        // the complement's newest base: the window's last, or its kr-th
        // when k > kr (bases past kr shift out of rc)
        dk = k > kr ? k - kr : 0;
        rk = k & 63;
        rk1 = (k - 1) & 63;
        bpow = p.bpow;
        base = (uint64_t)p.base;
    }

    // push stage[xi] (an INVALID base where !in)
    __device__ __forceinline__ void push(const uint8_t* __restrict__ stage,
                                         const uint64_t* T, int xi,
                                         bool in) {
        const uint32_t c = in ? stage[xi] : INVALID;
        const bool inv = c == INVALID;
        const bool full = len >= k;            // base xi - k leaves
        len = inv ? 0 : len + 1;
        if constexpr (MODE == MODE_DNA || MODE == MODE_DNA128) {
            if constexpr (MODE == MODE_DNA128)
                vhi = ((vhi << 2) | (v >> 62)) & hmask;
            v = ((v << 2) | c) & lmask;
            if constexpr (CANON) {
                const int i = xi - dk;
                const uint32_t cr = dk == 0 ? c
                    : in && i >= 0 ? stage[i] : INVALID;
                const uint64_t comp = (uint64_t)(~cr & 3);
                if constexpr (MODE == MODE_DNA) {
                    rc = (rc >> 2) | (comp << sh);
                } else {
                    rc = (rc >> 2) | (rchi << 62);
                    rchi >>= 2;
                    if (sh < 64) rc |= comp << sh;
                    else rchi |= comp << (sh - 64);
                }
            }
        } else if constexpr (MODE == MODE_BASEB) {
            const uint64_t co = full && in ? stage[xi - k] : 0;
            const uint64_t nv = (v - co * bpow) * base + c;
            v = inv ? 0 : nv;
        } else if constexpr (MODE == MODE_ROLL) {
            const uint32_t cc = inv ? 0 : c;
            const uint32_t co = full && in ? stage[xi - k] : 0;
            uint64_t nv = rotl(v, 1) ^ T[cc];
            if (full) nv ^= rotl(T[co], rk);
            v = inv ? 0 : nv;
            if constexpr (CANON) {
                const uint64_t nrc = rotl(full ? rc ^ T[3 - co] : rc, 63)
                    ^ rotl(T[3 - cc], rk1);
                rc = inv ? 0 : nrc;
            }
        }
        // MODE_SPACED: only the count
    }

    // the (score, key) of the window that starts at stage index qi, and
    // the 128-bit code's high word (0 in the other modes)
    __device__ __forceinline__ void code(const Params& p,
                                         const uint8_t* __restrict__ stage,
                                         int qi, uint64_t* score,
                                         uint64_t* key, uint64_t* khi) const {
        *khi = 0;
        if constexpr (MODE == MODE_DNA || MODE == MODE_ROLL) {
            *key = CANON && rc < v ? rc : v;
            *score = *key;
        } else if constexpr (MODE == MODE_DNA128) {
            const bool r = CANON && (rchi < vhi || (rchi == vhi && rc < v));
            *key = r ? rc : v;
            *khi = r ? rchi : vhi;
            *score = (*khi >> 1) ^ *key;
        } else if constexpr (MODE == MODE_BASEB) {
            *key = *score = v;
        } else {  // MODE_SPACED
            uint64_t s = 0;
            for (int j = 0; j < p.noff; ++j)
                s = (s << p.bits) | stage[qi + p.offsets[j]];
            *key = *score = s;
        }
    }
};

template <int MODE, bool CANON, int OUT>
__global__ void __launch_bounds__(THREADS)
oph_rows_kernel(const __grid_constant__ Params p,
                const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ row_item,
                const uint64_t* __restrict__ fs, Outs o, int count_pass) {
    constexpr bool STREAM = OUT != OUT_BUCKETS;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned long long* __restrict__ regs = o.regs;
    const int64_t r = blockIdx.x / p.nseg;
    const int64_t s = blockIdx.x % p.nseg;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int32_t item = row_item ? row_item[r] : 0;
    if (item < 0) {                             // the whole block
        if (STREAM && tid == 0) {
            o.seg_count[blockIdx.x] = 0;
            o.seg_start[blockIdx.x] = 0;
        }
        return;
    }
    const Layout Ly = layout(p);
    const int64_t lo = p.own_lo > 0 ? p.own_lo : 0;
    const int64_t hi = p.own_hi < p.npos ? p.own_hi : p.npos;
    const int64_t p0 = lo + s * p.seg;
    const int64_t p1 = p0 + p.seg < hi ? p0 + p.seg : hi;
    const bool mini = p.nwin > 1;
    const bool st = STREAM || mini;             // staged(p)
    const int h = mini ? p.nwin - 1 : 0;
    // rolled positions [e0, e1): the owned ones, with minimizers also h
    // on each side (inside [0, npos)); below, positions are counted
    // from e0 in int
    const int64_t qs = p0 - h;                  // slot 0 of the scores
    const int64_t e0 = qs > 0 ? qs : 0;
    const int64_t e1 = p1 + h < p.npos ? p1 + h : p.npos;
    const int ne = (int)(e1 - e0);
    const int nb = ne + p.span - 1;             // bases [e0, e0 + nb)

    Ctx cx;
    cx.p = &p;
    cx.fs = fs;
    cx.regs = regs;
    cx.counts = o.counts;
    cx.reg0 = (int64_t)item * p.m;
    cx.count_pass = count_pass != 0;
    cx.ring = reinterpret_cast<uint64_t*>(smem + Ly.ring) + warp * RING;
    cx.sbk = p.smem_buckets && !count_pass
        ? reinterpret_cast<unsigned long long*>(smem + Ly.buckets)
        : nullptr;
    uint64_t* T = reinterpret_cast<uint64_t*>(smem + Ly.table);
    int* scan = reinterpret_cast<int*>(smem + Ly.scan);
    uint64_t* sc = reinterpret_cast<uint64_t*>(smem + Ly.sc);
    uint64_t* ky = reinterpret_cast<uint64_t*>(smem + Ly.ky);
    uint16_t* ix = reinterpret_cast<uint16_t*>(smem + Ly.ix);
    uint8_t* va = smem + Ly.va;
    uint8_t* cf = smem + Ly.cf;

    // stage the bases with aligned 16-byte loads: stage[a + j] = base
    // e0 + j, a = the misalignment of row + e0
    const uint8_t* g = codes + r * p.W + e0;
    const uint4* g16 = reinterpret_cast<const uint4*>(
        reinterpret_cast<uintptr_t>(g) & ~uintptr_t(15));
    const int a = (int)(reinterpret_cast<uintptr_t>(g) & 15);
    uint8_t* stage = smem + Ly.stage;
    const int nvec = (a + nb + 15) >> 4;
    // the first and last staged code that is not INVALID (stage indices)
    int first = 0x7FFFFFFF, last = -1;
    for (int i = tid; i < nvec; i += THREADS) {
        const uint4 x = __ldg(g16 + i);
        reinterpret_cast<uint4*>(stage)[i] = x;
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int wb = 16 * i + 4 * j;      // the word's first byte
            uint32_t nf = ~w[j];                // nonzero bytes: codes
            if (wb < a || wb + 4 > a + nb) {    // bytes outside the range
                const int b0 = a - wb, b1 = a + nb - wb;
                for (int bt = 0; bt < 4; ++bt)
                    if (bt < b0 || bt >= b1) nf &= ~(0xFFu << (8 * bt));
            }
            if (nf) {
                first = min(first, wb + ((__ffs(nf) - 1) >> 3));
                last = max(last, wb + ((31 - __clz(nf)) >> 3));
            }
        }
    }
    if (MODE == MODE_ROLL && tid < MAX_SYMBOLS) T[tid] = p.roll[tid];
    if (cx.sbk)
        for (int64_t b = tid; b < p.m; b += THREADS) cx.sbk[b] = U64MAX;
    int* ext = reinterpret_cast<int*>(smem + Ly.ext);
    first = __reduce_min_sync(0xFFFFFFFFu, first);
    last = __reduce_max_sync(0xFFFFFFFFu, last);
    if (lane == 0) {
        ext[warp] = first;
        ext[WARPS + warp] = last;
    }
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) {
        first = min(first, ext[w]);
        last = max(last, ext[WARPS + w]);
    }
    // positions [ulo, uhi) (from e0) whose windows lie between those
    // codes: every other one is invalid
    const int ulo = first - a;
    const int uhi = min(last - a - p.span + 2, ne);
    if (uhi <= ulo) {                           // no window: nothing
        if (STREAM && tid == 0) {
            o.seg_count[blockIdx.x] = 0;
            o.seg_start[blockIdx.x] = 0;
        }
        return;
    }
    const int ds = (int)(e0 - qs);              // score slot of e0
    if (st) {
        // the slots that are not rolled: invalid, scored the u64 max
        const int r0 = ds + ulo, r1 = ds + uhi;
        for (int e = tid; e < Ly.E; e += THREADS) {
            if (e < r0 || e >= r1) {
                sc[e] = U64MAX;
                va[e] = 0;
            }
            if (mini) cf[e] = 0;
        }
    }

    // this thread's run of positions [u0, u0 + un): the range cut into
    // runs that fill whole warps, of at most about p.run where the
    // codes go straight to the rings, and over every warp where they
    // are staged (so that all of them roll: a run is then at most p.run)
    const int nx = uhi - ulo;
    const int nwu = st ? WARPS : (nx + 32 * p.run - 1) / (32 * p.run);
    int run = (nx + 32 * nwu - 1) / (32 * nwu);
    run = (run + 3) & ~3;
    if (((run >> 2) & 1) == 0) run += 4;        // 4 x odd
    const int u0 = ulo + tid * run;
    const int un = min(run, uhi - u0);
    const bool live = warp < nwu;

    Ring ring;
    if (live) {
        Roller<MODE, CANON> ro(p);
        const int qi0 = a + u0;                 // stage index of u0
        if (un > 0)
            for (int j = 0; j < p.span - 1; ++j)
                ro.push(stage, T, qi0 + j, true);
        const int sm1 = p.span - 1;
#pragma unroll 4
        for (int t = 0; t < run; ++t) {
            const bool in = t < un;
            ro.push(stage, T, qi0 + t + sm1, in);
            const bool valid = in && ro.len >= p.span;
            uint64_t score = U64MAX, key = 0, khi = 0;
            if (valid) ro.code(p, stage, qi0 + t, &score, &key, &khi);
            if (st) {
                if (in) {
                    const int e = ds + u0 + t;
                    sc[e] = score;
                    va[e] = (uint8_t)(valid
                        | (OUT == OUT_STREAM128 ? (khi & 1) << 1 : 0));
                    if (MODE == MODE_DNA128) ky[e] = key;
                }
            } else if constexpr (OUT == OUT_BUCKETS) {
                ring.push(cx, valid, key);
            }
        }
    }
    if (st) {
        __syncthreads();
        const int no = (int)(p1 - p0);          // owned: slots [h, h + no)
        if (mini) {
            // van Herk / Gil-Werman over chunks of nwin slots: window j
            // (slots [j, j + h]) is the suffix of its chunk from j and
            // the next chunk's prefix up to j + h
            const int N = p.nwin;
            const int nwt = no + h;             // windows: slots [0, nwt)
            const int nch = (nwt + N - 1) / N;
            for (int c = tid; c < nch; c += THREADS) {
                const int b = c * N;
                uint64_t best = U64MAX;
                int bi = b + h;
                bool ok = true;
#pragma unroll 4
                for (int i = b + h; i >= b; --i) {  // suffix minima
                    const uint64_t v = sc[i];
                    if (v <= best) {            // ties: the leftmost
                        best = v;
                        bi = i;
                    }
                    ok = ok && (va[i] & 1);
                    ix[i] = (uint16_t)(bi | (ok ? MARK : 0));
                }
                uint64_t pb = U64MAX;           // the prefix so far
                int pi = 0;
                bool pok = true;
                const int jn = min(N, nwt - b);
#pragma unroll 4
                for (int t = 0; t < jn; ++t) {
                    if (t > 0) {
                        const int i = b + h + t;
                        const uint64_t v = sc[i];
                        if (v < pb) {
                            pb = v;
                            pi = i;
                        }
                        pok = pok && (va[i] & 1);
                    }
                    const unsigned x = ix[b + t];
                    if ((x & MARK) && pok) {        // a live window
                        const int si = x & (MARK - 1);
                        const int q = sc[si] <= pb ? si : pi;
                        if (q >= h && q < h + no) cf[q] = 1;
                    }
                }
            }
            __syncthreads();
        }
        // the candidates (flagged, or every valid owned slot without
        // minimizers) listed in position order
        int i0, i1, ncand;
        piece(no, &i0, &i1);
        const uint8_t* flag = mini ? cf : va;
        int c = 0;
        for (int i = i0; i < i1; ++i) c += flag[h + i] & 1;
        int at = block_scan(c, scan, &ncand);
        for (int i = i0; i < i1; ++i)
            if (flag[h + i] & 1) ix[at++] = (uint16_t)(h + i);
        __syncthreads();
        // the tie test and the masks, a candidate a thread (full warps)
        for (int base = 0; base < ncand; base += THREADS) {
            const int i = base + tid;
            bool sel = false;
            uint64_t key = 0;
            if (i < ncand) {
                const int q = ix[i];
                const uint64_t v = sc[q];
                bool dup = false;
                for (int d = 1; d <= h; ++d) dup |= sc[q - d] == v;
                sel = !dup;
                key = MODE == MODE_DNA128 ? ky[q] : v;
            }
            if constexpr (OUT == OUT_BUCKETS) {
                ring.push(cx, sel, key);
            } else if (i < ncand) {
                uint64_t hh;
                if (sel && masked(cx, key, &hh)) ix[i] |= MARK;
            }
        }
        if constexpr (STREAM) {
            // the survivors: counted, their range of the slab reserved,
            // written in order
            __syncthreads();
            int nk;
            piece(ncand, &i0, &i1);
            c = 0;
            for (int i = i0; i < i1; ++i) c += ix[i] >> 15;
            at = block_scan(c, scan, &nk);
            if (tid == 0) {
                const unsigned long long s0 =
                    nk ? atomicAdd(o.cursor, (unsigned long long)nk) : 0;
                o.seg_count[blockIdx.x] = nk;
                o.seg_start[blockIdx.x] = (long long)s0;
                reinterpret_cast<unsigned long long*>(scan)[1] = s0;
            }
            __syncthreads();
            const long long s0 =
                (long long)reinterpret_cast<unsigned long long*>(scan)[1];
            if (c == 0 || s0 + nk > o.cap) return;
            for (int i = i0; i < i1; ++i) {
                const unsigned x = ix[i];
                if (!(x & MARK)) continue;
                const int q = x & (MARK - 1);
                const uint64_t key = MODE == MODE_DNA128 ? ky[q] : sc[q];
                const long long w = s0 + at++;
                o.tok[w] = p.seed_is_zero ? key : wanghash(key ^ p.xormask);
                if constexpr (OUT == OUT_STREAM128) {
                    const uint64_t khi = ((sc[q] ^ key) << 1)
                        | ((va[q] >> 1) & 1);
                    o.tok_hi[w] = p.seed_is_zero
                        ? khi : wanghash(khi ^ p.xormask2_hi);
                }
            }
            return;
        }
    }
    if constexpr (OUT == OUT_BUCKETS) {
        ring.drain(cx);
        if (cx.sbk) {
            __syncthreads();
            for (int64_t b = tid; b < p.m; b += THREADS) {
                const unsigned long long v = cx.sbk[b];
                if (v != U64MAX && v < __ldcg(regs + cx.reg0 + b))
                    atomicMin(regs + cx.reg0 + b, v);
            }
        }
    }
}

// hash_rows' placement: a warp a segment copies its count of tokens
// (and high words) from its range of the slab to its offset in the
// output; a segment whose range or place would pass `cap` is skipped
// (the batch overflowed the slab and runs again).
__global__ void __launch_bounds__(THREADS)
place_kernel(int64_t nblk, const long long* __restrict__ seg_count,
             const long long* __restrict__ seg_start,
             const long long* __restrict__ offsets,
             const uint64_t* __restrict__ tok,
             const uint64_t* __restrict__ tok_hi, long long cap,
             uint64_t* __restrict__ out, uint64_t* __restrict__ out_hi) {
    const int64_t sgm = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (sgm >= nblk) return;
    const long long n = seg_count[sgm], a = seg_start[sgm],
        at = offsets[sgm];
    if (n == 0 || a + n > cap || at + n > cap) return;
    for (long long i = threadIdx.x & 31; i < n; i += 32) {
        out[at + i] = tok[a + i];
        if (tok_hi) out_hi[at + i] = tok_hi[a + i];
    }
}

// One launch (oph_rows: two with counts) of the kernel for OUT.
template <int MODE, bool CANON, int OUT>
cudaError_t launch(const Params& p, size_t smem, const uint8_t* codes,
                   const int32_t* row_item, const uint64_t* fs,
                   const Outs& o, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            oph_rows_kernel<MODE, CANON, OUT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    const unsigned blocks = (unsigned)(p.R * p.nseg);
    oph_rows_kernel<MODE, CANON, OUT><<<blocks, THREADS, smem, stream>>>(
        p, codes, row_item, fs, o, 0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || OUT != OUT_BUCKETS || o.counts == nullptr)
        return e;
    oph_rows_kernel<MODE, CANON, OUT><<<blocks, THREADS, smem, stream>>>(
        p, codes, row_item, fs, o, 1);
    return cudaGetLastError();
}

// Checks the caller's Params and sets nseg; false where nothing is to
// be done (*err = 0) or the Params are bad (*err set).
bool prepare(Params& p, int* err) {
    *err = 0;
    const int64_t lo = p.own_lo > 0 ? p.own_lo : 0;
    const int64_t hi = p.own_hi < p.npos ? p.own_hi : p.npos;
    if (p.R <= 0 || hi <= lo) return false;
    const int64_t h = p.nwin > 1 ? p.nwin - 1 : 0;
    // every rolled position needs a thread's run, every staged slot a
    // 16-bit index
    if (p.seg <= 0 || p.run <= 0 || p.run % 4
            || (int64_t)THREADS * p.run < p.seg + 2 * h
            || (staged(p) && p.seg + 2 * h >= MAX_SLOTS)
            || p.mode < MODE_DNA || p.mode > MODE_DNA128) {
        *err = (int)cudaErrorInvalidValue;
        return false;
    }
    p.nseg = (hi - lo + p.seg - 1) / p.seg;
    if (p.R * p.nseg > 0x7FFFFFFF) {
        *err = (int)cudaErrorInvalidConfiguration;
        return false;
    }
    return true;
}

template <int OUT>
cudaError_t dispatch(const Params& p, const uint8_t* codes,
                     const int32_t* row_item, const uint64_t* fs,
                     const Outs& o, cudaStream_t stream) {
    const size_t smem = (size_t)layout(p).total;
#define OPH_LAUNCH(M, C) launch<M, C, OUT>(p, smem, codes, row_item, fs, \
                                            o, stream)
    if constexpr (OUT == OUT_STREAM128)     // full keys: DNA128 only
        return p.canon ? OPH_LAUNCH(MODE_DNA128, true)
                       : OPH_LAUNCH(MODE_DNA128, false);
    switch (p.mode) {
    case MODE_DNA:
        return p.canon ? OPH_LAUNCH(MODE_DNA, true)
                       : OPH_LAUNCH(MODE_DNA, false);
    case MODE_BASEB: return OPH_LAUNCH(MODE_BASEB, false);
    case MODE_SPACED: return OPH_LAUNCH(MODE_SPACED, false);
    case MODE_ROLL:
        return p.canon ? OPH_LAUNCH(MODE_ROLL, true)
                       : OPH_LAUNCH(MODE_ROLL, false);
    default:
        return p.canon ? OPH_LAUNCH(MODE_DNA128, true)
                       : OPH_LAUNCH(MODE_DNA128, false);
    }
#undef OPH_LAUNCH
}

}  // namespace

extern "C" {

// Registers (and with `counts`, their counts) of R rows: one launch, or
// two with counts. Returns the CUDA error of the launches (0 = none).
// The caller sets `run` and `seg` (ops/oph_rows.py `geometry`); nseg is
// set here.
int oph_rows(const Params* host_params, const uint8_t* codes,
             const int32_t* row_item, const uint64_t* fs,
             unsigned long long* regs, unsigned int* counts,
             cudaStream_t stream) {
    Params p = *host_params;
    p.full_key = 0;
    if (p.m <= 0) return (int)cudaErrorInvalidValue;
    int err;
    if (!prepare(p, &err)) return err;
    const Outs o{regs, counts, nullptr, nullptr, nullptr, nullptr, nullptr,
                 0};
    return (int)dispatch<OUT_BUCKETS>(p, codes, row_item, fs, o, stream);
}

// The masked tokens of R rows' surviving positions (p.m = 0): block
// b = r * nseg + s (segment s of row r) writes seg_count[b] tokens, in
// position order, to tok[seg_start[b] ...] (and with p.full_key, DNA128
// only, tok_hi[...]), a range it reserves from *cursor (zeroed here);
// where the range would pass `cap` it writes only the count and the
// start, and *cursor ends past cap. row_item may be null (every row
// kept). One launch; returns its CUDA error (0 = none).
int hash_rows(const Params* host_params, const uint8_t* codes,
              const int32_t* row_item, const uint64_t* fs, uint64_t* tok,
              uint64_t* tok_hi, long long cap, long long* seg_count,
              long long* seg_start, unsigned long long* cursor,
              cudaStream_t stream) {
    Params p = *host_params;
    p.smem_buckets = 0;
    if (p.m != 0 || cap < 0
            || (p.full_key && (p.mode != MODE_DNA128 || tok_hi == nullptr)))
        return (int)cudaErrorInvalidValue;
    int err;
    if (!prepare(p, &err)) return err;
    cudaError_t e = cudaMemsetAsync(cursor, 0, sizeof(*cursor), stream);
    if (e != cudaSuccess) return (int)e;
    const Outs o{nullptr, nullptr, tok, p.full_key ? tok_hi : nullptr,
                 seg_count, seg_start, cursor, cap};
    return (int)(p.full_key
        ? dispatch<OUT_STREAM128>(p, codes, row_item, fs, o, stream)
        : dispatch<OUT_STREAM>(p, codes, row_item, fs, o, stream));
}

// hash_rows' placement: out[offsets[b] + i] = tok[seg_start[b] + i] for
// i < seg_count[b], each of the nblk segments (and tok_hi into out_hi
// where tok_hi is not null); offsets is the exclusive scan of
// seg_count. One launch; returns its CUDA error (0 = none).
int hash_place(long long nblk, const long long* seg_count,
               const long long* seg_start, const long long* offsets,
               const uint64_t* tok, const uint64_t* tok_hi, long long cap,
               uint64_t* out, uint64_t* out_hi, cudaStream_t stream) {
    if (nblk <= 0) return 0;
    if ((tok_hi == nullptr) != (out_hi == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long blocks = (nblk + WARPS - 1) / WARPS;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
    place_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        nblk, seg_count, seg_start, offsets, tok, tok_hi, cap, out, out_hi);
    return (int)cudaGetLastError();
}

}  // extern "C"
