// The CountSketch of `-c` (--countsketch-size) in the weighted spaces,
// for a batch of hash streams: in each stream, bucket h mod cssize gains
// +1 where the hash h is odd and -1 where it is even (counter.h); the
// result is, for each stream, its non-zero buckets in ascending order
// with their |sum|, and their number.
//
// Replaces the JAX package's device CountSketch, which is XLA and not a
// Pallas kernel: dashing2_tpu/ops/sketch_kernels.py `_countsketch_device`
// (one sort of the bucket ids with the signs as payload and an int32
// cumsum, whose run ends the host reads back in `countsketch_counts`).
// ops/countsketch.py holds the plain PyTorch version (the same sort and
// run sums) and the wrapper.
//
// Work follows the stream, not the bucket array: no cssize-sized array
// exists, so work and memory are O(n + K) a stream (n hashes, K non-zero
// buckets) for any cssize in [1, 2^31). The plan, a fixed sequence of
// launches for the whole batch:
//
// 1. plan (one block): each stream's shift, from its length n and cssize
//    (`stream_shift`); its bins are the ranges [b << shift, (b + 1) <<
//    shift) of buckets, about BIN_TARGET entries each (DENSE_TARGET where
//    n >= cssize / DENSE_RATIO, so that the dense form below takes few,
//    full bins), a scan of the bins' numbers gives each stream's first
//    bin, and each bin is marked with its stream.
// 2. count (a block a tile of TILE hashes): each hash's stream (a binary
//    search of the offsets once a thread, then a walk), bucket (a u64
//    modulo by a precomputed reciprocal, `mod_c`) and bin; the tile counts
//    its bins in shared memory and adds them to global memory, one atomic
//    a (tile, bin).
// 3. scan (one block): the bins' counts to their starts.
// 4. scatter (the tiles again): each entry, packed as (bucket - bin base)
//    << 1 | (h & 1) in a u32, into its bin; the tile reserves each of its
//    bins' ranges with one global atomic, stages its entries in bin order
//    in shared memory and writes each bin's run of them with
//    neighbouring threads on neighbouring addresses.
// 5. bins (a block a bin, in turn): where the bin's range of R buckets
//    holds many entries (R <= DENSE_MAX and R <= DENSE_RATIO entries), a
//    dense int32 histogram in shared memory (one shared atomic an entry,
//    so a repeated k-mer costs one each), compacted in order by ballots;
//    otherwise a hash table in shared memory (linear probing, keys
//    claimed by compare-and-swap), whose non-zero slots are packed as
//    (offset << 32 | |sum|) and sorted: by a counting sort on equal parts
//    of the range and an insertion sort of each part's few keys, or,
//    where keys bunch in a part, by a bitonic sort. A table that
//    fills past TABLE_FILL keys (only a bin whose range holds more
//    distinct buckets than that) splits its range in halves and does
//    each in turn, so any bin is exact, whatever its repeats. A bin
//    writes its non-zero buckets, ascending, at its own start.
// 6. scan (one block): the bins' non-zero counts to output positions,
//    and each stream's count.
// 7. place (a warp a bin): each bin's buckets to their output position.
//
// Integer sums are exact in any order: the histograms' and tables' int32
// sums hold streams below 2^31 hashes.
//
// Bound on the card: bytes. The function reads 8 bytes a hash and 8 a
// stream offset and writes 8 a non-zero bucket (id and |sum|); its least
// work a hash is a modulo, a sign and an add (chip_smoke.py CS_OPS). The
// plan reads the hashes twice (count and scatter) and writes and reads
// the entries (4 bytes a hash) and the bins' outputs (8 bytes a non-zero
// bucket, written twice and read once): about 24 bytes a hash and 24 a
// non-zero bucket against the bound's 8 and 8, so at long streams it can
// reach about a third of the bound, where a single pass over the hashes
// (a per-tile sort and a gather by bin) would be the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 512;             // threads a block (tiles and bins)
constexpr int ITEMS = 16;            // hashes a thread in a tile
constexpr int TILE = TPB * ITEMS;    // hashes a tile
constexpr int SMEM_BINS = 4096;      // bins a tile counts in shared memory
constexpr int BIN_TARGET = 1024;     // entries a bin, sparse streams
constexpr int DENSE_TARGET = 8192;   // entries a bin, dense streams
constexpr int DENSE_SHIFT = 14;      // the dense form's largest range ...
constexpr int DENSE_MAX = 1 << DENSE_SHIFT;   // ... 16384 int32 (64 KB)
constexpr int DENSE_RATIO = 16;      // dense where range <= 16 entries
constexpr int TABLE = 8192;          // slots of the sparse form's table
constexpr int TABLE_FILL = 4096;     // keys before a range splits
constexpr int SUB_MAX = 32;          // keys of a part of the counting sort
constexpr int SCAN_TPB = 1024;       // threads of the one-block scans
constexpr int SCAN_ITEMS = 8;        // elements a thread a scan round
// dynamic shared memory of a bin block: the dense histogram, or the
// table's keys and sums (64 KB) and its packed non-zero slots (32 KB)
constexpr int BIN_SMEM = TABLE * 8 + TABLE_FILL * 8;
// dynamic shared memory of a tile: its bins' counts, and for the
// scatter their offsets to global positions and the tile's entries
// staged in bin order (u32 entries, u16 bins)
constexpr int COUNT_SMEM = SMEM_BINS * 4;
constexpr int SCATTER_SMEM = SMEM_BINS * 8 + TILE * 6;
constexpr unsigned EMPTY = 0xFFFFFFFFu;

static_assert(DENSE_MAX * 4 <= BIN_SMEM, "dense histogram");
static_assert(TABLE_FILL * 12 <= TABLE * 8 && TABLE_FILL <= 8 * TPB,
              "counting sort");
static_assert(SMEM_BINS <= 8 * TPB && SMEM_BINS <= 65536, "tile bins");

// x mod c for c in [1, 2^31), m = floor((2^64 - 1) / c): the quotient
// estimate umulhi(x, m) is floor(x / c) less at most 2, so the remainder
// estimate lies in [0, 3c) and two conditional subtractions end it.
__device__ __forceinline__ uint64_t mod_c(uint64_t x, uint64_t c,
                                          uint64_t m) {
    const uint64_t q = __umul64hi(x, m);
    uint64_t r = x - q * c;
    if (r >= c) r -= c;
    if (r >= c) r -= c;
    return r;
}

// The stream's shift and number of bins (0 for an empty stream): the
// least shift whose bins number at most max(1, n / target), the dense
// streams' capped at DENSE_SHIFT.
__device__ __forceinline__ int stream_shift(long long n, uint64_t c,
                                            int* nbins) {
    if (n <= 0) {
        *nbins = 0;
        return 0;
    }
    const bool dense = (uint64_t)n * DENSE_RATIO >= c;
    long long t = n / (dense ? DENSE_TARGET : BIN_TARGET);
    if (t < 1) t = 1;
    int s = 0;
    while (((c + (1ull << s) - 1) >> s) > (uint64_t)t) ++s;
    if (dense && s > DENSE_SHIFT) s = DENSE_SHIFT;
    *nbins = (int)((c + (1ull << s) - 1) >> s);
    return s;
}

// The last index s in [0, S) with off[s] <= i, for off[0] <= i < off[S]:
// the stream of position i (empty streams skipped).
__device__ __forceinline__ int last_le(const long long* off, int S,
                                       long long i) {
    int lo = 0, hi = S;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= i) lo = mid; else hi = mid;
    }
    return lo;
}

// Exclusive scan of one int a thread over a block of NT threads; `total`
// gets the block's sum. `warp_sums` holds NT / 32 ints of shared memory.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < NT / 32 ? warp_sums[lane] : 0;
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += y;
        }
        if (lane < NT / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = (warp ? warp_sums[warp - 1] : 0) + x - v;
    *total = warp_sums[NT / 32 - 1];
    __syncthreads();
    return before;
}

// out[0..len] = exclusive scan of in[0..len), with out[len] the sum, in
// one block of SCAN_TPB threads; in == out is allowed.
__device__ void scan_into(const int* in, int* out, int len) {
    __shared__ int warp_sums[SCAN_TPB / 32];
    int carry = 0;
    for (int base = 0; base < len; base += SCAN_TPB * SCAN_ITEMS) {
        const int i0 = base + threadIdx.x * SCAN_ITEMS;
        int v[SCAN_ITEMS], sum = 0;
#pragma unroll
        for (int j = 0; j < SCAN_ITEMS; ++j) {
            v[j] = i0 + j < len ? in[i0 + j] : 0;
            sum += v[j];
        }
        int total;
        int run = carry + block_exclusive_scan<SCAN_TPB>(sum, warp_sums,
                                                         &total);
#pragma unroll
        for (int j = 0; j < SCAN_ITEMS; ++j) {
            if (i0 + j < len) out[i0 + j] = run;
            run += v[j];
        }
        carry += total;
    }
    if (threadIdx.x == 0) out[len] = carry;
}

// 1. each stream's shift and first bin (binbase[S] = the bins in all),
// and each bin's stream
__global__ void __launch_bounds__(SCAN_TPB)
cs_plan(const long long* __restrict__ off, int S, uint64_t c,
        int* __restrict__ shift, int* __restrict__ binbase,
        int* __restrict__ bin_stream) {
    __shared__ int warp_sums[SCAN_TPB / 32];
    int carry = 0;
    for (int base = 0; base < S; base += SCAN_TPB * SCAN_ITEMS) {
        const int s0 = base + threadIdx.x * SCAN_ITEMS;
        int nb[SCAN_ITEMS], sum = 0;
#pragma unroll
        for (int j = 0; j < SCAN_ITEMS; ++j) {
            nb[j] = 0;
            if (s0 + j < S) {
                shift[s0 + j] = stream_shift(off[s0 + j + 1] - off[s0 + j],
                                             c, &nb[j]);
            }
            sum += nb[j];
        }
        int total;
        int run = carry + block_exclusive_scan<SCAN_TPB>(sum, warp_sums,
                                                         &total);
#pragma unroll
        for (int j = 0; j < SCAN_ITEMS; ++j) {
            if (s0 + j < S) binbase[s0 + j] = run;
            run += nb[j];
        }
        carry += total;
    }
    if (threadIdx.x == 0) binbase[S] = carry;
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += SCAN_TPB) {
        for (int b = binbase[s]; b < binbase[s + 1]; ++b) bin_stream[b] = s;
    }
}

// 2. and 4. a tile of TILE hashes: with SCATTER false, the bins' counts
// (added to `bins`); with SCATTER true, the entries placed from the bins'
// cursors (`bins`, the starts on entry). Where the tile's bins fit in
// shared memory, the scatter stages the tile's entries in bin order
// there and writes each bin's run of them with neighbouring threads on
// neighbouring addresses; otherwise each entry takes a global atomic.
template <bool SCATTER>
__global__ void __launch_bounds__(TPB)
cs_tiles(const uint64_t* __restrict__ h, long long n,
         const long long* __restrict__ off, int S, uint64_t c, uint64_t m,
         const int* __restrict__ shift, const int* __restrict__ binbase,
         int* __restrict__ bins, unsigned* __restrict__ entries) {
    extern __shared__ __align__(16) char tsmem[];
    int* cnt = (int*)tsmem;
    __shared__ int s_lo, s_span;
    __shared__ int warp_sums[TPB / 32];
    const long long tile0 = (long long)blockIdx.x * TILE;
    const long long tile_end = tile0 + TILE < n ? tile0 + TILE : n;
    if (threadIdx.x == 0) {
        const int sf = last_le(off, S, tile0);
        const int sl = last_le(off, S, tile_end - 1);
        s_lo = binbase[sf];
        s_span = binbase[sl + 1] - binbase[sf];
    }
    __syncthreads();
    const int lo = s_lo, span = s_span;
    const bool smem = span <= SMEM_BINS;
    if (smem) {
        for (int k = threadIdx.x; k < span; k += TPB) cnt[k] = 0;
        __syncthreads();
    }
    int gbin[ITEMS];
    unsigned packed[ITEMS];
    long long i = tile0 + threadIdx.x;
    int s = i < tile_end ? last_le(off, S, i) : 0;
    long long next = off[s + 1];
    int sh = shift[s], bb = binbase[s];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j, i += TPB) {
        gbin[j] = -1;
        if (i >= tile_end) continue;
        if (i >= next) {
            do {
                ++s;
                next = off[s + 1];
            } while (i >= next);
            sh = shift[s];
            bb = binbase[s];
        }
        const uint64_t x = h[i];
        const unsigned b = (unsigned)mod_c(x, c, m);
        const unsigned local = b >> sh;
        gbin[j] = bb + (int)local;
        packed[j] = ((b - (local << sh)) << 1) | (unsigned)(x & 1);
        if (smem) {
            atomicAdd(&cnt[gbin[j] - lo], 1);
        } else if (!SCATTER) {
            atomicAdd(&bins[gbin[j]], 1);
        }
    }
    if (!SCATTER) {
        if (smem) {
            __syncthreads();
            for (int k = threadIdx.x; k < span; k += TPB) {
                if (cnt[k]) atomicAdd(&bins[lo + k], cnt[k]);
            }
        }
        return;
    }
    if (!smem) {
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            if (gbin[j] >= 0) entries[atomicAdd(&bins[gbin[j]], 1)] =
                packed[j];
        }
        return;
    }
    int* delta = cnt + SMEM_BINS;
    unsigned* stage = (unsigned*)(delta + SMEM_BINS);
    unsigned short* sbin = (unsigned short*)(stage + TILE);
    __syncthreads();
    // the bins' local starts (a scan of a few bins a thread), their global
    // ranges reserved, and delta = global start - local start
    const int per = (span + TPB - 1) / TPB, k0 = threadIdx.x * per;
    int v[SMEM_BINS / TPB], sum = 0;
#pragma unroll
    for (int j = 0; j < SMEM_BINS / TPB; ++j) {
        v[j] = j < per && k0 + j < span ? cnt[k0 + j] : 0;
        sum += v[j];
    }
    int total;
    int run = block_exclusive_scan<TPB>(sum, warp_sums, &total);
#pragma unroll
    for (int j = 0; j < SMEM_BINS / TPB; ++j) {
        if (j < per && k0 + j < span) {
            const int g = v[j] ? atomicAdd(&bins[lo + k0 + j], v[j]) : 0;
            delta[k0 + j] = g - run;
            cnt[k0 + j] = run;
            run += v[j];
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        if (gbin[j] < 0) continue;
        const int p = atomicAdd(&cnt[gbin[j] - lo], 1);
        stage[p] = packed[j];
        sbin[p] = (unsigned short)(gbin[j] - lo);
    }
    __syncthreads();
    const int tn = (int)(tile_end - tile0);
    for (int p = threadIdx.x; p < tn; p += TPB)
        entries[p + delta[sbin[p]]] = stage[p];
}

// 3. and 6. one-block scans; the second also writes each stream's count
__global__ void __launch_bounds__(SCAN_TPB)
cs_scan_bins(const int* __restrict__ binbase, int S,
             const int* __restrict__ counts, int* __restrict__ starts,
             int* __restrict__ cursor) {
    const int nb = binbase[S];
    scan_into(counts, starts, nb);
    __syncthreads();
    for (int k = threadIdx.x; k < nb; k += SCAN_TPB) cursor[k] = starts[k];
}

__global__ void __launch_bounds__(SCAN_TPB)
cs_scan_out(const int* __restrict__ binbase, int S,
            const int* __restrict__ nnz, int* __restrict__ outpos,
            long long* __restrict__ stream_counts) {
    const int nb = binbase[S];
    scan_into(nnz, outpos, nb);
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += SCAN_TPB) {
        stream_counts[s] = outpos[binbase[s + 1]] - outpos[binbase[s]];
    }
}

// The non-zero counters of hist[0, R), in order, as (base + k, |v|) at
// out[0..): every warp a segment, ballots for the positions. Returns the
// number written (to every thread).
__device__ int compact_dense(const int* hist, int R, unsigned base,
                             int2* __restrict__ out, int* wsum) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int WARPS = TPB / 32;
    const int seg = ((R + WARPS * 32 - 1) / (WARPS * 32)) * 32;
    const int k0 = warp * seg, k1 = k0 + seg < R ? k0 + seg : R;
    int count = 0;
    for (int k = k0; k < k0 + seg; k += 32) {
        const bool nz = k + lane < k1 && hist[k + lane] != 0;
        count += __popc(__ballot_sync(0xFFFFFFFFu, nz));
    }
    if (lane == 0) wsum[warp] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
        int run = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int v = wsum[w];
            wsum[w] = run;
            run += v;
        }
        wsum[WARPS] = run;
    }
    __syncthreads();
    int pos = wsum[warp];
    for (int k = k0; k < k0 + seg; k += 32) {
        const int v = k + lane < k1 ? hist[k + lane] : 0;
        const unsigned ball = __ballot_sync(0xFFFFFFFFu, v != 0);
        if (v != 0) {
            out[pos + __popc(ball & ((1u << lane) - 1))] =
                make_int2((int)(base + k + lane), v < 0 ? -v : v);
        }
        pos += __popc(ball);
    }
    const int total = wsum[WARPS];
    __syncthreads();
    return total;
}

// One range [lo, hi) of a sparse bin's offsets through the hash table:
// returns -1 when the table filled (the range must split), else the
// number of non-zero buckets written, ascending, at out[0..).
__device__ int sparse_range(const unsigned* __restrict__ ent, int E,
                            unsigned lo, unsigned hi, unsigned base,
                            char* smem, int2* __restrict__ out,
                            int* s_used, int* s_over, int* s_d, int* wsum) {
    unsigned* keys = (unsigned*)smem;
    int* sums = (int*)(smem + TABLE * 4);
    unsigned long long* packed = (unsigned long long*)(smem + TABLE * 8);
    // the table: a power of two of at least 2E slots, at most TABLE
    int lg = 6;
    while ((1LL << lg) < 2LL * E && (1 << lg) < TABLE) ++lg;
    const int ts = 1 << lg;
    for (int k = threadIdx.x; k < ts; k += TPB) {
        keys[k] = EMPTY;
        sums[k] = 0;
    }
    if (threadIdx.x == 0) {
        *s_used = 0;
        *s_over = 0;
        *s_d = 0;
    }
    __syncthreads();
    volatile unsigned* vkeys = keys;
    volatile int* vover = s_over;
    int claimed = 0;   // keys this thread put in the table
    for (int k = threadIdx.x; k < E; k += TPB) {
        if (*vover) break;
        const unsigned e = ent[k], o = e >> 1;
        if (o < lo || o >= hi) continue;
        const int sg = (e & 1) ? 1 : -1;
        unsigned slot = (o * 0x9E3779B1u) >> (32 - lg);
        bool done = false;
        for (int p = 0; p < ts && !done; ++p) {
            const unsigned kk = vkeys[slot];
            if (kk == o) {
                atomicAdd(&sums[slot], sg);
                done = true;
            } else if (kk == EMPTY) {
                const unsigned prev = atomicCAS(&keys[slot], EMPTY, o);
                if (prev == EMPTY || prev == o) {
                    claimed += prev == EMPTY;
                    atomicAdd(&sums[slot], sg);
                    done = true;
                }
            }
            slot = (slot + 1) & (ts - 1);
        }
        if (!done) *vover = 1;   // no free slot: more keys than slots
    }
    // the range's distinct keys, a warp's at a time
    for (int d = 16; d > 0; d >>= 1)
        claimed += __shfl_down_sync(0xFFFFFFFFu, claimed, d);
    if ((threadIdx.x & 31) == 0 && claimed) atomicAdd(s_used, claimed);
    __syncthreads();
    if (*s_over || *s_used > TABLE_FILL) {
        __syncthreads();
        return -1;
    }
    // the non-zero slots, packed (offset << 32 | |sum|): at most
    // TABLE_FILL keys, placed a warp at a time
    const int lane = threadIdx.x & 31;
    for (int k0 = 0; k0 < ts; k0 += TPB) {
        const int k = k0 + threadIdx.x;
        const unsigned kk = k < ts ? keys[k] : EMPTY;
        const int v = k < ts ? sums[k] : 0;
        const bool nz = kk != EMPTY && v != 0;
        const unsigned ball = __ballot_sync(0xFFFFFFFFu, nz);
        int at = 0;
        if (lane == 0 && ball) at = atomicAdd(s_d, __popc(ball));
        at = __shfl_sync(0xFFFFFFFFu, at, 0);
        if (nz) {
            packed[at + __popc(ball & ((1u << lane) - 1))] =
                ((unsigned long long)kk << 32) | (unsigned)(v < 0 ? -v : v);
        }
    }
    __syncthreads();
    const int d = *s_d;
    // the order: a counting sort of the keys by sub-range (nsub equal
    // parts of [lo, hi), about one key each), then each part's few keys
    // by insertion; where a part holds more than SUB_MAX keys (keys
    // bunched in a corner of the range), a bitonic sort instead
    int nsub = 32;
    while (nsub < d) nsub <<= 1;
    int* sub = (int*)smem;
    unsigned long long* sorted =
        (unsigned long long*)(smem + TABLE_FILL * 4);
    const unsigned long long width = hi - lo;
    for (int k = threadIdx.x; k < nsub; k += TPB) sub[k] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < d; i += TPB) {
        const unsigned key = (unsigned)(packed[i] >> 32);
        const int b = (int)((unsigned long long)(key - lo) * nsub / width);
        if (atomicAdd(&sub[b], 1) >= SUB_MAX) *vover = 1;
    }
    __syncthreads();
    const unsigned long long* src = sorted;
    if (!*s_over) {
        const int per = (nsub + TPB - 1) / TPB, k0 = threadIdx.x * per;
        int v[TABLE_FILL / TPB], sum = 0;
#pragma unroll
        for (int j = 0; j < TABLE_FILL / TPB; ++j) {
            v[j] = j < per && k0 + j < nsub ? sub[k0 + j] : 0;
            sum += v[j];
        }
        int total;
        int run = block_exclusive_scan<TPB>(sum, wsum, &total);
#pragma unroll
        for (int j = 0; j < TABLE_FILL / TPB; ++j) {
            if (j < per && k0 + j < nsub) {
                sub[k0 + j] = run;
                run += v[j];
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < d; i += TPB) {
            const unsigned long long x = packed[i];
            const int b = (int)((unsigned long long)((unsigned)(x >> 32) - lo)
                                * nsub / width);
            sorted[atomicAdd(&sub[b], 1)] = x;
        }
        __syncthreads();
        // sub[b] is now part b's end, sub[b - 1] its start
        for (int b = threadIdx.x; b < nsub; b += TPB) {
            const int s0 = b ? sub[b - 1] : 0, e = sub[b];
            for (int i = s0 + 1; i < e; ++i) {
                const unsigned long long x = sorted[i];
                int j = i - 1;
                while (j >= s0 && sorted[j] > x) {
                    sorted[j + 1] = sorted[j];
                    --j;
                }
                sorted[j + 1] = x;
            }
        }
        __syncthreads();
    } else {
        src = packed;
        int P = 1;
        while (P < d) P <<= 1;
        for (int k = d + threadIdx.x; k < P; k += TPB) packed[k] = ~0ull;
        __syncthreads();
        for (int k = 2; k <= P; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
                for (int i = threadIdx.x; i < P; i += TPB) {
                    const int ixj = i ^ j;
                    if (ixj > i) {
                        const unsigned long long a = packed[i],
                                                 b = packed[ixj];
                        if ((a > b) == ((i & k) == 0)) {
                            packed[i] = b;
                            packed[ixj] = a;
                        }
                    }
                }
                __syncthreads();
            }
        }
    }
    for (int k = threadIdx.x; k < d; k += TPB) {
        const unsigned long long v = src[k];
        out[k] = make_int2((int)(base + (unsigned)(v >> 32)),
                           (int)(unsigned)(v & 0xFFFFFFFFu));
    }
    __syncthreads();
    return d;
}

// 5. a block a bin, in turn
__global__ void __launch_bounds__(TPB)
cs_bins(const unsigned* __restrict__ entries, const int* __restrict__ starts,
        const int* __restrict__ binbase, const int* __restrict__ shift,
        const int* __restrict__ bin_stream, int S, uint64_t c,
        int2* __restrict__ tmp, int* __restrict__ nnz) {
    extern __shared__ __align__(16) char smem[];
    __shared__ int s_info[4];
    __shared__ int wsum[TPB / 32 + 1];
    __shared__ int s_used, s_over, s_d;
    __shared__ unsigned stack_lo[32], stack_hi[32];
    const int nb = binbase[S];
    for (int bin = blockIdx.x; bin < nb; bin += gridDim.x) {
        if (threadIdx.x == 0) {
            const int s = bin_stream[bin];
            s_info[0] = s;
            s_info[1] = starts[bin];
            s_info[2] = starts[bin + 1] - starts[bin];
        }
        __syncthreads();
        const int s = s_info[0], st = s_info[1], E = s_info[2];
        const int sh = shift[s];
        const unsigned base = (unsigned)(bin - binbase[s]) << sh;
        const unsigned long long rest = c - base;
        const unsigned R = (unsigned)((1ull << sh) < rest ? (1ull << sh)
                                                          : rest);
        const unsigned* ent = entries + st;
        int2* out = tmp + st;
        int written = 0;
        if (E > 0 && R <= DENSE_MAX
            && R <= (unsigned long long)E * DENSE_RATIO) {
            int* hist = (int*)smem;
            for (unsigned k = threadIdx.x; k < R; k += TPB) hist[k] = 0;
            __syncthreads();
            for (int k = threadIdx.x; k < E; k += TPB) {
                const unsigned e = ent[k];
                atomicAdd(&hist[e >> 1], (e & 1) ? 1 : -1);
            }
            __syncthreads();
            written = compact_dense(hist, (int)R, base, out, wsum);
        } else if (E > 0) {
            // ranges in ascending order: the current one, then the stack
            unsigned lo = 0, hi = R;
            int depth = 0;
            for (;;) {
                const int d = sparse_range(ent, E, lo, hi, base, smem,
                                           out + written, &s_used, &s_over,
                                           &s_d, wsum);
                if (d < 0) {
                    const unsigned mid = lo + (hi - lo) / 2;
                    if (threadIdx.x == 0) {
                        stack_lo[depth] = mid;
                        stack_hi[depth] = hi;
                    }
                    ++depth;
                    hi = mid;
                    continue;
                }
                written += d;
                if (depth == 0) break;
                --depth;
                __syncthreads();
                lo = stack_lo[depth];
                hi = stack_hi[depth];
            }
        }
        if (threadIdx.x == 0) nnz[bin] = written;
        __syncthreads();
    }
}

// 7. a warp a bin, in turn
__global__ void __launch_bounds__(TPB)
cs_place(const int* __restrict__ binbase, int S,
         const int* __restrict__ starts, const int* __restrict__ nnz,
         const int* __restrict__ outpos, const int2* __restrict__ tmp,
         int2* __restrict__ out) {
    const int nb = binbase[S];
    const int lane = threadIdx.x & 31;
    const int warps = gridDim.x * (TPB / 32);
    for (int bin = blockIdx.x * (TPB / 32) + (threadIdx.x >> 5); bin < nb;
         bin += warps) {
        const int k = nnz[bin];
        const int2* src = tmp + starts[bin];
        int2* dst = out + outpos[bin];
        for (int i = lane; i < k; i += 32) dst[i] = src[i];
    }
}

// int32 scratch of a batch of n hashes in S streams: the bins' outputs
// (2n, first, for their 8-byte alignment) and the entries (n), then
// shift and binbase (S and S + 1), then over the bins (at most S + n /
// 1024 + 1 of them: a stream of n hashes has at most max(1, ceil(n /
// 1024)) bins) their streams, counts, starts, cursors, non-zero counts
// and output positions.
long long max_bins(long long n, int S) { return S + n / 1024 + 2; }

}  // namespace

extern "C" long long countsketch_scratch_ints(long long n, int S) {
    return 3 * n + 2LL * S + 1 + 6 * (max_bins(n, S) + 1);
}

// h (n,) u64 of S streams, off (S + 1,) int64 on the card (off[0] = 0,
// non-decreasing, off[S] = n < 2^31); c in [1, 2^31), m = floor((2^64 -
// 1) / c); scratch of countsketch_scratch_ints(n, S) int32; out (n, 2)
// int32: the streams' non-zero buckets (id, |sum|), ascending in each
// stream, stream after stream, in its first sum(counts) rows; counts (S,)
// int64. Returns the first CUDA error of the launches (0 on success).
extern "C" int countsketch_batch(const void* h, long long n, const void* off,
                                 int S, unsigned long long c,
                                 unsigned long long m, void* scratch,
                                 void* out, void* counts, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long b = max_bins(n, S);
    int2* tmp = (int2*)scratch;
    unsigned* entries = (unsigned*)(tmp + n);
    int* shift = (int*)(entries + n);
    int* binbase = shift + S;
    int* bcount = binbase + S + 1;
    int* starts = bcount + (b + 1);
    int* cursor = starts + (b + 1);
    int* nnz = cursor + (b + 1);
    int* outpos = nnz + (b + 1);
    int* bin_stream = outpos + (b + 1);
    const long long* o = (const long long*)off;
    static int grid_bins = 0;
    if (grid_bins == 0) {
        cudaError_t e = cudaFuncSetAttribute(
            cs_bins, cudaFuncAttributeMaxDynamicSharedMemorySize, BIN_SMEM);
        if (e == cudaSuccess) {
            e = cudaFuncSetAttribute(
                cs_tiles<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                SCATTER_SMEM);
        }
        if (e != cudaSuccess) return (int)e;
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cs_bins, TPB,
                                                      BIN_SMEM);
        grid_bins = sms * (per_sm > 0 ? per_sm : 1);
    }
    cudaError_t e = cudaMemsetAsync(bcount, 0, sizeof(int) * b, st);
    if (e != cudaSuccess) return (int)e;
    cs_plan<<<1, SCAN_TPB, 0, st>>>(o, S, c, shift, binbase, bin_stream);
    const long long tiles = (n + TILE - 1) / TILE;
    if (tiles > 0) {
        cs_tiles<false><<<(unsigned)tiles, TPB, COUNT_SMEM, st>>>(
            (const uint64_t*)h, n, o, S, c, m, shift, binbase, bcount,
            entries);
    }
    cs_scan_bins<<<1, SCAN_TPB, 0, st>>>(binbase, S, bcount, starts, cursor);
    if (tiles > 0) {
        cs_tiles<true><<<(unsigned)tiles, TPB, SCATTER_SMEM, st>>>(
            (const uint64_t*)h, n, o, S, c, m, shift, binbase, cursor,
            entries);
    }
    cs_bins<<<grid_bins, TPB, BIN_SMEM, st>>>(entries, starts, binbase, shift,
                                              bin_stream, S, c, tmp, nnz);
    cs_scan_out<<<1, SCAN_TPB, 0, st>>>(binbase, S, nnz, outpos,
                                        (long long*)counts);
    cs_place<<<grid_bins, TPB, 0, st>>>(binbase, S, starts, nnz, outpos, tmp,
                                        (int2*)out);
    return (int)cudaGetLastError();
}
