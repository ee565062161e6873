// One-permutation registers of chunk rows, for sm_90a (H100).
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
//     minimum, and no position in the nwin - 1 before q (the u64 max
//     before the row) has an equal score; invalid positions score the
//     u64 max;
//   * owned positions only ([own_lo, own_hi): chunk halos), maskfn, the
//     downsample test, the filterset probe, id = wanghash(h ^ oph_xor).
//
// Design: one block of TILE threads a (row, tile of TILE owned
// positions); a thread a position. Each position's code is built from
// its span of codes read from device memory (neighbouring threads read
// neighbouring bytes; the L1 cache serves the overlap). With minimizers
// the block first scores its TILE + 2 (nwin - 1) positions and the
// minima and liveness of its TILE + nwin - 1 windows into shared memory
// (the halo is recomputed by the neighbouring tiles). The bucket-min is
// an atomicMin on the item's register; the counts are a second launch
// of the same kernel that adds 1 where a position's id equals its
// register. What bounds it: integer work, O(k) a position for its code
// plus three u64 hash chains; the bytes (the codes once, the registers
// once) are far less. This first kernel builds each code from its span
// instead of rolling it along the row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr uint8_t INVALID = 0xFF;
constexpr uint64_t U64MAX = ~0ULL;
constexpr int MAX_SYMBOLS = 32;
constexpr int MAX_OFFSETS = 256;
enum Mode { MODE_DNA = 0, MODE_BASEB = 1, MODE_SPACED = 2, MODE_ROLL = 3,
            MODE_DNA128 = 4 };

}  // namespace

// ops/oph_rows.py `Params`, field for field
struct Params {
    int64_t R, W, npos, own_lo, own_hi, m, fs_len, ntiles;
    uint64_t xormask, oph_xor, ds_threshold, ds_salt;
    uint64_t roll[MAX_SYMBOLS];
    int32_t mode, k, span, nwin, canon, seed_is_zero, downsample, base,
        bits, noff;
    int32_t offsets[MAX_OFFSETS];
};

namespace {

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

__device__ __forceinline__ uint64_t rotl(uint64_t x, int s) {
    s &= 63;
    return s ? (x << s) | (x >> (64 - s)) : x;
}

struct Kmer {
    uint64_t score;   // minimizer score (the u64 max where invalid)
    uint64_t key;     // the code maskfn scrambles
    bool valid;
};

// The code of position q of `row`; q outside [0, npos), or a window
// that holds an INVALID code, is invalid (score the u64 max, no key).
__device__ Kmer kmer_at(const Params& p, const uint8_t* __restrict__ row,
                        int64_t q) {
    Kmer out{U64MAX, 0, false};
    if (q < 0 || q >= p.npos) return out;
    const uint8_t* c = row + q;
    bool bad = false;
    for (int j = 0; j < p.span; ++j) bad |= c[j] == INVALID;
    if (bad) return out;   // no code: chunk padding, N runs
    uint64_t v = 0, key;
    switch (p.mode) {
    case MODE_DNA: {
        uint64_t rc = 0;
        for (int j = 0; j < p.k; ++j) {
            const uint64_t cv = c[j] == INVALID ? 0 : c[j];
            v = (v << 2) | cv;
            if (p.canon && 2 * j < 64) rc |= (3 - cv) << (2 * j);
        }
        if (p.canon && rc < v) v = rc;
        key = v;
        break;
    }
    case MODE_BASEB:
        for (int j = 0; j < p.k; ++j)
            v = v * (uint64_t)p.base + (c[j] == INVALID ? 0 : c[j]);
        key = v;
        break;
    case MODE_SPACED:
        for (int j = 0; j < p.noff; ++j) {
            const uint8_t b = c[p.offsets[j]];
            v = (v << p.bits) | (b == INVALID ? 0 : b);
        }
        key = v;
        break;
    case MODE_ROLL: {
        uint64_t rc = 0;
        for (int j = 0; j < p.k; ++j) {
            const bool inv = c[j] == INVALID;
            v ^= rotl(p.roll[inv ? 0 : c[j]], (p.k - 1 - j) & 63);
            if (p.canon) rc ^= rotl(p.roll[inv ? 0 : 3 - c[j]], j & 63);
        }
        if (p.canon && rc < v) v = rc;
        key = v;
        break;
    }
    default: {  // MODE_DNA128
        uint64_t fhi = 0, flo = 0, rhi = 0, rlo = 0;
        for (int j = 0; j < p.k; ++j) {
            const uint64_t cv = c[j] == INVALID ? 0 : c[j];
            fhi = (fhi << 2) | (flo >> 62);
            flo = (flo << 2) | cv;
            if (2 * j < 64) rlo |= (3 - cv) << (2 * j);
            else rhi |= (3 - cv) << (2 * j - 64);
        }
        uint64_t hi = fhi, lo = flo;
        if (p.canon && (rhi < fhi || (rhi == fhi && rlo < flo))) {
            hi = rhi;
            lo = rlo;
        }
        v = (hi >> 1) ^ lo;
        key = lo;
        break;
    }
    }
    out.valid = true;
    out.score = v;
    out.key = key;
    return out;
}

// the surviving position's id, or false where the masks drop it
__device__ __forceinline__ bool position_id(const Params& p, uint64_t key,
                                            const uint64_t* __restrict__ fs,
                                            uint64_t* id) {
    const uint64_t h = p.seed_is_zero ? key : wanghash(key ^ p.xormask);
    if (p.downsample && !(wanghash(h ^ p.ds_salt) < p.ds_threshold))
        return false;
    if (p.fs_len) {
        int64_t lo = 0, hi = p.fs_len;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (fs[mid] < h) lo = mid + 1; else hi = mid;
        }
        if (lo < p.fs_len && fs[lo] == h) return false;
    }
    *id = wanghash(h ^ p.oph_xor);
    return true;
}

template <bool COUNT>
__global__ void __launch_bounds__(TILE)
oph_rows_kernel(const __grid_constant__ Params p,
                const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ row_item,
                const uint64_t* __restrict__ fs,
                unsigned long long* __restrict__ regs,
                unsigned int* __restrict__ counts) {
    extern __shared__ unsigned char smem[];
    const int64_t r = blockIdx.x / p.ntiles;
    const int64_t t = blockIdx.x % p.ntiles;
    const int32_t item = row_item[r];
    if (item < 0) return;                       // the whole block
    const int64_t lo = p.own_lo > 0 ? p.own_lo : 0;
    const int64_t hi = p.own_hi < p.npos ? p.own_hi : p.npos;
    const int64_t p0 = lo + t * TILE;
    const int64_t p1 = p0 + TILE < hi ? p0 + TILE : hi;
    const uint8_t* row = codes + r * p.W;
    const int64_t i = p0 + threadIdx.x;
    uint64_t key;
    if (p.nwin <= 1) {
        if (i >= p1) return;
        const Kmer km = kmer_at(p, row, i);
        if (!km.valid) return;
        key = km.key;
    } else {
        const int h = p.nwin - 1;
        const int E = TILE + 2 * h, NW = TILE + h;
        uint64_t* sc = reinterpret_cast<uint64_t*>(smem);   // E scores
        uint64_t* wm = sc + E;                              // NW minima
        uint8_t* va = reinterpret_cast<uint8_t*>(wm + NW);  // E valid
        uint8_t* wl = va + E;                               // NW live
        const int64_t q0 = p0 - h;      // first scored position
        const int ne = (int)(p1 - p0) + 2 * h;
        for (int e = threadIdx.x; e < ne; e += TILE) {
            const Kmer km = kmer_at(p, row, q0 + e);
            sc[e] = km.score;
            va[e] = km.valid;
        }
        __syncthreads();
        const int64_t nw = p.npos - p.nwin + 1;
        const int nwt = (int)(p1 - p0) + h;
        for (int e = threadIdx.x; e < nwt; e += TILE) {
            const int64_t j = q0 + e;   // window j covers [j, j + h]
            uint64_t mn = U64MAX;
            bool live = j >= 0 && j < nw;
            for (int d = 0; d <= h; ++d) {
                const uint64_t s = sc[e + d];
                mn = s < mn ? s : mn;
                live = live && va[e + d];
            }
            wm[e] = mn;
            wl[e] = live;
        }
        __syncthreads();
        if (i >= p1) return;
        const int e = threadIdx.x + h;
        if (!va[e]) return;
        const uint64_t s = sc[e];
        for (int d = 1; d <= h; ++d)
            if (sc[e - d] == s) return;
        bool hit = false;
        for (int d = 0; d <= h; ++d)    // windows i - h .. i
            hit = hit || (wl[threadIdx.x + d] && wm[threadIdx.x + d] == s);
        if (!hit) return;
        key = kmer_at(p, row, i).key;
    }
    uint64_t id;
    if (!position_id(p, key, fs, &id)) return;
    const uint64_t b = (p.m & (p.m - 1)) == 0 ? id & (uint64_t)(p.m - 1)
                                              : id % (uint64_t)p.m;
    const int64_t at = (int64_t)item * p.m + (int64_t)b;
    if (!COUNT)
        atomicMin(regs + at, (unsigned long long)id);
    else if (regs[at] == id)
        atomicAdd(counts + at, 1u);
}

}  // namespace

extern "C" {

// Registers (and with `counts`, their counts) of R rows: one launch, or
// two with counts. Returns the CUDA error of the launches (0 = none).
int oph_rows(const Params* host_params, const uint8_t* codes,
             const int32_t* row_item, const uint64_t* fs,
             unsigned long long* regs, unsigned int* counts,
             cudaStream_t stream) {
    Params p = *host_params;
    const int64_t lo = p.own_lo > 0 ? p.own_lo : 0;
    const int64_t hi = p.own_hi < p.npos ? p.own_hi : p.npos;
    if (p.R <= 0 || hi <= lo) return 0;
    p.ntiles = (hi - lo + TILE - 1) / TILE;
    const int64_t blocks = p.R * p.ntiles;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
    size_t smem = 0;
    if (p.nwin > 1) {
        const int h = p.nwin - 1;
        smem = 9 * (size_t)(TILE + 2 * h) + 9 * (size_t)(TILE + h);
    }
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            oph_rows_kernel<false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                oph_rows_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    oph_rows_kernel<false><<<(unsigned)blocks, TILE, smem, stream>>>(
        p, codes, row_item, fs, regs, counts);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || counts == nullptr) return (int)e;
    oph_rows_kernel<true><<<(unsigned)blocks, TILE, smem, stream>>>(
        p, codes, row_item, fs, regs, counts);
    return (int)cudaGetLastError();
}

}  // extern "C"
