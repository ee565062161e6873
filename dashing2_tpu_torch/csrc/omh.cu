// OrderMinHash registers: each sequence's k-mer stream reduced to m
// registers, each the wanghash fold of the ell k-mers it selects, taken
// in sequence order.
//
// Replaces the JAX package's OrderMinHash engine, which is XLA and not a
// Pallas kernel: dashing2_tpu/sketch/omh.py `_omh_registers` (a jitted
// scan over chunks of 8192 positions: the (m, chunk) keys, `lax.top_k`
// over their f64 values, a carry ahead of each chunk, then a stable
// argsort of the winners by position and the fold) and its vmapped batch
// `_omh_registers_batch`. ops/omh.py holds the plain PyTorch version of
// the same rule and says what a register is.
//
// Rule: register r of a sequence keeps the ell valid positions of least
// (f64(key), position), key = wanghash(kmer ^ occ * G1 ^ (r * G2 + SALT)),
// among those whose key rounds to an f64 below 2^64 (__ull2double_rn
// rounds to nearest, ties to even, as the JAX engine's u64 -> f64 cast
// does); an unfilled slot is a phantom. The winners go in position order
// (a phantom after a real winner at position 0 and before every later
// one) and fold into the register. The rounded key's f64 bits, an
// unsigned integer, order as its value.
//
// Schedule: two kernels in one call. `omh_select`: one block per (piece
// of at most PIECE positions of a sequence, tile of TPB registers), one
// thread per register. The block stages the keyed words kmer ^ occ * G1
// and the valid flags of CH positions at a time in shared memory, once
// for all its registers; each thread hashes its register's key for every
// staged position and keeps its ell best (rounded key, position) in
// registers, sorted. A key above the exact key of the thread's worst kept
// winner cannot round below that winner's rounded key (rounding is
// monotone), so only a key at or below it is rounded; the positions come
// in order, so a strict compare leaves an equal rounded key to the
// earlier position. The piece's ell best go to scratch. `omh_fold`: one
// block per (sequence, register tile) merges the sequence's pieces in
// order by the same strict compare (an earlier piece's winner keeps an
// equal key), sorts the winners by position and folds them. A long
// sequence is cut into pieces so that a few long sequences still fill the
// card's 132 SMs.
//
// Only ell = 2 is built, the depth every path uses; the entry rejects any
// other.
//
// Bound on the card: operations. Each valid (position, register) is one
// keyed u64 wanghash chain and a u64 compare; the stream is read once per
// register tile (17 bytes a position), the registers written once.
// experiments/omh_sass_ops.py counts the chain's instructions by pipe in
// this kernel's SASS, and chip_smoke.py charges them for bound_ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;               // registers (threads) per block
constexpr int CH = 1024;               // positions staged per step
constexpr int ELL = 2;                 // winners a register keeps

constexpr uint64_t G1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t G2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t SALT = 0x165667B19E3779F9ull;
constexpr uint64_t INVALID_CODE = 0x5851F42D4C957F2Dull;
constexpr uint64_t F_EMPTY = 0x43F0000000000000ull;   // f64 2^64

__device__ __forceinline__ uint64_t wanghash(uint64_t x) {
    x = (~x) + (x << 21);
    x = x ^ (x >> 24);
    x = x * 265ull;
    x = x ^ (x >> 14);
    x = x * 21ull;
    x = x ^ (x >> 28);
    return x + (x << 31);
}

// the bits of the key rounded to nearest f64, ties to even
__device__ __forceinline__ uint64_t rounded(uint64_t key) {
    return (uint64_t)__double_as_longlong(__ull2double_rn(key));
}

// insert (f, p) into the sorted best list (f < bf[ELL - 1] holds); a
// kept entry with an equal f stays ahead. x rides along with its entry.
__device__ __forceinline__ void insert(uint64_t (&bf)[ELL],
                                       int64_t (&bp)[ELL],
                                       uint64_t (&bx)[ELL], uint64_t f,
                                       int64_t p, uint64_t x) {
#pragma unroll
    for (int e = ELL - 1; e >= 0; --e) {
        if (e > 0 && f < bf[e - 1]) {
            bf[e] = bf[e - 1];
            bp[e] = bp[e - 1];
            bx[e] = bx[e - 1];
        } else if (f < bf[e]) {
            bf[e] = f;
            bp[e] = p;
            bx[e] = x;
        }
    }
}

__global__ void __launch_bounds__(TPB)
omh_select(const uint64_t* __restrict__ kmers,
           const int64_t* __restrict__ occ,
           const uint8_t* __restrict__ valid,
           const int64_t* __restrict__ table, int m,
           uint64_t* __restrict__ part_f, int64_t* __restrict__ part_p) {
    __shared__ uint64_t sk[CH];
    __shared__ uint8_t sv[CH];
    const int64_t piece = blockIdx.x;
    const int reg = blockIdx.y * TPB + threadIdx.x;
    const bool active = reg < m;
    const int64_t beg = table[3 * piece], end = table[3 * piece + 1];
    const int64_t rel = table[3 * piece + 2];
    const uint64_t rk = (uint64_t)reg * G2 + SALT;

    // the sorted best: rounded key bits, position in the item, exact key
    uint64_t bf[ELL], bk[ELL];
    int64_t bp[ELL];
#pragma unroll
    for (int e = 0; e < ELL; ++e) {
        bf[e] = F_EMPTY;
        bk[e] = ~0ull;
        bp[e] = 0;
    }
    for (int64_t base = beg; base < end; base += CH) {
        const int cnt = (int)(end - base < CH ? end - base : CH);
        __syncthreads();
        for (int i = threadIdx.x; i < cnt; i += TPB) {
            const bool v = valid[base + i] != 0;
            sv[i] = v;
            sk[i] = v ? kmers[base + i] ^ ((uint64_t)occ[base + i] * G1)
                      : 0ull;
        }
        __syncthreads();
        if (!active) continue;
        const int64_t p0 = base - beg + rel;
        for (int i = 0; i < cnt; ++i) {
            // the same position for every thread: no divergence
            if (!sv[i]) continue;
            const uint64_t key = wanghash(sk[i] ^ rk);
            if (key > bk[ELL - 1]) continue;
            const uint64_t f = rounded(key);
            if (f < bf[ELL - 1]) insert(bf, bp, bk, f, p0 + i, key);
        }
    }
    if (!active) return;
#pragma unroll
    for (int e = 0; e < ELL; ++e) {
        const int64_t o = (piece * ELL + e) * (int64_t)m + reg;
        part_f[o] = bf[e];
        part_p[o] = bp[e];
    }
}

__global__ void __launch_bounds__(TPB)
omh_fold(const uint64_t* __restrict__ kmers,
         const int64_t* __restrict__ offsets,
         const int64_t* __restrict__ poff, int m,
         const uint64_t* __restrict__ part_f,
         const int64_t* __restrict__ part_p, uint64_t* __restrict__ sig) {
    const int64_t item = blockIdx.x;
    const int reg = blockIdx.y * TPB + threadIdx.x;
    if (reg >= m) return;
    const int64_t start = offsets[item];
    uint64_t* out = sig + item * (int64_t)m + reg;
    if (offsets[item + 1] == start) {
        *out = 0ull;                   // shorter than k: no position
        return;
    }
    uint64_t bf[ELL], unused[ELL];
    int64_t bp[ELL];
#pragma unroll
    for (int e = 0; e < ELL; ++e) {
        bf[e] = F_EMPTY;
        bp[e] = 0;
        unused[e] = 0;
    }
    for (int64_t q = poff[item]; q < poff[item + 1]; ++q) {
#pragma unroll
        for (int e = 0; e < ELL; ++e) {
            const int64_t o = (q * ELL + e) * (int64_t)m + reg;
            const uint64_t f = part_f[o];
            if (f < bf[ELL - 1]) insert(bf, bp, unused, f, part_p[o], 0);
        }
    }
    // position order: a real winner at p sorts by 2p, a phantom by 1
    int64_t ok[ELL];
    uint64_t sel[ELL];
#pragma unroll
    for (int e = 0; e < ELL; ++e) {
        const bool real = bf[e] < F_EMPTY;
        ok[e] = real ? 2 * bp[e] : 1;
        sel[e] = real ? kmers[start + bp[e]] : INVALID_CODE;
    }
#pragma unroll
    for (int a = 0; a < ELL; ++a) {
#pragma unroll
        for (int b = 0; b + 1 < ELL - a; ++b) {
            if (ok[b] > ok[b + 1]) {      // stable: equal keys keep order
                const int64_t t = ok[b];
                ok[b] = ok[b + 1];
                ok[b + 1] = t;
                const uint64_t s = sel[b];
                sel[b] = sel[b + 1];
                sel[b + 1] = s;
            }
        }
    }
    uint64_t s = SALT;
#pragma unroll
    for (int e = 0; e < ELL; ++e)
        s = wanghash(s ^ sel[e] ^ ((uint64_t)(e + 1) * G1));
    *out = s;
}

int launch(const uint64_t* kmers, const int64_t* occ, const uint8_t* valid,
           const int64_t* offsets, int n, const int64_t* table,
           const int64_t* poff, int64_t npieces, int m, uint64_t* part_f,
           int64_t* part_p, uint64_t* sig, cudaStream_t s) {
    const unsigned tiles = (unsigned)((m + TPB - 1) / TPB);
    if (npieces > 0) {
        omh_select<<<dim3((unsigned)npieces, tiles), TPB, 0, s>>>(
            kmers, occ, valid, table, m, part_f, part_p);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    omh_fold<<<dim3((unsigned)n, tiles), TPB, 0, s>>>(
        kmers, offsets, poff, m, part_f, part_p, sig);
    return (int)cudaGetLastError();
}

}  // namespace

// kmers (total,) u64, occ (total,) int64, valid (total,) u8 (0 or 1),
// offsets (n + 1,) int64; table (npieces, 3) int64 rows (first position,
// end position, first position within its item) and poff (n + 1,) int64,
// item i's pieces at [poff[i], poff[i + 1]); part_f, part_p (npieces,
// ell, m) scratch; sig (n, m) u64. ell = 2, 1 <= n < 2^31, npieces <
// 2^31, m <= 65535 * 128. Returns the launches' CUDA error (0 on
// success).
extern "C" int omh_registers(const void* kmers, const void* occ,
                             const void* valid, const void* offsets, int n,
                             const void* table, const void* poff,
                             int64_t npieces, int m, int ell, void* part_f,
                             void* part_p, void* sig, void* stream) {
    if (n <= 0 || m <= 0) return 0;
    if (ell != ELL || npieces >= (1ll << 31) ||
        (m + TPB - 1) / TPB > 65535)
        return (int)cudaErrorInvalidValue;
    return launch((const uint64_t*)kmers, (const int64_t*)occ,
                       (const uint8_t*)valid, (const int64_t*)offsets, n,
                       (const int64_t*)table, (const int64_t*)poff, npieces,
                       m, (uint64_t*)part_f, (int64_t*)part_p, (uint64_t*)sig,
                       (cudaStream_t)stream);
}
