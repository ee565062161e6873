// Weighted-sketch draws: each item's (hash, log-weight) stream reduced to
// m registers (the least key of every register), the winning position and
// the winner's sample value.
//
// Replaces the JAX package's weighted engine, which is XLA and not a
// Pallas kernel: dashing2_tpu/sketch/weighted.py `_rows_kernel` (a jitted
// scan over 32-position chunks of (rows, 2048) row batches, the draw math
// in `_icws_rt`) and the host loop of `_sketch_many_streams` that merges
// an item's rows. ops/weighted_draws.py holds the plain PyTorch version
// of the same arithmetic and says what a draw is.
//
// Bits: every f32 and f64 step is one rounded IEEE operation written out
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fmaf_rn), so that nvcc contracts
// nothing, and log and exp are the port's fixed sequences
// (ops/fixedmath.py: XLA's CPU sequences), so the keys, winners and values
// equal the plain version's bit for bit, and the JAX package's.
//
// Mask: a position whose f32 log-weight is not finite (a weight of 0 or
// less) has key +inf in the JAX engine (`live = isfinite(lnw)`), and so
// never wins. Here an ICWS draw of such a position is skipped (key +inf);
// a ProbMinHash one stages exp(-w) = +inf, so its key -log(u) * inf is
// +inf (NaN where u rounds to 1, which orders after +inf): no row merges
// either key (f32 `<` against +inf), so the keys, winners and values
// that come out are the JAX engine's. A register no live position wins
// keeps key +inf, winner 0 and value 0.
//
// Schedule: one block per (tile of TPB registers, item), one thread per
// register. The block walks its item's stream in chunks of CH positions
// staged in shared memory (ProbMinHash stages exp(-w), which depends on
// the position alone); every thread draws its register for each position
// from the broadcast shared value, keeps the row's least (ordered key
// bits, first position) and at the end of every 2048-position row merges
// it into the item's best by f32 `<` (the JAX engine's row rule). The
// winner's sample value is hashed once at the end.
//
// Bound on the card: operations. A draw reads nothing from device memory
// (the stream is read once per register tile, 12 bytes a position); an
// ICWS draw is five 64-bit wanghash chains, five u64 -> f64 -> f32
// conversions, four f32 logs (each about 25 f32 operations, 10 of them
// fused multiply-adds), one IEEE division and about ten more f32
// operations; a ProbMinHash draw one chain, one conversion, one log and a
// multiply. chip_smoke.py counts them for bound_ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;               // registers (threads) per block
constexpr int CH = 512;                // stream positions staged per step
constexpr int64_t ROW_L = 2048;        // the JAX engine's row length

constexpr uint64_t S1 = 0xA24BAED4963EE407ull;
constexpr uint64_t S2 = 0x9FB21C651E98DF25ull;
constexpr uint64_t S3 = 0xE7037ED1A0B428DBull;
constexpr uint64_t S4 = 0x8EBC6AF09C88C6E3ull;
constexpr uint64_t S5 = 0x589965CC75374CC3ull;
constexpr uint64_t SVAL = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t GOLD = 0x9E3779B97F4A7C15ull;

__device__ __forceinline__ float bitsf(uint32_t b) {
    return __uint_as_float(b);
}

__device__ __forceinline__ uint64_t wanghash(uint64_t x) {
    x = (~x) + (x << 21);
    x = x ^ (x >> 24);
    x = x * 265ull;
    x = x ^ (x >> 14);
    x = x * 21ull;
    x = x ^ (x >> 28);
    return x + (x << 31);
}

// f32(f64(u) * 2^-64): the u64's correctly rounded f64, then f32
__device__ __forceinline__ float unit32(uint64_t u) {
    return __double2float_rn(__dmul_rn(__ull2double_rn(u), 0x1p-64));
}

// ops/fixedmath.py log32
__device__ __forceinline__ float log32(float x) {
    const float minnorm = bitsf(0x00800000u);
    const float xc = (x > minnorm) ? x : minnorm;
    const int bits = __float_as_int(xc);
    float e = __fadd_rn(__int2float_rn((bits >> 23) - 127), 1.0f);
    const float mant = __int_as_float((bits & (int)0x807FFFFF) | 0x3F000000);
    const bool small = mant < bitsf(0x3F3504F3u);
    float t = __fsub_rn(mant, 1.0f);
    e = __fsub_rn(e, small ? 1.0f : 0.0f);
    t = __fadd_rn(t, small ? mant : 0.0f);
    const float t2 = __fmul_rn(t, t);
    const float t3 = __fmul_rn(t2, t);
    float y = __fmaf_rn(t, bitsf(0x3D9021BBu), bitsf(0xBDEBD1B8u));
    float y1 = __fmaf_rn(t, bitsf(0xBDFE5D4Fu), bitsf(0x3E11E9BFu));
    float y2 = __fmaf_rn(t, bitsf(0x3E4CCEACu), bitsf(0xBE7FFFFCu));
    y = __fmaf_rn(y, t, bitsf(0x3DEF251Au));
    y1 = __fmaf_rn(y1, t, bitsf(0xBE2AAE50u));
    y2 = __fmaf_rn(y2, t, bitsf(0x3EAAAAAAu));
    y = __fmaf_rn(y, t3, y1);
    y = __fmaf_rn(y, t3, y2);
    y = __fmaf_rn(y, t3, __fmul_rn(e, bitsf(0xB95E8083u)));
    float r = __fadd_rn(__fsub_rn(t, __fmul_rn(0.5f, t2)), y);
    r = __fadd_rn(r, __fmul_rn(bitsf(0x3F318000u), e));
    if (!(x > 0.0f)) r = bitsf(0x7FC00000u);
    if (x == 0.0f) r = bitsf(0xFF800000u);
    if (x == bitsf(0x7F800000u)) r = x;
    return r;
}

// ops/fixedmath.py exp32
__device__ __forceinline__ float exp32(float x) {
    const float lo = bitsf(0xC2AF999Au), hi = bitsf(0x42B1999Au);
    x = (x < lo) ? lo : x;
    x = (x > hi) ? hi : x;
    float n = floorf(__fmaf_rn(x, bitsf(0x3FB8AA3Bu), 0.5f));
    n = (n < -127.0f) ? -127.0f : n;
    n = (n > 127.0f) ? 127.0f : n;
    float z = __fsub_rn(x, __fmul_rn(bitsf(0x3F318000u), n));
    z = __fmaf_rn(-bitsf(0xB95E8083u), n, z);
    float y = __fmaf_rn(z, bitsf(0x39506967u), bitsf(0x3AB743CEu));
    y = __fmaf_rn(y, z, bitsf(0x3C088908u));
    y = __fmaf_rn(y, z, bitsf(0x3D2AA9C1u));
    y = __fmaf_rn(y, z, bitsf(0x3E2AAAAAu));
    y = __fmaf_rn(y, z, 0.5f);
    y = __fadd_rn(__fmaf_rn(y, __fmul_rn(z, z), z), 1.0f);
    const float pow2 = __int_as_float(((int)n + 127) << 23);
    return __fmul_rn(y, pow2);
}

__device__ __forceinline__ float unit_clamped(uint64_t h, uint64_t jt,
                                              uint64_t salt) {
    return fmaxf(unit32(wanghash(h ^ (jt + salt))), 1e-30f);
}

// One draw: the key, and for ICWS the t its sample value is keyed by.
// w is the f32 log-weight (ICWS) or exp(-w) (ProbMinHash).
template <int KIND>
__device__ __forceinline__ float draw(uint64_t h, float w, uint64_t jt,
                                      float& t) {
    if (KIND == 0) {
        const float r = -__fadd_rn(log32(unit_clamped(h, jt, S1)),
                                   log32(unit_clamped(h, jt, S2)));
        const float lnc = log32(-__fadd_rn(log32(unit_clamped(h, jt, S3)),
                                           log32(unit_clamped(h, jt, S4))));
        const float beta = unit32(wanghash(h ^ (jt + S5)));
        t = floorf(__fadd_rn(__fdiv_rn(w, r), beta));
        return __fsub_rn(__fmaf_rn(-r, __fsub_rn(t, beta), lnc), r);
    }
    t = 0.0f;
    return __fmul_rn(-log32(unit_clamped(h, jt, S1)), w);
}

template <int KIND>
__global__ void __launch_bounds__(TPB)
draws_kernel(const uint64_t* __restrict__ hashes,
             const float* __restrict__ lnw,
             const int64_t* __restrict__ offsets, int m,
             float* __restrict__ key_out, int* __restrict__ win_out,
             float* __restrict__ val_out) {
    __shared__ uint64_t sh[CH];
    __shared__ float sw[CH];
    const int item = blockIdx.y;
    const int reg = blockIdx.x * TPB + threadIdx.x;
    const bool active = reg < m;
    const int64_t start = offsets[item];
    const int64_t len = offsets[item + 1] - start;
    const uint64_t jt = (uint64_t)reg * GOLD;

    float best = bitsf(0x7F800000u), bt = 0.0f;
    int64_t bpos = 0;
    // the current row's least (ordered key bits, first position)
    uint32_t rord = 0xFFFFFFFFu;
    float rkey = best, rt = 0.0f;
    int64_t rpos = 0;
    for (int64_t base = 0; base < len; base += CH) {
        const int cnt = (int)(len - base < CH ? len - base : CH);
        __syncthreads();
        for (int i = threadIdx.x; i < cnt; i += TPB) {
            sh[i] = hashes[start + base + i];
            const float w = lnw[start + base + i];
            sw[i] = (KIND == 0) ? w
                    : (isfinite(w) ? exp32(-w) : bitsf(0x7F800000u));
        }
        __syncthreads();
        if (!active) continue;
        for (int i = 0; i < cnt; ++i) {
            const float w = sw[i];
            float t = 0.0f;
            // the same position for every thread: no divergence
            const float k = (KIND == 1 || isfinite(w))
                                ? draw<KIND>(sh[i], w, jt, t)
                                : bitsf(0x7F800000u);
            const uint32_t kb = __float_as_uint(k);
            const uint32_t ord = (kb >> 31) ? ~kb : (kb | 0x80000000u);
            const int64_t p = base + i;
            if (ord < rord) {
                rord = ord;
                rkey = k;
                rpos = p;
                rt = t;
            }
            if (((p + 1) & (ROW_L - 1)) == 0 || p + 1 == len) {
                if (rkey < best) {
                    best = rkey;
                    bpos = rpos;
                    bt = rt;
                }
                rord = 0xFFFFFFFFu;
                rkey = bitsf(0x7F800000u);
            }
        }
    }
    if (!active) return;
    const int64_t o = (int64_t)item * m + reg;
    key_out[o] = best;
    if (best == bitsf(0x7F800000u)) {
        // no row won (an empty item, or every position masked):
        // winner 0, value 0
        win_out[o] = 0;
        val_out[o] = 0.0f;
        return;
    }
    const uint64_t h = hashes[start + bpos];
    uint64_t x;
    if (KIND == 0) {
        const int64_t ti = (int64_t)__float2int_rz(bt);
        x = h ^ ((uint64_t)ti * GOLD) ^ SVAL;
    } else {
        x = h ^ SVAL;
    }
    win_out[o] = (int)bpos;
    val_out[o] = unit32(wanghash(x));
}

}  // namespace

// kind 0: ICWS (-B), 1: ProbMinHash (-P). hashes (total,) u64, lnw
// (total,) f32, offsets (n + 1,) int64; key, val (n, m) f32 and win (n, m)
// int32. Returns the launch's CUDA error (0 on success).
extern "C" int weighted_draws(int kind, const void* hashes, const void* lnw,
                              const void* offsets, int n, int m, void* key,
                              void* win, void* val, void* stream) {
    if (n <= 0 || m <= 0) return 0;
    dim3 grid((m + TPB - 1) / TPB, n);
    cudaStream_t s = (cudaStream_t)stream;
    const uint64_t* h = (const uint64_t*)hashes;
    const float* w = (const float*)lnw;
    const int64_t* off = (const int64_t*)offsets;
    if (kind == 0) {
        draws_kernel<0><<<grid, TPB, 0, s>>>(h, w, off, m, (float*)key,
                                             (int*)win, (float*)val);
    } else {
        draws_kernel<1><<<grid, TPB, 0, s>>>(h, w, off, m, (float*)key,
                                             (int*)win, (float*)val);
    }
    return (int)cudaGetLastError();
}
