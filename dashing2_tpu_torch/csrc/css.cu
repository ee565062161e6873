// The CSetSketch (FullSetSketch) pass: each item's kept rows, ascending in
// x1, reduced to m registers (the least draw of every register), the
// winning row of each register, and the item's cutoff.
//
// Replaces the JAX package's CSetSketch pass, which is XLA and not a
// Pallas kernel: dashing2_tpu/ops/sketch_kernels.py `_css_pass` (a jitted
// top_k, then a vmapped (rows, m) draw and an argmin), driven by the host
// loop `css_sketch`. ops/css.py holds the plain PyTorch version of the
// same arithmetic (`css_pass_plain`) and says what a pass computes.
//
// Bits: every f64 step is one rounded IEEE operation written out
// (__dadd_rn, __dsub_rn, __dmul_rn, __ddiv_rn), so that nvcc contracts
// nothing, and the log is the port's fdlibm sequence (ops/fixedmath.py
// `_log64`), so the registers, winners and cutoffs equal the plain
// version's bit for bit.
//
// Schedule: one block per (item, tile of TPB registers), one thread per
// register. The block stages CH rows at a time in shared memory (x1, rv
// and the row's first register wyhash(rv) mod m, hashed once a row); each
// thread walks them in order and keeps its least draw and the first row
// that gave it (`<`: the first of equal minima, as torch.argmin takes it).
//
// Early exit: the kept rows are a prefix of the ascending rows (x1 <=
// threshold among the first k), and every draw of row d is at least x1[d]
// (x1 itself, or x1 - log(u) with -log(u) >= 0 for u in (0, 1]: the tests
// hold the log to that). So a thread stops at its first row with x1 >= its
// least draw, and a block at the end of the chunk where none of its
// threads walks on: the result is the full pass's.
//
// Bound on the card: operations. A draw reads nothing from device memory
// (a row is read once per register tile: 16 bytes); it is a 64-bit
// wanghash chain, a u64 -> f64 conversion and the f64 log (one IEEE
// division and about 30 more f64 operations). chip_smoke.py counts the
// instructions of the walk's loop in this kernel's SASS for bound_ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 128;                 // registers (threads) per block
constexpr int CH = 256;                  // rows staged per step

constexpr uint64_t GOLD = 0x9E3779B97F4A7C15ull;
constexpr uint64_t WY_INC = 0x60BEE2BEE120FC15ull;
constexpr uint64_t WY_M1 = 0xA3B195354A39B70Dull;
constexpr uint64_t WY_M2 = 0x1B03738712FAD5C9ull;

// fdlibm e_log.c
constexpr double LN2_HI = 6.93147180369123816490e-01;
constexpr double LN2_LO = 1.90821492927058770002e-10;
constexpr double LG1 = 6.666666666666735130e-01;
constexpr double LG2 = 3.999999999940941908e-01;
constexpr double LG3 = 2.857142874366239149e-01;
constexpr double LG4 = 2.222219843214978396e-01;
constexpr double LG5 = 1.818357216161805012e-01;
constexpr double LG6 = 1.531383769920937332e-01;
constexpr double LG7 = 1.479819860511658591e-01;

__device__ __forceinline__ uint64_t wanghash(uint64_t x) {
    x = (~x) + (x << 21);
    x = x ^ (x >> 24);
    x = x * 265ull;
    x = x ^ (x >> 14);
    x = x * 21ull;
    x = x ^ (x >> 28);
    return x + (x << 31);
}

// ops/hashes.py wyhash64_step's output
__device__ __forceinline__ uint64_t wyhash_out(uint64_t seed) {
    seed += WY_INC;
    const uint64_t m1 = __umul64hi(seed, WY_M1) ^ (seed * WY_M1);
    return __umul64hi(m1, WY_M2) ^ (m1 * WY_M2);
}

// ops/fixedmath.py _log64: fdlibm's __ieee754_log, branch-free, for
// positive normal finite x
__device__ __forceinline__ double log64(double x) {
    const int64_t bits = __double_as_longlong(x);
    int64_t hx = bits >> 32;
    int64_t k = (hx >> 20) - 1023;
    hx &= 0x000FFFFF;
    const int64_t i = (hx + 0x95F64) & 0x100000;
    k += i >> 20;
    double f = __longlong_as_double(((hx | (i ^ 0x3FF00000)) << 32)
                                    | (bits & 0xFFFFFFFFll));
    f = __dsub_rn(f, 1.0);
    const bool big = ((hx - 0x6147A) | (0x6B851 - hx)) > 0;
    const double dk = (double)k;
    const double s = __ddiv_rn(f, __dadd_rn(f, 2.0));
    const double z = __dmul_rn(s, s);
    const double w = __dmul_rn(z, z);
    double R = __dmul_rn(z, __dadd_rn(LG1, __dmul_rn(w, __dadd_rn(
        LG3, __dmul_rn(w, __dadd_rn(LG5, __dmul_rn(w, LG7)))))));
    R = __dadd_rn(R, __dmul_rn(w, __dadd_rn(LG2, __dmul_rn(w, __dadd_rn(
        LG4, __dmul_rn(w, LG6))))));
    const double lo = __dmul_rn(dk, LN2_LO);
    const double hfsq = __dmul_rn(__dmul_rn(0.5, f), f);
    const double r = big
        ? __dsub_rn(hfsq, __dadd_rn(__dmul_rn(s, __dadd_rn(hfsq, R)), lo))
        : __dsub_rn(__dmul_rn(s, __dsub_rn(f, R)), lo);
    return __dsub_rn(__dmul_rn(dk, LN2_HI), __dsub_rn(r, f));
}

// the draw of a row (rv, x1) for the register whose salt is jt:
// x1 - log(max(u, 1e-300)), u = wanghash(rv ^ jt) * 2^-64 (the u64's
// correctly rounded f64), written as -log + x1 like the plain version
__device__ __forceinline__ double draw(uint64_t rv, uint64_t jt, double x1) {
    const double u = fmax(__dmul_rn(__ull2double_rn(wanghash(rv ^ jt)),
                                    0x1p-64), 1e-300);
    return __dadd_rn(-log64(u), x1);
}

__global__ void __launch_bounds__(TPB)
css_kernel(const double* __restrict__ sx1, const uint64_t* __restrict__ srv,
           const int64_t* __restrict__ kcap,
           const double* __restrict__ threshold, int64_t K, int m,
           double* __restrict__ regs, double* __restrict__ tcut,
           int64_t* __restrict__ ids) {
    __shared__ double s_x1[CH];
    __shared__ uint64_t s_rv[CH];
    __shared__ int s_first[CH];
    const int64_t item = blockIdx.x;
    const int reg = blockIdx.y * TPB + threadIdx.x;
    const bool active = reg < m;
    const double* x1 = sx1 + item * K;
    const uint64_t* rv = srv + item * K;
    const int64_t kk = kcap[item];
    const double t = threshold[item];
    const uint64_t jt = (uint64_t)reg * GOLD;

    if (blockIdx.y == 0 && threadIdx.x == 0) {
        // the cutoff: the least x1 of the first kk rows that is not kept,
        // the first row past the kept prefix (+inf if all are kept)
        int64_t lo = 0, hi = kk;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (x1[mid] <= t) lo = mid + 1; else hi = mid;
        }
        tcut[item] = lo < kk ? x1[lo] : __longlong_as_double(
            0x7FF0000000000000ll);
    }
    double best = __longlong_as_double(0x7FF0000000000000ll);
    int64_t row = 0;
    bool live = active;
    for (int64_t base = 0; base < kk; base += CH) {
        const int cnt = (int)(kk - base < CH ? kk - base : CH);
        __syncthreads();
        for (int i = threadIdx.x; i < cnt; i += TPB) {
            const uint64_t r = rv[base + i];
            s_x1[i] = x1[base + i];
            s_rv[i] = r;
            s_first[i] = (int)(wyhash_out(r) % (uint64_t)m);
        }
        __syncthreads();
        if (live) {
            for (int i = 0; i < cnt; ++i) {
                const double x = s_x1[i];
                // past the kept prefix, or no draw of this row or a later
                // one can beat the least
                if (!(x <= t) || !(x < best)) {
                    live = false;
                    break;
                }
                const double e = s_first[i] == reg ? x
                                                   : draw(s_rv[i], jt, x);
                if (e < best) {
                    best = e;
                    row = base + i;
                }
            }
        }
        if (!__syncthreads_or(live)) break;
    }
    if (!active) return;
    regs[item * m + reg] = best;
    if (ids != nullptr) ids[item * m + reg] = row;
}

}  // namespace

// sx1 (B, K) f64 ascending per item and srv (B, K) u64 its rows; kcap (B,)
// int64 <= K and threshold (B,) f64; regs (B, m) f64, tcut (B,) f64, ids
// (B, m) int64 or null. Returns the launch's CUDA error (0 on success).
extern "C" int css_pass(const void* sx1, const void* srv, const void* kcap,
                        const void* threshold, long long B, long long K,
                        int m, void* regs, void* tcut, void* ids,
                        void* stream) {
    if (B <= 0 || m <= 0) return 0;
    dim3 grid((unsigned)B, (m + TPB - 1) / TPB);
    css_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(
        (const double*)sx1, (const uint64_t*)srv, (const int64_t*)kcap,
        (const double*)threshold, (int64_t)K, m, (double*)regs,
        (double*)tcut, (int64_t*)ids);
    return (int)cudaGetLastError();
}
