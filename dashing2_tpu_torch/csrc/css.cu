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
// Early exit: the kept rows are a prefix of the ascending rows (x1 <=
// threshold among the first k), and every draw of row d is at least x1[d]
// (x1 itself, or x1 - log(u) with -log(u) >= 0 for u in (0, 1]: the tests
// hold the log to that). So a register's walk may stop at its first row
// with x1 >= its least draw. It ends at the latest at the register's own
// row (the first row whose wyhash(rv) mod m is the register), so a walk
// is about a geometric number of rows, of mean about m.
//
// Schedule: one warp per register, its 32 lanes across 32 consecutive
// rows. A thread per register (the earlier schedule) kept every lane of a
// warp busy until the longest of its 32 walks ended; here a register's
// walk runs in steps of 32 rows and a lane idles only in its last step.
// In a step, lane l draws row base + l (x1 itself on the register's own
// row, +inf past the kept prefix); a ballot finds whether any lane beats
// the least draw so far, and only then a shuffle-min and a second ballot
// give the step's least and its lowest lane (the first row of equal
// minima). It replaces the least only when strictly below it, so an
// earlier step's tie keeps its earlier row, as torch.argmin does. The
// warp stops when x1 of the next step's first row is not below the least,
// or that row is past the kept prefix: the walk's own exit taken 32 rows
// at a time. The rows it draws beyond the walk have e >= x1 >= the least,
// so the result is the full pass's.
//
// Blocks: one block per (item, tile of TILE registers); its WARPS warps
// take the tile's registers in turn from a counter in shared memory, so
// that a warp that drew short walks takes more of them. Rows are read
// straight through L1 (x1 and rv of 32 neighbouring rows: two coalesced
// 256-byte loads, the next step's issued before this step's draws); all
// warps of a block read the same item's rows. There is no barrier inside
// a walk, so no warp waits for another.
//
// Each row's own register, wyhash(rv) mod m (a u64 modulo, a division
// sequence), is computed once per row and block, not once per draw: the
// block stages it for the item's first STAGE_ROWS rows in dynamic shared
// memory behind the one barrier before the walks. The C entry's arguments
// leave no room for a device table of it (a first launch writing (B, K)
// int32 would need scratch that the caller does not pass). Rows past
// STAGE_ROWS (only later passes of large m reach them: the first pass
// keeps at most max(4096, 6m) rows) compute it in the walk, one modulo a
// draw there.
//
// Bound on the card: operations. The bytes are 16 a kept row and 8 a
// register; a draw is a 64-bit wanghash chain, a u64 -> f64 conversion
// and the f64 log (one IEEE division and about 30 more f64 operations).
// chip_smoke.py charges each draw the early exit evaluates the
// instruction counts of the PR 18 kernel's walk loop (CSS_INT_OPS,
// CSS_F64_OPS), a fixed yardstick.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 8 warps and 1024 registers a block: in turns over the FullSetSketch
// job's first pass (experiments/torch_kernel_turns.py css), 128 or 256
// registers, or 4 or 16 warps, a block were 0.1-1.9% slower
constexpr int WARPS = 8;                 // warps per block
constexpr int TILE = 1024;               // registers per block
constexpr int THREADS = WARPS * 32;
constexpr int STAGE_ROWS = 12256;        // own registers staged: with the
                                         // counter, 48 KB of shared memory
constexpr unsigned FULL = 0xFFFFFFFFu;

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

__device__ __forceinline__ int own_register(uint64_t rv, int m) {
    return (int)(wyhash_out(rv) % (uint64_t)m);
}

__global__ void __launch_bounds__(THREADS)
css_kernel(const double* __restrict__ sx1, const uint64_t* __restrict__ srv,
           const int64_t* __restrict__ kcap,
           const double* __restrict__ threshold, int64_t K, int m,
           int ntiles, double* __restrict__ regs, double* __restrict__ tcut,
           int64_t* __restrict__ ids) {
    extern __shared__ int s_own[];
    __shared__ int s_next;
    const double INF = __longlong_as_double(0x7FF0000000000000ll);
    const int64_t item = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const double* x1 = sx1 + item * K;
    const uint64_t* rv = srv + item * K;
    const int64_t kk = kcap[item];
    const double t = threshold[item];
    const int staged = (int)(kk < STAGE_ROWS ? kk : STAGE_ROWS);
    for (int i = threadIdx.x; i < staged; i += THREADS)
        s_own[i] = own_register(__ldg(rv + i), m);

    for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
        const int lo = tile * TILE;
        const int hi = m - lo < TILE ? m : lo + TILE;
        if (threadIdx.x == 0) s_next = lo + WARPS;
        __syncthreads();
        for (int j = lo + (threadIdx.x >> 5); j < hi;) {
            const uint64_t jt = (uint64_t)j * GOLD;
            double best = INF;
            int64_t row = 0;
            int64_t base = 0;
            double x = lane < kk ? __ldg(x1 + lane) : INF;
            uint64_t r = lane < kk ? __ldg(rv + lane) : 0;
            while (true) {
                const int64_t d = base + lane;
                const double xn = d + 32 < kk ? __ldg(x1 + d + 32) : INF;
                const uint64_t rn = d + 32 < kk ? __ldg(rv + d + 32) : 0;
                double e = INF;
                if (d < kk && x <= t) {
                    const int own = d < staged ? s_own[d]
                                               : own_register(r, m);
                    e = own == j ? x : draw(r, jt, x);
                }
                if (__ballot_sync(FULL, e < best)) {
                    double v = e;
#pragma unroll
                    for (int o = 16; o > 0; o >>= 1)
                        v = fmin(v, __shfl_xor_sync(FULL, v, o));
                    const int at = __ffs(__ballot_sync(FULL, e == v)) - 1;
                    // the winning lane's own bits (fmin may give either
                    // zero of equal +0 and -0)
                    best = __shfl_sync(FULL, e, at);
                    row = base + at;
                }
                base += 32;
                // past the kept prefix, or no draw of the next row or a
                // later one can beat the least
                const double xf = __shfl_sync(FULL, xn, 0);
                if (base >= kk || !(xf <= t) || !(xf < best)) break;
                x = xn;
                r = rn;
            }
            if (lane == 0) {
                regs[item * m + j] = best;
                if (ids != nullptr) ids[item * m + j] = row;
                j = atomicAdd(&s_next, 1);
            }
            j = __shfl_sync(FULL, j, 0);
        }
        if (tile + (int)gridDim.y < ntiles) __syncthreads();
    }

    if (blockIdx.y == 0 && threadIdx.x == 0) {
        // the cutoff: the least x1 of the first kk rows that is not kept,
        // the first row past the kept prefix (+inf if all are kept)
        int64_t lo = 0, hi = kk;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (x1[mid] <= t) lo = mid + 1; else hi = mid;
        }
        tcut[item] = lo < kk ? x1[lo] : INF;
    }
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
    const int ntiles = (m + TILE - 1) / TILE;
    dim3 grid((unsigned)B, ntiles < 65535 ? ntiles : 65535);
    const size_t smem = sizeof(int) * (size_t)(K < STAGE_ROWS ? K
                                                              : STAGE_ROWS);
    css_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const double*)sx1, (const uint64_t*)srv, (const int64_t*)kcap,
        (const double*)threshold, (int64_t)K, m, ntiles, (double*)regs,
        (double*)tcut, (int64_t*)ids);
    return (int)cudaGetLastError();
}
