// Triangular all-pairs equal- and greater-register counts over packed
// 4-bit registers, as one int8 product on Hopper's tensor cores
// (mma.sync) with a per-chunk decode.
//
// Replaces the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_tri_comb_kernel
// (:367, launched by _tri_comb_call :383), which contracts the one-hot
// operand enc_onehot_T (:348) of the rows against the combined operand
// enc_combined_T (:357) of the columns, ct = [b == v] - 128 [b < v], so
// that one product gives, per register chunk,
//
//   partial[i][j] = eq - 128 gt,  gt = #{r : a_ir > b_jr}
//
// and decodes each chunk with t = (127 - partial) >> 7: gt += t,
// eq += partial + (t << 7). That is exact only while eq <= 127 in a
// chunk, so a chunk holds at most 127 registers.
//
// Bound on the card: one product, N(N+1)/2 pairs x 16m MACs x 2 int8
// operations; at N = 10240, m = 1024 that is 1.718e12 operations, 0.868
// ms at the H100's 1,979 TOP/s. The operand is N m/2 bytes and the two
// u16 outputs 4 N^2 bytes (0.125 ms at 3.35 TB/s), so the operations set
// the bound.
//
// Design: csrc/tri_eq.cu's engine, with the combined encoding on the B
// side and the decode added.
// - Schedule, staging, A side and products as tri_eq.cu: one block per
//   upper tile pair (bi <= bj) of 128-row tiles, four warps of 64 x 64
//   sub-tiles (4 x 8 m16n8 accumulators, 128 s32 a lane), CHUNK packed
//   bytes of the block's 256 rows a stage in two cp.async buffers (row
//   stride 80 bytes, so the 8 rows a warp reads at once sit in 8 distinct
//   banks), one m16n8k32 step a packed byte (k = 0..15 the levels of
//   its low nibble, 16..31 those of its high nibble), A words one-hot
//   with the pad rule (bytes at or past m/2 get bit 7 in their shift, so
//   their words are 0 and add nothing to either count).
// - B words: lane group t holds levels v = 4t..4t+3 of column register b;
//   byte q is 1 where 4t + q == b, 0x80 (-128) where 4t + q > b, else 0.
//   With s = 8 (b - 4t): shl.b32(0x80808001, s) for s in 0..31, which
//   PTX's shl also gives as 0 for s >= 32 (b above the group); or-ed with
//   0x80808080 where s < 0 (every level of the group above b).
//   ops/nibble_comb.py::combined_fragment_words models these words, and
//   tests/test_torch_tri_comb_encoding.py holds them to enc_combined_T.
// - The integer pipe sets the pace (PERF.md §6), and that word takes six
//   integer instructions against the one-hot word's three. So each block
//   builds a table of them once: entry 4 byte + t holds the words of
//   both nibbles of a packed byte for lane group t (8 KB), and a k32 step
//   reads a column's two B words with one 8-byte shared load and two
//   integer instructions. With t innermost, the four lanes of a column
//   read 32 consecutive bytes, so a warp's load meets at most the bank
//   conflicts of its 8 columns' random bytes (t outermost put the four
//   lanes of a column in one bank pair, and was slower).
// - Decode: after each stage of CHUNK = 48 packed bytes (96 registers;
//   the TPU's 64-register chunks decoded 50% more often and were 3%
//   slower) the partials are decoded as above and added, as
//   eq + (gt << 16), to the block's totals in shared memory (one u32 an
//   output: both counts are <= m < 2^16 and eq + gt <= m, so no carry
//   crosses), and restart at 0. 128 partials
//   and 128 totals would not fit in a lane's 255 registers beside the
//   fragments; 64 KB of totals beside the 40 KB of stages and the 8 KB
//   table still leave two blocks an SM. The totals are kept in fragment
//   order, so each warp's read and write of them is 32 consecutive
//   16-byte words.
// - Epilogue: eq and gt go to two u16 tiles in shared memory, then to
//   tile (bi, bj) of both outputs row by row and to the mirror (bj, bi)
//   read transposed: eq[j][i] = eq[i][j], gt[j][i] = m - eq[i][j] -
//   gt[i][j]. Every global store is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;               // rows (and columns) per tile
constexpr int WARP_N = 64;              // columns of a warp's sub-tile
constexpr int NT = WARP_N / 8;          // n8 tiles a warp
constexpr int WARPS_N = TILE / WARP_N;
constexpr int TPB = 32 * 2 * WARPS_N;   // 2 x WARPS_N warps of 64 x WARP_N
constexpr int CHUNK = 48;               // packed bytes a stage and a decode
constexpr int SROW = CHUNK + 32;        // staged row stride: 20 words
constexpr int STAGE = 2 * TILE * SROW;  // A and B rows of one stage
constexpr int STAGES = 2 * STAGE;       // two stages: 40,960 bytes
constexpr int TOTALS = TILE * TILE * 4; // u32 eq + (gt << 16): 65,536 bytes
constexpr int TABLE = 256 * 4 * 8;      // B words by (byte, t): 8,192 bytes
constexpr int SMEM = STAGES + TOTALS + TABLE;   // dynamic shared memory
constexpr int OSTRIDE = TILE + 2;       // u16 epilogue row stride (65 words)
static_assert(2 * CHUNK <= 127, "a chunk's eq must stay decodable");
static_assert(CHUNK % 16 == 0, "whole 16-byte cp.async segments");
static_assert(TILE * OSTRIDE * 2 <= STAGES && TILE * OSTRIDE * 2 <= TOTALS,
              "the eq and gt epilogue tiles fit the stages and the totals");
static_assert(SROW % 16 == 0, "cp.async destinations are 16-byte aligned");

__device__ __forceinline__ uint32_t shl(uint32_t a, uint32_t s) {
  uint32_t d;
  asm("shl.b32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(s));
  return d;
}

// 8 * (nibble H of byte B of w): its value times 8, in 0..120
template <int B, int H>
__device__ __forceinline__ uint32_t nib8(uint32_t w) {
  constexpr int S = 8 * B + 4 * H - 3;
  if constexpr (S >= 0) {
    return (w >> S) & 0x78u;
  } else {
    return (w << -S) & 0x78u;
  }
}

// B word of lane group t (c = 32 t) for column register b: a table entry
__device__ __forceinline__ uint32_t combined(uint32_t b, uint32_t c) {
  const int s = static_cast<int>(8 * b - c);           // 8 (b - 4t)
  return shl(0x80808001u, static_cast<uint32_t>(s))
         | (0x80808080u & static_cast<uint32_t>(s >> 31));
}

// a chunk's partial eq - 128 gt (0 <= eq <= 127) as eq + (gt << 16)
__device__ __forceinline__ uint32_t decoded(int p) {
  const int t = (127 - p) >> 7;                         // gt
  return static_cast<uint32_t>(p + (t << 7)) + (static_cast<uint32_t>(t) << 16);
}

__device__ __forceinline__ void mma(int (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

// both B words (low and high nibble) of byte B of w for this lane's
// group t, from the table (tb = table + t)
template <int B>
__device__ __forceinline__ uint2 bwords(const uint2* tb, uint32_t w) {
  return tb[4 * ((w >> (8 * B)) & 0xFFu)];
}

// One k32 step: byte B of the staged words. ca is what the A shifts are
// xor-ed with (32t, plus 128 for a pad byte).
template <int B>
__device__ __forceinline__ void kstep(int (&acc)[4][NT][4],
                                      uint32_t (&aw)[4][2],
                                      uint32_t (&bw)[NT], uint32_t ca,
                                      const uint2* tb) {
  uint2 b[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) b[j] = bwords<B>(tb, bw[j]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a0 = shl(1u, nib8<B, 0>(aw[i][0]) ^ ca);
    const uint32_t a1 = shl(1u, nib8<B, 0>(aw[i][1]) ^ ca);
    const uint32_t a2 = shl(1u, nib8<B, 1>(aw[i][0]) ^ ca);
    const uint32_t a3 = shl(1u, nib8<B, 1>(aw[i][1]) ^ ca);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], a0, a1, a2, a3, b[j].x, b[j].y);
  }
}

// Add the chunk's decoded partials to this thread's totals (fragment
// (i, j) at tot[(i NT + j) TPB]) and restart the partials at 0.
__device__ __forceinline__ void decode(int (&acc)[4][NT][4], uint4* tot) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint4 v = tot[(i * NT + j) * TPB];
      v.x += decoded(acc[i][j][0]);
      v.y += decoded(acc[i][j][1]);
      v.z += decoded(acc[i][j][2]);
      v.w += decoded(acc[i][j][3]);
      tot[(i * NT + j) * TPB] = v;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
    }
  }
}

__global__ void __launch_bounds__(TPB, 2)
tri_comb_kernel(const uint8_t* __restrict__ rows, int n, int rb, int mb,
                int m, uint16_t* __restrict__ eq_out,
                uint16_t* __restrict__ gt_out) {
  // block index -> tile pair (bi <= bj): p = bj (bj + 1) / 2 + bi
  const long long p = blockIdx.x;
  int bj = static_cast<int>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0)
                            * 0.5);
  while (static_cast<long long>(bj + 1) * (bj + 2) / 2 <= p) ++bj;
  while (static_cast<long long>(bj) * (bj + 1) / 2 > p) --bj;
  const int bi = static_cast<int>(p - static_cast<long long>(bj) * (bj + 1) / 2);
  const int row0 = bi * TILE;
  const int col0 = bj * TILE;

  // [0, STAGES): stage s's rows [0, TILE) are the A tile's, [TILE, 2 TILE)
  // the B tile's; then the totals, then the B word table
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const uint32_t cb = 32u * static_cast<uint32_t>(t);
  uint4* tot = reinterpret_cast<uint4*>(smem + STAGES) + tid;
  uint2* table = reinterpret_cast<uint2*>(smem + STAGES + TOTALS);
  for (int e = tid; e < 256 * 4; e += TPB) {             // e = 4 byte + t
    const uint32_t c = 32u * static_cast<uint32_t>(e & 3);
    table[e] = make_uint2(combined((e >> 2) & 15, c), combined(e >> 6, c));
  }
  const uint2* tb = table + t;

  int acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tot[(i * NT + j) * TPB] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
    }

  const int nstages = (mb + CHUNK - 1) / CHUNK;
  auto stage = [&](int s) {
    uint8_t* base = smem + (s & 1) * STAGE;
    const int k0 = s * CHUNK;
    for (int e = tid; e < 2 * TILE * (CHUNK / 16); e += TPB) {
      const int seg = e % (CHUNK / 16);
      const int r = e / (CHUNK / 16);
      const int grow = (r < TILE ? row0 + r : col0 + r - TILE);
      const int k = k0 + 16 * seg;
      const bool ok = grow < n && k < rb;
      const uint8_t* src = ok ? rows + static_cast<size_t>(grow) * rb + k
                              : rows;
      cp_async16(base + r * SROW + 16 * seg, src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  stage(0);
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* base = smem + (s & 1) * STAGE;
    const uint8_t* sa = base + (wm * 64 + g) * SROW;
    const uint8_t* sb = base + (TILE + wn * WARP_N + g) * SROW;
    const int k0 = s * CHUNK;
    const int words = min(CHUNK, mb - k0 + 3) / 4;   // words with a byte < mb
#pragma unroll 4
    for (int w = 0; w < words; ++w) {
      uint32_t aw[4][2], bw[NT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aw[i][0] = *reinterpret_cast<const uint32_t*>(sa + i * 16 * SROW + 4 * w);
        aw[i][1] = *reinterpret_cast<const uint32_t*>(sa + (i * 16 + 8) * SROW
                                                      + 4 * w);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bw[j] = *reinterpret_cast<const uint32_t*>(sb + j * 8 * SROW + 4 * w);
      const int kb = k0 + 4 * w;
      kstep<0>(acc, aw, bw, cb | (kb + 0 < mb ? 0u : 128u), tb);
      kstep<1>(acc, aw, bw, cb | (kb + 1 < mb ? 0u : 128u), tb);
      kstep<2>(acc, aw, bw, cb | (kb + 2 < mb ? 0u : 128u), tb);
      kstep<3>(acc, aw, bw, cb | (kb + 3 < mb ? 0u : 128u), tb);
    }
    decode(acc, tot);
    __syncthreads();
  }

  // epilogue: this thread's totals, split into u16 eq and gt tiles in
  // shared memory (eq over the stages, gt over the totals, once every
  // thread has read its totals), then four coalesced stores
  uint32_t sum[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint4 v = tot[(i * NT + j) * TPB];
      sum[i][j][0] = v.x;
      sum[i][j][1] = v.y;
      sum[i][j][2] = v.z;
      sum[i][j][3] = v.w;
    }
  __syncthreads();
  uint16_t* teq = reinterpret_cast<uint16_t*>(smem);
  uint16_t* tgt = reinterpret_cast<uint16_t*>(smem + STAGES);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wn * WARP_N + j * 8 + 2 * t;
      // low halves (eq) and high halves (gt) of columns c and c + 1
      *reinterpret_cast<uint32_t*>(teq + r * OSTRIDE + c) =
          __byte_perm(sum[i][j][0], sum[i][j][1], 0x5410);
      *reinterpret_cast<uint32_t*>(tgt + r * OSTRIDE + c) =
          __byte_perm(sum[i][j][0], sum[i][j][1], 0x7632);
      *reinterpret_cast<uint32_t*>(teq + (r + 8) * OSTRIDE + c) =
          __byte_perm(sum[i][j][2], sum[i][j][3], 0x5410);
      *reinterpret_cast<uint32_t*>(tgt + (r + 8) * OSTRIDE + c) =
          __byte_perm(sum[i][j][2], sum[i][j][3], 0x7632);
    }
  }
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += TPB) {
    const int r = e / TILE;
    const int c = e % TILE;
    if (row0 + r < n && col0 + c < n) {
      const size_t o = static_cast<size_t>(row0 + r) * n + col0 + c;
      eq_out[o] = teq[r * OSTRIDE + c];
      gt_out[o] = tgt[r * OSTRIDE + c];
    }
  }
  if (bi != bj) {
    // mirror: eq[col0 + r][row0 + c] = eq(row0 + c, col0 + r), gt there
    // the lt count m - eq - gt
    for (int e = tid; e < TILE * TILE; e += TPB) {
      const int r = e / TILE;
      const int c = e % TILE;
      if (col0 + r < n && row0 + c < n) {
        const size_t o = static_cast<size_t>(col0 + r) * n + row0 + c;
        const int eq = teq[c * OSTRIDE + r];
        eq_out[o] = static_cast<uint16_t>(eq);
        gt_out[o] = static_cast<uint16_t>(m - eq - tgt[c * OSTRIDE + r]);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success).
// `words` is (n, wpr) u32: rows of packed nibbles zero-padded to whole
// 16-byte segments, 16-byte aligned. The caller checks 1 <= n,
// 0 < m < 65536, m even, wpr % 4 == 0, wpr * 8 >= m, and allocates `eq`
// and `gt` as (n, n) u16 each.
extern "C" int tri_comb_counts_u16(const void* words, int n, int wpr, int m,
                                   void* eq, void* gt, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tri_comb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  tri_comb_kernel<<<static_cast<unsigned>(pairs), TPB, SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(words), n, 4 * wpr, m / 2, m,
      static_cast<uint16_t*>(eq), static_cast<uint16_t*>(gt));
  return static_cast<int>(cudaGetLastError());
}
