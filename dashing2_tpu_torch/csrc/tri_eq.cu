// Triangular all-pairs equal-register counts over packed 4-bit registers,
// as an int8 one-hot product on Hopper's tensor cores (mma.sync).
//
// Replaces the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_tri_eq_kernel
// (:447, launched by _tri_eq_call :458), which contracts the int8 one-hot
// operand enc_onehot_T (:348), (16m, N) with k = 16 r + v register-major,
// against itself on the MXU:
//
//   eq[i][j] = sum_r sum_v [a_ir = v] [a_jr = v]
//
// Bound on the card: N(N+1)/2 pairs x 16m MACs x 2 int8 operations; at
// N = 10240, m = 1024 that is 1.718e12 operations, 0.868 ms at the
// H100's 1,979 TOP/s. The operand is N m/2 bytes and the u16 output
// 2 N^2 bytes (0.064 ms at 3.35 TB/s), so the operations set the bound.
//
// Design:
// - The one-hot is never stored. Blocks stage the PACKED rows (one byte
//   holds two registers) and build the one-hot fragments in registers.
//   An expanded (N, 16m) operand would be 168 MB at N = 10240 and be read
//   again by every tile pair.
// - Schedule: one block per upper tile pair (bi <= bj) of 128-row tiles,
//   decoded from the 1-D block index. Four warps, each a 64 x 64 sub-tile
//   of 4 x 8 m16n8 accumulators: 128 s32 registers a lane.
// - Staging: KB packed bytes (2 KB registers) of the block's 256 rows a
//   stage, copied with 16-byte cp.async into two buffers, so the next
//   stage's copy runs under this stage's products. The staged row stride
//   (80 bytes) puts the 8 rows a warp reads at once in 8 distinct banks.
// - Products: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. One k32
//   step is one packed byte of every row: k = 0..15 is the one-hot of its
//   low nibble, k = 16..31 that of its high nibble (the registers j and
//   j + m/2 of the row, in make_compressed's packing). The sum runs over
//   every register, so the order of k does not matter.
// - Fragments: lane g = lane >> 2, t = lane & 3. Word a0 holds bytes
//   k = 4t..4t+3 of row g (low nibble), so a0 = 1 << 8 (nib - 4t) where
//   4t <= nib < 4t + 4, else 0. It is computed as PTX shl.b32 of 1 by
//   (8 nib) ^ (32 t): bits 5-6 of 8 nib are nib >> 2, so the xor leaves
//   8 (nib & 3) where nib >> 2 == t and 32 or more elsewhere, and shl
//   gives 0 for any shift of 32 or more. Three integer instructions a
//   word (shift, and-xor, shl); no compare, no select. a1 is row g + 8, a2 and
//   a3 the high nibbles of rows g and g + 8; b0 and b1 (column g) are
//   built the same way. Per k32 step a warp builds 16 A words (4 per m16
//   tile, reused across its 8 n8 tiles) and 16 B words, for 32 products.
//   ops/nibble_tri.py::onehot_fragment_words models these words, and
//   tests/test_torch_tri_eq_encoding.py holds them to enc_onehot_T.
// - Pad registers: a one-hot counts matches, so a zero pad nibble on both
//   sides would add 1. Bytes at or past m/2 get bit 7 set in their A-side
//   shift, which makes every A word of them 0; rows >= n are staged as
//   zeros and masked at the store. The diagonal comes out as m.
// - Epilogue: the block's u16 counts go to shared memory, then to tile
//   (bi, bj) row by row and to its mirror (bj, bi) read transposed, so
//   both global stores are coalesced.
//
// The integer pipe, not the tensor cores, is the hazard: about one
// fragment word a product. The word loop is unrolled 4 times (16 k32
// steps) so that one step's loads and fragment build overlap another's
// products; 2 spills registers. 64 x 32 warp sub-tiles (8 warps) were
// slower: more warps do not lift mma.sync's own rate (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;               // rows (and columns) per tile
constexpr int WARP_N = 64;              // columns of a warp's sub-tile
constexpr int NT = WARP_N / 8;          // n8 tiles a warp
constexpr int WARPS_N = TILE / WARP_N;
constexpr int TPB = 32 * 2 * WARPS_N;   // 2 x WARPS_N warps of 64 x WARP_N
constexpr int KB = 64;                  // packed bytes a row a stage
constexpr int SROW = KB + 16;           // staged row stride in bytes
constexpr int STAGE = 2 * TILE * SROW;  // A and B rows of one stage
constexpr int SMEM = 2 * STAGE;         // two stages: 40,960 bytes
constexpr int OSTRIDE = TILE + 2;       // u16 epilogue row stride (65 words)
static_assert(TILE * OSTRIDE * 2 <= SMEM, "epilogue tile fits the stages");
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

// One k32 step: byte B of the staged words. ca and cb are what the A and
// B shifts are xor-ed with: 32t, plus 128 on the A side for a pad byte.
template <int B>
__device__ __forceinline__ void kstep(int (&acc)[4][NT][4],
                                      uint32_t (&aw)[4][2],
                                      uint32_t (&bw)[NT], uint32_t ca,
                                      uint32_t cb) {
  uint32_t b[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    b[j][0] = shl(1u, nib8<B, 0>(bw[j]) ^ cb);
    b[j][1] = shl(1u, nib8<B, 1>(bw[j]) ^ cb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a0 = shl(1u, nib8<B, 0>(aw[i][0]) ^ ca);
    const uint32_t a1 = shl(1u, nib8<B, 0>(aw[i][1]) ^ ca);
    const uint32_t a2 = shl(1u, nib8<B, 1>(aw[i][0]) ^ ca);
    const uint32_t a3 = shl(1u, nib8<B, 1>(aw[i][1]) ^ ca);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
  }
}

__global__ void __launch_bounds__(TPB, 2)
tri_eq_kernel(const uint8_t* __restrict__ rows, int n, int rb, int mb,
              uint16_t* __restrict__ out) {
  // block index -> tile pair (bi <= bj): p = bj (bj + 1) / 2 + bi
  const long long p = blockIdx.x;
  int bj = static_cast<int>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0)
                            * 0.5);
  while (static_cast<long long>(bj + 1) * (bj + 2) / 2 <= p) ++bj;
  while (static_cast<long long>(bj) * (bj + 1) / 2 > p) --bj;
  const int bi = static_cast<int>(p - static_cast<long long>(bj) * (bj + 1) / 2);
  const int row0 = bi * TILE;
  const int col0 = bj * TILE;

  // stage s: rows [0, TILE) are the A tile's, [TILE, 2 TILE) the B tile's
  __shared__ __align__(16) uint8_t smem[SMEM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const uint32_t cb = 32u * static_cast<uint32_t>(t);

  int acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int nstages = (mb + KB - 1) / KB;
  auto stage = [&](int s) {
    uint8_t* base = smem + (s & 1) * STAGE;
    const int k0 = s * KB;
    for (int e = tid; e < 2 * TILE * (KB / 16); e += TPB) {
      const int seg = e % (KB / 16);
      const int r = e / (KB / 16);
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
    const int k0 = s * KB;
    const int words = min(KB, mb - k0 + 3) / 4;   // words with a byte < mb
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
      kstep<0>(acc, aw, bw, cb | (kb + 0 < mb ? 0u : 128u), cb);
      kstep<1>(acc, aw, bw, cb | (kb + 1 < mb ? 0u : 128u), cb);
      kstep<2>(acc, aw, bw, cb | (kb + 2 < mb ? 0u : 128u), cb);
      kstep<3>(acc, aw, bw, cb | (kb + 3 < mb ? 0u : 128u), cb);
    }
    __syncthreads();
  }

  // epilogue: u16 counts through shared memory, then two coalesced stores
  uint16_t* tile = reinterpret_cast<uint16_t*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wm * 64 + i * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wn * WARP_N + j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(tile + r * OSTRIDE + c) =
          (static_cast<uint32_t>(acc[i][j][0]) & 0xFFFFu)
          | (static_cast<uint32_t>(acc[i][j][1]) << 16);
      *reinterpret_cast<uint32_t*>(tile + (r + 8) * OSTRIDE + c) =
          (static_cast<uint32_t>(acc[i][j][2]) & 0xFFFFu)
          | (static_cast<uint32_t>(acc[i][j][3]) << 16);
    }
  }
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += TPB) {
    const int r = e / TILE;
    const int c = e % TILE;
    if (row0 + r < n && col0 + c < n)
      out[static_cast<size_t>(row0 + r) * n + col0 + c] = tile[r * OSTRIDE + c];
  }
  if (bi != bj) {
    // mirror: out[col0 + r][row0 + c] = eq(row0 + c, col0 + r)
    for (int e = tid; e < TILE * TILE; e += TPB) {
      const int r = e / TILE;
      const int c = e % TILE;
      if (col0 + r < n && row0 + c < n)
        out[static_cast<size_t>(col0 + r) * n + row0 + c] =
            tile[c * OSTRIDE + r];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `words`
// is (n, wpr) u32: rows of packed nibbles zero-padded to whole 16-byte
// segments, 16-byte aligned. The caller checks 1 <= n, 0 < m < 65536,
// m even, wpr % 4 == 0, wpr * 8 >= m, and allocates `out` as (n, n) u16.
extern "C" int tri_eq_counts_u16(const void* words, int n, int wpr, int m,
                                 void* out, void* stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  tri_eq_kernel<<<static_cast<unsigned>(pairs), TPB, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(words), n, 4 * wpr, m / 2,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
