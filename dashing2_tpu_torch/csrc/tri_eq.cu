// Triangular all-pairs equal-register counts over packed 4-bit registers.
//
// Replaces the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_tri_eq_kernel
// (with _tri_eq_call and tri_counts_tiles(want_gtlt=False)), which
// expands the nibbles into an int8 one-hot (16m, N) operand and contracts
// it on the MXU, carrying an i32 sum across its sequential k grid axis.
// Neither part carries over: the one-hot only feeds a matrix unit and
// costs 16x the operand bytes, and CUDA blocks run in no order. Here
// each block reads the PACKED registers and loops over all of m itself.
//
//   eq[i][j] = m - #{r : nibble r of row i != nibble r of row j}
//
// Layout: `words` is (n, wpr) little-endian u32, row-major; each word
// holds 8 registers (the packed byte order of make_compressed). Words
// past a row's registers are zero in every row, so their xor is zero and
// they add no mismatch: counting mismatches instead of matches is what
// discounts the pad nibbles.
//
// Schedule: one block per tile pair (bi <= bj) of the 64-row tiles, the
// pair decoded from the 1-D block index (no scalar prefetch). The block
// stages KW words of its two row tiles in shared memory, transposed so
// that the compute loop reads conflict-free, and each of its 256 threads
// accumulates a 4 x 4 micro-tile of mismatch counts in registers. The
// block writes u16 eq counts to tile (bi, bj) and its mirror (bj, bi);
// the mirrored store is uncoalesced. The diagonal comes out as m.
//
// Bound on the card: about N^2/2 * m/8 word compares (xor, two
// shift-or steps, mask, popcount, add), integer-issue and popcount bound;
// the operands are tiny (N * m/2 bytes) and the u16 output is 2 N^2
// bytes. CUDA cores only: an int8 tensor-core (wgmma) form is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;               // rows (and columns) per tile
constexpr int KW = 32;                 // u32 words staged per step
constexpr int TPB = 256;               // 16 x 16 threads
constexpr int MICRO = TILE / 16;       // 4 x 4 outputs per thread
constexpr uint32_t NIBBLE_LOW = 0x11111111u;

__device__ __forceinline__ int mismatches(uint32_t a, uint32_t b) {
  uint32_t x = a ^ b;
  x |= x >> 1;
  x |= x >> 2;                          // bit 4t set iff nibble t != 0
  return __popc(x & NIBBLE_LOW);
}

__global__ void __launch_bounds__(TPB)
tri_eq_kernel(const uint32_t* __restrict__ words, int n, int wpr, int m,
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

  // [word][row], padded by one so the transposed stores hit 32 banks
  __shared__ uint32_t as[KW][TILE + 1];
  __shared__ uint32_t bs[KW][TILE + 1];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < wpr; k0 += KW) {
    // a warp reads 32 consecutive words of one row: coalesced
    for (int e = threadIdx.x; e < TILE * KW; e += TPB) {
      const int kk = e % KW;
      const int r = e / KW;
      const int k = k0 + kk;
      const int ra = row0 + r;
      const int rb = col0 + r;
      as[kk][r] = (ra < n && k < wpr) ? words[static_cast<size_t>(ra) * wpr + k] : 0u;
      bs[kk][r] = (rb < n && k < wpr) ? words[static_cast<size_t>(rb) * wpr + k] : 0u;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KW; ++kk) {
      uint32_t a[MICRO], b[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        a[i] = as[kk][ty + 16 * i];
        b[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) acc[i][j] += mismatches(a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < n) {
        const uint16_t v = static_cast<uint16_t>(m - acc[i][j]);
        out[static_cast<size_t>(r) * n + c] = v;
        out[static_cast<size_t>(c) * n + r] = v;
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller checks 1 <= n, 0 < m < 65536, wpr * 8 >= m, and allocates `out`
// as (n, n) u16.
extern "C" int tri_eq_counts_u16(const void* words, int n, int wpr, int m,
                                 void* out, void* stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  tri_eq_kernel<<<static_cast<unsigned>(pairs), TPB, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n, wpr, m,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
