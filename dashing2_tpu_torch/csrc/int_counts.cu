// All-pairs equal-, greater- and less-register counts over unsigned 8-bit
// and 16-bit registers.
//
// Replaces the TPU kernel dashing2_tpu/ops/pallas_cmp.py::_int_counts_kernel
// (with _int_counts_call and counts_int_pallas), the engine of the
// `--fastcmp 1` and `--fastcmp 2` comparisons. That kernel widens u8 to
// i16 and u16 to i32 so that Mosaic's vector compares stay exact, and
// sums three planes of compares of one row of A against a block of B per
// loop step. Here the registers stay packed, 32 / W of them (W = 8 or 16
// bits) in each u32 word, and one word pair is compared in all its lanes
// at once, as the JAX package's XLA engines swar8_neq_tile and
// swar8_gt_tile (dashing2_tpu/ops/cmp_kernels.py) do. With LOW the lanes'
// low W - 1 bits and HIGH their top bits:
//
//   neq: x = a ^ b; ((x & LOW) + LOW) | x has a lane's top bit set iff the
//        lane of x is not 0 (the low bits carry into the top bit, and no
//        sum crosses its lane);
//   gt:  t = ~(((b & LOW) | HIGH) - (a & LOW)): per lane b_l + 2^(W-1) - a_l
//        lies in [1, 2^W - 1], so no borrow crosses a lane, and its top
//        bit is clear iff a_l > b_l. Then a > b iff a's top bit is set and
//        b's is not, or the top bits are equal and t's top bit is set:
//        ((a & ~b) | (~(a ^ b) & t)) & HIGH.
//
// One popcount each counts the lanes; eq = m - neq and lt = neq - gt. Pad
// registers (past m in the last word) are zero in every row: equal, so
// they drop out of neq and gt, and eq needs no correction.
//
// Layout: each matrix is (rows, wpr) little-endian u32 words, row-major.
//
// Schedule: as csrc/tri_comb.cu. One block per (row tile, column tile) of
// 64 rows each; KW words of both tiles staged per step in shared memory,
// transposed to [word][row] and padded by one row so that the stores and
// the inner loop's reads are free of bank conflicts; 256 threads, each
// with a 4 x 4 micro-tile of neq (and gt) counts in registers. Entries:
//  * int_counts_self_u16: the tile pairs bi <= bj of one matrix, decoded
//    from the 1-D block index as in tri_eq.cu. mode 0 stores eq at (i, j)
//    and (j, i); mode 1 stores gt at (i, j) and lt at (j, i) (lt = gt^T),
//    so one (n, n) matrix holds both counts. The mirrored stores are
//    uncoalesced.
//  * int_counts_u16: a 2-D grid of (column tile, row tile) over two
//    matrices, storing eq, gt and lt at (i, j).
//
// Bound on the card: N^2/2 * m * W / 32 word pairs for self-pairs (Na * Nb
// * m * W / 32 for the rectangle), each about six integer instructions and
// one popcount for neq, and as many again for gt, against 2 loads from
// shared memory per 4 word pairs: integer-throughput and popcount bound (the
// popcount unit takes 16 a clock per SM, a quarter of the integer rate),
// with small operands (N m W / 8 bytes) and 2 bytes of output per count.
// CUDA cores only. On an H100 (700 W) every entry ran at 76-83% of the
// popcount bound at N = 10240, m = 1024 (PERF.md); summing the lane flags
// in byte lanes over several words before one popcount would move work
// to the integer units.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;               // rows (and columns) per tile
constexpr int KW = 32;                 // u32 words staged per step
constexpr int TPB = 256;               // 16 x 16 threads
constexpr int MICRO = TILE / 16;       // 4 x 4 outputs per thread

template <int W>
struct Lanes;
template <>
struct Lanes<8> {
  static constexpr uint32_t LOW = 0x7F7F7F7Fu;
  static constexpr uint32_t HIGH = 0x80808080u;
};
template <>
struct Lanes<16> {
  static constexpr uint32_t LOW = 0x7FFF7FFFu;
  static constexpr uint32_t HIGH = 0x80008000u;
};

template <int W>
__device__ __forceinline__ int neq_lanes(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return __popc((((x & Lanes<W>::LOW) + Lanes<W>::LOW) | x) & Lanes<W>::HIGH);
}

// al = a & LOW and bh = (b & LOW) | HIGH, hoisted out of the pair loop
template <int W>
__device__ __forceinline__ int gt_lanes(uint32_t a, uint32_t al, uint32_t b,
                                        uint32_t bh) {
  const uint32_t t = ~(bh - al);
  return __popc(((a & ~b) | (~(a ^ b) & t)) & Lanes<W>::HIGH);
}

// neq (and, with GT, gt) of rows [row0, row0 + 64) of a against rows
// [col0, col0 + 64) of b, for this thread's micro-tile: rows
// row0 + ty + 16 i, columns col0 + tx + 16 j
template <int W, bool GT>
__device__ __forceinline__ void tile_counts(
    const uint32_t* __restrict__ a, int na, int row0,
    const uint32_t* __restrict__ b, int nb, int col0, int wpr,
    int (&neq)[MICRO][MICRO], int (&gt)[MICRO][MICRO]) {
  __shared__ uint32_t as[KW][TILE + 1];
  __shared__ uint32_t bs[KW][TILE + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) neq[i][j] = gt[i][j] = 0;

  for (int k0 = 0; k0 < wpr; k0 += KW) {
    // a warp reads 32 consecutive words of one row: coalesced
    for (int e = threadIdx.x; e < TILE * KW; e += TPB) {
      const int kk = e % KW;
      const int r = e / KW;
      const int k = k0 + kk;
      const int ra = row0 + r;
      const int rb = col0 + r;
      as[kk][r] = (ra < na && k < wpr) ? a[static_cast<size_t>(ra) * wpr + k] : 0u;
      bs[kk][r] = (rb < nb && k < wpr) ? b[static_cast<size_t>(rb) * wpr + k] : 0u;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KW; ++kk) {
      uint32_t av[MICRO], bv[MICRO], al[MICRO], bh[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        av[i] = as[kk][ty + 16 * i];
        bv[i] = bs[kk][tx + 16 * i];
        al[i] = av[i] & Lanes<W>::LOW;
        bh[i] = (bv[i] & Lanes<W>::LOW) | Lanes<W>::HIGH;
      }
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) {
          neq[i][j] += neq_lanes<W>(av[i], bv[j]);
          if (GT) gt[i][j] += gt_lanes<W>(av[i], al[i], bv[j], bh[j]);
        }
    }
    __syncthreads();
  }
}

template <int W, bool GTLT>
__global__ void __launch_bounds__(TPB)
int_self_kernel(const uint32_t* __restrict__ words, int n, int wpr, int m,
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

  int neq[MICRO][MICRO], gt[MICRO][MICRO];
  tile_counts<W, GTLT>(words, n, row0, words, n, col0, wpr, neq, gt);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < n && c < n) {
        // on a diagonal tile the thread of (c, r) writes the same values
        const size_t rc = static_cast<size_t>(r) * n + c;
        const size_t cr = static_cast<size_t>(c) * n + r;
        if (GTLT) {
          out[rc] = static_cast<uint16_t>(gt[i][j]);
          out[cr] = static_cast<uint16_t>(neq[i][j] - gt[i][j]);
        } else {
          out[rc] = out[cr] = static_cast<uint16_t>(m - neq[i][j]);
        }
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(TPB)
int_rect_kernel(const uint32_t* __restrict__ a, int na,
                const uint32_t* __restrict__ b, int nb, int wpr, int m,
                uint16_t* __restrict__ eq_out, uint16_t* __restrict__ gt_out,
                uint16_t* __restrict__ lt_out) {
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  int neq[MICRO][MICRO], gt[MICRO][MICRO];
  tile_counts<W, true>(a, na, row0, b, nb, col0, wpr, neq, gt);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int c = col0 + tx + 16 * j;
      if (r < na && c < nb) {
        const size_t rc = static_cast<size_t>(r) * nb + c;
        eq_out[rc] = static_cast<uint16_t>(m - neq[i][j]);
        gt_out[rc] = static_cast<uint16_t>(gt[i][j]);
        lt_out[rc] = static_cast<uint16_t>(neq[i][j] - gt[i][j]);
      }
    }
  }
}

template <int W, bool GTLT>
void launch_self(const void* words, int n, int wpr, int m, void* out,
                 cudaStream_t stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  int_self_kernel<W, GTLT><<<static_cast<unsigned>(pairs), TPB, 0, stream>>>(
      static_cast<const uint32_t*>(words), n, wpr, m,
      static_cast<uint16_t*>(out));
}

template <int W>
void launch_rect(const void* a, int na, const void* b, int nb, int wpr, int m,
                 void* eq, void* gt, void* lt, cudaStream_t stream) {
  const dim3 grid((nb + TILE - 1) / TILE, (na + TILE - 1) / TILE);
  int_rect_kernel<W><<<grid, TPB, 0, stream>>>(
      static_cast<const uint32_t*>(a), na, static_cast<const uint32_t*>(b),
      nb, wpr, m, static_cast<uint16_t*>(eq), static_cast<uint16_t*>(gt),
      static_cast<uint16_t*>(lt));
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a width other than 8 or 16. The caller checks
// 1 <= n, 1 <= m < 65536, wpr * 32 / width >= m, that the words are
// contiguous and 4-byte aligned with zero pad registers, and allocates
// the outputs.

// words (n, wpr) -> out (n, n): mode 0 eq at (i, j) and (j, i); mode 1 gt
// at (i, j) and lt at (j, i), for i <= j
extern "C" int int_counts_self_u16(const void* words, int n, int wpr, int m,
                                   int width, int mode, void* out,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8 && mode == 0) launch_self<8, false>(words, n, wpr, m, out, s);
  else if (width == 8) launch_self<8, true>(words, n, wpr, m, out, s);
  else if (width == 16 && mode == 0) launch_self<16, false>(words, n, wpr, m, out, s);
  else if (width == 16) launch_self<16, true>(words, n, wpr, m, out, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// a (na, wpr), b (nb, wpr) -> eq, gt, lt (na, nb) each; the caller also
// checks that na needs at most 65535 row tiles (the grid's y extent)
extern "C" int int_counts_u16(const void* a, int na, const void* b, int nb,
                              int wpr, int m, int width, void* eq, void* gt,
                              void* lt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 8) launch_rect<8>(a, na, b, nb, wpr, m, eq, gt, lt, s);
  else if (width == 16) launch_rect<16>(a, na, b, nb, wpr, m, eq, gt, lt, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
