// All-pairs greater- and less-register counts over unsigned 64-bit
// registers.
//
// Replaces two TPU kernels of dashing2_tpu/ops/pallas_cmp.py:
//  * _gtlt_kernel (with _gtlt_pallas_call and gtlt_pallas): the full
//    rectangle of two register matrices;
//  * the kernel inside _tri_gtlt_call (with gtlt_self_pallas): the upper
//    tiles of one matrix against itself, lt = gt^T.
//
//   gt[i][j] = #{r : reg r of row i of A > reg r of row j of B}
//   lt[i][j] = #{r : reg r of row i of A < reg r of row j of B}
//
// The TPU kernels hold each register as a (hi, lo) u32 pair because
// Mosaic has no 64-bit vectors, and loop over A rows with fori_loop to
// bound Mosaic's compile time. Neither applies here: the registers are
// compared as unsigned 64-bit integers (the wrapper passes torch int64
// holding the bit patterns), and the block's loops are ordinary loops.
//
// Layout: each matrix is (rows, m) u64, row-major. Registers past m in
// the last staged chunk and rows past the matrix load as 0 on both sides:
// 0 against 0 is neither greater nor less, and pad rows are never stored.
//
// Schedule: one block per (row tile, column tile) of 64 rows each. KC
// registers of both tiles are staged per step in shared memory,
// transposed to [register][row] and padded by one row so that the stores
// and the inner loop's reads are free of bank conflicts; 256 threads each
// keep a 4 x 4 micro-tile of gt and lt counts in registers. Two entries
// share that body:
//  * gtlt_self_counts_u16: the tile pairs bi <= bj of one matrix, decoded
//    from the 1-D block index as in tri_eq.cu (the TPU kernel got them by
//    scalar prefetch). It stores gt at (i, j) and lt at (j, i), so one
//    (n, n) matrix holds both counts (lt = gt^T) and the diagonal is 0.
//    The mirrored stores are uncoalesced.
//  * gtlt_counts_u16: a 2-D grid of (column tile, row tile) over two
//    matrices, storing gt and lt at (i, j).
//
// Bound on the card: N^2/2 * m register pairs for self-pairs (Na * Nb * m
// for the rectangle), each two unsigned 64-bit compares (two 32-bit
// integer instructions each) and two counter increments, against 2 loads
// from shared memory per 4 pairs: bound by instruction throughput, with
// small operands (8 N m bytes) and 2 bytes of output per count. CUDA
// cores only. nvcc 12.8 emits 8.6 instructions per pair in the inner
// loop; on an H100 (700 W) that ran at about 82% of the SM's 4 warp
// instructions per clock. The similarity reads only gt + lt = m - eq, so
// an eq-only schedule would need about half the instructions.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;               // rows (and columns) per tile
constexpr int KC = 16;                 // u64 registers staged per step
constexpr int TPB = 256;               // 16 x 16 threads
constexpr int MICRO = TILE / 16;       // 4 x 4 outputs per thread

// gt and lt of rows [row0, row0 + 64) of a against rows [col0, col0 + 64)
// of b, for this thread's micro-tile: rows row0 + ty + 16 i, columns
// col0 + tx + 16 j
__device__ __forceinline__ void tile_counts(
    const uint64_t* __restrict__ a, int na, int row0,
    const uint64_t* __restrict__ b, int nb, int col0, int m,
    int (&gt)[MICRO][MICRO], int (&lt)[MICRO][MICRO]) {
  __shared__ uint64_t as[KC][TILE + 1];
  __shared__ uint64_t bs[KC][TILE + 1];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) gt[i][j] = lt[i][j] = 0;

  for (int k0 = 0; k0 < m; k0 += KC) {
    // 16 neighbouring threads read 16 neighbouring registers of one row
    for (int e = threadIdx.x; e < TILE * KC; e += TPB) {
      const int kk = e % KC;
      const int r = e / KC;
      const int k = k0 + kk;
      const int ra = row0 + r;
      const int rb = col0 + r;
      as[kk][r] = (ra < na && k < m) ? a[static_cast<size_t>(ra) * m + k] : 0ull;
      bs[kk][r] = (rb < nb && k < m) ? b[static_cast<size_t>(rb) * m + k] : 0ull;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      uint64_t av[MICRO], bv[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) {
        av[i] = as[kk][ty + 16 * i];
        bv[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) {
          gt[i][j] += av[i] > bv[j];
          lt[i][j] += av[i] < bv[j];
        }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TPB)
gtlt_self_kernel(const uint64_t* __restrict__ regs, int n, int m,
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

  int gt[MICRO][MICRO], lt[MICRO][MICRO];
  tile_counts(regs, n, row0, regs, n, col0, m, gt, lt);

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
        out[static_cast<size_t>(r) * n + c] = static_cast<uint16_t>(gt[i][j]);
        out[static_cast<size_t>(c) * n + r] = static_cast<uint16_t>(lt[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(TPB)
gtlt_rect_kernel(const uint64_t* __restrict__ a, int na,
                 const uint64_t* __restrict__ b, int nb, int m,
                 uint16_t* __restrict__ gt_out, uint16_t* __restrict__ lt_out) {
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;
  int gt[MICRO][MICRO], lt[MICRO][MICRO];
  tile_counts(a, na, row0, b, nb, col0, m, gt, lt);

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
        gt_out[rc] = static_cast<uint16_t>(gt[i][j]);
        lt_out[rc] = static_cast<uint16_t>(lt[i][j]);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success). The
// caller checks 1 <= n, 1 <= m < 65536, that the registers are (n, m)
// contiguous 8-byte words, and allocates the outputs.

// regs (n, m) -> out (n, n): gt at (i, j), lt at (j, i) for i <= j
extern "C" int gtlt_self_counts_u16(const void* regs, int n, int m, void* out,
                                    void* stream) {
  const long long tiles = (n + TILE - 1) / TILE;
  const long long pairs = tiles * (tiles + 1) / 2;
  gtlt_self_kernel<<<static_cast<unsigned>(pairs), TPB, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(regs), n, m, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// a (na, m), b (nb, m) -> gt, lt (na, nb) each; the caller also checks
// that na needs at most 65535 row tiles (the grid's y extent)
extern "C" int gtlt_counts_u16(const void* a, int na, const void* b, int nb,
                               int m, void* gt, void* lt, void* stream) {
  const dim3 grid((nb + TILE - 1) / TILE, (na + TILE - 1) / TILE);
  gtlt_rect_kernel<<<grid, TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(a), na, static_cast<const uint64_t*>(b),
      nb, m, static_cast<uint16_t*>(gt), static_cast<uint16_t*>(lt));
  return static_cast<int>(cudaGetLastError());
}
