// The port's first CountSketch kernel (commit 833c1c6), kept as a
// yardstick for chip_smoke.py's CountSketch phase and
// experiments/torch_kernel_turns.py: a thread a hash, int32 atomicAdds
// into a zeroed cssize-sized bucket array (the caller zeroes it and then
// compacts it with torch.nonzero). The port does not call it; its
// CountSketch is dashing2_tpu_torch/csrc/countsketch.cu.
//
// The CountSketch of `-c` (--countsketch-size) in the weighted spaces: a
// hash stream accumulated into cssize signed buckets, bucket h mod cssize
// gaining +1 where h is odd and -1 where it is even (counter.h).
//
// Replaces the JAX package's device CountSketch, which is XLA and not a
// Pallas kernel: dashing2_tpu/ops/sketch_kernels.py `_countsketch_device`
// (one sort of the bucket ids with the signs as payload and an int32
// cumsum, whose run ends the host reads back in `countsketch_counts`).
// ops/countsketch.py holds the plain PyTorch version and the compaction
// to the non-zero buckets.
//
// Design: one pass of int32 atomicAdds into the zeroed buckets, a thread
// a hash (grid-stride). Integer sums do not depend on the order of the
// adds, so the buckets are exact; the wrapper keeps streams below 2^31
// hashes, where no bucket can overflow.
//
// Bound on the card: bytes. A hash is read once (8 bytes) and the
// buckets written once (4 bytes each); the u64 modulo (a division
// sequence of some tens of integer instructions) and the atomic stay
// below that at the stream lengths of a genome.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TPB = 256;

__global__ void __launch_bounds__(TPB)
countsketch_kernel(const uint64_t* __restrict__ h, int64_t n,
                   uint64_t cssize, int* __restrict__ buckets) {
    const int64_t stride = (int64_t)gridDim.x * TPB;
    for (int64_t i = (int64_t)blockIdx.x * TPB + threadIdx.x; i < n;
         i += stride) {
        const uint64_t x = h[i];
        atomicAdd(&buckets[x % cssize], (x & 1) ? 1 : -1);
    }
}

}  // namespace

// h (n,) u64, buckets (cssize,) int32, zeroed by the caller. Returns the
// launch's CUDA error (0 on success).
extern "C" int countsketch(const void* h, long long n,
                           unsigned long long cssize, void* buckets,
                           void* stream) {
    if (n <= 0) return 0;
    long long blocks = (n + TPB - 1) / TPB;
    if (blocks > 132 * 32) blocks = 132 * 32;
    countsketch_kernel<<<(unsigned)blocks, TPB, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)h, (int64_t)n, (uint64_t)cssize, (int*)buckets);
    return (int)cudaGetLastError();
}
