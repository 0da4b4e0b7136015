// Kernel 3: order-preserving stream compaction.
//
// Replaces cwipc_util_tpu/ops/pallas_compact.py:_kernel (the pallas_call at
// :192).  Keeps the points i with keep[i] != 0 and i < count, in order:
// the four 32-bit words of each kept point (x, y, z as raw float bits, and
// rgba) go to its rank, so every payload (inf, nan, -0.0, subnormals)
// passes bit for bit.  Slots from the kept count on are zero, and the kept
// count goes to a device scalar; nothing waits for the host.
//
// Bound on the H100: memory.  17 bytes read and up to 16 written per point
// (under 8 MB at the chain's 229,376 points).  The TPU kernel placed kept
// points with one-hot matmuls into a ring it flushed in order, because a
// TPU has no scatter.  Here one call is a memset and one launch:
//   1. the memset zeroes the one work buffer: the outputs [4][n] (so the
//      slots no kept point reaches read zero), the kept count, a tile
//      counter and one 64-bit look-back status word per tile;
//   2. a block of TILE threads takes the next tile of TILE points from the
//      tile counter, counts and ranks its kept points with one block scan,
//      and resolves its offset by decoupled look-back (scan.cuh); the last
//      tile writes the kept count, and each kept point writes its four
//      words to its rank.
#include <cuda_runtime.h>

#include "scan.cuh"  // TILE, block_exclusive_scan, lookback_exclusive, CWIPC_RETURN_IF_ERROR

namespace {

__global__ void __launch_bounds__(TILE)
compact_lookback(const int* __restrict__ x, const int* __restrict__ y, const int* __restrict__ z,
                 const int* __restrict__ rgba, const unsigned char* __restrict__ keep,
                 const int* __restrict__ count_ptr, int n, int* __restrict__ out, int* __restrict__ nkept,
                 int* __restrict__ counter, unsigned long long* status) {
  __shared__ int tile_id;
  __shared__ int exclusive;
  if (threadIdx.x == 0) tile_id = atomicAdd(counter, 1);
  __syncthreads();
  const int tile = tile_id;
  const int i = tile * TILE + threadIdx.x;
  const int kept = i < n && i < *count_ptr && keep[i] != 0;
  int total;
  const int before = block_exclusive_scan<TILE>(kept, &total);

  if (threadIdx.x < 32) {
    const int prefix = lookback_exclusive(status, tile, total);
    if (threadIdx.x == 0) {
      exclusive = prefix;
      if (tile == gridDim.x - 1) *nkept = prefix + total;
    }
  }
  __syncthreads();
  if (kept) {
    const int r = exclusive + before;
    out[r] = x[i];
    out[static_cast<size_t>(n) + r] = y[i];
    out[2 * static_cast<size_t>(n) + r] = z[i];
    out[3 * static_cast<size_t>(n) + r] = rgba[i];
  }
}

}  // namespace

// work: the one buffer of ops/compact_kernel.py:compact_plan(n), in int32
// words: the outputs x, y, z, rgba [4][n], the kept count at 4n, the tile
// counter at 4n + 1, then from the first even word after them one 64-bit
// status word per tile of TILE points.  One memset, then one launch.
extern "C" int cwipc_compact(const int* x, const int* y, const int* z, const int* rgba,
                             const unsigned char* keep, const int* count, int n, int* work,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0 || n > (0x7fffffff - 3) / 4) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (n + TILE - 1) / TILE;
  const size_t status_at = (4 * static_cast<size_t>(n) + 3) / 2 * 2;
  const size_t words = status_at + 2 * static_cast<size_t>(ntiles);
  const cudaError_t e = cudaMemsetAsync(work, 0, words * sizeof(int), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ntiles > 0) {
    int* tail = work + 4 * static_cast<size_t>(n);
    compact_lookback<<<ntiles, TILE, 0, stream>>>(
        x, y, z, rgba, keep, count, n, work, tail, tail + 1,
        reinterpret_cast<unsigned long long*>(work + status_at));
    CWIPC_RETURN_IF_ERROR();
  }
  return 0;
}
