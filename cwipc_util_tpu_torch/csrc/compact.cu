// Kernel 3: order-preserving stream compaction.
//
// Replaces cwipc_util_tpu/ops/pallas_compact.py:_kernel (the pallas_call at
// :192).  Keeps the points i with keep[i] != 0 and i < count, in order:
// the four 32-bit words of each kept point (x, y, z as raw float bits, and
// rgba) go to its rank, so every payload (inf, nan, -0.0, subnormals)
// passes bit for bit.  Slots from the kept count on are zeroed, and the
// kept count goes to a device scalar.
//
// Bound on the H100: memory.  17 bytes read and up to 16 written per point
// (under 8 MB at the chain's 229,376 points).  The TPU kernel placed kept
// points with one-hot matmuls into a ring it flushed in order, because a
// TPU has no scatter; here the rank comes from the same three-launch scan
// as the segmented reduce (scan.cuh), and each kept point writes its words
// directly.  Each output slot is written by exactly one thread: below the
// kept count by the point of that rank, from it on by the thread of that
// index (with zeros).
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

__device__ __forceinline__ int kept_at(const unsigned char* __restrict__ keep, int i, int n, int count) {
  return i < n && i < count && keep[i] != 0;
}

__global__ void __launch_bounds__(TILE)
count_kept(const unsigned char* __restrict__ keep, const int* __restrict__ count_ptr, int n,
           int* __restrict__ tile_counts) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int c = __syncthreads_count(kept_at(keep, i, n, *count_ptr));
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(TILE)
scatter_kept(const int* __restrict__ x, const int* __restrict__ y, const int* __restrict__ z,
             const int* __restrict__ rgba, const unsigned char* __restrict__ keep,
             const int* __restrict__ count_ptr, int n, const int* __restrict__ tile_offsets,
             const int* __restrict__ nkept, int* __restrict__ ox, int* __restrict__ oy,
             int* __restrict__ oz, int* __restrict__ orgba) {
  const int i = blockIdx.x * TILE + threadIdx.x;
  const int k = kept_at(keep, i, n, *count_ptr);
  int unused;
  const int before = block_exclusive_scan(k, &unused);
  if (i >= n) return;
  if (k) {
    const int r = tile_offsets[blockIdx.x] + before;
    ox[r] = x[i];
    oy[r] = y[i];
    oz[r] = z[i];
    orgba[r] = rgba[i];
  }
  if (i >= *nkept) {
    ox[i] = 0;
    oy[i] = 0;
    oz[i] = 0;
    orgba[i] = 0;
  }
}

}  // namespace

extern "C" int cwipc_compact(const int* x, const int* y, const int* z, const int* rgba,
                             const unsigned char* keep, const int* count, int n,
                             int* tile_counts, int* tile_offsets,
                             int* ox, int* oy, int* oz, int* orgba, int* nkept, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ntiles = (n + TILE - 1) / TILE;
  if (ntiles > 0) {
    count_kept<<<ntiles, TILE, 0, stream>>>(keep, count, n, tile_counts);
    CWIPC_RETURN_IF_ERROR();
  }
  scan_tile_counts<<<1, TILE, 0, stream>>>(tile_counts, ntiles, tile_offsets, nkept);
  CWIPC_RETURN_IF_ERROR();
  if (ntiles > 0) {
    scatter_kept<<<ntiles, TILE, 0, stream>>>(x, y, z, rgba, keep, count, n, tile_offsets, nkept,
                                              ox, oy, oz, orgba);
    CWIPC_RETURN_IF_ERROR();
  }
  return 0;
}
